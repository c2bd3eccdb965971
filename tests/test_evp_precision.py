"""The float32 αEVP step against the float64 step, configuration by
configuration.

The GPU runs the model in float32 through the plain jnp/lax substep loop, so
every grid family and forcing that the loop supports is checked here against
the same loop in float64.  The soft-ice regime (P★ = 27.5 N m⁻²) keeps the
αEVP relaxation contractive, so the two precisions track each other to f32
roundoff amplified by a modest factor: velocities agree to TOL_UV relative to
the largest speed, h and ℵ to TOL_HA relative to their largest value.  (With
the default P★ = 27500 the Δ → Δ_min regime amplifies roundoff ~30× per
substep and no two precisions agree tightly; the "stiff" case checks only
that f32 stays finite and within 5 cm s⁻¹ and 1 cm of float64.)
"""

import numpy as np
import pytest
import jax.numpy as jnp

import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu.grids import CurvilinearGrid

km = 1000.0
TOL_UV = 1e-4
TOL_HA = 1e-5


def _dynamics(substeps=10, P_star=27.5, top=None, bottom=None, drag=None,
              coriolis=None):
    return csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=coriolis or csi.FPlane(f=1.2e-4),
        top_momentum_stress=top or {"u": 0.05, "v": 0.02},
        bottom_momentum_stress=bottom or csi.SemiImplicitStress(ue=0.08,
                                                                ve=-0.04),
        immersed_drag=drag,
        solver=csi.SplitExplicitSolver(substeps=substeps))


def _rect(dtype, topology, size=(24, 24), fold=False):
    return csi.RectilinearGrid(size=size, x=(0, 100 * km), y=(0, 100 * km),
                               halo=5, dtype=dtype, topology=topology,
                               north_fold=fold)


def _island(grid):
    mask = np.zeros((grid.Nx, grid.Ny), bool)
    mask[8:12, 10:14] = True
    return csi.ImmersedBoundaryGrid(grid, mask)


def _tripolar(dtype, N=24, south_rows=2):
    grid = csi.TripolarGrid((N, N), southernmost_latitude=-70.0, halo=5,
                            dtype=dtype)
    mask = np.zeros((N, N), bool)
    mask[:, :south_rows] = True
    mask[N // 3:N // 2, 3 * N // 4:] = True   # landmass into the fold
    return csi.ImmersedBoundaryGrid(grid, mask)


def _warped(dtype, N=24):
    i = np.arange(N + 1)[:, None]
    j = np.arange(N + 1)[None, :]
    lam = 360.0 * i / N + 4.0 * np.sin(2 * np.pi * j / N)
    phi = 20.0 + 40.0 * j / N + 3.0 * np.sin(2 * np.pi * i / N) * (j / N)
    lam[-1] = lam[0] + 360.0
    phi[-1] = phi[0]
    return CurvilinearGrid(lam, phi, halo=5, dtype=dtype)


def _wind_u(grid, clock, fields):
    x = jnp.arange(grid.nxp, dtype=grid.np_dtype)[:, None]
    return (0.05 * jnp.sin(2 * np.pi * x / grid.Nx + clock.time / 3600.0)
            * jnp.ones(grid.shape, grid.np_dtype))


def _array_stresses(grid):
    rng = np.random.default_rng(5)
    tau = [np.asarray(0.05 * rng.standard_normal(grid.shape), np.float32)
           for _ in range(2)]
    ocean = [np.asarray(0.1 * rng.standard_normal(grid.shape), np.float32)
             for _ in range(2)]
    return ({"u": tau[0], "v": tau[1]},
            csi.SemiImplicitStress(ue=ocean[0], ve=ocean[1]))


def _build(case, dtype):
    """(grid, dynamics) of one configuration."""
    substeps = {"odd_9": 9, "odd_27": 27}.get(case, 10)
    if case in ("periodic", "stiff"):
        grid = _rect(dtype, ("periodic", "periodic"), size=(16, 128))
        dyn = _dynamics(P_star=27500.0 if case == "stiff" else 27.5)
    elif case == "walls":
        grid = _rect(dtype, ("periodic", "bounded"))
        dyn = _dynamics()
    elif case in ("immersed_island", "immersed_drag"):
        grid = _island(_rect(dtype, ("periodic", "bounded")))
        dyn = _dynamics(drag=csi.ImmersedDrag(3e-3)
                        if case == "immersed_drag" else None)
    elif case == "array_stresses":
        grid = _rect(dtype, ("bounded", "bounded"))
        top, bottom = _array_stresses(grid)
        dyn = _dynamics(top=top, bottom=bottom)
    elif case == "stress_function":
        grid = _rect(dtype, ("bounded", "bounded"))
        dyn = _dynamics(top={"u": csi.StressFunction(func=_wind_u), "v": 0.02})
    elif case == "latlon_bounded":
        grid = csi.LatitudeLongitudeGrid((24, 16), longitude=(0, 360),
                                         latitude=(55.0, 75.0), halo=5,
                                         dtype=dtype,
                                         topology=("periodic", "bounded"))
        dyn = _dynamics()
    elif case in ("rect_fold", "odd_9", "odd_27"):
        grid = _rect(dtype, ("periodic", "bounded"), fold=True)
        dyn = _dynamics(substeps=substeps)
    elif case in ("tripolar_immersed", "tripolar_immersed_drag"):
        grid = _tripolar(dtype)
        dyn = _dynamics(drag=csi.ImmersedDrag(3e-3)
                        if case.endswith("drag") else None)
    elif case == "tripolar_solid_rows":
        grid = _tripolar(dtype, N=32, south_rows=12)
        dyn = _dynamics(drag=csi.ImmersedDrag(3e-3))
    elif case == "warped_curvilinear":
        grid = _warped(dtype)
        dyn = _dynamics()
    elif case == "latitude_coriolis":
        grid = _tripolar(dtype)
        dyn = _dynamics(coriolis=csi.LatitudeCoriolis())
    else:
        raise ValueError(case)
    return grid, dyn


def _run(case, dtype, steps=3, dt=60.0):
    grid, dyn = _build(case, dtype)
    model = csi.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    rng = np.random.default_rng(3)
    h0 = 0.5 + 0.1 * rng.random((grid.Nx, grid.Ny))
    state = csi.initial_state(model, h=h0, a=1.0, u=0.02, v=0.01)
    for _ in range(steps):
        state = csi.step(model, state, dt)
    return model, state


CASES = ["periodic", "walls", "immersed_island", "immersed_drag",
         "array_stresses", "stress_function", "latlon_bounded", "rect_fold",
         "tripolar_immersed", "tripolar_immersed_drag", "tripolar_solid_rows",
         "warped_curvilinear", "latitude_coriolis", "odd_9", "odd_27",
         "stiff"]


@pytest.mark.parametrize("case", CASES)
def test_f32_step_matches_f64(case):
    m32, s32 = _run(case, "float32")
    m64, s64 = _run(case, "float64")
    I64, I32 = m64.grid.interior, m32.grid.interior
    get = lambda I, s, n: np.asarray(I(getattr(s, n)), np.float64)
    speed = max(np.abs(get(I64, s64, "u")).max(),
                np.abs(get(I64, s64, "v")).max(), 1e-8)
    assert speed > 1e-3, "the configuration must actually move the ice"
    stiff = case == "stiff"
    for name in ("u", "v", "h", "a"):
        a, b = get(I32, s32, name), get(I64, s64, name)
        assert np.isfinite(a).all(), name
        if stiff:
            err, tol = np.abs(a - b).max(), 5e-2 if name in "uv" else 1e-2
        elif name in ("u", "v"):
            err, tol = np.abs(a - b).max() / speed, TOL_UV
        else:
            err, tol = np.abs(a - b).max() / np.abs(b).max(), TOL_HA
        assert err < tol, (case, name, err)
    if m64.grid.solid_cc is not None:
        land = np.asarray(I64(m64.grid.solid_cc)) > 0.5
        assert (get(I32, s32, "h")[land] == 0).all()
        assert (get(I32, s32, "u")[land] == 0).all()
