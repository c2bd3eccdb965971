"""Distributed ≡ serial on curvilinear and tripolar grids.

Port of the reference's hardest distributed test: an *immersed tripolar* grid
with the Zipper fold crossing the top rank (`test/distributed_tests_utils.jl:
170-259`), plus a warped general-curvilinear variant and the fold on x-split
meshes (the reference only exercises y-splits; a 2-D-mesh arctic run needs
the cross-shard fold pairing ix ↔ Px−1−ix).
"""

import numpy as np
import pytest

import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu.grids import CurvilinearGrid, TripolarGrid
from climaseaice_jl_tpu.parallel import make_distributed_step
from climaseaice_jl_tpu.parallel.stepper import strip_halos, unstrip_halos


def _run_serial(model, state, steps, dt):
    for _ in range(steps):
        state = csi.step(model, state, dt)
    return state


def _run_distributed(model, state, steps, dt, mesh_shape):
    dstep, mesh = make_distributed_step(model, mesh_shape)
    s = strip_halos(model, state)
    for _ in range(steps):
        s = dstep(s, dt)
    return unstrip_halos(model, s)


def _assert_state_equal(model, serial, dist, names=("u", "v", "h", "a"),
                        rtol=1e-7, atol=1e-9, msg=""):
    I = model.grid.interior
    for name in names:
        a = np.asarray(I(getattr(serial, name)))
        b = np.asarray(I(getattr(dist, name)))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{name} mismatch {msg}")


def _dynamics(substeps=6):
    # strict-equality tests run in the contractive αEVP regime (see
    # tests/test_distributed.py::_build docstring)
    return csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(max_relaxation_parameter=1e4),
        top_momentum_stress={"u": 0.02, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=substeps))


def _warped_corners(Nx=32, Ny=32):
    i = np.arange(Nx + 1)[:, None]
    j = np.arange(Ny + 1)[None, :]
    lam = 360.0 * i / Nx + 4.0 * np.sin(2 * np.pi * j / Ny)
    phi = 20.0 + 40.0 * j / Ny + 3.0 * np.sin(2 * np.pi * i / Nx) * (j / Ny)
    lam[-1] = lam[0] + 360.0
    phi[-1] = phi[0]
    return lam, phi


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_distributed_curvilinear_equals_serial(mesh_shape):
    """Fully 2-D metric arrays sharded correctly (slice_metric both dims)."""
    lam, phi = _warped_corners()
    grid = CurvilinearGrid(lam, phi, halo=5)
    model = csi.sea_ice_model(grid, dynamics=_dynamics(), ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    rng = np.random.default_rng(7)
    state = csi.initial_state(model, h=0.5 + 0.1 * rng.random((32, 32)), a=1.0,
                              u=0.05)
    serial = _run_serial(model, state, 5, 60.0)
    dist = _run_distributed(model, state, 5, 60.0, mesh_shape)
    _assert_state_equal(model, serial, dist, msg=f"curvilinear {mesh_shape}")


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_distributed_immersed_tripolar_equals_serial(mesh_shape):
    """The reference's hardest distributed case: immersed TripolarGrid, land
    mask crossing shards, Zipper fold on the top rank
    (`distributed_tests_utils.jl:170-259`)."""
    grid = TripolarGrid((32, 32), southernmost_latitude=-70.0, halo=5)

    # land wedge reaching across the fold region and the southern rows
    Nx, Ny = grid.Nx, grid.Ny
    land = np.zeros((Nx, Ny), bool)
    land[:, :3] = True                    # southern cap (like a coast)
    land[10:16, 20:] = True               # meridional landmass into the cap
    grid = csi.ImmersedBoundaryGrid(grid, land)

    model = csi.sea_ice_model(grid, dynamics=_dynamics(), ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    rng = np.random.default_rng(3)
    state = csi.initial_state(model, h=0.5 + 0.1 * rng.random((Nx, Ny)),
                              a=1.0, u=0.05)
    serial = _run_serial(model, state, 5, 60.0)
    dist = _run_distributed(model, state, 5, 60.0, mesh_shape)
    _assert_state_equal(model, serial, dist, msg=f"tripolar {mesh_shape}")


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_folded_x_split_equals_serial(mesh_shape):
    """north_fold with the x direction split across the mesh: the fold pairs
    shard ix with shard Px−1−ix (cross-shard all_gather fold fill)."""
    km = 1000.0
    grid = csi.RectilinearGrid(size=(32, 32), x=(0, 100 * km), y=(0, 100 * km),
                               halo=5, topology=("periodic", "bounded"),
                               north_fold=True)
    model = csi.sea_ice_model(grid, dynamics=_dynamics(), ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")

    def h0(x, y):
        return 0.5 + 0.1 * np.sin(2 * np.pi * x / (100 * km)) \
            + 0.05 * np.cos(2 * np.pi * y / (100 * km))

    state = csi.initial_state(model, h=h0, a=1.0, v=0.02)
    serial = _run_serial(model, state, 5, 60.0)
    dist = _run_distributed(model, state, 5, 60.0, mesh_shape)
    _assert_state_equal(model, serial, dist, msg=f"fold x-split {mesh_shape}")


# --- wide-halo (communication-avoiding) EVP beyond rectilinear grids ---------

def test_with_halo_latlon_and_tripolar_exact():
    """with_halo on latlon reproduces direct construction bit-exactly; on a
    tripolar grid the re-padded metrics match a fresh pad of the same
    interior (`split_explicit_momentum_equations.jl:48-64` halo math)."""
    from climaseaice_jl_tpu.grids import (LatitudeLongitudeGrid, with_halo)
    g4 = LatitudeLongitudeGrid((16, 12), longitude=(0, 360), latitude=(-60, 60),
                               halo=4)
    g9 = LatitudeLongitudeGrid((16, 12), longitude=(0, 360), latitude=(-60, 60),
                               halo=9)
    w9 = with_halo(g4, 9)
    for name in ("xc", "xf", "yc", "yf", "dx_cc", "dx_cf", "dy_cc",
                 "az_cc", "az_cf"):
        np.testing.assert_array_equal(np.asarray(getattr(w9, name)),
                                      np.asarray(getattr(g9, name)), err_msg=name)

    tp = TripolarGrid((16, 16), halo=4)
    tw = with_halo(tp, 7)
    assert tw.Hx == 7 and tw.north_fold and tw.kind == "curvilinear"
    for name in ("dx_cc", "dx_ff", "dy_cf", "az_cc", "az_ff"):
        a = np.asarray(tp.interior(getattr(tp, name)))
        b = np.asarray(tw.interior(getattr(tw, name)))
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("build", ["latlon", "bounded_rect", "tripolar"])
def test_wide_halo_evp_beyond_rectilinear(build):
    """Communication-avoiding wide-halo EVP on the grids where the arctic
    basin lives (latlon/tripolar), plus a bounded rectilinear case that
    exercises the wall-BC refresh in local-only fills."""
    km = 1000.0
    if build == "latlon":
        grid = csi.LatitudeLongitudeGrid((32, 32), longitude=(0, 90),
                                         latitude=(20, 60), halo=5)
        mesh_shape = (1, 2)
    elif build == "bounded_rect":
        grid = csi.RectilinearGrid(size=(32, 32), x=(0, 100 * km),
                                   y=(0, 100 * km), halo=5,
                                   topology=("bounded", "bounded"))
        mesh_shape = (2, 2)
    else:
        grid = TripolarGrid((32, 32), southernmost_latitude=-70.0, halo=5)
        mesh_shape = (1, 2)

    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(max_relaxation_parameter=1e4),
        top_momentum_stress={"u": 0.02, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=3, halo_exchange="wide"))
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    rng = np.random.default_rng(13)
    state = csi.initial_state(model, h=0.5 + 0.1 * rng.random((32, 32)),
                              a=1.0, u=0.05)
    serial = _run_serial(model, state, 5, 60.0)
    dist = _run_distributed(model, state, 5, 60.0, mesh_shape)
    _assert_state_equal(model, serial, dist, msg=f"wide {build}")


def test_wide_halo_fold_x_split_rejected():
    grid = csi.RectilinearGrid(size=(32, 32), halo=5,
                               topology=("periodic", "bounded"), north_fold=True)
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(),
        solver=csi.SplitExplicitSolver(substeps=3, halo_exchange="wide"))
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None)
    with pytest.raises(NotImplementedError, match="fold"):
        make_distributed_step(model, (2, 2))


# --- float32 on the flagship grid family ------------------------------------
# The precision the GPU runs.  Serial and per-shard executables are compiled
# for different shapes, so they agree to roundoff, not bitwise; on these
# grids (varied thickness, soft ice) roundoff is not amplified: measured on
# the CPU ≤ 2.5e-7 of the largest speed for u, v and ≤ 1.4e-6 for σ, h, ℵ.
F32_TOL = 1e-5


def _f32_tripolar(Nx, Ny, land_block, halo_exchange, advect, seed):
    grid = TripolarGrid((Nx, Ny), southernmost_latitude=-70.0, halo=5,
                        dtype="float32")
    land = np.zeros((Nx, Ny), bool)
    land[:, :3] = True                    # southern cap
    land[land_block] = True               # landmass reaching the fold
    grid = csi.ImmersedBoundaryGrid(grid, land)
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        top_momentum_stress={"u": 0.02, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=8,
                                       halo_exchange=halo_exchange))
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=csi.WENO(order=7) if advect else None,
                              timestepper="ForwardEuler")
    rng = np.random.default_rng(seed)
    state = csi.initial_state(model, h=0.5 + 0.1 * rng.random((Nx, Ny)),
                              a=1.0, u=0.05)
    return model, state


def _assert_f32_close(model, serial, dist, names, msg):
    I = model.grid.interior
    vel_scale = max(np.abs(np.asarray(I(serial.u))).max(),
                    np.abs(np.asarray(I(serial.v))).max(), 1e-8)
    for name in names:
        a = np.asarray(I(getattr(serial, name)))
        b = np.asarray(I(getattr(dist, name)))
        assert np.isfinite(b).all(), name
        scale = vel_scale if name in ("u", "v") else max(np.abs(a).max(), 1e-8)
        err = np.abs(a - b).max() / scale
        assert err < F32_TOL, f"{name} {msg}: {err}"


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("advect", [False, True])
def test_f32_tripolar_serial_equals_distributed(advect, mesh_shape):
    """float32 serial ≡ distributed on an immersed TripolarGrid with the
    fold on the top rank and wide-halo EVP (`distributed_tests_utils.jl:
    170-259`); ``advect=True`` runs the full dynamics step with WENO-7."""
    model, state = _f32_tripolar(32, 96, np.s_[10:16, 80:], "wide", advect,
                                 seed=11)
    serial = _run_serial(model, state, 5, 60.0)
    dist = _run_distributed(model, state, 5, 60.0, mesh_shape)
    names = ("u", "v", "sig11", "sig12", "alpha") + (("h", "a") if advect
                                                     else ())
    _assert_f32_close(model, serial, dist, names, f"{mesh_shape}")


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_f32_tripolar_xmeshed_fold_equals_serial(mesh_shape):
    """float32 serial ≡ distributed with the fold split across the x mesh
    (reference x-splitting partitions, `distributed_tests_utils.jl:231-257`):
    per-substep exchange with the cross-shard fold pairing, WENO-7 on."""
    model, state = _f32_tripolar(48, 96, np.s_[18:30, 80:], "per_substep",
                                 True, seed=13)
    serial = _run_serial(model, state, 3, 60.0)
    dist = _run_distributed(model, state, 3, 60.0, mesh_shape)
    _assert_f32_close(model, serial, dist,
                      ("u", "v", "sig11", "sig12", "alpha", "h", "a"),
                      f"{mesh_shape}")


def _seasonal_fluxes():
    import jax.numpy as jnp
    from climaseaice_jl_tpu.forcing_utils import FieldTimeSeries
    day = 86400.0
    fts = FieldTimeSeries(times=(np.arange(12) * 30 * day).astype(np.float32),
                          data=(np.sin(np.arange(12)) * 60.0 - 20.0
                                ).astype(np.float32),
                          cyclical=True)

    def solar(grid_, Tu, clock, fields, p):
        lat = jnp.asarray(grid_.lat_cc, jnp.float32)
        sw = jnp.clip(jnp.cos(lat * np.pi / 180.0) / 0.5, 0.3, 1.6)
        albedo = jnp.where(Tu < -0.1, 0.75, 0.64)
        return p.at_time(clock.time) * sw * (1 - albedo)

    return (csi.FluxFunction(func=solar, parameters=fts,
                             top_temperature_dependent=True),
            csi.RadiativeEmission(), -15.0)


@pytest.mark.parametrize("mesh_shape,halo_exchange",
                         [((1, 4), "wide"), ((2, 2), "per_substep")])
def test_f32_full_physics_serial_equals_distributed(mesh_shape, halo_exchange):
    """Full physics in float32 (EVP at the reference α⁺ = 300 + WENO-7 +
    slab ice + snow + a seasonal FluxFunction solved by the secant) on an
    immersed tripolar grid: serial ≡ distributed to the stated tolerance,
    the reference's whole-model decomposition contract
    (`distributed_tests_utils.jl:83-86`)."""
    grid = TripolarGrid((48, 96), southernmost_latitude=-70.0, halo=5,
                        dtype="float32")
    land = np.zeros((48, 96), bool)
    land[:, :3] = True
    land[18:30, 80:] = True
    grid = csi.ImmersedBoundaryGrid(grid, land)
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(),
        top_momentum_stress={"u": 0.02, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=8,
                                       halo_exchange=halo_exchange))
    model = csi.sea_ice_model(
        grid, dynamics=dynamics,
        ice_thermodynamics=csi.sea_ice_slab_thermodynamics(),
        snow_thermodynamics=csi.snow_slab_thermodynamics(),
        snowfall=3.2e-6, top_heat_flux=_seasonal_fluxes(),
        bottom_heat_flux=-2.0, advection=csi.WENO(order=7),
        timestepper="ForwardEuler")
    rng = np.random.default_rng(7)
    state = csi.initial_state(model, h=0.5 + 0.5 * rng.random((48, 96)),
                              a=0.9, hs=0.05, u=0.02)
    serial = _run_serial(model, state, 3, 600.0)
    dist = _run_distributed(model, state, 3, 600.0, mesh_shape)
    _assert_f32_close(model, serial, dist,
                      ("u", "v", "h", "a", "hs", "Tu", "Tus"),
                      f"{mesh_shape} {halo_exchange}")
