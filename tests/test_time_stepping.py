"""Model construction + stepping smoke matrix and drag physics.

Port of `test/test_time_stepping.jl`: the cartesian product of
{rheology} × {advection} × {thermo} × {snow} × {coriolis} × {solver} runs one
step and advances the clock; plus the SemiImplicitStress ocean-drag
monotonicity test (ice accelerates toward uₒ without overshoot).
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

import climaseaice_jl_tpu as csi


def _steps_ok(grid, dynamics=None, ice_thermodynamics=None,
              snow_thermodynamics=None, advection=None):
    model = csi.sea_ice_model(grid, dynamics=dynamics,
                              ice_thermodynamics=ice_thermodynamics,
                              snow_thermodynamics=snow_thermodynamics,
                              advection=advection)
    kw = dict(h=1, a=1)
    if snow_thermodynamics is not None:
        kw["hs"] = 0.1
    state = csi.initial_state(model, **kw)
    state = csi.step(model, state, 1.1)
    return (int(state.clock.iteration) == 1
            and float(state.clock.time) == pytest.approx(1.1)
            and np.isfinite(np.asarray(state.h)).all()
            and np.isfinite(np.asarray(state.u)).all())


RHEOLOGIES = [csi.ElastoViscoPlasticRheology(), csi.ViscousRheology(nu=1000.0)]
ADVECTIONS = [csi.WENO(order=5), csi.UpwindBiased(order=5)]
CORIOLISES = [None, csi.FPlane(f=1e-4), csi.BetaPlane(f0=1e-4, beta=1e-11)]
SOLVERS = [csi.ExplicitSolver(), csi.SplitExplicitSolver(substeps=10)]


@pytest.mark.parametrize("rheology", RHEOLOGIES, ids=["EVP", "Viscous"])
@pytest.mark.parametrize("advection", ADVECTIONS, ids=["WENO5", "UB5"])
@pytest.mark.parametrize("coriolis", CORIOLISES, ids=["noF", "FPlane", "BetaPlane"])
@pytest.mark.parametrize("solver", SOLVERS, ids=["Explicit", "SplitExplicit"])
def test_stepping_matrix(rheology, advection, coriolis, solver):
    grid = csi.RectilinearGrid(size=(10, 10), topology=("bounded", "bounded"))
    dynamics = csi.SeaIceMomentumEquation(rheology=rheology, coriolis=coriolis,
                                          solver=solver)
    assert _steps_ok(grid, dynamics=dynamics,
                     ice_thermodynamics=csi.sea_ice_slab_thermodynamics(),
                     advection=advection)


@pytest.mark.parametrize("thermo", [None, "slab"], ids=["nothermo", "slab"])
@pytest.mark.parametrize("snow", [None, "slab"], ids=["nosnow", "snow"])
def test_stepping_thermo_combinations(thermo, snow):
    grid = csi.RectilinearGrid(size=(10, 10), topology=("bounded", "bounded"))
    dynamics = csi.SeaIceMomentumEquation(rheology=csi.ElastoViscoPlasticRheology(),
                                          solver=csi.SplitExplicitSolver(substeps=10))
    assert _steps_ok(
        grid, dynamics=dynamics,
        ice_thermodynamics=csi.sea_ice_slab_thermodynamics() if thermo else None,
        snow_thermodynamics=csi.snow_slab_thermodynamics() if snow else None,
        advection=csi.WENO(order=5))


@pytest.mark.parametrize("solver", [csi.ExplicitSolver(),
                                    csi.SplitExplicitSolver(substeps=10)],
                         ids=["Explicit", "SplitExplicit"])
def test_semi_implicit_ocean_drag(solver):
    """`test_time_stepping.jl:56-90`: ocean drag accelerates resting ice toward
    uₒ monotonically without overshoot."""
    grid = csi.RectilinearGrid(size=(8, 8), x=(0, 10_000), y=(0, 10_000),
                               topology=("periodic", "periodic"))
    u_o = 0.1
    tau_o = csi.SemiImplicitStress(ue=u_o)
    dynamics = csi.SeaIceMomentumEquation(rheology=csi.ElastoViscoPlasticRheology(),
                                          bottom_momentum_stress=tau_o,
                                          solver=solver)
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None)
    state = csi.initial_state(model, h=1, a=1, u=0, v=0)

    for _ in range(20):
        state = csi.step(model, state, 60.0)

    u = np.asarray(grid.interior(state.u))
    assert np.isfinite(u).all()
    assert u.max() > 0
    assert u.max() <= u_o + 1e-12


def test_free_drift_only_dynamics():
    """Free drift usable as the entire dynamics
    (`stress_balance_free_drift.jl:132-151`)."""
    grid = csi.RectilinearGrid(size=(8, 8))
    tau_o = csi.SemiImplicitStress(ue=0.2, ve=0.0)
    fd = csi.StressBalanceFreeDrift(top_momentum_stress=0.0,
                                    bottom_momentum_stress=tau_o)
    model = csi.sea_ice_model(grid, dynamics=fd, ice_thermodynamics=None)
    state = csi.initial_state(model, h=1, a=1)
    state = csi.step(model, state, 60.0)
    u = np.asarray(grid.interior(state.u))
    assert np.allclose(u, 0.2)  # zero top stress → ice moves with the ocean


def test_evp_on_latitude_longitude_grid():
    """Full EVP + advection on curvilinear (lat-lon) metrics stays finite and
    physical — exercises the general metric-aware operators end-to-end."""
    grid = csi.LatitudeLongitudeGrid(size=(24, 16), longitude=(0, 360),
                                     latitude=(60, 84),
                                     topology=("periodic", "bounded"), halo=4)
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(),
        coriolis=csi.BetaPlane(f0=1.4e-4, beta=0.0),
        top_momentum_stress={"u": 0.05, "v": 0.0},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=10))
    model = csi.sea_ice_model(grid, dynamics=dynamics,
                              ice_thermodynamics=csi.sea_ice_slab_thermodynamics(),
                              top_heat_flux=-20.0, bottom_heat_flux=-5.0,
                              advection=csi.WENO(order=5))
    state = csi.initial_state(model, h=1.0, a=1.0)
    for _ in range(5):
        state = csi.step(model, state, 300.0)
    I = grid.interior
    for name in ("u", "v", "h", "a", "Tu"):
        q = np.asarray(I(getattr(state, name)))
        assert np.isfinite(q).all(), name
    assert np.abs(np.asarray(I(state.u))).max() < 1.0  # physical speeds


def test_callable_time_dependent_stress():
    """A stress callable f(grid, clock, fields) is evaluated in-step: the
    functional analog of the reference's per-iteration wind-refresh callback
    (`examples/ice_advected_by_anticyclone.jl`)."""
    import numpy as np

    grid = csi.RectilinearGrid(size=(16, 16), x=(0, 16e3), y=(0, 16e3),
                               topology=("periodic", "periodic"))

    def tau_u(grid, clock, fields):
        return 0.1 * jnp.sin(2 * jnp.pi * clock.time / 86400.0) * jnp.ones(grid.shape, grid.np_dtype)

    dyn = csi.SeaIceMomentumEquation(
        top_momentum_stress={"u": csi.StressFunction(func=tau_u), "v": 0.0},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        rheology=csi.ElastoViscoPlasticRheology(),
        solver=csi.SplitExplicitSolver(substeps=20),
    )
    model = csi.sea_ice_model(grid=grid, dynamics=dyn, ice_thermodynamics=None)

    state = csi.initial_state(model, h=1.0, a=1.0)
    s1 = csi.step(model, state, 600.0)       # τ(t=0) = 0 → no motion
    assert float(jnp.max(jnp.abs(s1.u))) == 0.0
    s1 = dataclasses.replace(s1, clock=csi.Clock(time=jnp.asarray(21600.0), iteration=s1.clock.iteration))
    s2 = csi.step(model, s1, 600.0)          # τ(t=6h) = 0.1 → accelerates
    assert float(jnp.max(jnp.abs(s2.u))) > 0.0
    assert bool(jnp.all(jnp.isfinite(s2.u)))

    # equivalence with the equivalent static-array stress at fixed time
    dyn_static = dataclasses.replace(
        dyn, top_momentum_stress={"u": np.asarray(tau_u(grid, csi.Clock(time=jnp.asarray(21600.0)), None)), "v": 0.0})
    model_s = csi.sea_ice_model(grid=grid, dynamics=dyn_static, ice_thermodynamics=None)
    s2s = csi.step(model_s, s1, 600.0)
    assert float(jnp.max(jnp.abs(s2.u - s2s.u))) < 1e-13
