"""Dynamical (shallow-water) ocean tests: the JAX analog of the
reference coupling prototype's Oceananigans ocean
(`validation/ice_ocean_model/melting_baroclinicity.jl:60-76`)."""

import numpy as np

import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu import coupled as cp
from climaseaice_jl_tpu.ocean import (ShallowWaterOcean,
                                      shallow_water_substeps, advect_tracer,
                                      surface_stresses)

km = 1000.0
hour = 3600.0


def _ice(grid, **kw):
    return csi.sea_ice_model(grid, top_heat_flux=0.0, bottom_heat_flux=0.0,
                             ice_salinity=5.0, timestepper="ForwardEuler", **kw)


def test_lake_at_rest_is_exactly_steady():
    """Well-balancedness: flat η, no wind, bounded walls + immersed island →
    the discrete state is an exact fixed point (no spurious metric/pressure
    currents)."""
    grid = csi.RectilinearGrid(size=(16, 16), x=(0, 100 * km), y=(0, 100 * km),
                               topology=("bounded", "bounded"))
    solid = np.zeros((16, 16), bool)
    solid[6:9, 6:9] = True
    grid = csi.ImmersedBoundaryGrid(grid, solid)
    ocean = ShallowWaterOcean(depth=50.0, coriolis=csi.FPlane(f=1e-4),
                              bottom_drag=1e-3, substeps=8)
    u = grid.new_field(); v = grid.new_field(); eta = grid.new_field()
    u2, v2, eta2 = shallow_water_substeps(grid, ocean, u, v, eta,
                                          grid.new_field(), grid.new_field(),
                                          1800.0)
    assert np.array_equal(np.asarray(u2), np.asarray(u))
    assert np.array_equal(np.asarray(v2), np.asarray(v))
    assert np.array_equal(np.asarray(eta2), np.asarray(eta))


def test_gravity_wave_volume_conservation():
    """Periodic η bump: flux-form continuity conserves ∑η·Az to roundoff and
    the adjustment stays bounded (gravity-wave CFL respected by substeps)."""
    N = 32
    grid = csi.RectilinearGrid(size=(N, N), x=(0, 200 * km), y=(0, 200 * km))
    ocean = ShallowWaterOcean(depth=100.0, coriolis=csi.FPlane(f=1e-4),
                              bottom_drag=0.0, substeps=64)
    x = (np.arange(N) + 0.5) * (200 * km / N)
    xc, yc = np.meshgrid(x, x, indexing="ij")
    eta0 = 0.1 * np.exp(-((xc - 100 * km) ** 2 + (yc - 100 * km) ** 2)
                        / (30 * km) ** 2)
    eta = grid.field_from(eta0)
    u = grid.new_field(); v = grid.new_field()
    vol0 = float(np.sum(np.asarray(grid.interior(eta))))
    for _ in range(5):
        u, v, eta = shallow_water_substeps(grid, ocean, u, v, eta,
                                           grid.new_field(), grid.new_field(),
                                           1800.0)
    e = np.asarray(grid.interior(eta))
    assert np.isfinite(e).all()
    assert abs(float(np.sum(e)) - vol0) < 1e-9 * max(abs(vol0), 1.0)
    assert np.abs(e).max() < 0.2              # no blow-up
    assert np.abs(np.asarray(grid.interior(u))).max() < 1.0


def test_wind_driven_drag_balance():
    """Constant wind over open water spins the layer up toward the quadratic
    bottom-drag balance u* = sqrt(τ/(ρ C_d)) (f = 0, periodic)."""
    N = 8
    grid = csi.RectilinearGrid(size=(N, N), x=(0, 100 * km), y=(0, 100 * km))
    tau = 0.1
    ocean = ShallowWaterOcean(depth=20.0, coriolis=None, bottom_drag=2e-3,
                              wind_stress_x=tau, substeps=4)
    u = grid.new_field(); v = grid.new_field(); eta = grid.new_field()
    a = grid.new_field()  # ice-free
    for _ in range(400):
        tu, tv = surface_stresses(grid, ocean, grid.new_field(),
                                  grid.new_field(), a, u, v)
        u, v, eta = shallow_water_substeps(grid, ocean, u, v, eta, tu, tv,
                                           1800.0)
    u_star = np.sqrt(tau / (ocean.density * ocean.bottom_drag))
    u_end = float(np.asarray(grid.interior(u)).mean())
    assert abs(u_end - u_star) / u_star < 0.05, (u_end, u_star)


def test_tracer_advection_monotone_and_compensated():
    """Advective-form WENO transport under a divergent SW flow: tracer stays
    within its initial bounds (no divergence-induced over/undershoot)."""
    N = 32
    grid = csi.RectilinearGrid(size=(N, N), x=(0, 200 * km), y=(0, 200 * km))
    ocean = ShallowWaterOcean(depth=100.0, substeps=32, bottom_drag=0.0)
    x = (np.arange(N) + 0.5) * (200 * km / N)
    xc, yc = np.meshgrid(x, x, indexing="ij")
    eta = grid.field_from(0.2 * np.sin(2 * np.pi * xc / (200 * km)))
    T = grid.field_from(1.0 + np.cos(2 * np.pi * yc / (200 * km)))
    u = grid.new_field(); v = grid.new_field()
    Tmin, Tmax = 0.0, 2.0
    for _ in range(10):
        u, v, eta = shallow_water_substeps(grid, ocean, u, v, eta,
                                           grid.new_field(), grid.new_field(),
                                           1800.0)
        T = advect_tracer(grid, ocean, u, v, T, 1800.0)
    Ti = np.asarray(grid.interior(T))
    assert np.isfinite(Ti).all()
    assert Ti.min() > Tmin - 5e-3 and Ti.max() < Tmax + 5e-3


def test_coupled_dynamic_ocean_ice_drag_drives_currents():
    """Full coupling: wind-driven ice (free drift) over a quiescent dynamical
    ocean drags the ocean into motion; fields stay finite and brine/heat
    coupling still operates."""
    N = 16
    grid = csi.RectilinearGrid(size=(N, N), x=(0, 100 * km), y=(0, 100 * km))
    dynamics = csi.StressBalanceFreeDrift(
        top_momentum_stress={"u": 0.1, "v": 0.0},
        bottom_momentum_stress=csi.SemiImplicitStress())
    ice = _ice(grid, dynamics=dynamics)
    ocean = ShallowWaterOcean(depth=30.0, coriolis=csi.FPlane(f=1.2e-4),
                              substeps=8)
    iom = cp.IceOceanModel(ice=ice, ocean=ocean)
    state = cp.initial_state(iom, T_ocean=-1.0, S_ocean=30.0, h=1.0, a=1.0)
    for _ in range(20):
        state = cp.coupled_step(iom, state, 1200.0)
    g = grid
    uo = np.asarray(g.interior(state.u_ocean))
    ui = np.asarray(g.interior(state.ice.u))
    assert np.isfinite(uo).all() and np.isfinite(ui).all()
    assert np.abs(ui).max() > 1e-3            # ice in free drift
    assert np.abs(uo).max() > 1e-5            # ocean responds to ice drag
    assert np.abs(uo).max() < np.abs(ui).max()  # ...but lags the ice
    T = np.asarray(g.interior(state.T_ocean))
    Tm = np.asarray(csi.melting_temperature(
        iom.ice.phase_transitions.liquidus,
        np.asarray(g.interior(state.S_ocean))))
    np.testing.assert_allclose(T, Tm, atol=1e-2)  # icy cells pinned near Tm
