"""Ice melting over a dynamical (shallow-water) ocean — the JAX
analog of the reference's `validation/ice_ocean_model/melting_baroclinicity.jl`:
an ice pack over an ocean with prognostic currents, warm anomaly melting the
ice from below, brine/meltwater salinity coupling, and wind-driven ice drift
dragging the ocean into motion."""

import numpy as np

import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu import coupled as cp
from climaseaice_jl_tpu.ocean import ShallowWaterOcean

km, day, hour = 1000.0, 86400.0, 3600.0


def build(N=128):
    grid = csi.RectilinearGrid(size=(N, N), x=(-50 * km, 50 * km),
                               y=(-50 * km, 50 * km),
                               topology=("periodic", "bounded"))
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(),
        coriolis=csi.FPlane(f=1.4e-4),
        top_momentum_stress={"u": 0.05, "v": 0.0},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=120))
    ice = csi.sea_ice_model(
        grid, dynamics=dynamics,
        top_heat_flux=(csi.RadiativeEmission(),), bottom_heat_flux=0.0,
        ice_salinity=5.0, advection=csi.WENO(order=7),
        timestepper="SplitRungeKutta3")
    ocean = ShallowWaterOcean(depth=50.0, coriolis=csi.FPlane(f=1.4e-4),
                              wind_stress_x=0.05, substeps=24,
                              tracer_diffusivity=20.0)
    iom = cp.IceOceanModel(ice=ice, ocean=ocean)

    # warm strip in the channel center (the melting anomaly), cold elsewhere
    x = (np.arange(N) + 0.5) * (100 * km / N) - 50 * km
    xc, yc = np.meshgrid(x, x, indexing="ij")
    T0 = -1.5 + 2.5 * np.exp(-(yc / (15 * km)) ** 2)
    state = cp.initial_state(iom, T_ocean=T0, S_ocean=30.0, h=1.0, a=1.0)
    return iom, state


def main(days=10.0, N=128):
    iom, state = build(N)
    g = iom.ice.grid
    dt = 20 * 60.0
    n = int(days * day / dt)
    for k in range(n):
        state = cp.coupled_step(iom, state, dt)
    h = np.asarray(g.interior(state.ice.h))
    T = np.asarray(g.interior(state.T_ocean))
    S = np.asarray(g.interior(state.S_ocean))
    uo = np.asarray(g.interior(state.u_ocean))
    ui = np.asarray(g.interior(state.ice.u))
    np.savez("melting_over_dynamic_ocean.npz", h=h, T=T, S=S, uo=uo, ui=ui)
    print(f"after {days:.0f} days: h in [{h.min():.3f}, {h.max():.3f}] m "
          f"(warm strip melts); S in [{S.min():.2f}, {S.max():.2f}] "
          f"(meltwater freshening); |u_ice|max {np.abs(ui).max():.3f} m/s, "
          f"|u_ocean|max {np.abs(uo).max():.3f} m/s")
    assert np.isfinite(h).all() and np.isfinite(uo).all()
    return state


if __name__ == "__main__":
    main()
