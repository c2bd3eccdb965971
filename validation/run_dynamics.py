"""2-D dynamics validation runs (float32)."""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import numpy as np
import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu import step as model_step

km, minute, day = 1000.0, 60.0, 86400.0

# 1. ice advected by anticyclone: 2 days, 128^2, 150 substeps (f32)
import ice_advected_by_anticyclone as anti
model, state = anti.build(N=128, substeps=150, dtype="float32")
dt = 2 * minute
n = int(2 * day / dt)
for k in range(n):
    t = float(state.clock.time)
    tau_u, tau_v = anti.wind_stress_arrays(model.grid, t)
    model = model.evolve(dynamics=model.dynamics.evolve(
        top_momentum_stress={"u": tau_u.astype(np.float32),
                             "v": tau_v.astype(np.float32)}))
    state = model_step(model, state, dt)
I = model.grid.interior
h = np.asarray(I(state.h)); u = np.asarray(I(state.u)); a = np.asarray(I(state.a))
print(f"[anticyclone 2d] h in [{h.min():.3f},{h.max():.3f}] m, |u|max={np.abs(u).max():.3f} m/s, "
      f"amin={a.min():.3f}, finite={np.isfinite(h).all()}")
np.savez("validation/anticyclone_final.npz", h=h, u=u, a=a)

# 2. coastline: 3 days, 256x128, 150 substeps
import ice_advected_on_coastline as coast
model2, state2 = coast.build(Nx=256, Ny=128, substeps=150)
# rebuild at f32
grid = csi.RectilinearGrid(size=(256, 128), x=(-256*km, 256*km), y=(0, 256*km),
                           halo=4, topology=("periodic", "bounded"), dtype="float32")
def land(x, y):
    Lx, Ly, Nx, Ny = 512*km, 256*km, 256, 128
    ocean = (y <= Ly/2) & (np.abs(x/Lx)*Nx + y/Ly*Ny > 24)
    return ~ocean
grid = csi.ImmersedBoundaryGrid(grid, land)
dyn = csi.SeaIceMomentumEquation(
    rheology=csi.ElastoViscoPlasticRheology(),
    top_momentum_stress={"u": -1.3*1.2e-3*100.0, "v": 0.0},
    bottom_momentum_stress=csi.SemiImplicitStress(),
    immersed_drag=csi.ImmersedDrag(coefficient=3e-3),
    solver=csi.SplitExplicitSolver(substeps=150))
model2 = csi.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                           advection=csi.WENO(order=7), timestepper="SplitRungeKutta3")
state2 = csi.initial_state(model2, h=1.0, a=1.0)
dt = 5 * minute
for _ in range(int(3 * day / dt)):
    state2 = model_step(model2, state2, dt)
I2 = grid.interior
h2 = np.asarray(I2(state2.h)); land_m = np.asarray(I2(grid.solid_cc))
print(f"[coastline 3d] h in [{h2[~land_m].min():.2f},{h2[~land_m].max():.2f}] m "
      f"(ridging against coast), land h==0: {bool((h2[land_m]==0).all())}, "
      f"finite={np.isfinite(h2).all()}")
np.savez("validation/coastline_final.npz", h=h2)
