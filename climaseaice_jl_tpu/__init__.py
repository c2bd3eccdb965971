"""climaseaice_jl_tpu — a JAX sea-ice modeling framework.

A from-scratch JAX/XLA re-design of the capabilities of
CliMA/ClimaSeaIce.jl (reference mounted read-only at /root/reference): slab
and layered snow+ice thermodynamics, flux-form WENO/upwind advection,
viscous and elasto-visco-plastic (αEVP) rheologies with explicit and
split-explicit momentum solvers, Forward-Euler and low-storage split-RK3
time stepping, immersed boundaries, and SPMD multi-device execution over a
`jax.sharding.Mesh` with ppermute halo exchange.

Design: immutable state pytree + pure jitted ``step(model, state, dt)``.
"""

from .grids import (RectilinearGrid, LatitudeLongitudeGrid, ImmersedBoundaryGrid,
                    CurvilinearGrid, TripolarGrid, with_halo, Grid)
from .state import SeaIceState, Clock, ModelFields
from .model import (SeaIceModel, sea_ice_model, initial_state, set_fields,
                    step, step_unjitted, update_state, make_fields,
                    cell_advection_timescale)
from .simulation import Simulation, Callback, IterationInterval, TimeInterval
from .advection import Centered, UpwindBiased, WENO, FluxFormAdvection
from .thermodynamics import (LinearLiquidus, PhaseTransitions, melting_temperature,
                             latent_heat, PrescribedTemperature,
                             MeltingConstrainedFluxBalance, IceWaterThermalEquilibrium,
                             RadiativeEmission, FluxFunction, getflux,
                             ConductiveFlux, IceSnowConductiveFlux,
                             ProportionalEvolution, SlabThermodynamics,
                             sea_ice_slab_thermodynamics, snow_slab_thermodynamics)
from .dynamics import (FPlane, BetaPlane, LatitudeCoriolis, SemiImplicitStress, StressFunction, StressBalanceFreeDrift,
                       ViscousRheology, ElastoViscoPlasticRheology,
                       SeaIceMomentumEquation, ExplicitSolver, SplitExplicitSolver,
                       ImmersedDrag, ImmersedStressBC)

__version__ = "0.1.0"
