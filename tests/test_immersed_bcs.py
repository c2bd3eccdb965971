"""General immersed stress boundary conditions and function-valued viscosity.

Ports of `src/Rheologies/ice_stress_divergence.jl:57-123` (immersed flux BCs
via `ImmersedBoundaryCondition` + discrete-form `FluxBoundaryCondition`) and
`src/Rheologies/viscous_rheology.jl:5-23` (constant/field/function ν).
"""

import numpy as np
import pytest

import climaseaice_jl_tpu as csi


def _coastline_model(immersed_drag, substeps=8):
    """ice_advected_on_coastline-style setup: bounded y, triangular coast."""
    km = 1000.0
    grid = csi.RectilinearGrid(size=(32, 16), x=(0, 64 * km), y=(0, 32 * km),
                               halo=5, topology=("periodic", "bounded"))

    def coast(x, y):
        return y < 8 * km * (1 - np.abs(x / (32 * km) - 1))

    grid = csi.ImmersedBoundaryGrid(grid, coast)
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(),
        top_momentum_stress={"u": 0.1, "v": 0.0},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        immersed_drag=immersed_drag,
        solver=csi.SplitExplicitSolver(substeps=substeps))
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    state = csi.initial_state(model, h=1.0, a=1.0)
    return model, state


def test_immersed_stress_bc_matches_immersed_drag():
    """A user-supplied flux BC −C·u (the reference coastline example's exact
    BC, `examples/ice_advected_on_coastline.jl:91-98`) must reproduce the
    built-in ImmersedDrag bit-for-bit."""
    C = 3e-3

    def u_drag(grid, clock, fields, p):
        return -p * fields.u

    def v_drag(grid, clock, fields, p):
        return -p * fields.v

    m1, s1 = _coastline_model(csi.ImmersedDrag(coefficient=C))
    m2, s2 = _coastline_model(csi.ImmersedStressBC(u_flux=u_drag, v_flux=v_drag,
                                                   parameters=C))
    for _ in range(5):
        s1 = csi.step(m1, s1, 120.0)
        s2 = csi.step(m2, s2, 120.0)
    I = m1.grid.interior
    for name in ("u", "v", "h"):
        np.testing.assert_array_equal(np.asarray(I(getattr(s1, name))),
                                      np.asarray(I(getattr(s2, name))),
                                      err_msg=name)


def test_immersed_drag_slows_flow_along_coast():
    """The drag flux −C·u (units Pa·s/m) acts on coast-adjacent faces: with a
    strong C the along-coast speed must drop measurably vs the no-drag run."""
    m0, s0 = _coastline_model(None)
    m1, s1 = _coastline_model(csi.ImmersedDrag(coefficient=2e5))
    for _ in range(10):
        s0 = csi.step(m0, s0, 120.0)
        s1 = csi.step(m1, s1, 120.0)
    grid = m0.grid
    # u faces whose south or north ff node is immersed (where the drag acts)
    imm = np.asarray(m1.masks.imm_ff)
    band = imm | np.roll(imm, -1, 1)
    band &= ~np.asarray(m1.masks.per_fc)
    I = grid.interior
    u0 = np.abs(np.asarray(s0.u))[band].mean()
    u1 = np.abs(np.asarray(s1.u))[band].mean()
    assert np.isfinite(u1)
    assert u1 < 0.92 * u0, (u0, u1)


def test_immersed_drag_inactive_on_domain_walls():
    """immersed_peripheral_node excludes domain walls: on a bounded grid with
    no land mask, ImmersedDrag must change nothing (the reference gates the
    flux with conditional_flux_ffc on the *immersed* grid only)."""
    km = 1000.0
    grid = csi.RectilinearGrid(size=(16, 16), x=(0, 32 * km), y=(0, 32 * km),
                               halo=5, topology=("bounded", "bounded"))
    grid = csi.ImmersedBoundaryGrid(grid, np.zeros((16, 16), bool))

    def build(drag):
        dynamics = csi.SeaIceMomentumEquation(
            rheology=csi.ElastoViscoPlasticRheology(),
            top_momentum_stress={"u": 0.1, "v": 0.05},
            bottom_momentum_stress=csi.SemiImplicitStress(),
            immersed_drag=drag,
            solver=csi.SplitExplicitSolver(substeps=8))
        model = csi.sea_ice_model(grid, dynamics=dynamics,
                                  ice_thermodynamics=None,
                                  advection=csi.WENO(order=5),
                                  timestepper="ForwardEuler")
        return model, csi.initial_state(model, h=1.0, a=1.0)

    m0, s0 = build(None)
    m1, s1 = build(csi.ImmersedDrag(coefficient=1.0))
    for _ in range(3):
        s0 = csi.step(m0, s0, 120.0)
        s1 = csi.step(m1, s1, 120.0)
    I = grid.interior
    # the zero-valued extra term changes XLA fusion/association: bit-level
    # (1e-16) reassociation noise only
    np.testing.assert_allclose(np.asarray(I(s0.u)), np.asarray(I(s1.u)),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(I(s0.v)), np.asarray(I(s1.v)),
                               rtol=0, atol=1e-13)


def test_function_viscosity_matches_field_viscosity():
    """ViscousRheology with ν(x, y, t) equals the same ν precomputed as a
    field (`viscous_rheology.jl:5-23` function path).  The callable samples
    at (f,f) for σ12, so use an x/y-independent but *time-aware* function on
    top of a constant part to keep cc/ff sampling comparable."""
    km = 1000.0
    grid = csi.RectilinearGrid(size=(24, 24), x=(0, 48 * km), y=(0, 48 * km),
                               halo=4)

    def nu_fn(x, y, t):
        return 500.0 + 0.0 * x + 0.0 * y

    def build(nu):
        dynamics = csi.SeaIceMomentumEquation(
            rheology=csi.ViscousRheology(nu=nu),
            top_momentum_stress={"u": 0.05, "v": 0.02},
            bottom_momentum_stress=csi.SemiImplicitStress(),
            solver=csi.ExplicitSolver())
        model = csi.sea_ice_model(grid, dynamics=dynamics,
                                  ice_thermodynamics=None,
                                  advection=csi.WENO(order=5),
                                  timestepper="ForwardEuler")
        return model, csi.initial_state(model, h=1.0, a=1.0)

    m_fn, s_fn = build(nu_fn)
    m_ct, s_ct = build(500.0)
    for _ in range(5):
        s_fn = csi.step(m_fn, s_fn, 300.0)
        s_ct = csi.step(m_ct, s_ct, 300.0)
    I = grid.interior
    np.testing.assert_allclose(np.asarray(I(s_fn.u)), np.asarray(I(s_ct.u)),
                               rtol=1e-12, atol=1e-15)


def test_function_viscosity_spatially_varying_runs():
    km = 1000.0
    grid = csi.RectilinearGrid(size=(24, 24), x=(0, 48 * km), y=(0, 48 * km),
                               halo=4)

    def nu_fn(x, y, t):
        import jax.numpy as jnp
        return 200.0 + 300.0 * jnp.exp(-((x - 24 * km) ** 2
                                         + (y - 24 * km) ** 2) / (12 * km) ** 2)

    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ViscousRheology(nu=nu_fn),
        top_momentum_stress={"u": 0.05, "v": 0.02},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.ExplicitSolver())
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    state = csi.initial_state(model, h=1.0, a=1.0)
    for _ in range(5):
        state = csi.step(model, state, 300.0)
    I = grid.interior
    assert np.isfinite(np.asarray(I(state.u))).all()
    assert np.abs(np.asarray(I(state.u))).max() < 1.0
