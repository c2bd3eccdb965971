"""Distributed ≡ serial equality tests.

Port of `test/distributed_tests_utils.jl:40-88` / `test_distributed_sea_ice.jl`:
a full EVP + WENO-advection simulation must produce identical (allclose)
u, v, h, ℵ whether run serially or sharded over (1,4), (4,1), (2,2) device
meshes.  The reference spawns mpiexec ranks; here the 8 virtual CPU devices
from conftest.py play the ranks and halo exchange is lax.ppermute inside
shard_map.
"""

import numpy as np
import pytest
import jax

import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu.parallel import make_distributed_step
from climaseaice_jl_tpu.parallel.stepper import strip_halos, unstrip_halos


def _build(topology=("periodic", "periodic"), immersed=False,
           max_relaxation=1e4):
    """The reference's 'random simulation': EVP + WENO(7) + FPlane + scalar
    top stress + SemiImplicitStress bottom drag
    (`distributed_tests_utils.jl:108-137`).

    NOTE on ``max_relaxation``: with the reference default α⁺ = 300, the αEVP
    relaxation is *non-contractive* in the Δ → Δ_min (high-viscosity) regime —
    the stability bound √(ζ c_α Δt / m Az) can exceed α⁺, and roundoff-level
    perturbations amplify ~30×/substep.  The reference's serial≡distributed
    test survives that because Julia's per-point arithmetic is bit-identical
    across MPI ranks; XLA's fusion differs between shardings, so we test strict
    equality in the contractive regime (α⁺ large enough that clamping never
    violates the bound) and cover the reference-default regime with a loose
    tolerance below.
    """
    km = 1000.0
    grid = csi.RectilinearGrid(size=(48, 48), x=(-10 * km, 10 * km),
                               y=(-10 * km, 10 * km), halo=5,
                               topology=topology)
    if immersed:
        def island(x, y):
            return (x ** 2 + y ** 2) < (4 * km) ** 2
        grid = csi.ImmersedBoundaryGrid(grid, island)

    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(max_relaxation_parameter=max_relaxation),
        coriolis=csi.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.01, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=10))

    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=csi.WENO(order=7),
                              timestepper="ForwardEuler")

    def h0(x, y):
        return 0.3 + 0.005 * (np.sin(60 * x / (20 * km)) + np.sin(30 * y / (20 * km)))

    state = csi.initial_state(model, h=h0, a=1.0, u=0.1)
    return model, state


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


@pytest.mark.parametrize("mesh_shape", [(1, 4), (4, 1), (2, 2)])
@pytest.mark.parametrize("topology", [("periodic", "periodic"),
                                      ("periodic", "bounded"),
                                      ("bounded", "bounded")])
def test_distributed_equals_serial(mesh_shape, topology):
    model, state = _build(topology)
    steps, dt = 10, 60.0

    serial = _run_serial(model, state, steps, dt)
    dist = _run_distributed(model, state, steps, dt, mesh_shape)

    I = model.grid.interior
    for name in ("u", "v", "h", "a"):
        a = np.asarray(I(getattr(serial, name)))
        b = np.asarray(I(getattr(dist, name)))
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9,
                                   err_msg=f"{name} mismatch on {mesh_shape}/{topology}")


def test_distributed_reference_default_alpha():
    """Reference-default α⁺ = 300 (non-contractive regime): trajectories agree
    only to the roundoff-amplification level; assert they stay physically
    close rather than bitwise (see _build docstring)."""
    model, state = _build(max_relaxation=300.0)
    steps, dt = 10, 60.0
    serial = _run_serial(model, state, steps, dt)
    dist = _run_distributed(model, state, steps, dt, (2, 2))
    I = model.grid.interior
    for name, tol in (("u", 5e-3), ("h", 1e-3)):
        a = np.asarray(I(getattr(serial, name)))
        b = np.asarray(I(getattr(dist, name)))
        assert np.abs(a - b).max() < tol


def test_distributed_immersed_island():
    """Immersed boundary crossing shard boundaries (tripolar-fold analog of
    `distributed_tests_utils.jl:170-259`, rectilinear island variant)."""
    model, state = _build(("periodic", "periodic"), immersed=True)
    steps, dt = 5, 60.0
    serial = _run_serial(model, state, steps, dt)
    dist = _run_distributed(model, state, steps, dt, (2, 2))
    I = model.grid.interior
    for name in ("u", "v", "h", "a"):
        np.testing.assert_allclose(np.asarray(I(getattr(serial, name))),
                                   np.asarray(I(getattr(dist, name))),
                                   rtol=1e-7, atol=1e-9, err_msg=name)


def test_distributed_with_thermodynamics():
    """Thermo + dynamics + snow distributed equality."""
    km = 1000.0
    grid = csi.RectilinearGrid(size=(16, 16), x=(0, 10 * km), y=(0, 10 * km), halo=4)
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(),
        bottom_momentum_stress=csi.SemiImplicitStress(ue=0.1),
        solver=csi.SplitExplicitSolver(substeps=8))
    model = csi.sea_ice_model(grid, dynamics=dynamics,
                              snow_thermodynamics=csi.snow_slab_thermodynamics(),
                              top_heat_flux=-50.0, bottom_heat_flux=-5.0,
                              snowfall=1e-6, advection=csi.WENO(order=5))
    state = csi.initial_state(model, h=1.0, a=0.9, hs=0.1)

    serial = _run_serial(model, state, 5, 600.0)
    dist = _run_distributed(model, state, 5, 600.0, (2, 2))
    I = grid.interior
    for name in ("u", "v", "h", "a", "hs", "Tu"):
        np.testing.assert_allclose(np.asarray(I(getattr(serial, name))),
                                   np.asarray(I(getattr(dist, name))),
                                   rtol=1e-7, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_wide_halo_communication_avoiding_evp(mesh_shape):
    """halo_exchange='wide': shard halos inflated to 2N+3, zero exchanges in
    the substep loop, one exchange per outer step — must still reproduce the
    serial run (`split_explicit_momentum_equations.jl:51-64,170-187`)."""
    km = 1000.0
    grid = csi.RectilinearGrid(size=(48, 48), x=(-10 * km, 10 * km),
                               y=(-10 * km, 10 * km), halo=5)
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(max_relaxation_parameter=1e4),
        coriolis=csi.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.01, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=4, halo_exchange="wide"))
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=csi.WENO(order=7),
                              timestepper="ForwardEuler")

    def h0(x, y):
        return 0.3 + 0.005 * (np.sin(60 * x / (20 * km)) + np.sin(30 * y / (20 * km)))

    state = csi.initial_state(model, h=h0, a=1.0, u=0.1)

    serial = _run_serial(model, state, 10, 60.0)
    dist = _run_distributed(model, state, 10, 60.0, mesh_shape)

    I = model.grid.interior
    for name in ("u", "v", "h", "a"):
        a = np.asarray(I(getattr(serial, name)))
        b = np.asarray(I(getattr(dist, name)))
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9,
                                   err_msg=f"wide-halo {name} mismatch {mesh_shape}")


def test_wide_halo_rejects_small_tiles():
    grid = csi.RectilinearGrid(size=(16, 16), halo=4)
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(),
        solver=csi.SplitExplicitSolver(substeps=50, halo_exchange="wide"))
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None)
    with pytest.raises(ValueError, match="wide-halo"):
        make_distributed_step(model, (2, 4))


def test_distributed_with_tracers():
    """Custom tracers shard and advect identically to serial."""
    km = 1000.0
    grid = csi.RectilinearGrid(size=(16, 16), x=(0, 10 * km), y=(0, 10 * km), halo=4)
    model = csi.sea_ice_model(grid, ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    rng = np.random.default_rng(11)
    state = csi.initial_state(model, h=1.0, a=1.0, u=0.2, v=0.1,
                              tracers={"dye": rng.random((16, 16))})

    serial = _run_serial(model, state, 5, 300.0)
    dist = _run_distributed(model, state, 5, 300.0, (2, 2))
    I = grid.interior
    np.testing.assert_allclose(np.asarray(I(serial.tracers["dye"])),
                               np.asarray(I(dist.tracers["dye"])),
                               rtol=1e-12, atol=1e-14)


def _build_f32(advection=None, halo_exchange="wide"):
    """float32 rectilinear EVP step, the precision the GPU runs, on cells of
    about 20 km, where the relaxation is well conditioned."""
    km = 1000.0
    grid = csi.RectilinearGrid(size=(48, 128), x=(-500 * km, 500 * km),
                               y=(-1000 * km, 1000 * km), halo=5,
                               dtype="float32")
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=csi.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.01, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=8,
                                       halo_exchange=halo_exchange))
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=advection, timestepper="ForwardEuler")

    def h0(x, y):
        return 0.3 + 0.005 * (np.sin(60 * x / (1000 * km))
                              + np.sin(30 * y / (2000 * km)))

    state = csi.initial_state(model, h=h0, a=1.0, u=0.05)
    return model, state


def _assert_f32_close(model, serial, dist, names, tol_uv, tol_other):
    """Velocities relative to the largest speed, other fields relative to
    their own largest value."""
    I = model.grid.interior
    vel_scale = max(np.abs(np.asarray(I(serial.u))).max(),
                    np.abs(np.asarray(I(serial.v))).max(), 1e-8)
    for name in names:
        a = np.asarray(I(getattr(serial, name)))
        b = np.asarray(I(getattr(dist, name)))
        assert np.isfinite(b).all(), name
        scale = vel_scale if name in ("u", "v") else max(np.abs(a).max(), 1e-8)
        tol = tol_uv if name in ("u", "v") else tol_other
        err = np.abs(a - b).max() / scale
        assert err < tol, f"{name}: {err}"


# In float32 the serial and per-shard executables are compiled for different
# array shapes, so XLA contracts and fuses them differently and their results
# differ by roundoff from the first substep on.  On _build_f32's 20 km cells
# that roundoff is not amplified; measured on the CPU over (2, 2), (1, 4) and
# (2, 4) meshes, both exchange policies, with and without advection: u, v ≤
# 1.6e-7 of the largest speed, σ₁₁, σ₁₂ ≤ 1.2e-4 of their largest value, h,
# ℵ ≤ 1e-7, α equal.  (On 0.4 km cells the same step amplifies roundoff until
# σ₁₂ differs by its own size, and a bound would test nothing.)
F32_TOL_UV, F32_TOL_OTHER = 2e-6, 1e-3
F32_FIELDS = ("u", "v", "sig11", "sig12", "alpha")


def test_wide_halo_f32_equals_serial():
    """Distributed wide-halo mode in float32 with WENO-5 advection: per-shard
    steps reproduce the serial float32 run to the stated tolerance."""
    model, state = _build_f32(advection=csi.WENO(order=5))
    serial = _run_serial(model, state, 5, 60.0)
    dist = _run_distributed(model, state, 5, 60.0, (2, 2))
    _assert_f32_close(model, serial, dist, F32_FIELDS + ("h", "a"),
                      F32_TOL_UV, F32_TOL_OTHER)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_f32_evp_serial_equals_distributed(mesh_shape):
    """With advection off the whole step is the EVP loop: serial ≡
    distributed in float32 (wide-halo EVP) to the stated tolerance
    (`distributed_tests_utils.jl:83-86` is the reference's analog)."""
    model, state = _build_f32()
    serial = _run_serial(model, state, 5, 60.0)
    dist = _run_distributed(model, state, 5, 60.0, mesh_shape)
    _assert_f32_close(model, serial, dist, F32_FIELDS, F32_TOL_UV,
                      F32_TOL_OTHER)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_f32_full_step_serial_equals_distributed(mesh_shape):
    """Full dynamics step (WENO-7 advection + EVP) in float32 under the
    default per-substep exchange: serial ≡ distributed to the stated
    tolerance."""
    model, state = _build_f32(advection=csi.WENO(order=7),
                              halo_exchange="per_substep")
    serial = _run_serial(model, state, 5, 60.0)
    dist = _run_distributed(model, state, 5, 60.0, mesh_shape)
    _assert_f32_close(model, serial, dist, F32_FIELDS + ("h", "a"),
                      F32_TOL_UV, F32_TOL_OTHER)


def test_deferred_substep_exchange_single_batched_round():
    """Per-substep mode runs ONE batched u+v exchange round per substep
    (fields.fill_halos_uv): the compiled substep-loop body must contain
    exactly 2 collective-permutes (fwd + bwd of the stacked payload) — the
    deferred-exchange analog of the reference's grouped async halo sends
    (`split_explicit_momentum_equations.jl:170-187`).  Guard against
    regressing to per-half-update exchanges (4 permutes)."""
    import re
    import jax
    from climaseaice_jl_tpu.parallel.stepper import strip_halos

    model, state = _build()
    dstep, mesh = make_distributed_step(model, (1, 2))
    s = strip_halos(model, state)
    hlo = jax.jit(lambda s: dstep(s, 60.0)).lower(s).compile().as_text()
    # the momentum substep loop is the only while-region with permutes
    comps = re.split(r"\n(?=%?\w[\w.+-]* \()", hlo)
    loop_counts = [c.count("collective-permute") for c in comps
                   if "region" in c.split("\n", 1)[0]
                   and c.count("collective-permute")]
    assert loop_counts == [2], loop_counts


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (4, 1)])
@pytest.mark.parametrize("topology", [("periodic", "periodic"),
                                      ("bounded", "bounded")])
def test_overlap_exchange_equals_serial(mesh_shape, topology):
    """halo_exchange='overlap': the per-substep u/v exchange is consumed only
    by narrow boundary-band recomputes, so XLA can run it concurrently with
    the full-shard substep (the reference's async fill posted at substep end
    and completed at next use, `elasto_visco_plastic_rheology.jl:276-279` +
    `:204-206`).  Must reproduce the serial trajectory like the default
    policy."""
    import dataclasses
    model, state = _build(topology)
    solver = dataclasses.replace(model.dynamics.solver,
                                 halo_exchange="overlap")
    model = model.evolve(dynamics=dataclasses.replace(model.dynamics,
                                                      solver=solver))
    steps, dt = 10, 60.0
    serial = _run_serial(model, state, steps, dt)
    dist = _run_distributed(model, state, steps, dt, mesh_shape)
    I = model.grid.interior
    for name in ("u", "v", "h", "a"):
        a = np.asarray(I(getattr(serial, name)))
        b = np.asarray(I(getattr(dist, name)))
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9,
                                   err_msg=f"{name} {mesh_shape}/{topology}")


def test_overlap_exchange_immersed_island():
    import dataclasses
    model, state = _build(("periodic", "periodic"), immersed=True)
    solver = dataclasses.replace(model.dynamics.solver,
                                 halo_exchange="overlap")
    model = model.evolve(dynamics=dataclasses.replace(model.dynamics,
                                                      solver=solver))
    serial = _run_serial(model, state, 5, 60.0)
    dist = _run_distributed(model, state, 5, 60.0, (2, 2))
    I = model.grid.interior
    for name in ("u", "v", "h", "a"):
        np.testing.assert_allclose(np.asarray(I(getattr(serial, name))),
                                   np.asarray(I(getattr(dist, name))),
                                   rtol=1e-7, atol=1e-9, err_msg=name)


def test_overlap_exchange_fold_y_meshed():
    """Overlap mode under the Zipper fold (y-meshed: the top shard's north
    band hosts the within-shard fold fill; the south band's fake north edge
    must not leak into the merge region)."""
    import dataclasses
    km = 1000.0
    grid = csi.RectilinearGrid(size=(32, 32), x=(0, 20 * km), y=(0, 20 * km),
                               halo=5, topology=("periodic", "bounded"),
                               north_fold=True)
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(max_relaxation_parameter=1e4),
        coriolis=csi.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.01, "v": 0.005},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=10, halo_exchange="overlap"))
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    rng = np.random.default_rng(11)
    state = csi.initial_state(model, h=0.4 + 0.05 * rng.random((32, 32)),
                              a=1.0, u=0.05)
    serial = _run_serial(model, state, 5, 60.0)
    dist = _run_distributed(model, state, 5, 60.0, (1, 2))
    I = grid.interior
    for name in ("u", "v", "h", "a"):
        np.testing.assert_allclose(np.asarray(I(getattr(serial, name))),
                                   np.asarray(I(getattr(dist, name))),
                                   rtol=1e-7, atol=1e-9, err_msg=name)


def test_overlap_substep_single_round():
    """Overlap mode must not add exchange rounds: the substep loop still
    contains exactly ONE batched u+v round (2 collective-permutes) — the
    band recompute rides the same payload."""
    import re
    import dataclasses
    import jax
    from climaseaice_jl_tpu.parallel.stepper import strip_halos

    model, state = _build()
    solver = dataclasses.replace(model.dynamics.solver,
                                 halo_exchange="overlap")
    model = model.evolve(dynamics=dataclasses.replace(model.dynamics,
                                                      solver=solver))
    dstep, mesh = make_distributed_step(model, (1, 2))
    s = strip_halos(model, state)
    hlo = jax.jit(lambda s: dstep(s, 60.0)).lower(s).compile().as_text()
    comps = re.split(r"\n(?=%?\w[\w.+-]* \()", hlo)
    loop_counts = [c.count("collective-permute") for c in comps
                   if "region" in c.split("\n", 1)[0]
                   and c.count("collective-permute")]
    assert loop_counts == [2], loop_counts


def test_overlap_interior_pass_independent_of_permute():
    """Structural proof of the overlap: the jaxpr "overlap window" — the
    number of substep-loop-body equations that are issued AFTER the u/v
    ppermute but do NOT depend on it — must be large in overlap mode (the
    whole full-shard interior substep runs concurrently with the collective,
    the reference's async fill `elasto_visco_plastic_rheology.jl:276-279`)
    and is ~zero in the deferred mode, whose permute is the last thing the
    body does (its latency is exposed at the next iteration's head)."""
    import dataclasses
    import jax
    from climaseaice_jl_tpu.parallel.stepper import strip_halos

    def overlap_window(policy):
        model, state = _build()
        solver = dataclasses.replace(model.dynamics.solver,
                                     halo_exchange=policy)
        model = model.evolve(dynamics=dataclasses.replace(model.dynamics,
                                                          solver=solver))
        dstep, mesh = make_distributed_step(model, (1, 2))
        s = strip_halos(model, state)
        jaxpr = jax.make_jaxpr(lambda st: dstep(st, 60.0))(s)

        def subjaxprs(eqn):
            for v in eqn.params.values():
                for item in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(item, "eqns"):
                        yield item
                    elif hasattr(getattr(item, "jaxpr", None), "eqns"):
                        yield item.jaxpr

        def walk(jx):
            found = []
            for eqn in jx.eqns:
                for sub in subjaxprs(eqn):
                    if eqn.primitive.name in ("while", "scan") and any(
                            e.primitive.name == "ppermute" for e in sub.eqns):
                        found.append(sub)
                    found += walk(sub)
            return found

        bodies = walk(jaxpr.jaxpr)
        assert bodies, f"no permute-bearing loop body found ({policy})"
        body = max(bodies, key=lambda b: len(b.eqns))
        first_perm = next(i for i, e in enumerate(body.eqns)
                          if e.primitive.name == "ppermute")
        tainted = set()
        window = 0
        for i, eqn in enumerate(body.eqns):
            dep = eqn.primitive.name == "ppermute" or any(
                id(iv) in tainted for iv in eqn.invars
                if hasattr(iv, "count"))
            if dep:
                for ov in eqn.outvars:
                    tainted.add(id(ov))
            elif i > first_perm:
                window += 1
        return window, len(body.eqns)

    w_overlap, n_overlap = overlap_window("overlap")
    w_deferred, n_deferred = overlap_window("per_substep")
    # overlap: the interior pass (most of the body) is independent work the
    # scheduler can run while the collective is in flight; deferred: the
    # permute is the tail of the body — nothing overlaps in-iteration.
    assert w_overlap > 0.4 * n_overlap, (w_overlap, n_overlap)
    assert w_deferred < 0.05 * n_deferred, (w_deferred, n_deferred)
