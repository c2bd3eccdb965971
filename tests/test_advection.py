"""Advection scheme tests (analog of `test/test_sea_ice_advection.jl`):
constancy preservation, conservation, and translation accuracy."""

import numpy as np
import pytest

import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu.advection import horizontal_div_Uc
from climaseaice_jl_tpu.fields import fill_halos_cc

SCHEMES = [csi.Centered(order=2), csi.UpwindBiased(order=1),
           csi.UpwindBiased(order=3), csi.UpwindBiased(order=5),
           csi.UpwindBiased(order=7), csi.UpwindBiased(order=9),
           csi.WENO(order=5), csi.WENO(order=7), csi.WENO(order=9)]
IDS = ["C2", "UB1", "UB3", "UB5", "UB7", "UB9", "WENO5", "WENO7", "WENO9"]


@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_constancy_preservation(scheme):
    """Uniform tracer in a divergence-free velocity field has zero tendency."""
    grid = csi.RectilinearGrid(size=(16, 16), x=(0, 1), y=(0, 1), halo=5)
    c = grid.new_field() + 3.7
    u = grid.new_field() + 0.5
    v = grid.new_field() - 0.25
    div = np.asarray(grid.interior(horizontal_div_Uc(grid, scheme, u, v, c)))
    np.testing.assert_allclose(div, 0.0, atol=1e-13)


@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_conservation_periodic(scheme):
    """Flux-form divergence sums to zero over a periodic domain."""
    grid = csi.RectilinearGrid(size=(32, 32), x=(0, 1), y=(0, 1), halo=5)
    rng = np.random.default_rng(42)
    c = fill_halos_cc(grid.set_interior(grid.new_field(), rng.random((32, 32))), grid)
    u = grid.new_field() + 0.3
    v = grid.new_field() + 0.1
    div = np.asarray(grid.interior(horizontal_div_Uc(grid, scheme, u, v, c)))
    az = float(np.asarray(grid.az_cc))
    assert abs((div * az).sum()) < 1e-12


@pytest.mark.parametrize("scheme,tol", [(csi.UpwindBiased(order=5), 0.06),
                                        (csi.WENO(order=5), 0.06),
                                        (csi.WENO(order=7), 0.03)],
                         ids=["UB5", "WENO5", "WENO7"])
def test_translation_accuracy(scheme, tol):
    """A smooth bump advected across a periodic domain returns ≈ unchanged."""
    N = 64
    grid = csi.RectilinearGrid(size=(N, N), x=(0, 1), y=(0, 1))
    model = csi.sea_ice_model(grid, ice_thermodynamics=None, advection=scheme,
                              timestepper="SplitRungeKutta3")

    def bump(x, y):
        return np.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)

    state = csi.initial_state(model, h=bump, a=1.0, u=1.0, v=0.0)
    c0 = np.asarray(grid.interior(state.h)).copy()

    # advect once around the domain: T = L/u = 1
    steps = 256
    dt = 1.0 / steps
    for _ in range(steps):
        state = csi.step(model, state, dt)

    c1 = np.asarray(grid.interior(state.h))
    err = np.abs(c1 - c0).max() / np.abs(c0).max()
    assert err < tol, f"translation error {err}"
    # flux form conserves total volume exactly (periodic)
    assert abs(c1.sum() - c0.sum()) / abs(c0.sum()) < 1e-12


def test_weno_no_oscillations():
    """WENO keeps a square wave essentially monotone (no large over/undershoot)."""
    N = 64
    grid = csi.RectilinearGrid(size=(N, 1), topology=("periodic", "flat"))
    model = csi.sea_ice_model(grid, ice_thermodynamics=None,
                              advection=csi.WENO(order=5), timestepper="ForwardEuler")

    def square(x, y):
        return np.where((x > 0.25) & (x < 0.5), 1.0, 0.0)

    state = csi.initial_state(model, h=square, a=1.0, u=1.0, v=0.0)
    dt = 0.5 / N
    for _ in range(N):
        state = csi.step(model, state, dt)
    c = np.asarray(grid.interior(state.h))
    assert c.max() < 1.0 + 5e-2
    assert c.min() > -5e-2


def test_weno_tables_match_classic_forms():
    """Generated WENO coefficient tables reproduce the classic closed forms."""
    from fractions import Fraction as F
    from climaseaice_jl_tpu.advection import _weno_tables

    C, G, B = _weno_tables(3)
    np.testing.assert_allclose(G, [0.1, 0.6, 0.3], rtol=1e-14)
    np.testing.assert_allclose(C[0], [1 / 3, -7 / 6, 11 / 6], rtol=1e-14)
    # Jiang–Shu β₀ = 13/12 (a−2b+c)² + 1/4 (a−4b+3c)²
    a, b, c = 0.3, -1.2, 2.7
    u = np.array([a, b, c])
    js = 13 / 12 * (a - 2 * b + c) ** 2 + 0.25 * (a - 4 * b + 3 * c) ** 2
    np.testing.assert_allclose(u @ np.array(B[0]) @ u, js, rtol=1e-13)

    _, G7, _ = _weno_tables(4)
    np.testing.assert_allclose(G7, [1 / 35, 12 / 35, 18 / 35, 4 / 35], rtol=1e-14)
    _, G9, _ = _weno_tables(5)
    np.testing.assert_allclose(G9, [1 / 126, 10 / 63, 10 / 21, 20 / 63, 5 / 126],
                               rtol=1e-14)


def test_upwind9_matches_weno_big_stencil():
    """UB9 coefficients must equal the assembled WENO-9 big-stencil
    reconstruction Σ γ_k q_k."""
    from climaseaice_jl_tpu.advection import _weno_tables, _upwind_faces
    C, G, _ = _weno_tables(5)
    # assemble big-stencil coefficients over cells I-5..I+3
    big = np.zeros(9)
    for k in range(5):
        for j in range(5):
            big[k + j] += G[k] * C[k][j]
    # hand coefficients from _upwind_faces (order 9, left-biased)
    hand = np.array([4, -41, 199, -641, 1879, 1375, -305, 55, -5]) / 2520.0
    np.testing.assert_allclose(big, hand, rtol=1e-12)


def test_solid_row_crop_tendencies_bitwise(monkeypatch):
    """The tracer-tendency solid-row crop (model.tracer_tendencies) must be
    BITWISE equal to the full-grid computation: the cropped rows' divergence
    is exactly zero (all fluxes killed at peripheral faces) and every kept
    row's stencil reads identical values in the row-sliced view."""
    import climaseaice_jl_tpu as csi
    import climaseaice_jl_tpu.model as M
    from climaseaice_jl_tpu.grids import solid_crop_rows
    from climaseaice_jl_tpu.model import _step

    N = 96
    grid = csi.TripolarGrid((N, N), southernmost_latitude=-70.0, halo=5,
                            dtype="float32")
    mask = np.zeros((N, N), bool)
    mask[:, :40] = True                      # deep band: crop threshold ≥ 32
    mask[N // 3:N // 2, 3 * N // 4:] = True
    grid = csi.ImmersedBoundaryGrid(grid, mask)

    def build():
        dyn = csi.SeaIceMomentumEquation(
            rheology=csi.ElastoViscoPlasticRheology(),
            coriolis=csi.FPlane(f=1.4e-4),
            top_momentum_stress={"u": 0.1, "v": 0.02},
            bottom_momentum_stress=csi.SemiImplicitStress(),
            solver=csi.SplitExplicitSolver(substeps=20))
        model = csi.sea_ice_model(grid, dynamics=dyn,
                                  ice_thermodynamics=None,
                                  advection=csi.WENO(order=7),
                                  timestepper="SplitRungeKutta3")
        rng = np.random.default_rng(7)
        h0 = np.where(mask, 0.0, 1.0 + 0.2 * rng.random((N, N)))
        state = csi.initial_state(model, h=h0, a=np.where(mask, 0.0, 0.9),
                                  u=0.0)
        return model, state

    model, state = build()
    assert solid_crop_rows(model.grid) == 40
    for _ in range(3):
        state = _step(model, state, 600.0)
    cropped = state

    monkeypatch.setattr(M, "solid_crop_rows", lambda g: 0)
    model, state = build()
    for _ in range(3):
        state = _step(model, state, 600.0)
    for name in ("h", "a", "u", "v"):
        a = np.asarray(getattr(cropped, name))
        b = np.asarray(getattr(state, name))
        assert np.array_equal(a, b), name


def _crop_grid(mask, N=32, **kw):
    import climaseaice_jl_tpu as csi
    grid = csi.TripolarGrid((N, N), southernmost_latitude=-70.0, halo=5, **kw)
    return grid if mask is None else csi.ImmersedBoundaryGrid(grid, mask)


def _band(rows, N=32):
    mask = np.zeros((N, N), bool)
    mask[:, :rows] = True
    mask[N // 3:N // 2, 3 * N // 4:] = True   # landmass into the fold
    return mask


@pytest.mark.parametrize("case,expected", [
    ("deep_band", 12),        # fully-solid southern rows are counted
    ("ragged_band", 3),       # one column reaching deeper does not count
    ("no_mask", 0),           # no immersed mask, nothing to crop
    ("all_solid", 0),         # degenerate domain: compute as before
    ("meshed", 0),            # per-shard crops would differ between shards
])
def test_solid_crop_rows(case, expected):
    """The solid-row count (grids.solid_crop_rows) that the serial tracer
    divergence crops: fully-solid southern rows only, and none where a
    crop would be wrong or meaningless."""
    from climaseaice_jl_tpu.grids import solid_crop_rows
    if case == "deep_band":
        grid = _crop_grid(_band(12))
    elif case == "ragged_band":
        mask = _band(3)
        mask[7, :9] = True
        grid = _crop_grid(mask)
    elif case == "no_mask":
        grid = _crop_grid(None)
    elif case == "all_solid":
        grid = _crop_grid(np.ones((32, 32), bool))
    else:
        grid = _crop_grid(_band(12)).evolve(mesh_axes=("x", "y"),
                                            mesh_shape=(2, 2))
    assert solid_crop_rows(grid) == expected


def test_south_crop_grid_is_a_view():
    """south_crop_grid keeps halos and metrics as exact sub-array views of
    the full grid, shifted by the cropped rows."""
    from climaseaice_jl_tpu.grids import south_crop_grid
    grid = _crop_grid(_band(12))
    gc = south_crop_grid(grid, 12)
    assert (gc.Nx, gc.Ny, gc.Hx, gc.Hy) == (grid.Nx, grid.Ny - 12,
                                            grid.Hx, grid.Hy)
    for name in ("dx_cc", "dy_cf", "az_ff", "solid_cc"):
        np.testing.assert_array_equal(np.asarray(getattr(gc, name)),
                                      np.asarray(getattr(grid, name))[:, 12:],
                                      err_msg=name)
