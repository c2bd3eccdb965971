"""Independent NumPy oracles for the remaining BASELINE configs (VERDICT r2
item 4): melting_in_spring (bare + snow), diffusive_ice_column_model, and a
small-grid EVP momentum recurrence.

Like tests/test_reference_parity.py's freezing-bucket oracle, each oracle is
a standalone NumPy transcription of the reference's *discrete update
formulas*, written directly from the Julia math and sharing no code with the
framework:

* layered snow+ice column — `thermodynamic_time_step.jl:131-298` (surface
  secant solve, snow-melt energy budget, closed-form implicit-ℵ fixed point,
  snow-ice flooding), `slab_thermodynamics_tendencies.jl:28-68`,
  `slab_heat_and_tracer_fluxes.jl:45-86` (resistors-in-series flux and the
  snow-ice interface temperature);
* enthalpy column — `EnthalpyMethodSeaIceModel.jl:160-233` (H-step,
  T = H/c, ϕ = (T < 0), κ(ϕ), Dirichlet ghost cells);
* EVP momentum — `elasto_visco_plastic_rheology.jl:236-354` (viscosities,
  αEVP stress relaxation, dynamic γ), `ice_stress_divergence.jl:36-51`
  (SBP divergence), `split_explicit_momentum_equations.jl:103-264`
  (alternating-leapfrog substeps, semi-implicit drag).
"""

import numpy as np
import pytest

import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu.model import _step

minute, day = 60.0, 86400.0

# reference constants (repo defaults = reference defaults)
RHO_I = 900.0      # bulk sea-ice density (sea_ice_model.jl:72 default 900)
RHO_S = 330.0      # bulk snow density
RHO_W = 999.8      # liquid density (PhaseTransitions)
RHO_PURE = 917.0   # microscopic ice density (PhaseTransitions.density)
C_I = 2000.0       # ice heat capacity
C_L = 4186.0       # liquid heat capacity
L0 = 334e3         # reference latent heat
KI = 2.0           # ice conductivity
KS = 0.31          # snow conductivity
HC = 0.05          # consolidation thickness
SIGMA_SB = 5.67e-8
T_REF_RAD = 273.15


def latent_heat(T):
    """`SeaIceThermodynamics.jl` ℒ(T) = ℒ₀ + (ρℓcℓ/ρᵢ − cᵢ)(T − T₀) with the
    *microscopic* ice density (PhaseTransitions.density = 917)."""
    return L0 + (RHO_W * C_L / RHO_PURE - C_I) * T


def secant(fb, Tu0, iterations=32):
    """RootSolvers-style secant from the bracket (Tu0+1, Tu0)
    (`top_heat_boundary_conditions.jl:88-97`); at convergence the fixed
    iteration count is immaterial."""
    T1, T2 = Tu0 + 1.0, Tu0 + 0.0
    F1, F2 = fb(T1), fb(T2)
    for _ in range(iterations):
        dF = F2 - F1
        step = F2 * (T2 - T1) / dF if dF != 0 else 0.0
        T1, F1 = T2, F2
        T2 = T2 - step
        F2 = fb(T2)
    return T2


def ice_volume_update(dVdt, h, a, hc, dt):
    """`thermodynamic_time_step.jl:304-324` + `:358-370`
    (ProportionalEvolution)."""
    V1 = max(0.0, h * a + dt * dVdt)
    dVdt = (V1 - h * a) / dt
    if dVdt >= 0:
        ap = a + dt * (1 - a) / hc * dVdt if hc > 0 else a
    else:
        ap = a + dt * a / (2 * h) * dVdt if h > 0 else a
    ap = max(0.0, ap)
    hp = V1 / ap if ap > 0 else 0.0
    if ap <= 0:
        hp = 0.0
    if dVdt == 0:
        hp, ap = h, a
    if hp == 0:
        ap = 0.0
    if ap == 0:
        hp = 0.0
    if ap > 1:
        hp, ap = hp * ap, 1.0
    return hp, ap


# --- melting_in_spring external fluxes (examples/melting_in_spring.jl) -------

SENS = dict(Cs=1e-3, rho_a=1.225, c_a=1004.0, Ta=-5.0, ua=5.0)


def external_flux(T, insolation, a):
    """RadiativeEmission (εσ(T+273.15)⁴, `boundary_fluxes.jl:122-127`) +
    prescribed insolation + the example's sensible bulk flux (× ℵ)."""
    rad = SIGMA_SB * (T + T_REF_RAD) ** 4
    sens = SENS["Cs"] * SENS["rho_a"] * SENS["c_a"] * SENS["ua"] * (T - SENS["Ta"]) * a
    return rad + insolation + sens


def melting_in_spring_bare_oracle(n_steps, dt, insolation, h0=1.0, a0=1.0):
    """Bare-ice column: `_ice_thermodynamic_time_step!` +
    `thermodynamic_tendency` (`slab_thermodynamics_tendencies.jl:74-136`)."""
    h, a, Tu = h0, a0, 0.0
    Tb = 0.0  # IceWaterThermalEquilibrium at S=0
    traj = [(h, a, Tu)]
    for _ in range(n_steps):
        consolidated = h >= HC

        def Qi(T, h=h):
            return -KI * (T - Tb) / h if h > 0 else 0.0

        if consolidated:
            Tu = secant(lambda T: external_flux(T, insolation, a) - Qi(T), Tu)
            Tu = min(Tu, 0.0)  # melting cap, Tm(S=0)
        else:
            Tu = Tb
        Qui = external_flux(Tu, insolation, a)
        Qbi = 0.0
        Qii = Qi(Tu) if consolidated else 0.0
        Eu = RHO_I * latent_heat(Tu)
        Eb = RHO_I * latent_heat(Tb)
        wu = (Qui - Qii) / Eu
        wb = (Qii - Qbi) / Eb
        h, a = ice_volume_update(wu + wb, h, a, HC, dt)
        traj.append((h, a, Tu))
    return np.array(traj)


def melting_in_spring_snow_oracle(n_steps, dt, insolation,
                                  h0=1.0, a0=1.0, hs0=0.2, snowfall=0.0):
    """Layered snow+ice column: `_layered_thermodynamic_time_step!`
    (`thermodynamic_time_step.jl:131-298`)."""
    h, a, hs, Tus = h0, a0, hs0, 0.0
    Tb = 0.0
    Ls = L0
    traj = [(h, a, hs, Tus)]
    for _ in range(n_steps):
        consolidated = h >= HC
        Tm = 0.0 if hs > 0 else 0.0  # both snow (0) and Tm(S=0) are 0 here

        def Qic(T, h=h, hs=hs):
            R = hs / KS + h / KI
            return (Tb - T) / R if R > 0 else 0.0

        if consolidated:
            Tus = secant(lambda T: external_flux(T, insolation, a) - Qic(T), Tus)
            Tus = min(Tus, Tm)
        else:
            Tus = Tb

        # snow-ice interface temperature (`slab_heat_and_tracer_fluxes.jl:70-86`)
        Ri, Rs = h / KI, hs / KS
        Tsi = Tb + (Tus - Tb) * Ri / (Rs + Ri) if (Rs + Ri) > 0 else Tb

        Qis = Qic(Tus) if consolidated else 0.0
        Qui = external_flux(Tus, insolation, a)
        Qui_per_ice = Qui / a if a > 0 else 0.0
        dQ = Qui_per_ice - Qis
        melt_energy = max(0.0, -dQ)
        snow_cap = RHO_S * Ls * hs / dt
        Qs = min(melt_energy, snow_cap)
        Gs_minus = Qs / (RHO_S * Ls)

        # closed-form implicit-ℵ fixed point (`thermodynamic_time_step.jl:222-260`)
        Qbi = 0.0
        rhoiL = RHO_I * Ls
        alpha = (Qui - Qbi) / rhoiL
        beta = Qs / rhoiL
        Cm = a / (2 * h) if h > 0 else 0.0
        Cf = (1 - a) / HC if HC > 0 else 0.0
        Km, Kf = dt * Cm, dt * Cf
        eps_ = np.finfo(float).eps
        Dm, Df = 1 - Km * beta, 1 - Kf * beta
        am = (a + Km * alpha) / Dm if abs(Dm) > eps_ else a + Km * alpha
        af = (a + Kf * alpha) / Df if abs(Df) > eps_ else a + Kf * alpha
        melting = (alpha + beta * am) < 0
        a_tmp = am if melting else af
        Qui_eff = Qui + Qs * a_tmp

        # ice_melt_freeze_tendency at Tui = Tsi (`slab_thermodynamics_tendencies.jl:28-68`)
        Qii = (-KI * (Tsi - Tb) / h) if (consolidated and h > 0) else 0.0
        Eu = RHO_I * latent_heat(Tsi)
        Eb = RHO_I * latent_heat(Tb)
        dVdt = (Qui_eff - Qii) / Eu + (Qii - Qbi) / Eb

        h1, a1 = ice_volume_update(dVdt, h, a, HC, dt)

        # snow rebase, accumulation, flooding (`thermodynamic_time_step.jl:269-298`)
        hs = hs * a / a1 if a1 > 0 else 0.0
        Gs_plus = snowfall / RHO_S if a1 > 0 else 0.0
        hs = max(0.0, hs + dt * (Gs_plus - Gs_minus))
        hf = h1 * (1 - RHO_I / RHO_W) - hs * RHO_S / RHO_W
        dhs = -hf * RHO_I / RHO_S if hf < 0 else 0.0
        hs_new = max(0.0, hs - dhs)
        dhs = hs - hs_new
        h1 = h1 + dhs * RHO_S / RHO_I
        hs = hs_new
        if a1 <= 0:
            hs = 0.0
        h, a = h1, a1
        traj.append((h, a, hs, Tus))
    return np.array(traj)


def _build_spring(snow):
    grid = csi.RectilinearGrid(size=(4,), topology=("periodic", "flat"))
    solar = np.array([-600.0, -800.0, -1000.0, -1200.0])[:, None]

    def sensible(grid, Tu, clock, fields, p):
        return (p["Cs"] * p["rho_a"] * p["c_a"] * p["ua"]
                * (Tu - p["Ta"]) * fields.a)

    flux = (csi.RadiativeEmission(), solar,
            csi.FluxFunction(func=sensible, parameters=SENS,
                             top_temperature_dependent=True))
    model = csi.sea_ice_model(
        grid, ice_consolidation_thickness=HC, top_heat_flux=flux,
        snow_thermodynamics=csi.snow_slab_thermodynamics() if snow else None)
    kw = dict(h=1.0, a=1.0)
    if snow:
        kw["hs"] = 0.2
    return model, csi.initial_state(model, **kw)


INSOLS = [-600.0, -800.0, -1000.0, -1200.0]


def _run_spring(snow, n, dt, fields):
    import jax
    model, state = _build_spring(snow=snow)
    Hx = model.grid.Hx
    step = jax.jit(lambda s: _step(model, s, dt))

    def snap(s):
        return tuple(np.asarray(getattr(s, f))[Hx:Hx + 4, 0].copy()
                     for f in fields)

    traj = [snap(state)]
    for _ in range(n):
        state = step(state)
        traj.append(snap(state))
    # (steps+1, nfields, 4 columns)
    return np.array(traj)


def test_melting_in_spring_bare_matches_oracle():
    """Framework ≡ transcribed bare-ice recurrence at every step of 15 days,
    all four insolation columns (`examples/melting_in_spring.jl`)."""
    dt = 10 * minute
    n = int(15 * day / dt)
    got = _run_spring(False, n, dt, ("h", "a", "Tu"))
    for col, insol in enumerate(INSOLS):
        ref = melting_in_spring_bare_oracle(n, dt, insol)
        np.testing.assert_allclose(got[:, 0, col], ref[:, 0], rtol=1e-8,
                                   atol=1e-12, err_msg=f"h col {col}")
        np.testing.assert_allclose(got[:, 1, col], ref[:, 1], rtol=1e-8,
                                   atol=1e-12, err_msg=f"a col {col}")
        np.testing.assert_allclose(got[:, 2, col], ref[:, 2], rtol=1e-7,
                                   atol=1e-9, err_msg=f"Tu col {col}")


def test_melting_in_spring_snow_matches_oracle():
    """Framework ≡ transcribed layered snow+ice recurrence (implicit-ℵ
    closed form, snow-melt budget, flooding) at every step of 15 days."""
    dt = 10 * minute
    n = int(15 * day / dt)
    got = _run_spring(True, n, dt, ("h", "a", "hs", "Tus"))
    for col, insol in enumerate(INSOLS):
        ref = melting_in_spring_snow_oracle(n, dt, insol)
        for k, name, rtol in ((0, "h", 1e-8), (1, "a", 1e-8), (2, "hs", 1e-7),
                              (3, "Tus", 1e-6)):
            np.testing.assert_allclose(got[:, k, col], ref[:, k], rtol=rtol,
                                       atol=1e-10, err_msg=f"{name} col {col}")


# --- diffusive ice column (enthalpy method) ----------------------------------

def enthalpy_column_oracle(n_steps, dt, Nz=20, z0=-1.0, z1=0.0,
                           kappa_ice=1e-5, kappa_water=1e-6,
                           c=2090.0 / 999.8,   # `EnthalpyMethodSeaIceModel.jl:38,43`
                           T_init=1.1):
    """`EnthalpyMethodSeaIceModel.jl:160-233`: H += Δt·∂z(κ∂zT); T = H/c;
    ϕ = (T < 0); κ = κᵢ(1−ϕ) + κw·ϕ; Dirichlet ghost cells 2·T_bc − T₁."""
    dz = (z1 - z0) / Nz

    def T_top(t):
        return -0.5 / day * t + 5 * np.sin(2 * np.pi * t / day) - 5.0

    def T_bot(t):
        return -0.1 / day * t + 1.1

    H = np.full(Nz + 2, c * T_init)
    t = 0.0

    def update(H, t):
        T = H / c
        T[0] = 2 * T_bot(t) - T[1]
        T[-1] = 2 * T_top(t) - T[-2]
        phi = (T < 0).astype(float)
        kappa = kappa_ice * (1 - phi) + kappa_water * phi
        return T, kappa

    T, kappa = update(H, t)
    out = [T[1:-1].copy()]
    for _ in range(n_steps):
        kf = 0.5 * (kappa + np.roll(kappa, 1))
        flux = kf * (T - np.roll(T, 1)) / dz   # flux[k] at face below cell k
        G = (np.roll(flux, -1) - flux) / dz
        H[1:-1] += dt * G[1:-1]
        t += dt
        T, kappa = update(H, t)
        out.append(T[1:-1].copy())
    return np.stack(out)


def test_diffusive_ice_column_matches_oracle():
    """Framework enthalpy column ≡ the transcribed reference recurrence at
    every step of 2.5 days (`examples/diffusive_ice_column_model.jl`)."""
    from climaseaice_jl_tpu import enthalpy as em
    import jax.numpy as jnp

    grid = em.ZGrid(Nz=20, z0=-1.0, z1=0.0)
    closure = em.MolecularDiffusivity(kappa_ice=1e-5, kappa_water=1e-6)

    def air_ice_temperature(t):
        return -0.5 / day * t + 5 * jnp.sin(2 * np.pi * t / day) + (-5.0)

    def ice_ocean_temperature(t):
        return -0.1 / day * t + 1.1

    model = em.EnthalpyMethodSeaIceModel(
        grid=grid, closure=closure,
        top_T_bc=em.ValueBoundaryCondition(air_ice_temperature),
        bottom_T_bc=em.ValueBoundaryCondition(ice_ocean_temperature))
    state = em.initial_state(model, T=lambda z: 1.1 + 0.0 * z)

    dt = 100.0
    n = int(2.5 * day / dt)
    got = [np.asarray(grid.interior(state.T)).copy()]
    for _ in range(n):
        state = em.step(model, state, dt)
        got.append(np.asarray(grid.interior(state.T)).copy())
    got = np.stack(got)
    ref = enthalpy_column_oracle(n, dt)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-11)


# --- EVP momentum recurrence --------------------------------------------------

def evp_oracle(n_outer, dt, substeps, N=8, L=8e3, h0=None, a0=None, u0=0.05,
               f_cor=1e-4, tau_u=0.05, tau_v=0.02,
               rho_e_cd=1026.0 * 5.5e-3,   # SemiImplicitStress defaults
               ue=0.08, ve=-0.04, P_star=27.5, C_hard=20.0, e=2.0,
               d_min=2e-9, a_min=50.0, a_max=300.0, c_alpha=np.pi ** 2,
               weno5_advection=False, eps_weno=1e-8):
    """Full αEVP split-explicit recurrence on a doubly-periodic uniform
    N×N grid, transcribed from `elasto_visco_plastic_rheology.jl:236-354`
    (viscosities + stress relaxation + dynamic γ),
    `ice_stress_divergence.jl:36-51` (SBP divergence) and
    `split_explicit_momentum_equations.jl:103-264` (alternating leapfrog,
    semi-implicit quadratic drag).  Index convention: u[i,j] on the x-face
    west of cell (i,j); v[i,j] on the y-face south of cell (i,j)."""
    dx = dy = L / N
    Az = dx * dy
    e_inv2 = e ** -2

    def xp(q):
        return np.roll(q, -1, 0)

    def xm(q):
        return np.roll(q, 1, 0)

    def yp(q):
        return np.roll(q, -1, 1)

    def ym(q):
        return np.roll(q, 1, 1)

    def ixf(q):   # center -> x-face
        return 0.5 * (q + xm(q))

    def ixc(q):   # x-face -> center
        return 0.5 * (q + xp(q))

    def iyf(q):
        return 0.5 * (q + ym(q))

    def iyc(q):
        return 0.5 * (q + yp(q))

    rng = np.random.default_rng(11)
    h = 0.5 + 0.1 * rng.random((N, N)) if h0 is None else np.array(h0, float)
    a = np.ones((N, N)) if a0 is None else np.array(a0, float)
    u = np.full((N, N), u0)
    v = np.zeros((N, N))
    s11 = np.zeros((N, N))
    s22 = np.zeros((N, N))
    s12 = np.zeros((N, N))
    alpha = np.full((N, N), a_max)

    def w5(sm3, sm2, sm1, s0, sp1):
        """Left-biased WENO-5 face value — the classic Jiang–Shu closed
        forms, independent of the framework's Fraction-derived tables."""
        q0 = (2 * sm3 - 7 * sm2 + 11 * sm1) / 6
        q1 = (-sm2 + 5 * sm1 + 2 * s0) / 6
        q2 = (2 * sm1 + 5 * s0 - sp1) / 6
        b0 = (13 / 12 * (sm3 - 2 * sm2 + sm1) ** 2
              + 0.25 * (sm3 - 4 * sm2 + 3 * sm1) ** 2)
        b1 = (13 / 12 * (sm2 - 2 * sm1 + s0) ** 2
              + 0.25 * (sm2 - s0) ** 2)
        b2 = (13 / 12 * (sm1 - 2 * s0 + sp1) ** 2
              + 0.25 * (3 * sm1 - 4 * s0 + sp1) ** 2)
        w0 = 0.1 / (eps_weno + b0) ** 2
        w1 = 0.6 / (eps_weno + b1) ** 2
        w2 = 0.3 / (eps_weno + b2) ** 2
        return (w0 * q0 + w1 * q1 + w2 * q2) / (w0 + w1 + w2)

    def div_Uc(u, v, c):
        """Flux-form WENO-5 tracer divergence (`sea_ice_advection.jl:51-58`):
        [δx(Δy u ĉˣ) + δy(Δx v ĉʸ)] / Az with sign-of-velocity upwinding."""
        lx = w5(xm(xm(xm(c))), xm(xm(c)), xm(c), c, xp(c))
        rx = w5(xp(xp(c)), xp(c), c, xm(c), xm(xm(c)))
        cx = np.where(u > 0, lx, np.where(u < 0, rx, 0.5 * (lx + rx)))
        fx = dy * u * cx
        ly = w5(ym(ym(ym(c))), ym(ym(c)), ym(c), c, yp(c))
        ry = w5(yp(yp(c)), yp(c), c, ym(c), ym(ym(c)))
        cy = np.where(v > 0, ly, np.where(v < 0, ry, 0.5 * (ly + ry)))
        fy = dx * v * cy
        return ((xp(fx) - fx) + (yp(fy) - fy)) / Az

    outs = []
    for _ in range(n_outer):
        # initialize_rheology!: masses/strength recomputed from the advected
        # h, ℵ at every outer step (`elasto_visco_plastic_rheology.jl:192-216`)
        m = h * a * RHO_I
        m_fc, a_fc = ixf(m), ixf(a)
        m_cf, a_cf = iyf(m), iyf(a)
        m_ff = ixf(iyf(m))
        P = P_star * h * np.exp(-C_hard * (1 - a))
        Pff = ixf(iyf(P))
        if weno5_advection:
            # tracer tendencies from the PRE-momentum velocities
            # (`sea_ice_fe_step.jl:13-34` computes G before the momentum step)
            Gh = -div_Uc(u, v, h)
            Ga = -div_Uc(u, v, a)
        un, vn = u.copy(), v.copy()
        for sub in range(1, substeps + 1):
            # strain rates (uniform-grid SBP forms)
            e11 = (xp(u) - u) / dx
            e22 = (yp(v) - v) / dy
            e12 = 0.5 * ((u - ym(u)) / dy + (v - xm(v)) / dx)
            e11f, e22f = ixf(iyf(e11)), ixf(iyf(e22))
            e12c = ixc(iyc(e12))
            d_cc, d_ff = e11 + e22, e11f + e22f
            s_cc = np.sqrt((e11 - e22) ** 2 + 4 * e12c ** 2)
            s_ff = np.sqrt((e11f - e22f) ** 2 + 4 * e12 ** 2)
            Dcc = np.maximum(np.sqrt(d_cc ** 2 + s_cc ** 2 * e_inv2), d_min)
            Dff = np.maximum(np.sqrt(d_ff ** 2 + s_ff ** 2 * e_inv2), d_min)
            zcc, zff = P / (2 * Dcc), Pff / (2 * Dff)
            Pr = P * Dcc / (Dcc + d_min)      # ReplacementPressure (default)
            eta_cc, eta_ff = zcc * e_inv2, zff * e_inv2
            s11_t = 2 * eta_cc * e11 + ((zcc - eta_cc) * d_cc - Pr / 2)
            s22_t = 2 * eta_cc * e22 + ((zcc - eta_cc) * d_cc - Pr / 2)
            s12_t = 2 * eta_ff * e12
            g2cc = zcc * c_alpha * dt / m / Az
            g2ff = zff * c_alpha * dt / m_ff / Az
            gcc = np.clip(np.sqrt(g2cc), a_min, a_max)
            gff = np.clip(np.sqrt(g2ff), a_min, a_max)
            s11 = s11 + np.where(m > 0, (s11_t - s11) / gcc, 0.0)
            s22 = s22 + np.where(m > 0, (s22_t - s22) / gcc, 0.0)
            s12 = s12 + np.where(m_ff > 0, (s12_t - s12) / gff, 0.0)
            alpha = gcc

            sD, sT = s11 + s22, s11 - s22

            def u_step(u, v):
                div_x = ((dy * (sD - xm(sD)) / 2
                          + dy ** 2 * (sT - xm(sT)) / dy / 2
                          + dx ** 2 * (yp(s12) - s12) / dx) / Az)
                dtau = dt / ixf(alpha)
                v_fc = ixf(iyc(v))
                du_, dv_ = ue - u, ve - v_fc
                speed = np.sqrt(du_ ** 2 + dv_ ** 2)
                Gu = (f_cor * v_fc
                      - tau_u / m_fc * a_fc
                      + rho_e_cd * speed * ue / m_fc * a_fc
                      + div_x / m_fc
                      + (un - u) / dt)
                Gu = np.where(m_fc <= 0, 0.0, Gu)
                ti = rho_e_cd * speed / m_fc * a_fc
                return (u + dtau * Gu) / (1 + dtau * ti)

            def v_step(u, v):
                div_y = ((dx * (sD - ym(sD)) / 2
                          - dx ** 2 * (sT - ym(sT)) / dx / 2
                          + dy ** 2 * (xp(s12) - s12) / dy) / Az)
                dtau = dt / iyf(alpha)
                u_cf = ixc(iyf(u))
                du_, dv_ = ue - u_cf, ve - v
                speed = np.sqrt(du_ ** 2 + dv_ ** 2)
                Gv = (-f_cor * u_cf
                      - tau_v / m_cf * a_cf
                      + rho_e_cd * speed * ve / m_cf * a_cf
                      + div_y / m_cf
                      + (vn - v) / dt)
                Gv = np.where(m_cf <= 0, 0.0, Gv)
                ti = rho_e_cd * speed / m_cf * a_cf
                return (v + dtau * Gv) / (1 + dtau * ti)

            if sub % 2 == 0:
                u = u_step(u, v)
                v = v_step(u, v)
            else:
                v = v_step(u, v)
                u = u_step(u, v)
        if weno5_advection:
            # Euler tracer update + clipping + ridging
            # (`sea_ice_fe_step.jl:56-94`)
            h_plus = h + dt * Gh
            a_plus = np.maximum(0.0, a + dt * Ga)
            h_plus = np.maximum(0.0, h_plus)
            a_plus = np.where(h_plus == 0, 0.0, a_plus)
            h_plus = np.where(a_plus == 0, 0.0, h_plus)
            V_plus = h_plus * a_plus
            a = np.where(a_plus > 1, 1.0, a_plus)
            h = np.where(a_plus > 1, V_plus, h_plus)
        outs.append(dict(u=u.copy(), v=v.copy(), sig11=s11.copy(),
                         sig12=s12.copy(), alpha=alpha.copy(),
                         h=h.copy(), a=a.copy()))
    return outs


def test_evp_momentum_matches_oracle():
    """Framework EVP step ≡ the transcribed reference recurrence on an 8×8
    doubly-periodic grid, 2 outer steps × 10 substeps, f64 allclose."""
    N, L = 8, 8e3
    grid = csi.RectilinearGrid(size=(N, N), x=(0, L), y=(0, L), halo=5,
                               topology=("periodic", "periodic"))
    dyn = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=csi.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.05, "v": 0.02},
        bottom_momentum_stress=csi.SemiImplicitStress(ue=0.08, ve=-0.04),
        solver=csi.SplitExplicitSolver(substeps=10))
    model = csi.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                              advection=None, timestepper="ForwardEuler")
    rng = np.random.default_rng(11)
    h0 = 0.5 + 0.1 * rng.random((N, N))
    state = csi.initial_state(model, h=h0, a=1.0, u=0.05)

    dt = 60.0
    ref = evp_oracle(2, dt, 10, N=N, L=L, h0=h0)
    I = grid.interior
    for step_num in range(2):
        state = _step(model, state, dt)
        r = ref[step_num]
        for name in ("u", "v", "sig11", "sig12", "alpha"):
            np.testing.assert_allclose(np.asarray(I(getattr(state, name))),
                                       r[name], rtol=1e-8, atol=1e-12,
                                       err_msg=f"{name} at step {step_num}")


def test_evp_weno_advection_matches_oracle():
    """The combined dynamics+advection config (the anticyclone/golden-file
    class: periodic box, αEVP split-explicit + WENO-5 flux-form advection +
    Euler tracer update with clipping and ridging, ForwardEuler) against an
    independent NumPy transcription — every step, f64 rtol 1e-8.  Closes the
    last parity hole: the golden-file test (test_reference_parity.py) is now
    a secondary regression guard, not the primary parity evidence.
    Transcribed from `sea_ice_fe_step.jl:13-34,56-94`,
    `tracer_tendency_kernel_functions.jl:27-45`, `sea_ice_advection.jl:39-58`
    and the αEVP sources cited on evp_oracle."""
    N, L = 16, 16e3
    grid = csi.RectilinearGrid(size=(N, N), x=(0, L), y=(0, L), halo=5,
                               topology=("periodic", "periodic"))
    dyn = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=csi.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.05, "v": 0.02},
        bottom_momentum_stress=csi.SemiImplicitStress(ue=0.08, ve=-0.04),
        solver=csi.SplitExplicitSolver(substeps=10))
    model = csi.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    x = np.arange(N) + 0.5
    h0 = 1.0 + 0.3 * np.sin(2 * np.pi * x[:, None] / N) \
        * np.cos(2 * np.pi * x[None, :] / N)
    a0 = 0.85 + 0.15 * np.cos(2 * np.pi * x[:, None] / N)
    state = csi.initial_state(model, h=h0, a=a0, u=0.05)

    dt = 120.0
    ref = evp_oracle(3, dt, 10, N=N, L=L, h0=h0, a0=a0,
                     weno5_advection=True)
    I = grid.interior
    for step_num in range(3):
        state = _step(model, state, dt)
        r = ref[step_num]
        for name in ("u", "v", "h", "a", "sig11", "sig12", "alpha"):
            np.testing.assert_allclose(np.asarray(I(getattr(state, name))),
                                       r[name], rtol=1e-8, atol=1e-12,
                                       err_msg=f"{name} at step {step_num}")
