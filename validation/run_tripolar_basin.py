"""Arctic basin at scale on a TripolarGrid (VERDICT r1 item 9).

One-year seasonal run on a 360x300 tripolar grid (~50 km at 65N) with an
idealized continental land mask, EVP dynamics under a seasonal anticyclonic
(Beaufort-gyre-like) wind + transpolar drift, slab ice + snow
thermodynamics under the Semtner monthly flux climatology with
latitude-modulated shortwave, T-dependent albedo and radiative emission
(the 2-D at-scale extension of `examples/arctic_basin_seasonal_cycle.py`,
cf. reference `examples/arctic_basin_seasonal_cycle.jl`).

Prints throughput (pts/s) and seasonal diagnostics; saves the final state to
validation/tripolar_basin_year_{Nx}x{Ny}.npz (size-keyed so smoke runs never
clobber the flagship artifact).

Usage: python validation/run_tripolar_basin.py [--months 12] [--size 360x300]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu.forcing_utils import FieldTimeSeries

hour, day = 3600.0, 86400.0
month = 30 * day
deg = np.pi / 180.0

# Semtner monthly climatology (examples/arctic_basin_seasonal_cycle.py)
from arctic_basin_seasonal_cycle import (TAB_SHORTWAVE, TAB_LONGWAVE,
                                         TAB_SENSIBLE, TAB_LATENT, TIMES)


def build(Nx=360, Ny=300, substeps=120, dtype="float32"):
    import jax.numpy as jnp

    grid = csi.TripolarGrid((Nx, Ny), southernmost_latitude=45.0,
                            transition_latitude=65.0, halo=5, dtype=dtype)
    lon = np.asarray(grid.lon_cc)
    lon = (lon + 180.0) % 360.0 - 180.0
    lat = np.asarray(grid.lat_cc)

    # --- idealized continents (interior mask) ---------------------------------
    I = grid.interior
    lonI, latI = I(lon), I(lat)
    land = latI < 58.0                                     # southern closure
    land |= (lonI > 20) & (lonI < 180) & (latI < 73.0)     # "Eurasia"
    land |= (lonI > -170) & (lonI < -60) & (latI < 72.0)   # "North America"
    land |= (lonI > -60) & (lonI < -20) & (latI < 80.0)    # "Greenland"
    # grid poles: mask the fold-row cells nearest the two degenerate poles
    land[[0, 1, Nx - 1], Ny - 1] = True
    land[Nx // 2 - 1:Nx // 2 + 2, Ny - 1] = True
    # ... and, resolution-generically, every cell whose metric collapsed
    # near the two degenerate grid poles (at 1152×960 the smallest cap cell
    # is 47 m vs a 3.1 km median — advective CFL would force dt < 30 s).
    # Real tripolar configurations place the poles over land for exactly
    # this reason (cf. the reference's immersed landmass into the fold,
    # `test/distributed_tests_utils.jl:231-257`); the masked disk here is a
    # few hundred cells around each pole.
    dxm = np.asarray(I(np.broadcast_to(np.asarray(grid.dx_cc), grid.shape)))
    dym = np.asarray(I(np.broadcast_to(np.asarray(grid.dy_cc), grid.shape)))
    dmin = np.minimum(dxm, dym)
    land |= dmin < 0.2 * np.median(dmin)
    grid = csi.ImmersedBoundaryGrid(grid, land)

    # --- seasonal wind stress (on-device StressFunction) ----------------------
    # Anticyclonic gyre centered on (150W, 80N) + transpolar drift toward
    # Fram Strait (0E), modulated 1 +/- 0.4 over the year (winter max).
    lon_r = jnp.asarray(lon * deg, dtype)
    lat_r = jnp.asarray(lat * deg, dtype)
    # local stereographic-plane coordinates (unit sphere)
    def stereo(lon0, lat0):
        # gnomonic-ish local plane around (lon0, lat0): good enough for forcing
        x = jnp.cos(lat_r) * jnp.sin(lon_r - lon0 * deg)
        y = (jnp.cos(lat0 * deg) * jnp.sin(lat_r)
             - jnp.sin(lat0 * deg) * jnp.cos(lat_r) * jnp.cos(lon_r - lon0 * deg))
        return x, y

    gx, gy = stereo(-150.0, 80.0)      # gyre-centered plane
    fx, fy = stereo(0.0, 78.0)         # Fram-drift plane
    r2 = gx * gx + gy * gy
    gyre_amp = jnp.exp(-r2 / (2 * 0.25 ** 2))
    # anticyclonic (clockwise): tau = A * (y, -x)/r * envelope
    tau_gx = gyre_amp * gy / jnp.sqrt(r2 + 1e-6)
    tau_gy = -gyre_amp * gx / jnp.sqrt(r2 + 1e-6)
    # transpolar drift: uniform push toward the Fram plane origin
    drift = jnp.exp(-(fx * fx + fy * fy) / (2 * 0.6 ** 2))
    tau_dx = -drift * fx
    tau_dy = -drift * fy

    def seasonal(clock):
        return 1.0 + 0.4 * jnp.cos(2 * jnp.pi * clock.time / (360 * day))

    TAU0 = 0.12  # N/m^2 peak

    def wind_u(grid_, clock, fields, params=None):
        return (TAU0 * seasonal(clock) * (0.7 * tau_gx + 0.5 * tau_dx)
                ).astype(dtype)

    def wind_v(grid_, clock, fields, params=None):
        return (TAU0 * seasonal(clock) * (0.7 * tau_gy + 0.5 * tau_dy)
                ).astype(dtype)

    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(),
        coriolis=csi.LatitudeCoriolis(),  # real f(φ) = 2Ω sin(lat): ~11 %
                                          # variation over the 60–90°N basin
        top_momentum_stress={"u": csi.StressFunction(func=wind_u),
                             "v": csi.StressFunction(func=wind_v)},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        immersed_drag=csi.ImmersedDrag(coefficient=1e-3),
        solver=csi.SplitExplicitSolver(substeps=substeps))

    # --- seasonal heat fluxes --------------------------------------------------
    Rs = FieldTimeSeries(times=TIMES, data=TAB_SHORTWAVE, cyclical=True)
    Rl = FieldTimeSeries(times=TIMES, data=TAB_LONGWAVE, cyclical=True)
    Qs = FieldTimeSeries(times=TIMES, data=TAB_SENSIBLE, cyclical=True)
    Ql = FieldTimeSeries(times=TIMES, data=TAB_LATENT, cyclical=True)
    # poleward insolation decay: scale SW by cos(lat)/cos(75N), clipped
    sw_scale = jnp.asarray(
        np.clip(np.cos(lat * deg) / np.cos(75.0 * deg), 0.3, 1.6), dtype)

    def solar_flux(grid_, Tu, clock, fields, fts):
        Q = fts.at_time(clock.time)
        albedo = jnp.where(Tu < -0.1, 0.75, 0.64)
        return Q * sw_scale * (1 - albedo)

    Q_sw = csi.FluxFunction(func=solar_flux, parameters=Rs,
                            top_temperature_dependent=True)
    Q_em = csi.RadiativeEmission(emissivity=1.0,
                                 stefan_boltzmann_constant=5.67e-8 * 1.02)
    top_heat_flux = (Q_sw, Rl, Qs, Ql, Q_em)

    model = csi.sea_ice_model(
        grid, dynamics=dynamics,
        ice_thermodynamics=csi.sea_ice_slab_thermodynamics(),
        snow_thermodynamics=csi.snow_slab_thermodynamics(),
        snowfall=3.2e-6,                    # kg/m^2/s: ~0.3 m/yr snow depth
        top_heat_flux=top_heat_flux,
        bottom_heat_flux=-2.0,              # small ocean heat flux
        advection=csi.WENO(order=7), timestepper="SplitRungeKutta3")

    # initial ice: 2 m at the pole tapering to open water at the ice edge
    h0 = np.clip((latI - 62.0) / 20.0, 0.0, 1.0) * 2.0
    a0 = np.clip((latI - 60.0) / 10.0, 0.0, 1.0)
    h0[land] = 0.0
    a0[land] = 0.0
    state = csi.initial_state(model, h=h0, a=a0, hs=0.0)
    return model, state


def main():
    import jax
    from climaseaice_jl_tpu.model import _step
    from climaseaice_jl_tpu.io.writers import NetCDFWriter
    from climaseaice_jl_tpu.simulation import Simulation, IterationInterval

    ap = argparse.ArgumentParser()
    ap.add_argument("--months", type=int, default=12)
    ap.add_argument("--size", default="360x300")
    ap.add_argument("--dt", type=float, default=1200.0)
    ap.add_argument("--netcdf", default=None,
                    help="stream monthly h/a/hs/u/v snapshots to this file")
    ap.add_argument("--resume-nc", default=None,
                    help="resume from the LAST record of this NetCDF file: "
                         "h/a/hs/u/v and the clock are restored; the EVP "
                         "auxiliaries (σ, α) re-spin within one step "
                         "(physically equivalent, not bitwise — for "
                         "continuing a long climate run after an "
                         "environment failure, not a checkpoint substitute: "
                         "bit-exact pickup lives in io/checkpoint.py)")
    args = ap.parse_args()
    Nx, Ny = map(int, args.size.split("x"))

    model, state = build(Nx, Ny)
    start_month = 0
    if args.resume_nc:
        from scipy.io import netcdf_file
        f = netcdf_file(args.resume_nc, "r", mmap=False)
        start_month = f.variables["time"].shape[0]
        rec = {k: np.array(f.variables[k][-1]) for k in
               ("h", "a", "hs", "u", "v")}
        t0_resume = float(f.variables["time"][-1])
        f.close()
        state = csi.initial_state(model, h=rec["h"], a=rec["a"],
                                  hs=rec["hs"], u=rec["u"], v=rec["v"],
                                  time=t0_resume)
        print(json.dumps({"resumed_from": args.resume_nc,
                          "months_done": start_month,
                          "time_s": t0_resume}), flush=True)
    # Self-describing artifact: halo policy + device in the NetCDF attrs.
    run_attrs = {
        "halo_policy": "wide",
        "device": f"{jax.devices()[0].platform} {jax.devices()[0].device_kind}",
        "dt_s": args.dt,
        "evp_substeps": 120,
        "grid": f"{Nx}x{Ny} tripolar",
    }
    writer = (NetCDFWriter(["h", "a", "hs", "u", "v"], args.netcdf,
                           IterationInterval(1),
                           overwrite=not args.resume_nc,
                           global_attributes=run_attrs)
              if args.netcdf else None)
    step = jax.jit(lambda s, dt: _step(model, s, dt), donate_argnums=(0,))
    I = model.grid.interior
    ocean = ~np.asarray(I(model.grid.solid_cc))
    area = np.asarray(I(np.broadcast_to(np.asarray(model.grid.az_cc),
                                        model.grid.shape)))[ocean]

    dt = args.dt
    per_month = int(round(month / dt))
    state = step(state, dt)  # compile
    jax.block_until_ready(state.h)

    monthly = []
    t0 = time.perf_counter()
    for m in range(start_month, args.months):
        for _ in range(per_month):
            state = step(state, dt)
        jax.block_until_ready(state.h)
        h = np.asarray(I(state.h))[ocean]
        a = np.asarray(I(state.a))[ocean]
        hs = np.asarray(I(state.hs))[ocean]
        u = np.asarray(I(state.u))[ocean]
        ext = float((area * (a > 0.15)).sum() / 1e12)  # 1e6 km^2
        hbar = float((area * h).sum() / area.sum())
        rec = dict(month=m + 1, h_mean=round(hbar, 3),
                   h_max=round(float(h.max()), 2),
                   hs_max=round(float(hs.max()), 3),
                   extent_Mkm2=round(ext, 2),
                   umax=round(float(np.abs(u).max()), 3),
                   finite=bool(np.isfinite(h).all() and np.isfinite(u).all()))
        monthly.append(rec)
        print(json.dumps(rec), flush=True)
        if not rec["finite"]:
            print("NaN detected — aborting")
            return 1
        if writer is not None:
            writer.maybe_write(Simulation(model, state, dt=dt,
                                          stop_iteration=1))
    elapsed = time.perf_counter() - t0
    nsteps = (args.months - start_month) * per_month
    pts = Nx * Ny * nsteps / elapsed
    print(json.dumps({"throughput_pts_per_s": round(pts, 1),
                      "steps": nsteps, "wall_s": round(elapsed, 1),
                      "grid": f"{Nx}x{Ny} tripolar", "dt_s": dt}))
    # Size-keyed filename so smoke runs cannot clobber the flagship
    # artifact (ADVICE r4, medium).
    np.savez(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          f"tripolar_basin_year_{Nx}x{Ny}.npz"),
             h=np.asarray(I(state.h)), a=np.asarray(I(state.a)),
             hs=np.asarray(I(state.hs)), u=np.asarray(I(state.u)),
             v=np.asarray(I(state.v)),
             monthly=json.dumps(monthly))
    return 0


if __name__ == "__main__":
    sys.exit(main())
