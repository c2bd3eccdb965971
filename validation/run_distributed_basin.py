"""At-scale DISTRIBUTED arctic-basin validation (VERDICT r2 item 8).

Runs the seasonal tripolar arctic-basin physics (land mask, Zipper fold,
seasonal wind StressFunctions, Semtner flux climatology, slab ice + snow
thermo, WENO-7) through ``make_distributed_step`` on a (1, Py) device mesh,
writes per-rank snapshots, reassembles them, streams the reassembled fields
to NetCDF, and compares a serial run of the same slice.

The wind StressFunctions here evaluate from the *grid argument's* lon/lat
arrays (``grid_.lon_cc``/``lat_cc``), so the same closure works serially and
inside shard_map where the grid is the local shard — the pattern
distributed forcing must follow (closure-captured global arrays cannot be
sharded).

Usage: JAX_PLATFORMS=cpu \
       XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python validation/run_distributed_basin.py [--size 360x300]
       [--steps 6] [--py 4]
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
deg = np.pi / 180.0

from arctic_basin_seasonal_cycle import (TAB_SHORTWAVE, TAB_LONGWAVE,
                                         TAB_SENSIBLE, TAB_LATENT, TIMES)

TAU0 = 0.12


def _wind_expr(lon, lat, t, comp):
    """Seasonal anticyclonic gyre + transpolar drift as a pure elementwise
    expression of (lon_cc, lat_cc, time), traced into the step graph."""
    import jax.numpy as jnp

    lon = (lon + 180.0) % 360.0 - 180.0
    lon_r, lat_r = lon * deg, lat * deg

    def stereo(lon0, lat0):
        x = jnp.cos(lat_r) * jnp.sin(lon_r - lon0 * deg)
        y = (jnp.cos(lat0 * deg) * jnp.sin(lat_r)
             - jnp.sin(lat0 * deg) * jnp.cos(lat_r) * jnp.cos(lon_r - lon0 * deg))
        return x, y

    gx, gy = stereo(-150.0, 80.0)
    fx, fy = stereo(0.0, 78.0)
    r2 = gx * gx + gy * gy
    amp = jnp.exp(-r2 / (2 * 0.25 ** 2))
    tau_gx = amp * gy / jnp.sqrt(r2 + 1e-6)
    tau_gy = -amp * gx / jnp.sqrt(r2 + 1e-6)
    drift = jnp.exp(-(fx * fx + fy * fy) / (2 * 0.6 ** 2))
    seasonal = 1.0 + 0.4 * jnp.cos(2 * jnp.pi * t / (360 * day))
    if comp == 0:
        out = TAU0 * seasonal * (0.7 * tau_gx + 0.5 * (-drift * fx))
    else:
        out = TAU0 * seasonal * (0.7 * tau_gy + 0.5 * (-drift * fy))
    return out.astype(jnp.float32)


def _wind_components(grid_, clock):
    """Winds from the grid argument's coordinates (works on global AND
    shard-local grids)."""
    import jax.numpy as jnp

    lon = jnp.asarray(grid_.lon_cc, jnp.float32)
    lat = jnp.asarray(grid_.lat_cc, jnp.float32)
    return (_wind_expr(lon, lat, clock.time, 0),
            _wind_expr(lon, lat, clock.time, 1))


def build(Nx, Ny, substeps=24, max_relaxation=300.0, thermo=True):
    import jax.numpy as jnp

    grid = csi.TripolarGrid((Nx, Ny), southernmost_latitude=45.0,
                            transition_latitude=65.0, halo=5, dtype="float32")
    lon = (np.asarray(grid.lon_cc) + 180.0) % 360.0 - 180.0
    lat = np.asarray(grid.lat_cc)
    I = grid.interior
    lonI, latI = I(lon), I(lat)
    land = latI < 58.0
    land |= (lonI > 20) & (lonI < 180) & (latI < 73.0)
    land |= (lonI > -170) & (lonI < -60) & (latI < 72.0)
    land |= (lonI > -60) & (lonI < -20) & (latI < 80.0)
    land[[0, 1, Nx - 1], Ny - 1] = True
    land[Nx // 2 - 1:Nx // 2 + 2, Ny - 1] = True
    grid = csi.ImmersedBoundaryGrid(grid, land)

    def wind_u(grid_, clock, fields, params=None):
        return _wind_components(grid_, clock)[0]

    def wind_v(grid_, clock, fields, params=None):
        return _wind_components(grid_, clock)[1]

    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(
            max_relaxation_parameter=max_relaxation),
        coriolis=csi.FPlane(f=1.4e-4),
        top_momentum_stress={"u": csi.StressFunction(func=wind_u),
                             "v": csi.StressFunction(func=wind_v)},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        immersed_drag=csi.ImmersedDrag(coefficient=1e-3),
        solver=csi.SplitExplicitSolver(substeps=substeps))

    Rs = FieldTimeSeries(times=TIMES, data=TAB_SHORTWAVE, cyclical=True)
    Rl = FieldTimeSeries(times=TIMES, data=TAB_LONGWAVE, cyclical=True)
    Qs = FieldTimeSeries(times=TIMES, data=TAB_SENSIBLE, cyclical=True)
    Ql = FieldTimeSeries(times=TIMES, data=TAB_LATENT, cyclical=True)

    def solar_flux(grid_, Tu, clock, fields, fts):
        lat_ = jnp.asarray(grid_.lat_cc, jnp.float32)
        sw = jnp.clip(jnp.cos(lat_ * deg) / np.cos(75.0 * deg), 0.3, 1.6)
        albedo = jnp.where(Tu < -0.1, 0.75, 0.64)
        return fts.at_time(clock.time) * sw * (1 - albedo)

    Q_sw = csi.FluxFunction(func=solar_flux, parameters=Rs,
                            top_temperature_dependent=True)
    Q_em = csi.RadiativeEmission(emissivity=1.0,
                                 stefan_boltzmann_constant=5.67e-8 * 1.02)
    model = csi.sea_ice_model(
        grid, dynamics=dynamics,
        ice_thermodynamics=csi.sea_ice_slab_thermodynamics() if thermo
        else None,
        snow_thermodynamics=csi.snow_slab_thermodynamics() if thermo
        else None,
        snowfall=3.2e-6 if thermo else None,
        top_heat_flux=(Q_sw, Rl, Qs, Ql, Q_em) if thermo else None,
        bottom_heat_flux=-2.0 if thermo else None,
        advection=csi.WENO(order=7), timestepper="ForwardEuler")

    h0 = np.clip((latI - 62.0) / 20.0, 0.0, 1.0) * 2.0
    a0 = np.clip((latI - 60.0) / 10.0, 0.0, 1.0)
    h0[land] = 0.0
    a0[land] = 0.0
    kw = dict(h=h0, a=a0)
    if thermo:
        kw["hs"] = 0.0
    state = csi.initial_state(model, **kw)
    return model, state


def main():
    import jax
    from climaseaice_jl_tpu.model import _step
    from climaseaice_jl_tpu.parallel import make_distributed_step
    from climaseaice_jl_tpu.parallel.stepper import (strip_halos,
                                                     unstrip_halos, _strip_one)
    from climaseaice_jl_tpu.parallel.multihost import (save_rank_snapshot,
                                                       reassemble_rank_snapshots)
    from climaseaice_jl_tpu.io.writers import NetCDFWriter
    from climaseaice_jl_tpu.simulation import Simulation, IterationInterval

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="360x300")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dt", type=float, default=600.0)
    ap.add_argument("--py", type=int, default=4)
    ap.add_argument("--alpha-max", type=float, default=300.0,
                    help="max_relaxation_parameter; 300 = reference default "
                         "(non-contractive: serial-vs-distributed agreement "
                         "is roundoff-amplification-limited); 1e4 = "
                         "contractive regime (tight agreement)")
    ap.add_argument("--no-thermo", action="store_true",
                    help="dynamics+advection only (smaller/faster run)")
    args = ap.parse_args()
    Nx, Ny = map(int, args.size.split("x"))
    here = os.path.dirname(os.path.abspath(__file__))
    prefix = os.path.join(here, "dist_basin")

    model, state = build(Nx, Ny, max_relaxation=args.alpha_max,
                         thermo=not args.no_thermo)

    # --- distributed run -------------------------------------------------------
    dstep, mesh = make_distributed_step(model, (1, args.py))
    s = strip_halos(model, state)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        s = dstep(s, args.dt)
    jax.block_until_ready(s.h)
    wall = time.perf_counter() - t0
    outs = ("u", "v", "h", "a") + (() if args.no_thermo else ("hs",))
    save_rank_snapshot(prefix, s, args.steps, time=args.steps * args.dt,
                       outputs=outs)
    got = reassemble_rank_snapshots(prefix, args.steps, (Nx, Ny))

    # --- serial reference ------------------------------------------------------
    ser = state
    step = jax.jit(lambda st: _step(model, st, args.dt))
    for _ in range(args.steps):
        ser = step(ser)

    # Split the comparison: the ~12 rows nearest the two grid poles have the
    # smallest cells, where γ = clamp(√(ζcαΔt/mAz)) saturates at α⁺ and the
    # αEVP iteration is locally non-contractive — ulp-level seeds from
    # shape-dependent XLA fusion of the traced forcing amplify there
    # regardless of α⁺ (the reference sidesteps this only because Julia's
    # per-point arithmetic is bit-identical across ranks).  The basin-wide
    # metric excludes that band; the band is reported separately.
    CAP = 12
    fields = [n for n in ("u", "v", "h", "a", "hs")
              if getattr(ser, n) is not None]
    errs, errs_cap = {}, {}
    for name in fields:
        ref = np.asarray(_strip_one(name, getattr(ser, name), model.grid))
        scale = max(np.abs(ref).max(), 1e-8)
        d = np.abs(got[name] - ref) / scale
        errs[name] = float(d[:, :-CAP].max())
        errs_cap[name] = float(d[:, -CAP:].max())
        assert np.isfinite(got[name]).all(), name

    # --- stream the reassembled output to NetCDF -------------------------------
    nc_path = os.path.join(here, "dist_basin.nc")
    full = unstrip_halos(model, s)
    sim = Simulation(model, full, dt=args.dt, stop_iteration=args.steps)
    writer = NetCDFWriter(["h", "a", "u", "v"], nc_path, IterationInterval(1))
    writer.maybe_write(sim)

    pts = Nx * Ny * args.steps / wall
    print(json.dumps({
        "grid": f"{Nx}x{Ny} tripolar immersed", "mesh": [1, args.py],
        "steps": args.steps, "dt_s": args.dt,
        "thermo": not args.no_thermo,
        "distributed_pts_per_s": round(pts, 1),
        "serial_vs_distributed_rel_err": errs,
        "pole_cap_band_rel_err": errs_cap,
        "netcdf": os.path.basename(nc_path),
        "device": f"{jax.devices()[0].platform} {jax.devices()[0].device_kind}",
    }))
    # The pole-cap band is reported separately: the rows nearest the grid
    # poles have tiny cells where γ saturates at α⁺ and αEVP is locally
    # non-contractive.
    if args.alpha_max >= 1e3:
        # velocities amplify near the ice edge and just south of the cap
        # band; the prognostic h/ℵ stay tight
        ok = (errs["u"] < 5e-3 and errs["v"] < 5e-3
              and all(errs[k] < 1e-4 for k in fields[2:]))
    else:
        ok = (errs["u"] < 2e-2 and errs["v"] < 2e-2
              and all(errs[k] < 5e-3 for k in fields[2:]))
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
