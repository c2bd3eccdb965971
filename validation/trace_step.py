"""Profile one step of the flagship and summarise what ran on the device.

    python validation/trace_step.py [--N 512] [--substeps 120] [--out DIR]

Compiles and warms up bench.py's configuration, then records one step with
``jax.profiler.trace`` into ``DIR`` (default ``chiprun_out/trace``) and reads
the trace back.  For each device plane it prints the number of events, the
time from the first event's start to the last one's end (span), the time
covered by at least one event (busy), the kernels launched exactly
3 × substeps times (once per EVP substep of each RK3 stage), and the kernels
with the most device time.  The summary also goes to ``DIR/summary.json``.
"""

import argparse
import collections
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def busy_ns(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def summarise(xspace_path, substeps):
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xspace_path).planes:
        if not plane.name.startswith("/device:"):
            continue
        counts, times, intervals = (collections.Counter(),
                                    collections.Counter(), [])
        for line in plane.lines:
            for ev in line.events:
                key = f"{line.name} | {ev.name}"
                counts[key] += 1
                times[key] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        if not intervals:
            continue
        loop = {k: n for k, n in counts.items() if n == 3 * substeps}
        out[plane.name] = {
            "events": sum(counts.values()),
            "distinct": len(counts),
            "span_ns": max(e for _, e in intervals)
                       - min(s for s, _ in intervals),
            "busy_ns": busy_ns(intervals),
            "ops_per_substep": len(loop),
            "loop_kernels": loop,
            "top": [(k, counts[k], t) for k, t in times.most_common(25)],
        }
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--N", type=int, default=512)
    ap.add_argument("--substeps", type=int, default=120)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "trace"))
    args = ap.parse_args()

    import jax
    import bench
    from climaseaice_jl_tpu.model import step
    from climaseaice_jl_tpu.utils import card_info, enable_compile_cache

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}", flush=True)
    if dev.platform == "gpu":
        print(f"card: {card_info()}", flush=True)
    enable_compile_cache()
    model, state = bench.build(args.N, args.substeps)
    dt = 120.0
    state = jax.block_until_ready(step(model, state, dt))  # compile, warm up
    with jax.profiler.trace(args.out):
        state = jax.block_until_ready(step(model, state, dt))

    paths = sorted(glob.glob(os.path.join(args.out, "plugins", "profile", "*",
                                          "*.xplane.pb")))
    summary = summarise(paths[-1], args.substeps)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for name, s in summary.items():
        print(f"{name}: events {s['events']}  distinct {s['distinct']}  "
              f"span {s['span_ns'] / 1e6:.3f} ms  busy {s['busy_ns'] / 1e6:.3f} "
              f"ms  kernels once per substep {s['ops_per_substep']}  "
              f"events per substep {s['events'] / (3 * args.substeps):.1f}")
        for k, n, t in s["top"]:
            print(f"  {n:6d}  {t / 1e6:9.3f} ms  {k}")


if __name__ == "__main__":
    main()
