#!/usr/bin/env python3
"""Where an inline sweep's host time goes on a CUDA card.

Runs ``run_sweep`` inline (``workers=1``) over the phase-10 grid of
``chip_smoke.py`` (``websearch`` at 20 000 requests, 365 d / 1000 P/E
and 30 d / 0 P/E, all six mechanisms, ``engine="batched"``) for
``--seeds`` seed groups, once to warm up and once under ``cProfile``,
and prints the wall of the profiled run (the profiler adds host
overhead), the functions with the most time of their own, and those
with the most cumulative time.  Then it times the same sweep without
the profiler under ``torch.profiler`` and prints the device's busy
share of the wall.  Run from the root of a checkout:

    PYTHONPATH=src python tools/sweep_profile.py [--seeds 8]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.flashsim import OperatingCondition, run_sweep

CONDITIONS = ((365.0, 1000.0), (30.0, 0.0))
MECHANISMS = ("baseline", "sota", "pr2", "ar2", "pr2ar2", "sota+pr2ar2")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    conds = tuple(OperatingCondition(*c) for c in CONDITIONS)

    def sweep(seeds):
        out = run_sweep("websearch", conds, MECHANISMS, seeds,
                        n_requests=20000, engine="batched", device="cuda")
        torch.cuda.synchronize()
        return out

    print(torch.cuda.get_device_name(0))
    sweep((1000,))                       # characterize, build, warm up
    seeds = tuple(range(args.seeds))
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    sweep(seeds)
    prof.disable()
    wall = time.perf_counter() - t0
    print(f"profiled inline sweep of {len(seeds)} seed groups: {wall:.3f} s "
          f"({wall / len(seeds):.4f} s a group)")
    for key in ("tottime", "cumulative"):
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(args.top)
        print(buf.getvalue())

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        sweep(seeds)
    wall = time.perf_counter() - t0
    events = [e for e in tp.key_averages()
              if _device_us(e) > 0 and e.device_type is not None
              and "cuda" in str(e.device_type).lower()]
    busy = sum(map(_device_us, events)) * 1e-6
    print(f"torch.profiler: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({busy / wall:.1%}); the profiler adds host overhead")
    for e in sorted(events, key=_device_us, reverse=True)[:10]:
        print(f"  {_device_us(e) / 1e3:10.3f} ms x{e.count:<5} {e.key[:90]}")


if __name__ == "__main__":
    main()
