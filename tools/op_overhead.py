"""Time B4 and B5 through their wrappers, call by call, on the card.

For comparing two checkouts in one call (run it once per checkout, in
turns): each case is called ``--reps`` times back to back after a
warm-up, timed by CUDA events (device time between the first call's
start and the last call's end, so a launch slower to enqueue than to run
shows) and by the host clock around the same loop ended by a
synchronize.  Cases: B4 at llama3.2-3b's long prefill shape (4 x 2048,
24 heads over 8, hd 128, causal, bf16) and at a short prompt (T 11); B5
at mamba2-130m's long prefill shape (4 x 2048, 24 heads, hd 64, ds 128,
chunk 256, bf16) and at T 11.

Usage (from the root of a checkout; ``--src`` picks another one's
``src``):
  python tools/op_overhead.py [--src build/parent/src] [--reps 200]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path


def _time(fn, reps):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / reps * 1e3
    return start.elapsed_time(end) / reps, host


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssd_scan import ops as SSD

    if not torch.cuda.is_available():
        print("op_overhead: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    g = torch.Generator("cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    cases = {}
    for T in (2048, 11):
        q, k, v = randn(96, T, 128), randn(32, T, 128), randn(32, T, 128)
        cases[f"B4 T {T}"] = lambda q=q, k=k, v=v: FA.flash_attention_fwd(
            q, k, v, causal=True)
        x, Bm, Cm = randn(96, T, 64), randn(4, T, 128), randn(4, T, 128)
        dt = torch.rand((96, T), generator=g, device="cuda") * 0.1
        cases[f"B5 T {T}"] = lambda a=(x, Bm, Cm, dt, -dt): \
            SSD.ssd_scan_fwd(*a, chunk=256)
    print(f"{args.src} on {smi}, torch {torch.__version__}")
    for name, fn in cases.items():
        dev, host = _time(fn, args.reps)
        print(f"{name}: {dev:.4f} ms a call by CUDA events, {host:.4f} ms "
              f"by the host clock ({args.reps} calls back to back)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
