#!/usr/bin/env python3
"""The KV retry read (B3) on the card: its vector kernel against the
designs it was measured against, on full-width decode leaves.

Builds ``src/repro_torch/kernels/kv_retry/csrc/kv_retry.cu`` and
``tools/kv_ablation.cu`` (the ablations: the vector kernel at 1 and 4
pages in flight a thread, a lane's values in two spread halves, and bulk
copies through shared memory) and prints ptxas' report of their kernels.
Then on llama3.2-3b's decode leaf (28 x 4 x 8 x 2048 pages of 128
bfloat16 values, drawn as ``chip_smoke.py`` draws it: a third of the
pages carry one large value) at tau 0.02 (a quarter of the pages retry)
and 0.05 (none does, as in the long pr2ar2 run), and at page widths 64
and 256 over the same bytes (tau 0.02), it holds every variant against
the plain version (margins within rtol 1e-6 of the larger of the margin
and its ratio term, 0 flips, outputs bit for bit), and times each with
CUDA events in two rounds (the second in reverse order), beside the
warp-per-page kernel (the first design) and two yardsticks of the HBM
rate: a ``copy_`` of the leaf (reads and writes) and a ``fill_`` of it
(writes only).  Each kernel's time is printed with its bytes bound (int8 pages,
scales, margins and output, and the backing of the pages that retry,
over 3.35 TB/s) and the share of it.  Needs a CUDA card.  Run from the
root of a checkout:

    PYTHONPATH=src python tools/kv_ablation.py
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_retry import ops as KV
from repro_torch.kernels.kv_retry.plain import kv_retry_plain, quantize_pages

REPS = 10
HBM_BYTES_PER_S = 3.35e12
MARGIN_RTOL = 1e-6
LEAF_PAGES = 28 * 4 * 8 * 2048
ABLATION = Path(__file__).resolve().parent / "kv_ablation.cu"
# Variants of kv_ablation_launch.
ABLATIONS = {"vector, 1 page in flight": 1, "vector, 4 pages in flight": 4,
             "spread halves": 5, "bulk copies through shared memory": 6}


def ms(fn, reps=REPS):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ablation_fn():
    fn = build.load(ABLATION).kv_ablation_launch
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn


def variants(q, s, b, tau):
    """{name: launch() -> (out, margin)} of the port's two kernels and the
    ablations."""
    fn = ablation_fn()
    P, E = q.shape

    def ablation(v):
        out = torch.empty_like(b)
        margin = torch.empty((P, 1), dtype=torch.float32, device="cuda")
        err = fn(q.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
                 margin.data_ptr(), P, E, tau, 1, v,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ablation {v}: CUDA error {err}")
        return out, margin

    runs = {"vector (the port: 2 pages in flight)":
            lambda: KV._launch_cuda(q, s, b, tau, vector=True)}
    runs.update({n: (lambda v=v: ablation(v)) for n, v in ABLATIONS.items()})
    runs["warp-per-page kernel (the first design)"] = lambda: KV._launch_cuda(
        q, s, b, tau, vector=False)
    return runs


def leaf(gen, P, E):
    backing = torch.randn((P, E), generator=gen, device="cuda").to(
        torch.bfloat16)
    spiky = torch.rand(P, generator=gen, device="cuda") < 0.3
    col = torch.randint(0, E, (P,), generator=gen, device="cuda")
    backing[spiky, col[spiky]] *= 40.0
    return (*quantize_pages(backing), backing)


def hold(q, s, b, tau, runs):
    """Every variant against the plain version: margins within the rule,
    0 flips, outputs bit for bit.  Returns the bytes bound in ms."""
    want, want_m = kv_retry_plain(q, s, b, tau)
    w = want_m.double()
    for name, run in runs.items():
        out, margin = run()
        gap = float(((margin.double() - w).abs()
                     / torch.maximum(w.abs(), (1 - w).abs())).max())
        flips = int(((margin >= 0) != (want_m >= 0)).sum())
        if gap > MARGIN_RTOL or flips or not torch.equal(out, want):
            raise AssertionError(f"{name} differs from the plain version: "
                                 f"gap {gap:.3g}, {flips} flips")
    retried = int((want_m < 0).sum())
    P, E = q.shape
    n_bytes = (q.numel() + 8 * P + want.numel() * want.element_size()
               + retried * E * b.element_size())
    print(f"  {P} pages of {E}, tau {tau}: {retried} retried; every variant "
          f"within the rule, 0 flips, outputs bit for bit; "
          f"{n_bytes / 1e6:.1f} MB moved", flush=True)
    return n_bytes / HBM_BYTES_PER_S * 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kv_ablation: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    for src, lib in build.build_all([KV._SOURCE, ABLATION]).items():
        for line in Path(f"{lib}.log").read_text().splitlines():
            if "Used" in line or "spill" in line or "entry function" in line:
                print(f"ptxas ({src.name}): {line.strip()}")
    gen = torch.Generator("cuda").manual_seed(0)
    for E, tau in ((128, 0.02), (128, 0.05), (64, 0.02), (256, 0.02)):
        q, s, b = leaf(gen, LEAF_PAGES * 128 // E, E)
        runs = variants(q, s, b, tau)
        bound = hold(q, s, b, tau, runs)
        dst = torch.empty_like(b)
        runs["copy_ of the leaf"] = lambda: dst.copy_(b)
        runs["fill_ of the leaf"] = lambda: dst.fill_(1.0)
        names = list(runs)
        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                times[n].append(ms(runs[n]))
        leaf_bytes = b.numel() * b.element_size()
        for n in names:
            t = times[n]
            if n.endswith("of the leaf"):
                moved = leaf_bytes * (2 if n.startswith("copy") else 1)
                print(f"  {n}: {t[0]:.4f} / {t[1]:.4f} ms, "
                      f"{moved / min(t) / 1e6:.0f} GB/s of "
                      f"{moved / 1e6:.0f} MB", flush=True)
            else:
                print(f"  {n}: {t[0]:.4f} / {t[1]:.4f} ms, "
                      f"{bound / min(t) * 100:.1f}% of the {bound:.4f} ms "
                      f"bytes bound", flush=True)
        del q, s, b, dst, runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
