#!/usr/bin/env python3
"""Where the bfloat16 flash-attention kernel's time goes, by ablation.

Builds the port's flash-attention library
(``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``)
and copies of it with one part of the tensor-core kernel taken out by
text substitution: the softmax, the P·V products, the P_lo half of
them, or every ``wgmma``.  Each copy keeps the same TMA loads, barriers
and launch shape.  One more copy gives hd 128 tiles of 128 keys in
place of 64.  It prints ptxas' registers and spills of the hd-128
instance of each build, then times every build, in two rounds, on
full-width llama3.2-3b prefill launches (B 4, T 2048, 24 heads over 8
KV heads, causal; hd 128 and hd 64) with CUDA events.  The copies
compute wrong outputs, and only their times mean anything; the intact
kernel is held against the plain version first.  Needs a CUDA card.
Run from the root of a checkout:

    PYTHONPATH=src python tools/fa_ablation.py
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention.plain import (
    bf16_err_ratio, flash_attention_plain)

# (B, T, heads, KV heads, hd), causal.
SHAPES = ((4, 2048, 24, 8, 128), (4, 2048, 24, 8, 64))
REPS = 20
_NO_SOFTMAX = [("softmax(it, sc, c);", "c[0] = c[1] = 1.f;"),
               ("softmax(0, sc, c);", "c[0] = c[1] = 1.f;")]
_NO_PV = [("mma_rs<HD>(acc, p_hi + 4 * kk, dv);", ""),
          ("mma_rs<HD>(acc, p_lo + 4 * kk, dv);", "")]
_NO_S = [("mma_ss<BKV>(sc,", "if (kv_valid < 0) mma_ss<BKV>(sc,")]
VARIANTS = {
    "kernel": [],
    "no softmax": _NO_SOFTMAX,
    "no P.V wgmma": _NO_PV,
    "P_hi only": _NO_PV[1:],
    "no wgmma": _NO_PV + _NO_S,
    "128-key tiles": [("tc::launch<128, 64, 2>", "tc::launch<128, 128, 2>")],
}


def _sources():
    """One source per variant under build/fa_ablation/."""
    text = FA._SOURCE.read_text()
    out_dir = build.build_dir().parent / "fa_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, subs in VARIANTS.items():
        t = text
        for old, new in subs:
            if old not in t:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            t = t.replace(old, new)
        path = out_dir / f"fa_{name.replace(' ', '_').replace('.', '')}.cu"
        path.write_text(t)
        out[name] = path
    return out


def _entry(lib_path):
    fn = ctypes.CDLL(str(lib_path)).fa_fwd_tc_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                   ctypes.c_float, ci, ctypes.c_float, vp]
    fn.restype = ci
    return fn


def main():
    if not torch.cuda.is_available():
        raise SystemExit("fa_ablation: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    srcs = _sources()
    libs = build.build_all(list(srcs.values()))
    for name, path in srcs.items():
        lines = open(f"{libs[path]}.log").read().splitlines()
        for i, line in enumerate(lines):
            if "entry function" in line and "fa_tc_kernelILi128E" in line:
                report = [x.strip() for x in lines[i + 1:i + 4]
                          if "spill" in x or "Used" in x]
                print(f"{name}, hd 128: {'; '.join(report)}")
    fns = {name: _entry(libs[path]) for name, path in srcs.items()}
    gen = torch.Generator("cuda").manual_seed(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for B, T, H, K, hd in SHAPES:
        q, k, v = (torch.randn(n, T, hd, generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (B * H, B * K, B * K))
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B * H, T, T, B * K, hd, 1, 0, 0, T, hd ** -0.5, 0, 0.0,
                     stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        call(fns["kernel"])
        ratio = bf16_err_ratio(out, flash_attention_plain(q, k, v))
        if not ratio <= 1.0:
            raise AssertionError(f"kernel differs from plain: {ratio}")
        times = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                call(fn)
                start.record()
                for _ in range(REPS):
                    call(fn)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / REPS)
        base = sum(times["kernel"]) / 2
        print(f"q {tuple(q.shape)} k {tuple(k.shape)} causal, bf16 "
              f"(worst |err| / tolerance {ratio:.3g}):")
        for name, ts in times.items():
            ms = sum(ts) / 2
            print(f"  {name:>14}: {ts[0]:.4f} / {ts[1]:.4f} ms, "
                  f"{ms / base:.1%} of the kernel's")


if __name__ == "__main__":
    main()
