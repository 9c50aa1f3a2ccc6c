#!/usr/bin/env python3
"""Where the serving path's time goes on a CUDA card.

Builds ``ServeEngine`` for each ``--arch`` (llama3.2-3b by default;
mamba2-130m, recurrentgemma-2b, olmoe-1b-7b, whisper-large-v3 and
internvl2-1b, fed their frontends' zero inputs) at full width with seeded
weights on the card (as ``chip_smoke.py``'s serve paths do), warms it
up, then runs ``generate`` for each request set and mechanism under
``torch.profiler`` and prints, per run: the host-clock prefill and
decode times, the device time of every CUDA kernel summed by kind (the
port's serving kernels, matrix products, copies and casts, the MoE
dispatch's sorts, scans and indexing, other elementwise work), the
device's busy share of the wall time, the kernel launches, and the ten
kernels with the most device time.  Then the same for one prefill of
the set alone, and the decode steps' share (the run less its prefill)
per step.  The profiler adds host overhead, so its wall times run above
``chip_smoke.py``'s.  Run from the root of a checkout:

    PYTHONPATH=src python tools/serve_profile.py [--arch A [A ...]]
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.retry import RetryPolicy
from repro_torch.launch.serve import default_prompts
from repro_torch.models.api import frontend_zeros
from repro_torch.serving import ServeEngine

LONG_LENGTHS = (2048, 1024, 1536, 1792)
#: Long sets within a model's context: whisper's decoder 448 positions
#: (with 16 new tokens), internvl's 2048 (with 256 patches).
ARCH_LONG_LENGTHS = {"whisper-large-v3": (224, 432, 300, 380),
                     "internvl2-1b": (768, 1792, 1024, 1536)}


def _kind(name: str) -> str:
    n = name.lower()
    if "fa_fwd_kernel" in n or "fa_tc_kernel" in n:
        return "flash_attention kernel"
    if "kv_retry_kernel" in n or "kv_retry_vec_kernel" in n:
        return "kv_retry kernel"
    if any(f"ssd_{k}_kernel" in n for k in ("scan", "scan_tc", "pass",
                                             "state_scores")):
        return "ssd_scan kernel"
    if "gemm" in n or "gemv" in n or "xmma" in n or "cutlass" in n \
            or "matmul" in n or "nvjet" in n:   # nvjet_*: cuBLAS (CUDA 12.8)
        return "matrix products"
    if "copy" in n or "cast" in n or "convert" in n:
        return "copies and casts"
    if any(w in n for w in ("sort", "radix", "scan", "index", "scatter",
                            "gather", "cumsum")):
        return "sorts, scans, indexing"
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _profiled(fn):
    """(wall s, {kind: device us}, kernel launches, top kernels) of
    ``fn()`` under ``torch.profiler``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [evt for evt in prof.key_averages()
               if _device_us(evt) > 0 and evt.device_type is not None
               and "cuda" in str(evt.device_type).lower()]
    by_kind = {}
    for evt in kernels:
        k = _kind(evt.key)
        by_kind[k] = by_kind.get(k, 0.0) + _device_us(evt)
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    return wall, by_kind, sum(evt.count for evt in kernels), top, out


def _print_kinds(by_kind, scale=1.0):
    for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"    {k:>24}: {us * scale / 1e3:9.3f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["llama3.2-3b"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_profile: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    for arch in args.arch:
        _profile_arch(arch)
        torch.cuda.empty_cache()


def _profile_arch(arch):
    import numpy as np

    cfg = get_config(arch)
    eng = ServeEngine(cfg, policy=RetryPolicy("pr2ar2"), tau=0.05, seed=0,
                      device="cuda")
    engines = {"pr2ar2": eng,
               "baseline": ServeEngine(cfg, params=eng.params,
                                       policy=RetryPolicy("baseline"),
                                       tau=0.05, device="cuda")}
    rng = np.random.default_rng(1)
    sets = {"short": default_prompts(cfg.vocab, 4),
            "long": [rng.integers(2, cfg.vocab, size=n).astype(np.int32)
                     for n in ARCH_LONG_LENGTHS.get(arch, LONG_LENGTHS)]}
    for e in engines.values():
        e.generate(sets["short"], max_new_tokens=2)
    for set_name, prompts in sets.items():
        batch = {"tokens": torch.as_tensor(eng._pad_batch(prompts),
                                           device=eng.device),
                 **frontend_zeros(cfg, len(prompts), eng.device)}
        with torch.inference_mode():
            p_wall, p_kind, p_n, p_top, _ = _profiled(
                lambda: eng.model.prefill(eng.params, batch))
        busy = sum(p_kind.values()) / 1e6
        print(f"{arch} {set_name} prefill alone: wall {p_wall * 1e3:.1f} ms; "
              f"device busy {busy * 1e3:.1f} ms = {busy / p_wall:.1%}; "
              f"{p_n} kernel launches")
        _print_kinds(p_kind)
        for evt in p_top:
            print(f"      {_device_us(evt) / 1e3:9.3f} ms "
                  f"x{evt.count:<5} {evt.key[:90]}")
        for mech, e in engines.items():
            wall, by_kind, n, top, (_, st) = _profiled(
                lambda: e.generate(prompts, max_new_tokens=16))
            busy = sum(by_kind.values()) / 1e6
            print(f"{arch} {set_name} {mech}: wall {wall * 1e3:.1f} ms "
                  f"(prefill {st.prefill_s * 1e3:.1f} ms, decode "
                  f"{st.decode_s * 1e3:.1f} ms, 15 steps); device busy "
                  f"{busy * 1e3:.1f} ms = {busy / wall:.1%} of the wall; "
                  f"{n} kernel launches")
            _print_kinds(by_kind)
            for evt in top:
                print(f"      {_device_us(evt) / 1e3:9.3f} ms "
                      f"x{evt.count:<5} {evt.key[:90]}")
            step = {k: us - p_kind.get(k, 0.0) for k, us in by_kind.items()}
            d_busy = sum(step.values()) / 1e6 / 15
            print(f"  a decode step (the run less the prefill alone, / 15): "
                  f"host {st.decode_s / 15 * 1e3:.1f} ms (profiled), device busy "
                  f"{d_busy * 1e3:.2f} ms = {d_busy * 15 / st.decode_s:.1%}, "
                  f"{(n - p_n) / 15:.0f} kernel launches")
            _print_kinds(step, 1 / 15)


if __name__ == "__main__":
    main()
