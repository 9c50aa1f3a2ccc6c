#!/usr/bin/env python3
"""Where the serving path's time goes on a CUDA card.

Builds ``ServeEngine`` for ``--arch`` (llama3.2-3b by default, or
mamba2-130m) at full width with seeded weights on the card (as
``chip_smoke.py``'s serve paths do), warms it up, then
runs ``generate`` for each request set and mechanism under
``torch.profiler`` and prints, per run: the host-clock prefill and
decode times, the device time of every CUDA kernel summed by kind (the
port's serving kernels, matrix products, copies and casts, other),
the device's busy share of the wall time, and the ten kernels with the
most device time.  The profiler adds host overhead, so its wall times
run above ``chip_smoke.py``'s.  Run from the root of a checkout:

    PYTHONPATH=src python tools/serve_profile.py [--arch mamba2-130m]
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.retry import RetryPolicy
from repro_torch.launch.serve import default_prompts
from repro_torch.serving import ServeEngine

LONG_LENGTHS = (2048, 1024, 1536, 1792)


def _kind(name: str) -> str:
    n = name.lower()
    if "fa_fwd_kernel" in n or "fa_tc_kernel" in n:
        return "flash_attention kernel"
    if "kv_retry_kernel" in n:
        return "kv_retry kernel"
    if "ssd_scan_kernel" in n:
        return "ssd_scan kernel"
    if "gemm" in n or "gemv" in n or "xmma" in n or "cutlass" in n \
            or "matmul" in n:
        return "matrix products"
    if "copy" in n or "cast" in n or "convert" in n:
        return "copies and casts"
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None):
    import numpy as np

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_profile: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    eng = ServeEngine(cfg, policy=RetryPolicy("pr2ar2"), tau=0.05, seed=0,
                      device="cuda")
    engines = {"pr2ar2": eng,
               "baseline": ServeEngine(cfg, params=eng.params,
                                       policy=RetryPolicy("baseline"),
                                       tau=0.05, device="cuda")}
    rng = np.random.default_rng(1)
    sets = {"short": default_prompts(cfg.vocab, 4),
            "long": [rng.integers(2, cfg.vocab, size=n).astype(np.int32)
                     for n in LONG_LENGTHS]}
    for e in engines.values():
        e.generate(sets["short"], max_new_tokens=2)
    for set_name, prompts in sets.items():
        for mech, e in engines.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, st = e.generate(prompts, max_new_tokens=16)
                wall = time.perf_counter() - t0
            kernels = [evt for evt in prof.key_averages()
                       if _device_us(evt) > 0 and evt.device_type is not None
                       and "cuda" in str(evt.device_type).lower()]
            by_kind = {}
            for evt in kernels:
                k = _kind(evt.key)
                by_kind[k] = by_kind.get(k, 0.0) + _device_us(evt)
            busy = sum(by_kind.values()) / 1e6
            print(f"{args.arch} {set_name} {mech}: wall {wall * 1e3:.1f} ms (prefill "
                  f"{st.prefill_s * 1e3:.1f} ms, decode "
                  f"{st.decode_s * 1e3:.1f} ms, 15 steps); device busy "
                  f"{busy * 1e3:.1f} ms = {busy / wall:.1%} of the wall")
            for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
                print(f"    {k:>24}: {us / 1e3:9.3f} ms")
            for evt in sorted(kernels, key=_device_us, reverse=True)[:10]:
                print(f"      {_device_us(evt) / 1e3:9.3f} ms "
                      f"x{evt.count:<5} {evt.key[:90]}")


if __name__ == "__main__":
    main()
