#!/usr/bin/env python3
"""Why the SSD scan's scores, chunk states and carried-state term are
float32 chains on the card.

Serves mamba2-130m's long request set (four prompts of 2048, 1024, 1536
and 1792 tokens, left-padded to 2048; the seeded weights of
``chip_smoke.py``) through ``ServeEngine`` on the card and records every
``ssd_scan_fwd`` launch of the prefill (24, one a layer).  Each launch is
held against the plain version on the card by the element-wise bfloat16
rule (``bf16_err_ratio``: the rule holds at 1), through the kernels and
through variants of the scan's arithmetic evaluated in torch on the card
(``repro_torch.kernels.ssd_scan.emulate``):

  * the plain version's own float32 products (the design the kernels
    follow: scores, S and C . H_prev as float32 chains), with w' in two
    bfloat16 parts;
  * C . H_prev exact (float64, rounded once), and from two bfloat16 parts
    of H;
  * S from B * dt * seg in three bfloat16 parts (exact products, as
    wgmma takes them);
  * the scores summed as wgmma sums them: exact 16-deep products added
    to a float32 accumulator that rounds toward zero.

It prints each one's worst ratio over the 24 launches, the launch where
it is worst, and the rms of y's row there (left-padded rows fall to
~1e-8).  Needs a CUDA card.  Run from the root of a checkout:

    PYTHONPATH=src python tools/ssd_rounding.py
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.retry import RetryPolicy
from repro_torch.kernels.flash_attention.plain import bf16_err_ratio
from repro_torch.kernels.ssd_scan import ops as SSD
from repro_torch.kernels.ssd_scan.emulate import tensor_core_emulation
from repro_torch.kernels.ssd_scan.plain import ssd_scan_plain
from repro_torch.serving import ServeEngine

LONG_LENGTHS = (2048, 1024, 1536, 1792)     # chip_smoke.py's long set
CHUNK = 256


def variants(x, Bm, Cm, dt, dA):
    """y (BH, T, hd) of one launch under each variant."""
    def run(**kw):
        return tensor_core_emulation(x, Bm, Cm, dt, dA, CHUNK, **kw)[0]

    yield "float32 products (the kernels' design)", run()
    yield "C . H_prev exact, rounded once", run(exact_ch=True)
    yield "C . H_prev from two bf16 parts of H", run(h_parts=2)
    yield ("S from three bf16 parts (wgmma's exact products)",
           run(s_parts=3))
    yield ("scores summed as wgmma sums them (truncating)",
           run(wgmma_scores=True))


def row_rms_at_worst(y, want):
    """The rms of want's row where y's worst element is."""
    w = want.float()
    err = (y.float() - w).abs()
    _, ex = torch.frexp(w)
    ulp = torch.where(w != 0, torch.exp2((ex - 8).float()), 0.0)
    rms = w.square().mean(dim=-1, keepdim=True).sqrt()
    ratio = torch.where(err == 0, 0.0, err / (ulp + 2.0 ** -8 * rms))
    flat = int(torch.argmax(ratio))
    return float(rms.flatten()[flat // w.shape[-1]])


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-130m")
    eng = ServeEngine(cfg, policy=RetryPolicy("pr2ar2"), tau=0.05, seed=0,
                      device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab, size=n).astype(np.int32)
               for n in LONG_LENGTHS]
    calls = []
    orig = SSD.ssd_scan_fwd

    def record(x, Bm, Cm, dt, dA, chunk=CHUNK):
        calls.append((x, Bm, Cm, dt, dA))
        return orig(x, Bm, Cm, dt, dA, chunk)

    SSD.ssd_scan_fwd = record
    try:
        eng.generate(prompts, max_new_tokens=1)
    finally:
        SSD.ssd_scan_fwd = orig
    worst = {}
    for n, args in enumerate(calls):
        want, _ = ssd_scan_plain(*args, chunk=CHUNK)
        got, _ = SSD.ssd_scan_fwd(*args, chunk=CHUNK)
        runs = [("the kernels", got)] + list(variants(*args))
        for name, y in runs:
            r = bf16_err_ratio(y, want)
            if r > worst.get(name, (-1.0,))[0]:
                worst[name] = (r, n, row_rms_at_worst(y, want))
        del runs
        torch.cuda.empty_cache()
    for name, (r, n, rms) in worst.items():
        print(f"{name}: worst |err| / tolerance {r:.3g} (launch {n}, where "
              f"y's row rms is {rms:.3g})")


if __name__ == "__main__":
    main()
