#!/usr/bin/env python3
"""Host-clock prefill and decode-step times of ``ServeEngine`` on a CUDA
card, for comparing two checkouts of the port in one run.

Builds ``ServeEngine`` for ``--arch`` (mamba2-130m by default) at full
width with seeded weights on the card, warms it up with one
``generate``, then runs ``generate`` ``--reps`` times on
``launch.serve.default_prompts`` (``--batch`` prompts of 4 to 11
tokens) with ``--new`` tokens and prints one
JSON line: the ``repro_torch`` it imported, the prefill times, the
decode times per step (``ServeStats.decode_s`` over the steps) and their
medians, and the greedy tokens' digest (equal across checkouts that
compute the same tokens).  The times are the host's clock around
synchronized calls, so they include the host's Python.  To compare the
parent (unpacked with ``git archive`` into a gitignored directory such
as ``build/parent``) with this tree, run from the root of this tree:

    PYTHONPATH=build/parent/src python tools/decode_time.py
    PYTHONPATH=src python tools/decode_time.py
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics

import numpy as np
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core.retry import RetryPolicy
from repro_torch.launch.serve import default_prompts
from repro_torch.serving import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new", type=int, default=33,
                    help="tokens a request generates (decode steps + 1)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_time.py needs a CUDA card")
    cfg = get_config(args.arch)
    eng = ServeEngine(cfg, policy=RetryPolicy("pr2ar2"), seed=0,
                      device="cuda")
    prompts = default_prompts(cfg.vocab, args.batch)
    eng.generate(prompts, max_new_tokens=args.new)            # warm-up
    prefill, step, digest = [], [], None
    for _ in range(args.reps):
        gen, st = eng.generate(prompts, max_new_tokens=args.new)
        prefill.append(st.prefill_s)
        step.append(st.decode_s / (args.new - 1))
        digest = hashlib.sha256(np.ascontiguousarray(gen).tobytes()
                                ).hexdigest()[:16]
    print(json.dumps({
        "arch": args.arch, "package": repro_torch.__file__,
        "device": torch.cuda.get_device_name(0),
        "prefill_s": prefill, "decode_step_s": step,
        "prefill_median_s": statistics.median(prefill),
        "decode_step_median_s": statistics.median(step),
        "tokens_sha256": digest}))


if __name__ == "__main__":
    main()
