"""Serving from the command line: batched requests through the
retry-aware engine (see ``repro_torch.serving``).  ``--smoke`` runs a
reduced config.

Usage (the card is the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --smoke --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced_config
from repro_torch.core.retry import RetryPolicy
from repro_torch.serving import ServeEngine


def default_prompts(vocab: int, batch: int):
    """The command line's request set: ``batch`` prompts of 4 to 11 tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=rng.integers(4, 12)).astype(np.int32)
            for _ in range(batch)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dry-run", action="store_true",
                    help="lower and count on the production mesh "
                         "(ROADMAP D15b)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--mechanism", default="pr2ar2")
    ap.add_argument("--tau", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError("--dry-run is the dry-run's: "
                                  "ROADMAP D15b, the rest of item 13")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    engine = ServeEngine(cfg, policy=RetryPolicy(args.mechanism),
                         tau=args.tau, device=args.device)
    out, stats = engine.generate(default_prompts(cfg.vocab, args.batch),
                                 max_new_tokens=args.max_new)
    print(stats.summary())
    for i, row in enumerate(out[: min(4, len(out))]):
        print(f"  req{i}: {row.tolist()}")


if __name__ == "__main__":
    main()
