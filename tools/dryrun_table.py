"""Print the dry-run's records as a markdown table (one row a cell).

Reads ``results/dryrun_torch/*.json`` (``python -m
repro_torch.launch.dryrun --all --mesh both`` writes them) or the
directory given, and prints per rank: argument, output and temp bytes
(GB), whether the rank's total fits the card, FLOPs as ``dot`` and
``kernel``, and each collective kind's count and ring traffic (GB);
skipped and failed cells as one line each.  Counts of the program, not
times.

Usage:
  PYTHONPATH=src python tools/dryrun_table.py [DIR]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = (("all-gather", "AG"), ("all-reduce", "AR"),
         ("reduce-scatter", "RS"), ("all-to-all", "A2A"),
         ("collective-permute", "CP"))


def _gb(x) -> str:
    return f"{x / 1e9:.3f}"


def _pair(recs, fn) -> str:
    """``single / multi`` of one field."""
    return " / ".join(fn(recs[m]) if m in recs else "-"
                      for m in ("single", "multi"))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    d = Path(argv[0]) if argv else ROOT / "results" / "dryrun_torch"
    recs = [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]
    cells, skipped, failed = {}, [], []
    for r in recs:
        if r.get("status") == "ok":
            cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
        elif r.get("status") == "skipped":
            skipped.append(r)
        else:
            failed.append(r)
    print("| arch | shape | argument GB | output GB | temp GB | fits | "
          "dot FLOPs | kernel FLOPs | collectives (single): count / "
          "traffic GB | trace s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for (arch, shape), rs in sorted(cells.items()):
        c = rs.get("single", next(iter(rs.values())))["collectives"]
        coll = ", ".join(
            f"{short} {c['counts'][k]} / {_gb(c['traffic'][k])}"
            for k, short in KINDS if c["counts"][k])
        cols = [_pair(rs, lambda r, k=k: _gb(r["memory"][k]))
                for k in ("argument_bytes", "output_bytes", "temp_bytes")]
        cols.append(_pair(rs, lambda r: "yes" if r["memory"]["fits"]
                          else "no"))
        cols += [_pair(rs, lambda r, k=k: f"{r['flops_breakdown'][k]:.3e}")
                 for k in ("dot", "kernel")]
        cols += [coll or "none", _pair(rs, lambda r: str(r["trace_s"]))]
        print(f"| {arch} | {shape} | " + " | ".join(cols) + " |")
    if skipped:
        print(f"\nskipped ({skipped[0]['reason']}): "
              + ", ".join(sorted({f"{r['arch']} x {r['shape']}"
                                  for r in skipped})) + ", both meshes")
    for r in failed:
        print(f"\nFAILED {r['arch']} x {r['shape']} x {r['mesh']}: "
              f"{r['status']} ({r.get('log_tail', '')[-200:]})")
    n_ok = sum(len(v) for v in cells.values())
    print(f"\n{len(recs)} records: {n_ok} ok, {len(skipped)} skipped, "
          f"{len(failed)} failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
