#!/usr/bin/env python3
"""The shard-core kernel's time on the main path and on wide channels.

Times with CUDA events (a warm-up, then ``--reps`` launches) the one
launch of the main path (``compare_mechanisms`` over
the six mechanisms, ``websearch`` at 20 000 requests, 365 d / 1000 P/E,
``engine="batched"``: 48 lanes of 8 dies) and the launches of the same
cell on channels of ``--wide`` dies (``engine="auto"``), each beside the
longest lane's steps and its nanoseconds a step, two ways: through the
wrapper as the program calls it (its row check reads the device back,
so each launch waits for the last and the host's preparation shows
between launches), and queued (the row check run once, then left out,
so launches follow one another on the card: the kernel's own time).
With ``--against DIR`` (another checkout, e.g. the parent unpacked
with ``git archive`` into a gitignored directory such as
``build/parent``) the main-path launch is timed in ``--rounds`` turns of
other / this / this / other, each in a process of its own on that
tree's sources and kernel build, so both run on one card in one call.
Needs a CUDA card.  Run from the root of a checkout:

    PYTHONPATH=src python tools/fcfs_wide.py [--against build/parent]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MECHANISMS = ("baseline", "sota", "pr2", "ar2", "pr2ar2", "sota+pr2ar2")


def _record(dies, engine):
    """(ops, timing, steps, kw) of every launch of the cell."""
    import dataclasses

    from repro_torch.flashsim import (DEFAULT_SSD, OperatingCondition,
                                      compare_mechanisms)
    from repro_torch.kernels.fcfs_core import ops as K

    cfg = DEFAULT_SSD if dies is None else dataclasses.replace(
        DEFAULT_SSD, dies_per_channel=dies)
    recorded, fwd = [], K.fcfs_core_fwd

    def recording(ops, timing, steps, **kw):
        recorded.append((ops, timing, steps, kw))
        return fwd(ops, timing, steps, **kw)

    K.fcfs_core_fwd = recording
    try:
        res = compare_mechanisms(
            "websearch", OperatingCondition(365.0, 1000.0), MECHANISMS,
            cfg=cfg, n_requests=20000, engine=engine, device="cuda")
    finally:
        K.fcfs_core_fwd = fwd
    for m, st in res.items():
        if st.engine_selected != "batched":
            raise AssertionError(f"{dies} dies, {m}: {st.engine_selected} "
                                 f"({st.engine_fallback_reason})")
    return recorded


def _events_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time(ops, timing, steps, kw, reps):
    from repro_torch.kernels.fcfs_core import ops as K

    out = K.fcfs_core_fwd(ops, timing, steps, **kw)         # warm-up
    run = lambda: K.fcfs_core_fwd(ops, timing, steps, **kw)  # noqa: E731
    ms = _events_ms(run, reps)
    check = K._check_ops                    # rows checked by the warm-up
    K._check_ops = lambda *a, **k: None
    try:
        run()
        queued = _events_ms(run, reps)
    finally:
        K._check_ops = check
    real = (ops[:, :, 1] != 3.0).sum(dim=1).to(out[2].dtype)
    longest = int((real + out[2][:, 2]).max())
    return dict(lanes=ops.shape[0], n_dies=kw["n_dies"], capq=kw["capq"],
                longest=longest, ms=ms, queued_ms=queued,
                ns_per_step=queued * 1e6 / longest)


def child(wide, reps):
    """One process's measurements, printed as one JSON line."""
    rows = []
    for dies in [None] + wide:
        for i, (ops, timing, steps, kw) in enumerate(
                _record(dies, "batched" if dies is None else "auto")):
            rows.append(dict(cell="main" if dies is None else f"{dies} dies",
                             launch=i, **_time(ops, timing, steps, kw, reps)))
    print(json.dumps(rows), flush=True)


def _run(tree, wide, reps):
    env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve() / "src"))
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         "--reps", str(reps), "--wide", ",".join(map(str, wide))],
        env=env, cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: {out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout to time in turns")
    ap.add_argument("--wide", default="32,64,100",
                    help="dies a channel of the wide cells (comma list)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1,
                    help="turns of other / this / this / other")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    wide = [int(x) for x in a.wide.split(",") if x]
    if a.child:
        child(wide, a.reps)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fcfs_wide: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    turns = [(ROOT, wide)] if not a.against else [(ROOT, wide)] + [
        (Path(a.against), []), (ROOT, []), (ROOT, []),
        (Path(a.against), [])] * a.rounds
    for tree, w in turns:
        for r in _run(tree, w, a.reps):
            print(f"{tree}: {r['cell']} launch {r['launch']}: {r['lanes']} "
                  f"lanes of {r['n_dies']} dies (capq {r['capq']}), "
                  f"{r['ms']:.3f} ms through the wrapper, "
                  f"{r['queued_ms']:.3f} ms queued, longest lane "
                  f"{r['longest']} steps, {r['ns_per_step']:.1f} ns a step "
                  f"queued", flush=True)


if __name__ == "__main__":
    main()
