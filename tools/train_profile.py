#!/usr/bin/env python3
"""How ``torch.profiler`` sees a training step of llama3.2-3b on a CUDA card.

Builds the full-depth llama3.2-3b training state on the card (as
``chip_smoke.py``'s train phase does: batch 2 x 1024, deterministic
algorithms), takes two steps through ``train()``, then profiles
three steps, each in a fresh ``torch.profiler`` session with the step and its
synchronize inside a ``record_function`` window.  For each step it
prints the host wall time, the window as the profiler's clock gives it,
the device events by kind (user annotations apart from kernels, copies
and sets), the union of the device intervals with and without the
annotations, the device events that lie outside the window, and the
device span a pair of CUDA events measures around the same step.  Run
from the root of a checkout:

    PYTHONPATH=src python tools/train_profile.py
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.launch import train as TL
from repro_torch.optim.adamw import AdamWConfig

WINDOW = "train_profile.window"


def _union(spans):
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def _kind(ev) -> str:
    if getattr(ev, "is_user_annotation", False):
        return "user annotation"
    return str(getattr(ev, "activity_type", None) or "device")


def profile_step(fn):
    """Profile ``fn()`` once; a dict of what the profiler saw."""
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    win = [ev for ev in prof.events() if ev.name == WINDOW
           and ev.device_type == torch.autograd.DeviceType.CPU]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    kinds = {}
    for ev in dev:
        n, us = kinds.get(_kind(ev), (0, 0.0))
        kinds[_kind(ev)] = (n + 1, us + ev.time_range.elapsed_us())
    spans = [(ev.time_range.start, ev.time_range.end) for ev in dev]
    work = [(ev.time_range.start, ev.time_range.end) for ev in dev
            if _kind(ev) != "user annotation"]
    out = [ev for ev in dev if ev.time_range.start < w0
           or ev.time_range.end > w1]
    out_names = {}
    for ev in out:
        out_names[(_kind(ev), ev.name[:50])] = \
            out_names.get((_kind(ev), ev.name[:50]), 0) + 1
    dup = len(spans) - len({(ev.name, ev.time_range.start,
                             ev.time_range.end) for ev in dev})
    return dict(
        wall_s=wall, window_s=(w1 - w0) / 1e6,
        cuda_events_s=e0.elapsed_time(e1) / 1e3,
        n_device=len(dev), kinds=kinds,
        busy_all_s=_union(spans) / 1e6, busy_work_s=_union(work) / 1e6,
        sum_work_s=sum(b - a for a, b in work) / 1e6,
        first_rel_ms=(min(a for a, _ in spans) - w0) / 1e3 if spans else None,
        last_rel_ms=(max(b for _, b in spans) - w1) / 1e3 if spans else None,
        n_outside=len(out), outside=sorted(out_names.items(),
                                           key=lambda kv: -kv[1])[:8],
        duplicates=dup)


def main():
    import os
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{smi.strip()} | torch {torch.__version__}", flush=True)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    cfg = get_config("llama3.2-3b")
    opt = AdamWConfig(lr=2e-5, moment_dtype=cfg.moment_dtype)
    t0 = time.perf_counter()
    run = TL.train(cfg, steps=2, batch=2, seq=1024, device="cuda", opt=opt,
                   log=lambda *_: None)
    print(f"{cfg.n_layers} layers: two unprofiled steps through "
          f"train() in {time.perf_counter() - t0:.3f} s, "
          f"step_s {run.step_s}", flush=True)
    loss_fn = TL.build_model(cfg, "cuda").train_loss

    def step(i):
        b = {k: torch.from_numpy(v).to("cuda")
             for k, v in run.reader.corpus.batch(i).items()}
        return lambda: TL.train_step(loss_fn, run.state, b, opt, 0.1)

    for i in range(1, 4):
        r = profile_step(step(i))
        print(f"profiled step {i}: " + ", ".join(
            f"{k} {v!r}" for k, v in r.items()), flush=True)


if __name__ == "__main__":
    main()
