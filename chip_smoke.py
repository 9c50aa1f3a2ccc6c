#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its seconds; any failed check raises, and the run
exits non-zero):

  1. device        — the card's name, and ``nvidia-smi``'s name and power
                     limit;
  2. build         — compiles every CUDA source of the port with nvcc
                     (one process per source, all at once) into
                     ``build/repro_torch/`` and prints ptxas' resource
                     report;
  3. characterize  — the 160-chip characterization of 365 d / 1000 P/E and
                     the attempt histograms of all six mechanisms, on the
                     card, held against the port's own CPU run;
  4. kernels       — the shard-core kernel against its plain torch version
                     on the same card tensors, bit for bit, on the padded
                     op tables of ``websearch`` at 20 000 requests
                     (``baseline`` serial and ``pr2ar2`` pipelined; FIFO,
                     and priority rings with aging bounds inf and 8) and
                     on one 48-lane table stacking all six mechanisms;
                     then the floor of one step's dependency chain
                     (a probe kernel of dependent f64 max and adds);
  5. main path     — ``compare_mechanisms`` over the six mechanisms at
                     20 000 requests with ``engine="batched"``; the kernel
                     must have launched, and ``baseline`` / ``pr2ar2`` must
                     equal the array interpreter's SimStats.  Every launch
                     the run made is then held against the plain version
                     on the inputs it had, bit for bit, and timed beside
                     its bounds: bytes or operations, and the serial
                     chain (longest lane's steps x the measured floor).

The line before the last is a JSON object describing each kernel
(launches on the main path, error against the plain version, and times
and bound summed over the main path's launches); the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CACHE = ROOT / "build" / "chip_smoke_cache"

WORKLOAD = "websearch"
N_REQUESTS = 20000
CONDITION = (365.0, 1000.0)
MECHANISMS = ("baseline", "sota", "pr2", "ar2", "pr2ar2", "sota+pr2ar2")
HIST_TOL = 1e-3          # L-inf, as in tests/test_torch_core.py
KERNEL_REPS = 5
CHAIN_PROBE_STEPS = 1 << 21
DEVICE = "cuda"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and dense
# float64 outside the tensor cores; the kernel's arithmetic is f64 adds
# and maxes.
HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[{name}] done in {time.perf_counter() - t0:.3f} s",
                  flush=True)
            return out
        return run
    return wrap


def _cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


@phase("device")
def device_phase():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} (count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)
    return name, smi


@phase("build")
def build_phase():
    from repro_torch.kernels import build

    libs = build.build_all(build.all_sources())
    for src, lib in libs.items():
        print(f"built {src.relative_to(ROOT)} -> {lib.relative_to(ROOT)}")
        for line in Path(f"{lib}.log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def _char_tables(device):
    """Characterize CONDITION and the histograms of all six mechanisms."""
    from repro_torch.core import characterize as TC
    from repro_torch.core.retry import RetryPolicy

    stats = TC.characterize_condition(*CONDITION, device=device)
    hists = {}
    for m in MECHANISMS:
        pol = RetryPolicy(m)
        scale = stats.safe_tr_scale if pol.adaptive_tr else 1.0
        for pt in ("lsb", "csb", "msb"):
            hists[(pt, pol.sota_start, scale)] = TC.attempt_histogram(
                *CONDITION, page_type=pt, sota=pol.sota_start,
                tr_scale=scale, device=device)
    return stats, hists


def _fresh_cache(name):
    """Point the characterization cache at a new, empty directory inside
    the checkout, so the next characterization computes every table."""
    from repro_torch.core import characterize as TC

    cache = CACHE / name
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_TORCH_CHAR_CACHE_DIR"] = str(cache)
    TC.clear_tables()


@phase("characterize")
def characterize_phase():
    import torch

    _fresh_cache("cpu")
    t0 = time.perf_counter()
    cpu_stats, cpu_hists = _char_tables("cpu")
    cpu_s = time.perf_counter() - t0
    _fresh_cache(DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, hists = _char_tables(DEVICE)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    if stats.safe_tr_scale != cpu_stats.safe_tr_scale:
        raise AssertionError(f"safe_tr_scale card {stats.safe_tr_scale} "
                             f"!= cpu {cpu_stats.safe_tr_scale}")
    if set(hists) != set(cpu_hists):
        raise AssertionError("histogram keys differ between card and cpu")
    err = max(float(abs(hists[k] - cpu_hists[k]).max()) for k in hists)
    if err > HIST_TOL:
        raise AssertionError(f"attempt histograms differ by {err} > "
                             f"{HIST_TOL} between card and cpu")
    print(f"characterization {CONDITION[0]:g} d / {CONDITION[1]:g} P/E, "
          f"160 chips, {len(hists)} histograms: card {card_s:.3f} s, "
          f"cpu {cpu_s:.3f} s, max |hist card - cpu| = {err:.3g}")
    print(f"safe_tr_scale = {stats.safe_tr_scale}, mean_retry_steps = "
          f"{stats.mean_retry_steps}, p99_retry_steps = "
          f"{stats.p99_retry_steps}")
    return dict(card_s=card_s, cpu_s=cpu_s, hist_err=err)


def _main_path_tables():
    """Padded op tables of the main path's cells (one per mechanism)."""
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.flashsim import DEFAULT_SSD, OperatingCondition
    from repro_torch.flashsim import engine_batched as EB
    from repro_torch.flashsim import ssd
    from repro_torch.kernels.fcfs_core import ops as K

    trace = ssd.resolve_trace(WORKLOAD, seed=0, n_requests=N_REQUESTS)
    expansion = ssd.expand_trace(trace, DEFAULT_SSD)
    tables = {}
    for m in MECHANISMS:
        sim = ssd.SSDSim(DEFAULT_SSD, OperatingCondition(*CONDITION),
                         RetryPolicy(m), seed=7, engine="batched",
                         device=DEVICE)
        prep = sim._prepare(trace, expansion=expansion)
        lanes, _, _ = EB._lane_tables(sim.cfg, prep.bufs)
        tables[m] = K.pad_ops(lanes)
    n_dies = -(-DEFAULT_SSD.n_dies // DEFAULT_SSD.n_channels)
    t = DEFAULT_SSD.timing
    return tables, n_dies, (t.tdma_us, t.tecc_us)


def _bound_ms(ops, fin, diestat, lane):
    """The two times that bound one launch's work on the card: the bytes
    it must move over the HBM rate, and the f64 operations this run's
    steps need over the f64 peak (milliseconds, in that order).

    Bytes: columns 0-6 of every real op row and the arrival of the pad
    row each lane stops on, the timing rows, one completion time per
    real op, and the die and lane outputs.  Operations: each retired
    step (an admission or an event) compares time and seq over the die
    slots and the ACQ head, compares with the admission, and does at
    most four f64 adds or maxes of its own.
    """
    L, _, _ = ops.shape
    n_dies = diestat.shape[1]
    real = ops[:, :, 1] != 3.0
    n_real = int(real.sum())
    n_bytes = 8 * (7 * n_real + L + 3 * L) + \
        8 * (n_real + diestat.numel() + lane.numel())
    n_steps = n_real + float(lane[:, 2].sum())
    n_ops = n_steps * (2 * (n_dies + 1) + 5)
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F64_OPS_PER_S * 1e3


def _bound(t_bytes, t_ops):
    """The least time (the larger of the two) and what sets it."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _longest_lane_steps(ops, lane):
    """Steps the longest lane of one launch retires (admissions plus
    events): the length of the serial chain that bounds the kernel."""
    real = (ops[:, :, 1] != 3.0).sum(dim=1).to(lane.dtype)
    return int((real + lane[:, 2]).max())


def _chain_ns_per_step(tdma, tecc):
    """Measured floor of one step's latency on the card: nanoseconds per
    link of the dependent f64 max-and-add chain a step carries to the
    next (``fcfs_chain_probe_launch`` in the kernel's source)."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.fcfs_core import ops as K

    fn = build.load(K._SOURCE).fcfs_chain_probe_launch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(2, dtype=torch.float64, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    n = CHAIN_PROBE_STEPS

    def run():
        if fn(n, tdma, tecc, out.data_ptr(), stream) != 0:
            raise RuntimeError("chain probe launch failed")

    run()
    ms, _ = _cuda_ms(run, 3)
    if not torch.isfinite(out).all():
        raise AssertionError("chain probe gave a non-finite result")
    return ms * 1e6 / n


def _hold(name, ops, timing, steps, kw, got=None):
    """Hold one launch of the kernel against its plain version on the
    same card tensors, bit for bit, and time both.

    ``got`` is a launch's output recorded on the main path; without it
    the kernel's own timed launches give the output compared."""
    import torch

    from repro_torch.kernels.fcfs_core import ops as K
    from repro_torch.kernels.fcfs_core.plain import fcfs_core_plain

    K.fcfs_core_fwd(ops, timing, steps, **kw)          # warm-up
    ms, again = _cuda_ms(lambda: K.fcfs_core_fwd(ops, timing, steps, **kw),
                         KERNEL_REPS)
    got = again if got is None else got
    plain_ms, want = _cuda_ms(
        lambda: fcfs_core_plain(ops, timing, steps, **kw), 1)
    err = max(float((g - w).abs().nan_to_num(float("inf")).max())
              for g, w in zip(got, want))
    if err != 0.0 or not all(torch.equal(g, w) and torch.equal(g, a)
                             for g, w, a in zip(got, want, again)):
        raise AssertionError(f"{name}: kernel differs from plain version "
                             f"(max abs {err})")
    t_bytes, t_ops = _bound_ms(ops, *got)
    bound_ms, bound_by = _bound(t_bytes, t_ops)
    longest = _longest_lane_steps(ops, got[2])
    print(f"{name}: lanes {ops.shape[0]} maxp {ops.shape[1]} steps {steps} "
          f"longest lane {longest} max_abs_err {err} kernel {ms:.3f} ms "
          f"({ms * 1e6 / longest:.1f} ns per step of the longest lane) "
          f"plain {plain_ms:.1f} ms bound {bound_ms:.6f} ms ({bound_by})",
          flush=True)
    return dict(case=name, steps=steps, longest=longest, ms=ms,
                plain_ms=plain_ms, t_bytes=t_bytes, t_ops=t_ops,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)


@phase("kernels")
def kernel_phase():
    import numpy as np
    import torch

    from repro_torch.kernels.fcfs_core import ops as K

    tables, n_dies, (tdma, tecc) = _main_path_tables()
    cases = []
    for m, pipelined in (("baseline", False), ("pr2ar2", True)):
        for label, bound in (("fifo", None), ("prio-inf", float("inf")),
                             ("prio-8", 8.0)):
            cases.append((f"{m}/{label}", tables[m], pipelined, bound))
    widest = max(t.shape[1] for t in tables.values())
    stacked = np.concatenate(
        [K.pad_ops([row[np.isfinite(row[:, 0])] for row in tables[m]],
                   maxp=widest) for m in MECHANISMS], axis=0)
    cases.append(("six-mechanisms-48-lanes/fifo", stacked, True, None))

    results = []
    for name, ops_np, pipelined, bound in cases:
        prio = bound is not None
        capq, capw = K.ring_caps(ops_np, n_dies)
        ops = torch.as_tensor(K.augment_ops(ops_np, pipelined),
                              dtype=torch.float64, device=DEVICE)
        timing = torch.tensor([[tdma, tecc, bound if prio else 0.0]]
                              * ops.shape[0], dtype=torch.float64,
                              device=DEVICE)
        kw = dict(n_dies=n_dies, capq=capq, capw=capw, pipelined=pipelined,
                  prio=prio)
        results.append(_hold(name, ops, timing, K.count_steps(ops_np), kw))
    chain_ns = _chain_ns_per_step(tdma, tecc)
    print(f"chain floor: {chain_ns:.3f} ns per step (dependent f64 max "
          f"and adds, {CHAIN_PROBE_STEPS} links)", flush=True)
    return results, chain_ns


def _outcome(s):
    import dataclasses

    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if f.compare}


@phase("main path")
def main_path_phase(chain_ns):
    import math

    import torch

    from repro_torch.flashsim import OperatingCondition, compare_mechanisms
    from repro_torch.kernels.fcfs_core import ops as K

    cond = OperatingCondition(*CONDITION)
    # Keep every launch's card inputs and outputs, to hold each against
    # the plain version once the main path's counts are read.
    recorded = []
    fwd = K.fcfs_core_fwd

    def recording_fwd(ops, timing, steps, **kw):
        out = fwd(ops, timing, steps, **kw)
        recorded.append((ops, timing, steps, kw, out))
        return out

    K.fcfs_core_fwd = recording_fwd
    K.launches = 0
    t0 = time.perf_counter()
    res = compare_mechanisms(WORKLOAD, cond, MECHANISMS,
                             n_requests=N_REQUESTS, engine="batched",
                             device=DEVICE)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    launches = K.launches
    K.fcfs_core_fwd = fwd
    if launches <= 0:
        raise AssertionError("compare_mechanisms(engine='batched') never "
                             "launched the fcfs_core kernel")
    if len(recorded) != launches:
        raise AssertionError(f"{len(recorded)} recorded calls for "
                             f"{launches} kernel launches")
    t0 = time.perf_counter()
    ref = compare_mechanisms(WORKLOAD, cond, ("baseline", "pr2ar2"),
                             n_requests=N_REQUESTS, engine="array",
                             device=DEVICE)
    array_s = time.perf_counter() - t0
    for m in ref:
        if _outcome(res[m]) != _outcome(ref[m]):
            raise AssertionError(f"{m}: batched SimStats differ from the "
                                 f"array interpreter's")
    for m, s in res.items():
        if s.n_requests != N_REQUESTS or not all(
                math.isfinite(v) for v in (s.mean_us, s.p99_us)):
            raise AssertionError(f"{m}: bad stats {s}")
        if s.fast_path_events <= 0:
            raise AssertionError(f"{m}: no events went through the kernel")
        print(f"{m:>12}: mean {s.mean_us:.3f} us  p99 {s.p99_us:.3f} us  "
              f"attempts {s.mean_read_attempts:.3f}  fused_cells "
              f"{s.fused_cells}")
    b, p = res["baseline"], res["pr2ar2"]
    red_mean = 1.0 - p.mean_us / b.mean_us
    red_p99 = 1.0 - p.p99_us / b.p99_us
    if not red_mean > 0.0:
        raise AssertionError("pr2ar2 is not faster than baseline")
    print(f"pr2ar2 vs baseline: mean -{red_mean:.2%}, p99 -{red_p99:.2%}")
    print(f"main path: batched {batched_s:.3f} s ({launches} kernel "
          f"launches), array interpreter for 2 mechanisms {array_s:.3f} s; "
          f"batched == array for baseline and pr2ar2", flush=True)

    held = []
    for i, (ops, timing, steps, kw, out) in enumerate(recorded):
        mode = "prio" if kw["prio"] else "fifo"
        r = _hold(f"main-path launch {i} ({mode}, pipelined="
                  f"{kw['pipelined']})", ops, timing, steps, kw, got=out)
        r["chain_ms"] = r["longest"] * chain_ns * 1e-6
        print(f"  chain bound {r['chain_ms']:.3f} ms = {r['longest']} steps "
              f"x {chain_ns:.3f} ns; kernel at "
              f"{r['ms'] / r['chain_ms']:.1f}x its chain bound", flush=True)
        held.append(r)
    return launches, held


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # Checkout-local characterization caches, fresh for each device, so
    # the card does its own work and nothing outside the checkout is
    # read or written.
    os.environ["REPRO_TORCH_CHAR_CACHE_DIR"] = str(CACHE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, _ = device_phase()
    build_phase()
    characterize_phase()
    kern, chain_ns = kernel_phase()
    launches, held = main_path_phase(chain_ns)

    # Times and bounds are sums over the main path's launches, each
    # re-run on the inputs it had there.
    bound_ms, bound_by = _bound(sum(r["t_bytes"] for r in held),
                                sum(r["t_ops"] for r in held))
    print(json.dumps({"kernels": [{
        "name": "fcfs_core",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fcfs_core/csrc/fcfs_core.cu",
        "replaces": "src/repro/kernels/fcfs_core/kernel.py:120",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kern + held),
        "ms": sum(r["ms"] for r in held),
        "plain_ms": sum(r["plain_ms"] for r in held),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
