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
  6. serve kernels — the flash-attention kernel against its plain dense
                     softmax on the full-width llama3.2-3b prefill shape
                     (B 4, T 2048, 24 heads over 8 KV heads, hd 128,
                     causal, bf16), a window + softcap case (hd 256) and
                     a kv_valid case, with ``scaled_dot_product_attention``
                     timed beside the causal case (bfloat16 outputs are
                     held element by element: one bfloat16 ulp of the
                     plain value plus 2^-8 of the row's rms), and two
                     faulty variants of the plain version on the causal
                     case (p rounded to bfloat16 before P.V, a dropped
                     key tile) that must fail that rule; the KV retry kernel
                     against its plain version on one full-width decode
                     leaf (28 x 4 x 8 x 2048 pages of 128 bf16 values);
  7. serve path    — ``ServeEngine`` on the card, first at a small width
                     held against the same engine on the CPU (equal
                     tokens and KV read stats), then llama3.2-3b at full
                     width with seeded weights: ``launch/serve.py``'s
                     request set (4 prompts of 4-11 tokens) and a long
                     set (4 prompts of 1024-2048 tokens), 16 new tokens
                     each, under pr2ar2 (tau 0.05) and baseline engines
                     sharing the weights.  The launch counts are set to 0
                     just before each run and read just after; both
                     kernels must have launched, pr2ar2 must serve some
                     pages fast and baseline none, and every logit must
                     be finite.  Every launch of each run is then held
                     against the plain version on the inputs it had, and
                     timed beside its bound.

The line before the last is a JSON object describing each kernel
(launches on its main path, error against the plain version, and times
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
# Dense bf16 tensor-core peak, and float32 outside the tensor cores.
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

SERVE_ARCH = "llama3.2-3b"
SERVE_TAU = 0.05
SERVE_MAX_NEW = 16
LONG_LENGTHS = (2048, 1024, 1536, 1792)
# Full-width llama3.2-3b prefill attention: B, T, heads, KV heads, hd.
PREFILL_SHAPE = (4, 2048, 24, 8, 128)
# The decode-leaf case's tolerance: at 0.02 a page of 128 values whose
# largest value dominates its rms retries and a Gaussian page does not
# (at 0.05 no page of 128 values can retry: the ratio is at most
# 0.5 * sqrt(128) / (127 * 0.05) = 0.89).
LEAF_TAU = 0.02
FA_F32_TOL = 1e-5
KV_MARGIN_RTOL = 1e-6


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


# -- serving: the flash-attention and KV retry kernels ----------------------


def _fa_bound_ms(q, k, v, out, kw):
    """Bytes (each input read once, the output written once) and the
    operations the visible (query, key) pairs need — 2 flops per
    element of q.k and of p.v — over the peak of the inputs' type, in
    milliseconds."""
    from repro_torch.kernels.flash_attention.plain import attention_mask

    BH, T, hd = q.shape
    S = k.shape[1]
    pairs = int(attention_mask(T, S, kw.get("causal", True), kw.get("window"),
                               kw.get("kv_valid"), q.device).sum())
    n_ops = 4.0 * BH * pairs * hd
    peak = BF16_OPS_PER_S if q.dtype.itemsize == 2 else F32_OPS_PER_S
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak * 1e3


def _sdpa_ms(q, k, v, kw, reps):
    """``scaled_dot_product_attention`` on the same inputs (kernel layout
    viewed as (BK, G, T, hd) queries over (BK, 1, S, hd) keys), or None
    where it does not compute the same function (softcap, window,
    kv_valid)."""
    import torch
    import torch.nn.functional as F

    if kw.get("softcap") is not None or kw.get("window") is not None \
            or kw.get("kv_valid") is not None:
        return None, None
    BH, T, hd = q.shape
    BK, S, _ = k.shape
    qq = q.view(BK, BH // BK, T, hd)
    kk, vv = k.view(BK, 1, S, hd), v.view(BK, 1, S, hd)

    def call():
        return F.scaled_dot_product_attention(
            qq, kk, vv, is_causal=kw.get("causal", True), enable_gqa=True)

    call()
    ms, out = _cuda_ms(call, reps)
    return ms, out.reshape(BH, T, hd)


def _hold_fa(name, q, k, v, kw, got=None, reps=3, library=True, quiet=False):
    """Hold one flash-attention launch against the plain version on the
    same card tensors and time kernel, plain version and library call."""
    import torch

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.plain import (
        bf16_err_ratio, flash_attention_plain)

    FA.flash_attention_fwd(q, k, v, **kw)                # warm-up
    ms, again = _cuda_ms(lambda: FA.flash_attention_fwd(q, k, v, **kw), reps)
    got = again if got is None else got
    plain_ms, want = _cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), 1)
    err = float((got.float() - want.float()).abs().max())
    # Worst |err| / tolerance: 1e-5 in float32; element by element in
    # bfloat16 (one ulp of the plain value plus 2^-8 of the row's rms).
    ratio = err / FA_F32_TOL if q.dtype.itemsize == 4 else \
        bf16_err_ratio(got, want)
    if not ratio <= 1.0 or not torch.equal(got, again):
        raise AssertionError(f"{name}: flash_attention differs from its plain "
                             f"version (max abs {err}, worst |err| / "
                             f"tolerance {ratio}) or is not deterministic")
    lib_ms, lib_out = _sdpa_ms(q, k, v, kw, reps) if library else (None, None)
    t_bytes, t_ops = _fa_bound_ms(q, k, v, got, kw)
    bound_ms, bound_by = _bound(t_bytes, t_ops)
    lib = "none" if lib_ms is None else (
        f"{lib_ms:.3f} ms (max abs vs plain "
        f"{float((lib_out.float() - want.float()).abs().max()):.3g})")
    if not quiet:
        print(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
              f"{kw} max_abs_err {err:.3g} (worst |err| / tolerance "
              f"{ratio:.3g}) kernel {ms:.3f} "
              f"ms plain {plain_ms:.3f} ms bound {bound_ms:.4f} ms "
              f"({bound_by}; kernel at {t_ops / ms * 100:.1f}% of the "
              f"operations bound) sdpa {lib}", flush=True)
    return dict(case=name, ms=ms, plain_ms=plain_ms, t_bytes=t_bytes,
                t_ops=t_ops, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, max_abs_err=err, tol_ratio=ratio)


def _check_controls(q, k, v):
    """The bfloat16 rule must reject both faulty variants on the causal
    prefill case; returns their worst |err| / tolerance."""
    from repro_torch.kernels.flash_attention.plain import (
        bf16_err_ratio, faulty_attention_plain, flash_attention_plain)

    want = flash_attention_plain(q, k, v, causal=True)
    out = {}
    for fault in ("p-bf16", "drop-tile"):
        out[fault] = bf16_err_ratio(faulty_attention_plain(q, k, v, fault),
                                    want)
        print(f"control {fault}: worst |err| / tolerance {out[fault]:.3g} "
              f"(must exceed 1)", flush=True)
        if not out[fault] > 1.0:
            raise AssertionError(f"the bfloat16 rule accepts the {fault} "
                                 f"control ({out[fault]})")
    return out


def _kv_bound_ms(data_q, scale, backing, out, margin):
    """Bytes the read must move — the int8 pages and scales, the output
    and margins, and the backing pages only of the pages that retry —
    and its float32 operations (dequant, square, sum: 3 a value, and 5 a
    page), in milliseconds."""
    P, E = data_q.shape
    retried = int((margin[:, 0] < 0).sum())
    n_bytes = (data_q.numel() + 4 * scale.numel() + 4 * margin.numel()
               + out.numel() * out.element_size()
               + retried * E * backing.element_size())
    n_ops = 3.0 * P * E + 5.0 * P
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3, \
        retried


def _hold_kv(name, data_q, scale, backing, tau, got=None, reps=3,
             quiet=False):
    """Hold one KV retry launch against the plain version on the same
    card tensors: margins within rtol 1e-6 of the larger of the margin
    and its ratio term, decisions counted (flips must be 0), outputs bit
    for bit where decisions agree."""
    import torch

    from repro_torch.kernels.kv_retry import ops as KV
    from repro_torch.kernels.kv_retry.plain import kv_retry_plain

    KV.kv_retry_fwd(data_q, scale, backing, tau)          # warm-up
    ms, again = _cuda_ms(lambda: KV.kv_retry_fwd(data_q, scale, backing, tau),
                         reps)
    out, margin = again if got is None else got
    plain_ms, (want, want_m) = _cuda_ms(
        lambda: kv_retry_plain(data_q, scale, backing, tau), 1)
    m, w = margin.double(), want_m.double()
    gap = float(((m - w).abs() / torch.maximum(w.abs(), (1 - w).abs())).max())
    fast = margin[:, 0] >= 0
    flips = int((fast != (want_m[:, 0] >= 0)).sum())
    agree = fast == (want_m[:, 0] >= 0)
    err = float((out[agree].float() - want[agree].float()).abs().max()) \
        if bool(agree.any()) else 0.0
    if gap > KV_MARGIN_RTOL or flips or err != 0.0 or not (
            torch.equal(out, again[0]) and torch.equal(margin, again[1])):
        raise AssertionError(f"{name}: kv_retry differs from its plain "
                             f"version: margin gap {gap:.3g}, {flips} "
                             f"flips, max abs {err}")
    t_bytes, t_ops, retried = _kv_bound_ms(data_q, scale, backing, out, margin)
    bound_ms, bound_by = _bound(t_bytes, t_ops)
    P, E = data_q.shape
    if not quiet:
        print(f"{name}: {P} pages of {E} {backing.dtype}, tau {tau}: "
              f"{P - retried} fast, {retried} retried; margin gap {gap:.3g} "
              f"(rtol {KV_MARGIN_RTOL}), 0 flips, max_abs_err {err} kernel "
              f"{ms:.3f} ms plain {plain_ms:.3f} ms bound {bound_ms:.4f} ms "
              f"({bound_by}; kernel at {t_bytes / ms * 100:.1f}% of the "
              f"bytes bound)", flush=True)
    return dict(case=name, ms=ms, plain_ms=plain_ms, t_bytes=t_bytes,
                t_ops=t_ops, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, pages=P, retried=retried,
                moved=t_bytes * HBM_BYTES_PER_S * 1e-3,
                leaf=backing.numel() * backing.element_size())


@phase("serve kernels")
def serve_kernel_phase():
    import torch

    from repro_torch.kernels.kv_retry.plain import quantize_pages

    gen = torch.Generator(DEVICE).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=DEVICE)
                ).to(torch.bfloat16)

    B, T, H, K, hd = PREFILL_SHAPE
    cases = [
        ("llama prefill, causal", (B * H, B * K, T, hd),
         dict(causal=True)),
        (f"window {T // 4} + softcap 50, hd 256", (B * 8, B * 4, T, 256),
         dict(causal=True, window=T // 4, softcap=50.0)),
        (f"kv_valid {T * 3 // 4 - 36}, non-causal", (B * H, B * K, T, hd),
         dict(causal=False, kv_valid=T * 3 // 4 - 36)),
    ]
    fa, controls = [], None
    for name, (bh, bk, t, d), kw in cases:
        q, k, v = randn(bh, t, d), randn(bk, t, d), randn(bk, t, d)
        fa.append(_hold_fa(name, q, k, v, kw))
        if controls is None:
            controls = _check_controls(q, k, v)
        del q, k, v
    torch.cuda.empty_cache()

    # One full-width decode leaf: (U, B, K, S, hd) pages; about a third
    # of the pages carry one large value, so that they retry.
    P = 28 * B * K * T
    backing = randn(P, hd)
    spiky = torch.rand(P, generator=gen, device=DEVICE) < 0.3
    col = torch.randint(0, hd, (P,), generator=gen, device=DEVICE)
    backing[spiky, col[spiky]] *= 40.0
    data_q, scale = quantize_pages(backing)
    kv = [_hold_kv(f"decode leaf (28, {B}, {K}, {T}, {hd})", data_q, scale,
                   backing, LEAF_TAU)]
    del backing, data_q, scale
    torch.cuda.empty_cache()
    return fa, kv, controls


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _small_width_check():
    """The serve path on the card against itself on the CPU (where the
    kernels run their plain versions), at a small width with head dim 64
    (what the flash-attention kernel takes), in float32, with the same
    weights: prefill and two decode steps' logits within 1e-4 of the
    largest, and the served tokens and KV read stats of 8 new tokens
    compared (at least 90% of the tokens equal)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.launch.serve import default_prompts
    from repro_torch.serving import ServeEngine

    for arch in ("llama3.2-3b", "gemma2-2b"):
        cfg = dataclasses.replace(reduced_config(get_config(arch)),
                                  head_dim=64, activation_dtype="float32")
        # Prompts up to 40 tokens: past gemma2's reduced window of 32.
        rng = np.random.default_rng(5)
        prompts = default_prompts(cfg.vocab, 4)[:2] + [
            rng.integers(2, cfg.vocab, size=n).astype(np.int32)
            for n in (40, 33)]
        card = ServeEngine(cfg, policy=RetryPolicy("pr2ar2"), tau=0.01,
                           seed=0, device=DEVICE)
        cpu = ServeEngine(cfg, params=_tree_to(card.params, "cpu"),
                          policy=RetryPolicy("pr2ar2"), tau=0.01,
                          device="cpu")
        toks = torch.as_tensor(card._pad_batch(prompts))
        gap = 0.0
        with torch.inference_mode():
            outs = [(e.model.prefill(e.params, {"tokens": toks.to(e.device)}))
                    for e in (card, cpu)]
            for step in range(3):
                (lc, cc), (lp, cp) = outs
                lc = lc.cpu()
                if not bool(torch.isfinite(lc).all()):
                    raise AssertionError(f"{arch}: non-finite logits")
                gap = max(gap, float((lc - lp).abs().max() / lp.abs().max()))
                if step == 2:
                    break
                tok = lp[:, -1].argmax(-1)[:, None]
                outs = [e.model.decode_step(e.params, {
                    "token": tok.to(e.device), "pos": toks.shape[1] + step,
                    "cache": c}) for e, c in ((card, cc), (cpu, cp))]
        if gap > 1e-4:
            raise AssertionError(f"{arch} small width: card logits differ "
                                 f"from the CPU's by {gap:.3g} of the largest")
        g_card, s_card = card.generate(prompts, max_new_tokens=8)
        g_cpu, s_cpu = cpu.generate(prompts, max_new_tokens=8)
        agree = float((g_card == g_cpu).mean())
        print(f"small-width {arch} (hd 64, float32, tau 0.01): logits gap "
              f"{gap:.3g} of the largest (prefill, 2 decode steps); served "
              f"tokens card == cpu {agree:.4f}; kv_fast card "
              f"{100 * s_card.kv.fast_fraction:.2f}% cpu "
              f"{100 * s_cpu.kv.fast_fraction:.2f}% of {s_card.kv.pages} "
              f"pages", flush=True)
        if agree < 0.9 or s_card.kv.pages != s_cpu.kv.pages:
            raise AssertionError(f"{arch} small width: served tokens "
                                 f"{g_card.tolist()} vs {g_cpu.tolist()}")


def _request_sets(vocab):
    import numpy as np

    from repro_torch.launch.serve import default_prompts

    rng = np.random.default_rng(1)
    long = [rng.integers(2, vocab, size=n).astype(np.int32)
            for n in LONG_LENGTHS]
    return (("short", default_prompts(vocab, 4)), ("long", long))


@phase("serve path")
def serve_path_phase():
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.retry import RetryPolicy
    from repro_torch.kernels.fcfs_core import ops as B1
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.kv_retry import ops as KV
    from repro_torch.serving import KVReadStats, ServeEngine

    _small_width_check()

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, policy=RetryPolicy("pr2ar2"), tau=SERVE_TAU,
                      seed=0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"{SERVE_ARCH}: {n_params} seeded float32 parameters on the card "
          f"in {time.perf_counter() - t0:.3f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    engines = {"pr2ar2": eng,
               "baseline": ServeEngine(cfg, params=eng.params,
                                       policy=RetryPolicy("baseline"),
                                       tau=SERVE_TAU, device=DEVICE)}
    finite = []

    def checked(fn):
        def run(params, batch):
            logits, cache = fn(params, batch)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return run

    for e in engines.values():
        e.model = dataclasses.replace(
            e.model, prefill=checked(e.model.prefill),
            decode_step=checked(e.model.decode_step))
    sets = _request_sets(cfg.vocab)
    for e in engines.values():            # warm-up: library loads, cuBLAS
        e.generate(sets[0][1], max_new_tokens=2)

    rec_fa, rec_kv = [], []
    fa_fwd, kv_fwd = FA.flash_attention_fwd, KV.kv_retry_fwd

    def recording_fa(q, k, v, **kw):
        out = fa_fwd(q, k, v, **kw)
        rec_fa.append((q, k, v, kw, out))
        return out

    def recording_kv(data_q, scale, backing, tau=0.02):
        out = kv_fwd(data_q, scale, backing, tau)
        rec_kv.append((data_q, scale, backing, tau, out))
        return out

    runs, held_fa, held_kv = {}, [], []
    launches = {"fcfs_core": 0, "flash_attention": 0, "kv_retry": 0}
    FA.flash_attention_fwd, KV.kv_retry_fwd = recording_fa, recording_kv
    try:
        for set_name, prompts in sets:
            for mech, e in engines.items():
                e.store.stats = KVReadStats()
                finite.clear()
                B1.launches = FA.launches = KV.launches = 0
                gen, st = e.generate(prompts, max_new_tokens=SERVE_MAX_NEW)
                counts = {"fcfs_core": B1.launches,
                          "flash_attention": FA.launches,
                          "kv_retry": KV.launches}
                if len(rec_fa) != counts["flash_attention"] or \
                        len(rec_kv) != counts["kv_retry"]:
                    raise AssertionError(f"{set_name}/{mech}: recorded "
                                         f"calls != launches {counts}")
                if not bool(torch.stack(finite).all()):
                    raise AssertionError(f"{set_name}/{mech}: non-finite "
                                         f"logits")
                for name, n in counts.items():
                    launches[name] += n
                runs[(set_name, mech)] = (gen, st)
                print(f"{set_name:>5} {mech:>8}: {st.summary()}; launches "
                      f"{counts}", flush=True)
                # Hold this run's launches on the inputs they had, then
                # let them go (a long run keeps ~40 GB of KV pages).
                FA.flash_attention_fwd, KV.kv_retry_fwd = fa_fwd, kv_fwd
                fa_run = [_hold_fa(f"{set_name}/{mech} launch {i}", q, k, v,
                                   kw, got=out, quiet=True)
                          for i, (q, k, v, kw, out) in enumerate(rec_fa)]
                kv_run = [_hold_kv(f"{set_name}/{mech} launch {i}", dq, sc,
                                   bk, tau, got=out, quiet=True)
                          for i, (dq, sc, bk, tau, out) in enumerate(rec_kv)]
                for kname, rs in (("flash_attention", fa_run),
                                  ("kv_retry", kv_run)):
                    if rs:
                        _print_held(f"  {set_name}/{mech} {kname}", rs)
                held_fa += fa_run
                held_kv += kv_run
                FA.flash_attention_fwd = recording_fa
                KV.kv_retry_fwd = recording_kv
                rec_fa.clear()
                rec_kv.clear()
                torch.cuda.empty_cache()
    finally:
        FA.flash_attention_fwd, KV.kv_retry_fwd = fa_fwd, kv_fwd

    for name in ("flash_attention", "kv_retry"):
        if launches[name] <= 0:
            raise AssertionError(f"the serve path never launched {name}")
    for set_name, _ in sets:
        p_gen, p_st = runs[(set_name, "pr2ar2")]
        b_gen, b_st = runs[(set_name, "baseline")]
        if not p_st.kv.fast_fraction > 0 or b_st.kv.fast_fraction != 0:
            raise AssertionError(f"{set_name}: kv_fast pr2ar2 "
                                 f"{p_st.kv.fast_fraction}, baseline "
                                 f"{b_st.kv.fast_fraction}")
        agree = float((p_gen == b_gen).mean())
        print(f"{set_name}: pr2ar2/baseline token agreement {agree:.4f} "
              f"({int((p_gen == b_gen).sum())} of {p_gen.size})")
    return launches, held_fa, held_kv, runs


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _print_held(name, rs):
    """One line for the launches of one run, held and re-timed."""
    bound_ms, bound_by = _bound(sum(r["t_bytes"] for r in rs),
                                sum(r["t_ops"] for r in rs))
    lib = [r.get("library_ms") for r in rs]
    if "pages" in rs[0]:
        extra = (f", {sum(r['retried'] for r in rs)} of "
                 f"{sum(r['pages'] for r in rs)} pages retried, "
                 f"{sum(r['moved'] for r in rs) / 1e9:.3f} GB moved (int8 "
                 f"pages, scales, margins, output, retried backing) for "
                 f"{sum(r['leaf'] for r in rs) / 1e9:.3f} GB of backing "
                 f"leaves")
    else:
        extra = (f", worst |err| / tolerance "
                 f"{max(r['tol_ratio'] for r in rs):.3g}")
    print(f"{name}: {len(rs)} launches held{extra}, max_abs_err "
          f"{max(r['max_abs_err'] for r in rs):.3g}; kernel "
          f"{sum(r['ms'] for r in rs):.3f} ms (largest launch "
          f"{max(r['ms'] for r in rs):.3f}), plain "
          f"{sum(r['plain_ms'] for r in rs):.3f} ms, sdpa "
          f"{'none' if None in lib else f'{sum(lib):.3f} ms'}, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)


def _kernel_line(name, source, replaces, launches, cases, held, library):
    """One kernel's entry of the JSON line: times, bound and library time
    summed over the main path's launches, each re-run on its inputs."""
    bound_ms, bound_by = _bound(sum(r["t_bytes"] for r in held),
                                sum(r["t_ops"] for r in held))
    lib = [r.get("library_ms") for r in held]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in cases + held),
        "ms": sum(r["ms"] for r in held),
        "plain_ms": sum(r["plain_ms"] for r in held),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": sum(lib) if library and None not in lib else None,
    }


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
    torch.cuda.empty_cache()
    fa_cases, kv_cases, _ = serve_kernel_phase()
    serve_launches, held_fa, held_kv, _ = serve_path_phase()

    # Times and bounds are sums over each main path's launches, each
    # re-run on the inputs it had there.
    kernels = "src/repro_torch/kernels"
    print(json.dumps({"kernels": [
        _kernel_line("fcfs_core", f"{kernels}/fcfs_core/csrc/fcfs_core.cu",
                     "src/repro/kernels/fcfs_core/kernel.py:120", launches,
                     kern, held, library=False),
        _kernel_line("flash_attention",
                     f"{kernels}/flash_attention/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention/kernel.py:34",
                     serve_launches["flash_attention"], fa_cases, held_fa,
                     library=True),
        _kernel_line("kv_retry", f"{kernels}/kv_retry/csrc/kv_retry.cu",
                     "src/repro/kernels/kv_retry/kernel.py:26",
                     serve_launches["kv_retry"], kv_cases, held_kv,
                     library=False),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
