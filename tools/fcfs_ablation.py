#!/usr/bin/env python3
"""Where the shard-core kernel's step time goes, by ablation.

Records the one launch of the main path (``compare_mechanisms`` over the
six mechanisms, ``websearch`` at 20 000 requests, 365 d / 1000 P/E,
``engine="batched"``: 48 lanes, serial and pipelined) and re-runs its
inputs through the four placements the kernel
(``src/repro_torch/kernels/fcfs_core/csrc/fcfs_core.cu``) is built with:
op table and rings both in shared memory (what the wrapper launches),
only the op table, only the rings, and neither.  A copy of the source
with the event choice written as one compare after another (the scan
of the first port) in place of the tree runs at the first placement.
Every run must give the wrapper's output bit for bit.  Each is timed
with CUDA events in two rounds, the second in reverse order.  Then a
copy with ``clock64`` probes splits the longest lane's cycles between
the event choice and the four kinds of step (admission, write landing,
sense, release); the probes cost time of their own, so only the shares
mean much.  Last, the longest lane alone in one launch, and the floor
of one step's dependency chain.  With ``--wide DIES`` it then records
the same cell on channels of those dies (``engine="auto"``) and times
the event choice of the 32- and 64-slot instances three ways, each
bit for bit the wrapper's output: across warp 0 (what the wrapper
launches), as one register tree over all the slots in thread 0, and as
register trees over blocks of 16 slots combined in slot order.  Needs a
CUDA card.  Run from the root of a checkout:

    PYTHONPATH=src python tools/fcfs_ablation.py [--wide 32,64]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.fcfs_core import ops as K

REPS = 3
PLACEMENTS = {3: "op table and rings in shared memory",
              1: "op table in shared memory, rings in global",
              2: "rings in shared memory, op table in global",
              0: "op table and rings in global memory"}

_TREE_START = "      // candidate: least (time, seq) over the die slots, by a tree"
_TREE_END = "      if (!retire(tt[0], qq[0], ww[0])) break;\n"
_SCAN = """      // candidate: least (time, seq) over the die slots, one by one
      double tmin = inf, smin = inf;
      int widx = -1;
#pragma unroll 4
      for (int d = 0; d < n_dies; ++d) {
        const double t = s.ev_t[d], q = s.ev_seq[d];
        if (t < tmin || (t == tmin && q < smin)) {
          tmin = t;
          smin = q;
          widx = d;
        }
      }
      if (!retire(tmin, smin, widx)) break;
"""
# clock64 probes: pc[0] the event choice, pc[1..4] admission, landing,
# sense and release, pc[5..8] their counts.
_PROBES = [
    ("template <int kBytes>\n",
     "__device__ long long g_prof[4096 * 9];\n\ntemplate <int kBytes>\n"),
    ("  // Retires one step, given",
     "  long long pc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long c0 = 0, c1 = 0;\n  // Retires one step, given"),
    ("  for (long long step = 0; step < steps; ++step) {\n",
     "  for (long long step = 0; step < steps; ++step) {\n"
     "    c0 = clock64();\n"),
    ("    if (adm_t == inf && tmin == inf) return false;",
     "    c1 = clock64();\n    pc[0] += c1 - c0;\n"
     "    if (adm_t == inf && tmin == inf) return false;"),
    ("        take_die(o, p, tm);\n      }\n      return true;",
     "        take_die(o, p, tm);\n      }\n"
     "      pc[1] += clock64() - c1;\n      pc[5] += 1;\n      return true;"),
    ("      take_die(o, pk[o], tm);\n      return true;",
     "      take_die(o, pk[o], tm);\n"
     "      pc[2] += clock64() - c1;\n      pc[6] += 1;\n      return true;"),
    ("      s.ev_seq[d] = seqc;\n      seqc += 1.0;\n    } else {",
     "      s.ev_seq[d] = seqc;\n      seqc += 1.0;\n"
     "      pc[3] += clock64() - c1;\n      pc[7] += 1;\n    } else {"),
    ("        s.is_free[d] = 1;\n        s.ev_t[d] = inf;\n      }\n    }\n"
     "    return true;\n",
     "        s.is_free[d] = 1;\n        s.ev_t[d] = inf;\n      }\n"
     "      pc[4] += clock64() - c1;\n      pc[8] += 1;\n    }\n"
     "    return true;\n"),
    ("  for (int d = tid; d < n_dies; d += kRunners) {\n    diestat",
     "  if (tid == 0 && blockIdx.x < 4096) {\n"
     "    for (int k = 0; k < 9; ++k) g_prof[blockIdx.x * 9 + k] = pc[k];\n"
     "  }\n"
     "  for (int d = tid; d < n_dies; d += kRunners) {\n    diestat"),
]
_WARP = "  constexpr bool kWarp = kSlots == 0 || kSlots > 16;\n"
_TREE_ONLY = "  constexpr bool kWarp = kSlots == 0;\n"
_BLOCKS = """      // candidate: blocks of up to 16 slots, each by a tree of adjacent
      // pairs, combined in slot order
      constexpr int kB = kSlots < 16 ? kSlots : 16;
      double tmin = inf, smin = inf;
      int widx = 0;
#pragma unroll
      for (int b = 0; b < kSlots; b += kB) {
        double tt[kB], qq[kB];
        int ww[kB];
#pragma unroll
        for (int d = 0; d < kB; ++d) {
          tt[d] = s.ev_t[b + d];
          qq[d] = s.ev_seq[b + d];
          ww[d] = b + d;
        }
#pragma unroll
        for (int h = 1; h < kB; h *= 2) {
#pragma unroll
          for (int d = 0; d < kB; d += 2 * h) {
            const bool right = (tt[d + h] < tt[d]) |
                               ((tt[d + h] == tt[d]) & (qq[d + h] < qq[d]));
            if (right) {
              tt[d] = tt[d + h];
              qq[d] = qq[d + h];
              ww[d] = ww[d + h];
            }
          }
        }
        if ((b == 0) | (tt[0] < tmin) | ((tt[0] == tmin) & (qq[0] < smin))) {
          tmin = tt[0];
          smin = qq[0];
          widx = ww[0];
        }
      }
      if (!retire(tmin, smin, widx)) break;
"""
_PROF_READ = """
extern "C" int fcfs_prof_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 9 * n);
}
"""


def _sub(text, pairs):
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"{old!r} not in the source")
        text = text.replace(old, new)
    return text


def _variant_sources():
    """The scan, probed, one-tree and blocks-of-16 copies of the source,
    under build/."""
    text = K._SOURCE.read_text()
    i, j = text.index(_TREE_START), text.index(_TREE_END)
    out_dir = build.build_dir().parent / "fcfs_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    scan = out_dir / "fcfs_scan.cu"
    scan.write_text(text[:i] + _SCAN + text[j + len(_TREE_END):])
    probed = out_dir / "fcfs_probed.cu"
    probed.write_text(_sub(text, _PROBES) + _PROF_READ)
    tree = out_dir / "fcfs_tree.cu"
    tree.write_text(_sub(text, [(_WARP, _TREE_ONLY)]))
    blocks = out_dir / "fcfs_blocks.cu"
    blocks.write_text(_sub(text[:i] + _BLOCKS + text[j + len(_TREE_END):],
                           [(_WARP, _TREE_ONLY)]))
    return scan, probed, tree, blocks


def _record_main_path(dies=None):
    """The main path's launches, on channels of ``dies`` dies if given
    (``engine="auto"``): (ops, timing, steps, kw, out) each."""
    import dataclasses

    from repro_torch.flashsim import (DEFAULT_SSD, OperatingCondition,
                                      compare_mechanisms)

    cfg = DEFAULT_SSD if dies is None else dataclasses.replace(
        DEFAULT_SSD, dies_per_channel=dies)
    recorded = []
    fwd = K.fcfs_core_fwd

    def recording(ops, timing, steps, **kw):
        out = fwd(ops, timing, steps, **kw)
        recorded.append((ops, timing, steps, kw, out))
        return out

    K.fcfs_core_fwd = recording
    try:
        compare_mechanisms("websearch", OperatingCondition(365.0, 1000.0),
                           cfg=cfg, n_requests=20000,
                           engine="batched" if dies is None else "auto",
                           device="cuda")
    finally:
        K.fcfs_core_fwd = fwd
    torch.cuda.synchronize()
    return recorded


def _launcher(lib, ops, timing, steps, kw):
    """A function launching ``lib``'s kernel at one placement on these
    inputs (all lanes, or the ``lanes`` slice), returning its outputs."""
    f = lib.fcfs_core_launch
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, ll, ci, ci, ci, ci, vp,
                  vp, vp, vp, vp, vp, vp]
    f.restype = ci
    arr, gdt, pk, die = K.pack_ops(ops, kw["n_dies"])
    L, maxp, _ = ops.shape
    nd, capq, capw, prio = kw["n_dies"], kw["capq"], kw["capw"], kw["prio"]
    dev = ops.device
    fifo = torch.empty((L, nd, capq * (2 if prio else 1)), dtype=torch.int32,
                       device=dev)
    acq = torch.empty((L, capw, 3), dtype=torch.float64, device=dev)
    dies = torch.empty((L, K.DIE_BYTES // 8 * nd), dtype=torch.float64,
                       device=dev)

    def launch(place, lanes=slice(None)):
        a, g, p, dk, tim = (x[lanes].contiguous()
                            for x in (arr, gdt, pk, die, timing))
        n = a.shape[0]
        fin = torch.zeros((n, maxp + 1), dtype=torch.float64, device=dev)
        diestat = torch.empty((n, nd, 2), dtype=torch.float64, device=dev)
        lane = torch.empty((n, 4), dtype=torch.float64, device=dev)
        err = f(a.data_ptr(), g.data_ptr(), p.data_ptr(), dk.data_ptr(), n,
                maxp, nd, tim.data_ptr(), steps, capq, capw, int(prio), place,
                fifo.data_ptr(), acq.data_ptr(), dies.data_ptr(), fin.data_ptr(),
                diestat.data_ptr(), lane.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"placement {place}: CUDA error {err}")
        return fin, diestat, lane
    return launch


def _ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(REPS):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS, out


def _chain_ns(tdma, tecc, n=1 << 21):
    fn = build.load(K._SOURCE).fcfs_chain_probe_launch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(2, dtype=torch.float64, device="cuda")
    ms, _ = _ms(lambda: fn(n, tdma, tecc, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream))
    return ms * 1e6 / n


def _profile(lib, launch, out, lane, steps_of_lane, ms):
    """The probed copy's cycle split of one lane."""
    got = launch(3)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, out)):
        raise AssertionError("the probed copy differs from the wrapper")
    n = out[0].shape[0]
    buf = (ctypes.c_longlong * (9 * n))()
    lib.fcfs_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.fcfs_prof_read(buf, n) != 0:
        raise RuntimeError("reading the probes failed")
    pc = np.array(buf[:], dtype=np.int64).reshape(n, 9)[lane]
    total = int(pc[:5].sum())
    names = ("event choice", "admission", "write landing", "sense",
             "release")
    parts = [f"{names[0]} {pc[0] / steps_of_lane:.1f} a step "
             f"({pc[0] / total:.1%})"]
    for k in range(1, 5):
        parts.append(f"{names[k]} x{pc[4 + k]} {pc[k] / max(pc[4 + k], 1):.1f}"
                     f" each ({pc[k] / total:.1%})")
    print(f"  probed copy, longest lane: {total / steps_of_lane:.1f} cycles a "
          f"step: " + ", ".join(parts) + f"; the copy takes {ms:.3f} ms")


def _wide(libs, dies):
    """The wide instances' event choice three ways, on ``dies``' cell."""
    for i, (ops, timing, steps, kw, out) in enumerate(
            _record_main_path(dies)):
        real = (ops[:, :, 1] != 3.0).sum(dim=1).to(torch.float64)
        longest = int((real + out[2][:, 2]).max())
        print(f"{dies} dies, launch {i}: {ops.shape[0]} lanes, maxp "
              f"{ops.shape[1]}, {kw}, longest lane {longest} steps")
        runs = {name: (lambda f=_launcher(lib, ops, timing, steps, kw): f(3))
                for name, lib in libs.items()}
        times = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                ms, got = _ms(runs[name])
                if not all(torch.equal(g, w) for g, w in zip(got, out)):
                    raise AssertionError(f"{dies} dies, {name}: differs from "
                                         f"the wrapper's output")
                times[name].append(ms)
        for name, ms in times.items():
            print(f"  {name}: " + ", ".join(f"{t:.3f}" for t in ms)
                  + f" ms ({min(ms) * 1e6 / longest:.1f} ns per step of the "
                  f"longest lane)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wide", default="",
                    help="also compare the wide instances' event choice "
                         "on cells of these dies a channel (comma list)")
    wide = [int(x) for x in ap.parse_args().wide.split(",") if x]
    if not torch.cuda.is_available():
        raise SystemExit("fcfs_ablation: needs a CUDA card")
    os.environ.setdefault("REPRO_TORCH_CHAR_CACHE_DIR", str(
        Path(__file__).resolve().parents[1] / "build" / "fcfs_ablation"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    srcs = (K._SOURCE,) + _variant_sources()
    libs = build.build_all(srcs)
    prod, scan, probed, tree, blocks = (ctypes.CDLL(str(libs[s]))
                                        for s in srcs)
    recorded = _record_main_path()
    print(f"main path: {len(recorded)} launch(es)")
    for i, (ops, timing, steps, kw, out) in enumerate(recorded):
        real = (ops[:, :, 1] != 3.0).sum(dim=1).to(torch.float64)
        per_lane = real + out[2][:, 2]
        longest = int(per_lane.max())
        top = int(per_lane.argmax())
        print(f"launch {i}: {ops.shape[0]} lanes, maxp {ops.shape[1]}, "
              f"{kw}, longest lane {longest} steps (lane {top})")
        launch = _launcher(prod, ops, timing, steps, kw)
        runs = {name: (lambda p=p: launch(p))
                for p, name in PLACEMENTS.items()}
        scan_launch = _launcher(scan, ops, timing, steps, kw)
        runs["event choice as a scan, both in shared memory"] = \
            lambda: scan_launch(3)
        times = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                ms, got = _ms(runs[name])
                if not all(torch.equal(g, w) for g, w in zip(got, out)):
                    raise AssertionError(f"{name}: differs from the "
                                         f"wrapper's output")
                times[name].append(ms)
        for name, ms in times.items():
            print(f"  {name}: " + ", ".join(f"{t:.3f}" for t in ms)
                  + f" ms ({min(ms) * 1e6 / longest:.1f} ns per step of the "
                  f"longest lane)")
        probed_launch = _launcher(probed, ops, timing, steps, kw)
        ms, _ = _ms(lambda: probed_launch(3))
        _profile(probed, probed_launch, out, top, longest, ms)
        ms, _ = _ms(lambda: launch(3, slice(top, top + 1)))
        print(f"  the longest lane alone, shared memory: {ms:.3f} ms")
        tdma, tecc = float(timing[0, 0]), float(timing[0, 1])
        print(f"  chain floor: {_chain_ns(tdma, tecc):.3f} ns per step")
    for dies in wide:
        _wide({"event choice across warp 0 (the wrapper's)": prod,
               "one register tree in thread 0": tree,
               "register trees over blocks of 16 in thread 0": blocks},
              dies)


if __name__ == "__main__":
    main()
