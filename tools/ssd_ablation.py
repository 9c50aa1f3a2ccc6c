#!/usr/bin/env python3
"""The SSD scan's tensor-core path on the card: right, and where its time
goes.

Builds ``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu`` and prints
ptxas' report of its kernels.  Then, on inputs drawn as ``chip_smoke.py``
draws them (mamba2-130m's dt and A initialisation), holds the
tensor-core path against the plain version at the full-width long
prefill shape (B 4, T 2048, 24 heads, hd 64, ds 128, chunk 256) and at
T 4, 11, 300 and 1500 with G 1 and 24 heads to a row: y by the
element-wise bfloat16 rule, H within 1e-5 of its largest value, and two
launches bit for bit equal.  Last, at the long shape, with CUDA events
in two rounds (the second in reverse order): the whole launch; each of
its four kernels alone (the chunk states, the state passing, the scores,
the chunk scan); the chunk scan with the heads of a row split into 1, 2,
3, 4 and 6 groups; the SIMT kernel (the path float32 takes) on the same
bfloat16 inputs; whole launches at T 11 (a short prompt) and 1500; and
the host's time to enqueue a call (no synchronize) at T 11 and 2048.
Then copies of the source, each with one part taken out — of the chunk
scan: the decays' exp, the forming of w', the w' . x products, the C . H
term and its loads, all heads of a block but one, or the longest-first
order of the blocks (a batch row's query tiles side by side instead); of
the chunk states: the chain of S — are built beside it, and that kernel
timed alone on the same inputs (their outputs are wrong by design;
ptxas' notes on each are printed).  Needs a CUDA card.  Run from the
root of a checkout:

    PYTHONPATH=src python tools/ssd_ablation.py
"""

from __future__ import annotations

import math
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.plain import bf16_err_ratio
from repro_torch.kernels.ssd_scan import ops as K
from repro_torch.kernels.ssd_scan.plain import ssd_scan_plain

REPS = 20
SHAPE = (4, 2048, 24, 64, 128, 256)    # B, T, heads, hd, ds, chunk
H_TOL = 1e-5
HEAD_GROUPS = (1, 2, 3, 4, 6)


def inputs(gen, B, nh, T, hd, ds, dtype=torch.bfloat16):
    """Kernel-layout inputs as chip_smoke.py draws them."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u = torch.rand(nh, generator=gen, device="cuda")
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(randn(B * nh, T) + bias.repeat(B)[:, None])
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device="cuda")
    return (randn(B * nh, T, hd).to(dtype), (0.5 * randn(B, T, ds)).to(dtype),
            (0.5 * randn(B, T, ds)).to(dtype), dt, dt * A.repeat(B)[:, None])


def ms(fn, reps=REPS):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def hold(name, args, chunk):
    tc0 = K.tc_launches
    y, H = K.ssd_scan_fwd(*args, chunk=chunk)
    y2, H2 = K.ssd_scan_fwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    took = K.tc_launches - tc0
    want_y, want_H = ssd_scan_plain(*args, chunk=chunk)
    ry = bf16_err_ratio(y, want_y)
    rh = float((H - want_H).abs().max()) / (
        H_TOL * max(float(want_H.abs().max()), 1e-30))
    same = torch.equal(y, y2) and torch.equal(H, H2)
    ok = ry <= 1.0 and rh <= 1.0 and same and took == 2
    print(f"{name}: y ratio {ry:.3g}, H ratio {rh:.3g}, bitwise repeat "
          f"{same}, tensor-core launches {took} of 2 -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def simt(args, chunk):
    """The SIMT kernel on these (bfloat16) inputs, as a callable."""
    x, Bm, Cm, dt, dA = args
    BH, T, hd = x.shape
    BG, _, ds = Bm.shape
    y = torch.empty_like(x)
    H = torch.empty((BH, ds, hd), dtype=torch.float32, device=x.device)
    fn = K._kernel_fn()

    def run():
        err = fn(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                 dA.data_ptr(), y.data_ptr(), H.data_ptr(), BH, T, hd, ds,
                 BH // BG, min(chunk, T), 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return run


#: Ablations: a name, the kernel timed (1 the chunk states, 8 the chunk
#: scan),
#: and (text, replacement) pairs applied to the source.
_NO_FORMING = ("        build(st, fr[st & 1]);\n", "")
_NO_PRODUCTS = ("        mma_rs(acc, fr[st & 1], db, st > 0);\n"
                "        mma_rs(acc, fr[st & 1] + 4, db, 1);\n", "")
_NO_CH = ("    if (x.c > 0) {\n      const float* Hs",
          "    if (false) {\n      const float* Hs")
ABLATIONS = {
    "chunk scan, no decay exp": (8, [
        ("clip_exp_fast(cq[h] - cs[kp + jj])", "1.f")]),
    "chunk scan, no w' forming": (8, [_NO_FORMING]),
    "chunk scan, no w' . x products": (8, [_NO_PRODUCTS]),
    "chunk scan, no forming and no products": (8, [_NO_FORMING,
                                                  _NO_PRODUCTS]),
    "chunk scan, w' hi part only": (8, [
        ("        mma_rs(acc, fr[st & 1] + 4, db, 1);\n", "")]),
    "chunk scan, no C . H": (8, [_NO_CH]),
    "chunk scan, no C . H and no H loads": (8, [
        _NO_CH,
        ("  mbar_expect_tx(bar, NKT * 8192 + (x.c > 0 ? C::H_BYTES : 0));",
         "  mbar_expect_tx(bar, NKT * 8192);"),
        ("  if (x.c > 0)\n    bulk_load(", "  if (false)\n    bulk_load(")]),
    "chunk scan, one head a block": (8, [
        ("  x.nh = min(a.G, x.h_beg + a.hpg) - x.h_beg;",
         "  x.nh = min(1, min(a.G, x.h_beg + a.hpg) - x.h_beg);")]),
    "chunk scan, a row's query tiles side by side": (8, [
        ("  const int per_qt = a.nc * a.BG * a.n_hg;\n"
         "  const int qt = a.n_qt - 1 - (int)blockIdx.x / per_qt;\n"
         "  int rem = (int)blockIdx.x % per_qt;\n",
         "  const int qt = a.n_qt - 1 - (int)blockIdx.x % a.n_qt;\n"
         "  int rem = (int)blockIdx.x / a.n_qt;\n")]),
    "chunk states, no S chain": (1, [
        ("      sacc[4 * a] = fmaf(bv[a], xv.x, sacc[4 * a]);\n"
         "      sacc[4 * a + 1] = fmaf(bv[a], xv.y, sacc[4 * a + 1]);\n"
         "      sacc[4 * a + 2] = fmaf(bv[a], xv.z, sacc[4 * a + 2]);\n"
         "      sacc[4 * a + 3] = fmaf(bv[a], xv.w, sacc[4 * a + 3]);\n",
         "")]),
}


def ablation_libs():
    """Build every ablated copy of the source at once; returns {name:
    loaded library}."""
    import ctypes

    src = K._SOURCE.read_text()
    out_dir = build.build_dir() / "ssd_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, (_, edits)) in enumerate(ABLATIONS.items()):
        text = src
        missing = [old for old, _ in edits if old not in text]
        if missing:
            print(f"ablation {name!r} skipped: {missing[0]!r} is not in the "
                  f"source")
            continue
        for old, new in edits:
            text = text.replace(old, new)
        path = out_dir / f"ssd_scan_ablation{i}.cu"
        path.write_text(text)
        paths[name] = path
    libs = build.build_all(list(paths.values()))
    for name, path in paths.items():
        notes = [line.strip() for line in
                 open(f"{libs[path]}.log").read().splitlines()
                 if "arn" in line or "serializ" in line]
        for n in notes[:6]:
            print(f"  {name}: {n}")
    return {name: ctypes.CDLL(str(libs[path]))
            for name, path in paths.items()}


def stage_only(lib, args, chunk, n_hg, mask):
    """The kernel ``mask`` of ``lib`` alone, as a callable, on outputs of
    its own and zero scratch (cum 0: every decay is 1, which changes no
    instruction)."""
    import ctypes

    x, Bm, Cm, dt, dA = args
    BH, T, hd = x.shape
    BG, _, ds = Bm.shape
    L = min(chunk, T)
    nc = -(-T // L)
    y = torch.empty_like(x)
    H = torch.empty((BH, ds, hd), dtype=torch.float32, device="cuda")
    S = torch.zeros((BH, nc, ds, hd), dtype=torch.float32, device="cuda")
    Hp = torch.zeros((BH, max(nc - 1, 1), ds, hd), dtype=torch.float32,
                     device="cuda")
    cum = torch.zeros((BH, nc * L), dtype=torch.float32, device="cuda")
    n_qt = -(-L // 64)
    strip = torch.zeros((BG, nc, n_qt * (n_qt + 1) // 2, 64 * 64),
                        dtype=torch.float32, device="cuda")
    fn = lib.ssd_scan_tc_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 11 + [ci] * 8 + [vp]
    fn.restype = ci

    def run():
        err = fn(*(t.data_ptr() for t in (x, Bm, Cm, dt, dA, y, H, S, Hp,
                                            cum, strip)),
                 BH, T, hd, ds, BH // BG, L, n_hg, mask,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return run


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    lib = build.build_all([K._SOURCE])[K._SOURCE]
    for line in open(f"{lib}.log").read().splitlines():
        if ("Used" in line or "spill" in line or "Function properties" in line
                or "arn" in line or "serializ" in line):
            print(f"  ptxas: {line.strip()}")

    gen = torch.Generator("cuda").manual_seed(0)
    B, T, nh, hd, ds, chunk = SHAPE
    ok = hold(f"long prefill B {B} T {T} G {nh}",
              inputs(gen, B, nh, T, hd, ds), chunk)
    for t in (4, 11, 300, 1500):
        for g in (1, nh):
            ok &= hold(f"T {t} G {g}", inputs(gen, B, g, t, hd, ds), chunk)
    ok &= hold("ds 64, T 700 G 3", inputs(gen, 2, 3, 700, hd, 64), chunk)
    ok &= hold("chunk 64, T 500 G 5", inputs(gen, 2, 5, 500, hd, ds), 64)

    args = inputs(gen, B, nh, T, hd, ds)
    runs, _ = K.tc_stage_launchers(*args, chunk=chunk)
    for r in runs:                        # every intermediate written once
        r()
    whole = lambda: K.ssd_scan_fwd(*args, chunk=chunk)  # noqa: E731
    parts = {f"whole launch (n_hg {K.head_groups(B, nh, T, chunk)})": whole,
             "1 chunk states": runs[0], "2 state passing": runs[1],
             "3 scores": runs[2], "4 chunk scan": runs[3]}
    for g in HEAD_GROUPS:
        r, _ = K.tc_stage_launchers(*args, chunk=chunk, n_hg=g)
        for f in r:
            f()
        parts[f"4 chunk scan, {g} head groups"] = r[3]
    parts["SIMT kernel, bf16"] = simt(args, chunk)
    for t in (11, 1500):
        short = inputs(gen, B, nh, t, hd, ds)
        parts[f"whole launch at T {t}"] = (
            lambda a=short: K.ssd_scan_fwd(*a, chunk=chunk))
    n_hg = K.head_groups(B, nh, T, chunk)
    for name, lib in ablation_libs().items():
        parts[name] = stage_only(lib, args, chunk, n_hg, ABLATIONS[name][0])
    times = {k: [] for k in parts}
    for order in (list(parts), list(parts)[::-1]):
        for k in order:
            times[k].append(ms(parts[k]))
    for k, v in times.items():
        print(f"{k}: {v[0]:.4f} ms, {v[1]:.4f} ms")
    # Host time of a call: REPS calls enqueued, no synchronize between.
    import time
    for t in (11, 2048):
        a = inputs(gen, B, nh, t, hd, ds)
        K.ssd_scan_fwd(*a, chunk=chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            K.ssd_scan_fwd(*a, chunk=chunk)
        host = (time.perf_counter() - t0) / REPS * 1e3
        torch.cuda.synchronize()
        print(f"host time of a call at T {t}: {host:.4f} ms")
    print("ALL OK" if ok else "SOME CASE FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
