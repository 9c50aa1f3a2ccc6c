#!/usr/bin/env python3
"""Exhaustive float32 sweep of restatements of XLA's CPU ``log1p``.

The port's ``repro_torch.core.prng.erfinv32`` needs ``log1p(-x*x)`` for
x in (-1, 1), i.e. every float32 argument in (-1, 0].  This script runs
every such argument (1 065 353 217 values, in chunks) through
``jnp.log1p`` on the CPU and through three candidates, and prints the
histogram of float32 ulp gaps of each:

  torch     — ``torch.log1p``;
  cephes    — XLA's ``EmitLog1p`` form: below sqrt(2)-1 in magnitude the
              Cephes rational ``x - x^2/2 + x^3 P(x)/Q(x)``, else
              ``log(1 + x)``, with ``log`` the Cephes ``logf`` polynomial
              (frexp, sqrt(1/2) shift, 9-term Horner); Horner steps
              fused (one rounding each, as a fused multiply-add);
  cephes-nofma — the same with every multiply and add rounded.

It also counts, per candidate, the gaps on each branch.  Run from the
root of a checkout (needs jax, numpy and torch on the CPU):

    PYTHONPATH=src python tools/log1p_sweep.py [--stride N]

``--stride N`` samples every N-th argument instead of all of them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

F32 = np.float32
SMALL = F32(0.41421356237309504880)
NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
       6.5787325942061044846969E0, 2.9911919328553073277375E1,
       6.0949667980987787057556E1, 5.7112963590585538103336E1,
       2.0039553499201281259648E1)
DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
       2.2176239823732856465394E2, 3.0909872225312059774938E2,
       2.1642788614495947685003E2, 6.0118660497603843919306E1)
LOGP = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
        -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
        2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _ma(a, b, c, fused):
    if fused:   # one rounding: the f64 product of two f32 values is exact
        return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
                + np.asarray(c, np.float64)).astype(F32)
    return ((np.asarray(a, F32) * np.asarray(b, F32)).astype(F32)
            + np.asarray(c, F32)).astype(F32)


def _poly(x, coeffs, fused):
    p = np.zeros_like(x)
    for c in coeffs:
        p = _ma(p, x, F32(c), fused)
    return p


def cephes_log(v, fused):
    m, e = np.frexp(v)
    x, e = m.astype(F32), e.astype(F32)
    lt = x < F32(0.707106781186547524)
    x = (x - F32(1) + np.where(lt, x, F32(0))).astype(F32)
    e = (e - np.where(lt, F32(1), F32(0))).astype(F32)
    z = (x * x).astype(F32)
    y = np.full_like(x, F32(LOGP[0]))
    for c in LOGP[1:]:
        y = _ma(y, x, F32(c), fused)
    y = ((y * x).astype(F32) * z).astype(F32)
    y = _ma(e, F32(-2.12194440e-4), y, fused)
    y = _ma(z, F32(-0.5), y, fused)
    x = (x + y).astype(F32)
    return _ma(e, F32(0.693359375), x, fused)


def cephes_log1p(x, fused):
    x2 = (x * x).astype(F32)
    r = (_poly(x, NUM, fused) / _poly(x, DEN, fused)).astype(F32)
    t = ((x * x2).astype(F32) * r).astype(F32)
    small = _ma(F32(-0.5), x2, t, fused)
    small = (x + small).astype(F32)
    with np.errstate(divide="ignore"):
        large = cephes_log((F32(1) + x).astype(F32), fused)
    return np.where(np.abs(x) < SMALL, small, large)


def ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def main():
    import jax
    import jax.numpy as jnp
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=1 << 22)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    ref = jax.jit(jnp.log1p)
    names = ("torch", "cephes", "cephes-nofma")
    hist = {n: {"small": np.zeros(8, np.int64), "large": np.zeros(8, np.int64)}
            for n in names}
    n_total = 0
    t0 = time.perf_counter()
    top = 0x3F800000           # bits of 1.0: arguments -0.0 .. -nextbelow(1)
    step = args.chunk * args.stride
    for lo in range(0, top, step):
        bits = np.arange(lo, min(lo + step, top), args.stride, dtype=np.uint32)
        x = -bits.view(F32)
        want = np.asarray(ref(x))
        got = {"torch": torch.log1p(torch.from_numpy(x)).numpy(),
               "cephes": cephes_log1p(x, True),
               "cephes-nofma": cephes_log1p(x, False)}
        # XLA flushes subnormal arguments to zero; so do the restatements.
        sub = (x != 0) & (np.abs(x) < np.finfo(F32).tiny)
        small = np.abs(x) < SMALL
        for n in names:
            g = np.where(sub, want, got[n]) if n != "torch" else got[n]
            u = np.minimum(ulps(g, want), 7)
            hist[n]["small"] += np.bincount(u[small], minlength=8)
            hist[n]["large"] += np.bincount(u[~small], minlength=8)
        n_total += x.size
    print(f"{n_total} float32 arguments in (-1, 0], stride {args.stride}, "
          f"{time.perf_counter() - t0:.1f} s")
    for n in names:
        for br in ("small", "large"):
            h = hist[n][br]
            print(f"{n:>13} {br:>5} (|x| {'<' if br == 'small' else '>='} "
                  f"sqrt(2)-1): n={h.sum()} ulp gap 0..6,>=7: {h.tolist()} "
                  f"differ {h[1:].sum() / max(h.sum(), 1):.4%}")


if __name__ == "__main__":
    main()
