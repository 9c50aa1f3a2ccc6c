#!/usr/bin/env python3
"""The RBER kernel (B2) on the card, bare: the port's kernel against its
ablations and, optionally, another checkout's kernel.

Builds ``src/repro_torch/kernels/rber/csrc/rber.cu``,
``tools/rber_ablation.cu`` (the port's design, one thread per (page,
entry), with a 32-bit index, the levels in shared memory or not and
blocks of 256 or 128; and tiles of pages x all entries, a page's means
and sigmas in registers across its entries, at 12 to 64 pages a tile)
and, with ``--against DIR``, the rber.cu of the checkout at DIR (its C
entry ``rber_launch`` has the same signature).  On the
characterization's shape (``chip_smoke.py``'s 160-chip population at
365 d / 1000 P/E: 20 480 pages x 41 entries) every variant is held bit for bit against the plain version, and timed
bare (100 launches queued behind a sleeping stream, CUDA events around
them) in two rounds, the second in reverse order.  The bound is
``chip_smoke.py``'s, with the operations of one erfcf and one IEEE
division read from this checkout's SASS.  Needs a CUDA card.  Run from
the root of a checkout:

    PYTHONPATH=src python tools/rber_ablation.py [--against DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rber import ops as RB  # noqa: E402
from repro_torch.kernels.rber.plain import rber_plain  # noqa: E402

ABLATION = Path(__file__).resolve().parent / "rber_ablation.cu"
# Variants of rber_ablation_launch.
ABLATIONS = {"32-bit index, levels in shared memory": 1,
             "32-bit index, levels in shared memory, blocks of 128": 2,
             "32-bit index, levels loaded by each thread": 3,
             "tiled, 12 pages a tile (2 entries a thread)": 112,
             "tiled, 18 pages a tile (3 entries a thread)": 118,
             "tiled, 32 pages a tile (5-6 entries a thread)": 132,
             "tiled, 64 pages a tile (11 entries a thread)": 164}


def typed(fn, n_int):
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, *[ctypes.c_int] * n_int, vp]
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rber_ablation: needs a CUDA card")
    print(CS.device_phase()[1])
    mu, sigma, levels = CS._population()
    want = rber_plain(mu, sigma, levels)
    N, S = mu.shape[0], levels.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    head = (mu.data_ptr(), sigma.data_ptr(), levels.data_ptr())

    def launcher(fn, *extra):
        out = torch.empty_like(want)

        def launch():
            if fn(*head, out.data_ptr(), N, S, *extra, stream) != 0:
                raise RuntimeError("launch failed")
        return launch, out

    runs = {"the port's kernel (a thread a (page, entry), 64-bit index)":
            launcher(RB._kernel_fn())}
    abl = typed(build.load(ABLATION).rber_ablation_launch, 3)
    runs.update({n: launcher(abl, v) for n, v in ABLATIONS.items()})
    if a.against is not None:
        src = a.against / RB._SOURCE.relative_to(ROOT)
        runs[f"{a.against}'s kernel"] = launcher(
            typed(build.load(src).rber_launch, 2))
    for name, (launch, out) in runs.items():
        launch()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: differs from the plain version")
    bound = max(CS._rber_bound_ms(mu, levels, want, *CS._rber_op_counts()))
    names = list(runs)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(CS._queued_ms(runs[n][0], CS.RBER_BARE_REPS))
    for n in names:
        print(f"{n}: bare {' / '.join(f'{t:.5f}' for t in times[n])} ms, "
              f"{bound / min(times[n]) * 100:.1f}% of the {bound:.5f} ms "
              f"bound; bit for bit equal to the plain version", flush=True)


if __name__ == "__main__":
    main()
