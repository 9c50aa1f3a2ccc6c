"""Plain torch version of the Mamba-2 SSD chunked scan, and two faulty
variants of it.

``ssd_scan_plain`` evaluates the scan in the Pallas kernel's own order
(``src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel``): per (row,
chunk of L = min(chunk, T) tokens), all in float32,

  cum    = cumsum(dA)
  scores = C @ B^T
  w      = tril(scores * exp(clip(cum_i - cum_j, -60, 0)))
  y      = w @ (x * dt) + (C @ H) * exp(clip(cum, -60, 0))
  H     <- H * exp(clip(total, -60, 0)) + B^T @ (x * dt * seg)

with ``total = cum[-1]`` and ``seg = exp(clip(total - cum, -60, 0))``.
The y of a chunk reads the H from before that chunk's update.  The
cumulative sum is taken in the CUDA kernel's order (``chunk_cumsum``),
so that the two round |cum| alike, and every float32 product in the
kernels' order (:func:`seq_matmul`).  T is padded to a multiple of L with
dt = dA = 0, so padded tokens are inert.  y comes out in x's dtype, H in
float32.  It is what CPU hosts run (it
covers the reference's non-kernel ``ssd_chunked`` too), and what the
CUDA kernel is held against on the card.

B and C are shared by the heads of a batch row: they come in as (BG, T,
ds) and row ``bh`` of x reads row ``bh // (BH // BG)`` of them, so the
per-head broadcast of the reference's adapter is never materialized.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

CLIP = -60.0  # exp underflow guard, as in the reference


def chunk_cumsum(a: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis in the CUDA kernel's
    order, so that both round alike: 32 runs of ceil(L/32) values, each
    summed in sequence; a shuffle scan (steps 1, 2, 4, 8, 16) of the run
    sums; then each run again in sequence from its exclusive offset."""
    L = a.shape[-1]
    per = -(-L // 32)
    runs = F.pad(a, (0, 32 * per - L)).unflatten(-1, (32, per))
    incl = runs[..., 0]
    for k in range(1, per):
        incl = incl + runs[..., k]
    for off in (1, 2, 4, 8, 16):
        incl = torch.cat([incl[..., :off], incl[..., off:] + incl[..., :-off]],
                         dim=-1)
    run = F.pad(incl[..., :-1], (1, 0))
    out = []
    for k in range(per):
        run = run + runs[..., k]
        out.append(run)
    return torch.stack(out, dim=-1).flatten(-2)[..., :L]


def seq_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 (a (..., M, K), b (..., K, N)), each output a
    chain of fused multiply-adds over k in order: the CUDA kernels'
    ``fmaf`` chains, and cuBLAS's SGEMM order on the card at these
    shapes.  A CPU host's SGEMM orders k its own way (by BLAS build and
    vector width), and a cancelling sum (left-padded rows) shows it, so
    on the CPU the chain is taken explicitly: each step's a * b + acc in
    float64, rounded to float32 once (a fused multiply-add, but for the
    rare double rounding)."""
    if a.device.type != "cpu":
        return a @ b
    a64, b64 = a.double(), b.double()
    acc = (a64[..., :, :1] * b64[..., :1, :]).float()
    for k in range(1, a.shape[-1]):
        acc = (acc.double() + a64[..., :, k:k + 1] * b64[..., k:k + 1, :]
               ).float()
    return acc


def _scan(x, Bm, Cm, dt, dA, chunk: int, fault: Optional[str] = None):
    BH, T, hd = x.shape
    BG, _, ds = Bm.shape
    G = BH // BG
    L = min(chunk, T)
    nc = -(-T // L)
    pad = nc * L - T
    xf = F.pad(x.float(), (0, 0, 0, pad)).view(BG, G, nc, L, hd)
    Bf = F.pad(Bm.float(), (0, 0, 0, pad)).view(BG, nc, L, ds)
    Cf = F.pad(Cm.float(), (0, 0, 0, pad)).view(BG, nc, L, ds)
    dtf = F.pad(dt.float(), (0, pad)).view(BG, G, nc, L)
    dAf = F.pad(dA.float(), (0, pad)).view(BG, G, nc, L)
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()

    H = torch.zeros((BG, G, ds, hd), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, dAc = xf[:, :, c], dtf[:, :, c], dAf[:, :, c]
        Bc, Cc = Bf[:, c, None], Cf[:, c, None]           # (BG, 1, L, ds)
        cum = chunk_cumsum(dAc)                            # (BG, G, L)
        total = cum[..., -1:]
        scores = seq_matmul(Cc, Bc.transpose(-1, -2))      # (BG, 1, L, L)
        decay = torch.exp(torch.clamp(cum[..., :, None] - cum[..., None, :],
                                      CLIP, 0.0))
        w = torch.where(tril, scores * decay, 0.0)
        if fault == "w-bf16":
            w = w.to(torch.bfloat16).float()
        xdt = xc * dtc[..., None]                          # (BG, G, L, hd)
        y = seq_matmul(w, xdt) + seq_matmul(Cc, H) * torch.exp(
            torch.clamp(cum, CLIP, 0.0))[..., None]
        ys.append(y.to(x.dtype))
        seg = torch.exp(torch.clamp(total - cum, CLIP, 0.0))
        S = seq_matmul(Bc.transpose(-1, -2),
                       xdt * seg[..., None])               # (BG, G, ds, hd)
        if fault == "no-decay":
            H = H + S
        else:
            H = H * torch.exp(torch.clamp(total, CLIP, 0.0))[..., None] + S
    y = torch.stack(ys, dim=2).reshape(BH, nc * L, hd)[:, :T]
    return y, H.reshape(BH, ds, hd)


def ssd_scan_plain(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   dt: torch.Tensor, dA: torch.Tensor, chunk: int = 256):
    """x (BH, T, hd); Bm, Cm (BG, T, ds) with BH a multiple of BG; dt and
    dA = dt * A (BH, T).  Returns (y (BH, T, hd) in x's dtype, H (BH,
    ds, hd) float32)."""
    return _scan(x, Bm, Cm, dt, dA, chunk)


def faulty_ssd_plain(x, Bm, Cm, dt, dA, chunk: int, fault: str):
    """The scan with one fault a kernel could have, which the element-wise
    bfloat16 rule (``flash_attention.plain.bf16_err_ratio``) must reject
    on y: ``"w-bf16"`` rounds w to bfloat16 before its product with
    x * dt, ``"no-decay"`` carries the state across chunk boundaries
    without its decay exp(total)."""
    if fault not in ("w-bf16", "no-decay"):
        raise ValueError(f"unknown fault {fault!r}")
    return _scan(x, Bm, Cm, dt, dA, chunk, fault)
