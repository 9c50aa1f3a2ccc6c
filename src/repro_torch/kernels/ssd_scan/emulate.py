"""The SSD scan's tensor-core path, emulated in torch on any device.

``tensor_core_emulation`` evaluates the scan in the tensor-core path's
chunk-parallel order (chunk states, states passed in float32, then each
chunk's y), with switches for the roundings its design weighed.  The
default is the design the CUDA kernels take: the scores, the chunk
states S and C . H_{c-1} as float32 products in the plain version's
order, and w' . x with w' in two bfloat16 parts against the exact
bfloat16 x.  The others round as the tensor cores would:

  * ``w_parts``: w' in that many bfloat16 parts (one fails the bf16 rule);
  * ``s_parts``: S from B * dt * seg in that many bfloat16 parts against
    exact x (the products exact, as ``wgmma`` takes them);
  * ``h_parts``: C . H_{c-1} with H in that many bfloat16 parts;
  * ``exact_ch``: C . H_{c-1} in float64, rounded once;
  * ``wgmma_scores``: C . B^T summed as ``wgmma`` sums it (``wgmma_sum``).

A product of bfloat16 values is exact in float32, as on the tensor
cores; every float32 product sums over k in order (``plain.seq_matmul``),
so the roundings do not depend on the host's SGEMM.  The tests and ``tools/ssd_rounding.py`` hold these variants
against ``ssd_scan_plain`` by the element-wise bfloat16 rule.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.plain import CLIP, chunk_cumsum, seq_matmul


def split_bf16(v: torch.Tensor, parts: int) -> list:
    """v as ``parts`` bfloat16 values (as float32) that sum to it: each
    part rounds what the earlier ones left."""
    out = []
    for _ in range(parts):
        out.append(v.to(torch.bfloat16).float())
        v = v - out[-1]
    return out


def wgmma_sum(a: torch.Tensor, b: torch.Tensor, k: int = 16) -> torch.Tensor:
    """a @ b as ``wgmma`` sums it: each k-deep product exact, added to a
    float32 accumulator that rounds toward zero."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], device=a.device)
    for s in range(0, a.shape[-1], k):
        tot = acc.double() + (a[..., s:s + k].double()
                              @ b[..., s:s + k, :].double())
        f = tot.float()
        acc = torch.where(f.double().abs() > tot.abs(),
                          torch.nextafter(f, torch.zeros_like(f)), f)
    return acc


def tensor_core_emulation(x, Bm, Cm, dt, dA, chunk: int, *, w_parts: int = 2,
                          s_parts: Optional[int] = None,
                          h_parts: Optional[int] = None,
                          exact_ch: bool = False,
                          wgmma_scores: bool = False):
    """``(y, H)`` of the scan, as ``ssd_scan_plain`` takes its inputs
    (x (BH, T, hd), B and C (BG, T, ds), dt and dA (BH, T)), under the
    roundings the keywords choose; y in x's dtype, H in float32."""
    BH, T, hd = x.shape
    BG, _, ds = Bm.shape
    G = BH // BG
    L = min(chunk, T)
    nc = -(-T // L)
    pad = nc * L - T
    dev = x.device

    def rows(t):
        t = F.pad(t.float(), (0, 0, 0, pad))
        return t.view(t.shape[0], nc, L, t.shape[-1])

    xf = rows(x)
    Bf, Cf = (rows(t).repeat_interleave(G, 0) for t in (Bm, Cm))
    dtf = F.pad(dt, (0, pad)).view(BH, nc, L)
    cum = chunk_cumsum(F.pad(dA, (0, pad)).view(BH, nc, L))
    total = cum[..., -1:]
    seg = torch.exp(torch.clamp(total - cum, CLIP, 0.0))
    if s_parts is None:
        S = seq_matmul(Bf.transpose(-1, -2),
                       (xf * dtf[..., None]) * seg[..., None])
    else:
        S = sum(seq_matmul(p.transpose(-1, -2), xf)
                for p in split_bf16(Bf * (dtf * seg)[..., None], s_parts))
    H = torch.zeros((BH, ds, hd), device=dev)
    h_in = []
    for c in range(nc):
        h_in.append(H)
        H = H * torch.exp(torch.clamp(total[:, c], CLIP, 0.0))[..., None] \
            + S[:, c]
    h_in = torch.stack(h_in, dim=1)
    tril = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    decay = torch.exp(torch.clamp(cum[..., :, None] - cum[..., None, :],
                                  CLIP, 0.0))
    scores = (wgmma_sum(Cf, Bf.transpose(-1, -2)) if wgmma_scores
              else seq_matmul(Cf, Bf.transpose(-1, -2)))
    w = torch.where(tril, scores * decay, 0.0) * dtf[..., None, :]
    if exact_ch:
        ch = (Cf.double() @ h_in.double()).float()
    elif h_parts is None:
        ch = seq_matmul(Cf, h_in)
    else:
        ch = sum(seq_matmul(Cf, p) for p in split_bf16(h_in, h_parts))
    y = sum(seq_matmul(p, xf) for p in split_bf16(w, w_parts)) \
        + ch * torch.exp(torch.clamp(cum, CLIP, 0.0))[..., None]
    return y.reshape(BH, nc * L, hd)[:, :T].to(x.dtype), H
