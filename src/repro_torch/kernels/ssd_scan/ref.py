"""Sequential oracle of the SSD scan, restating the reference's
``src/repro/kernels/ssd_scan/ref.py::ssd_scan_ref`` in torch, so that
tests on the card need no JAX.  It evaluates the unchunked recurrence

  H_t = H_{t-1} * exp(clip(dA_t, -60, 0)) + dt_t * B_t^T x_t
  y_t = C_t H_t

one token at a time, in float32.
"""

from __future__ import annotations

import torch


def ssd_scan_ref(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, dA: torch.Tensor):
    """x (BH, T, hd); Bm, Cm (BH, T, ds); dt, dA (BH, T).  Returns (y (BH,
    T, hd) in x's dtype, H (BH, ds, hd) float32)."""
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    dtf, dAf = dt.float(), dA.float()
    BH, T, hd = x.shape
    H = torch.zeros((BH, Bm.shape[-1], hd), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(T):
        g = torch.exp(torch.clamp(dAf[:, t], -60.0, 0.0))[:, None, None]
        H = H * g + torch.einsum("bd,bh,b->bdh", Bf[:, t], xf[:, t],
                                 dtf[:, t])
        ys.append(torch.einsum("bd,bdh->bh", Cf[:, t], H))
    return torch.stack(ys, dim=1).to(x.dtype), H
