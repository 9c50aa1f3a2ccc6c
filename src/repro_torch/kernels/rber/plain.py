"""Plain torch version of the RBER table, in the Pallas kernel's order.

For N pages with level means and sigmas (N, 8) and S retry-table
entries of read levels (S, 7), boundary b of page n at entry s gives

  e = (Q((L_sb - mu_nb) / sigma_nb) + Q((mu_n,b+1 - L_sb) / sigma_n,b+1)) / 8

with Q(x) = erfc(x / sqrt(2)) / 2, and each page type sums the
boundaries it senses (``PAGE_MASKS``, TLC 2-3-2).  As the reference's
``_rber_kernel`` (``src/repro/kernels/rber/kernel.py``) does, the
argument is multiplied by 1/sqrt(2), the sum is scaled by 0.125, and a
page type's boundaries are added to 0 in order.  It is what CPU hosts
run, and what the CUDA kernel is held against on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core import constants as C

#: TLC 2-3-2 page-type masks over the 7 boundaries (lsb, csb, msb): the
#: reference's ``kernels/rber/ref.py::PAGE_MASKS``.
PAGE_MASKS = tuple(tuple(int(b + 1 in C.PAGE_BOUNDARIES[pt]) for b in range(7))
                   for pt in C.PAGE_TYPES)

INV_SQRT2 = 0.7071067811865475


def rber_plain(mu: torch.Tensor, sigma: torch.Tensor,
               levels: torch.Tensor) -> torch.Tensor:
    """mu, sigma (N, 8); levels (S, 7) -> (3, N, S) float32 RBER per
    page type, page and retry entry."""
    mu, sigma, levels = mu.float(), sigma.float(), levels.float()
    out = torch.zeros((3, mu.shape[0], levels.shape[0]), dtype=torch.float32,
                      device=mu.device)
    for b in range(7):
        L = levels[None, :, b]                         # (1, S)
        up = 0.5 * torch.special.erfc(
            (L - mu[:, b, None]) / sigma[:, b, None] * INV_SQRT2)
        dn = 0.5 * torch.special.erfc(
            (mu[:, b + 1, None] - L) / sigma[:, b + 1, None] * INV_SQRT2)
        e = (up + dn) * 0.125                          # (N, S)
        for p in range(3):
            if PAGE_MASKS[p][b]:
                out[p] = out[p] + e
    return out
