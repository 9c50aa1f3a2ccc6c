"""Plain torch version of the margin-aware KV retry read, and the page
quantizer it reads.

``kv_retry_plain`` restates the reference's ``kv_retry_ref`` line for
line: per page, the int8 × scale dequant, its rms, the margin
``1 - (scale/2) / (tau * rms)``, and the select between the dequant
(margin >= 0, the fast read) and the backing copy (the retry), cast to
backing's dtype (on int8 backing a truncation toward zero, as the
reference's ``astype`` is).  It is
what CPU hosts run and what the CUDA kernel is held against on the card.
``quantize_pages`` is the reference's per-page symmetric int8 quantizer
(plain torch on every device, as the reference keeps it outside its
kernel); ``torch.round`` rounds half to even, as ``jnp.round`` does, and
the scale is a true division by 127 on every device (CUDA would
multiply by the reciprocal of a Python divisor), so the card quantizes
as the CPU does.
"""

from __future__ import annotations

import torch

from repro_torch.core.xla_math import div32


def quantize_pages(x: torch.Tensor):
    """x (P, E) -> (int8 data (P, E), float32 scales (P, 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = div32(torch.clamp(amax, min=1e-8), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def kv_retry_plain(data_q: torch.Tensor, scale: torch.Tensor,
                   backing: torch.Tensor, tau: float = 0.02):
    """data_q (P, E) int8, scale (P, 1) float32, backing (P, E) float32,
    bfloat16 or int8.  Returns (out (P, E) in backing's dtype, margin (P, 1)
    float32)."""
    deq = data_q.float() * scale
    rms = torch.sqrt(torch.mean(torch.square(deq), dim=-1, keepdim=True)
                     + 1e-12)
    err_bound = 0.5 * scale
    margin = 1.0 - err_bound / (tau * rms)
    out = torch.where(margin >= 0.0, deq, backing.float())
    return out.to(backing.dtype), margin
