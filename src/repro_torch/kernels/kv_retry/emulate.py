"""The KV retry read's vector kernel, emulated in torch on any device.

``kv_retry_emulate`` evaluates the read in the order of
``kv_retry_vec_kernel`` (``csrc/kv_retry.cu``): a page of E values is
owned by G = E/16 lanes (rounded up to a power of two; the lanes past
E/16 hold 0), each lane sums the squares of its 16 dequantized values
in order, and the group adds its partial sums in a butterfly (lane i
takes lane i + G/2's sum, then i + G/4's, ...).  Every operation rounds
to float32 on its own, as the kernel built with ``-fmad=false`` does, so
on the CPU this is the kernel's arithmetic; the tests hold it against
the reference as the card holds the kernel against the plain version.
"""

from __future__ import annotations

import torch

#: Values a lane of the vector kernel loads, sums and writes.
LANE_VALUES = 16


def lanes_per_page(E: int) -> int:
    """G: the lanes that own a page of E values (E a multiple of 16)."""
    if E % LANE_VALUES or E <= 0:
        raise ValueError(f"the vector kernel takes widths that are "
                         f"multiples of {LANE_VALUES}, got {E}")
    chunks = E // LANE_VALUES
    return 1 << (chunks - 1).bit_length()


def sum_of_squares(deq: torch.Tensor) -> torch.Tensor:
    """(P, E) float32 dequant -> (P,) sum of squares in the kernel's
    order: lane partials of 16 in sequence, then the butterfly."""
    P, E = deq.shape
    G = lanes_per_page(E)
    sq = deq * deq
    sq = torch.cat([sq, sq.new_zeros(P, G * LANE_VALUES - E)], dim=1)
    sq = sq.view(P, G, LANE_VALUES)
    part = torch.zeros(P, G, dtype=torch.float32, device=deq.device)
    for j in range(LANE_VALUES):
        part = part + sq[:, :, j]
    while part.shape[1] > 1:
        half = part.shape[1] // 2
        part = part[:, :half] + part[:, half:]
    return part[:, 0]


def kv_retry_emulate(data_q: torch.Tensor, scale: torch.Tensor,
                     backing: torch.Tensor, tau: float = 0.02):
    """As ``kv_retry_plain``: (out (P, E) in backing's dtype, margin
    (P, 1) float32), with the vector kernel's summation order."""
    E = data_q.shape[1]
    deq = data_q.float() * scale
    ss = sum_of_squares(deq)[:, None]
    rms = torch.sqrt(ss / E + 1e-12)
    margin = 1.0 - (0.5 * scale) / (tau * rms)
    out = torch.where(margin >= 0.0, deq, backing.float())
    return out.to(backing.dtype), margin


def pages_near_zero(P: int, E: int, seed: int = 0):
    """Pages whose margins lie within 1e-6 of 0, on both sides, and whose
    sums are exact in any order, so that every implementation must take
    the same decisions: ``(data_q (P, E) int8, scale (P, 1) float32,
    tau)``, made with numpy from ``seed``.

    Each page is a permutation of one int8 page ``a`` (values uniform in
    [-127, 127], one 0) or of ``a`` with that 0 made 1, whose sum of
    squares is 1 more; its scale is a power of two, so every product and
    partial sum is an exact float32 (below 2^24 for E <= 512).  The
    margin is 1 - 0.5 / (tau * sqrt(sum q^2 / E)) whatever the scale,
    and tau sits between the two families: |margin| is about
    E / (4 * sum a^2), 7e-7 at E 64, negative for ``a``.
    """
    import numpy as np

    if E & (E - 1) or not 16 <= E <= 512:
        raise ValueError(f"E must be a power of two in [16, 512], got {E}")
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, E)
    a[a == 0] = 5
    a[0], a[1] = 127, 0
    S = float((a.astype(np.int64) ** 2).sum())
    q = np.stack([rng.permutation(a) for _ in range(P)])
    ones = rng.random(P) < 0.5
    q[ones] = np.where(q[ones] == 0, 1, q[ones])
    scale = np.exp2(-rng.integers(3, 13, (P, 1))).astype(np.float32)
    tau = float(np.float32(0.5 / np.sqrt((S + 0.5) / E)))
    return (torch.from_numpy(q.astype(np.int8)), torch.from_numpy(scale),
            tau)
