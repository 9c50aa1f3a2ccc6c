"""Plain torch version of the flash-attention forward kernel.

A dense float32 softmax over the kernel's mask: the reference's
``attention_ref`` restated with the kernel's arithmetic — q, k and v in
float32, the P·V product in float32 (not in the value dtype), masked
entries contributing p = 0, and the output ``acc / max(l, 1e-30)`` cast
to q's dtype.  It is what CPU hosts run, and what the CUDA kernel is
held against on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30


def attention_mask(T: int, S: int, causal: bool, window: Optional[int],
                   kv_valid: Optional[int], device,
                   q_offset: int = 0) -> torch.Tensor:
    """(T, S) bool: key ``s`` is visible to query ``t``, which sits at
    position ``q_offset + t`` (a context-parallel shard's queries)."""
    qpos = q_offset + torch.arange(T, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = (kpos < (S if kv_valid is None else kv_valid)).expand(T, S)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          kv_valid: Optional[int] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """q (BH, T, hd); k, v (BK, S, hd) with BH = BK * G (query row ``bh``
    reads kv row ``bh // G``); query ``t`` at position ``q_offset + t``.
    Returns (BH, T, hd) in q's dtype."""
    BH, T, hd = q.shape
    BK, S, _ = k.shape
    G = BH // BK
    kf = k.float().repeat_interleave(G, dim=0)
    vf = v.float().repeat_interleave(G, dim=0)
    s = torch.matmul(q.float(), kf.transpose(1, 2)) * (hd ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(T, S, causal, window, kv_valid, q.device,
                          q_offset)
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def bf16_err_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst ratio, over the elements, of ``|got - want|`` to a bfloat16
    output's tolerance there: one bfloat16 ulp of ``|want|`` at that
    element, plus 2^-8 of its row's rms (over the last axis) for values
    near zero.  Two float32 results that differ only in summation order
    round to equal or adjacent bfloat16 values, so they stay within 1;
    rounding p to bfloat16 before P·V, or dropping a key tile, does not.
    """
    w = want.float()
    err = (got.float() - w).abs()
    _, e = torch.frexp(w)                  # |w| in [2^(e-1), 2^e)
    ulp = torch.where(w != 0, torch.exp2((e - 8).float()), 0.0)
    tol = ulp + 2.0 ** -8 * w.square().mean(dim=-1, keepdim=True).sqrt()
    return float(torch.where(err == 0, 0.0, err / tol).max())


def faulty_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           fault: str) -> torch.Tensor:
    """Causal attention with one fault a kernel could have, which
    :func:`bf16_err_ratio` must reject: ``"p-bf16"`` rounds p to bfloat16
    before P·V (the reference's blockwise CPU path's math), and
    ``"drop-tile"`` leaves keys 64-127 out of the later half of the rows.
    """
    BH, T, hd = q.shape
    G = BH // k.shape[0]
    kf = k.float().repeat_interleave(G, dim=0)
    vf = v.float().repeat_interleave(G, dim=0)
    mask = attention_mask(T, T, True, None, None, q.device).clone()
    if fault == "drop-tile":
        mask[T // 2:, 64:128] = False
    elif fault != "p-bf16":
        raise ValueError(f"unknown fault {fault!r}")
    s = torch.where(mask, torch.matmul(q.float(), kf.transpose(1, 2))
                    * (hd ** -0.5), NEG)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if fault == "p-bf16":
        p = p.to(torch.bfloat16).float()
    return (torch.matmul(p, vf) / torch.clamp(l, min=1e-30)).to(q.dtype)
