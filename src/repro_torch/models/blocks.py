"""Residual block dispatch: one init/apply pair per block kind.

An attention layer is (norm -> attention -> residual) + (norm -> dense
MLP -> residual); an SSD layer (``SSM``) is the whole mixer-and-channel
layer, (norm -> Mamba-2 block -> residual), with no second norm or MLP.
The port has the global (``ATTN``) and sliding-window (``LOCAL``)
attention blocks with a dense MLP, and SSD blocks; the other kinds raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ATTN, ENC_ATTN, LOCAL, RGLRU, SSM, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSMM
from repro_torch.models.common import apply_norm, mlp_apply, mlp_init, norm_init

#: ROADMAP items of the block kinds this slice does not port.
_NOT_PORTED = {RGLRU: "D10 (RG-LRU blocks)",
               ENC_ATTN: "D12 (encoder-decoder attention)"}


def check_kind(kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported: ROADMAP {_NOT_PORTED[kind]}")
    if kind not in (ATTN, LOCAL, SSM):
        raise ValueError(kind)


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               moe_here: bool) -> dict:
    check_kind(kind)
    if moe_here:
        raise NotImplementedError("MoE FFN layers are not ported: "
                                  "ROADMAP D11")
    d = cfg.d_model
    if kind == SSM:   # SSD blocks are the whole mixer+channel layer
        return {"ln1": norm_init(cfg, d, gen.device),
                "ssm": SSMM.ssm_init(gen, cfg)}
    return {"ln1": norm_init(cfg, d, gen.device),
            "attn": A.attn_init(gen, cfg),
            "ln2": norm_init(cfg, d, gen.device),
            "mlp": mlp_init(gen, cfg, d, cfg.d_ff)}


def _attn_kind(kind: str) -> str:
    return "local" if kind == LOCAL else "causal"


def _mlp(cfg: ModelConfig, p: dict, x):
    if "moe" in p:
        raise NotImplementedError("MoE FFN layers are not ported: "
                                  "ROADMAP D11")
    return mlp_apply(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))


def block_fullseq(cfg: ModelConfig, kind: str, p: dict, x,
                  positions) -> Tuple[torch.Tensor, dict]:
    """Prefill block application; returns (x, cache)."""
    check_kind(kind)
    h = apply_norm(cfg, p["ln1"], x)
    if kind == SSM:
        y, c = SSMM.ssm_fullseq(cfg, p["ssm"], h)
        return x + y, {"ssm": c}
    y, c = A.attention_fullseq(cfg, p["attn"], h, positions,
                               _attn_kind(kind))
    x = x + y
    return x + _mlp(cfg, p, x), {"attn": c}


def block_train_check(kind: str) -> None:
    """Raise unless blocks of ``kind`` can train in the port."""
    check_kind(kind)
    if kind == SSM:
        raise NotImplementedError(
            "training through Mamba-2 SSD blocks is not ported: "
            "ROADMAP D14b")


def block_train(cfg: ModelConfig, kind: str, p: dict, x, positions):
    """Training block application (no cache): the reference's
    ``block_fullseq(..., "train")`` for the attention kinds."""
    block_train_check(kind)
    h = apply_norm(cfg, p["ln1"], x)
    x = x + A.attention_train(cfg, p["attn"], h, positions, _attn_kind(kind))
    return x + _mlp(cfg, p, x)


def block_decode(cfg: ModelConfig, kind: str, p: dict, x, cache: dict,
                 pos: int) -> Tuple[torch.Tensor, dict]:
    check_kind(kind)
    h = apply_norm(cfg, p["ln1"], x)
    if kind == SSM:
        y, c = SSMM.ssm_decode(cfg, p["ssm"], h, cache["ssm"])
        return x + y, {"ssm": c}
    y, c = A.attention_decode(cfg, p["attn"], h, cache["attn"], pos,
                              _attn_kind(kind))
    x = x + y
    return x + _mlp(cfg, p, x), {"attn": c}
