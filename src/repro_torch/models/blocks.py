"""Residual block dispatch: one init/apply pair per block kind.

An attention (``ATTN``, ``LOCAL``) or RG-LRU (``RGLRU``) layer is (norm
-> temporal mixer -> residual) + (norm -> FFN -> residual), where the
FFN is a dense MLP or, on MoE layers, the MoE FFN; an SSD layer
(``SSM``) is the whole mixer-and-channel layer, (norm -> Mamba-2 block
-> residual), with no second norm or FFN.  Encoder-decoder attention
(``ENC_ATTN``) raises ``NotImplementedError`` naming ROADMAP D12.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, ENC_ATTN, LOCAL, RGLRU, SSM, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSMM
from repro_torch.models.common import apply_norm, mlp_apply, mlp_init, norm_init

#: ROADMAP items of the block kinds the port does not have.
_NOT_PORTED = {ENC_ATTN: "D12 (encoder-decoder attention)"}


def check_kind(kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported: ROADMAP {_NOT_PORTED[kind]}")
    if kind not in (ATTN, LOCAL, SSM, RGLRU):
        raise ValueError(kind)


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               moe_here: bool) -> dict:
    check_kind(kind)
    d = cfg.d_model
    p = {"ln1": norm_init(cfg, d, gen.device)}
    if kind == SSM:   # SSD blocks are the whole mixer+channel layer
        p["ssm"] = SSMM.ssm_init(gen, cfg)
        return p
    if kind == RGLRU:
        p["rglru"] = RG.rglru_init(gen, cfg)
    else:
        p["attn"] = A.attn_init(gen, cfg)
    p["ln2"] = norm_init(cfg, d, gen.device)
    if moe_here:
        p["moe"] = MOE.moe_init(gen, cfg, cfg.moe)
    else:
        p["mlp"] = mlp_init(gen, cfg, d, cfg.d_ff)
    return p


def _attn_kind(kind: str) -> str:
    return "local" if kind == LOCAL else "causal"


def _ffn(cfg: ModelConfig, p: dict, x, with_aux: bool = False):
    """The FFN half of a layer on its residual input x: (y, the MoE
    layer's load-balance aux loss or None)."""
    h = apply_norm(cfg, p["ln2"], x)
    if "moe" not in p:
        return mlp_apply(cfg, p["mlp"], h), None
    if with_aux:
        return MOE.moe_apply(cfg, cfg.moe, p["moe"], h, with_aux=True)
    return MOE.moe_apply(cfg, cfg.moe, p["moe"], h), None


def block_fullseq(cfg: ModelConfig, kind: str, p: dict, x,
                  positions) -> Tuple[torch.Tensor, dict]:
    """Prefill block application; returns (x, cache)."""
    check_kind(kind)
    h = apply_norm(cfg, p["ln1"], x)
    if kind == SSM:
        y, c = SSMM.ssm_fullseq(cfg, p["ssm"], h)
        return x + y, {"ssm": c}
    if kind == RGLRU:
        y, c = RG.rglru_fullseq(cfg, p["rglru"], h)
        cache = {"rglru": c}
    else:
        y, c = A.attention_fullseq(cfg, p["attn"], h, positions,
                                   _attn_kind(kind))
        cache = {"attn": c}
    x = x + y
    return x + _ffn(cfg, p, x)[0], cache


def block_train_check(kind: str) -> None:
    """Raise unless blocks of ``kind`` can train in the port."""
    check_kind(kind)
    if kind == SSM:
        raise NotImplementedError(
            "training through Mamba-2 SSD blocks is not ported: "
            "ROADMAP D14b")


def block_train(cfg: ModelConfig, kind: str, p: dict, x, positions
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Training block application (no cache), the reference's
    ``block_fullseq(..., "train")``: returns (x, the MoE layer's aux loss
    or None)."""
    block_train_check(kind)
    h = apply_norm(cfg, p["ln1"], x)
    if kind == RGLRU:
        y, _ = RG.rglru_fullseq(cfg, p["rglru"], h, return_cache=False)
    else:
        y = A.attention_train(cfg, p["attn"], h, positions, _attn_kind(kind))
    x = x + y
    y, aux = _ffn(cfg, p, x, with_aux=True)
    return x + y, aux


def block_decode(cfg: ModelConfig, kind: str, p: dict, x, cache: dict,
                 pos: int) -> Tuple[torch.Tensor, dict]:
    check_kind(kind)
    h = apply_norm(cfg, p["ln1"], x)
    if kind == SSM:
        y, c = SSMM.ssm_decode(cfg, p["ssm"], h, cache["ssm"])
        return x + y, {"ssm": c}
    if kind == RGLRU:
        y, c = RG.rglru_decode(cfg, p["rglru"], h, cache["rglru"])
        new_cache = {"rglru": c}
    else:
        y, c = A.attention_decode(cfg, p["attn"], h, cache["attn"], pos,
                                  _attn_kind(kind))
        new_cache = {"attn": c}
    x = x + y
    return x + _ffn(cfg, p, x)[0], new_cache
