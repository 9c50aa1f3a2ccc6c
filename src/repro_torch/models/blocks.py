"""Residual block dispatch: one init/apply pair per block kind.

An attention (``ATTN``, ``LOCAL``) or RG-LRU (``RGLRU``) layer is (norm
-> temporal mixer -> residual) + (norm -> FFN -> residual), where the
FFN is a dense MLP or, on MoE layers, the MoE FFN; an SSD layer
(``SSM``) is the whole mixer-and-channel layer, (norm -> Mamba-2 block
-> residual), with no second norm or FFN.  The whisper encoder's layers
(``ENC_ATTN``) attend bidirectionally; its decoder's layers add a cross
sub-block (``lnx``, ``xattn``: norm -> cross attention over the encoder
output -> residual) after the self-attention residual.

``seq`` (the prefill and training blocks): the residual stream is this
rank's T / model rows, the reference's sequence-parallel stream of its
flash mode (``_sp``, ROADMAP D15c-2b; the backbone decides it,
``models.lm``).  Norms and residual adds run on the rows, their scales'
gradients summed over "model"; self-attention is context-parallel
(``models.attention``), the dense MLP's and RG-LRU's column-parallel
products take the rows gathered over "model" and their row-parallel
products reduce-scatter back to them; the MoE FFN and the cross
sub-block run on the gathered stream as on a whole one, their output
cut back to the rows (:func:`_on_whole`).  An SSD layer never takes a
divided stream: the reference's SSD blocks return before ``_sp``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, ENC_ATTN, LOCAL, RGLRU, SSM, ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSMM
from repro_torch.models.common import apply_norm, mlp_apply, mlp_init, norm_init

#: The attention kind of each attention block kind.
_ATTN_KINDS = {ATTN: "causal", LOCAL: "local", ENC_ATTN: "bidir"}


def _norm(cfg: ModelConfig, p: dict, x, seq: bool):
    """A norm of the stream; on this rank's rows (``seq``) its scale and
    bias are each rank's own use, their gradients summed over "model"."""
    if seq and TP.model_group() is not None:
        vals = TP.copy_to_model(*p.values())
        p = dict(zip(p, vals if len(p) > 1 else (vals,)))
    return apply_norm(cfg, p, x)


def _on_whole(fn, h, seq: bool):
    """``fn(h)`` -> y or (y, extra), on the whole stream: with ``seq``, h
    (this rank's rows) gathered over "model" for a computation every
    rank does alike, and y cut back to this rank's rows."""
    if not seq:
        return fn(h)
    out = fn(TP.gather_from_model(h, 1))
    if isinstance(out, tuple):
        return (TP.scatter_seq(out[0]),) + tuple(out[1:])
    return TP.scatter_seq(out)


def check_kind(kind: str) -> None:
    if kind not in (*_ATTN_KINDS, SSM, RGLRU):
        raise ValueError(kind)


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               moe_here: bool, cross: bool = False) -> dict:
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
    if cross:
        p["lnx"] = norm_init(cfg, d, gen.device)
        p["xattn"] = A.attn_init(gen, cfg)
    p["ln2"] = norm_init(cfg, d, gen.device)
    if moe_here:
        p["moe"] = MOE.moe_init(gen, cfg, cfg.moe)
    else:
        p["mlp"] = mlp_init(gen, cfg, d, cfg.d_ff)
    return p


def _cross(cfg: ModelConfig, p: dict, x, positions, enc_out, enc_positions,
           train: bool = False, seq: bool = False):
    """The cross sub-block of a decoder layer on its residual input x:
    (x plus cross attention over ``enc_out``, the cross cache or None)."""
    h = _norm(cfg, p["lnx"], x, seq)
    if train:
        return x + _on_whole(lambda t: A.attention_train(
            cfg, p["xattn"], t, positions, "cross", enc_out, enc_positions),
            h, seq), None
    y, c = _on_whole(lambda t: A.attention_fullseq(
        cfg, p["xattn"], t, positions, "cross", enc_out, enc_positions),
        h, seq)
    return x + y, c


def _ffn(cfg: ModelConfig, p: dict, x, with_aux: bool = False,
         seq: bool = False):
    """The FFN half of a layer on its residual input x: (y, the MoE
    layer's load-balance aux loss or None)."""
    h = _norm(cfg, p["ln2"], x, seq)
    if "moe" not in p:
        return mlp_apply(cfg, p["mlp"], h, seq=seq), None
    if with_aux:
        return _on_whole(lambda t: MOE.moe_apply(
            cfg, cfg.moe, p["moe"], t, with_aux=True), h, seq)
    return _on_whole(lambda t: MOE.moe_apply(cfg, cfg.moe, p["moe"], t),
                     h, seq), None


def block_fullseq(cfg: ModelConfig, kind: str, p: dict, x, positions,
                  enc_out=None, enc_positions=None, seq: bool = False
                  ) -> Tuple[torch.Tensor, dict]:
    """Prefill block application (``enc_out``, ``enc_positions``: the
    encoder output a cross sub-block attends to; ``seq``: x this rank's
    rows of the sequence-divided stream, ``positions`` the whole
    sequence's); returns (x, cache), which is empty for an encoder
    layer."""
    check_kind(kind)
    h = _norm(cfg, p["ln1"], x, seq)
    if kind == SSM:
        y, c = SSMM.ssm_fullseq(cfg, p["ssm"], h)
        return x + y, {"ssm": c}
    if kind == RGLRU:
        y, c = RG.rglru_fullseq(cfg, p["rglru"], h, seq=seq)
        cache = {"rglru": c}
    else:
        y, c = A.attention_fullseq(cfg, p["attn"], h, positions,
                                   _ATTN_KINDS[kind], seq=seq)
        cache = {} if c is None else {"attn": c}
    x = x + y
    if "xattn" in p:
        x, cache["xattn"] = _cross(cfg, p, x, positions, enc_out,
                                   enc_positions, seq=seq)
    return x + _ffn(cfg, p, x, seq=seq)[0], cache


def block_train(cfg: ModelConfig, kind: str, p: dict, x, positions,
                enc_out=None, enc_positions=None, seq: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Training block application (no cache), the reference's
    ``block_fullseq(..., "train")``: returns (x, the MoE layer's aux loss
    or None); ``seq`` as :func:`block_fullseq`.  An SSD layer trains
    through the plain scan by autograd."""
    check_kind(kind)
    h = _norm(cfg, p["ln1"], x, seq)
    if kind == SSM:
        y, _ = SSMM.ssm_fullseq(cfg, p["ssm"], h, return_cache=False)
        return x + y, None
    if kind == RGLRU:
        y, _ = RG.rglru_fullseq(cfg, p["rglru"], h, return_cache=False,
                                seq=seq)
    else:
        y = A.attention_train(cfg, p["attn"], h, positions,
                              _ATTN_KINDS[kind], seq=seq)
    x = x + y
    if "xattn" in p:
        x, _ = _cross(cfg, p, x, positions, enc_out, enc_positions,
                      train=True, seq=seq)
    y, aux = _ffn(cfg, p, x, with_aux=True, seq=seq)
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
                                  _ATTN_KINDS[kind])
        new_cache = {"attn": c}
    x = x + y
    if "xattn" in p:
        h = apply_norm(cfg, p["lnx"], x)
        y, new_cache["xattn"] = A.attention_decode(
            cfg, p["xattn"], h, cache["xattn"], pos, "cross")
        x = x + y
    return x + _ffn(cfg, p, x)[0], new_cache
