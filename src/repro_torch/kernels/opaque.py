"""Kernel stand-ins for the dry-run: the reference's ``kernels/opaque.py``
as ``torch.library`` ops with fake implementations only.

The reference's dry-run replaces each Pallas kernel by one opaque
custom-call (a ``jax.pure_callback``) whose operands and results are the
kernel's, plus a marker output whose length names the kernel and its
static configuration; ``launch/hlo_cost.py`` charges each call its
operand and result bytes and an analytic FLOP count by marker.  Here
each stand-in is a custom op of the ``repro_torch`` namespace with:

  * a fake implementation (``register_fake``) giving the reference's
    result shapes and dtypes, so the dry-run traces it on fake tensors
    (``launch.dryrun``) and ``launch.cost`` counts its operands and
    results as one call's bytes and its FLOPs as ``kernel``;
  * a FLOP formula (``register_flop_formula``) equal to ``hlo_cost``'s
    count for its marker.  For the scan's markers that is the scan
    branch's formula, not the 0 that ``hlo_cost`` returns for them
    (ROADMAP C15);
  * for the forward ops, a backward (``register_autograd``) that calls
    the backward op on the forward's inputs, the reference's
    ``custom_vjp`` residuals;
  * no CPU or CUDA implementation: a call on real tensors raises
    ``NotImplementedError`` (the reference's host callback returns
    zeros; ROADMAP C16).

The static configuration (causal, window, chunk, int8) travels as op
arguments in place of the marker; :func:`flash_marker`,
:func:`decode_marker` and :func:`ssd_marker` give the marker a call
stands for.  The decode op takes ``valid_len`` as a Python int, where
the reference's custom-call takes an int32 scalar operand: its counted
bytes are 4 below the reference's.

The models route to the stand-ins where the reference does, under its
switches: :func:`flash_mode` (``REPRO_ATTN_IMPL=flash`` and
``REPRO_OPAQUE_KERNELS=1``) for training attention and decode
attention, :func:`ssd_mode` (``REPRO_PALLAS_SSD=opaque`` and
``REPRO_OPAQUE_KERNELS=1``) for the SSD scan in training.  Prefill keeps
B4's and B5's own ops, whose FLOP formulas are the same markers'.

Marker registry (as the reference's):
  101            flash attention fwd, causal
  102            flash attention bwd, causal
  103            flash attention fwd, bidirectional/cross
  104            flash attention bwd, bidirectional/cross
  401            fused decode attention, bf16 KV
  402            fused decode attention, int8 KV (the AR² fast read)
  10000 + w      windowed flash fwd, window w
  20000 + w      windowed flash bwd, window w
  30000 + L      ssd chunked scan fwd, chunk L
  40000 + L      ssd chunked scan bwd, chunk L
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

M_FLASH_FWD_CAUSAL = 101
M_FLASH_BWD_CAUSAL = 102
M_FLASH_FWD_FULL = 103
M_FLASH_BWD_FULL = 104
M_DECODE_BF16 = 401
M_DECODE_INT8 = 402
M_WINDOW_FWD_BASE = 10000
M_WINDOW_BWD_BASE = 20000
M_SSD_FWD_BASE = 30000
M_SSD_BWD_BASE = 40000

#: The stand-in ops, by name in the ``repro_torch`` namespace.
OPS = ("flash_attention_fwd_standin", "flash_attention_bwd_standin",
       "decode_attention_standin", "ssd_scan_fwd_standin",
       "ssd_scan_bwd_standin")


def opaque_mode() -> bool:
    """``REPRO_OPAQUE_KERNELS=1``: the dry-run's stand-ins are on."""
    return os.environ.get("REPRO_OPAQUE_KERNELS", "0") == "1"


def seq_parallel_mode() -> bool:
    """The reference's flash mode (``REPRO_ATTN_IMPL=flash``, read at each
    call as the reference reads it at each trace), on a real run as in
    the dry-run: the residual stream divided along the sequence over
    "model" and attention context-parallel (``models.blocks``,
    ``models.attention``; ROADMAP D15c-2b)."""
    return os.environ.get("REPRO_ATTN_IMPL", "blockwise") == "flash"


def flash_mode() -> bool:
    """Training and decode attention run the stand-ins
    (:func:`seq_parallel_mode` with :func:`opaque_mode`)."""
    return seq_parallel_mode() and opaque_mode()


def ssd_mode() -> bool:
    """The SSD scan in training runs the stand-ins
    (``REPRO_PALLAS_SSD=opaque`` with :func:`opaque_mode`)."""
    return os.environ.get("REPRO_PALLAS_SSD", "auto") == "opaque" and \
        opaque_mode()


def flash_marker(causal: bool, window: Optional[int], bwd: bool) -> int:
    if window is not None:
        return (M_WINDOW_BWD_BASE if bwd else M_WINDOW_FWD_BASE) + window
    if causal:
        return M_FLASH_BWD_CAUSAL if bwd else M_FLASH_FWD_CAUSAL
    return M_FLASH_BWD_FULL if bwd else M_FLASH_FWD_FULL


def decode_marker(int8: bool) -> int:
    return M_DECODE_INT8 if int8 else M_DECODE_BF16


def ssd_marker(chunk: int, bwd: bool) -> int:
    return (M_SSD_BWD_BASE if bwd else M_SSD_FWD_BASE) + chunk


def marker_flops(marker: int, shape0, shape1) -> int:
    """``hlo_cost._opaque_kernel_cost``'s FLOPs for ``marker`` with first
    and second operand shapes ``shape0`` and ``shape1``: flash q (B, T,
    K, G, hd) and k (B, S, K, hd); decode q (B, 1, K, G, hd) and ck (B,
    K, S, hd); scan x (B, T, nh, hd) and Bm (B, T, ds).  The scan's
    markers take the scan branch (C15)."""
    if marker in (M_DECODE_BF16, M_DECODE_INT8):
        B, _, K, G, hd = shape0
        return 4 * B * K * G * hd * shape1[2]
    if marker >= M_SSD_FWD_BASE:
        B, T, nh, hd = shape0
        ds, L = shape1[-1], marker % 10000
        fwd = B * nh * T * (2 * L * (ds + hd) + 4 * ds * hd)
        return fwd * (3 if marker >= M_SSD_BWD_BASE else 1)
    B, T, K, G, hd = shape0
    S = shape1[1]
    if marker >= M_WINDOW_FWD_BASE:
        fwd = 4 * B * T * K * G * hd * min(marker % 10000, S)
        bwd = marker >= M_WINDOW_BWD_BASE
    else:
        fwd = 4 * B * T * K * G * hd * S // (2 if marker in (
            M_FLASH_FWD_CAUSAL, M_FLASH_BWD_CAUSAL) else 1)
        bwd = marker in (M_FLASH_BWD_CAUSAL, M_FLASH_BWD_FULL)
    # fwd is even, so 2.5 x fwd is exact.
    return fwd * 5 // 2 if bwd else fwd


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd_standin(Tensor q, Tensor k, Tensor v, "
            "bool causal, int? window) -> Tensor")
_LIB.define("flash_attention_bwd_standin(Tensor q, Tensor k, Tensor v, "
            "Tensor g, bool causal, int? window) -> (Tensor, Tensor, Tensor)")
_LIB.define("decode_attention_standin(Tensor q, Tensor ck, Tensor cv, "
            "Tensor? k_s, Tensor? v_s, int valid_len) -> Tensor")
_LIB.define("ssd_scan_fwd_standin(Tensor x, Tensor Bm, Tensor Cm, "
            "Tensor dt, Tensor A, int chunk) -> (Tensor, Tensor)")
_LIB.define("ssd_scan_bwd_standin(Tensor x, Tensor Bm, Tensor Cm, "
            "Tensor dt, Tensor A, Tensor g_y, int chunk) -> "
            "(Tensor, Tensor, Tensor, Tensor, Tensor)")
_ops = torch.ops.repro_torch


@torch.library.register_fake("repro_torch::flash_attention_fwd_standin",
                             lib=_LIB)
def _(q, k, v, causal, window):
    return q.new_empty(q.shape)


@torch.library.register_fake("repro_torch::flash_attention_bwd_standin",
                             lib=_LIB)
def _(q, k, v, g, causal, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@torch.library.register_fake("repro_torch::decode_attention_standin",
                             lib=_LIB)
def _(q, ck, cv, k_s, v_s, valid_len):
    return q.new_empty(q.shape)


@torch.library.register_fake("repro_torch::ssd_scan_fwd_standin", lib=_LIB)
def _(x, Bm, Cm, dt, A, chunk):
    B, _, nh, hd = x.shape
    return (x.new_empty(x.shape),
            x.new_empty((B, nh, hd, Bm.shape[-1]), dtype=torch.float32))


@torch.library.register_fake("repro_torch::ssd_scan_bwd_standin", lib=_LIB)
def _(x, Bm, Cm, dt, A, g_y, chunk):
    return tuple(t.new_empty(t.shape) for t in (x, Bm, Cm, dt, A))


@register_flop_formula(_ops.flash_attention_fwd_standin)
def _(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
    return marker_flops(flash_marker(causal, window, False), q_shape,
                        k_shape)


@register_flop_formula(_ops.flash_attention_bwd_standin)
def _(q_shape, k_shape, v_shape, g_shape, causal, window, *args,
      **kwargs) -> int:
    return marker_flops(flash_marker(causal, window, True), q_shape, k_shape)


@register_flop_formula(_ops.decode_attention_standin)
def _(q_shape, ck_shape, cv_shape, ks_shape, vs_shape, valid_len, *args,
      **kwargs) -> int:
    return marker_flops(decode_marker(ks_shape is not None), q_shape,
                        ck_shape)


@register_flop_formula(_ops.ssd_scan_fwd_standin)
def _(x_shape, bm_shape, cm_shape, dt_shape, a_shape, chunk, *args,
      **kwargs) -> int:
    return marker_flops(ssd_marker(chunk, False), x_shape, bm_shape)


@register_flop_formula(_ops.ssd_scan_bwd_standin)
def _(x_shape, bm_shape, cm_shape, dt_shape, a_shape, gy_shape, chunk,
      *args, **kwargs) -> int:
    return marker_flops(ssd_marker(chunk, True), x_shape, bm_shape)


def _flash_setup(ctx, inputs, output):
    q, k, v, ctx.causal, ctx.window = inputs
    ctx.save_for_backward(q, k, v)


def _flash_backward(ctx, g):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = _ops.flash_attention_bwd_standin(q, k, v, g, ctx.causal,
                                                  ctx.window)
    return dq, dk, dv, None, None


torch.library.register_autograd("repro_torch::flash_attention_fwd_standin",
                                _flash_backward, setup_context=_flash_setup,
                                lib=_LIB)


def _ssd_setup(ctx, inputs, output):
    *res, ctx.chunk = inputs
    ctx.save_for_backward(*res)
    # H's gradient is not an operand of the backward (the reference's
    # bwd takes y's only): leave it unmade.
    ctx.set_materialize_grads(False)


def _ssd_backward(ctx, g_y, g_H):
    grads = _ops.ssd_scan_bwd_standin(*ctx.saved_tensors, g_y, ctx.chunk)
    return (*grads, None)


torch.library.register_autograd("repro_torch::ssd_scan_fwd_standin",
                                _ssd_backward, setup_context=_ssd_setup,
                                lib=_LIB)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int] = None
                    ) -> torch.Tensor:
    """The reference's ``make_flash_opaque(causal, window)(q, k, v)``: q
    (B, T, K, G, hd), k and v (B, S, K, hd) -> o like q; its backward is
    the backward stand-in."""
    return _ops.flash_attention_fwd_standin(
        q, k, v, causal, None if window is None else int(window))


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     valid_len: int, scales=None) -> torch.Tensor:
    """The reference's ``decode_attention_opaque``: q (B, 1, K, G, hd) over
    a cache ck, cv (B, K, S, hd) -> o like q; an int8 cache comes with
    its scales (k_s, v_s), each (B, K, S, 1), undequantized."""
    k_s, v_s = (None, None) if scales is None else scales
    return _ops.decode_attention_standin(q, ck, cv, k_s, v_s, int(valid_len))


def ssd_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, *, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``make_ssd_opaque(chunk)(x, Bm, Cm, dt, A)``: x (B,
    T, nh, hd), Bm and Cm (B, T, ds), dt (B, T, nh), A (nh,) -> (y like
    x, H (B, nh, hd, ds) float32); its backward is the backward
    stand-in."""
    y, H = _ops.ssd_scan_fwd_standin(x, Bm, Cm, dt, A, int(chunk))
    return y, H
