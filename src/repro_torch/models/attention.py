"""GQA attention: global, local, bidirectional and cross; prefill, cached
decode and training.

Layouts, as in the reference:
  q:        (B, T, K, G, hd)   with H = K * G (G query groups per KV head)
  k, v:     (B, S, K, hd)
  caches:   global (B, K, S, hd) absolute-position slots;
            local  (B, K, W, hd) shift-ring (slot W-1 holds the newest).

Full-sequence attention always goes through the flash-attention kernel's
wrapper (the CUDA kernel on the card, its plain dense-softmax version on
the CPU); the reference's blockwise and windowed scans are its CPU
fallbacks and are covered by that plain version.  Decode attention is
plain torch (einsum, softmax, valid mask), as the reference computes it
outside any kernel.

Bidirectional attention (the whisper encoder's) and cross attention
(its decoder's, over the encoder output ``enc_out``) take the kernel
with ``causal=False``; a cross cache holds the S encoder positions'
K/V, static through decode.  Decode on a global cache writes the new
token's K/V at slot ``min(pos, S - 1)``: the reference's
``dynamic_update_slice`` clamps its start index, and its serving engine
prefills without headroom, so every decode step overwrites the last slot
(ROADMAP C6).

``REPRO_KV_INT8=1`` (read at each call, as the reference reads it at
each trace) stores the causal, local and cross caches in int8, the
reference's AR² adaptation: ``{"k", "k_s", "v", "v_s"}``, each
position's hd vector quantized on its own (``_quant_kv``: int8 data,
float32 scale (..., 1)).  Decode quantizes the new K/V row before it is
written, carries the scales through the local ring and the global
cache's clamped slot as it carries the data, and dequantizes the whole
cache to the activation dtype before the scores, as the reference's
plain path does.

Under a mesh, the heads are divided over "model" where it divides them
(``distributed.tensor_parallel``; :func:`_layout` reads the rule that
divides the weights a layer receives): the q, k and v projections are
column-parallel, the output projection row-parallel, its partial sums
added over "model"; where "model" divides the q heads but not the kv
heads, k and v are whole on every rank and each rank's q heads attend
to their own kv head (the reference's partitioner does the same).  The
cache leaves a prefill returns and a decode step takes are the serve
steps' DTensors, divided over "model" along the dim
``sharding.cache_leaf_spec`` picks (kv heads, slots or head dim), and
decode attends over a rank's shard (:func:`attention_decode`).

In the reference's flash mode (``REPRO_ATTN_IMPL=flash``,
:func:`seq_parallel_mode`; ROADMAP D15c-2b) a self-attention layer on
a sequence-divided stream (``seq=True``: x is this rank's T / model
rows) is context-parallel, as the reference's partitioner runs it
(:func:`_cp_qkv`): wq, wk, wv and wo whole on every rank (gathered over
"model" where the heads divide them), q, its rope and o at this rank's
rows and their absolute positions, k computed on the rows and gathered
over "model", and v likewise where "model" divides the kv heads, else
projected from the gathered stream (its gradients on the rows); B4
takes the rows' offset (``q_offset``), training's blockwise and
windowed scans their positions.  The prefill cache is cut from the
whole k and v as elsewhere (``tensor_parallel.to_cache``).

Under the dry-run's ``flash`` variant (``REPRO_ATTN_IMPL=flash`` and
``REPRO_OPAQUE_KERNELS=1``, :func:`repro_torch.kernels.opaque.flash_mode`)
training and decode attention call the reference's kernel stand-ins
where it does: training attention the flash stand-in (markers 101/103,
10000 + w; its backward 102/104, 20000 + w) in place of the blockwise
and windowed scans, decode attention the fused decode stand-in on the
updated cache (401; 402 on an int8 cache, passed with its scales and
not dequantized), for causal, local and cross layers alike.  Prefill
keeps B4's op, whose FLOP formula is the same markers'.  The stand-ins
have fake implementations only.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import opaque
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.opaque import seq_parallel_mode  # noqa: F401
from repro_torch.kernels.kv_retry.plain import quantize_pages
from repro_torch.models.common import init_dense, rmsnorm, rope, softcap

NEG = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": init_dense(gen, (d, H, hd)),
        "wk": init_dense(gen, (d, K, hd)),
        "wv": init_dense(gen, (d, K, hd)),
        "wo": init_dense(gen, (H, hd, d), in_dims=2),
    }
    if cfg.qk_norm:
        p["q_scale"] = torch.zeros((hd,), device=gen.device)
        p["k_scale"] = torch.zeros((hd,), device=gen.device)
    return p


def _proj(x, w):
    """einsum("btd,dnk->btnk"): x (B, T, d) by w (d, N, hd)."""
    d, n, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, n * hd)).reshape(
        x.shape[:-1] + (n, hd))


def _layout(cfg: ModelConfig):
    """This rank's share of the heads (``tensor_parallel.local``, the
    rule that divides the weights it receives): (K_l, G_l, kv).  Its q
    heads are K_l groups of G_l.  ``kv`` is None where k/v are this
    rank's own (whole, or its "model" shard of the kv heads alongside
    its q heads), else the indices of the kv heads its q heads read
    from whole k/v: q heads divided over "model" while the kv heads do
    not divide it (the reference's partitioner computes k/v whole and
    keeps each rank's q heads with their kv heads)."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    G = H // K
    H_l, K_l = TP.local(H), TP.local(K)
    if H_l == H or K_l < K:
        return K_l, G, None
    h0 = TP.shard_range(H_l)[0]
    if G % H_l == 0:
        return 1, H_l, [h0 // G]
    return H_l, 1, [h // G for h in range(h0, h0 + H_l)]


def _take_kv(kv, *caches):
    """The kv heads ``kv`` of whole (B, K, S, ...) caches; each as it is
    where ``kv`` is None."""
    if kv is None:
        return caches
    return tuple(c[:, kv] for c in caches)


def _project_qkv(cfg: ModelConfig, p, x, kv_x=None):
    """-> q (B,T,K_l,G_l,hd), k/v (B,S,K',hd) before rope; K and V
    project ``kv_x`` (cross attention's encoder output) where given,
    else x.  q holds this rank's heads (:func:`_layout`), k/v its kv
    heads where they are divided, else all K."""
    K_l, G_l, _ = _layout(cfg)
    q_div = TP.divided(cfg.n_heads)
    kv_div = TP.divided(cfg.n_kv_heads)
    # The column-parallel products take their input, replicated over
    # "model", through copy_to_model (its gradient summed over "model");
    # so does a replicated qk-norm scale on divided heads.
    xq = TP.copy_to_model(x) if q_div else x
    src = x if kv_x is None else kv_x
    if kv_div:
        src = xq if kv_x is None else TP.copy_to_model(kv_x)
    q = _proj(xq, p["wq"])
    k = _proj(src, p["wk"])
    v = _proj(src, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, TP.copy_to_model(p["q_scale"]) if q_div
                    else p["q_scale"])
        k = rmsnorm(k, TP.copy_to_model(p["k_scale"]) if kv_div
                    else p["k_scale"])
    B, T = q.shape[:2]
    return q.reshape(B, T, K_l, G_l, q.shape[-1]), k, v


def _merge_out(cfg: ModelConfig, p, o):
    """o (B,T,K_l,G_l,hd) -> (B,T,d): einsum("bthk,hkd->btd"), the
    ranks' partial sums added over "model" where the heads are
    divided (row-parallel)."""
    B, T = o.shape[:2]
    H, hd, d = p["wo"].shape
    o = o.reshape(B, T, H * hd)
    y = o @ p["wo"].to(o.dtype).reshape(H * hd, d)
    return TP.reduce_from_model(y) if TP.divided(cfg.n_heads) else y


#: The attention kinds: decoder self-attention (global, sliding-window),
#: the encoder's bidirectional attention, the decoder's cross attention.
_KINDS = ("causal", "local", "bidir", "cross")


def _kv_int8() -> bool:
    """Whether prefill stores the int8 KV cache (``REPRO_KV_INT8=1``)."""
    return os.environ.get("REPRO_KV_INT8", "0") == "1"


def _quant_kv(x):
    """x (..., hd) -> (int8 data (..., hd), float32 scales (..., 1)):
    per-vector symmetric quantization, the reference's ``_quant_kv``
    (the same arithmetic as ``quantize_pages``)."""
    q, s = quantize_pages(x.reshape(-1, x.shape[-1]))
    return q.view(x.shape), s.view(x.shape[:-1] + (1,))


def _dequant_kv(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _maybe_quantize_cache(cache: dict) -> dict:
    if not _kv_int8():
        return cache
    kq, ks = _quant_kv(cache["k"])
    vq, vs = _quant_kv(cache["v"])
    return {"k": kq, "k_s": ks, "v": vq, "v_s": vs}


def _roped_qkv(cfg: ModelConfig, p, x, positions, kind, enc_out=None,
               enc_positions=None):
    """q, k, v of ``kind`` with rope applied as the reference applies it
    (cross K/V, from ``enc_out``, unroped), and the keys' positions; k/v
    as projected (all kv heads where this rank's q heads read whole
    k/v: the prefill cache keeps them)."""
    if kind not in _KINDS:
        raise ValueError(kind)
    if (kind == "cross") != (enc_out is not None):
        raise ValueError("cross attention, and only it, takes enc_out")
    q, k, v = _project_qkv(cfg, p, x, kv_x=enc_out)
    q = rope(q.reshape(q.shape[:2] + (-1, q.shape[-1])), positions,
             cfg.rope_theta).reshape(q.shape)
    kv_pos = positions if enc_out is None else enc_positions
    if kind != "cross":
        k = rope(k, kv_pos, cfg.rope_theta)
    q = constrain(q, ("batch", None, "kv_heads", None, None))
    k = constrain(k, ("batch", None, "kv_heads", None))
    v = constrain(v, ("batch", None, "kv_heads", None))
    return q, k, v, kv_pos


def _whole_weights(cfg: ModelConfig, p):
    """The projections whole on every rank, each rank's own use (its
    rows of the sequence): a weight divided over "model" all-gathered
    (its gradient reduce-scattered back), a whole one and the qk-norm
    scales with their gradients summed over "model" (one all-reduce)."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    w = {n: TP.gather_own(p[n], dim) if TP.divided(heads) else p[n]
         for n, dim, heads in (("wq", 1, H), ("wk", 1, K), ("wv", 1, K),
                               ("wo", 0, H))}
    names = [n for n in ("wq", "wk", "wv", "wo", "q_scale", "k_scale")
             if n in p and (n not in w or w[n] is p[n])]
    if names:
        out = TP.copy_to_model(*(p[n] for n in names))
        w.update(zip(names, out if len(names) > 1 else (out,)))
    return w


def _cp_qkv(cfg: ModelConfig, p, x, positions):
    """Context-parallel q, k, v of a self-attention layer (the
    reference's flash mode): x (B, T_l, d) this rank's rows of the
    stream divided over "model", ``positions`` (T,) the whole sequence's.
    Returns (q (B, T_l, K, G, hd) at this rank's positions, k and v (B,
    T, K, hd) whole, every kv head, the whole weights, the rows'
    offset).  k is projected and roped on the rows and gathered; v
    likewise where "model" divides the kv heads, else projected from the
    gathered stream, as the reference's partitioner computes it (its
    gradients on the rows: ``tensor_parallel.gathered_product``)."""
    B, T_l = x.shape[:2]
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    off = TP.shard_range(T_l)[0]
    pos = positions[off:off + T_l]
    w = _whole_weights(cfg, p)
    q = _proj(x, w["wq"])
    k = _proj(x, w["wk"])
    if cfg.qk_norm:
        q = rmsnorm(q, w["q_scale"])
        k = rmsnorm(k, w["k_scale"])
    q = rope(q, pos, cfg.rope_theta).reshape(B, T_l, K, -1, hd)
    k = TP.gather_own(rope(k, pos, cfg.rope_theta), 1)
    if TP.divided(K):
        v = TP.gather_own(_proj(x, w["wv"]), 1)
    else:
        wv = w["wv"]
        v = TP.gathered_product(x, wv.to(x.dtype).reshape(wv.shape[0], -1))
        v = v.reshape(B, -1, K, hd)
    return q, k, v, w, off


def _cp_out(o, w):
    """o (B, T_l, K, G, hd) of every head at this rank's rows -> (B, T_l,
    d): the whole wo, no collective."""
    B, T_l = o.shape[:2]
    H, hd, d = w["wo"].shape
    return o.reshape(B, T_l, H * hd) @ w["wo"].to(o.dtype).reshape(H * hd, d)


def _core_kv(cfg: ModelConfig, k, v):
    """The k/v (B,S,K_l,hd) this rank's q heads attend to: k/v as they
    are, or the kv heads of :func:`_layout` taken from whole k/v, whose
    gradient the ranks' q heads each add to (summed over "model")."""
    kv = _layout(cfg)[2]
    if kv is None:
        return k, v
    return (TP.copy_to_model(k)[:, :, kv], TP.copy_to_model(v)[:, :, kv])


def attention_fullseq(cfg: ModelConfig, p: dict, x, positions, kind: str,
                      enc_out=None, enc_positions=None, seq: bool = False
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Prefill attention of ``kind`` over x (B, T, d); ``enc_out`` (B, S,
    d) and ``enc_positions`` (S,) for "cross".  Returns (y, cache): a
    global cache holds exactly the T prompt slots (no decode headroom,
    as the reference's serving engine asks), a cross cache the S encoder
    positions, and a bidirectional layer none; under ``REPRO_KV_INT8=1``
    the caches are int8 with their scales, quantized from whole rows.
    Under a mesh each cache leaf leaves as this rank's shard
    (``tensor_parallel.to_cache``): cut from its k/v, or moved from its
    kv heads by an all-to-all, never gathered whole.  With ``seq`` (a
    self-attention kind), x and y are this rank's rows of the
    sequence-divided stream and attention is context-parallel
    (:func:`_cp_qkv`): B4 over this rank's queries at their offset,
    against every key."""
    window = cfg.window if kind == "local" else None
    causal = kind in ("causal", "local")
    if seq:
        q, k, v, w, off = _cp_qkv(cfg, p, x, positions)
        o = flash_attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.attn_softcap, device=x.device,
                            q_offset=off)
        y = _cp_out(o, w)
    else:
        q, k, v, _ = _roped_qkv(cfg, p, x, positions, kind, enc_out,
                                enc_positions)
        kq, vq = _core_kv(cfg, k, v)
        o = flash_attention(q, kq, vq, causal=causal, window=window,
                            softcap=cfg.attn_softcap, device=x.device)
        y = _merge_out(cfg, p, o)
    if kind == "bidir":
        return y, None
    kc = k.transpose(1, 2)
    vc = v.transpose(1, 2)
    if kind == "local":
        w = cfg.window
        kc, vc = kc[:, :, -w:], vc[:, :, -w:]
        if kc.shape[2] < w:  # left-pad ring to full window
            pad = (0, 0, w - kc.shape[2], 0)
            kc = torch.nn.functional.pad(kc, pad)
            vc = torch.nn.functional.pad(vc, pad)
    cache = _maybe_quantize_cache({"k": kc.contiguous(), "v": vc.contiguous()})
    have = 1 if TP.divided(cfg.n_kv_heads) and not seq else None
    return y, {n: TP.to_cache(t, have) for n, t in cache.items()}


def _all_heads(cfg: ModelConfig, q):
    """q (B, 1, K_l, G_l, hd) of this rank's heads -> all H heads (B, 1,
    K, G, hd), gathered over "model" where the heads are divided (a
    rank's q heads are contiguous in both of :func:`_layout`'s forms)."""
    if not TP.divided(cfg.n_heads):
        return q
    B, hd = q.shape[0], q.shape[-1]
    K = cfg.n_kv_heads
    q = TP.gather_from_model(q.reshape(B, 1, -1, hd), 2)
    return q.reshape(B, 1, K, cfg.n_heads // K, hd)


def _own_heads(cfg: ModelConfig, o):
    """o (B, 1, K, G, hd) of all heads -> this rank's (B, 1, K_l, G_l,
    hd), the inverse of :func:`_all_heads`."""
    if not TP.divided(cfg.n_heads):
        return o
    B, hd = o.shape[0], o.shape[-1]
    K_l, G_l, _ = _layout(cfg)
    h0, h1 = TP.shard_range(TP.local(cfg.n_heads))
    return o.reshape(B, 1, -1, hd)[:, :, h0:h1].reshape(B, 1, K_l, G_l, hd)


def _new_row(cfg: ModelConfig, row, work: Optional[int]):
    """The new token's cache row (B, K', 1, ...) as the work layout
    ``work`` of its leaf needs it: this rank's kv heads (1), or all K
    heads (gathered where "model" divides them), whole or, at 3, this
    rank's part of the last dim."""
    if work == 1 or not TP.divided(cfg.n_kv_heads):
        full = row
    else:
        full = TP.gather_from_model(row, 1)
    return TP.relayout(full, None, 3) if work == 3 else full


def attention_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos: int,
                     kind: str) -> Tuple[torch.Tensor, dict]:
    """One decode step of ``kind`` "causal", "local" or "cross"; x (B, 1,
    d), pos the new token's absolute position.  Returns (y, new cache);
    the input cache is not modified, and a cross cache (static, every
    key valid) is returned as it came.  A cache with scales (``"k_s"``)
    is int8: the new row is quantized, and the cache dequantized before
    the scores (under the ``flash`` stand-ins, the decode stand-in takes
    it as it is).

    Under a mesh each leaf is a DTensor divided over "model" along the
    dim ``sharding.cache_leaf_spec`` picks (``tensor_parallel.
    cache_part``), and the new cache keeps each leaf's placements.  By
    the k/v leaves' dim: kv heads (1), as the weights divide them: each
    rank attends with its heads; none (no dim divides): whole k/v, each
    rank's q heads with their kv heads (:func:`_layout`); slots (2):
    every rank takes all q heads over its slots, the softmax's max and
    sum and the partial p.v all-reduced over "model", the new token
    written by the rank whose slots hold ``pos`` (clamped to the global
    S - 1, C6) and a window's shift moving one slot from each shard to
    the one before (a collective-permute); head dim (3): every rank's
    partial scores all-reduced, its part of p.v gathered.  An int8
    cache's scales are read in the k/v leaves' layout (whole where k/v
    divide their head dim), quantized from whole rows."""
    if kind not in ("causal", "local", "cross"):
        raise ValueError(kind)
    K_l, G_l, kv = _layout(cfg)
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)

    q = _proj(x, p["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_scale"])
    q = rope(q, positions, cfg.rope_theta).reshape(B, 1, K_l, G_l, hd)

    parts = {n: TP.cache_part(t) for n, t in cache.items()}
    dk = parts["k"].dim
    S = parts["k"].shape[2]
    work = {n: dk if n in ("k", "v") or dk in (1, 2) else None
            for n in parts}
    loc = {n: TP.relayout(pt.local, pt.dim, work[n])
           for n, pt in parts.items()}
    S_l = loc["k"].shape[2]
    first = TP.shard_range(S_l)[0] if dk == 2 else 0
    slots = first + torch.arange(S_l, device=x.device)
    int8 = "k_s" in cache
    if kind == "cross":
        new = loc
        valid = torch.ones((S_l,), dtype=torch.bool, device=x.device)
    else:
        knew = _proj(x, p["wk"])
        vnew = _proj(x, p["wv"])
        if cfg.qk_norm:
            knew = rmsnorm(knew, p["k_scale"])
        rows = {"k": rope(knew, positions, cfg.rope_theta).transpose(1, 2),
                "v": vnew.transpose(1, 2)}                # (B, K', 1, hd)
        if int8:
            for n in ("k", "v"):
                rows[n], rows[n + "_s"] = _quant_kv(rows[n])
        rows = {n: _new_row(cfg, r, work[n]) for n, r in rows.items()}
        new = {}
        if kind == "local":
            for n, t in loc.items():
                head = t[:, :, :1] if work[n] == 2 else rows[n]
                t = torch.cat([t[:, :, 1:], TP.from_next(head)
                               if work[n] == 2 else head], dim=2)
                if work[n] == 2 and first + S_l == S:   # the last shard
                    t[:, :, -1:] = rows[n]
                new[n] = t
            valid = slots >= (S - min(pos + 1, S))
        else:
            slot = min(max(pos, 0), S - 1)     # the reference's clamp (C6)
            for n, t in loc.items():
                new[n] = t.clone()
                off = TP.shard_range(t.shape[2])[0] if work[n] == 2 else 0
                if off <= slot < off + t.shape[2]:
                    new[n][:, :, slot - off] = rows[n][:, :, 0]
            valid = slots <= pos
    new_cache = {n: TP.cache_like(cache[n], t, work[n])
                 for n, t in new.items()} if kind != "cross" else cache
    ck, cv = new["k"], new["v"]
    scales = (new["k_s"], new["v_s"]) if int8 else None
    if opaque.flash_mode():
        return _merge_out(cfg, p, _flash_decode(cfg, q, ck, cv, scales,
                                                work, pos)), new_cache
    if int8:
        ck = _dequant_kv(ck, scales[0], x.dtype)
        cv = _dequant_kv(cv, scales[1], x.dtype)
    if dk in (None, 1):
        ck, cv = _take_kv(kv, ck, cv)
        return _merge_out(cfg, p, _decode_attend(cfg, q, ck, cv, valid)), \
            new_cache
    o = _decode_attend(cfg, _all_heads(cfg, q), ck, cv, valid, over=dk)
    return _merge_out(cfg, p, _own_heads(cfg, o)), new_cache


def _flash_decode(cfg: ModelConfig, q, ck, cv, scales, work, pos):
    """The fused decode stand-in as the reference's ``shard_map`` calls
    it (``repro/kernels/opaque.py:223-235``: q on ("batch", "act_seq",
    "kv_heads"), the cache on ("batch", "kv_heads", "kv_seq")): over
    this rank's kv heads where "model" divides them, else all q heads
    over this rank's slots where it divides those, else whole."""
    mg = TP.model_group()
    K, S = cfg.n_kv_heads, ck.shape[2] * (mg.size if work["k"] == 2 else 1)
    want = None if mg is None else (1 if K % mg.size == 0 else
                                    2 if S % mg.size == 0 else None)
    ck, cv = (TP.relayout(t, work["k"], want) for t in (ck, cv))
    if scales is not None:
        scales = tuple(TP.relayout(t, work["k_s"], want) for t in scales)
    if want == 1:
        return opaque.decode_attention(q, ck, cv, pos, scales)
    o = opaque.decode_attention(_all_heads(cfg, q), ck, cv, pos, scales)
    return _own_heads(cfg, o)


def _decode_attend(cfg: ModelConfig, q, ck, cv, valid, over=None):
    """One query token q (B, 1, K, G, hd) over a cache ck, cv (B, K, S,
    hd) where ``valid`` (S,) -> o (B, 1, K, G, hd).  ``over``: the cache
    dim divided over "model" (2: the slots, the softmax and p.v
    combined over "model"; 3: the head dim, this rank's part of q
    against it, the scores summed and p.v gathered over "model")."""
    hd = cfg.resolved_head_dim
    if over == 3:
        q = TP.relayout(q, None, 4)
    # s: (B, K, G, 1, S), products of the activation dtype's values
    # summed in float32.
    qf = q.float().permute(0, 2, 3, 1, 4)                 # (B,K,G,1,hd)
    s = torch.matmul(qf, ck.float()[:, :, None].transpose(-1, -2))
    if over == 3:
        s = TP.reduce_from_model(s)
    s = softcap(s * (hd ** -0.5), cfg.attn_softcap)
    s = torch.where(valid, s, NEG)
    w = (TP.softmax_over_model(s) if over == 2
         else torch.softmax(s, dim=-1)).to(q.dtype)
    o = torch.matmul(w, cv[:, :, None])                   # (B,K,G,1,hd)
    if over == 2:
        o = TP.reduce_from_model(o)
    elif over == 3:
        o = TP.gather_from_model(o, -1)
    return o.permute(0, 3, 1, 2, 4)


# -- training: the reference's blockwise and windowed attention -----------------


def _pad_to(x, mult: int, dim: int):
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _online_softmax_block(q, kb, vb, bias, scale, cap):
    """One (q-block, kv-block) tile; q (B,K,G,bq,hd), kb/vb (B,bk,K,hd).
    Scores are products of the activation dtype's values summed in
    float32; the probabilities meet V in V's dtype."""
    kf = kb.float().permute(0, 2, 3, 1)[:, :, None]         # (B,K,1,hd,bk)
    s = torch.matmul(q.float(), kf) * scale                  # (B,K,G,bq,bk)
    s = softcap(s, cap) + bias
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    lsum = p.sum(dim=-1)
    o = torch.matmul(p.to(vb.dtype), vb.permute(0, 2, 1, 3)[:, :, None])
    return m, lsum, o


def _bias(valid):
    return torch.where(valid, 0.0, NEG)


def blockwise_attention(cfg: ModelConfig, q, k, v, q_positions,
                        kv_positions, causal: bool, window=None,
                        bq: int = 512, bk: int = 1024):
    """Online-softmax attention over (bq, bk) tiles, the reference's
    ``blockwise_attention``: q (B,T,K,G,hd), k/v (B,S,K,hd), already
    roped; positions (T,), (S,) (negative: masked).  -> (B,T,K,G,hd)."""
    B, T, K, G, hd = q.shape
    S = k.shape[1]
    scale = hd ** -0.5
    bq, bk = min(bq, max(T, 1)), min(bk, max(S, 1))
    qp = _pad_to(q_positions, bq, 0)
    kp = _pad_to(torch.where(kv_positions < 0, -1, kv_positions), bk, 0)
    kp = torch.where(torch.arange(kp.shape[0], device=kp.device) < S, kp, -1)
    q_pad, k_pad, v_pad = _pad_to(q, bq, 1), _pad_to(k, bk, 1), \
        _pad_to(v, bk, 1)
    outs = []
    for i in range(q_pad.shape[1] // bq):
        qb = q_pad[:, i * bq:(i + 1) * bq].permute(0, 2, 3, 1, 4)
        qpos = qp[i * bq:(i + 1) * bq]
        m = torch.full((B, K, G, bq), NEG, device=q.device)
        lsum = torch.zeros((B, K, G, bq), device=q.device)
        acc = torch.zeros((B, K, G, bq, hd), device=q.device)
        for j in range(k_pad.shape[1] // bk):
            kpos = kp[j * bk:(j + 1) * bk]
            bias = _bias(kpos[None, :] >= 0)
            if causal:
                bias = bias + _bias(kpos[None, :] <= qpos[:, None])
            if window is not None:
                bias = bias + _bias(qpos[:, None] - kpos[None, :] < window)
            mb, lb, ob = _online_softmax_block(
                qb, k_pad[:, j * bk:(j + 1) * bk], v_pad[:, j * bk:(j + 1) * bk],
                bias, scale, cfg.attn_softcap)
            m_new = torch.maximum(m, mb)
            c_old, c_blk = torch.exp(m - m_new), torch.exp(mb - m_new)
            lsum = lsum * c_old + lb * c_blk
            acc = acc * c_old[..., None] + ob * c_blk[..., None]
            m = m_new
        out = acc / torch.clamp(lsum, min=1e-30)[..., None]
        outs.append(out.to(q.dtype).permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)[:, :T]


def windowed_attention(cfg: ModelConfig, q, k, v, q_positions,
                       causal_window: int, bq: int = 256,
                       q_offset: int = 0):
    """Sliding-window attention, the reference's ``windowed_attention``:
    q block i attends to the slice [i bq, i bq + window + bq) of the
    window-left-padded K/V, O(T window) work.  A context-parallel
    shard's queries (at positions ``q_offset`` on, ``q_positions``)
    take the slices at their offset of the whole K/V."""
    B, T, K, G, hd = q.shape
    S = k.shape[1]
    w = causal_window
    scale = hd ** -0.5
    bq = min(bq, T)
    q_pad = _pad_to(q, bq, 1)
    qp = _pad_to(q_positions, bq, 0)
    zeros = k.new_zeros((B, w, K, hd))
    k_pad, v_pad = torch.cat([zeros, k], dim=1), torch.cat([zeros, v], dim=1)
    kpos_full = torch.cat([
        torch.full((w,), -1, dtype=torch.int32, device=q.device),
        torch.arange(S, dtype=torch.int32, device=q.device)])
    span = w + bq
    outs = []
    for i in range(q_pad.shape[1] // bq):
        qb = q_pad[:, i * bq:(i + 1) * bq].permute(0, 2, 3, 1, 4)
        qpos = qp[i * bq:(i + 1) * bq]
        start = q_offset + i * bq
        kb, vb = k_pad[:, start:start + span], v_pad[:, start:start + span]
        kpos = kpos_full[start:start + span]
        if kb.shape[1] < span:    # the reference's dynamic_slice clamps
            start = k_pad.shape[1] - span
            kb, vb = k_pad[:, start:], v_pad[:, start:]
            kpos = kpos_full[start:]
        bias = _bias(kpos[None, :] >= 0) + \
            _bias(kpos[None, :] <= qpos[:, None]) + \
            _bias(qpos[:, None] - kpos[None, :] < w)
        _, lsum, o = _online_softmax_block(qb, kb, vb, bias, scale,
                                           cfg.attn_softcap)
        out = o / torch.clamp(lsum, min=1e-30)[..., None]
        outs.append(out.to(q.dtype).permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)[:, :T]


def attention_train(cfg: ModelConfig, p: dict, x, positions, kind: str,
                    enc_out=None, enc_positions=None, seq: bool = False):
    """Training attention of ``kind`` over x (B,T,d) (``enc_out``,
    ``enc_positions`` for "cross"): the reference's training path,
    blockwise (global, bidirectional, cross) or windowed (local) online
    softmax, differentiable by autograd.  No kernel runs here: flash
    attention stays the prefill's.  Under the dry-run's ``flash``
    stand-ins, the reference's flash stand-in and its backward instead.
    With ``seq``, context-parallel as :func:`attention_fullseq`: this
    rank's queries at their positions against every key."""
    if seq:
        q, k, v, w, off = _cp_qkv(cfg, p, x, positions)
        q_pos = positions[off:off + q.shape[1]]
        kv_pos = positions
    else:
        q, k, v, kv_pos = _roped_qkv(cfg, p, x, positions, kind, enc_out,
                                     enc_positions)
        k, v = _core_kv(cfg, k, v)
        q_pos, off = positions, 0
    if opaque.flash_mode():
        o = opaque.flash_attention(
            q, k, v, causal=kind in ("causal", "local"),
            window=cfg.window if kind == "local" else None)
    elif kind == "local":
        o = windowed_attention(cfg, q, k, v, q_pos, cfg.window,
                               q_offset=off)
    else:
        o = blockwise_attention(cfg, q, k, v, q_pos, kv_pos,
                                causal=kind == "causal")
    return _cp_out(o, w) if seq else _merge_out(cfg, p, o)
