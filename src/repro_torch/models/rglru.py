"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The reference's ``models/rglru.py`` restated in torch.  Block structure:

    x -> [gate branch: Linear(d->w) -> GeLU]
      -> [rec branch:  Linear(d->w) -> causal conv1d(K) -> RG-LRU]
    y = gate * rglru_out -> Linear(w->d)

The recurrence h_t = a_t h_{t-1} + b_t (a_t = exp(-c softplus(Lambda)
r_t), c = 8) runs in float32.  Prefill scans it with the reference's
``lax.associative_scan`` recursion restated on strided slices (pairs
combined, the halved sequence scanned, the odd results combined with
the even inputs, then interleaved): about 2 log2 T tensor steps, rounding
where the reference rounds.  Decode carries ``{"conv": (B, K-1, w),
"h": float32 (B, w)}`` and costs O(1) a token.  Dtypes and summation
orders are the reference's: the prefill conv sums its K products in the
activation dtype, left to right from 0; the decode conv is a product
summed in float32 and rounded once; the gates' w x w products are
float32.

Under a mesh (ROADMAP D15c-3), where "model" divides the width w, the
block runs on this rank's channels as the reference's partitioner runs
it (:func:`_divided`); the decode state (conv and h) stays divided
along w.  On the sequence-divided stream of the reference's flash mode
(``seq``, ROADMAP D15c-2b) the column-parallel w_gate and w_rec take
their input gathered over "model" and the row-parallel w_out
reduce-scatters its output; a block whose width "model" does not
divide runs on the gathered stream alike on every rank.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.common import gelu, init_dense, softplus

_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    K = cfg.rglru.d_conv
    dev = gen.device
    # Lambda so that a^c spans ~(0.9, 0.999) (Griffin appendix).
    u = torch.empty((w,), dtype=torch.float32, device=dev).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / (2.0 * _C)))  # inv-softplus
    conv_w = torch.empty((K, w), dtype=torch.float32, device=dev).normal_(
        0.0, 1.0, generator=gen) * 0.1
    return {
        "w_gate": init_dense(gen, (d, w)),
        "w_rec": init_dense(gen, (d, w)),
        "w_out": init_dense(gen, (w, d)),
        "conv_w": conv_w,
        "conv_b": torch.zeros((w,), device=dev),
        "lambda_p": lam,
        "a_gate": init_dense(gen, (w, w)),
        "x_gate": init_dense(gen, (w, w)),
        "a_gate_b": torch.zeros((w,), device=dev),
        "x_gate_b": torch.zeros((w,), device=dev),
    }


def _conv(x, w, b):
    """Causal depthwise conv; x (B, T, w), w (K, w).  Returns (conv + b,
    the last K - 1 inputs as the conv state)."""
    K = w.shape[0]
    T = x.shape[1]
    pad = torch.zeros(x.shape[:1] + (K - 1,) + x.shape[2:], dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = 0
    for i in range(K):                   # Python's sum: 0 + p0 + p1 + ...
        out = out + xp[:, i:i + T] * w[i].to(x.dtype)
    return out + b.to(x.dtype), xp[:, -(K - 1):]


def _gates(p, x, x_all):
    """x (B, T, w) -> (log_a, b) of the recurrence h = a h + b, float32.
    ``x_all``: the gates' input, x itself or, where x is this rank's
    channels of it, every channel (the gate products then this rank's
    columns).  The products are float32 whatever the weights' dtype (the
    reference's promotion)."""
    xf, xa = x.float(), x_all.float()
    r = torch.sigmoid(xa @ p["a_gate"].float() + p["a_gate_b"])
    i = torch.sigmoid(xa @ p["x_gate"].float() + p["x_gate_b"])
    log_a = -_C * softplus(p["lambda_p"]) * r
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return log_a, beta * (i * xf)


def _divided(cfg: ModelConfig, p: dict, x, seq: bool = False):
    """The block's layout under the active mesh: (the channels' layout,
    x into the column-parallel w_gate and w_rec, the weights with each
    replicated leaf at this rank's channels).  Where "model" divides the
    width w, w_gate and w_rec are column-parallel and w_out row-parallel
    (their shards this rank's), the conv and the recurrence run on this
    rank's channels, and the gates' w x w products (a_gate, x_gate: the
    reference replicates them) take the whole input to this rank's
    columns, as the reference's partitioner computes them.  With ``seq``,
    x is this rank's rows of the sequence-divided stream, made whole (for
    the column-parallel products, or for every rank alike)."""
    w = cfg.rglru.lru_width or cfg.d_model
    chans = TP.cols(w)
    if chans.alike:
        return chans, TP.gather_from_model(x, 1) if seq else x, p
    names = ("conv_b", "lambda_p", "a_gate_b", "x_gate_b", "a_gate",
             "x_gate")
    a, b = TP.shard_range(TP.local(w))
    q = dict(p)
    q.update(zip(names, (t[..., a:b] for t in TP.copy_to_model(
        *(p[n] for n in names)))))
    return chans, TP.column_input(x, seq), q


def _combine(a1, b1, a2, b2):
    return a1 * a2, b1 * a2 + b2


def _interleave(x, y):
    """Along dim 1: x at the even positions, y at the odd ones (x has as
    many entries as y or one more)."""
    n = y.shape[1]
    pairs = torch.stack([x[:, :n], y], dim=2).flatten(1, 2)
    return torch.cat([pairs, x[:, n:]], dim=1)


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0),
    by ``lax.associative_scan``'s recursion: returns (prod a, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = linear_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_fullseq(cfg: ModelConfig, p: dict, x, return_cache: bool = True,
                  seq: bool = False):
    """x (B, T, d) -> (y, cache or None); divided over "model" as
    :func:`_divided` says (``seq``: x and y this rank's rows of the
    sequence-divided stream)."""
    dt = x.dtype
    chans, x, p = _divided(cfg, p, x, seq)
    gate = gelu(x @ p["w_gate"].to(dt))
    u = x @ p["w_rec"].to(dt)
    u, conv_state = _conv(u, p["conv_w"], p["conv_b"])
    log_a, b = _gates(p, u, _all(chans, u))
    _, h = linear_scan(torch.exp(log_a), b)
    h = h.to(dt)
    y = _w_out(chans, p, gate * h, seq)
    if not return_cache:
        return y, None
    conv_dim, h_dim = _state_dims(chans)
    return y, {"conv": TP.to_cache(conv_state, conv_dim),
               "h": TP.to_cache(h[:, -1].float(), h_dim)}


def _state_dims(chans):
    """The dims of the conv state (B, K-1, w) and of h (B, w) divided
    over "model": the channels', or None (whole)."""
    return (None, None) if chans.alike else (2, 1)


def _all(chans, u):
    """The gates' input: u at every channel, each rank's own use (u
    itself where it is whole)."""
    return u if chans.alike else TP.gather_own(u, -1)


def _w_out(chans, p, v, seq: bool = False):
    """The row-parallel w_out: the ranks' partial sums added (``seq``:
    reduce-scattered to this rank's rows, or a whole block's output cut
    to them)."""
    y = v @ p["w_out"].to(v.dtype)
    if chans.alike:
        return TP.scatter_seq(y) if seq else y
    return TP.row_output(y, seq)


def rglru_decode(cfg: ModelConfig, p: dict, x, cache: dict):
    """x (B, 1, d); one O(1) recurrent step, divided over "model" as
    :func:`rglru_fullseq`; the conv state and h are read and kept at
    this rank's channels."""
    dt = x.dtype
    chans, x, p = _divided(cfg, p, x)
    conv_dim, h_dim = _state_dims(chans)
    gate = gelu(x @ p["w_gate"].to(dt))
    u = x @ p["w_rec"].to(dt)
    conv, h = (TP.relayout(*TP.cache_part(cache[n])[:2], d)
               for n, d in (("conv", conv_dim), ("h", h_dim)))
    window = torch.cat([conv.to(dt), u], dim=1)               # (B, K, w)
    # The reference's einsum over the K taps, summed in float32.
    u_t = (window.float() * p["conv_w"].to(dt).float()).sum(dim=1).to(dt) \
        + p["conv_b"].to(dt)
    u_t = u_t[:, None, :]
    log_a, b = _gates(p, u_t, _all(chans, u_t))
    h = h * torch.exp(log_a[:, 0]) + b[:, 0]
    y = _w_out(chans, p, gate * h[:, None, :].to(dt))
    return y, {"conv": TP.cache_like(cache["conv"], window[:, 1:],
                                     conv_dim),
               "h": TP.cache_like(cache["h"], h, h_dim)}
