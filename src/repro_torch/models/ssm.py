"""Mamba-2 SSD (state-space duality) block: chunked prefill, recurrent
decode.

The reference's ``models/ssm.py`` restated in torch (Dao & Gu,
arXiv:2405.21060): in_proj -> [z | xBC | dt], a causal depthwise conv
over xBC, a scalar-decay SSM per head (A scalar per head, B and C shared
across heads, ngroups = 1), gated RMSNorm, out_proj.  Prefill runs the
chunked scan through the ``ssd_scan`` kernel's entry (the CUDA kernel on
the card, its plain version on the CPU, which also stands for the
reference's non-kernel ``ssd_chunked``).  Decode carries (conv state,
ssm state) and costs O(1) a token, in plain torch as in the reference.
Dtypes and summation orders are the reference's: the prefill conv sums
its K products in the activation dtype, left to right from 0; the
decode conv is a product summed in float32 and rounded once.  Training
(``return_cache=False``) runs the reference's training mode: the chunked
scan as the plain torch version on every device, differentiated by
autograd, as the reference differentiates its non-kernel
``ssd_chunked``; the kernel has no backward and stays the prefill's.
Under the dry-run's ``ssdk`` variant (``REPRO_PALLAS_SSD=opaque`` and
``REPRO_OPAQUE_KERNELS=1``, :func:`repro_torch.kernels.opaque.ssd_mode`)
training calls the reference's scan stand-in (markers 30000 + L, its
backward 40000 + L) in place of the plain scan.  The cache
is ``{"conv": (B, K-1, C) activation dtype, "ssm": (B, nh, hd, ds)
float32}``.

Under a mesh (ROADMAP D15c-3) each product is divided over "model"
where "model" divides its dim, as the reference's partitioner divides
it from the weights' placements (``distributed.tensor_parallel``):
in_proj by its packed columns, whose shards one all-to-all takes to the
layouts below (z by rows of d_inner, xBC by conv channels, dt by
heads); the conv by channels; the scan by heads (B and C whole on every
rank: one group), the gated norm's sum of squares over d_inner summed
over "model"; out_proj by rows, its partial sums added.  The replicated
leaves (conv_b, dt_bias, a_log, d_skip, norm_scale) are sliced to the
dims they serve.  The cache leaves stay divided along the dims the
serve steps divide them by (channels; d_state for the SSM state).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import opaque
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.common import init_dense, rmsnorm, softplus


def ssm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di, nh, ds = s.d_inner(d), s.n_heads(d), s.d_state
    conv_dim = di + 2 * ds                       # xBC channels
    dev = gen.device
    in_proj = init_dense(gen, (d, 2 * di + 2 * ds + nh))
    conv_w = torch.empty((s.d_conv, conv_dim), dtype=torch.float32,
                         device=dev).normal_(0.0, 1.0, generator=gen) * 0.1
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba default).
    u = torch.rand((nh,), dtype=torch.float32, device=dev, generator=gen)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt0 = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))   # inverse softplus
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "a_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "dt_bias": dt_bias,
        "d_skip": torch.ones((nh,), device=dev),
        "norm_scale": torch.zeros((di,), device=dev),
        "out_proj": init_dense(gen, (di, d)),
    }


def _dims(cfg: ModelConfig):
    """(di, ds, nh, C): inner width, state width, heads, conv channels."""
    s = cfg.ssm
    di, ds = s.d_inner(cfg.d_model), s.d_state
    return di, ds, s.n_heads(cfg.d_model), di + 2 * ds


class _Layout(NamedTuple):
    """The block's layouts under the active mesh, each the
    ``tensor_parallel.Cols`` of a last dim: in_proj's packed columns (z |
    xBC | dt); the rows of di (z, the gated norm's and out_proj's); xBC
    by conv channels (the conv's), as in_proj's columns and as its own;
    dt by the scan's heads, and whole on each rank (decode's); the
    conv's output as the scan takes it (x by heads, B and C whole on
    every rank; whole where the heads are) and the scan's output; the
    conv channels and the rows of di whole; and the replicated leaves
    cut to the divided dims they serve (name, dim)."""
    proj: TP.Cols
    rows: TP.Cols
    xbc: TP.Cols
    chans: TP.Cols
    dt: TP.Cols
    dt_each: TP.Cols
    scan_in: TP.Cols
    scan_out: TP.Cols
    whole_chans: TP.Cols
    whole_rows: TP.Cols
    cut: tuple


def _layout(cfg: ModelConfig) -> _Layout:
    """The block's layouts under the active mesh, built once a config
    and "model" size."""
    return _layout_for(*_dims(cfg), TP.model_size())


@functools.lru_cache(maxsize=None)
def _layout_for(di: int, ds: int, nh: int, C: int, size: int) -> _Layout:
    """:func:`_layout` for a "model" group of ``size`` ranks (the active
    one's: ``size`` keys the cache)."""
    heads = TP.divided(nh)
    rows = TP.cols(di)
    dims = {"conv_b": C, "dt_bias": nh, "a_log": nh, "d_skip": nh,
            "norm_scale": di}
    return _Layout(
        proj=TP.cols(di + C + nh), rows=rows, xbc=TP.cols(C, di),
        chans=TP.cols(C),
        dt=TP.cols(nh, di + C), dt_each=TP.each(nh, di + C),
        scan_in=TP.join(TP.cols(di), TP.each(2 * ds, di)) if heads
        else TP.whole(C),
        scan_out=rows if heads else TP.whole(di),
        whole_chans=TP.whole(C), whole_rows=TP.whole(di),
        cut=tuple((n, k) for n, k in dims.items() if TP.divided(k)))


def _split_proj(p, u, L: _Layout, dt: TP.Cols):
    """in_proj -> (z, xBC, dt) in the layouts ``L.rows``, ``L.xbc``
    and ``dt``.  Where "model" divides in_proj's packed columns, the
    product is column-parallel and one all-to-all
    (``tensor_parallel.regroup``) takes each rank's columns to those
    layouts; where it does not, each rank slices its own."""
    if not L.proj.alike:
        u = TP.copy_to_model(u)
    zxbcdt = u @ p["in_proj"].to(u.dtype)
    return TP.regroup(zxbcdt, L.proj, L.rows, L.xbc, dt)


def _dim(layout: TP.Cols, dim: int):
    """``dim`` where ``layout`` is divided over "model", else None."""
    return None if layout.alike else dim


def _causal_conv(xBC, w, b):
    """Depthwise causal conv along the sequence.  xBC (B, T, C); w (K, C).
    Returns (silu(conv + b), the last K - 1 inputs as the conv state)."""
    K = w.shape[0]
    T = xBC.shape[1]
    pad = torch.zeros(xBC.shape[:1] + (K - 1,) + xBC.shape[2:],
                      dtype=xBC.dtype, device=xBC.device)
    xp = torch.cat([pad, xBC], dim=1)
    out = 0
    for i in range(K):                   # Python's sum: 0 + p0 + p1 + ...
        out = out + xp[:, i:i + T] * w[i].to(xBC.dtype)
    out = F.silu(out + b.to(xBC.dtype))
    return out, xp[:, -(K - 1):]


def _replicated(p, L: _Layout):
    """The weights with each replicated leaf of ``L.cut`` at this rank's
    slice of the divided dim it serves (``copy_to_model`` first: their
    gradients are the ranks' parts, summed): conv_b at the conv
    channels, dt_bias, a_log and d_skip at the heads, norm_scale at the
    rows of di."""
    if not L.cut:
        return p
    out = dict(p)
    for (n, k), t in zip(L.cut, TP.copy_to_model(*(p[n] for n, _ in L.cut))):
        a, b = TP.shard_range(TP.local(k))
        out[n] = t[a:b]
    return out


def _heads(cfg: ModelConfig, xBC, dt, r):
    """xBC (x by heads, then B and C whole) -> the scan's inputs at this
    rank's heads."""
    s = cfg.ssm
    ds = s.d_state
    x = xBC[..., :-2 * ds]
    Bm = xBC[..., -2 * ds:-ds]                        # (B, T, ds)
    Cm = xBC[..., -ds:]                               # (B, T, ds)
    x = x.reshape(x.shape[0], x.shape[1], -1, s.head_dim)
    dt = softplus(dt.float() + r["dt_bias"])         # (B, T, nh)
    A = -torch.exp(r["a_log"])                        # (nh,) negative
    return x, Bm, Cm, dt, A


def _out(cfg: ModelConfig, p, L: _Layout, y, z):
    """Gated RMSNorm and out_proj of y, z (B, T, rows of di).  Where
    "model" divides di, y and z are this rank's rows: the norm's sum of
    squares is summed over "model" and out_proj is row-parallel."""
    if L.rows.alike:
        y = rmsnorm(y * F.silu(z), p["norm_scale"])
        return y @ p["out_proj"].to(y.dtype)
    di, dt = _dims(cfg)[0], y.dtype
    v = (y * F.silu(z)).float()
    ss = TP.copy_to_model(TP.reduce_from_model(
        (v * v).sum(dim=-1, keepdim=True)))
    v = v * torch.rsqrt(ss / di + 1e-6)
    v = (v * (1.0 + p["norm_scale"].float())).to(dt)
    return TP.reduce_from_model(v @ p["out_proj"].to(dt))


def ssm_fullseq(cfg: ModelConfig, p: dict, u, return_cache: bool = True):
    """Full-sequence SSD block.  u (B, T, d) -> (out, cache); without
    ``return_cache`` (training: the plain scan, by autograd, or the
    dry-run's scan stand-in) the cache is None.  Under a mesh, each
    product is divided over "model" where it divides the product's dim
    (``tensor_parallel.cols``): in_proj by columns, the conv by
    channels, the scan by heads, out_proj by rows."""
    s = cfg.ssm
    L = _layout(cfg)
    r = _replicated(p, L)
    z, xBC, dt = _split_proj(p, u, L, L.dt)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], r["conv_b"])
    xBC = TP.regroup(xBC, L.chans, L.scan_in)
    x, Bm, Cm, dtv, A = _heads(cfg, xBC, dt, r)
    if not return_cache and opaque.ssd_mode():
        y, H = opaque.ssd_scan(x, Bm, Cm, dtv, A, chunk=s.chunk)
    else:
        y, H = ssd_scan(x, Bm, Cm, dtv, A, chunk=s.chunk, device=x.device,
                        training=not return_cache)
    y = y + x * r["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(y.shape[0], y.shape[1], -1)
    out = _out(cfg, r, L, TP.regroup(y, L.scan_out, L.rows), z)
    if not return_cache:
        return out, None
    return out, {"conv": TP.to_cache(conv_state, _dim(L.chans, 2)),
                 "ssm": TP.to_cache(H, _dim(L.scan_out, 1))}


def ssm_decode(cfg: ModelConfig, p: dict, u, cache: dict):
    """Single-token recurrent step.  u (B, 1, d).  Under a mesh the
    products are divided as in :func:`ssm_fullseq`; the conv state is
    read at this rank's channels, and the SSM state stays on the dim
    the serve steps divide it along (``cache_leaf_spec``: d_state
    where "model" divides it): the step runs on that slice with x, dt,
    B and C whole, and C.H's partial sums over d_state are summed over
    "model", as the reference's partitioner divides its decode."""
    s = cfg.ssm
    di, ds, nh, _ = _dims(cfg)
    L = _layout(cfg)
    r = _replicated(p, L)
    z, xBC, dt = _split_proj(p, u, L, L.dt_each)
    conv_dim = _dim(L.chans, 2)
    conv = TP.relayout(*TP.cache_part(cache["conv"])[:2], conv_dim)
    # Conv ring update: the reference's einsum, summed in float32.
    window = torch.cat([conv.to(xBC.dtype), xBC], dim=1)   # (B, K, C)
    w = p["conv_w"].to(xBC.dtype)
    out = (window.float() * w.float()).sum(dim=1).to(xBC.dtype) \
        + r["conv_b"].to(xBC.dtype)
    xBC_t = TP.regroup(F.silu(out)[:, None, :], L.chans, L.whole_chans)

    x = xBC_t[..., :di].reshape(xBC_t.shape[0], 1, nh, s.head_dim)
    Bm, Cm = xBC_t[..., di:di + ds], xBC_t[..., di + ds:]
    dtv = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    # x (B, 1, nh, hd); Bm, Cm (B, 1, ds); dtv (B, 1, nh); the state and
    # each operand at this rank's slice of the state's divided dim.
    st = TP.cache_part(cache["ssm"])
    H = st.local.float()                              # (B, nh, hd, ds)
    x0, dt0, B0, C0, A0 = x[:, 0], dtv[:, 0], Bm[:, 0], Cm[:, 0], A
    if st.dim is not None:
        a, b = TP.shard_range(H.shape[st.dim])
        if st.dim == 1:
            x0, dt0, A0 = x0[:, a:b], dt0[:, a:b], A0[a:b]
        elif st.dim == 2:
            x0 = x0[:, :, a:b]
        else:
            B0, C0 = B0[:, a:b], C0[:, a:b]
    g = torch.exp(dt0[:, :, None, None] * A0[None, :, None, None])
    dBx = (B0[:, None, None, :].float() * x0[:, :, :, None].float()
           * dt0[:, :, None, None])
    H_new = H * g + dBx
    y = torch.einsum("bd,bhpd->bhp", C0.float(), H_new)
    if st.dim == 3:
        y = TP.reduce_from_model(y)
    elif st.dim is not None:
        y = TP.gather_from_model(y, st.dim)
    y = y + x[:, 0].float() * p["d_skip"][None, :, None]
    y = y.reshape(y.shape[0], 1, di).to(u.dtype)
    y = TP.regroup(y, L.whole_rows, L.rows)
    return _out(cfg, r, L, y, z), {
        "conv": TP.cache_like(cache["conv"], window[:, 1:], conv_dim),
        "ssm": TP.cache_like(cache["ssm"], H_new, st.dim)}
