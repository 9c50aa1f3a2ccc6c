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
"""

from __future__ import annotations

import math

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


def _split_proj(cfg: ModelConfig, p, u):
    s = cfg.ssm
    di, ds = s.d_inner(cfg.d_model), s.d_state
    zxbcdt = u @ p["in_proj"].to(u.dtype)
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * ds],
            zxbcdt[..., 2 * di + 2 * ds:])


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


def _heads(cfg: ModelConfig, xBC, dt, p):
    s = cfg.ssm
    di, ds, nh = s.d_inner(cfg.d_model), s.d_state, s.n_heads(cfg.d_model)
    x = xBC[..., :di]
    Bm = xBC[..., di:di + ds]                         # (B, T, ds)
    Cm = xBC[..., di + ds:]                           # (B, T, ds)
    x = x.reshape(x.shape[0], x.shape[1], nh, s.head_dim)
    dt = softplus(dt.float() + p["dt_bias"])         # (B, T, nh)
    A = -torch.exp(p["a_log"])                        # (nh,) negative
    return x, Bm, Cm, dt, A


def _out(cfg: ModelConfig, p, y, z):
    y = rmsnorm(y * F.silu(z), p["norm_scale"])
    return y @ p["out_proj"].to(y.dtype)


def ssm_fullseq(cfg: ModelConfig, p: dict, u, return_cache: bool = True):
    """Full-sequence SSD block.  u (B, T, d) -> (out, cache); without
    ``return_cache`` (training: the plain scan, by autograd, or the
    dry-run's scan stand-in) the cache is None."""
    s = cfg.ssm
    z, xBC, dt = _split_proj(cfg, p, u)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    x, Bm, Cm, dtv, A = _heads(cfg, xBC, dt, p)
    if not return_cache and opaque.ssd_mode():
        y, H = opaque.ssd_scan(x, Bm, Cm, dtv, A, chunk=s.chunk)
    else:
        y, H = ssd_scan(x, Bm, Cm, dtv, A, chunk=s.chunk, device=x.device,
                        training=not return_cache)
    y = y + x * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(y.shape[0], y.shape[1], s.d_inner(cfg.d_model))
    out = _out(cfg, p, y, z)
    if not return_cache:
        return out, None
    return out, {"conv": TP.to_cache(conv_state), "ssm": TP.to_cache(H)}


def ssm_decode(cfg: ModelConfig, p: dict, u, cache: dict):
    """Single-token recurrent step.  u (B, 1, d).  A state divided over
    "model" (the serve steps' DTensor) is gathered whole and the new
    state kept in its layout: the products stay whole (D15c-3)."""
    s = cfg.ssm
    z, xBC, dt = _split_proj(cfg, p, u)
    state = {n: TP.relayout(*TP.cache_part(t)[:2], None)
             for n, t in cache.items()}
    # Conv ring update: the reference's einsum, summed in float32.
    window = torch.cat([state["conv"].to(xBC.dtype), xBC], dim=1)  # (B,K,C)
    w = p["conv_w"].to(xBC.dtype)
    out = (window.float() * w.float()).sum(dim=1).to(xBC.dtype) \
        + p["conv_b"].to(xBC.dtype)
    xBC_t = F.silu(out)[:, None, :]

    x, Bm, Cm, dtv, A = _heads(cfg, xBC_t, dt, p)
    # x (B, 1, nh, hd); Bm, Cm (B, 1, ds); dtv (B, 1, nh)
    H = state["ssm"].float()                          # (B, nh, hd, ds)
    g = torch.exp(dtv[:, 0, :, None, None] * A[None, :, None, None])
    dBx = (Bm[:, 0, None, None, :].float() * x[:, 0, :, :, None].float()
           * dtv[:, 0, :, None, None])
    H_new = H * g + dBx
    y = torch.einsum("bd,bhpd->bhp", Cm[:, 0].float(), H_new)
    y = y + x[:, 0].float() * p["d_skip"][None, :, None]
    y = y.reshape(y.shape[0], 1, s.d_inner(cfg.d_model)).to(u.dtype)
    return _out(cfg, p, y, z), {"conv": TP.cache_like(cache["conv"],
                                                      window[:, 1:]),
                                "ssm": TP.cache_like(cache["ssm"], H_new)}
