"""Shared model primitives: norms, RoPE, MLPs, embeddings.

Plain functions on tensors with the reference's parameter names and
layouts.  Every init draws from an explicit ``torch.Generator`` on the
device the parameters live on.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import constrain


def dtype_of(cfg: ModelConfig, kind: str = "param") -> torch.dtype:
    """The config's parameter dtype (``kind="param"``), else its
    activation dtype."""
    return getattr(torch, cfg.param_dtype if kind == "param"
                   else cfg.activation_dtype)


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg, "act")


def init_dense(gen: torch.Generator, shape, scale: Optional[float] = None,
               in_dims: int = 1) -> torch.Tensor:
    """Truncated-normal fan-in init (stddev 1/sqrt(fan_in) by default),
    truncated at two standard deviations, float32."""
    fan_in = 1
    for s in shape[:in_dims]:
        fan_in *= s
    stddev = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(stddev)


# -- norms -------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def norm_init(cfg: ModelConfig, d: int, device) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    return {"scale": torch.zeros((d,), device=device)}


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# -- rotary embeddings ---------------------------------------------------------


def rope(x, positions, theta: float):
    """Rotary embedding; x: (..., seq, heads, head_dim), positions (seq,)."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), expo)
    ang = positions[..., None].float() * freqs       # (..., seq, hd/2)
    ang = ang[..., None, :]                          # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# -- MLPs ----------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d: int, ff: int) -> dict:
    if cfg.mlp in ("swiglu", "geglu"):
        return {"wi": init_dense(gen, (d, ff)), "wg": init_dense(gen, (d, ff)),
                "wd": init_dense(gen, (ff, d))}
    return {"wi": init_dense(gen, (d, ff)), "wd": init_dense(gen, (ff, d))}


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def mlp_apply(cfg: ModelConfig, p, x, ff: Optional[int] = None,
              seq: bool = False):
    """The MLP of x (B, T, d), ``ff`` wide (default ``cfg.d_ff``).  Where
    ff is divided over "model" (its weights this rank's ff columns:
    ``wi`` and ``wg`` column-parallel, ``wd`` row-parallel), the ranks'
    partial outputs are summed over "model".  With ``seq``, x and y are
    this rank's rows of the sequence-divided stream: a divided MLP
    takes x gathered over "model" and reduce-scatters its output
    (``tensor_parallel.column_input``, ``row_output``); a whole one runs
    on the rows, its weights' gradients summed over "model"."""
    dt = x.dtype
    divided = TP.divided(ff or cfg.d_ff)
    if divided:
        x = TP.column_input(x, seq)
    elif seq and TP.model_group() is not None:
        p = dict(zip(p, TP.copy_to_model(*p.values())))
    h = x @ p["wi"].to(dt)
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ p["wg"].to(dt)
        act = F.silu if cfg.mlp == "swiglu" else gelu
        h = act(g) * h
    else:
        h = gelu(h)
    h = constrain(h, ("batch", None, "ff"))
    y = h @ p["wd"].to(dt)
    return TP.row_output(y, seq) if divided else y


# -- embeddings / head ---------------------------------------------------------


def embed_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    emb = torch.empty((cfg.vocab, cfg.d_model), dtype=torch.float32,
                      device=gen.device)
    p = {"embed": emb.normal_(0.0, 0.02, generator=gen)}
    if not cfg.tie_embeddings:
        p["unembed"] = init_dense(gen, (cfg.d_model, cfg.vocab))
    return p


def embed_apply(cfg: ModelConfig, p, tokens):
    """The token embeddings in the activation dtype (vocab-parallel where
    ``embed`` is this rank's rows divided over "model")."""
    x = TP.embed_lookup(p["embed"], tokens, act_dtype(cfg), cfg.vocab)
    if cfg.scale_embed:
        # The reference rounds the scale to the activation dtype first.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def logits_apply(cfg: ModelConfig, p, x):
    """float32 logits of ``x`` (B, T, d): the products of the activation
    dtype's values, summed in float32 (the reference's
    ``preferred_element_type``), then the final softcap.  Where the head
    is divided over "model", this rank's vocab columns."""
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    if TP.divided(cfg.vocab):
        x = TP.copy_to_model(x)
    logits = x.float() @ w.to(x.dtype).float()
    logits = constrain(logits, ("batch", None, "vocab"))
    return softcap(logits, cfg.final_softcap)


def cross_entropy(logits, labels, mask=None, vocab: Optional[int] = None):
    """Mean token cross-entropy in float32; ``mask`` 1.0 counts a
    position.  The reference's form: ``log sum exp(logits - m) + m``
    with the max ``m`` held constant, minus the gold logit (picked by a
    select and a sum, whose backward is deterministic on the card).
    Where ``vocab`` (the head's width) is divided over "model", the
    logits are this rank's columns
    (``distributed.tensor_parallel.cross_entropy``)."""
    nll = TP.cross_entropy(logits, labels, vocab)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
