"""Mixture-of-Experts FFN: top-k router and capacity-based scatter
dispatch.

The reference's ``models/moe.py`` restated in torch: the Switch/Mixtral
dropping dispatch.  Each expert owns a (capacity, d) buffer; an
assignment's slot is its position within its expert (the exclusive
cumsum of the routing one-hot, token-major, k-minor), and assignments
past capacity are dropped (the residual carries their token).  The
experts run as batched products over E, then each token gathers its k
outputs, weighs them by its gates and sums them.

Router: logits are products of the activation dtype's values summed in
float32 (the reference's ``preferred_element_type``), then softmax
(olmoe: gates renormalized over the k picked, floor 1e-9) or sigmoid
(llama4, with a parallel shared expert).  Top-k breaks ties as
``lax.top_k`` does, the lower expert index first (a stable descending
sort).

``REPRO_MOE_EP=1`` selects the reference's expert-parallel dispatch,
which over a device mesh shards the experts (ROADMAP D15) and without
one means to fall back to this dense dispatch (the reference recurses
there instead: ROADMAP C11).  The port has no mesh, so it always
computes the dense dispatch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import init_dense, mlp_apply, mlp_init


def moe_init(gen: torch.Generator, cfg: ModelConfig, moe: MoEConfig) -> dict:
    d, ff, E = cfg.d_model, moe.d_ff_expert, moe.n_experts
    # in_dims=2 takes (E, d) as the fan-in; the rescale gives each expert
    # 1/sqrt(d).
    p = {
        "router": init_dense(gen, (d, E), scale=0.02),
        "moe_wi": init_dense(gen, (E, d, ff), in_dims=2).mul_(E ** 0.5),
        "moe_wg": init_dense(gen, (E, d, ff), in_dims=2).mul_(E ** 0.5),
        "moe_wd": init_dense(gen, (E, ff, d), in_dims=2).mul_(E ** 0.5),
    }
    if moe.shared_expert:
        p["shared"] = mlp_init(gen, cfg, d, moe.d_ff_expert)
    return p


def top_k(x, k: int):
    """``lax.top_k`` along the last dim: the k largest values and their
    indices, equal values in index order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(moe: MoEConfig, p: dict, tokens):
    """tokens (N, d) -> (float32 router probabilities (N, E), gates (N,
    k), expert indices (N, k))."""
    logits = tokens.float() @ p["router"].to(tokens.dtype).float()
    if moe.router == "sigmoid":
        probs = torch.sigmoid(logits)
        gate_v, gate_i = top_k(probs, moe.top_k)
    else:
        probs = torch.softmax(logits, dim=-1)
        gate_v, gate_i = top_k(probs, moe.top_k)
        gate_v = gate_v / torch.clamp(gate_v.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_v, gate_i


def _balance(moe: MoEConfig, probs, top1):
    """Switch-style load balance: E * sum_e fraction_routed_e *
    mean_prob_e."""
    E = moe.n_experts
    frac = F.one_hot(top1, E).float().mean(dim=0)
    return E * torch.sum(frac * probs.mean(dim=0))


def moe_apply(cfg: ModelConfig, moe: MoEConfig, p: dict, x,
              with_aux: bool = False):
    """x (B, T, d) -> (B, T, d) [, float32 load-balance aux loss]."""
    B, T, d = x.shape
    dt = x.dtype
    N = B * T
    E, k = moe.n_experts, moe.top_k
    tokens = x.reshape(N, d)
    probs, gate_v, gate_i = route(moe, p, tokens)

    aux = None
    if with_aux:
        if moe.router != "softmax":
            probs = probs / torch.clamp(probs.sum(-1, keepdim=True),
                                        min=1e-9)
        aux = _balance(moe, probs, gate_i[:, 0])

    capacity = max(int(N * k / E * moe.capacity_factor), 4)

    # Position of each assignment within its expert (dropped past
    # capacity; a dropped one adds zeros to slot capacity - 1).  The
    # cumsum runs along the last dim: along dim 0 CUDA scans each of the
    # E columns in one thread (371 of olmoe's 614 ms long prefill on an
    # H100).
    flat_e = gate_i.reshape(N * k)
    onehot = F.one_hot(flat_e, E)
    pos_in_e = torch.cumsum(onehot.T, dim=1).T - onehot
    pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = pos < capacity
    safe_pos = torch.where(keep, pos, capacity - 1)
    tok_rep = tokens.repeat_interleave(k, dim=0)
    buf = tokens.new_zeros((E, capacity, d)).index_put(
        (flat_e, safe_pos), tok_rep * keep[:, None].to(dt), accumulate=True)

    # Expert SwiGLU, batched over E.
    h = torch.bmm(buf, p["moe_wi"].to(dt))
    g = torch.bmm(buf, p["moe_wg"].to(dt))
    out_buf = torch.bmm(F.silu(g) * h, p["moe_wd"].to(dt))

    # Gather back and combine with the gates.
    out_tok = out_buf[flat_e, safe_pos]
    out_tok = out_tok * (keep[:, None] * gate_v.reshape(N * k, 1)).to(dt)
    y = out_tok.reshape(N, k, d).sum(dim=1)
    if moe.shared_expert:
        y = y + mlp_apply(cfg, p["shared"], x).reshape(N, d)
    y = y.reshape(B, T, d)
    return (y, aux) if with_aux else y


def router_aux_loss(cfg: ModelConfig, moe: MoEConfig, p: dict, x):
    """Load-balance auxiliary loss of a softmax router over x (B, T, d)."""
    B, T, d = x.shape
    tokens = x.reshape(B * T, d)
    logits = tokens.float() @ p["router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    return _balance(moe, probs, torch.argmax(probs, dim=-1))
