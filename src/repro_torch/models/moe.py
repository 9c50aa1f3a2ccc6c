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

Under a mesh (``distributed.sharding.use_mesh``, the step builders of
``distributed.steps``), ``REPRO_MOE_EP=1`` selects the reference's
expert-parallel dispatch, :func:`moe_apply_ep`: each "model" rank owns
``E / tp`` experts (the local shards of ``moe_wi``, ``moe_wg`` and
``moe_wd`` along dim 0) and dispatches its local tokens to them with a
local capacity; one all-reduce of the (B, T, d) combine over the
"model" group is the only communication of the forward pass
(``distributed.tensor_parallel``'s reduce-from-model, and its
copy-to-model for the tokens' and gates' gradients).  With no mesh, or where tp
does not divide E, the reference means to fall back to the dense
dispatch and recurses instead (ROADMAP C11); the port computes the
dense dispatch.

The dense dispatch under a mesh (:func:`_dense_divided`, ROADMAP
D15c-2a) keeps the reference's semantics, the global batch's routing,
capacity, drops and aux loss, and divides its products as the
reference's SPMD partitioner does (read from the compiled HLO of the
reduced olmoe-1b-7b cells): each rank routes its own rows and the
expert indices (and, for the aux loss, the probabilities) are gathered
over the batch axes; each "model" rank runs its ``E / model`` experts
(``sharding.KEPT_LEAVES``, their "model" shards) on a (E / model,
capacity, d) buffer, which each data rank fills with its rows and the
data ranks sum (an all-reduce).  Then, by the buffer's size against
the weights': where the capacity is below d (decode), ``moe_wi`` and
``moe_wg`` contract this rank's d / data on their FSDP shards, never
gathered, and the partial products are all-reduced over the batch
axes; else (prefill, training) they are gathered over the batch axes
and contract all of d.  ``moe_wd`` writes this rank's d / data, which
an all-gather over the batch axes makes whole; each rank combines its
rows' assignments to its experts and one all-reduce over "model" sums
the experts' shares.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.common import init_dense, mlp_apply, mlp_init

#: The expert leaves, in ``_experts``' argument order: the unit gathers
#: leave them as DTensors.
EXPERT_LEAVES = SH.KEPT_LEAVES


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


def _use_ep() -> bool:
    return os.environ.get("REPRO_MOE_EP", "0") == "1"


def _ep_tp(moe: MoEConfig):
    """The "model" size the expert-parallel dispatch splits the experts
    over, or None where it does not run (off, no mesh, tp !| E)."""
    mesh = SH.current_mesh()
    if not _use_ep() or mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    return tp if moe.n_experts % tp == 0 else None


def expert_parallel(cfg: ModelConfig) -> bool:
    """Whether the expert-parallel dispatch runs (inside ``use_mesh``)."""
    return bool(cfg.moe and _ep_tp(cfg.moe))


def moe_apply(cfg: ModelConfig, moe: MoEConfig, p: dict, x,
              with_aux: bool = False):
    """x (B, T, d) -> (B, T, d) [, float32 load-balance aux loss]."""
    if _ep_tp(moe):
        return moe_apply_ep(cfg, moe, p, x, with_aux)
    if SH.current_mesh() is None or (not SH.current_batch_axes()
                                     and TP.model_group() is None):
        return _dense(cfg, moe, p, x, with_aux)
    return _dense_divided(cfg, moe, p, x, with_aux)


def _aux(moe: MoEConfig, probs, top1):
    """The load-balance aux loss of router probabilities (N, E) and top-1
    experts (N,)."""
    if moe.router != "softmax":
        probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    return _balance(moe, probs, top1)


def _route(moe: MoEConfig, router, tokens, with_aux: bool):
    """(gates (N, k), expert indices (N, k), the load-balance aux loss
    or None)."""
    probs, gate_v, gate_i = route(moe, {"router": router}, tokens)
    aux = _aux(moe, probs, gate_i[:, 0]) if with_aux else None
    return gate_v, gate_i, aux


def _slots(moe: MoEConfig, gate_i, n: int, e0: int, cap: int):
    """(kept, slot, local expert) of each assignment (N k,) of ``gate_i``
    to the experts [e0, e0 + n): its position within its expert is the
    exclusive cumsum of the routing one-hot, token-major, k-minor (other
    experts' assignments count in a drop row n); one past ``cap`` or to
    another expert is not kept and points at slot cap - 1 of local expert
    ``e mod n``.  The cumsum runs along the last dim: along dim 0 CUDA
    scans each column in one thread (371 of olmoe's 614 ms long prefill
    on an H100)."""
    flat_e = gate_i.reshape(-1)
    mine = (flat_e >= e0) & (flat_e < e0 + n)
    le = torch.where(mine, flat_e - e0, n)
    onehot = F.one_hot(le, n + 1)
    pos = (torch.cumsum(onehot.T, dim=1).T - onehot).gather(
        1, le[:, None])[:, 0]
    keep = mine & (pos < cap)
    return (keep, torch.where(keep, pos, cap - 1),
            torch.where(keep, le, flat_e % n))


def _capacity(moe: MoEConfig, n_tokens: int) -> int:
    return max(int(n_tokens * moe.top_k / moe.n_experts
                   * moe.capacity_factor), 4)


def _scatter(tokens, keep, slot, le, n: int, cap: int):
    """The (n, cap, d) buffer of ``tokens``' kept assignments (k a
    token, token-major): a not-kept one adds zeros to its slot.  Spread
    so: sent all to one slot, the scatter-add's duplicates made olmoe's
    long prefill 3.3x slower on an H100 (PERF.md)."""
    k = keep.shape[0] // tokens.shape[0]
    tok_rep = tokens.repeat_interleave(k, dim=0)
    return tokens.new_zeros((n, cap, tokens.shape[1])).index_put(
        (le, slot), tok_rep * keep[:, None].to(tokens.dtype), accumulate=True)


def _combine(out_buf, keep, slot, le, gate_v):
    """Each token's gated outputs of its kept assignments summed: (N,
    d)."""
    N, k = gate_v.shape
    out_tok = out_buf[le, slot]
    out_tok = out_tok * (keep[:, None]
                         * gate_v.reshape(N * k, 1)).to(out_buf.dtype)
    return out_tok.reshape(N, k, -1).sum(dim=1)


def _experts(moe: MoEConfig, tokens, gate_v, gate_i, wi, wg, wd,
             e0: int = 0):
    """tokens (N, d) through the experts [e0, e0 + n) whose weights are
    ``wi``, ``wg``, ``wd`` (n along dim 0; all E in the dense dispatch):
    (N, d), each token's gated outputs of its assignments to those
    experts summed.

    An assignment's slot and whether it is kept: :func:`_slots`, with
    the capacity ``max(int(N k / E cf), 4)``."""
    dt = tokens.dtype
    n = wi.shape[0]
    cap = _capacity(moe, tokens.shape[0])
    keep, slot, le = _slots(moe, gate_i, n, e0, cap)
    buf = SH.constrain(_scatter(tokens, keep, slot, le, n, cap),
                       ("experts", None, None))
    # Expert SwiGLU, batched over the experts.
    h = torch.bmm(buf, wi.to(dt))
    g = torch.bmm(buf, wg.to(dt))
    h = SH.constrain(F.silu(g) * h, ("experts", None, None))
    return _combine(torch.bmm(h, wd.to(dt)), keep, slot, le, gate_v)


def _dense(cfg: ModelConfig, moe: MoEConfig, p: dict, x,
           with_aux: bool = False):
    """The dense dispatch on the tokens of x, every expert whole."""
    p = SH.gather_tree(p)
    p.update({n: SH.gather(p[n]) for n in EXPERT_LEAVES})
    B, T, d = x.shape
    tokens = x.reshape(B * T, d)
    gate_v, gate_i, aux = _route(moe, p["router"], tokens, with_aux)
    y = _experts(moe, tokens, gate_v, gate_i,
                 *(p[name] for name in EXPERT_LEAVES))
    if moe.shared_expert:
        y = y + mlp_apply(cfg, p["shared"], x,
                          moe.d_ff_expert).reshape(B * T, d)
    y = y.reshape(B, T, d)
    return (y, aux) if with_aux else y


def _expert_shard(w, n: int, e0: int, d_split: bool):
    """This rank's experts [e0, e0 + n) of an expert leaf: with
    ``d_split`` its FSDP shard as it is (d divided over the batch axes;
    its gradient complete), else d whole (gathered over the batch axes,
    the gradient summed back).  A plain tensor (whole) is sliced."""
    if not isinstance(w, SH.DTensor):
        return w[e0:e0 + n]
    return w.to_local() if d_split else SH.gather_tp(w, 0)


def _d_split(w, mesh, axes, d_dim: int) -> bool:
    """Whether an expert leaf (a DTensor) holds d divided over the batch
    axes: ``param_specs`` shards it over them where they divide it."""
    if not axes or not isinstance(w, SH.DTensor):
        return False
    names = mesh.mesh_dim_names
    return all(w.placements[names.index(a)] == SH.Shard(d_dim)
               for a in axes)


def _dense_divided(cfg: ModelConfig, moe: MoEConfig, p: dict, x,
                   with_aux: bool = False):
    """The dense dispatch under a mesh, divided over "model" and the
    batch axes the step split its rows over (module docstring); the
    same function of the global batch as :func:`_dense`."""
    mesh, axes = SH.current_mesh(), SH.current_batch_axes()
    B, T, d = x.shape
    dt = x.dtype
    n_b = SH.batch_size_of(mesh, axes)
    tokens = x.reshape(B * T, d)
    N_l, k = tokens.shape[0], moe.top_k
    probs, gate_v, gate_i = route(moe, {"router": SH.gather(p["router"])},
                                  tokens)
    aux = None
    if axes:
        gate_i = SH.gather_batch(gate_i, mesh, axes)
        if with_aux:
            probs = SH.gather_batch(probs, mesh, axes)
    if with_aux:
        aux = _aux(moe, probs, gate_i[:, 0])
    n = TP.local(moe.n_experts)
    e0 = TP.shard_range(n)[0]
    cap = _capacity(moe, N_l * n_b)
    keep, slot, le = _slots(moe, gate_i, n, e0, cap)
    if axes:         # this rank's rows' assignments
        r = SH.batch_index(mesh, axes) * N_l * k
        keep, slot, le = (t[r:r + N_l * k] for t in (keep, slot, le))
    if TP.model_group() is not None:
        tokens, gate_v = TP.copy_to_model(tokens, gate_v)
    # The data ranks' scatters summed: every rank's buffer holds the
    # global batch's assignments to its experts.
    buf = SH.all_reduce_batch(_scatter(tokens, keep, slot, le, n, cap),
                              mesh, axes)
    wi, wg, wd = (p[name] for name in EXPERT_LEAVES)
    if cap < d and _d_split(wi, mesh, axes, 1):
        # decode: d contracted on the FSDP shards (wg's are wi's)
        wi, wg = (_expert_shard(w, n, e0, True) for w in (wi, wg))
        part = SH.batch_index(mesh, axes) * wi.shape[1]
        b = buf.narrow(2, part, wi.shape[1])
        hg = SH.all_reduce_batch(torch.stack([torch.bmm(b, wi.to(dt)),
                                              torch.bmm(b, wg.to(dt))]),
                                 mesh, axes)
        h, g = hg.unbind(0)
    else:            # prefill and training: wi, wg gathered
        wi, wg = (_expert_shard(w, n, e0, False) for w in (wi, wg))
        h, g = torch.bmm(buf, wi.to(dt)), torch.bmm(buf, wg.to(dt))
    d_out = _d_split(wd, mesh, axes, 2)
    out_buf = torch.bmm(F.silu(g) * h,
                        _expert_shard(wd, n, e0, d_out).to(dt))
    if d_out:
        out_buf = SH.gather_batch(out_buf, mesh, axes, dim=2)
    y = TP.reduce_from_model(_combine(out_buf, keep, slot, le, gate_v))
    y = y.reshape(B, T, d)
    if moe.shared_expert:
        y = y + mlp_apply(cfg, SH.gather_tree(p["shared"]), x,
                          moe.d_ff_expert)
    return (y, aux) if with_aux else y


def _local_experts(w, e0: int, n: int):
    """This "model" rank's experts [e0, e0 + n) of an expert leaf: the
    local shard of a DTensor (gathered over the batch axes, its gradient
    summed back over them), or a slice of a plain tensor."""
    if not isinstance(w, SH.DTensor):
        return w[e0:e0 + n]
    return SH.gather_tp(w, 0)


def moe_apply_ep(cfg: ModelConfig, moe: MoEConfig, p: dict, x,
                 with_aux: bool = False):
    """Expert-parallel MoE under a mesh: the experts shard over "model";
    tokens stay local (the reference's ``shard_map`` body,
    ``models/moe.py:126-244``).

    Each model rank routes its local tokens over all E experts (the
    same on every model rank), keeps the assignments to its own ``E /
    tp`` experts with a local cumsum and a local capacity ``max(int(N k
    / E cf), 4)`` (others go to a drop row), runs its experts, and
    combines its share of each token's k outputs; one all-reduce over
    the "model" group sums the shares.  In the backward pass the tokens'
    and gates' partial gradients are summed over "model" (one
    all-reduce), as the transpose of the reference's ``shard_map`` sums
    them; the routing and the aux loss sit outside that partial region.
    The aux loss is the local tokens', as the reference's body computes
    it.  Call it inside ``use_mesh``; without a usable mesh it computes
    the dense dispatch (C11).
    """
    tp = _ep_tp(moe)
    if tp is None:
        return _dense(cfg, moe, p, x, with_aux)
    mesh = SH.current_mesh()
    E_local = moe.n_experts // tp
    e0 = mesh.get_local_rank("model") * E_local
    B, T, d = x.shape
    tokens = x.reshape(B * T, d)
    gate_v, gate_i, aux = _route(moe, SH.gather(p["router"]), tokens,
                                 with_aux)
    # The experts' partial computation: the tokens' and gates' gradients
    # summed over "model" (one all-reduce) ...
    tokens, gate_v = TP.copy_to_model(tokens, gate_v)
    y = _experts(moe, tokens, gate_v, gate_i,
                 *(_local_experts(p[name], e0, E_local)
                   for name in EXPERT_LEAVES), e0=e0).reshape(B, T, d)
    # ... and each token's k experts may live on other ranks: the one
    # collective of the forward pass.
    y = TP.reduce_from_model(y)
    if moe.shared_expert:
        y = y + mlp_apply(cfg, SH.gather_tree(p["shared"]), x,
                          moe.d_ff_expert)
    return (y, aux) if with_aux else y


def router_aux_loss(cfg: ModelConfig, moe: MoEConfig, p: dict, x):
    """Load-balance auxiliary loss of a softmax router over x (B, T, d)."""
    B, T, d = x.shape
    tokens = x.reshape(B * T, d)
    logits = tokens.float() @ p["router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    return _balance(moe, probs, torch.argmax(probs, dim=-1))
