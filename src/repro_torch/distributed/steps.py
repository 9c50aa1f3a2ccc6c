"""Step builders: the sharded train step and the prefill and decode steps
over a ``DeviceMesh``, with placements from the logical rules of
:mod:`repro_torch.distributed.sharding` (the reference's
``repro.distributed.steps``).

The train step's state is DTensors: every parameter and both AdamW
moments on the placements :func:`~repro_torch.distributed.sharding.
param_specs` gives the leaf, so each rank holds exactly the reference's
per-device share; ``step`` is a plain (replicated) tensor.  Each rank
takes its rows of the global batch (over the ``batch`` rule's axes; the
whole batch on every rank where those axes do not divide it), runs the
model on plain local tensors with each unit's weights gathered just in
time (their gradients summed back over the batch axes onto the
parameters' placements), and backpropagates its mean loss over the
batch-group size, so the gradients are those of the loss's mean over
the global batch.  The update is AdamW on the local shards, with the
global norm over the whole mesh.

The prefill and decode steps split the batch the same way and gather
the logits and cache back over the batch axes, so they take and return
global tensors.

What "model" divides (ROADMAP D15c-1): attention, the dense MLP (also
in RG-LRU layers and as the MoE's shared expert), the embedding and the
head, Megatron-style (``distributed.tensor_parallel``), each where
"model" divides its heads, ff or vocab: each rank computes its q heads
and, where they divide, its kv heads (else whole k/v, each q head with
its kv head), its ff columns and its vocab rows; the row-parallel
products and the embedding are summed over "model", the loss is the
vocab-parallel cross-entropy.  The serve steps hand each rank its kv
heads of the cache it is given and gather the logits (which the
reference replicates over "model") and the new cache back over
"model".  What it does not divide: Mamba-2's and RG-LRU's products
(D15c-3), which every "model" rank computes for its batch rows in
full, and the router and the dense MoE's experts, whose dispatch
gathers the global batch on every rank (D15c-2).  The expert-parallel
MoE (``REPRO_MOE_EP=1``) divides the experts.
:func:`build_cell` gives the dry-run one (arch x shape x mesh) cell:
the step, its arguments as meta tensors and their placements.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.elastic import reshard_state
from repro_torch.models import moe as MOE
from repro_torch.models.api import build_model, input_specs
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     init_opt_state, tree_leaves, tree_map)

_BATCH_RANK = {"tokens": 2, "labels": 2, "token": 2, "patches": 3,
               "audio_embed": 3}


def param_shapes(cfg: ModelConfig):
    """The parameter tree as meta tensors (shapes and dtypes only)."""
    return build_model(cfg, "meta").init()


def _batch_parts(mesh, leaf) -> Optional[tuple]:
    b = SH.rules_for_mesh(mesh)["batch"]
    return b if leaf.shape[0] % SH.batch_size_of(mesh, b) == 0 else None


def batch_specs(cfg: ModelConfig, mesh, specs: Dict) -> Dict:
    """A spec per batch entry (tokens, labels, frontends, decode inputs):
    the batch dim over the batch axes where they divide it (a batch of 1
    is replicated); the decode cache by :func:`cache_specs`."""
    out = {}
    for name, leaf in specs.items():
        if name == "cache":
            out[name] = cache_specs(cfg, mesh, leaf)
        elif name == "pos":
            out[name] = ()
        elif name in _BATCH_RANK:
            out[name] = (_batch_parts(mesh, leaf),) + (None,) * (
                _BATCH_RANK[name] - 1)
        else:
            raise KeyError(name)
    return out


def batch_shardings(cfg: ModelConfig, mesh, specs: Dict) -> Dict:
    """:func:`batch_specs` as DTensor placements."""
    return SH.map_with_path(lambda _, s: SH.spec_to_placements(s, mesh),
                            batch_specs(cfg, mesh, specs))


def _cache_batch_dim(path) -> int:
    """The batch dim of a cache leaf: after the unit dim of a stacked
    leaf."""
    return 1 if "units" in path else 0


def cache_specs(cfg: ModelConfig, mesh, cache_spec) -> Any:
    """Decode-cache specs: the batch over the batch axes, and the
    largest non-batch dim that "model" divides over "model" (heads where
    they divide, else the KV sequence)."""
    b_axes = SH.rules_for_mesh(mesh)["batch"]
    batch_size = SH.batch_size_of(mesh, b_axes)
    model_size = SH.mesh_shape(mesh)["model"]

    def leaf_spec(path, leaf):
        n_lead = _cache_batch_dim(path)
        ndim = leaf.ndim
        parts = [None] * ndim
        if ndim > n_lead and leaf.shape[n_lead] % batch_size == 0:
            parts[n_lead] = tuple(b_axes)
        cand = [(leaf.shape[i], i) for i in range(n_lead + 1, ndim)
                if leaf.shape[i] % model_size == 0
                and leaf.shape[i] >= model_size]
        if cand:
            _, i = max(cand)
            parts[i] = ("model",)
        return tuple(parts)

    return SH.map_with_path(leaf_spec, cache_spec)


def cache_shardings(cfg: ModelConfig, mesh, cache_spec) -> Any:
    """:func:`cache_specs` as DTensor placements."""
    return SH.map_with_path(lambda _, s: SH.spec_to_placements(s, mesh),
                            cache_specs(cfg, mesh, cache_spec))


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def make_train_state_specs(cfg: ModelConfig, mesh):
    """-> (the state as meta tensors, its placements): the moments share
    their parameters' placements; ``step`` (placements ``None``) is a
    plain tensor on every rank."""
    params_spec = param_shapes(cfg)
    p_place = SH.param_placements(params_spec, mesh)
    opt_spec = init_opt_state(params_spec,
                              AdamWConfig(moment_dtype=cfg.moment_dtype))
    return ({"params": params_spec, "opt": opt_spec},
            {"params": p_place, "opt": {"m": p_place, "v": p_place,
                                        "step": None}})


def init_train_state(cfg: ModelConfig, mesh, placements, params=None,
                     seed: int = 0, opt: Optional[AdamWConfig] = None):
    """The train state on ``mesh``: ``params`` (drawn from ``seed`` on
    the mesh's device type unless given, the same on every rank) on
    their placements, requiring grad, and zero moments beside them."""
    dev = torch.device(mesh.device_type)
    if params is None:
        params = build_model(cfg, dev,
                             torch.Generator(dev).manual_seed(seed)).init()
    params = reshard_state(params, mesh, placements["params"])
    params = tree_map(lambda p: p.requires_grad_(True), params)
    opt = opt or AdamWConfig(moment_dtype=cfg.moment_dtype)
    return {"params": params, "opt": init_opt_state(params, opt)}


def place_train_state(host, mesh, placements):
    """A host state (a restored checkpoint, from any mesh) on ``mesh``'s
    placements, the parameters requiring grad."""
    state = reshard_state(host, mesh, placements)
    tree_map(lambda p: p.requires_grad_(True), state["params"])
    return state


def _split(mesh, batch: Dict, axes) -> Dict:
    """This rank's rows of each batch entry (all rows where ``axes`` is
    empty), as tensors on the mesh's device."""
    out = {}
    kind = mesh.device_type
    for k, v in batch.items():
        if k == "pos":
            t = v
        elif isinstance(v, torch.Tensor):
            t = v if v.device.type == kind else v.to(kind)
        else:
            t = torch.as_tensor(np.asarray(v), device=kind)
        out[k] = SH.local_rows(t, mesh, axes) if axes and k != "pos" else t
    return out


def _batch_axes(mesh, n_rows: int) -> tuple:
    """The batch axes a batch of ``n_rows`` splits over, or ``()``."""
    axes = SH.rules_for_mesh(mesh)["batch"]
    n = SH.batch_size_of(mesh, axes)
    return tuple(axes) if n > 1 and n_rows % n == 0 else ()


def _all_reduce(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM):
    for ax in axes:
        dist.all_reduce(t, op=op, group=mesh.get_group(ax))
    return t


def make_train_step(cfg: ModelConfig, mesh, opt: Optional[AdamWConfig] = None,
                    batch_shard=None):
    """-> (step_fn, state_placements).  ``step_fn(state, batch,
    lr_scale=1.0)`` trains one step in place on the global ``batch``
    and returns ``(state, {"loss", "grad_norm"})``; ``batch_shard`` (the
    reference's batch shardings) is accepted and the split follows the
    ``batch`` rule."""
    del batch_shard
    model = build_model(cfg, mesh.device_type)
    opt = opt or AdamWConfig(moment_dtype=cfg.moment_dtype)
    _, placements = make_train_state_specs(cfg, mesh)
    n_b = SH.batch_size_of(mesh, SH.rules_for_mesh(mesh)["batch"])

    def step_fn(state, batch, lr_scale=1.0):
        params = state["params"]
        axes = _batch_axes(mesh, len(batch["tokens"]))
        local = _split(mesh, batch, axes)
        aux = None
        with SH.use_mesh(mesh, batch_axes=axes):
            if cfg.moe is not None and axes and MOE.kept_sharded(cfg):
                loss, aux = model.train_loss(params, local, return_aux=True)
            else:
                loss = model.train_loss(params, local)
        # Each rank's share of the global mean: the gradients are summed
        # over the batch axes where the weights are gathered.
        (loss if n_b == 1 else loss / n_b).backward()
        grads = tree_map(lambda p: p.grad, params)
        _, _, metrics = adamw_update(grads, state["opt"], params, opt,
                                     lr_scale)
        for p in tree_leaves(params):
            p.grad = None
        metrics["loss"] = _reported_loss(loss.detach(), aux, mesh, axes, n_b)
        return state, metrics

    return step_fn, placements


def _reported_loss(loss, aux, mesh, axes, n_b):
    """The step's loss metric: the mean of the ranks' losses over the
    batch axes.  Under the expert-parallel MoE with a split batch it is
    the reference's metric instead (ROADMAP C14): the cross-entropy's
    mean plus 0.01 x the first batch rank's aux loss (its ``shard_map``
    returns each rank's own aux as a replicated value and the host reads
    the first device's), while the gradient is the mean's."""
    loss = loss.clone()
    if not axes:
        return loss
    if aux is None:
        return _all_reduce(loss, mesh, axes) / n_b
    aux = aux.detach().clone()
    ce = _all_reduce(loss - 0.01 * aux, mesh, axes) / n_b
    for ax in axes:
        dist.broadcast(aux, group=mesh.get_group(ax), group_src=0)
    return ce + 0.01 * aux


def train_input_shardings(cfg: ModelConfig, mesh, shape: ShapeConfig):
    """-> (the cell's batch as meta tensors, its placements)."""
    specs = input_specs(cfg, shape)
    return specs, batch_shardings(cfg, mesh, specs)


def host_state(state) -> Any:
    """The state as host numpy arrays (every rank gathers each DTensor)."""
    def get(x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return x.detach().cpu().numpy()
    return tree_map(get, state)


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------


def _gather_rows(tree, mesh, axes, path_dim=_cache_batch_dim):
    """Each leaf's rows gathered over ``axes`` (batch dim per leaf)."""
    if not axes:
        return tree
    names = mesh.mesh_dim_names

    def one(path, t):
        d = path_dim(path)
        place = [Shard(d) if n in axes else Replicate() for n in names]
        return DTensor.from_local(t, mesh, place).full_tensor()

    return SH.map_with_path(one, tree)


def _local_cache(tree, mesh, axes):
    if not axes:
        return tree

    def one(path, t):
        d = _cache_batch_dim(path)
        return SH.local_rows(t.transpose(0, d), mesh, axes).transpose(0, d)

    return SH.map_with_path(one, tree)


def _kv_dim(path) -> Optional[int]:
    """The kv-head dim of an attention cache leaf (``attn``, ``xattn``:
    k, v and an int8 cache's scales, (B, K, S, ...) after any unit dim),
    or None."""
    return _cache_batch_dim(path) + 1 if {"attn", "xattn"} & set(path) \
        else None


def _local_kv_heads(cfg: ModelConfig, cache):
    """This "model" rank's kv heads of each attention cache leaf, where
    they are divided over "model" (as ``wk`` and ``wv`` are).  Call it
    inside ``use_mesh``."""
    if not TP.divided(cfg.n_kv_heads):
        return cache
    start, stop = TP.shard_range(TP.local(cfg.n_kv_heads))

    def one(path, t):
        d = _kv_dim(path)
        return t if d is None else t.narrow(d, start, stop - start)

    return SH.map_with_path(one, cache)


def _whole_over_model(cfg: ModelConfig, logits, cache):
    """The logits (this rank's vocab columns where the vocab is divided
    over "model") and the cache (its kv heads where they are divided)
    gathered over "model": the reference's out shardings replicate the
    logits over "model"."""
    if TP.divided(cfg.vocab):
        logits = TP.gather_from_model(logits, -1)
    if TP.divided(cfg.n_kv_heads):
        cache = SH.map_with_path(
            lambda path, t: t if _kv_dim(path) is None else
            TP.gather_from_model(t, _kv_dim(path)), cache)
    return logits, cache


def make_prefill_step(cfg: ModelConfig, mesh):
    """-> (fn, parameter placements); ``fn(params, batch)`` is the
    model's prefill under the mesh on the global batch: (logits,
    cache), gathered over the batch axes and "model"."""
    model = build_model(cfg, mesh.device_type)
    p_place = SH.param_placements(param_shapes(cfg), mesh)

    @torch.no_grad()
    def fn(params, batch):
        axes = _batch_axes(mesh, len(batch["tokens"]))
        local = _split(mesh, batch, axes)
        with SH.use_mesh(mesh, batch_axes=axes):
            logits, cache = _whole_over_model(cfg,
                                              *model.prefill(params, local))
        return (_gather_rows(logits, mesh, axes, lambda _: 0),
                _gather_rows(cache, mesh, axes))

    return fn, p_place


def make_decode_step(cfg: ModelConfig, mesh):
    """-> (fn, parameter placements); ``fn(params, batch)`` is one decode
    step under the mesh on the global batch {"token", "pos", "cache"}:
    (logits, new cache), gathered over the batch axes and "model".  Each
    rank decodes its rows, and its kv heads where "model" divides them,
    of the global cache it is given."""
    model = build_model(cfg, mesh.device_type)
    p_place = SH.param_placements(param_shapes(cfg), mesh)

    @torch.no_grad()
    def fn(params, batch):
        axes = _batch_axes(mesh, len(batch["token"]))
        local = _split(mesh, {k: v for k, v in batch.items()
                              if k != "cache"}, axes)
        with SH.use_mesh(mesh, batch_axes=axes):
            local["cache"] = _local_kv_heads(
                cfg, _local_cache(batch["cache"], mesh, axes))
            logits, cache = _whole_over_model(
                cfg, *model.decode_step(params, local))
        return (_gather_rows(logits, mesh, axes, lambda _: 0),
                _gather_rows(cache, mesh, axes))

    return fn, p_place


# ---------------------------------------------------------------------------
# One-stop cell builder for the dry-run.
# ---------------------------------------------------------------------------


def _logits_sharding(mesh, global_batch: int) -> tuple:
    """Placements of the (B, T, V) logits: the batch over the batch axes
    where they divide it, else replicated."""
    b = SH.rules_for_mesh(mesh)["batch"]
    whole = global_batch % SH.batch_size_of(mesh, b)
    return SH.spec_to_placements((None if whole else tuple(b), None, None),
                                 mesh)


def serve_param_shapes(cfg: ModelConfig):
    """The parameter tree as meta tensors in bfloat16 where the
    parameters are float32: the production serving convention the
    reference's dry-run takes for its prefill and decode cells."""
    return tree_map(lambda p: p.to(torch.bfloat16)
                    if p.dtype == torch.float32 else p, param_shapes(cfg))


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """-> (step, argument specs, their placements) for one (arch x shape
    x mesh) cell, the reference's ``build_cell``: the step of
    :func:`make_train_step`, :func:`make_prefill_step` or
    :func:`make_decode_step`; its arguments as meta tensors (the train
    state, or the serve parameters in bfloat16, and the batch of
    :func:`~repro_torch.models.api.input_specs`); the placements each
    argument has on the reference's mesh (``None``: replicated).  The
    port's serve steps take and return global batches: they split the
    rows over the batch axes themselves."""
    specs = input_specs(cfg, shape)
    b_place = batch_shardings(cfg, mesh, specs)
    if shape.kind == "train":
        step, state_place = make_train_step(cfg, mesh, batch_shard=b_place)
        state_spec, _ = make_train_state_specs(cfg, mesh)
        return step, (state_spec, specs), (state_place, b_place)
    make = make_prefill_step if shape.kind == "prefill" else \
        make_decode_step
    fn, p_place = make(cfg, mesh)
    return fn, (serve_param_shapes(cfg), specs), (p_place, b_place)


def cell_output_placements(cfg: ModelConfig, shape: ShapeConfig, mesh,
                           out) -> Any:
    """The placements the reference gives a cell's outputs ``out``
    (its ``out_shardings``): the train state on its placements and the
    metrics replicated; the logits by :func:`_logits_sharding` and the
    cache by :func:`cache_shardings`."""
    if shape.kind == "train":
        _, place = make_train_state_specs(cfg, mesh)
        state, metrics = out
        return place, {k: None for k in metrics}
    logits, cache = out
    return (_logits_sharding(mesh, shape.global_batch),
            cache_shardings(cfg, mesh, cache))
