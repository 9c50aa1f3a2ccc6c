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

The prefill and decode steps take and return DTensors on the
reference's placements (``batch_shardings``, ``cache_shardings``,
``_logits_sharding``): each rank runs its rows over its shard of the
cache, the cache divided over "model" along the dim
``sharding.cache_leaf_spec`` picks, and never holds more of either.

What "model" divides (ROADMAP D15c-1): attention, the dense MLP (also
in RG-LRU layers and as the MoE's shared expert), the embedding and the
head, Megatron-style (``distributed.tensor_parallel``), each where
"model" divides its heads, ff or vocab: each rank computes its q heads
and, where they divide, its kv heads (else whole k/v, each q head with
its kv head), its ff columns and its vocab rows; the row-parallel
products and the embedding are summed over "model", the loss is the
vocab-parallel cross-entropy.  Decode attention runs over the cache's
shard (its kv heads, slots or head dim: ``models.attention``), and the
serve steps gather the logits over "model" (the reference replicates
them).  The dense MoE divides its experts over "model" and its products
over the batch axes as the reference's partitioner does, and the
expert-parallel MoE (``REPRO_MOE_EP=1``) its experts
(``models.moe``; ROADMAP D15c-2a).  Mamba-2's and RG-LRU's products are
divided as the reference's partitioner divides them (D15c-3): in_proj,
w_gate and w_rec by columns, out_proj and w_out by rows, the conv by
channels, the scan by heads (``models.ssm``, ``models.rglru``), each
where "model" divides that dim; their decode states stay divided along
the dims ``cache_leaf_spec`` picks.

Along the sequence (ROADMAP D15c-2b): the train step's remat carry is
each rank's T / model rows wherever "model" divides T, in every mode
(``models.lm``), as the reference constrains it to ``act_seq``.  Under
``REPRO_ATTN_IMPL=flash`` (the reference's flash mode, a real run as
the dry-run) the train and prefill steps also hold the residual stream
as those rows (``models.blocks``' ``seq``): attention context-parallel
(q, rope and o at the rows' positions, K/V gathered over "model", B4
with the rows' ``q_offset``), the column-parallel products' input
gathered and the row-parallel products reduce-scattered along T
(``tensor_parallel.gather_own``, ``reduce_scatter_seq``).  Decode is
unchanged (T is 1), and at "model" 1 every sequence piece is the
identity.

:func:`build_cell` gives the dry-run one (arch x shape x mesh) cell:
the step, its arguments as meta tensors and their placements.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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
    they are largest, else the KV sequence or the head dim):
    ``sharding.cache_leaf_spec``, the rule the layers read too."""
    return SH.map_with_path(
        lambda path, leaf: SH.cache_leaf_spec(
            tuple(leaf.shape), _cache_batch_dim(path), mesh), cache_spec)


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


def _on_mesh(mesh, t) -> torch.Tensor:
    """A batch entry as a tensor on the mesh's device."""
    if isinstance(t, torch.Tensor):
        return t if t.device.type == mesh.device_type else t.to(
            mesh.device_type)
    return torch.as_tensor(np.asarray(t), device=mesh.device_type)


def _split(mesh, batch: Dict, axes) -> Dict:
    """This rank's rows of each batch entry (all rows where ``axes`` is
    empty), as tensors on the mesh's device."""
    out = {}
    for k, v in batch.items():
        t = v if k == "pos" else _on_mesh(mesh, v)
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
            if cfg.moe is not None and axes and MOE.expert_parallel(cfg):
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


def place_serve_batch(cfg: ModelConfig, mesh, batch: Dict) -> Dict:
    """A serve step's batch on the placements of :func:`batch_shardings`:
    a DTensor entry or cache leaf as it is, a plain one (whole on every
    rank) cut to this rank's shard without a collective; ``pos`` as it
    is."""
    def one(path, t):
        if path[0] == "pos" or isinstance(t, DTensor):
            return t
        t = _on_mesh(mesh, t)
        if path[0] == "cache":
            spec = SH.cache_leaf_spec(tuple(t.shape),
                                      _cache_batch_dim(path), mesh)
        else:
            spec = batch_specs(cfg, mesh, {path[0]: t})[path[0]]
        return SH.place(t, mesh, SH.spec_to_placements(spec, mesh))

    return SH.map_with_path(one, batch)


def _serve_logits(cfg: ModelConfig, mesh, logits):
    """This rank's (B_l, T, V_l) logits gathered over the vocab where
    "model" divides it (the reference replicates them over "model"), as
    a DTensor on :func:`_logits_sharding`.  Call it inside
    ``use_mesh``."""
    if TP.divided(cfg.vocab):
        logits = TP.gather_from_model(logits, -1)
    B = logits.shape[0] * SH.batch_size_of(mesh, SH.current_batch_axes())
    return SH.as_dtensor(logits, mesh, _logits_sharding(mesh, B),
                         (B,) + tuple(logits.shape[1:]))


def make_prefill_step(cfg: ModelConfig, mesh):
    """-> (fn, parameter placements); ``fn(params, batch)`` is the
    model's prefill under the mesh.  ``batch`` holds DTensors on
    :func:`batch_shardings` (plain tensors, whole on every rank, are
    cut to them: :func:`place_serve_batch`); each rank runs its rows.
    Returns DTensors: the logits on :func:`_logits_sharding` and each
    cache leaf on :func:`cache_shardings`, every rank holding only its
    shard."""
    model = build_model(cfg, mesh.device_type)
    p_place = SH.param_placements(param_shapes(cfg), mesh)

    @torch.no_grad()
    def fn(params, batch):
        batch = place_serve_batch(cfg, mesh, batch)
        axes = _batch_axes(mesh, batch["tokens"].shape[0])
        local = {k: SH.local(v) for k, v in batch.items()}
        with SH.use_mesh(mesh, batch_axes=axes):
            logits, cache = model.prefill(params, local)
            return _serve_logits(cfg, mesh, logits), cache

    return fn, p_place


def _host_int(pos) -> int:
    """A decode's ``pos``: an int, or a host scalar tensor (the
    dry-run's argument, real under its fake tensor mode) read on the
    host."""
    if not isinstance(pos, torch.Tensor):
        return int(pos)
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return int(pos)


def make_decode_step(cfg: ModelConfig, mesh):
    """-> (fn, parameter placements); ``fn(params, batch)`` is one decode
    step under the mesh on {"token", "pos", "cache"}, DTensors on
    :func:`batch_shardings` (plain tensors, whole on every rank, are
    cut to them) and ``pos`` an int or a host scalar: (the logits on
    :func:`_logits_sharding`, the new cache on :func:`cache_shardings`),
    DTensors.  Each rank decodes its rows over its shard of the cache
    (``models.attention.attention_decode``)."""
    model = build_model(cfg, mesh.device_type)
    p_place = SH.param_placements(param_shapes(cfg), mesh)

    @torch.no_grad()
    def fn(params, batch):
        batch = place_serve_batch(cfg, mesh, batch)
        axes = _batch_axes(mesh, batch["token"].shape[0])
        local = {k: v if k == "cache" else SH.local(v)
                 for k, v in batch.items()}
        local["pos"] = _host_int(batch["pos"])
        with SH.use_mesh(mesh, batch_axes=axes):
            logits, cache = model.decode_step(params, local)
            return _serve_logits(cfg, mesh, logits), cache

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
    serve steps take and return DTensors on those placements, each rank
    holding its shard."""
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
