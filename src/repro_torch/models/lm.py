"""Decoder-only LM assembled from the block pattern, and the VLM: the same
backbone over projected patch embeddings prepended to the tokens.

Parameters and caches keep the reference's stacked-unit layout: every
leaf of ``params["units"]`` and ``cache["units"]`` carries a leading
unit dim U (one unit is one repeat of the block pattern), so the KV
store sees the same pages in the same order as the reference does.  The
reference scans over units; here a Python loop indexes them.  A pattern
remainder (recurrentgemma: 26 = 8 * 3 + 2) runs after the units as the
reference's unscanned tail: ``params["tail"]`` and ``cache["tail"]`` are
plain lists of per-layer trees, not stacked.

``train_loss`` rematerializes each unit in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
scan body), so only the unit inputs are kept; the tail runs without
remat.  Under a mesh the kept input, the carry, is this rank's T /
model rows where "model" divides the T positions, in every mode (the
reference constrains it to ``act_seq``): a unit on a whole stream
gathers it on entry and cuts its output back (ROADMAP D15c-2b).  MoE configs add 0.01 x the load-balance aux loss summed over the
units' MoE layers: the reference drops the tail's aux, and so does the
port (ROADMAP C13).

Parameters may be DTensors (``distributed.steps``): each unit's weights
are gathered just where the backbone takes the unit (inside the remat
region in training, so the backward pass gathers them again rather
than keeping them, its collectives issued again under the restored
mesh context), the other weights where an entry point starts
(``distributed.sharding.gather_tree``).  Attention's, the dense MLP's,
Mamba-2's and RG-LRU's products', the embedding's and the head's
weights (``sharding.TP_LEAVES``) arrive as this rank's "model" shard
where "model" divides them, and those layers compute their share of
the products (``distributed.tensor_parallel``; ``train_loss`` takes
the vocab-parallel cross-entropy); the MoE's experts stay DTensors
(``sharding.KEPT_LEAVES``) for its dispatch to take its shards; every
other weight arrives whole.  Activations stay plain local tensors (the
serve steps' cache leaves DTensors, ``tensor_parallel.cache_part``);
the ``constrain`` hints are no-ops on them: the layouts along the
sequence are the ``tensor_parallel`` pieces below.

In the reference's flash mode (``REPRO_ATTN_IMPL=flash``,
``models.attention.seq_parallel_mode``) the prefill's and training's
residual stream is this rank's T / model rows (:func:`seq_stream`; the
blocks' ``seq``) where "model" divides T and no layer is an SSD layer:
the embeddings are cut to the rows, the blocks keep them, and the
prefill's last position is taken from the rank that holds it (a
gather of one row a rank), training's stream gathered whole before the
head.

The VLM (``family == "vlm"``, internvl2) takes ``batch["patches"]`` (B,
n_patches, d), the stub vision frontend's output, in front of the token
embeddings: positions run over n_patches + T, the prefill cache holds
those slots, and ``train_loss`` drops the prefix rows before the
logits.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import SSM, ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (constrain, gather_tree,
                                              restored, snapshot,
                                              stack_units, unit_of)
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models.common import (
    apply_norm,
    cross_entropy,
    embed_apply,
    embed_init,
    logits_apply,
    norm_init,
)


def _moe_here(cfg: ModelConfig, member_idx: int) -> bool:
    if cfg.moe is None:
        return False
    il = cfg.moe.interleave
    return member_idx % il == il - 1


def _stack(trees):
    """Stack a list of equal nested dicts of tensors along a new dim 0
    (DTensors by their local shards: ``sharding.stack_units``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return stack_units(trees)


def _index(tree, u: int):
    """Unit ``u`` of a stacked nested dict (a DTensor's from its local
    shard: ``sharding.unit_of``)."""
    if isinstance(tree, dict):
        return {k: _index(v, u) for k, v in tree.items()}
    return unit_of(tree, u)


def unit_params(cfg: ModelConfig, units, u: int):
    """Unit ``u``'s weights, DTensors gathered (plain tensors as they
    are)."""
    return gather_tree(_index(units, u))


def outer_params(cfg: ModelConfig, params, stacked=("units",)) -> dict:
    """``params`` with every entry but the stacked units gathered."""
    return {k: v if k in stacked else gather_tree(v)
            for k, v in params.items()}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("decoder", "vlm"):
        raise ValueError(f"the {cfg.family!r} family is not a decoder LM")
    for kind in cfg.block_pattern + cfg.tail_pattern():
        B.check_kind(kind)


def lm_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Seeded float32 parameters on the generator's device."""
    _check_family(cfg)
    embed_p = embed_init(generator, cfg)
    units = [{f"b{i}": B.block_init(generator, cfg, kind, _moe_here(cfg, i))
              for i, kind in enumerate(cfg.block_pattern)}
             for _ in range(cfg.unit_count())]
    params = {"embed_p": embed_p, "units": _stack(units),
              "final_norm": norm_init(cfg, cfg.d_model, generator.device)}
    tail = cfg.tail_pattern()
    if tail:
        params["tail"] = [B.block_init(generator, cfg, kind, _moe_here(cfg, i))
                          for i, kind in enumerate(tail)]
    return params


def seq_stream(cfg: ModelConfig, T: int) -> bool:
    """Whether the prefill's and training's residual stream is this
    rank's rows of the T positions (the reference's flash mode, "model"
    dividing T, and no SSD layer: the reference's SSD blocks keep the
    whole stream)."""
    return (A.seq_parallel_mode() and TP.seq_divided(T)
            and SSM not in cfg.block_pattern + cfg.tail_pattern())


def backbone_fullseq(cfg: ModelConfig, params, x, positions,
                     seq: bool = False):
    """x (B, T, d) embedded input -> (x_out, cache); ``seq``: x and
    x_out this rank's rows of the sequence-divided stream."""
    x = constrain(x, ("batch", None, None))
    caches = []
    for u in range(cfg.unit_count()):
        unit_p = unit_params(cfg, params["units"], u)
        unit_c = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, unit_c[f"b{i}"] = B.block_fullseq(
                cfg, kind, unit_p[f"b{i}"], x, positions, seq=seq)
        caches.append(unit_c)
    cache = {"units": _stack(caches)}
    tail = cfg.tail_pattern()
    if tail:
        cache["tail"] = []
        for i, kind in enumerate(tail):
            x, c = B.block_fullseq(cfg, kind, params["tail"][i], x, positions,
                                   seq=seq)
            cache["tail"].append(c)
    return x, cache


def backbone_decode(cfg: ModelConfig, params, x, cache, pos: int):
    new_units = []
    for u in range(cfg.unit_count()):
        unit_p = unit_params(cfg, params["units"], u)
        unit_c = _index(cache["units"], u)
        new_c = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, new_c[f"b{i}"] = B.block_decode(
                cfg, kind, unit_p[f"b{i}"], x, unit_c[f"b{i}"], pos)
        new_units.append(new_c)
    new_cache = {"units": _stack(new_units)}
    if "tail" in cache:
        new_cache["tail"] = []
        for i, kind in enumerate(cfg.tail_pattern()):
            x, c = B.block_decode(cfg, kind, params["tail"][i], x,
                                  cache["tail"][i], pos)
            new_cache["tail"].append(c)
    return x, new_cache


# -- entry points ---------------------------------------------------------------


def _embed_input(cfg: ModelConfig, params, batch):
    """Token embeddings, with the VLM's patches prepended: (x, the
    number of prefix rows)."""
    x = embed_apply(cfg, params["embed_p"], batch["tokens"])
    if cfg.family != "vlm":
        return x, 0
    patches = batch["patches"]
    return torch.cat([patches.to(x.dtype), x], dim=1), patches.shape[1]


def prefill(cfg: ModelConfig, params, batch):
    """batch {"tokens": (B, T) int; the VLM's "patches": (B, P, d)}: ->
    (last-position float32 logits (B, 1, V), cache)."""
    _check_family(cfg)
    params = outer_params(cfg, params)
    x, _ = _embed_input(cfg, params, batch)
    T = x.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    seq = seq_stream(cfg, T)
    if seq:
        x = TP.scatter_seq(x)
    x, cache = backbone_fullseq(cfg, params, x, positions, seq=seq)
    last = x[:, -1:]
    if seq:        # the last position, from the last "model" rank
        last = TP.gather_from_model(last, 1)[:, -1:]
    x = apply_norm(cfg, params["final_norm"], last)
    return logits_apply(cfg, params["embed_p"], x), cache


def decode_step(cfg: ModelConfig, params, batch):
    """batch {"token": (B, 1), "pos": int, "cache": nested dict}."""
    params = outer_params(cfg, params)
    x = embed_apply(cfg, params["embed_p"], batch["token"])
    x, new_cache = backbone_decode(cfg, params, x, batch["cache"],
                                   int(batch["pos"]))
    x = apply_norm(cfg, params["final_norm"], x)
    return logits_apply(cfg, params["embed_p"], x), new_cache


def _unit_train(cfg: ModelConfig, snap, unit_p, x, positions, seq: bool,
                carry: bool):
    """One unit in training: (x, the sum of its MoE layers' aux losses
    from 0, in layer order).  ``unit_p`` is gathered here, inside the
    remat region, under the mesh context ``snap`` (the recomputation may
    run on the autograd engine's device thread).  ``carry``: x, the
    saved input, is this rank's rows of the sequence; the blocks take
    them as they are (``seq``) or the stream gathered whole, their
    output cut back to the rows."""
    with restored(snap):
        unit_p = gather_tree(unit_p)
        whole = carry and not seq
        if whole:
            x = TP.gather_from_model(x, 1)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(cfg.block_pattern):
            x, a = B.block_train(cfg, kind, unit_p[f"b{i}"], x, positions,
                                 seq=seq)
            if a is not None:
                aux = aux + a
        return TP.scatter_seq(x) if whole else x, aux


def train_loss(cfg: ModelConfig, params, batch, return_aux: bool = False):
    """batch {"tokens", "labels": (B, T) int; the VLM's "patches"}: ->
    scalar float32 mean next-token cross-entropy over the token rows
    (plus 0.01 x the units' load-balance aux loss for MoE configs),
    differentiable in ``params``; with ``return_aux``, (loss, the units'
    aux sum)."""
    _check_family(cfg)
    params = outer_params(cfg, params)
    x, n_prefix = _embed_input(cfg, params, batch)
    x = constrain(x, ("batch", None, None))
    T = x.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    # The remat carry is this rank's rows wherever "model" divides T.
    carry, seq = TP.seq_divided(T), seq_stream(cfg, T)
    if carry:
        x = TP.scatter_seq(x)
    for u in range(cfg.unit_count()):
        x, aux = torch.utils.checkpoint.checkpoint(
            _unit_train, cfg, snapshot(), _index(params["units"], u), x,
            positions, seq, carry, use_reentrant=False)
        aux_total = aux_total + aux
    if carry and not seq:
        x = TP.gather_from_model(x, 1)
    for i, kind in enumerate(cfg.tail_pattern()):   # tail aux dropped
        x, _ = B.block_train(cfg, kind, params["tail"][i], x, positions,
                             seq=seq)
    if seq:
        x = TP.gather_from_model(x, 1)
    x = apply_norm(cfg, params["final_norm"], x)[:, n_prefix:]
    logits = logits_apply(cfg, params["embed_p"], x)
    loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                         vocab=cfg.vocab)
    if cfg.moe is not None:
        loss = loss + 0.01 * aux_total   # load-balance coefficient (OLMoE)
    return (loss, aux_total) if return_aux else loss
