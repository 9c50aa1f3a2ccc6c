"""Public model API: ``build_model(cfg, device, generator)`` -> Model bundle.

The port builds every family: the decoder (global and sliding-window
attention, Mamba-2 SSD blocks and RG-LRU blocks with the pattern tail of
recurrentgemma, each attention or RG-LRU layer with a dense MLP or the
MoE FFN of olmoe and llama4), the VLM (internvl2: the decoder over a
patch prefix, ``batch["patches"]``) and the encoder-decoder (whisper:
``models.encdec``, ``batch["audio_embed"]``).  :func:`input_specs`
gives every input of a grid cell as meta tensors (the dry-run's
arguments).  ``train_loss`` trains every block
kind, Mamba-2's SSD blocks through the plain scan.  Parameters may be
plain tensors or DTensors on a mesh (``distributed.steps``); on
``device="meta"`` ``init`` gives the parameter tree's shapes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models.common import act_dtype


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable                # () -> params, drawn from the generator
    train_loss: Callable          # (params, batch) -> scalar loss
    prefill: Callable             # (params, batch) -> (logits, cache)
    decode_step: Callable         # (params, batch{token,pos,cache}) -> (logits, cache)

    def input_specs(self, shape: ShapeConfig,
                    batch_override: Optional[int] = None) -> Dict:
        return input_specs(self.cfg, shape, batch_override)


class _MetaGenerator(torch.Generator):
    """A CPU generator that allocates on the meta device: random inits
    accept it and draw nothing."""

    @property
    def device(self):
        return torch.device("meta")


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> Model:
    """Model bundle for ``cfg`` on ``device`` (``None``: the CUDA card).

    ``generator`` draws the parameters of ``Model.init``; by default a
    generator on ``device`` seeded with 0 (on "meta", one that draws
    nothing).
    """
    dev = resolve_device(device)
    gen = [generator]

    def init():
        # The default generator is made at the first draw, so a model
        # whose parameters come from elsewhere (a checkpoint, the
        # dry-run's fake tensors) needs no generator on its device.
        if gen[0] is None:
            gen[0] = _MetaGenerator() if dev.type == "meta" else \
                torch.Generator(dev).manual_seed(0)
        mod = ED.encdec_init if cfg.family == "encdec" else LM.lm_init
        return mod(cfg, gen[0])

    if cfg.family == "encdec":
        return Model(cfg=cfg, init=init,
                     train_loss=functools.partial(ED.train_loss, cfg),
                     prefill=functools.partial(ED.prefill, cfg),
                     decode_step=functools.partial(ED.decode_step, cfg))
    return Model(cfg=cfg, init=init,
                 train_loss=functools.partial(LM.train_loss, cfg),
                 prefill=functools.partial(LM.prefill, cfg),
                 decode_step=functools.partial(LM.decode_step, cfg))


def frontend_zeros(cfg: ModelConfig, batch: int, device=None,
                   dtype: Optional[torch.dtype] = None) -> dict:
    """The stub modality frontends' inputs as the reference's serving
    engine and training launcher feed them: zero patch embeddings (B,
    n_patches, d) for the VLM, zero frame embeddings (B, enc_positions,
    d) for the encoder-decoder, none for the decoder; in ``dtype`` (by
    default the activation dtype) on ``device`` (``None``: the card)."""
    dt = act_dtype(cfg) if dtype is None else dtype
    shape = {"vlm": ("patches", cfg.n_patches),
             "encdec": ("audio_embed", cfg.enc_positions)}.get(cfg.family)
    if shape is None:
        return {}
    name, n = shape
    return {name: torch.zeros((batch, n, cfg.d_model), dtype=dt,
                              device=resolve_device(device))}


def _frontend_specs(cfg: ModelConfig, B: int) -> Dict:
    """The stub modality frontends' inputs: precomputed frame or patch
    embeddings in the activation dtype."""
    return frontend_zeros(cfg, B, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch_override: Optional[int] = None) -> Dict:
    """Every input of one grid cell as meta tensors (shapes and dtypes,
    no storage), the reference's ``ShapeDtypeStruct`` specs:

      train   -> {tokens, labels, frontend...}, int32 (B, T);
      prefill -> {tokens, frontend...}; the VLM's patches take context
                 slots, so its T is the context less the patches;
      decode  -> {token (B, 1), pos (), cache}, the cache the port's
                 prefill makes at depth ``seq_len`` (run on meta
                 tensors, so it is the real cache's structure by
                 construction; int8 with scales under REPRO_KV_INT8=1).
    """
    B = batch_override or shape.global_batch
    i32 = torch.int32

    def tok(T):
        return torch.empty((B, T), dtype=i32, device="meta")

    if shape.kind == "train":
        specs = {"tokens": tok(shape.seq_len), "labels": tok(shape.seq_len)}
        specs.update(_frontend_specs(cfg, B))
        return specs
    if shape.kind == "prefill":
        T = shape.seq_len
        if cfg.family == "vlm":
            T = max(T - cfg.n_patches, 1)
        specs = {"tokens": tok(T)}
        specs.update(_frontend_specs(cfg, B))
        return specs
    pre = input_specs(cfg, dataclasses.replace(shape, kind="prefill"), B)
    model = build_model(cfg, "meta")
    with torch.no_grad():
        _, cache = model.prefill(model.init(), pre)
    return {"token": tok(1),
            "pos": torch.empty((), dtype=i32, device="meta"),
            "cache": cache}
