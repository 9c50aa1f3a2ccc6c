"""Public model API: ``build_model(cfg, device, generator)`` -> Model bundle.

The port builds every family: the decoder (global and sliding-window
attention, Mamba-2 SSD blocks and RG-LRU blocks with the pattern tail of
recurrentgemma, each attention or RG-LRU layer with a dense MLP or the
MoE FFN of olmoe and llama4), the VLM (internvl2: the decoder over a
patch prefix, ``batch["patches"]``) and the encoder-decoder (whisper:
``models.encdec``, ``batch["audio_embed"]``).  ``input_specs`` is the
dry-run's and waits for ROADMAP D15b.  ``train_loss`` trains every block
kind, Mamba-2's SSD blocks through the plain scan.  Parameters may be
plain tensors or DTensors on a mesh (``distributed.steps``); on
``device="meta"`` ``init`` gives the parameter tree's shapes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
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

    def input_specs(self, *args, **kw):
        raise NotImplementedError("input_specs is the dry-run's: "
                                  "ROADMAP D15b, the rest of item 13")


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
    if generator is None:
        generator = _MetaGenerator() if dev.type == "meta" else \
            torch.Generator(dev).manual_seed(0)
    if cfg.family == "encdec":
        return Model(cfg=cfg,
                     init=functools.partial(ED.encdec_init, cfg, generator),
                     train_loss=functools.partial(ED.train_loss, cfg),
                     prefill=functools.partial(ED.prefill, cfg),
                     decode_step=functools.partial(ED.decode_step, cfg))
    return Model(cfg=cfg,
                 init=functools.partial(LM.lm_init, cfg, generator),
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
