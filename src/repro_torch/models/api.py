"""Public model API: ``build_model(cfg, device, generator)`` -> Model bundle.

The port builds the decoder family: global and sliding-window attention,
Mamba-2 SSD blocks and RG-LRU blocks (with the pattern tail of
recurrentgemma), each attention or RG-LRU layer with a dense MLP or the
MoE FFN (olmoe, llama4).  Encoder-decoder and VLM families raise
``NotImplementedError`` (ROADMAP D12); ``input_specs`` is JAX dry-run
tooling and waits for ROADMAP item 13.  ``train_loss`` trains every
block kind but Mamba-2's (ROADMAP D14b).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm as LM


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable                # () -> params, drawn from the generator
    train_loss: Callable          # (params, batch) -> scalar loss
    prefill: Callable             # (params, batch) -> (logits, cache)
    decode_step: Callable         # (params, batch{token,pos,cache}) -> (logits, cache)

    def input_specs(self, *args, **kw):
        raise NotImplementedError("input_specs is dry-run tooling: "
                                  "ROADMAP item 13")


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> Model:
    """Model bundle for ``cfg`` on ``device`` (``None``: the CUDA card).

    ``generator`` draws the parameters of ``Model.init``; by default a
    generator on ``device`` seeded with 0.
    """
    dev = resolve_device(device)
    if cfg.family != "decoder":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported: ROADMAP D12")
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    return Model(cfg=cfg,
                 init=functools.partial(LM.lm_init, cfg, generator),
                 train_loss=functools.partial(LM.train_loss, cfg),
                 prefill=functools.partial(LM.prefill, cfg),
                 decode_step=functools.partial(LM.decode_step, cfg))
