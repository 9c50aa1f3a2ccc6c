"""Batched serving engine with retry-aware KV reads.

  admit(prompts) -> prefill (one batched pass) -> decode loop
                     |                              |
                     v                              v
              QuantizedKVStore.pack()        materialize() -> decode_step
                                              -> update() + sample

Requests of unequal length are left-padded to the batch maximum so the
KV cache is rectangular (static-batch serving).  The prefill keeps no
cache headroom, as the reference's engine does, so each decode step
writes the last cache slot (ROADMAP C6).  As the reference's engine
does, the VLM prefills over zero patch embeddings and decodes from
position T + n_patches, and the encoder-decoder over zero frame
embeddings; its static cross-attention leaves are read (and
re-quantized) every step like the others.  Greedy sampling keeps outputs
deterministic.  ``RetryPolicy`` "baseline" serves every read from the
backing tier; the AR² mechanisms serve margin-cleared pages from int8.
Times are host-clock seconds around work that ends in a device
synchronize.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.retry import RetryPolicy
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model, frontend_zeros
from repro_torch.serving.kv_store import KVReadStats, QuantizedKVStore


@dataclasses.dataclass
class ServeStats:
    n_requests: int
    prompt_tokens: int
    generated_tokens: int
    prefill_s: float
    decode_s: float
    tokens_per_s: float
    kv: KVReadStats

    def summary(self) -> str:
        return (
            f"reqs={self.n_requests} prompt={self.prompt_tokens}tok "
            f"gen={self.generated_tokens}tok prefill={self.prefill_s * 1e3:.1f}ms "
            f"decode={self.decode_s * 1e3:.1f}ms ({self.tokens_per_s:.1f} tok/s) "
            f"kv_fast={100 * self.kv.fast_fraction:.1f}% "
            f"hbm_saved={100 * self.kv.bytes_saved_fraction:.1f}%"
        )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params=None,
                 policy: RetryPolicy = RetryPolicy("pr2ar2"),
                 tau: float = 0.05, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(self.device).manual_seed(seed)
        self.model = build_model(cfg, self.device, gen)
        self.params = params if params is not None else self.model.init()
        self.policy = policy
        self.store = QuantizedKVStore(policy, tau=tau)

    def _pad_batch(self, prompts: List[np.ndarray]) -> np.ndarray:
        T = max(len(p) for p in prompts)
        out = np.zeros((len(prompts), T), np.int64)
        for i, p in enumerate(prompts):
            out[i, T - len(p):] = p  # left-pad
        return out

    def _greedy(self, logits) -> np.ndarray:
        return logits[:, -1].argmax(dim=-1).to(torch.int32).cpu().numpy()

    @torch.inference_mode()
    def generate(self, prompts: List[np.ndarray], max_new_tokens: int = 16,
                 eos_id: Optional[int] = None) -> Tuple[np.ndarray, ServeStats]:
        tokens = self._pad_batch(prompts)
        B, T = tokens.shape
        batch = {"tokens": torch.as_tensor(tokens, device=self.device),
                 **frontend_zeros(self.cfg, B, self.device)}

        _sync(self.device)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, batch)
        _sync(self.device)
        prefill_s = time.perf_counter() - t0
        self.store.pack(cache)

        out = [self._greedy(logits)]
        pos = T + (self.cfg.n_patches if self.cfg.family == "vlm" else 0)
        done = np.zeros((B,), bool)

        t0 = time.perf_counter()
        for step in range(max_new_tokens - 1):
            step_batch = {
                "token": torch.as_tensor(out[-1][:, None], dtype=torch.int64,
                                         device=self.device),
                "pos": pos + step,
                "cache": self.store.materialize(),
            }
            logits, new_cache = self.model.decode_step(self.params, step_batch)
            self.store.update(new_cache)
            nxt = self._greedy(logits)
            if eos_id is not None:
                done |= nxt == eos_id
                nxt = np.where(done, eos_id, nxt)
            out.append(nxt)
            if eos_id is not None and done.all():
                break
        _sync(self.device)
        decode_s = time.perf_counter() - t0

        gen = np.stack(out, axis=1)
        stats = ServeStats(
            n_requests=B,
            prompt_tokens=int(sum(len(p) for p in prompts)),
            generated_tokens=int(gen.size),
            prefill_s=prefill_s,
            decode_s=decode_s,
            tokens_per_s=gen.size / decode_s if decode_s else 0.0,
            kv=self.store.stats,
        )
        return gen, stats
