"""Quantized, margin-aware KV store — the AR²/PR² adaptation for serving.

The decode-time KV working set is the serving analogue of the paper's
flash page: its read cost ("tR") is device-memory bytes.  The store
keeps every attention cache leaf in two tiers:

  * fast tier: per-page symmetric int8 (a page = one sequence position's
    head_dim vector per unit/batch/kv-head) — the reduced-tR read;
  * backing tier: the original bfloat16/float32 copy — the full-tR
    fallback.

A read returns the fast tier wherever the page's quantization-error
bound sits within the margin tolerance (the ECC-capability-margin
analogue) and *retries* from backing elsewhere — one pass of the
``kv_retry`` kernel on the card.  Non-attention cache leaves stay as
they are, so for an attention-free model (Mamba-2's conv and SSM
states) the store is a passthrough that reads 0 pages, as the
reference's is.  Mechanism "baseline" keeps no fast tier and always reads
backing; the AR² mechanisms enable it; ``tau`` plays the role of the
characterized safe-tR table entry.

Caches are nested dicts and lists of tensors (a pattern tail is a
list of per-layer caches).  A leaf's key is the reference's key string
(``"['units']['b0']['attn']['k']"``, ``"['tail'][0]['rglru']['h']"``),
and leaves are walked in the reference's flattening order, so both
packages read the same pages in the same order.  Read statistics are
counted on the device and read back once per ``materialize``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.retry import RetryPolicy
from repro_torch.kernels.kv_retry.ops import kv_read_with_retry, quantize_pages


@dataclasses.dataclass
class KVReadStats:
    pages: int = 0
    fast_pages: int = 0              # served from int8 within margin
    retried_pages: int = 0           # re-read from backing
    fast_bytes: int = 0
    backing_bytes: int = 0

    @property
    def fast_fraction(self) -> float:
        return self.fast_pages / self.pages if self.pages else 0.0

    @property
    def bytes_saved_fraction(self) -> float:
        """Device-memory traffic saved vs an always-backing read."""
        full = (self.fast_bytes + self.backing_bytes) * 4  # backing is 4B/elt
        if not full:
            return 0.0
        moved = self.fast_bytes + 4 * self.backing_bytes
        return 1.0 - moved / full


def _leaves(tree, path=()):
    """(path, leaf) pairs in the reference's flattening order (dict keys
    sorted, list items in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over every leaf, in the reference's order."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def keystr(path) -> str:
    """``jax.tree_util.keystr``: ``['key']`` for a dict key, ``[i]`` for a
    list index."""
    return "".join(f"[{k!r}]" for k in path)


def _is_kv_leaf(path) -> bool:
    return any(k in ("attn", "xattn") for k in path) and path[-1] in ("k", "v")


class QuantizedKVStore:
    """Two-tier KV cache with margin-aware retry reads."""

    def __init__(self, policy: RetryPolicy = RetryPolicy("pr2ar2"),
                 tau: float = 0.05):
        self.policy = policy
        self.tau = tau
        self.fast: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.backing: Any = None
        self.stats = KVReadStats()

    # -- pack ---------------------------------------------------------------

    def pack(self, cache: Any) -> None:
        """Ingest a prefill cache (quantize attention leaves)."""
        self.backing = cache
        self.fast.clear()
        if not self.policy.adaptive_tr:
            return  # baseline: no fast tier
        for path, leaf in _leaves(cache):
            if not _is_kv_leaf(path) or leaf.dim() < 2:
                continue
            self.fast[keystr(path)] = quantize_pages(
                leaf.reshape(-1, leaf.shape[-1]))

    # -- read ------------------------------------------------------------------

    def materialize(self) -> Any:
        """Cache for the next decode step, reading through the fast tier
        with margin-aware retry."""
        if not self.fast:
            return self.backing
        counted = []                 # (pages, elements per page, fast count)

        def read(path, leaf):
            key = keystr(path)
            if key not in self.fast:
                return leaf
            q, s = self.fast[key]
            out, margin = kv_read_with_retry(
                q, s, leaf.reshape(-1, leaf.shape[-1]), tau=self.tau,
                device=leaf.device)
            counted.append((q.shape[0], leaf.shape[-1],
                            (margin[:, 0] >= 0.0).sum()))
            return out.reshape(leaf.shape)

        cache = _map_with_path(read, self.backing)
        fast = torch.stack([c for _, _, c in counted]).tolist()
        for (n, elt, _), f in zip(counted, fast):
            self.stats.pages += n
            self.stats.fast_pages += f
            self.stats.retried_pages += n - f
            self.stats.fast_bytes += f * elt
            self.stats.backing_bytes += (n - f) * elt
        return cache

    # -- update ---------------------------------------------------------------

    def update(self, new_cache: Any) -> None:
        """Adopt the post-decode cache (re-quantize attention leaves,
        whole, as the reference does)."""
        self.pack(new_cache)
