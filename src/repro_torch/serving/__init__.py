"""Serving: the batched engine and the retry-aware quantized KV store."""

from repro_torch.serving.engine import ServeEngine, ServeStats  # noqa: F401
from repro_torch.serving.kv_store import (  # noqa: F401
    KVReadStats,
    QuantizedKVStore,
)
