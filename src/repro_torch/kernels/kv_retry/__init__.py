"""Margin-aware quantized-KV retry read: the CUDA kernel on the card, the
plain torch version on the CPU (``ops``), and the page quantizer."""

from repro_torch.kernels.kv_retry.ops import (  # noqa: F401
    kv_read_with_retry,
    kv_retry_fwd,
    quantize_pages,
)
from repro_torch.kernels.kv_retry.plain import kv_retry_plain  # noqa: F401
