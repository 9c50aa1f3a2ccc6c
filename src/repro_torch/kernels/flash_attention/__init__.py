"""Forward flash attention: the CUDA kernel on the card, the plain torch
dense softmax on the CPU (``ops``), beside the plain version (``plain``)."""

from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
    flash_attention_fwd,
)
from repro_torch.kernels.flash_attention.plain import (  # noqa: F401
    flash_attention_plain,
)
