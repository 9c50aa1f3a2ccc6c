"""deepseek-67b [arXiv:2401.02954; hf]: dense llama-arch.

95 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=22016, vocab=102400.
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=102400,
    block_pattern=(ATTN,),
    mlp="swiglu",
    rope_theta=10000.0,
    moment_dtype="bfloat16",   # 67B: keep optimizer state within HBM budget
    supports_long_context=False,
)
