"""deepseek-coder-33b [arXiv:2401.14196; hf]: dense llama-arch code model.

62 layers, d_model=7168, 56 heads (GQA kv=8), d_ff=19200, vocab=32256.
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    block_pattern=(ATTN,),
    mlp="swiglu",
    rope_theta=100000.0,
    supports_long_context=False,
)
