"""llama3.2-3b [hf:meta-llama/Llama-3.2-3B]: small llama3.

28 layers, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=128256.
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    block_pattern=(ATTN,),
    mlp="swiglu",
    rope_theta=500000.0,
    tie_embeddings=True,
    supports_long_context=False,
)
