"""recurrentgemma-2b [arXiv:2402.19427; hf]: Griffin (RG-LRU + local attn 1:2).

26 layers in the pattern (recurrent, recurrent, local-attention), d=2560,
10 heads (kv=1 -> MQA), head_dim=256, d_ff=7680 GeGLU, vocab=256000,
window=2048.  Sub-quadratic decode: runs long_500k.
"""

from repro_torch.configs.base import LOCAL, RGLRU, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    block_pattern=(RGLRU, RGLRU, LOCAL),   # 8 full units + (RGLRU, RGLRU) tail
    window=2048,
    mlp="geglu",
    rope_theta=10000.0,
    scale_embed=True,
    tie_embeddings=True,
    rglru=RGLRUConfig(d_conv=4, lru_width=2560),
    supports_long_context=True,
)
