"""gemma2-2b [arXiv:2408.00118; hf]: alternating local/global + softcaps.

26 layers in the pattern (local, global), d_model=2304, 8 heads (GQA kv=4),
head_dim=256, d_ff=9216 GeGLU, vocab=256000, window 4096, attention logit
softcap 50, final logit softcap 30.
"""

from repro_torch.configs.base import ATTN, LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    block_pattern=(LOCAL, ATTN),
    window=4096,
    mlp="geglu",
    rope_theta=10000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    scale_embed=True,
    tie_embeddings=True,
    supports_long_context=False,   # global layers attend over the full ctx
)
