"""internvl2-1b [arXiv:2404.16821; hf]: InternViT frontend + 0.5B LM backbone.

24 layers, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151655.
The vision frontend is a STUB per the task block: input_specs() supplies
precomputed patch embeddings prepended to the token sequence.
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    block_pattern=(ATTN,),
    mlp="swiglu",
    rope_theta=1000000.0,
    tie_embeddings=True,
    n_patches=256,
    supports_long_context=False,
)
