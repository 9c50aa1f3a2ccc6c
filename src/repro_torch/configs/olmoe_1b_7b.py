"""olmoe-1b-7b [arXiv:2409.02060; hf]: 64-expert top-8 MoE (1B active/7B total).

16 layers, d_model=2048, 16 heads (MHA kv=16), expert d_ff=1024,
vocab=50304, QK-norm.
"""

from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    block_pattern=(ATTN,),
    mlp="swiglu",
    rope_theta=10000.0,
    qk_norm=True,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024, router="softmax"),
    supports_long_context=False,
)
