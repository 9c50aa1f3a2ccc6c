"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-*]: interleaved MoE.

48 layers, d_model=5120, 40 heads (GQA kv=8), d_ff=8192, vocab=202048.
MoE: 128 experts, top-1, sigmoid router, parallel shared expert, MoE in
every *second* layer (interleave=2, hf `interleave_moe_layer_step=2`) —
with MoE in all 48 layers the stated dims total ~780B; 1:2 interleave
totals ~398B, matching the 400B name.  Recorded in DESIGN.md §6.
"""

from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    block_pattern=(ATTN, ATTN),     # dense-FFN layer, MoE layer
    mlp="swiglu",
    rope_theta=500000.0,
    moe=MoEConfig(
        n_experts=128,
        top_k=1,
        d_ff_expert=8192,
        router="sigmoid",
        shared_expert=True,
        interleave=2,
    ),
    moment_dtype="bfloat16",        # ~400B params: bf16 moments to fit HBM
    supports_long_context=False,
)
