"""whisper-large-v3 [arXiv:2212.04356]: enc-dec audio transformer backbone.

32 encoder + 32 decoder layers, d_model=1280, 20 heads (kv=20 -> MHA),
d_ff=5120, vocab=51866, GELU MLP, LayerNorm, learned/sinusoidal positions
(no RoPE).  The conv audio frontend is a STUB per the task block:
input_specs() supplies precomputed 1500-frame embeddings.
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_enc_layers=32,
    enc_positions=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    block_pattern=(ATTN,),
    mlp="gelu",
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=0.0,      # absolute positions, no rope
    supports_long_context=False,
)
