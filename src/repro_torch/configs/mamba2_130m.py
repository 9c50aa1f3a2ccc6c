"""mamba2-130m [arXiv:2405.21060]: attention-free SSD (state-space duality).

24 SSD layers, d_model=768, ssm_state=128, head_dim=64 (24 heads at
expand=2), vocab=50280.  O(1)-state decode: runs long_500k.
"""

from repro_torch.configs.base import SSM, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    n_layers=24,
    d_model=768,
    n_heads=1,            # attention-free; unused
    n_kv_heads=1,
    d_ff=0,               # no FFN: the SSD block is the mixer
    vocab=50280,
    block_pattern=(SSM,),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    supports_long_context=True,
)
