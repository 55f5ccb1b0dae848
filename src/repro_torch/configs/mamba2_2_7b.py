"""Mamba2-2.7B [arXiv:2405.21060] — SSD (state-space duality), attention-free.

64L, d_model 2560, expand 2 (d_inner 5120), head_dim 64 (80 ssm heads),
ssm_state 128, conv width 4, vocab 50280. d_ff=0: Mamba2 blocks have no FFN.
No attention kernel runs for this arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    norm_type="rmsnorm",
    tie_embeddings=True,
)
