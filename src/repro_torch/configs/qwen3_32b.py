"""Qwen3-32B [hf:Qwen/Qwen3-32B family; assignment cites Qwen3-8B card].

64L, d_model 5120, 64 heads GQA kv=8, d_ff 25600, vocab 151936.
Distinctive: QK-RMSNorm inside attention, decoupled head_dim=128
(q-proj 64*128=8192 != d_model). RMSNorm + SwiGLU + RoPE(1e6).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936,
    qk_norm=True, norm_type="rmsnorm", mlp_type="swiglu", rope_theta=1e6,
    tie_embeddings=False,
)
