"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model 4096, 32 heads GQA kv=8, vocab 32064. MoE FFN: 16 experts,
top-2, d_ff 6400 per expert. head_dim 128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    num_experts=16, num_experts_per_token=2,
    norm_type="rmsnorm", mlp_type="swiglu",
    tie_embeddings=False,
)
