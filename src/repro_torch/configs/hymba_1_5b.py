"""Hymba-1.5B [arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base].

32L hybrid-head blocks: attention heads AND mamba heads consume the same
input in parallel, per-path normalized then averaged. 25 q heads (GQA kv=5,
head_dim 64), d_model 1600, d_ff 5504, vocab 32001, ssm_state 16.
Attention is causal sliding-window (1024) in every layer, as in the
reference (which approximates Hymba's first/middle/last global-attention
layers as windowed).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", hybrid=True,
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    window=1024,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    norm_type="rmsnorm", mlp_type="swiglu",
    tie_embeddings=True,
)
