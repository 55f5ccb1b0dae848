"""OLMoE-1B-7B [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924].

16L, d_model 2048, 16 heads (kv=16), vocab 50304. MoE FFN: 64 experts,
top-8, d_ff 1024 per expert (1B active / 7B total). RMSNorm + SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    num_experts=64, num_experts_per_token=8,
    norm_type="rmsnorm", mlp_type="swiglu",
    tie_embeddings=False,
)
