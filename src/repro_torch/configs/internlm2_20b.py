"""InternLM2-20B [arXiv:2403.17297; hf:internlm/internlm2-20b].

48L, d_model 6144, 48 heads GQA kv=8, d_ff 16384, vocab 92544.
RMSNorm + SwiGLU + RoPE (theta 1e6 for long context).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544,
    norm_type="rmsnorm", mlp_type="swiglu", rope_theta=1e6,
    tie_embeddings=False,
)
