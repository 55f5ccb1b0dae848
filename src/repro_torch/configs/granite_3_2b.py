"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model 2048, 32 heads GQA kv=8, d_ff 8192, vocab 49155.
RMSNorm + SwiGLU + RoPE; tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=49155,
)
