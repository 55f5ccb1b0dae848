"""Phi-3-vision-128k [hf:microsoft/Phi-3-vision-128k-instruct].

Backbone: phi3-mini — 32L, d_model 3072, 32 heads (MHA, kv=32) of 96,
d_ff 8192, vocab 32064. The CLIP ViT-L/14 image frontend is a stub, as in
the JAX package: the batch carries precomputed patch embeddings (576
tokens of dim 1024 for a 336px image) under ``"patches"``, which a
learned projection maps into the text stream ahead of the tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    norm_type="rmsnorm", mlp_type="swiglu",
    frontend="vision", frontend_tokens=576, frontend_dim=1024,
    tie_embeddings=False,
)
