"""SeamlessM4T-medium [arXiv:2308.11596; hf:facebook/seamless-m4t-medium].

Encoder-decoder, 12+12L, d_model 1024, 16 heads (kv=16), d_ff 4096,
vocab 256206 (NLLB multilingual). The speech frontend (fbank + conformer
feature extractor) is a stub: the batch carries precomputed frame
embeddings (dim 160 = 80-mel x 2 stacking) under ``"frames"``. LayerNorm +
GELU FFN. Self-attention uses RoPE instead of learned positions, as in
the JAX package; cross-attention has none.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, num_encoder_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    norm_type="layernorm", mlp_type="gelu",
    frontend="audio", frontend_dim=160,
    tie_embeddings=True,
)
