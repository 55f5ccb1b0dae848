"""OLMo-1B [arXiv:2402.00838; hf:allenai/OLMo-1B].

16L, d_model 2048, 16 heads (MHA — kv=16), d_ff 8192, vocab 50304.
Distinctive: NON-PARAMETRIC LayerNorm (no scale/bias), SwiGLU, RoPE,
untied embeddings in hf (we follow: tie=False).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm_type="layernorm_np", mlp_type="swiglu",
    tie_embeddings=False,
)
