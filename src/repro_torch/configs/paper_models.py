"""The paper's own experiment models (Tables 1, 2, 4): GPT-2 small/medium
(decoder LM) and BERT-large (bidirectional encoder, used for the MLPerf
Table-1 benchmark; trained here with the LM harness in non-causal mode —
step-time benchmarking only)."""
from repro_torch.configs.base import ModelConfig

GPT2_SMALL = ModelConfig(
    name="gpt2-small", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=50257,
    norm_type="layernorm", mlp_type="gelu",
    tie_embeddings=True,
)

GPT2_MEDIUM = ModelConfig(
    name="gpt2-medium", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=50257,
    norm_type="layernorm", mlp_type="gelu",
    tie_embeddings=True,
)

BERT_LARGE = ModelConfig(
    name="bert-large", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=30522,
    causal=False,
    norm_type="layernorm", mlp_type="gelu",
    tie_embeddings=True,
)
