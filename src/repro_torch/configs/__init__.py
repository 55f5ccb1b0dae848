"""Architecture registry of the port: the dense decoders of the JAX
package (``olmo-1b``, ``internlm2-20b``, ``granite-3-2b``, ``qwen3-32b``),
its mixture-of-experts decoders (``olmoe-1b-7b``,
``phi3.5-moe-42b-a6.6b``), its state-space and hybrid decoders
(``mamba2-2.7b``, ``hymba-1.5b``), its encoder-decoder
(``seamless-m4t-medium``), its vision-language decoder
(``phi-3-vision-4.2b``) and the paper's own models (``gpt2-small``,
``gpt2-medium``, ``bert-large``). ``get_config(name)`` / ``reduced_config(name)`` mirror
``repro.configs``; ``ASSIGNED`` (what ``list_archs`` returns) and
``get_shape`` / ``SHAPES`` name the dry-run's cells."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (SHAPES, ModelConfig,  # noqa: F401
                                      ShapeConfig, cell_is_applicable)
from repro_torch.configs.granite_3_2b import CONFIG as _granite_3_2b
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2_20b
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.olmo_1b import CONFIG as _olmo_1b
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.paper_models import (BERT_LARGE, GPT2_MEDIUM,
                                              GPT2_SMALL)
from repro_torch.configs.phi3_5_moe_42b import CONFIG as _phi35moe
from repro_torch.configs.phi_3_vision_4_2b import CONFIG as _phi3v
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3_32b
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [_olmo_1b, _internlm2_20b, _granite_3_2b, _qwen3_32b,
                        _seamless, _phi3v, _olmoe, _phi35moe, _hymba,
                        _mamba2,
                        GPT2_SMALL, GPT2_MEDIUM, BERT_LARGE]}


ASSIGNED = [
    "olmo-1b", "internlm2-20b", "granite-3-2b", "qwen3-32b",
    "phi-3-vision-4.2b", "seamless-m4t-medium", "hymba-1.5b",
    "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def list_archs() -> list[str]:
    """The assigned architectures (the dry-run's; ``ARCHS`` also holds the
    paper's GPT-2 and BERT models)."""
    return ASSIGNED


def reduced_config(name: str, **overrides) -> ModelConfig:
    """Family-faithful tiny config for CPU tests: same structure (GQA
    ratio, norm, MLP, head, causality, top-k routing, SSM heads), small
    dims — the same reduction as ``repro.configs`` (at most 8 experts,
    top-2; no attention heads and no MLP where the arch has none; SSM state
    at most 16, SSM heads of 16, chunks of 16; 2 encoder layers where the
    arch has an encoder, frontend embeddings of dim 32, 8 vision patches)."""
    cfg = get_config(name)
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = 0
    if cfg.num_heads:
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        kv = max(1, heads // ratio)
    small = dict(
        num_layers=2,
        num_encoder_layers=2 if cfg.num_encoder_layers else 0,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, 64) if cfg.window else None,
        num_experts=min(cfg.num_experts, 8),
        num_experts_per_token=min(cfg.num_experts_per_token, 2),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        frontend_tokens=8 if cfg.frontend == "vision" else 0,
        frontend_dim=32 if cfg.frontend else 0,
        dtype="float32",
        remat=False,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
