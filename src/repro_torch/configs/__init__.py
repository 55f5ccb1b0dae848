"""Architecture registry of the port: the dense decoders of the JAX
package (``olmo-1b``, ``internlm2-20b``, ``granite-3-2b``, ``qwen3-32b``)
and the paper's own models (``gpt2-small``, ``gpt2-medium``,
``bert-large``). ``get_config(name)`` / ``reduced_config(name)`` mirror
``repro.configs``."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.granite_3_2b import CONFIG as _granite_3_2b
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2_20b
from repro_torch.configs.olmo_1b import CONFIG as _olmo_1b
from repro_torch.configs.paper_models import (BERT_LARGE, GPT2_MEDIUM,
                                              GPT2_SMALL)
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3_32b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [_olmo_1b, _internlm2_20b, _granite_3_2b, _qwen3_32b,
                        GPT2_SMALL, GPT2_MEDIUM, BERT_LARGE]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)


def reduced_config(name: str, **overrides) -> ModelConfig:
    """Family-faithful tiny config for CPU tests: same structure (GQA
    ratio, norm, MLP, head, causality), small dims — the same reduction as
    ``repro.configs``."""
    cfg = get_config(name)
    heads = min(cfg.num_heads, 4)
    ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    small = dict(
        num_layers=2,
        d_model=64,
        num_heads=heads,
        num_kv_heads=max(1, heads // ratio),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        window=min(cfg.window, 64) if cfg.window else None,
        dtype="float32",
        remat=False,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
