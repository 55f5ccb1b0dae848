"""The port's architecture registry against the JAX package's: every
field the two ``ModelConfig`` classes share is equal for each of the seven
dense archs, at the published size and after ``reduced_config`` (also with
overrides), and the config's ``window`` reaches the ``AttentionSpec`` the
attention layer builds, as in the reference."""

import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models.attention_layer import attn_spec_from_config as jax_spec
from repro_torch.configs import ARCHS, get_config, list_archs, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention_layer import attn_spec_from_config

DENSE = ["granite-3-2b", "olmo-1b", "qwen3-32b", "internlm2-20b",
         "gpt2-small", "gpt2-medium", "bert-large"]


def _shared(port_cfg, jax_cfg):
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    jax_names = {f.name for f in dataclasses.fields(jax_cfg)}
    assert names <= jax_names, f"fields the JAX config lacks: {names - jax_names}"
    return ({n: getattr(port_cfg, n) for n in sorted(names)},
            {n: getattr(jax_cfg, n) for n in sorted(names)})


def test_registry_holds_the_dense_archs():
    assert sorted(ARCHS) == sorted(DENSE) == list_archs()
    with pytest.raises(KeyError):
        get_config("mamba2-2.7b")


@pytest.mark.parametrize("arch", DENSE)
def test_published_fields_equal_jax(arch):
    ours, ref = _shared(get_config(arch), jax_get_config(arch))
    assert ours == ref


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("overrides", [{}, {"head_dim": 32, "window": 300},
                                       {"num_layers": 1, "causal": False}])
def test_reduced_fields_equal_jax(arch, overrides):
    ours, ref = _shared(reduced_config(arch, **overrides),
                        jax_reduced_config(arch, **overrides))
    assert ours == ref


def test_reduction_clamps_the_window():
    """``window`` is cut to at most 64 by the reduction, as in the
    reference; the reduced dims keep each arch's GQA ratio, norm, MLP, head
    tying and causality."""
    big = dataclasses.replace(get_config("olmo-1b"), window=4096)
    ARCHS["_windowed"] = big = dataclasses.replace(big, name="_windowed")
    try:
        assert reduced_config("_windowed").window == 64
    finally:
        del ARCHS["_windowed"]
    q = reduced_config("qwen3-32b")
    assert (q.num_heads, q.num_kv_heads, q.qk_norm, q.tie_embeddings) == \
        (4, 1, True, False)
    b = reduced_config("bert-large")
    assert (b.causal, b.norm_type, b.mlp_type) == (False, "layernorm", "gelu")


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("arch", ["olmo-1b", "bert-large"])
def test_window_reaches_the_attention_spec(arch, window):
    cfg = reduced_config(arch, window=window, attn_impl="pallas")
    spec = attn_spec_from_config(cfg)
    ref = jax_spec(jax_reduced_config(arch, window=window, attn_impl="pallas"))
    assert spec.window == ref.window == window
    assert (spec.causal, spec.impl) == (ref.causal, ref.impl)
