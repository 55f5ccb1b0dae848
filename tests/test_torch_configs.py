"""The port's architecture registry against the JAX package's: every
field the two ``ModelConfig`` classes share is equal for each of the seven
dense archs, the two MoE archs, the SSM and hybrid archs, the
encoder-decoder and the vision-language decoder, at the
published size and after ``reduced_config`` (also with overrides), the
reduction clamps the experts to 8 and the top-k to 2 as the reference's
does, gives no heads and no MLP where the arch has none, and the config's
``window`` reaches the ``AttentionSpec`` the attention layer builds, as
in the reference."""

import dataclasses

import pytest

from repro.configs import ARCHS as jax_archs
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs import reduced_config as jax_reduced_config
from repro.models.attention_layer import attn_spec_from_config as jax_spec
from repro_torch.configs import ARCHS, get_config, list_archs, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention_layer import attn_spec_from_config

DENSE = ["granite-3-2b", "olmo-1b", "qwen3-32b", "internlm2-20b",
         "gpt2-small", "gpt2-medium", "bert-large"]
MOE = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
SSM = ["mamba2-2.7b", "hymba-1.5b"]
ENCDEC = ["seamless-m4t-medium"]
VLM = ["phi-3-vision-4.2b"]


def _shared(port_cfg, jax_cfg):
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    jax_names = {f.name for f in dataclasses.fields(jax_cfg)}
    assert names <= jax_names, f"fields the JAX config lacks: {names - jax_names}"
    return ({n: getattr(port_cfg, n) for n in sorted(names)},
            {n: getattr(jax_cfg, n) for n in sorted(names)})


def test_registry_holds_the_dense_archs():
    """The dense archs, and beside them the MoE, SSM, hybrid,
    encoder-decoder and vision-language archs, under the reference's names
    and families: every arch of the reference."""
    assert sorted(ARCHS) == sorted(DENSE + MOE + SSM + ENCDEC + VLM) \
        == sorted(jax_archs)
    assert list_archs() == jax_list_archs()
    assert {a for a in ARCHS if get_config(a).family == "dense"} == set(DENSE)
    assert {a for a in ARCHS if get_config(a).family == "moe"} == set(MOE)
    assert get_config("mamba2-2.7b").family == "ssm"
    assert get_config("hymba-1.5b").family == "hybrid"
    assert get_config("seamless-m4t-medium").family == "encdec"
    assert get_config("phi-3-vision-4.2b").family == "vlm"
    with pytest.raises(KeyError):
        get_config("phi-3-vision")


@pytest.mark.parametrize("arch", DENSE + MOE + SSM + ENCDEC + VLM)
def test_published_fields_equal_jax(arch):
    ours, ref = _shared(get_config(arch), jax_get_config(arch))
    assert ours == ref


@pytest.mark.parametrize("arch", DENSE + MOE + SSM + ENCDEC + VLM)
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


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("overrides", [{}, {"moe_capacity_factor": 8.0},
                                       {"num_experts": 16,
                                        "num_experts_per_token": 4}])
def test_reduction_clamps_the_experts(arch, overrides):
    """At most 8 experts and top-2 after the reduction (the published 64 /
    top-8 and 16 / top-2 are cut as the reference cuts them), overrides
    applied last; the capacity factor keeps its 1.25 default."""
    ours, ref = _shared(reduced_config(arch, **overrides),
                        jax_reduced_config(arch, **overrides))
    assert ours == ref
    cfg = reduced_config(arch, **overrides)
    pub = get_config(arch)
    assert cfg.num_experts == overrides.get("num_experts",
                                            min(pub.num_experts, 8))
    assert cfg.num_experts_per_token == overrides.get(
        "num_experts_per_token", min(pub.num_experts_per_token, 2))
    assert cfg.moe_capacity_factor == overrides.get("moe_capacity_factor",
                                                    1.25)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_fields_and_reduction_match_jax(arch):
    """The SSM fields and properties the reference derives (d_inner, SSM
    heads) at the published size, and the reduction: no attention heads
    and no head_dim for mamba2, no MLP where d_ff is 0, SSM state at most
    16, SSM heads of 16, chunks of 16; mamba2's head_dim is d_model as in
    the reference (no kernel sees it)."""
    for ours, ref in ((get_config(arch), jax_get_config(arch)),
                      (reduced_config(arch), jax_reduced_config(arch))):
        for name in ("ssm_d_inner", "ssm_num_heads", "attention_free"):
            assert getattr(ours, name) == getattr(ref, name), name
    m = get_config("mamba2-2.7b")
    assert (m.head_dim, m.ssm_num_heads, m.ssm_d_inner) == (2560, 80, 5120)
    r = reduced_config(arch)
    assert r.ssm_state == 16 and r.ssm_head_dim == 16 and r.ssm_chunk == 16
    assert (r.num_heads, r.d_ff) == ((0, 0) if arch == "mamba2-2.7b"
                                     else (4, 128))
