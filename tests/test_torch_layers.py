"""The port's primitive layers against ``repro.models.layers`` on the CPU,
in fp32 and bf16, from numpy seeds: ``apply_norm`` for RMSNorm, LayerNorm
and non-parametric LayerNorm, the qk-norm base ``rms_normalize`` (eps
1e-6), ``apply_mlp`` for SwiGLU, GeGLU and GELU (JAX's tanh-approximate
gelu), and the qk-normed q/k projection of the attention layer.

Tolerances: fp32 atol 1e-5 (norms) and 1e-4 (MLPs, logits-scale);
bf16 norms bit-equal (both compute in fp32 and round once); bf16 MLPs
within one bf16 rounding of the largest output (2**-7 * max |ref|),
since the two packages' bf16 matmuls may round their fp32 sums apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import attention_layer as jax_attn
from repro.models import layers as JL
from repro_torch.configs import reduced_config
from repro_torch.models import attention_layer as port_attn
from repro_torch.models import layers as TL

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _both(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.tensor(a).to(tdt), jnp.asarray(a, jdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _x(seed, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 5, d)) * 3 + 0.5).astype(np.float32), rng


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm", "layernorm_np"])
def test_apply_norm_matches_jax(norm_type, dtype):
    x, rng = _x(0)
    p = {"w": rng.standard_normal(64).astype(np.float32),
         "b": rng.standard_normal(64).astype(np.float32)}
    p = {"rmsnorm": {"w": p["w"]}, "layernorm": p, "layernorm_np": {}}[norm_type]
    tp = {k: _both(v, dtype)[0] for k, v in p.items()}
    jp = {k: _both(v, dtype)[1] for k, v in p.items()}
    tx, jx = _both(x, dtype)
    got = TL.apply_norm(tp, tx, norm_type)
    want = JL.apply_norm(jp, jx, norm_type)
    assert got.dtype == tx.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    # the params each norm type initialises, as the reference
    init = TL.init_norm(64, norm_type, torch.float32, "cpu")
    ref = JL.init_norm(None, 64, norm_type, jnp.float32)
    assert init.keys() == ref.keys()
    for k in init:
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rms_normalize_matches_jax(dtype):
    x, _ = _x(1, d=16)
    x[0, 0] = 0.0                      # eps 1e-6 keeps an all-zero row finite
    tx, jx = _both(x, dtype)
    got, want = TL.rms_normalize(tx), JL.rms_normalize(jx)
    assert np.isfinite(_np(got)).all()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_apply_mlp_matches_jax(mlp_type, dtype):
    x, rng = _x(2)
    w = {n: (rng.standard_normal(s) / 8).astype(np.float32) for n, s in
         (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    if mlp_type == "gelu":
        del w["w_gate"]
    got = TL.apply_mlp({k: _both(v, dtype)[0] for k, v in w.items()},
                       _both(x, dtype)[0], mlp_type)
    want = _np(JL.apply_mlp({k: _both(v, dtype)[1] for k, v in w.items()},
                            _both(x, dtype)[1], mlp_type))
    atol = 2.0 ** -7 * np.abs(want).max() if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=0)
    init = TL.init_mlp(64, 128, mlp_type, torch.float32,
                       generator=torch.Generator().manual_seed(0), device="cpu")
    assert init.keys() == w.keys()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_qk_norm_projection_matches_jax(dtype):
    """qk-norm normalises each head in fp32, rounds to q's dtype, then
    scales by ``q_norm`` in that dtype. With identity projections the
    matmuls are exact, so in bf16 the result is bit-equal to JAX's only if
    the order of rounding is the same."""
    x, rng = _x(3)
    cfg = reduced_config("qwen3-32b", num_kv_heads=4)     # 4 x 16 = d_model
    jcfg = jax_reduced_config("qwen3-32b", num_kv_heads=4)
    eye = np.eye(64, dtype=np.float32)
    p = {"wq": eye, "wk": eye, "wv": eye, "wo": eye,
         "q_norm": (1 + rng.standard_normal(16) / 3).astype(np.float32),
         "k_norm": (1 + rng.standard_normal(16) / 3).astype(np.float32)}
    tx, jx = _both(x, dtype)
    got = port_attn._project_qkv({k: _both(v, dtype)[0] for k, v in p.items()},
                                 cfg, tx, tx, None, None)
    want = jax_attn._project_qkv({k: _both(v, dtype)[1] for k, v in p.items()},
                                 jcfg, jx, jx, None, None)
    for g, w in zip(got, want):
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_np(g), _np(w))
        else:
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=0)
    init = port_attn.init_attention(cfg, torch.float32,
                                    generator=torch.Generator().manual_seed(0),
                                    device="cpu")
    assert init["q_norm"].shape == init["k_norm"].shape == (16,)
