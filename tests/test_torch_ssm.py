"""The port's Mamba2 (SSD) layer against ``repro.models.ssm`` on the CPU,
in float32, the same inputs (numpy, from a seed) on both sides:

  * ``ssd_chunked`` over several (seq, chunk) pairs, one padded (seq not
    a chunk multiple) and one of a single chunk, with its final state
    (atol 1e-5);
  * ``apply_ssm`` with both conv stems (shifts and the depthwise conv) and
    both decay dtypes (float32, and bfloat16 operands with a float32
    product, as the reference's ``preferred_element_type``), with its
    final state {"h", "conv"} (atol 1e-5), also for a prompt shorter than
    the conv's w-1 rows (the reference's slice keeps fewer rows);
  * a chain of ``decode_ssm_step`` calls equal to the full forward, and the
    prefill -> decode handoff (prefill k tokens, decode the rest), each
    step against the reference's decode step;
  * the gradients of every parameter and of x against ``jax.grad``
    (atol 1e-4 once scaled by their max), and finite gradients where the
    decays are long (exponents far below zero, where an unclamped
    ``exp`` would overflow in the masked half of the decay matrix).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import ssm as jssm
from repro_torch.configs import reduced_config
from repro_torch.models import ssm

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ARCH = "mamba2-2.7b"
# the reference's layer functions, compiled (op-by-op dispatch of their
# chunk scans and decode chains is many times slower)
_japply = jax.jit(jssm.apply_ssm, static_argnums=(1,),
                  static_argnames=("return_final_state",))
_jdecode = jax.jit(jssm.decode_ssm_step, static_argnums=(1,))
_jssd = jax.jit(jssm.ssd_chunked, static_argnums=(5,),
                static_argnames=("return_final_state",))


def _cfgs(**overrides):
    return (reduced_config(ARCH, **overrides),
            jax_reduced_config(ARCH, **overrides))


def _params(jcfg, seed=0):
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    # a non-zero conv bias, so that its gradient and its use are tested
    jp["conv_b"] = jnp.asarray(rng.standard_normal(jp["conv_b"].shape) * 0.1,
                               jnp.float32)
    np_p = jax.tree.map(np.asarray, jp)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in np_p.items()}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("seq,chunk", [(32, 16), (40, 16), (16, 16), (24, 8)])
def test_ssd_chunked_matches_jax(seq, chunk):
    rng = np.random.default_rng(seq + chunk)
    b, h, p, n = 2, 3, 4, 5
    x = rng.standard_normal((b, seq, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, seq, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    b_in = rng.standard_normal((b, seq, n)).astype(np.float32)
    c_in = rng.standard_normal((b, seq, n)).astype(np.float32)
    args = (x, dt, dt * a, b_in, c_in)
    want_y, want_h = _jssd(*map(jnp.asarray, args), chunk,
                           return_final_state=True)
    got_y, got_h = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk,
                                   return_final_state=True)
    assert got_y.shape == (b, seq, h, p) and got_h.shape == (b, h, p, n)
    _close(got_y, want_y, 1e-5)
    _close(got_h, want_h, 1e-5)
    plain = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert torch.equal(plain, got_y)


@pytest.mark.parametrize("fast_conv", [False, True])
@pytest.mark.parametrize("decay_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [37, 2])
def test_apply_ssm_matches_jax(fast_conv, decay_dtype, seq):
    """The layer and its final state; at seq 2 (< w-1 = 3) the conv state
    is what the reference's slice ``conv_in[:, s - (w-1):]`` gives."""
    cfg, jcfg = _cfgs(fast_conv=fast_conv, ssm_decay_dtype=decay_dtype)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, seq, cfg.d_model)).astype(np.float32)
    want, wstate = _japply(jp, jcfg, jnp.asarray(x), return_final_state=True)
    got, state = ssm.apply_ssm(tp, cfg, torch.from_numpy(x),
                               return_final_state=True)
    _close(got, want, 1e-5)
    assert state["conv"].shape == wstate["conv"].shape
    _close(state["h"], wstate["h"], 1e-5)
    _close(state["conv"], wstate["conv"], 1e-5)


def test_decode_chain_and_prefill_handoff_match_full_forward():
    """Prefill the first k tokens (k = 0: a zero state), then decode the
    rest one token at a time: each step's output equals the full forward's
    row and the reference's decode step, and the state after the last step
    equals the full prefill's final state."""
    cfg, jcfg = _cfgs()
    jp, tp = _params(jcfg, seed=2)
    s = 21
    x = np.random.default_rng(3).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    full, full_state = ssm.apply_ssm(tp, cfg, torch.from_numpy(x),
                                     return_final_state=True)
    _close(full, _japply(jp, jcfg, jnp.asarray(x)), 1e-5)
    for k in (0, 5, 17):
        if k:
            _, state = ssm.apply_ssm(tp, cfg, torch.from_numpy(x[:, :k]),
                                     return_final_state=True)
            _, jstate = _japply(jp, jcfg, jnp.asarray(x[:, :k]),
                                return_final_state=True)
        else:
            state = ssm.init_ssm_state(cfg, 2, torch.float32, "cpu")
            jstate = jssm.init_ssm_state(jcfg, 2, jnp.float32)
        for t in range(k, s):
            y, state = ssm.decode_ssm_step(tp, cfg,
                                           torch.from_numpy(x[:, t:t + 1]),
                                           state)
            jy, jstate = _jdecode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                  jstate)
            _close(y, jy, 1e-5)
            _close(y[:, 0], full[:, t], 1e-5)
        _close(state["h"], full_state["h"], 1e-5)
        _close(state["conv"], full_state["conv"], 1e-5)
        _close(state["h"], jstate["h"], 1e-5)


def _grads_vs_jax(cfg, jcfg, jp, tp, x, cot):
    def jloss(p, xx):
        return jnp.sum(jssm.apply_ssm(p, jcfg, xx) * cot)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xx = torch.from_numpy(x).requires_grad_()
    y = ssm.apply_ssm(leaves, cfg, xx)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                [xx, *leaves.values()])
    want = [np.asarray(jgx)] + [np.asarray(jg[k]) for k in leaves]
    for name, g, w in zip(["x", *leaves], grads, want):
        assert torch.isfinite(g).all(), name
        s = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / s, w / s, atol=1e-4, rtol=0,
                                   err_msg=name)
    return grads


@pytest.mark.parametrize("seq", [40, 16])
def test_gradients_match_jax_grad(seq):
    cfg, jcfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    _grads_vs_jax(cfg, jcfg, jp, tp, x, cot)


def test_gradients_finite_at_long_decays():
    """Steps of dt ~ 20 and A down to -exp(5): chunk log-decays near -1e4,
    so exp(cum_i - cum_j) for j > i would overflow without the clamp
    before exp; every gradient stays finite and equal to the
    reference's."""
    cfg, jcfg = _cfgs()
    jp, tp = _params(jcfg, seed=6)
    h = cfg.ssm_num_heads
    a_log = np.linspace(2.0, 5.0, h).astype(np.float32)
    dt_bias = np.full((h,), 20.0, np.float32)
    jp = dict(jp, A_log=jnp.asarray(a_log), dt_bias=jnp.asarray(dt_bias))
    tp = dict(tp, A_log=torch.from_numpy(a_log),
              dt_bias=torch.from_numpy(dt_bias))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    grads = _grads_vs_jax(cfg, jcfg, jp, tp, x, cot)
    assert float(grads[0].abs().max()) > 0


def test_bf16_layer_keeps_float32_parameters():
    """In a bf16 model ``A_log``, ``D`` and ``dt_bias`` stay float32 (as the
    reference's ``init_ssm`` makes them), every other leaf is bf16, and the
    layer's output and state keep the reference's dtypes."""
    cfg = dataclasses.replace(reduced_config(ARCH), dtype="bfloat16")
    p = ssm.init_ssm(cfg, torch.bfloat16, generator=torch.Generator(),
                     device="cpu")
    jp = jssm.init_ssm(jax.random.PRNGKey(0), jax_reduced_config(ARCH),
                       jnp.bfloat16)
    for k, t in p.items():
        assert t.shape == jp[k].shape, k
        assert str(t.dtype).removeprefix("torch.") == str(jp[k].dtype), k
    assert {k for k, t in p.items() if t.dtype == torch.float32} == {
        "A_log", "D", "dt_bias"}
    y, state = ssm.apply_ssm(p, cfg, torch.randn(1, 20, cfg.d_model,
                                                 dtype=torch.bfloat16),
                             return_final_state=True)
    assert y.dtype == state["conv"].dtype == torch.bfloat16
    assert state["h"].dtype == torch.float32
