"""Training parity on the CPU, on ``reduced_config("granite-3-2b")`` with
the JAX package's weights handed over by ``params_from_jax``:

  * ``Model.loss`` and its gradient with respect to every parameter
    against ``jax.value_and_grad`` of the JAX model, for ``attn_impl``
    ``chunked`` and ``pallas`` (the port's plain versions; JAX's Pallas
    kernels in interpret mode), on a ``SyntheticLM`` batch with packed
    segments and a loss mask: loss atol 1e-5, each gradient scaled by its
    max |.| at atol 1e-4;
  * ``SyntheticLM`` batches bit-equal to JAX's for several steps;
  * one ``adamw`` update at atol 1e-6; ``warmup_cosine`` (see its test);
  * three ``make_train_step`` steps (deterministic, clip 1.0), also with
    gradient accumulation: the losses within 1e-4 relative. Losses, not
    parameters element by element: AdamW's m/sqrt(v) magnifies float noise
    where v is near 0, so parameters may differ in the last bits while
    every loss agrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model, params_from_jax
from repro_torch.optim import adamw, constant, warmup_cosine
from repro_torch.core.tree import tree_leaves, with_leaves
from repro_torch.train import make_train_step

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_reduced_config("granite-3-2b")
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _batch():
    return SyntheticLM(256, 48, 2, seed=1, mean_doc_len=16).batch_at(0)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_model_loss_and_grads_match_jax(jax_side, impl):
    jparams, np_params = jax_side
    batch = _batch()
    assert batch["segment_ids"].max() > 0 and batch["loss_mask"].min() == 0
    jmodel = jax_build_model(jax_reduced_config("granite-3-2b",
                                                attn_impl=impl))

    def jloss(p):
        return jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                           deterministic=True)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    cfg = reduced_config("granite-3-2b", attn_impl=impl)
    params = params_from_jax(np_params, cfg, device="cpu")
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tl, tm = build_model(cfg).loss(with_leaves(params, leaves), batch,
                                   deterministic=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5,
                               rtol=0)
    assert float(tm["tokens"]) == float(jm["tokens"])
    grads = with_leaves(params, torch.autograd.grad(tl, leaves))
    jg = jax.tree.map(np.asarray, jg)

    def close(g, w):
        s = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / s, w / s, atol=1e-4, rtol=0)

    close(grads["embed"], jg["embed"])
    close(grads["final_norm"]["w"], jg["final_norm"]["w"])
    for l, block in enumerate(grads["blocks"]):
        for group, leaves_l in block.items():
            for name, g in leaves_l.items():
                close(g, jg["blocks"][group][name][l])


def test_synthetic_lm_bit_equal_to_jax():
    for kw in (dict(), dict(mean_doc_len=8, noise=0.1)):
        ours = SyntheticLM(256, 64, 4, seed=3, **kw)
        ref = JaxSyntheticLM(256, 64, 4, seed=3, **kw)
        for step in (0, 1, 7, 1000):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "blocks": [{"m": (3, 4)}, {"m": (3, 4)}]}

    def draw():
        return jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                            shapes, is_leaf=lambda x: isinstance(x, tuple))

    p_np, g_np = draw(), draw()
    jopt = jax_adamw(jax_warmup_cosine(1e-2, 3, 20))
    jstate = jopt.init(p_np)
    topt = adamw(warmup_cosine(1e-2, 3, 20))
    to_t = lambda t: jax.tree.map(torch.as_tensor, t)  # noqa: E731
    tparams = to_t(p_np)
    tstate = topt.init(tparams)
    for _ in range(2):                       # two updates: bias corrections move
        jupd, jstate = jopt.update(g_np, jstate, p_np)
        tupd, tstate = topt.update(to_t(g_np), tstate, tparams)
        for a, b in zip(tree_leaves(tupd), jax.tree.leaves(jupd)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    for a, b in zip(tree_leaves(tstate["nu"]), jax.tree.leaves(jstate["nu"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    assert float(constant(0.5)(torch.tensor(3))) == 0.5


def test_warmup_cosine_matches_jax():
    """Bit-equal on the warmup ramp; on the cosine segment within 4 float32
    ulps (rtol 5e-7): XLA's and PyTorch's float32 cos differ in the last
    bits (measured: up to 3 ulps of the learning rate)."""
    jfn, tfn = jax_warmup_cosine(3e-4, 20, 100), warmup_cosine(3e-4, 20, 100)
    for s in range(0, 130):
        want = np.float32(jfn(jnp.int32(s)))
        got = tfn(torch.tensor(s, dtype=torch.int32)).numpy()
        assert got.dtype == np.float32
        if s < 20:
            assert got == want, s
        else:
            np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_train_steps_match_jax(jax_side, grad_accum):
    jparams, np_params = jax_side
    jcfg = jax_reduced_config("granite-3-2b")
    jopt = jax_adamw(jax_warmup_cosine(1e-3, 2, 10))
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg), jopt,
                                        grad_accum=grad_accum,
                                        deterministic=True))
    jstate = jopt.init(jparams)
    cfg = reduced_config("granite-3-2b")
    opt = adamw(warmup_cosine(1e-3, 2, 10))
    params = params_from_jax(np_params, cfg, device="cpu")
    state = opt.init(params)
    step = make_train_step(build_model(cfg), opt, clip_norm=1.0,
                           grad_accum=grad_accum, deterministic=True)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=3)
    for s in range(3):
        batch = data.batch_at(s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, tm = step(params, state, batch)
        # relative 1e-4 on losses (see the module docstring)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert int(state["step"]) == 3


def test_remat_gives_the_same_grads():
    """Checkpointing every block recomputes it in the backward and changes
    nothing: loss and grads equal with and without remat (fp32, pallas)."""
    cfg = reduced_config("granite-3-2b", attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch()
    out = []
    for remat in (False, True):
        m = build_model(dataclasses.replace(cfg, remat=remat))
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = m.loss(with_leaves(params, leaves), batch,
                         deterministic=True)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    torch.testing.assert_close(out[0][0], out[1][0], atol=0, rtol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_attention_dropout_reaches_the_model():
    """With ``attn_dropout`` the loss depends on the dropout seed when not
    deterministic (the seed is the optimizer step), and not otherwise."""
    cfg = reduced_config("granite-3-2b", attn_impl="pallas", attn_dropout=0.3)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch()
    with torch.no_grad():
        det = [float(model.loss(params, batch, deterministic=True,
                                dropout_seed=s)[0]) for s in (0, 1)]
        drop = [float(model.loss(params, batch, deterministic=False,
                                 dropout_seed=s)[0]) for s in (0, 1, 1)]
    assert det[0] == det[1]
    assert drop[0] != drop[1] and drop[1] == drop[2] and drop[0] != det[0]
