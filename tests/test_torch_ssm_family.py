"""The reference's state-space and hybrid decoders on the CPU, against the
JAX package, with its weights handed over by ``params_from_jax``: reduced
mamba2-2.7b (attention-free, no MLP) and hymba-1.5b (parallel attention and
SSM heads, sliding window 64, GQA 4:1; and once at GQA 5:1, the published
ratio, with ``num_heads=5, num_kv_heads=1``).

  * the parameter tree: every JAX leaf arrives with its shape and dtype —
    ``A_log``, ``D`` and ``dt_bias`` stay float32 in a bf16 model — and
    ``Model.init`` draws the same tree;
  * ``forward`` logits (atol 1e-4), ``loss`` (1e-4 relative) and every
    gradient (atol 1e-4 once scaled by its max; the hybrid's ``ssm_norm``,
    which the reference never reads, zero on both sides) on a packed
    ``SyntheticLM`` batch with a loss mask, for ``attn_impl`` ``chunked``
    and ``pallas`` (the port's plain versions; JAX's Pallas kernels in
    interpret mode), with and without remat (the reference without: remat
    changes no value);
  * three AdamW train steps against the JAX step (losses 1e-4 relative);
  * the train launcher on both archs with ``--reduced --device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.core.tree import tree_leaves, tree_map, with_leaves
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model, params_from_jax
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import make_train_step

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ARCHS = ["mamba2-2.7b", "hymba-1.5b"]
GQA5 = {"num_heads": 5, "num_kv_heads": 1}
BLOCK_KEYS = {
    "mamba2-2.7b": {"ssm_norm", "ssm"},
    "hymba-1.5b": {"attn_norm", "attn", "ssm_norm", "ssm", "mlp_norm", "mlp"}}
SSM_KEYS = {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w",
            "out_proj"}


def _batch():
    return SyntheticLM(256, 80, 2, seed=1, mean_doc_len=24).batch_at(0)


def _jax_blocks(tree, num_layers):
    return [jax.tree.map(lambda a, l=l: a[l], tree) for l in range(num_layers)]


def _shapes(tree, prefix=""):
    """{path: (shape, dtype)} of a params tree."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items
                for k, v in _shapes(sub, f"{prefix}/{key}").items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_the_float32_ssm_leaves(arch):
    """Every JAX leaf arrives as is, in the reference's block tree (no
    attention for mamba2, no MLP where d_ff is 0); in a bf16 model the
    SSM's ``A_log``, ``D`` and ``dt_bias`` stay float32, on both sides and
    as ``Model.init`` draws them, every other leaf bf16."""
    cfg = reduced_config(arch, dtype="bfloat16")
    jparams = jax_build_model(jax_reduced_config(arch, dtype="bfloat16")
                              ).init(jax.random.PRNGKey(2))
    np_params = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(np_params, cfg, device="cpu")
    drawn = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert _shapes(drawn) == _shapes(params)
    for block, ref in zip(params["blocks"],
                          _jax_blocks(np_params["blocks"], cfg.num_layers)):
        assert set(block) == set(ref) == BLOCK_KEYS[arch]
        assert set(block["ssm"]) == SSM_KEYS
        tree_map(lambda t, a: np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(a, np.float32)), block, ref)
        for name, t in block["ssm"].items():
            want = (torch.float32 if name in ("A_log", "D", "dt_bias")
                    else torch.bfloat16)
            assert t.dtype == want == (torch.float32 if ref["ssm"][name].dtype
                                       == np.float32 else torch.bfloat16), name
    for block in drawn["blocks"]:
        assert {n for n, t in block["ssm"].items()
                if t.dtype == torch.float32} == {"A_log", "D", "dt_bias"}


@pytest.fixture(scope="module")
def references():
    """The JAX model's params, logits, loss and grads per (arch, impl,
    overrides), computed once (the reference without remat)."""
    cache = {}

    def get(arch, impl, overrides=()):
        key = (arch, impl, overrides)
        if key not in cache:
            jcfg = jax_reduced_config(arch, attn_impl=impl, remat=False,
                                      **dict(overrides))
            jmodel = jax_build_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}
            jlogits, _ = jax.jit(jmodel.forward)(jparams, jbatch)

            def jloss(p):
                return jmodel.loss(p, jbatch, deterministic=True)[0]

            jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
            jg = jax.tree.map(np.asarray, jg)
            jg["blocks"] = _jax_blocks(jg["blocks"], jcfg.num_layers)
            cache[key] = (jax.tree.map(np.asarray, jparams),
                          np.asarray(jlogits), float(jl), jg)
        return cache[key]

    return get


def _check_against_jax(references, arch, impl, remat, overrides=()):
    np_params, jlogits, jl, jg = references(arch, impl, overrides)
    cfg = reduced_config(arch, attn_impl=impl, remat=remat, **dict(overrides))
    model = build_model(cfg)
    params = params_from_jax(np_params, cfg, device="cpu")
    batch = _batch()
    assert batch["segment_ids"].max() > 0 and batch["loss_mask"].min() == 0
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=0)
    assert float(aux) == 0.0
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tl, _ = model.loss(with_leaves(params, leaves), batch, deterministic=True)
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-4)
    grads = with_leaves(params, torch.autograd.grad(
        tl, leaves, allow_unused=True, materialize_grads=True))

    def close(g, w):
        s = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / s, w / s, atol=1e-4, rtol=0)

    tree_map(close, grads, jg)
    for block, ref in zip(grads["blocks"], jg["blocks"]):
        assert float(block["ssm"]["A_log"].abs().max()) > 0
        if cfg.hybrid:              # the reference never reads ssm_norm
            assert float(block["ssm_norm"]["w"].abs().max()) == 0
            assert float(np.abs(ref["ssm_norm"]["w"]).max()) == 0


@pytest.mark.parametrize("remat", [False, True])
def test_mamba2_logits_loss_and_grads_match_jax(references, remat):
    """Attention-free: ``attn_impl`` reaches no kernel, so one reference
    serves both; the port runs both impls."""
    for impl in ("chunked", "pallas"):
        _check_against_jax(references, "mamba2-2.7b", impl, remat)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_hymba_logits_loss_and_grads_match_jax(references, impl, remat):
    _check_against_jax(references, "hymba-1.5b", impl, remat)


def test_hymba_at_gqa5_matches_jax(references):
    """The published GQA ratio, 5 q heads a kv head (the reduced config
    has 4:1), through the pallas path's plain versions against the
    reference's Pallas kernels in interpret mode."""
    _check_against_jax(references, "hymba-1.5b", "pallas", True,
                       tuple(GQA5.items()))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_jax(arch):
    """Three train steps (AdamW, warmup_cosine, clip 1.0, deterministic)
    from the same weights on the same packed batches: losses within 1e-4
    relative at every step, grad norms within 1e-4 relative."""
    jcfg = jax_reduced_config(arch, attn_impl="pallas")
    cfg = reduced_config(arch, attn_impl="pallas")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    data = SyntheticLM(256, 48, 2, seed=2, mean_doc_len=16)
    jopt = jax_adamw(jax_warmup_cosine(1e-3, 2, 10))
    opt = adamw(warmup_cosine(1e-3, 2, 10))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, deterministic=True))
    step = make_train_step(build_model(cfg), opt, deterministic=True)
    jstate, state = jopt.init(jparams), opt.init(params)
    for s in range(3):
        b = data.batch_at(s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_reduced_on_cpu(arch, tmp_path):
    from repro_torch.launch import train as launch_train

    trainer = launch_train.main([
        "--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
        "--seq", "40", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    losses = [r["loss"] for r in trainer.history]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(256)) < 0.5
