"""The reference's other dense decoders on the CPU, against the JAX
package, with its weights handed over by ``params_from_jax``: reduced
olmo-1b (non-parametric LayerNorm, untied head), qwen3-32b (qk-norm,
head_dim 32 so that the q projection, 4 x 32 = 128 wide, differs from
d_model 64), internlm2-20b (untied head), gpt2-medium (LayerNorm, GELU)
and bert-large (LayerNorm, GELU, non-causal).

  * the parameter tree: every JAX leaf (``lm_head``, ``q_norm`` /
    ``k_norm``, the empty norm dicts of ``layernorm_np``) arrives with its
    shape, and ``Model.init`` draws the same tree;
  * ``forward`` logits (atol 1e-4), ``loss`` (1e-4 relative) and every
    gradient (atol 1e-4 once scaled by its max |.|) against the JAX model,
    for ``attn_impl`` ``chunked`` and ``pallas`` (the port's plain
    versions; JAX's Pallas kernels in interpret mode), on a packed
    ``SyntheticLM`` batch with a loss mask;
  * three train steps of the paper's recipes: bert-large with
    ``lamb(warmup_poly)`` (MLPerf BERT) and olmo-1b with
    ``adamw(warmup_cosine)``, losses within 1e-4 relative.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import lamb as jax_lamb
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.optim import warmup_poly as jax_warmup_poly
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.core.tree import tree_leaves, tree_map, with_leaves
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model, params_from_jax
from repro_torch.optim import adamw, lamb, warmup_cosine, warmup_poly
from repro_torch.train import make_train_step

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
OVERRIDES = {"olmo-1b": {}, "qwen3-32b": {"head_dim": 32},
             "internlm2-20b": {}, "gpt2-medium": {}, "bert-large": {}}


@pytest.fixture(scope="module", params=sorted(OVERRIDES))
def family(request):
    arch = request.param
    cfg = jax_reduced_config(arch, **OVERRIDES[arch])
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    return arch, params, jax.tree.map(np.asarray, params)


def _cfgs(arch, **kw):
    kw = {**OVERRIDES[arch], **kw}
    return reduced_config(arch, **kw), jax_reduced_config(arch, **kw)


def _batch():
    return SyntheticLM(256, 48, 2, seed=1, mean_doc_len=16).batch_at(0)


def _paths(tree, prefix=""):
    """{path: leaf} with empty dicts kept as leaves (they are part of the
    layout)."""
    if isinstance(tree, dict):
        if not tree:
            return {prefix: "{}"}
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        return _paths(dict(enumerate(tree)), prefix)
    return {prefix: tree}


def test_params_from_jax_carries_every_leaf(family):
    arch, _, np_params = family
    cfg, jcfg = _cfgs(arch)
    params = params_from_jax(np_params, cfg, device="cpu")
    want = {"embed", "final_norm", "blocks"} | (
        set() if jcfg.tie_embeddings else {"lm_head"})
    assert set(params) == want
    for l, block in enumerate(params["blocks"]):
        ref = jax.tree.map(lambda a, l=l: a[l], np_params["blocks"])
        got = _paths(block)
        ref = _paths(ref)
        assert got.keys() == ref.keys()
        for k in got:
            if isinstance(got[k], str):
                assert ref[k] == "{}"
            else:
                np.testing.assert_array_equal(got[k].numpy(), ref[k])
        assert ("q_norm" in block["attn"]) == jcfg.qk_norm
    drawn = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert ({k: tuple(v.shape) if not isinstance(v, str) else v
             for k, v in _paths(drawn).items()}
            == {k: tuple(v.shape) if not isinstance(v, str) else v
                for k, v in _paths(params).items()})


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_logits_loss_and_grads_match_jax(family, impl):
    arch, jparams, np_params = family
    cfg, jcfg = _cfgs(arch, attn_impl=impl)
    batch = _batch()
    assert batch["segment_ids"].max() > 0 and batch["loss_mask"].min() == 0
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(jcfg)
    model = build_model(cfg)
    params = params_from_jax(np_params, cfg, device="cpu")

    jlogits, _ = jmodel.forward(jparams, jbatch)
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4,
                               rtol=0)

    def jloss(p):
        return jmodel.loss(p, jbatch, deterministic=True)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tl, tm = model.loss(with_leaves(params, leaves), batch, deterministic=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    assert float(tm["tokens"]) == float(jm["tokens"])
    grads = with_leaves(params, torch.autograd.grad(tl, leaves))
    jg = jax.tree.map(np.asarray, jg)
    jg["blocks"] = [jax.tree.map(lambda a, l=l: a[l], jg["blocks"])
                    for l in range(cfg.num_layers)]

    def close(g, w):
        s = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / s, w / s, atol=1e-4, rtol=0)

    tree_map(close, grads, jg)


RECIPES = {
    # arch: (port optimizer, JAX optimizer), the MLPerf-BERT and GPT-2 recipes
    "bert-large": (lambda: lamb(warmup_poly(3.75e-3, 2, 10)),
                   lambda: jax_lamb(jax_warmup_poly(3.75e-3, 2, 10))),
    "olmo-1b": (lambda: adamw(warmup_cosine(1e-3, 2, 10)),
                lambda: jax_adamw(jax_warmup_cosine(1e-3, 2, 10))),
}


@pytest.mark.parametrize("arch", sorted(RECIPES))
def test_three_train_steps_match_jax(arch):
    cfg, jcfg = _cfgs(arch)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    port_opt, jax_opt = (f() for f in RECIPES[arch])
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg), jax_opt,
                                        deterministic=True))
    jstate = jax_opt.init(jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    state = port_opt.init(params)
    step = make_train_step(build_model(cfg), port_opt, clip_norm=1.0,
                           deterministic=True)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=3)
    losses = []
    for s in range(3):
        batch = data.batch_at(s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, tm = step(params, state, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        losses.append(float(tm["loss"]))
    assert int(state["step"]) == 3 and len(set(losses)) == 3


def test_train_launcher_defaults_to_olmo(tmp_path, capsys):
    """The launcher's default arch is olmo-1b, as the JAX launcher's; two
    reduced steps on the CPU give finite losses, and the launcher leaves
    the process's SIGTERM handler as it found it."""
    from repro_torch.launch import train as launch_train

    assert launch_train.build_parser().parse_args([]).arch == "olmo-1b"
    before = signal.getsignal(signal.SIGTERM)
    trainer = launch_train.main(["--reduced", "--device", "cpu", "--steps",
                                 "2", "--seq", "32", "--batch", "2",
                                 "--ckpt-dir", str(tmp_path)])
    assert "arch=olmo-1b" in capsys.readouterr().out
    assert len(trainer.history) == 2
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    assert "lm_head" in trainer.params
    # the launcher's SIGTERM handler (which holds the trainer) is gone
    assert signal.getsignal(signal.SIGTERM) is before
