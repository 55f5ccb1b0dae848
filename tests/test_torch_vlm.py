"""The reference's vision-language decoder (phi-3-vision-4.2b, reduced: 2
layers, d 64, 4 heads (MHA), 8 patches of dim 32) on the CPU, against the
JAX package, with its weights handed over by ``params_from_jax``, at the
reduction's head_dim 16 and at the published head_dim 96 (the q, k and v
projections 64 -> 384). Batches have the reference's ``make_batch``
shapes (``tests/test_models_smoke.py``): patches (B, 8, frontend_dim) and
tokens (B, S - 8), made with numpy from a seed and given to both sides.

  * the parameter tree: ``frontend_proj`` (frontend_dim, d) and the
    untied ``lm_head`` arrive as the JAX leaves, and ``Model.init`` draws
    the same tree;
  * ``forward`` logits over the whole stream, patches first (atol 1e-4),
    ``loss`` over the token rows (1e-4 relative) and every gradient,
    ``frontend_proj``'s included (atol 1e-4 once scaled by its max), for
    ``attn_impl`` ``chunked`` and ``pallas`` (the port's plain versions;
    JAX's Pallas kernels in interpret mode);
  * prefill (patches + a prompt, ``kv_len`` = 8 + the prompt) + 3 decode
    steps of tokens: logits against the port's full forward (max error /
    max |logit| < 2e-4, the reference's own test) and against the JAX
    model's prefill and decode (atol 1e-4), through the plain decode and
    the split-KV decode's plain version;
  * three AdamW train steps against the JAX step (losses 1e-4 relative);
  * the engine and both launchers refuse the family (a request and a
    ``SyntheticLM`` batch carry tokens alone, as in the reference), and
    packed ``segment_ids`` are refused with a frontend.
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
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.tree import tree_leaves, tree_map, with_leaves
from repro_torch.models import build_model, params_from_jax
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.serve import ServingEngine
from repro_torch.train import make_train_step

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ARCH = "phi-3-vision-4.2b"
HEAD_DIMS = [16, 96]


def _cfgs(head_dim, **kw):
    return (reduced_config(ARCH, head_dim=head_dim, **kw),
            jax_reduced_config(ARCH, head_dim=head_dim, **kw))


def _batch(cfg, B=2, S=32, seed=0):
    """The reference's ``make_batch`` shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    nf = cfg.frontend_tokens
    return {"patches": rng.standard_normal(
                (B, nf, cfg.frontend_dim)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S - nf)
                                   ).astype(np.int32),
            "loss_mask": np.ones((B, S - nf), np.float32)}


def _jax_blocks(tree, num_layers):
    return [jax.tree.map(lambda a, l=l: a[l], tree) for l in range(num_layers)]


def _shapes(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items
                for k, v in _shapes(sub, f"{prefix}/{key}").items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


def test_config_is_the_reference_vlm():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        ("vlm", 32, 3072, 32, 32, 96, 8192, 32064)
    assert (cfg.frontend, cfg.frontend_tokens, cfg.frontend_dim,
            cfg.tie_embeddings) == ("vision", 576, 1024, False)
    small = reduced_config(ARCH)
    assert (small.num_layers, small.head_dim, small.frontend_tokens,
            small.frontend_dim) == (2, 16, 8, 32)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_params_from_jax_carries_the_frontend_and_head(head_dim):
    cfg, jcfg = _cfgs(head_dim)
    np_params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(2)))
    params = params_from_jax(np_params, cfg, device="cpu")
    drawn = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert _shapes(drawn) == _shapes(params)
    assert set(params) == {"embed", "final_norm", "blocks", "frontend_proj",
                           "lm_head"}
    assert params["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    assert params["blocks"][0]["attn"]["wq"].shape == (64, 4 * head_dim)
    for key in ("frontend_proj", "lm_head", "embed"):
        np.testing.assert_array_equal(params[key].numpy(), np_params[key])
    for block, ref in zip(params["blocks"],
                          _jax_blocks(np_params["blocks"], cfg.num_layers)):
        tree_map(lambda t, a: np.testing.assert_array_equal(
            t.numpy(), np.asarray(a)), block, ref)


@pytest.fixture(scope="module")
def references():
    """The JAX model's params, logits, loss and grads per (head_dim, impl),
    computed once."""
    cache = {}

    def get(head_dim, impl):
        if (head_dim, impl) not in cache:
            _, jcfg = _cfgs(head_dim, attn_impl=impl)
            jmodel = jax_build_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            jbatch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
            jlogits, _ = jax.jit(jmodel.forward)(jparams, jbatch)

            def jloss(p):
                return jmodel.loss(p, jbatch, deterministic=True)[0]

            jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
            jg = jax.tree.map(np.asarray, jg)
            jg["blocks"] = _jax_blocks(jg["blocks"], jcfg.num_layers)
            cache[(head_dim, impl)] = (jax.tree.map(np.asarray, jparams),
                                       np.asarray(jlogits), float(jl), jg)
        return cache[(head_dim, impl)]

    return get


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_logits_loss_and_grads_match_jax(references, head_dim, impl):
    np_params, jlogits, jl, jg = references(head_dim, impl)
    cfg, _ = _cfgs(head_dim, attn_impl=impl)
    model = build_model(cfg)
    params = params_from_jax(np_params, cfg, device="cpu")
    batch = _batch(cfg)
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    assert logits.shape == (2, 32, cfg.vocab_size)   # 8 patches + 24 tokens
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=0)
    assert float(aux) == 0.0
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tl, tm = model.loss(with_leaves(params, leaves), batch, deterministic=True)
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-4)
    assert float(tm["tokens"]) == 2 * 23      # token rows only
    grads = with_leaves(params, torch.autograd.grad(tl, leaves))

    def close(g, w):
        s = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / s, w / s, atol=1e-4, rtol=0)

    tree_map(close, grads, jg)
    # the patches reach the loss through attention
    assert float(grads["frontend_proj"].abs().max()) > 0


def _decode_logits(model, params, batch, n_pre, cap, steps):
    """Logits of a prefill of the patches and ``n_pre`` tokens and of
    ``steps`` decode steps feeding the batch's next tokens."""
    toks = batch["tokens"]
    pre = {"patches": batch["patches"], "tokens": toks[:, :n_pre]}
    state, lg = model.prefill(params, pre, cap)
    out = [np.asarray(lg[:, -1], np.float32)]
    for t in range(n_pre, n_pre + steps):
        state, lg = model.decode_step(params, state, toks[:, t])
        out.append(np.asarray(lg[:, 0], np.float32))
    return out, state


@pytest.mark.parametrize("decode_kernel", [False, True])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_prefill_and_decode_match_forward_and_jax(head_dim, decode_kernel):
    """The reference's decode-parity test (B 2, S 24: 8 patches, 16 tokens,
    a 13-token prompt, 3 steps, capacity 8 + 16 + 4) on the port, and its
    logits against the JAX model's at every step."""
    cfg, jcfg = _cfgs(head_dim, attn_impl="pallas",
                      use_decode_kernel=decode_kernel)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    batch = _batch(cfg, B=2, S=24, seed=3)
    n, off = batch["tokens"].shape[1], cfg.frontend_tokens
    cap = n + 4 + off
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        full, _ = model.forward(params, tbatch)
    got, state = _decode_logits(model, params, tbatch, n - 3, cap, 3)
    want = [full[:, t + off].numpy() for t in range(n - 4, n)]
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    assert max(errs) / float(full.abs().max()) < 2e-4, errs
    assert state["kv_len"].tolist() == [n + off, n + off]

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgot, _ = _decode_logits(jmodel, jparams, jbatch, n - 3, cap, 3)
    for g, j in zip(got, jgot):
        np.testing.assert_allclose(g, j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_three_adamw_steps_match_jax(head_dim):
    """Three train steps (AdamW, warmup_cosine, clip 1.0, deterministic)
    from the same weights on the same batches, patches included: losses
    within 1e-4 relative at every step."""
    cfg, jcfg = _cfgs(head_dim, attn_impl="pallas")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    jopt = jax_adamw(jax_warmup_cosine(1e-3, 2, 10))
    opt = adamw(warmup_cosine(1e-3, 2, 10))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, deterministic=True))
    step = make_train_step(build_model(cfg), opt, deterministic=True)
    jstate, state = jopt.init(jparams), opt.init(params)
    losses = []
    for s in range(3):
        b = _batch(cfg, seed=10 + s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and len(set(losses)) == 3


def test_segment_ids_are_refused_with_a_frontend():
    cfg, _ = _cfgs(16)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg)
    batch["segment_ids"] = np.zeros_like(batch["tokens"])
    with pytest.raises(ValueError, match="segment_ids are a text-decoder"):
        model.forward(params, batch)


def test_engine_and_launchers_refuse_the_family(tmp_path):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    cfg, _ = _cfgs(16)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    for paged in (None, False):
        with pytest.raises(ValueError, match="feeds token inputs only"):
            ServingEngine(model, params, num_slots=2, capacity=32,
                          paged=paged, device="cpu")
    with pytest.raises(ValueError, match="the serve launcher feeds token"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    with pytest.raises(ValueError, match="the train launcher"):
        launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "1", "--ckpt-dir", str(tmp_path)])
