"""The reference's encoder-decoder (seamless-m4t-medium, reduced: 2 encoder
+ 2 decoder layers, d 64, 4 heads of 16, audio frames of dim 32) on the
CPU, against the JAX package, with its weights handed over by
``params_from_jax``. Batches have the reference's ``make_batch`` shapes
(``tests/test_models_smoke.py``): frames (B, S/2, frontend_dim) and
tokens (B, S/2), made with numpy from a seed and given to both sides.

  * the parameter tree: ``enc_blocks`` (unstacked from the layer axis),
    ``enc_final_norm``, ``frontend_proj`` and each decoder block's
    ``cross_norm`` / ``cross_attn`` arrive as the JAX leaves, and
    ``Model.init`` draws the same tree;
  * ``forward`` logits (atol 1e-4), ``loss`` (1e-4 relative) and every
    gradient (atol 1e-4 once scaled by its max) for ``attn_impl``
    ``chunked`` and ``pallas`` (the port's plain versions; JAX's Pallas
    kernels in interpret mode), with and without remat;
  * prefill + 3 decode steps: logits against the port's full forward
    (max error / max |logit| < 2e-4, the reference's own test) and
    against the JAX model's prefill and decode (atol 1e-4), through the
    plain decode and the split-KV decode's plain version over the cross
    cache padded to the decode tile (``kv_len`` = the encoder's length);
    with a decoder window, decode still against the full forward (the
    cross-attention is never windowed);
  * three AdamW train steps against the JAX step (losses 1e-4 relative),
    and one update from zero gradients: the optimizer's weight decay
    reaches the encoder's 1-D leaves (LayerNorm scales and biases) as it
    reaches the reference's stacked ones (atol 1e-7);
  * ``segment_ids`` refused with an encoder, as in the reference; the
    engine and both launchers refuse the family (a request and a
    ``SyntheticLM`` batch carry tokens alone).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.tree import tree_leaves, tree_map, with_leaves
from repro_torch.models import build_model, params_from_jax
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.serve import ServingEngine
from repro_torch.train import make_train_step
from repro_torch.train.steps import _clip_update_apply

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ARCH = "seamless-m4t-medium"
BLOCK_KEYS = {"attn_norm", "attn", "mlp_norm", "mlp"}
CROSS_KEYS = BLOCK_KEYS | {"cross_norm", "cross_attn"}


def _batch(cfg, B=2, S=32, seed=0):
    """The reference's ``make_batch`` shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal(
                (B, S // 2, cfg.frontend_dim)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S // 2)
                                   ).astype(np.int32),
            "loss_mask": np.ones((B, S // 2), np.float32)}


def _jax_blocks(tree, num_layers):
    return [jax.tree.map(lambda a, l=l: a[l], tree) for l in range(num_layers)]


def _shapes(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items
                for k, v in _shapes(sub, f"{prefix}/{key}").items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


def test_config_is_the_reference_encdec():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.num_encoder_layers, cfg.d_model,
            cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size) == \
        ("encdec", 12, 12, 1024, 16, 16, 4096, 256206)
    assert (cfg.frontend, cfg.frontend_dim, cfg.norm_type, cfg.mlp_type,
            cfg.tie_embeddings) == ("audio", 160, "layernorm", "gelu", True)
    small = reduced_config(ARCH)
    assert (small.num_layers, small.num_encoder_layers, small.frontend_dim,
            small.frontend_tokens) == (2, 2, 32, 0)


def test_params_from_jax_carries_the_encoder_and_cross_leaves():
    cfg = reduced_config(ARCH)
    jparams = jax_build_model(jax_reduced_config(ARCH)).init(
        jax.random.PRNGKey(2))
    np_params = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(np_params, cfg, device="cpu")
    drawn = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert _shapes(drawn) == _shapes(params)
    assert set(params) == {"embed", "final_norm", "blocks", "enc_blocks",
                           "enc_final_norm", "frontend_proj"}
    assert params["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    for key, keys, n in (("blocks", CROSS_KEYS, cfg.num_layers),
                         ("enc_blocks", BLOCK_KEYS, cfg.num_encoder_layers)):
        assert len(params[key]) == n
        for block, ref in zip(params[key], _jax_blocks(np_params[key], n)):
            assert set(block) == set(ref) == keys
            tree_map(lambda t, a: np.testing.assert_array_equal(
                t.numpy(), np.asarray(a)), block, ref)


@pytest.fixture(scope="module")
def references():
    """The JAX model's params, logits, loss and grads per impl, computed
    once (the reference without remat)."""
    cache = {}

    def get(impl):
        if impl not in cache:
            jcfg = jax_reduced_config(ARCH, attn_impl=impl, remat=False)
            jmodel = jax_build_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            jbatch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
            jlogits, _ = jax.jit(jmodel.forward)(jparams, jbatch)

            def jloss(p):
                return jmodel.loss(p, jbatch, deterministic=True)[0]

            jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
            jg = jax.tree.map(np.asarray, jg)
            jg["blocks"] = _jax_blocks(jg["blocks"], jcfg.num_layers)
            jg["enc_blocks"] = _jax_blocks(jg["enc_blocks"],
                                           jcfg.num_encoder_layers)
            cache[impl] = (jax.tree.map(np.asarray, jparams),
                           np.asarray(jlogits), float(jl), jg)
        return cache[impl]

    return get


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_logits_loss_and_grads_match_jax(references, impl, remat):
    np_params, jlogits, jl, jg = references(impl)
    cfg = reduced_config(ARCH, attn_impl=impl, remat=remat)
    model = build_model(cfg)
    params = params_from_jax(np_params, cfg, device="cpu")
    batch = _batch(cfg)
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=0)
    assert float(aux) == 0.0
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tl, _ = model.loss(with_leaves(params, leaves), batch, deterministic=True)
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-4)
    grads = with_leaves(params, torch.autograd.grad(tl, leaves))

    def close(g, w):
        s = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / s, w / s, atol=1e-4, rtol=0)

    tree_map(close, grads, jg)
    # the encoder is reached through cross-attention and the frontend
    for t in (grads["frontend_proj"], grads["enc_blocks"][0]["attn"]["wq"],
              grads["blocks"][1]["cross_attn"]["wk"]):
        assert float(t.abs().max()) > 0


def _decode_logits(model, params, batch, n_pre, cap, steps):
    """Logits of a prefill of ``n_pre`` tokens and of ``steps`` greedy-free
    decode steps feeding the batch's next tokens."""
    toks = batch["tokens"]
    pre = {"frames": batch["frames"], "tokens": toks[:, :n_pre]}
    state, lg = model.prefill(params, pre, cap)
    out = [np.asarray(lg[:, -1], np.float32)]
    for t in range(n_pre, n_pre + steps):
        state, lg = model.decode_step(params, state, toks[:, t])
        out.append(np.asarray(lg[:, 0], np.float32))
    return out, state


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_prefill_and_decode_match_forward_and_jax(decode_kernel):
    """The reference's decode-parity test (B 2, S 24: 12 frames, 12 tokens,
    a 9-token prompt, 3 steps, capacity 16) on the port, and its logits
    against the JAX model's at every step."""
    jcfg = jax_reduced_config(ARCH)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced_config(ARCH, attn_impl="pallas",
                         use_decode_kernel=decode_kernel)
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    batch = _batch(cfg, B=2, S=24, seed=3)
    n = batch["tokens"].shape[1]
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        full, _ = model.forward(params, tbatch)
    got, state = _decode_logits(model, params, tbatch, n - 3, n + 4, 3)
    want = [full[:, t].numpy() for t in range(n - 4, n)]
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    assert max(errs) / float(full.abs().max()) < 2e-4, errs
    # the cross cache is padded to the decode tile; decode reads 12 rows
    cross = state["caches"]["cross_kv"]["k"]
    assert cross.shape[3] == 64 and state["enc_len"].tolist() == [12, 12]
    assert float(cross[:, :, :, 12:].abs().max()) == 0.0
    assert state["kv_len"].tolist() == [n, n]
    empty = model.init_decode_state(2, n + 4, "cpu", enc_len=12)
    assert empty["enc_len"].tolist() == [12, 12]
    assert {k: tuple(v["k"].shape) for k, v in empty["caches"].items()} == \
        {k: tuple(v["k"].shape) for k, v in state["caches"].items()}

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgot, _ = _decode_logits(jmodel, jparams, jbatch, n - 3, n + 4, 3)
    for g, j in zip(got, jgot):
        np.testing.assert_allclose(g, j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_windowed_decoder_keeps_cross_attention_unwindowed(decode_kernel):
    """With a sliding window on the decoder's self-attention (4 rows, less
    than the 12 encoder rows), prefill + 3 decode steps still match the
    port's full forward (rel < 2e-4): cross-attention reads every encoder
    row at decode as in the full sequence. (The reference windows its cross
    cache at decode alone; no published config has a window, ROADMAP §3.)"""
    cfg = reduced_config(ARCH, attn_impl="pallas", window=4,
                         use_decode_kernel=decode_kernel)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(cfg, B=2, S=24, seed=6).items()}
    n = batch["tokens"].shape[1]
    with torch.no_grad():
        full, _ = model.forward(params, batch)
        got, _ = _decode_logits(model, params, batch, n - 3, n + 4, 3)
    want = [full[:, t].numpy() for t in range(n - 4, n)]
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    assert max(errs) / float(full.abs().max()) < 2e-4, errs


def test_three_adamw_steps_match_jax():
    """Three train steps (AdamW, warmup_cosine, clip 1.0, deterministic)
    from the same weights on the same batches, frames included: losses
    and grad norms within 1e-4 relative at every step."""
    jcfg = jax_reduced_config(ARCH, attn_impl="pallas")
    cfg = reduced_config(ARCH, attn_impl="pallas")
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
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))


def test_weight_decay_reaches_the_encoder_1d_leaves():
    """From zero gradients an AdamW update is the weight decay alone. The
    reference stacks ``enc_blocks`` on a layer axis, so its optimizer
    decays their LayerNorm scales and biases (2-D leaves there); the
    port's step hands each encoder block over with that axis, so its
    update matches, leaf for leaf, and the encoder's final norm (1-D in
    both) is left alone."""
    jcfg = jax_reduced_config(ARCH)
    cfg = reduced_config(ARCH)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(4))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    jopt, opt = jax_adamw(1e-2), adamw(1e-2)
    jzero = jax.tree.map(jnp.zeros_like, jparams)
    jup, _ = jopt.update(jzero, jopt.init(jparams), jparams)
    jnew = jax.tree.map(np.asarray, jax_apply_updates(jparams, jup))
    zero = tree_map(torch.zeros_like, params)
    new, _, _ = _clip_update_apply(opt, zero, opt.init(params), params, 1.0)
    for key, n in (("enc_blocks", cfg.num_encoder_layers),
                   ("blocks", cfg.num_layers)):
        for l, (block, ref) in enumerate(zip(new[key],
                                             _jax_blocks(jnew[key], n))):
            tree_map(lambda t, a: np.testing.assert_allclose(
                t.numpy(), a, atol=1e-7, rtol=0), block, ref)
            # a 1-D leaf moved: decayed, as the reference's stacked leaf
            w = params[key][l]["attn_norm"]["w"]
            assert float((block["attn_norm"]["w"] - w).abs().max()) > 0
    np.testing.assert_array_equal(new["enc_final_norm"]["w"].numpy(),
                                  params["enc_final_norm"]["w"].numpy())
    tree_map(lambda t, a: np.testing.assert_allclose(t.numpy(), a, atol=1e-7,
                                                     rtol=0),
             {k: new[k] for k in ("frontend_proj", "enc_final_norm")},
             {k: jnew[k] for k in ("frontend_proj", "enc_final_norm")})


def test_segment_ids_are_refused_with_an_encoder():
    cfg = reduced_config(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg)
    batch["segment_ids"] = np.zeros_like(batch["tokens"])
    with pytest.raises(ValueError, match="segment_ids are a text-decoder"):
        model.forward(params, batch)


def test_engine_and_launchers_refuse_the_family(tmp_path):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    cfg = reduced_config(ARCH)
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
    # the dense family still serves through the same check
    dense = dataclasses.replace(cfg, family="dense", num_encoder_layers=0,
                                frontend=None, frontend_dim=0)
    dmodel = build_model(dense)
    ServingEngine(dmodel, dmodel.init(torch.Generator().manual_seed(0),
                                      device="cpu"),
                  num_slots=2, capacity=32, device="cpu")
