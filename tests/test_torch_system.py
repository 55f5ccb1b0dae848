"""End-to-end behaviour of the port on the CPU (the counterpart of
``tests/test_system.py``): a small model trained on the synthetic pipeline
learns; the chunked, reference and pallas attention implementations give
the same training curve, and that curve is the JAX reference's; the MoE
and the SSM learn; a trained model serves its own greedy continuations;
and every ``examples/torch_*.py`` runs at its smallest setting (and
raises without ``--device cpu`` where there is no card) and imports only
the port.

Every run starts from the JAX ``Model.init`` weights (``params_from_jax``)
and trains on ``SyntheticLM``'s batches with AdamW and warmup + cosine, as
the reference test does, so its thresholds carry over."""

import ast
import os
import pathlib
import subprocess
import sys

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
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.serve import ServingEngine
from repro_torch.train import make_train_step

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_params(arch, cfg_kw, seed=0):
    jmodel = jax_build_model(jax_reduced_config(arch, **cfg_kw))
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))


def _run(arch, steps=40, seed=0, **cfg_kw):
    """``steps`` AdamW steps of reduced ``arch`` from the JAX init: the
    losses, the params and the model."""
    cfg = reduced_config(arch, **cfg_kw)
    model = build_model(cfg)
    params = params_from_jax(_jax_params(arch, cfg_kw, seed), cfg,
                             device="cpu")
    opt = adamw(warmup_cosine(2e-3, 5, steps))
    state = opt.init(params)
    data = SyntheticLM(cfg.vocab_size, 64, 8, seed=11)
    step = make_train_step(model, opt, deterministic=True)
    losses = []
    for s in range(steps):
        params, state, m = step(params, state, data.batch_at(s))
        losses.append(float(m["loss"]))
    return losses, params, model


def test_training_learns():
    losses, _, _ = _run("olmo-1b", num_layers=2)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.3, (first, last)


def _jax_curve(arch, steps, **cfg_kw):
    jmodel = jax_build_model(jax_reduced_config(arch, **cfg_kw))
    params = jmodel.init(jax.random.PRNGKey(0))
    opt = jax_adamw(jax_warmup_cosine(2e-3, 5, steps))
    state = opt.init(params)
    data = JaxSyntheticLM(jmodel.cfg.vocab_size, 64, 8, seed=11)
    step = jax.jit(jax_make_train_step(jmodel, opt, deterministic=True))
    losses = []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in data.batch_at(s).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return losses


def test_flash_and_standard_attention_same_training_curve():
    """The paper's exactness claim end to end: swapping the attention
    implementation does not change the loss trajectory, and the port's is
    the JAX package's (its ``reference`` impl) from the same weights and
    batches."""
    curves = {impl: _run("granite-3-2b", steps=8, num_layers=2,
                         attn_impl=impl)[0]
              for impl in ("reference", "chunked", "pallas")}
    np.testing.assert_allclose(curves["reference"], curves["chunked"],
                               rtol=1e-4)
    np.testing.assert_allclose(curves["reference"], curves["pallas"],
                               rtol=1e-4)
    want = _jax_curve("granite-3-2b", 8, num_layers=2, attn_impl="reference")
    np.testing.assert_allclose(curves["reference"], want, rtol=1e-4)


def test_moe_training_learns():
    losses, _, _ = _run("olmoe-1b-7b", steps=40, num_layers=2)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_ssm_training_learns():
    # the tiny SSD learns the task more slowly than attention: a steady
    # finite decrease (the reference test's calibrated threshold)
    losses, _, _ = _run("mamba2-2.7b", steps=60, num_layers=2)
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.04


def test_train_then_serve_roundtrip():
    """Train briefly, then serve the trained params: the engine emits the
    model's own greedy continuations."""
    _, params, model = _run("olmo-1b", steps=10, num_layers=2)
    eng = ServingEngine(model, params, num_slots=2, capacity=64,
                        device="cpu")
    prompts = [[1, 2, 3], [9, 8, 7, 6]]
    for p in prompts:
        eng.submit(p, max_new_tokens=4)
    done = eng.run()
    assert len(done) == 2
    for r in done:
        assert len(r.output) == 4
        assert all(0 <= t < model.cfg.vocab_size for t in r.output)
        toks = list(prompts[r.rid])
        with torch.no_grad():
            for _ in range(4):
                logits, _ = model.forward(params, {"tokens": np.asarray(
                    [toks], np.int32)})
                toks.append(int(logits[0, -1].argmax()))
        assert r.output == toks[len(prompts[r.rid]):]


EXAMPLES = {
    "torch_quickstart.py": ["--n", "128", "--long", "2048"],
    "torch_train_lm.py": ["--steps", "3", "--seq", "32", "--batch", "2"],
    "torch_serve_batched.py": ["--chunk-size", "16", "--shared-prefix", "8",
                               "--requests", "4"],
    "torch_long_context_classification.py": ["--steps", "2", "--eval", "8",
                                             "--seqs", "128"],
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args = list(EXAMPLES[name])
    if name == "torch_train_lm.py":
        args += ["--ckpt-dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *args], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    want = {"torch_quickstart.py": "[3] block-sparse",
            "torch_train_lm.py": "final loss",
            "torch_serve_batched.py": "ok",
            "torch_long_context_classification.py": "Paper Table 5"}[name]
    assert last.startswith(want), out.stdout[-2000:]
    # the card is the default: without one it raises
    if not torch.cuda.is_available():
        bad = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                              *args], capture_output=True, text=True,
                             env=env, timeout=300)
        assert bad.returncode != 0
        assert "torch.cuda.is_available() is False" in bad.stderr


def test_examples_import_only_the_port():
    """The port's examples import ``repro_torch`` and the libraries the
    card's machine has, never ``jax`` or ``repro``."""
    for name in EXAMPLES:
        tree = ast.parse((ROOT / "examples" / name).read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
        tops = {m.split(".")[0] for m in mods}
        assert "repro_torch" in tops, name
        assert not tops & {"jax", "jaxlib", "repro"}, (name, tops)
