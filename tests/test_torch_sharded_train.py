"""Sharded training in the port (``train.steps.make_sharded_train_step``)
as SPMD ranks over gloo on the CPU: one spawn a world size (2, 4 and 8
ranks; ``repro_torch.distributed.launch.train``, each rank importing only
``repro_torch``), weights from the JAX ``Model.init``.

  * the counterpart of the reference's ``test_sharded_train_step_tp_dp_
    zero1``: reduced granite-3-2b (d 64, d_ff 128, 4 q / 2 kv heads of
    16, vocab 256: heads, FFN and the tied vocab sharded) at data 2 x
    model 2 and data 2 x model 4 (a kv head cut across ranks), ZeRO-1,
    3 AdamW steps: losses within 1e-4 relative of the JAX
    ``make_train_step``, params within the reference test's rtol 5e-2 /
    atol 5e-5, the moments cut over more ranks than the params; the same
    at ``grad_accum=4`` (the counterpart of ``test_grad_accum_
    equivalence``), reduced olmo (untied head, vocab sharded) with AdamW
    and reduced bert (non-causal, LayerNorm) with LAMB;
  * every rank's collective census of every step equal to
    ``expected_train_census``;
  * reduced qwen3-32b (qk-norm, a kv head cut across ranks, remat),
    internlm2-20b and gpt2-medium at model 2 against the JAX step;
  * reduced olmoe-1b-7b and mamba2-2.7b data-parallel at data 2, with and
    without ZeRO-1, and at model 2 (experts and SSM head groups cut),
    against the JAX step; published hymba-1.5b's step built at model 2 and
    4, its heads replicated (``train_rules``), its SSM and MLP cut
    (``tests/test_torch_family_parallel_train.py`` holds every family at
    model > 1 in depth, reduced hymba with heads that do not cut whole
    among them);
  * attention dropout 0.1 at data 2 x model 2 against the single-rank
    port step, and the keep mask at (b0, h0, H) a slice of the
    reference's ``full_dropout_keep_mask``;
  * ``zero1_state_specs``, ``auto_rules`` and ``resolve_spec`` equal to
    the reference's; ``make_production_mesh`` / ``make_test_mesh``
    refusing a world of the wrong size;
  * elastic resume: a checkpoint saved at data 2 x model 2 resumed at
    model 2 and in one process, the loss curve an uninterrupted run's;
  * the train launcher at ``--data 2 --model 2`` against ``--data 1
    --model 1``.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.distributed import sharding as jax_sharding
from repro.distributed import zero as jax_zero
from repro.kernels import ref as jax_ref
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import lamb as jax_lamb
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed import launch
from repro_torch.distributed.meshes import data_axis_names, num_data_shards
from repro_torch.distributed.sharding import (P, auto_rules,
                                              expected_train_census,
                                              resolve_spec, rules_for_mesh,
                                              train_cuts, train_rules)
from repro_torch.distributed.zero import zero1_state_specs
from repro_torch.kernels.ref import full_dropout_keep_mask
from repro_torch.models import build_model, params_from_jax
from repro_torch.optim import adamw, lamb
from repro_torch.train import Trainer, TrainerConfig, make_train_step

torch.set_num_threads(1)
GRANITE = dict(d_model=64, d_ff=128, num_heads=4, num_kv_heads=2,
               head_dim=16, vocab_size=256)
ARCH_KW = {"granite-3-2b": GRANITE, "olmo-1b": {}, "bert-large": {},
           "olmoe-1b-7b": {}, "mamba2-2.7b": {}, "qwen3-32b": {},
           "internlm2-20b": {}, "gpt2-medium": {}}
# the other dense decoders at model 2: qwen3 with qk-norm (its 4 q / 1 kv
# heads cut a kv head across the ranks) and remat, internlm2 (4 / 1),
# gpt2 (LayerNorm, GELU)
MODEL2 = ("qwen3-32b", "internlm2-20b", "gpt2-medium")
OPTS = {"adamw": ({"name": "adamw", "lr": 1e-3}, lambda: jax_adamw(1e-3),
                  lambda: adamw(1e-3)),
        "lamb": ({"name": "lamb", "lr": 1e-3}, lambda: jax_lamb(1e-3),
                 lambda: lamb(1e-3))}
STEPS = 3


def batches(n=STEPS, rows=8, seq=32, seed=5):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 256, (rows, seq)).astype(np.int32),
             "loss_mask": (rng.random((rows, seq)) > 0.2).astype(np.float32)}
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def weights(arch):
    """(port cfg, numpy params in the port's layout, JAX model, JAX
    params)."""
    kw = ARCH_KW[arch]
    jmodel = jax_build_model(jax_reduced_config(arch, **kw))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced_config(arch, **kw)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, tree_map(lambda t: t.numpy(), params), jmodel, jparams


@functools.lru_cache(maxsize=None)
def jax_run(arch, opt, grad_accum=1):
    """The JAX ``make_train_step``'s losses over the batches and its final
    params in the port's layout."""
    cfg, _, jmodel, jparams = weights(arch)
    jopt = OPTS[opt][1]()
    step = jax.jit(jax_make_train_step(jmodel, jopt, grad_accum=grad_accum))
    state = jopt.init(jparams)
    losses = []
    for b in batches():
        jparams, state, m = step(jparams, state,
                                 {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    final = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return losses, tree_map(lambda t: t.numpy(), final)


def by_path(tree, prefix=""):
    """A port tree (dicts and lists) as {path: leaf}."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in by_path(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in by_path(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def jax_by_path(tree):
    """A JAX spec tree as {path: spec tuple}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path): tuple(spec)
            for path, spec in flat}


def assert_params_close(got, want):
    got, want = by_path(got), by_path(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-2, atol=5e-5,
                                   err_msg=k)


def run(arch, shape, opt="adamw", **kw):
    cfg, params, _, _ = weights(arch)
    return dict({"cfg": cfg, "params": params, "shape": shape,
                 "optimizer": OPTS[opt][0], "batches": batches()}, **kw)


def dropout_cfg():
    return dataclasses.replace(reduced_config("granite-3-2b", **GRANITE),
                               attn_dropout=0.1, attn_impl="pallas")


def elastic_runs(tmp, shape):
    cfg, params, _, _ = weights("granite-3-2b")
    six = batches(n=6, seed=9)
    return [dict(run("granite-3-2b", shape), batches=six),
            dict(run("granite-3-2b", shape), batches=six[:3],
                 ckpt={"dir": tmp, "every": 3})]


# one spawn a world size: its runs, by name
RUNS4 = {
    "granite": lambda tmp: run("granite-3-2b", (2, 2), gather=True),
    "granite_accum": lambda tmp: run("granite-3-2b", (2, 2), grad_accum=4),
    "olmo": lambda tmp: run("olmo-1b", (2, 2), gather=True),
    "bert": lambda tmp: run("bert-large", (2, 2), opt="lamb"),
    "dropout": lambda tmp: dict(run("granite-3-2b", (2, 2)),
                                cfg=dropout_cfg(), deterministic=False),
    "granite_nozero": lambda tmp: run("granite-3-2b", (2, 2), zero1=False),
    "hymba_model4": lambda tmp: {"cfg": get_config("hymba-1.5b"),
                                 "shape": (1, 4),
                                 "optimizer": OPTS["adamw"][0],
                                 "batches": batches(), "expect_error": True},
}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("elastic"))


@functools.lru_cache(maxsize=None)
def spawned4(tmp):
    runs = [f(tmp) for f in RUNS4.values()] + elastic_runs(tmp, (2, 2))
    out = launch.train({"backend": "gloo", "device": "cpu", "runs": runs}, 4)
    names = list(RUNS4) + ["elastic_whole", "elastic_saved"]
    return {n: [recs[i] for recs in out] for i, n in enumerate(names)}


@functools.lru_cache(maxsize=None)
def spawned8():
    out = launch.train({"backend": "gloo", "device": "cpu",
                        "runs": [run("granite-3-2b", (2, 4), gather=True)]}, 8)
    return {"granite": [recs[0] for recs in out]}


def family_runs():
    runs, names = [], []
    for arch in ("olmoe-1b-7b", "mamba2-2.7b"):
        for zero1 in (True, False):
            runs.append(run(arch, (2, 1), zero1=zero1))
            names.append((arch, zero1))
        runs.append(run(arch, (1, 2)))
        names.append((arch, "model2"))
    runs.append({"cfg": get_config("hymba-1.5b"), "shape": (1, 2),
                 "optimizer": OPTS["adamw"][0], "batches": batches(),
                 "expect_error": True})
    names.append(("hymba-1.5b", "model2"))
    runs += [{"mesh_fn": "make_test_mesh"},
             {"mesh_fn": "make_production_mesh", "mesh_kw": {}},
             {"mesh_fn": "make_production_mesh",
              "mesh_kw": {"multi_pod": True}},
             {"mesh_fn": "make_test_mesh", "mesh_kw": {"data": 2,
                                                       "model": 1}}]
    names += ["test_mesh", "production", "multi_pod", "test_mesh_2x1"]
    for arch in MODEL2:
        r = run(arch, (1, 2))
        if arch == "qwen3-32b":
            r["cfg"] = dataclasses.replace(r["cfg"], remat=True)
        runs.append(r)
        names.append((arch, "model2"))
    return runs, names


@functools.lru_cache(maxsize=None)
def spawned2(tmp):
    spawned4(tmp)                   # the elastic checkpoint is saved there
    runs, names = family_runs()
    six = batches(n=6, seed=9)
    runs.append(dict(run("granite-3-2b", (1, 2)), batches=six,
                     ckpt={"dir": tmp, "every": 100, "resume": True}))
    names.append("elastic_resumed")
    out = launch.train({"backend": "gloo", "device": "cpu", "runs": runs}, 2)
    return {n: [recs[i] for recs in out] for i, n in enumerate(names)}


def losses(recs):
    return [h["loss"] for h in recs[0]["history"]]


def check_ranks(recs):
    """Every rank at its row-major coordinate, its losses rank 0's, every
    step's census the expected."""
    names = list(recs[0]["coord"])
    sizes = [max(r["coord"][a] for r in recs) + 1 for a in names]
    for r in recs:
        flat = 0
        for a, n in zip(names, sizes):
            flat = flat * n + r["coord"][a]
        assert flat == r["rank"], (r["rank"], r["coord"])
        assert [h["loss"] for h in r["history"]] == losses(recs)
        for c in r["census"]:
            assert c == r["expected_census"], (r["rank"], c)


@pytest.mark.parametrize("world", [4, 8])
def test_granite_tp_dp_zero1_matches_jax(world, ckpt_dir):
    recs = (spawned4(ckpt_dir) if world == 4 else spawned8())["granite"]
    check_ranks(recs)
    want, want_params = jax_run("granite-3-2b", "adamw")
    np.testing.assert_allclose(losses(recs), want, rtol=1e-4)
    assert_params_close(recs[0]["full"], want_params)
    # ZeRO-1: moments cut over more ranks than the params
    for r in recs:
        ps = [np.prod(s) for s in r["param_shapes"]]
        ms = [np.prod(s) for s in r["moment_shapes"]]
        assert all(m <= p for m, p in zip(ms, ps))
        assert sum(ms) < sum(ps)
    cfg = weights("granite-3-2b")[0]
    rules = auto_rules(cfg, {"data": 2, "model": world // 2}, global_batch=8)
    assert rules["vocab"] == rules["heads"] == rules["ff"] == "model"
    census = recs[0]["expected_census"]
    assert census == expected_train_census(
        cfg, {"data": 2, "model": world // 2}, rules, zero1=True)
    if world == 8:          # a kv head cut across ranks: gathered
        assert census["all_gather"] == 2 * cfg.num_layers + 1


@pytest.mark.parametrize("name, arch, opt, accum", [
    ("granite_accum", "granite-3-2b", "adamw", 4),
    ("granite_nozero", "granite-3-2b", "adamw", 1),
    ("olmo", "olmo-1b", "adamw", 1),
    ("bert", "bert-large", "lamb", 1)])
def test_data2_model2_matches_jax(name, arch, opt, accum, ckpt_dir):
    recs = spawned4(ckpt_dir)[name]
    check_ranks(recs)
    want, want_params = jax_run(arch, opt, accum)
    np.testing.assert_allclose(losses(recs), want, rtol=1e-4)
    if "full" in recs[0]:
        assert_params_close(recs[0]["full"], want_params)
    if arch == "olmo-1b":   # the untied head, its vocab columns sharded
        cfg = weights(arch)[0]
        assert not cfg.tie_embeddings
        r = recs[0]
        heads = [s for s in r["param_shapes"] if s == (cfg.d_model,
                                                       cfg.vocab_size // 2)]
        assert heads, r["param_shapes"]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-2.7b"])
@pytest.mark.parametrize("zero1", [True, False])
def test_data_parallel_families_match_jax(arch, zero1, ckpt_dir):
    recs = spawned2(ckpt_dir)[(arch, zero1)]
    check_ranks(recs)
    want, _ = jax_run(arch, "adamw")
    np.testing.assert_allclose(losses(recs), want, rtol=1e-4)
    if arch == "olmoe-1b-7b":
        cfg, params, _, _ = weights(arch)
        port = make_train_step(build_model(cfg), adamw(1e-3),
                               deterministic=True)
        p = tree_map(torch.from_numpy, params)
        st = adamw(1e-3).init(p)
        for b, h in zip(batches(), recs[0]["history"]):
            p, st, m = port(p, st, b)
            for key in ("ce", "aux", "tokens"):
                np.testing.assert_allclose(h[key], float(m[key]), rtol=1e-4)


@pytest.mark.parametrize("arch", MODEL2)
def test_dense_decoders_at_model2_match_jax(arch, ckpt_dir):
    recs = spawned2(ckpt_dir)[(arch, "model2")]
    check_ranks(recs)
    want, _ = jax_run(arch, "adamw")
    np.testing.assert_allclose(losses(recs), want, rtol=1e-4)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-2.7b",
                                  "hymba-1.5b"])
def test_moe_ssm_and_hybrid_at_model2(arch, ckpt_dir):
    """The MoE and the SSM train at model 2 (experts and SSM head groups
    cut over "model") against the JAX step, every rank's census the
    expected; published hymba-1.5b's 25 q / 5 kv heads of 64, which do not
    cut whole over 2 or 4 ranks, build a step at model 2 and at model 4
    with no error: ``train_rules`` replicates the heads, the SSM is cut by
    head group at model 2 (its widths do not divide by 4, so ``auto_rules``
    keeps it whole there) and the MLP at both."""
    if arch == "hymba-1.5b":
        cfg = get_config(arch)
        for recs, m in ((spawned2(ckpt_dir)[(arch, "model2")], 2),
                        (spawned4(ckpt_dir)["hymba_model4"], 4)):
            for rec in recs:
                assert rec["error"] is None, rec["error"]
            shape = {"data": 1, "model": m}
            rules = auto_rules(cfg, shape, global_batch=8)
            assert rules["heads"] == "model"       # the reference's rules
            run_rules = train_rules(cfg, shape, rules)
            assert run_rules == dict(rules, heads=None)
            assert train_cuts(cfg, shape, run_rules) == {
                "heads": False, "ff": True, "vocab": False,
                "experts": False, "ssm": m == 2}
            assert train_cuts(cfg, shape, rules) == train_cuts(
                cfg, shape, run_rules)
        return
    recs = spawned2(ckpt_dir)[(arch, "model2")]
    check_ranks(recs)
    want, _ = jax_run(arch, "adamw")
    np.testing.assert_allclose(losses(recs), want, rtol=1e-4)


def test_dropout_at_global_coordinates(ckpt_dir):
    recs = spawned4(ckpt_dir)["dropout"]
    check_ranks(recs)
    cfg = dropout_cfg()
    params = tree_map(torch.from_numpy, weights("granite-3-2b")[1])
    step = make_train_step(build_model(cfg), adamw(1e-3),
                           deterministic=False)
    st = adamw(1e-3).init(params)
    want = []
    for b in batches():
        params, st, m = step(params, st, b)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(losses(recs), want, rtol=1e-4)
    # without the global coordinates the ranks would draw other masks
    nodrop = spawned4(ckpt_dir)["granite"]
    assert abs(losses(recs)[0] - losses(nodrop)[0]) > 1e-4


@pytest.mark.parametrize("b0, h0", [(0, 0), (2, 1), (5, 3)])
def test_keep_mask_is_a_slice_of_the_reference(b0, h0):
    B, H, S, b, h = 8, 4, 24, 3, 1
    want = np.asarray(jax_ref.full_dropout_keep_mask(11, B, H, S, S, 0.1))
    got = full_dropout_keep_mask(11, b, h, S, S, 0.1, coords=(b0, h0, H))
    np.testing.assert_array_equal(got.numpy(),
                                  want[b0:b0 + b, h0:h0 + h])
    assert torch.equal(full_dropout_keep_mask(11, B, H, S, S, 0.1),
                       full_dropout_keep_mask(11, B, H, S, S, 0.1,
                                              coords=(0, 0, H)))


def _mesh(shape: dict):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


@pytest.mark.parametrize("arch", ["granite-3-2b", "olmo-1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("shape", [{"data": 2, "model": 4},
                                   {"pod": 2, "data": 2, "model": 4}])
def test_zero1_state_specs_equal_reference(arch, shape):
    jmodel = jax_build_model(jax_get_config(arch))
    jshapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    jrules = jax_sharding.auto_rules(jax_get_config(arch), _mesh(shape),
                                     global_batch=16)
    want = jax_zero.zero1_state_specs(jshapes, jmodel.param_specs(),
                                      _mesh(shape), jrules)
    model = build_model(get_config(arch))
    rules = auto_rules(get_config(arch), shape, global_batch=16)
    assert rules == jrules
    got = zero1_state_specs(model.param_shapes(), model.param_specs(), shape,
                            rules)
    assert got["step"] == P() and want["step"] == JP()
    # the reference's blocks are stacked on a leading layer axis: its spec
    # is the port's per-layer spec with one more leading entry
    want_mu = jax_by_path(want["mu"])
    got_mu = {k: tuple(v) for k, v in by_path(got["mu"]).items()}
    n = get_config(arch).num_layers
    for path, spec in want_mu.items():
        if path.startswith("/blocks/"):
            assert spec[0] is None, path
            for l in range(n):
                assert got_mu.pop("/blocks/%d/%s" % (l, path[8:])) == \
                    spec[1:], path
        else:
            assert got_mu.pop(path) == spec, path
    assert not got_mu


@pytest.mark.parametrize("spec, rules", [
    (("embed", "heads"), {"heads": "model", "embed": None}),
    (("data", None), {"data": ("pod", "data")}),
    ((None, "unknown"), {}),
    ((("data",), "ff"), {"data": ("pod", "data"), "ff": "model"})])
def test_resolve_spec_equals_reference(spec, rules):
    assert tuple(resolve_spec(P(*spec), rules)) == tuple(
        jax_sharding.resolve_spec(JP(*spec), rules))


@pytest.mark.parametrize("arch, shape, batch", [
    ("granite-3-2b", {"data": 2, "model": 4}, 8),
    ("hymba-1.5b", {"data": 2, "model": 4}, 8),
    ("olmo-1b", {"data": 2, "model": 4}, 1),
    ("qwen3-32b", {"pod": 2, "data": 2, "model": 4}, 8),
    ("olmoe-1b-7b", {"data": 2, "model": 16}, 32)])
def test_auto_rules_equal_reference(arch, shape, batch):
    want = jax_sharding.auto_rules(jax_get_config(arch), _mesh(shape),
                                   global_batch=batch)
    assert auto_rules(get_config(arch), shape, global_batch=batch) == want
    assert rules_for_mesh(shape) == jax_sharding.rules_for_mesh(_mesh(shape))


def test_data_axis_names_and_shards():
    for shape, axes, n in (({"data": 2, "model": 4}, ("data",), 2),
                           ({"pod": 2, "data": 2, "model": 4},
                            ("pod", "data"), 4),
                           ({"pipe": 4}, (), 1)):
        mesh = _mesh(shape)
        assert data_axis_names(mesh) == axes
        assert num_data_shards(mesh) == n


def test_launch_meshes_refuse_a_wrong_world(ckpt_dir):
    out = spawned2(ckpt_dir)
    for name, shape in (("test_mesh", "(2, 4)"), ("production", "(16, 16)"),
                        ("multi_pod", "(2, 16, 16)")):
        for rec in out[name]:
            assert rec["error"] is not None and shape in rec["error"]
            assert "has 2 ranks" in rec["error"]
    assert all(r["error"] is None for r in out["test_mesh_2x1"])


def test_elastic_resume_across_meshes(ckpt_dir):
    whole = losses(spawned4(ckpt_dir)["elastic_whole"])
    saved = spawned4(ckpt_dir)["elastic_saved"]
    assert losses(saved) == whole[:3]
    resumed = spawned2(ckpt_dir)["elastic_resumed"]
    assert resumed[0]["start"] == 3
    check_ranks(resumed)
    np.testing.assert_allclose(losses(resumed), whole[3:], rtol=1e-5)
    # and in one process, through the unsharded step
    cfg, params, _, _ = weights("granite-3-2b")
    p = tree_map(torch.from_numpy, params)
    opt = adamw(1e-3)
    trainer = Trainer(TrainerConfig(total_steps=6, ckpt_dir=ckpt_dir,
                                    ckpt_every=100),
                      make_train_step(build_model(cfg), opt,
                                      deterministic=True),
                      p, opt.init(p), lambda i: batches(n=6, seed=9)[i])
    assert trainer.try_resume() and trainer.step == 3
    np.testing.assert_allclose([h["loss"] for h in trainer.run()], whole[3:],
                               rtol=1e-5)


def test_train_launcher_data2_model2(tmp_path):
    from repro_torch.launch import train as launch_train

    args = ["--reduced", "--device", "cpu", "--steps", "3", "--seq", "32",
            "--batch", "4", "--ckpt-every", "100"]
    one = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    four = launch_train.main(args + ["--data", "2", "--model", "2",
                                     "--ckpt-dir", str(tmp_path / "b")])
    want = [h["loss"] for h in one.history]
    assert len(four) == 4
    for rec in four:
        np.testing.assert_allclose([h["loss"] for h in rec["history"]], want,
                                   rtol=1e-4)
