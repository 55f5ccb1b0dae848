"""The port's dry-run (``repro_torch.launch.dryrun``) and what it reads,
against the JAX package, on the CPU without devices:

  * ``SHAPES``, ``ASSIGNED``, ``get_shape``, ``list_archs`` and
    ``cell_is_applicable`` equal to the reference's for every cell;
  * ``Model.input_specs`` of every arch at every shape: the batch (train,
    prefill) or the decode state and token (decode) with the reference's
    shapes and dtypes and logical specs, leaf by leaf (the port's
    encoder-decoder state also holds ``enc_len``, (B,) int32 over "data",
    which the reference's does not);
  * per-rank parameter bytes of every ASSIGNED x SHAPES cell at (16, 16)
    against the reference's: ``jax.eval_shape(model.init)`` resolved
    through its ``auto_rules`` / ``resolve_tree`` over a
    ``jax.sharding.AbstractMesh((16, 16), ("data", "model"))``, each
    leaf's ``NamedSharding.shard_shape``. Leaf for leaf equal, apart from
    the port's two kept differences: the SSM's head-group storage (a cut
    ``in_proj`` / ``conv_w`` / ``conv_b`` keeps its B and C columns whole
    on every rank, ROADMAP §3) and a train cell whose heads do not cut
    whole (hymba-1.5b's 25 q / 5 kv heads at 16: the step replicates the
    attention, ``train_rules``); each is held to its exact size;
  * every cell's record: the skip reasons, no divisibility problem, the
    train cells' census equal to ``expected_train_census`` of the step's
    rules, and the command line writing one record a cell.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jax_configs
from repro.distributed import sharding as jax_sharding
from repro.models import build_model as jax_build_model
from repro_torch import configs
from repro_torch.distributed.sharding import (Pieces, auto_rules,
                                              expected_train_census,
                                              resolve_spec, train_rules)
from repro_torch.launch import dryrun
from repro_torch.models import build_model


def test_shapes_archs_and_applicability_equal_reference():
    assert configs.ASSIGNED == jax_configs.ASSIGNED
    assert configs.list_archs() == jax_configs.list_archs()
    assert list(configs.SHAPES) == list(jax_configs.SHAPES)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jax_configs.get_shape(name))
        assert configs.get_shape(name) is shape
    for arch in configs.ARCHS:
        for name in configs.SHAPES:
            assert configs.cell_is_applicable(
                configs.get_config(arch), configs.SHAPES[name]) == \
                jax_configs.cell_is_applicable(
                    jax_configs.get_config(arch), jax_configs.SHAPES[name])


def _paths(tree, prefix=""):
    """{path: leaf} of a tree of dicts (specs are tuples: leaves)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _paths(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def _jax_paths(tree):
    return _paths(jax.tree.map(lambda x: x, tree,
                               is_leaf=lambda x: isinstance(x, tuple)))


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_input_specs_equal_reference(arch):
    model = build_model(configs.get_config(arch))
    jmodel = jax_build_model(jax_configs.get_config(arch))
    for name, shape in configs.SHAPES.items():
        got, got_specs = model.input_specs(shape)
        want, want_specs = jmodel.input_specs(jax_configs.SHAPES[name])
        if shape.kind == "decode":
            (got, token), (got_specs, token_spec) = got, got_specs
            (want, wtoken), (want_specs, wtoken_spec) = want, want_specs
            assert tuple(token.shape) == wtoken.shape
            assert str(token.dtype)[6:] == str(wtoken.dtype)
            assert tuple(token_spec) == tuple(wtoken_spec)
            if "enc_len" in got:            # the port's, not the reference's
                assert tuple(got["enc_len"].shape) == (shape.global_batch,)
                assert str(got["enc_len"].dtype) == "torch.int32"
                assert tuple(got_specs.pop("enc_len")) == ("data",)
                got = {k: v for k, v in got.items() if k != "enc_len"}
        got, got_specs = _paths(got), _paths(got_specs)
        want, want_specs = _jax_paths(want), _jax_paths(want_specs)
        assert set(got) == set(want) == set(got_specs) == set(want_specs), \
            (arch, name)
        for path, leaf in got.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == want[path].shape, (arch, name, path)
            assert str(leaf.dtype)[6:] == str(want[path].dtype), \
                (arch, name, path)
            assert tuple(got_specs[path]) == tuple(want_specs[path]), \
                (arch, name, path)


MESH = {"data": 16, "model": 16}


def _reference_leaf_bytes(arch, shape):
    """{path: bytes a rank holds} of the reference's params at (16, 16),
    its stacked blocks as one leaf."""
    cfg = jax_configs.get_config(arch)
    jmodel = jax_build_model(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    mesh = AbstractMesh((16, 16), ("data", "model"))
    rules = jax_sharding.auto_rules(cfg, mesh,
                                    global_batch=shape.global_batch)
    sh = jax_sharding.resolve_tree(jmodel.param_specs(), mesh, rules)
    out = {}
    for (path, leaf), s in zip(jax.tree_util.tree_leaves_with_path(shapes),
                               jax.tree.leaves(sh)):
        key = "/" + "/".join(str(p.key) for p in path)
        out[key] = math.prod(s.shard_shape(leaf.shape)) * \
            jnp.dtype(leaf.dtype).itemsize
    return out


def _port_leaf_bytes(arch, shape):
    """{path: (bytes a rank holds, physical spec)} of the port's params
    at (16, 16) under the rules the cell runs, a block's leaves summed over
    its layers under the reference's stacked path."""
    cfg = configs.get_config(arch)
    model = build_model(cfg)
    rules = auto_rules(cfg, MESH, global_batch=shape.global_batch)
    if shape.kind == "train":
        rules = train_rules(cfg, MESH, rules)
    out = {}

    def walk(tree, specs, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], specs[k], f"{path}/{k}")
        elif isinstance(tree, list):
            for t, s in zip(tree, specs):
                walk(t, s, path)
        else:
            phys = resolve_spec(specs, rules)
            n = dryrun.tree_bytes(tree, phys, MESH, None)
            old = out.get(path, (0, phys))[0]
            out[path] = (old + n, phys)

    walk(model.param_shapes(), model.param_specs(), "")
    return out


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_param_bytes_per_rank_equal_reference(arch):
    cfg = configs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        if not configs.cell_is_applicable(cfg, shape)[0]:
            continue
        want = _reference_leaf_bytes(arch, shape)
        got = _port_leaf_bytes(arch, shape)
        assert set(got) == set(want), (arch, name)
        replicated_heads = (shape.kind == "train"
                            and train_rules(cfg, MESH, auto_rules(
                                cfg, MESH))["heads"] is None)
        for path, (n, phys) in got.items():
            pieces = [e for e in phys if isinstance(e, Pieces)]
            if pieces:
                # B and C (2 x ssm_state columns or channels) whole on
                # every rank: (m - 1) / m of them more than a contiguous cut
                whole = sum(s for s, c in zip(pieces[0].sizes,
                                              pieces[0].cut) if not c)
                rows = {"/blocks/ssm/in_proj": cfg.d_model,
                        "/blocks/ssm/conv_w": cfg.ssm_conv_width,
                        "/blocks/ssm/conv_b": 1}[path]
                extra = (whole * rows * cfg.num_layers * 15 // 16
                         * (2 if cfg.dtype == "bfloat16" else 4))
                assert n == want[path] + extra, (arch, name, path)
            elif replicated_heads and "/attn/" in path and \
                    want[path] != n:
                assert n == 16 * want[path], (arch, name, path)
            else:
                assert n == want[path], (arch, name, path)
        rec = dryrun.cell(arch, name, "pod16x16")
        assert rec["bytes_per_rank"]["params"] == sum(
            n for n, _ in got.values())


def test_every_cell_has_a_record(capsys):
    recs = [json.loads(line) for line in _run_main(capsys)]
    assert len(recs) == 2 * len(configs.ASSIGNED) * len(configs.SHAPES)
    for rec in recs:
        cfg = configs.get_config(rec["arch"])
        shape = configs.SHAPES[rec["shape"]]
        ok, why = configs.cell_is_applicable(cfg, shape)
        assert rec.get("skipped", "") == why
        if not ok:
            continue
        assert rec["problems"] == []
        b = rec["bytes_per_rank"]
        assert b["total"] == sum(v for k, v in b.items() if k != "total")
        assert b["params"] > 0 and b["batch"] > 0
        if shape.kind == "train":
            assert b["grads"] == b["params"] and b["opt_state"] > 0
            rules = auto_rules(cfg, rec["axes"],
                               global_batch=shape.global_batch)
            state = dryrun.train_state_bytes(cfg, rec["axes"], rules)
            census = expected_train_census(
                cfg, rec["axes"], train_rules(cfg, rec["axes"], rules),
                zero1=True, cut_leaves=state["cut_leaves"],
                whole_leaves=state["whole_leaves"])
            assert rec["census"] == census
        else:
            assert b["cache"] > 0
    # the pod axis joins the data axes: the moments cut twice as finely
    by = {(r["mesh"], r["arch"], r["shape"]): r for r in recs}
    single = by[("pod16x16", "qwen3-32b", "train_4k")]["bytes_per_rank"]
    multi = by[("pod2x16x16", "qwen3-32b", "train_4k")]["bytes_per_rank"]
    assert single["params"] == multi["params"]
    assert 1.9 < single["opt_state"] / multi["opt_state"] <= 2.0


def _run_main(capsys):
    assert dryrun.main([]) == 0
    return capsys.readouterr().out.splitlines()


def test_single_rank_train_state_is_params_and_two_float32_moments():
    cfg = configs.get_config("granite-3-2b")
    axes = {"data": 1, "model": 1}
    state = dryrun.train_state_bytes(cfg, axes, auto_rules(cfg, axes))
    numel = _numel(build_model(cfg).param_shapes())
    assert state["params"] == state["grads"] == 2 * numel       # bf16
    assert state["opt_state"] == 2 * 4 * numel


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()
