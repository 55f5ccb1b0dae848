"""Dry-run of the port: a per-rank estimate of every (architecture x input
shape x production mesh) cell, on meta tensors and shape mappings only (no
device, no ranks):

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k --mesh single --out /tmp/dryrun.jsonl

The cells are ``configs.ASSIGNED`` x ``configs.SHAPES`` x the production
meshes (16, 16) ``("data", "model")`` and (2, 16, 16) ``("pod", "data",
"model")`` (``launch.mesh.make_production_mesh``). Each record (one JSON
object a line, to stdout or ``--out``) holds:

  * whether the cell applies (``configs.cell_is_applicable``; a skipped
    cell says why);
  * the rules from ``distributed.sharding.auto_rules`` and, for a train
    cell, those the sharded train step runs (``train_rules``: heads that
    do not cut whole replicated) with what the step cuts over "model";
  * per rank, in bytes: the parameters, for a train cell their gradients
    (the param pieces' shapes and dtypes) and the AdamW moments (two
    float32 trees at the ZeRO-1 slices, ``distributed.zero.
    zero1_state_specs``; the step counter lives on the host), the batch
    (``Model.input_specs``), and for a prefill or decode cell the slot
    cache or decode state (``Model.init_decode_state`` on the meta
    device);
  * for a train cell, the collective census of one step
    (``expected_train_census``: what every rank of
    ``make_sharded_train_step`` counts);
  * any dim that does not divide its mesh axes (the preflight's
    messages).

The JAX dry-run (``repro.launch.dryrun``) also reads FLOPs, HBM bytes
and activation bytes off XLA's ``cost_analysis`` and ``memory_analysis``
of the compiled step; the port has no compiled program to ask, so this
estimate leaves them out. It writes nothing under ``benchmarks/`` (so
the reference's ``--tag`` and ``--force`` have no counterpart).
``--override 'k=v,...'`` replaces config fields before every cell
(``parse_overrides``: ints, ``true``/``false``, else strings; a record
made under overrides carries them). No cell here resolves a tile, so the
reference's ``--autotune`` / ``--sram-budget`` have no counterpart
either.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Any, Mapping

from repro_torch.configs import (ASSIGNED, SHAPES, cell_is_applicable,
                                 get_config)
from repro_torch.distributed.sharding import (auto_rules,
                                              expected_train_census,
                                              local_shape, resolve_spec,
                                              train_cuts, train_rules,
                                              validate_divisibility)
from repro_torch.distributed.sharding import _walk
from repro_torch.distributed.zero import _data_axes, zero1_state_specs
from repro_torch.models import build_model

MESHES: dict[str, dict[str, int]] = {
    "pod16x16": {"data": 16, "model": 16},
    "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def tree_bytes(tree, specs, axes: Mapping[str, int],
               rules: Mapping[str, Any] | None, itemsize: int = 0) -> int:
    """Bytes a rank holds of a tree of meta tensors under its logical
    specs (``rules`` None: the specs are physical already); ``itemsize``
    overrides the leaves' (4: the float32 moments)."""
    total = []

    def one(_, leaf, spec):
        phys = resolve_spec(spec, rules) if rules is not None else spec
        total.append(math.prod(local_shape(tuple(leaf.shape), phys, axes))
                     * (itemsize or leaf.dtype.itemsize))

    _walk("", tree, specs, one)
    return sum(total)


def train_state_bytes(cfg, axes: Mapping[str, int], rules) -> dict:
    """A train cell's per-rank parameter, gradient and AdamW-moment bytes
    under the step's rules (``train_rules`` of ``rules``), ZeRO-1 on, and
    whether ZeRO-1 cuts some moment leaf / keeps some whole."""
    model = build_model(cfg)
    shapes, specs = model.param_shapes(), model.param_specs()
    rules = train_rules(cfg, axes, rules)
    params = tree_bytes(shapes, specs, axes, rules)
    moments = zero1_state_specs(shapes, specs, axes, rules)["mu"]
    data = set(_data_axes(axes))
    cut = []
    _walk("", moments, moments, lambda _, __, spec: cut.append(bool(
        data & {a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))})))
    return {"params": params, "grads": params,
            "opt_state": 2 * tree_bytes(shapes, moments, axes, None, 4),
            "cut_leaves": any(cut), "whole_leaves": not all(cut)}


def decode_state_bytes(cfg, axes: Mapping[str, int], rules, shape, *,
                       page_size: int | None = None) -> int:
    """Bytes a rank holds of the decode state of a ``shape`` (its
    ``global_batch`` lanes at a capacity of its ``seq_len``; an
    encoder-decoder's half of it, with its cross cache for the other
    half) under ``Model.decode_state_specs``, or with ``page_size`` of a
    pool of every lane's pages under ``paged_decode_state_specs``: what
    ``train.steps.make_sharded_serve_steps``' prefill allocates on each
    rank."""
    model = build_model(cfg)
    if page_size is not None:
        pages = shape.seq_len // page_size
        state = model.init_paged_decode_state(
            shape.global_batch, shape.global_batch * pages, page_size,
            pages, device="meta")
        return tree_bytes(state, model.paged_decode_state_specs(), axes,
                          rules)
    enc = cfg.num_encoder_layers > 0
    capacity = shape.seq_len // 2 if enc else shape.seq_len
    state = model.init_decode_state(shape.global_batch, capacity,
                                    device="meta",
                                    enc_len=capacity if enc else 0)
    return tree_bytes(state, model.decode_state_specs(), axes, rules)


def parse_overrides(spec: str | None) -> dict:
    """--override 'ssm_chunk=64,attn_pv_bf16=true,ssm_decay_dtype=bfloat16'"""
    out = {}
    if not spec:
        return out
    for kv in spec.split(","):
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def cell(arch: str, shape_name: str, mesh_name: str,
         axes: Mapping[str, int] | None = None,
         overrides: dict | None = None) -> dict:
    """The record of one cell (module docstring), of the arch's config
    with ``overrides`` replaced."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    axes = dict(axes or MESHES[mesh_name])
    rec: dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "axes": axes, "chips": math.prod(axes.values()), "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch}
    if overrides:
        rec["overrides"] = dict(overrides)
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        rec["skipped"] = why
        return rec
    rules = auto_rules(cfg, axes, global_batch=shape.global_batch)
    rec["rules"] = _plain(rules)
    model = build_model(cfg)
    shapes, specs = model.param_shapes(), model.param_specs()
    inputs, input_specs = model.input_specs(shape)
    by_rank: dict[str, int] = {}
    problems: list[str] = []
    if shape.kind == "train":
        step_rules = train_rules(cfg, axes, rules)
        rec["train_rules"] = _plain(step_rules)
        rec["cuts"] = train_cuts(cfg, axes, step_rules)
        state = train_state_bytes(cfg, axes, rules)
        by_rank.update(params=state["params"], grads=state["grads"],
                       opt_state=state["opt_state"])
        by_rank["batch"] = tree_bytes(inputs, input_specs, axes, step_rules)
        problems += validate_divisibility(shapes, specs, axes, step_rules)
        rec["census"] = expected_train_census(
            cfg, axes, step_rules, zero1=True,
            cut_leaves=state["cut_leaves"],
            whole_leaves=state["whole_leaves"])
    else:
        by_rank["params"] = tree_bytes(shapes, specs, axes, rules)
        problems += validate_divisibility(shapes, specs, axes, rules)
        if shape.kind == "prefill":
            # the slot cache the prompt fills: the decode state at the
            # prefill's capacity
            by_rank["batch"] = tree_bytes(inputs, input_specs, axes, rules)
            enc = cfg.num_encoder_layers > 0
            capacity = shape.seq_len // 2 if enc else shape.seq_len
            cache = model.init_decode_state(
                shape.global_batch, capacity, device="meta",
                enc_len=capacity if enc else 0)
            cache_specs = model.decode_state_specs()
        else:
            (cache, token), (cache_specs, token_spec) = inputs, input_specs
            by_rank["batch"] = tree_bytes(token, token_spec, axes, rules)
        by_rank["cache"] = decode_state_bytes(cfg, axes, rules, shape)
        problems += validate_divisibility(cache, cache_specs, axes, rules)
    by_rank["total"] = sum(by_rank.values())
    rec["bytes_per_rank"] = by_rank
    rec["problems"] = problems
    return rec


def _plain(rules) -> dict:
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in rules.items()}


def cells(archs=None, shapes=None, meshes=None, overrides=None):
    """Every record of ``archs`` x ``shapes`` x ``meshes`` (default: all
    the assigned archs, all shapes, both production meshes)."""
    for mesh_name in meshes or MESHES:
        for arch in archs or ASSIGNED:
            for shape_name in shapes or SHAPES:
                yield cell(arch, shape_name, mesh_name,
                           overrides=overrides)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default=None,
                    help="write the records here (JSON lines) instead of "
                         "stdout")
    ap.add_argument("--override", default=None,
                    help="config overrides, e.g. ssm_chunk=64,attn_pv_bf16=true")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.override)
    meshes = {"single": ["pod16x16"], "multi": ["pod2x16x16"],
              "both": list(MESHES)}[args.mesh]
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        for rec in cells([args.arch] if args.arch else None,
                         [args.shape] if args.shape else None, meshes,
                         overrides):
            out.write(json.dumps(rec) + "\n")
    finally:
        if args.out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
