"""Logical-axis sharding rules (port of ``repro.distributed.sharding``'s
rule tables, preflight and census contract) and ``shard_params``.

Model code names each parameter axis logically (``Model.param_specs``:
"embed", "heads", "ff", "vocab", ...); a rule table maps logical names to
mesh axes, and an unlisted name is replicated. The serving tables shard
only heads and the FFN hidden dim over "tp" (``tp_serve_rules``), so
embedding, vocab and ``lm_head`` stay replicated and, after the two
per-layer all-reduces, so do activations and logits. Heads shard
contiguously, which keeps each q-head group on the rank of its kv head
(GQA co-location): ``wq`` by q heads, ``wk`` / ``wv`` by kv heads, ``wo``
and ``w_down`` by rows, ``w_up`` / ``w_gate`` by columns.

A mesh here is anything with a ``shape`` mapping axis names to sizes (a
``meshes.ServeMesh``) or such a mapping itself; ``shard_params`` also
needs the rank's coordinate (a ``ServeMesh``).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch

# default rules: a 2-D/3-D mesh with tensor parallelism on "model" and
# data parallelism on ("pod", "data"), as the reference's
DEFAULT_RULES: dict[str, Any] = {
    "embed": None,             # activations' feature dim replicated
    "heads": "model",          # attention head projections -> TP
    "ff": "model",             # FFN hidden -> TP
    "expert": "model",         # MoE experts -> EP (same physical axis)
    "vocab": "model",          # embedding/vocab rows -> TP
    "ssm_ff": "model",         # SSM projections -> TP
    "ssm_heads": "model",      # SSM decode-state heads -> TP
    "kv_seq": "model",         # KV-cache capacity -> sequence-sharded TP
    "data": "data",            # batch -> DP (("pod", "data") with a pod axis)
}


class PartitionSpec(tuple):
    """A logical or physical spec: one entry per array axis, each a name,
    a tuple of names or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


P = PartitionSpec


def tp_serve_rules() -> dict[str, Any]:
    """The tensor-parallel serving table (DESIGN.md §13): heads and the FFN
    hidden dim over "tp", nothing else. The page pool shards over heads
    and its page indices stay host-global: every rank holds the same pages
    of its own heads."""
    return {"heads": "tp", "ff": "tp"}


def sp_serve_rules() -> dict[str, Any]:
    """The ``("sp", "tp")`` serving table (DESIGN.md §14):
    ``tp_serve_rules`` plus "sp_seq", a chunk step's packed query rows,
    over "sp" (each sp rank one contiguous slab). Everything kv-side stays
    replicated over sp: each rank writes the whole chunk's K/V into its
    pool replica."""
    return {**tp_serve_rules(), "sp_seq": "sp"}


def expected_sp_prefill_census(traced_layers: int, *, sp: int = 1,
                               strategy: str = "allgather") -> dict[str, int]:
    """The collectives one sharded chunk step must count (the reference's
    census contract in the port's kinds): per layer the two projection
    all-reduces over "tp" (counted whenever the mesh is active, at tp=1
    too), plus the sp K/V movement, one ``all_gather`` or ``sp - 1``
    ``ring_shift`` calls. The port runs its layers eagerly, so
    ``traced_layers`` is ``num_layers``."""
    census = {"all_reduce": 2 * traced_layers}
    if sp > 1:
        if strategy == "ring":
            census["ring_shift"] = (sp - 1) * traced_layers
        elif strategy == "allgather":
            census["all_gather"] = traced_layers
        else:
            raise ValueError(f"unknown sp strategy {strategy!r}")
    return census


def _axes(mesh) -> Mapping[str, int]:
    return mesh.shape if hasattr(mesh, "shape") else mesh


def rules_for_mesh(mesh, overrides: Mapping[str, Any] | None = None):
    rules = dict(DEFAULT_RULES)
    if "pod" in _axes(mesh):
        rules["data"] = ("pod", "data")
    if overrides:
        rules.update(overrides)
    return rules


def auto_rules(cfg, mesh, *, global_batch: int | None = None,
               overrides: Mapping[str, Any] | None = None):
    """Divisibility-aware rules for one (arch, mesh, shape) cell: a logical
    axis whose dims do not divide the "model" axis is replicated (granite's
    vocab 49155 on 16 shards, hymba's SSM widths), and the batch is
    replicated when it does not divide the data-parallel size."""
    axes = _axes(mesh)
    rules = rules_for_mesh(mesh, overrides)
    m = axes.get("model", 1)

    def divisible(*dims):
        return all(d % m == 0 for d in dims)

    if cfg.vocab_size and not divisible(cfg.vocab_size):
        rules["vocab"] = None
    if cfg.num_experts and not divisible(cfg.num_experts):
        rules["expert"] = None
    if cfg.d_ff and not divisible(cfg.d_ff):
        rules["ff"] = None
    if cfg.num_heads:
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if not divisible(hq * hd, hkv * hd):
            rules["heads"] = None
    if cfg.ssm_state:
        d_inner = cfg.ssm_d_inner
        nheads = cfg.ssm_num_heads
        proj = 2 * d_inner + 2 * cfg.ssm_state + nheads
        conv_ch = d_inner + 2 * cfg.ssm_state
        if not divisible(proj, conv_ch, d_inner):
            rules["ssm_ff"] = None
        if not divisible(nheads):
            rules["ssm_heads"] = None
    if global_batch is not None:
        dp = 1
        for a in ("pod", "data"):
            dp *= axes.get(a, 1)
        if global_batch % dp != 0:
            rules["data"] = None
    if overrides:
        rules.update(overrides)
    return rules


def resolve_spec(logical, rules: Mapping[str, Any]) -> PartitionSpec:
    """A logical spec mapped through the rule table to mesh axes."""
    out = []
    for entry in logical:
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        phys: list[str] = []
        for n in names:
            r = rules.get(n, None)
            if r is None:
                continue
            phys.extend(r if isinstance(r, tuple) else (r,))
        if not phys:
            out.append(None)
        elif len(phys) == 1:
            out.append(phys[0])
        else:
            out.append(tuple(phys))
    return PartitionSpec(*out)


def _walk(path, tree, specs, fn):
    """fn(path, leaf, spec) over a spec tree (dicts and lists of specs)
    and the tree it describes; returns the mapped tree."""
    if isinstance(specs, PartitionSpec):
        return fn(path, tree, specs)
    if isinstance(specs, dict):
        return {k: _walk(f"{path}/{k}", tree[k], specs[k], fn) for k in specs}
    return [_walk(f"{path}[{i}]", tree[i], s, fn) for i, s in enumerate(specs)]


def validate_divisibility(shapes_tree, specs_tree, mesh,
                          rules: Mapping[str, Any] | None = None) -> list[str]:
    """Every place where a sharded dim does not divide by the product of
    its mesh axes, each naming the leaf, its shape, its physical spec and
    the axes with their size (the preflight before any slicing)."""
    axes = _axes(mesh)
    rules = rules or rules_for_mesh(mesh)
    problems: list[str] = []

    def check(path, leaf, spec):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        phys = resolve_spec(spec, rules)
        for i, (dim, entry) in enumerate(zip(shape, phys)):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(axes[a] for a in names)
            if dim % n != 0:
                problems.append(
                    f"{path}: shape {shape} spec {phys} — dim[{i}]={dim} "
                    f"not divisible by mesh axes {names} (size {n})")

    _walk("", shapes_tree, specs_tree, check)
    return problems


def shard_params(params, specs, mesh, rules: Mapping[str, Any]):
    """This rank's slices of a full parameter tree: every dim whose spec
    resolves to mesh axes is cut into that many contiguous pieces and the
    piece at the rank's coordinate kept (a copy, so the full tree can be
    freed); replicated leaves are kept as they are. Raises with the
    preflight's messages where a dim does not divide."""
    problems = validate_divisibility(params, specs, mesh, rules)
    if problems:
        raise ValueError("sharding preflight failed:\n" + "\n".join(problems))
    axes = mesh.shape
    coord = dict(zip(("sp", "tp"), mesh.coord))

    def piece(path, leaf, spec):
        out = leaf
        for i, entry in enumerate(resolve_spec(spec, rules)):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            n, idx = 1, 0
            for a in names:                 # row-major over the axes
                n, idx = n * axes[a], idx * axes[a] + coord[a]
            size = leaf.shape[i] // n
            out = out.narrow(i, idx * size, size)
        return (out if out is leaf
                else out.clone(memory_format=torch.contiguous_format))

    return _walk("", params, specs, piece)
