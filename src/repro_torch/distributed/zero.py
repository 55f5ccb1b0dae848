"""ZeRO-1: the optimizer state sharded over the data axes (port of
``repro.distributed.zero``).

Under tensor parallelism alone, qwen3-32b's AdamW moments (2 x 32 B
parameters in fp32 = 256 GB) are 16 GB a rank at model 16. ZeRO-1 also
cuts each moment tensor's largest still-unsharded dim that divides by the
data-parallel size over ``("pod", "data")``: a rank holds, updates and
keeps only that slice. The train step then reduce-scatters the gradients
onto the slices and all-gathers the updated parameter slices back
(``train.steps.make_sharded_train_step``), the schedule the reference
expresses through shardings alone.

A mesh here is anything with a ``shape`` mapping axis names to sizes, or
such a mapping itself (the specs), and a ``meshes.Mesh`` where pieces are
cut or gathered (``moment_shardings``, ``NamedSharding.shard`` /
``gather``).
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.distributed.meshes import DATA_AXES
from repro_torch.distributed.sharding import (NamedSharding, P, _axes, _walk,
                                              resolve_spec, rules_for_mesh)


def _data_axes(mesh) -> tuple[str, ...]:
    axes = _axes(mesh)
    return tuple(a for a in DATA_AXES if a in axes)


def zero1_moment_spec(shape, param_spec, mesh,
                      rules: Mapping[str, Any]) -> P:
    """Physical spec of one optimizer-moment tensor: the param's physical
    spec plus the data axes on the largest still-unsharded dim that
    divides by the data-parallel size (the first such dim on a tie; none:
    the param's spec)."""
    phys = list(resolve_spec(param_spec, rules))
    phys += [None] * (len(shape) - len(phys))
    data_axes = _data_axes(mesh)
    if not data_axes:
        return P(*phys)
    axes = _axes(mesh)
    dp = 1
    for a in data_axes:
        dp *= axes[a]
    best, best_dim = -1, -1
    for i, (dim, entry) in enumerate(zip(shape, phys)):
        if entry is None and dim % dp == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best >= 0:
        phys[best] = data_axes if len(data_axes) > 1 else data_axes[0]
    return P(*phys)


def zero1_state_specs(param_shapes, param_specs, mesh,
                      rules: Mapping[str, Any] | None = None):
    """Optimizer-state spec tree for ``{"step", "mu", "nu"}`` states;
    ``param_shapes`` is a tree of tensors (or of shapes) the spec tree
    describes."""
    rules = rules or rules_for_mesh(mesh)

    def one(_, leaf, spec):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        return zero1_moment_spec(shape, spec, mesh, rules)

    moments = _walk("", param_shapes, param_specs, one)
    return {"step": P(), "mu": moments, "nu": moments}


def moment_shardings(param_shapes, param_specs, mesh,
                     rules: Mapping[str, Any] | None = None):
    """The moments' ``NamedSharding`` tree on ``mesh`` (a ``meshes.Mesh``):
    ``shard`` cuts a rank's moment slice out of a full moment, ``gather``
    puts the full moment back together."""
    specs = zero1_state_specs(param_shapes, param_specs, mesh, rules)["mu"]
    return _walk("", specs, specs,
                 lambda _, __, spec: NamedSharding(mesh, spec))


def zero1_dim(moment: NamedSharding) -> int | None:
    """The dim of a moment's spec that holds the data axes (the one ZeRO-1
    cut), or None."""
    data_axes = set(_data_axes(moment.mesh))
    for i, entry in enumerate(moment.spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if entry is not None and data_axes & set(names):
            return i
    return None


def param_slice(piece, moment: NamedSharding):
    """The part of a rank's parameter piece (cut by the param's spec) that
    its moment slice covers: a view, narrowed along ``zero1_dim`` to this
    rank's data index (the piece itself where ZeRO-1 cut nothing)."""
    dim = zero1_dim(moment)
    if dim is None:
        return piece
    group = moment.mesh.data
    size = piece.shape[dim] // group.size
    return piece.narrow(dim, group.index * size, size)
