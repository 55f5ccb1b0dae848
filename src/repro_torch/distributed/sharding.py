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
``meshes.ServeMesh`` or ``meshes.Mesh``) or such a mapping itself;
``shard_params`` also needs the rank's coordinate on each axis
(``named_coord``: "sp"/"tp" of a serving mesh, "pod"/"data"/"model" of a
training mesh). ``NamedSharding`` is a leaf's physical spec on a mesh:
``shard`` cuts this rank's piece out of a full array, ``gather`` puts the
full array back together from every rank's (``unshard`` over a tree, for
a mesh-free checkpoint).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

from repro_torch.distributed import comm

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


class Pieces(str):
    """A spec entry for a dim stored by piece (the SSM's head-group layout,
    ``models.ssm.ssm_specs``): the dim is the segments of ``sizes`` in
    order (the reference's layout of the full array); a rank holds its
    contiguous part of each segment marked ``cut`` and every other segment
    whole, in the same order. The entry is the axis name itself (a str:
    the logical spec equals the reference's, and the rule table maps it as
    it maps the name); ``resolve_spec`` carries the segments over to the
    physical axis. A whole segment is held on every rank of the axis, so
    its gradient must be whole there too (the model sums each rank's part,
    ``comm.copy_parts_to_group``)."""

    sizes: tuple[int, ...]
    cut: tuple[bool, ...]

    def __new__(cls, axis: str, sizes, cut):
        if len(sizes) != len(cut):
            raise ValueError(f"{len(sizes)} segments, {len(cut)} cut flags")
        obj = super().__new__(cls, axis)
        obj.sizes, obj.cut = tuple(sizes), tuple(cut)
        return obj

    def __reduce__(self):
        return Pieces, (str(self), self.sizes, self.cut)

    def __repr__(self) -> str:
        segs = ", ".join(f"{n}{'' if c else ' whole'}"
                         for n, c in zip(self.sizes, self.cut))
        return f"{str(self)!r}[{segs}]"

    def local_sizes(self, n: int) -> tuple[int, ...]:
        """The segments' sizes on a rank of an axis of ``n`` ranks."""
        return tuple(s // n if c else s for s, c in zip(self.sizes, self.cut))


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


def heads_cut_whole(cfg, m: int) -> bool:
    """Whether ``m`` "model" ranks cut the attention into whole q heads,
    each rank holding its q heads' kv head (the kv heads cut whole, or
    one kv head shared by ``m / hkv`` ranks)."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    return hq % m == 0 and (hkv % m == 0 or m % hkv == 0)


def train_rules(cfg, shape: Mapping[str, int],
                rules: Mapping[str, Any]) -> dict[str, Any]:
    """The rules a sharded train step runs: ``rules`` with "heads" demoted
    to replicated where the "model" axis would cut the heads into pieces
    that are not whole q heads with their kv head (published hymba-1.5b's
    25 q / 5 kv heads of 64 at model 2 or 4, which the reference cuts as
    columns of its projections), as ``auto_rules`` demotes every axis
    that does not divide. The attention then runs whole on every rank
    beside the cut SSM and MLP."""
    out = dict(rules)
    m = shape.get("model", 1)
    if (m > 1 and cfg.num_heads and out.get("heads") == "model"
            and not heads_cut_whole(cfg, m)):
        out["heads"] = None
    return out


def train_cuts(cfg, shape: Mapping[str, int],
               rules: Mapping[str, Any]) -> dict[str, bool]:
    """What a sharded train step cuts over a "model" axis of more than one
    rank: the attention heads, a dense MLP's hidden dim (``ff``), the
    vocab, the MoE's experts and the SSM by head group (``ssm``), each
    where the rules put its logical axis on "model" and the config has
    it (the heads only where they cut whole: ``train_rules``)."""
    m = shape.get("model", 1)

    def cut(axis):
        return m > 1 and rules.get(axis) == "model"

    return {"heads": (cut("heads") and cfg.num_heads > 0
                      and heads_cut_whole(cfg, m)),
            "ff": cut("ff") and cfg.family != "moe" and cfg.d_ff > 0,
            "vocab": cut("vocab"),
            "experts": cut("expert") and cfg.family == "moe",
            "ssm": cut("ssm_ff") and cfg.ssm_state > 0}


def _block_census(cfg, cuts, m: int, D: int, *, encoder: bool):
    """(forward collectives, backward collectives, the forward's tail) of
    one block of a rank's training model: kind -> count, the tail being
    what the block's forward runs after its last saved tensor (which
    ``torch.utils.checkpoint``'s early stop does not run again)."""
    fwd: dict[str, int] = {}
    bwd: dict[str, int] = {}
    tail: dict[str, int] = {}

    def add(tree, kind, n):
        if n:
            tree[kind] = tree.get(kind, 0) + n

    kv_split = cuts["heads"] and cfg.num_kv_heads % m != 0
    attn = cfg.family != "ssm" or encoder
    ssm = not encoder and (cfg.family == "ssm" or cfg.hybrid)
    cross = not encoder and cfg.num_encoder_layers > 0
    ffn = ("moe" if cfg.family == "moe" and not encoder
           else "mlp" if cfg.d_ff > 0 else None)
    for on, inputs in ((attn, 1), (cross, 2)):
        if on and cuts["heads"]:
            # the input copies (a cross-attention's decoder and encoder
            # streams), wo's sum, the qk-norm scales' copies, a cut kv
            # head's gathers
            add(fwd, "all_reduce", 1)
            add(fwd, "all_gather", 2 * kv_split)
            add(bwd, "all_reduce", inputs + 2 * cfg.qk_norm)
            add(bwd, "reduce_scatter", 2 * kv_split)
    if ssm and cuts["ssm"]:
        # the gated norm's sum of squares (both ways), out_proj's sum; the
        # input copy and the whole pieces' copy backward
        add(fwd, "all_reduce", 2)
        add(bwd, "all_reduce", 3)
        if ffn is None:
            add(tail, "all_reduce", 1)
    if ffn == "moe":
        add(fwd, "all_reduce", D > 1)        # the routing fractions
        if cuts["experts"]:
            # y's sum; the copies of the input and the routing weights
            add(fwd, "all_reduce", 1)
            add(bwd, "all_reduce", 2)
            add(tail, "all_reduce", 1)
    elif ffn == "mlp" and cuts["ff"]:
        add(fwd, "all_reduce", 1)
        add(bwd, "all_reduce", 1)
        add(tail, "all_reduce", 1)
    return fwd, bwd, tail


def expected_train_census(cfg, shape: Mapping[str, int],
                          rules: Mapping[str, Any], *, zero1: bool,
                          cut_leaves: bool = True, whole_leaves: bool = False,
                          grad_accum: int = 1, stacked: bool = False
                          ) -> dict[str, int]:
    """The collectives one sharded train step must count on every rank
    (the port's census contract for ``make_sharded_train_step``), from
    the config, the mesh shape and the rules. ``cut_leaves`` /
    ``whole_leaves``: some moment leaf is / is not cut by ZeRO-1;
    ``stacked``: the optimizer sums trust ratios (LAMB).

    Per microbatch, each block (an encoder's too) at a "model" axis m > 1
    (``train_cuts``): an attention with its heads cut one ``all_reduce``
    forward (``wo``) and one backward a stream it reads (the input; a
    cross-attention's encoder stream too), two more backward with
    qk-norm (the scales), and where a kv head is cut two ``all_gather``
    forward and two ``reduce_scatter`` backward; an MLP with its FFN cut
    one ``all_reduce`` each way; an MoE with its experts cut one forward
    (the combine's sum) and two backward (the input and the routing
    weights); an SSM cut by head group two forward (the gated norm's sum
    of squares, ``out_proj``) and three backward (the sum of squares, the
    input, the whole pieces). A cut vocab adds one ``all_reduce`` for the
    embedding, one backward for the logits' input, an ``all_reduce_max``
    and two ``all_reduce`` for the softmax. With ``cfg.remat`` the
    backward recomputes each block's forward up to the last tensor it
    saves (``torch.utils.checkpoint``'s early stop): every forward
    collective runs again except the block's tail, the sum of its FFN's
    output (an MLP's ``w_down``, the MoE's combine) or, in a block with
    no FFN, of its SSM's ``out_proj`` (their outputs only join the
    residual stream). At a data size D > 1: one ``all_reduce`` of the
    token count and one for each MoE block's routing fractions. Per
    step: at D > 1 one ``all_reduce`` of the metrics, the gradients' sum
    (one ``all_reduce``, or under ZeRO-1 a ``reduce_scatter`` onto the
    cut leaves and an ``all_reduce`` of the whole ones) and the
    ``all_gather`` of the updated slices; over a mesh of more than one
    rank one ``all_reduce`` for the global norm and, for LAMB, one for
    its sums."""
    census: dict[str, int] = {}

    def add(kind, n):
        if n:
            census[kind] = census.get(kind, 0) + n

    D = math.prod(shape.get(a, 1) for a in ("pod", "data"))
    world = math.prod(shape.values())
    cuts = train_cuts(cfg, shape, rules)
    for encoder, layers in ((False, cfg.num_layers),
                            (True, cfg.num_encoder_layers)):
        fwd, bwd, tail = _block_census(cfg, cuts, shape.get("model", 1), D,
                                       encoder=encoder)
        for kind in set(fwd) | set(bwd):
            again = (fwd.get(kind, 0) - tail.get(kind, 0)) * cfg.remat
            add(kind, grad_accum * layers * (fwd.get(kind, 0) + again
                                             + bwd.get(kind, 0)))
    vocab = cuts["vocab"]
    add("all_reduce", grad_accum * (4 * vocab + (D > 1)))
    add("all_reduce_max", grad_accum * vocab)
    if D > 1:
        add("all_reduce", 1 + (whole_leaves or not zero1))
        if zero1 and cut_leaves:
            add("reduce_scatter", 1)
            add("all_gather", 1)
    add("all_reduce", (world > 1) * (1 + stacked))
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
        elif isinstance(entry, Pieces):
            if len(phys) != 1:
                raise ValueError(f"a dim stored by piece is cut over one "
                                 f"mesh axis; {entry!r} resolves to {phys}")
            out.append(Pieces(phys[0], entry.sizes, entry.cut))
        elif len(phys) == 1:
            out.append(phys[0])
        else:
            out.append(tuple(phys))
    return PartitionSpec(*out)


def local_shape(shape, spec: PartitionSpec,
                axes: Mapping[str, int]) -> tuple[int, ...]:
    """A rank's piece of a leaf of ``shape`` under a physical spec on a
    mesh of ``axes`` (the reference's ``NamedSharding.shard_shape``): a
    cut dim divided by the product of its axes, a ``Pieces`` dim its cut
    segments divided and its whole ones kept. No mesh or device needed
    (the dry-run)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        n = math.prod(axes[a] for a in _names(entry))
        if isinstance(entry, Pieces):
            out[i] = sum(entry.local_sizes(n))
        else:
            out[i] = shape[i] // n
    return tuple(out)


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
            if isinstance(entry, Pieces):
                bad = [s for s, c in zip(entry.sizes, entry.cut)
                       if c and s % n]
                if sum(entry.sizes) != dim or bad:
                    problems.append(
                        f"{path}: shape {shape} spec {phys} — dim[{i}]={dim}"
                        f" stored by piece: its cut segments do not divide "
                        f"by mesh axes {names} (size {n})")
                continue
            if dim % n != 0:
                problems.append(
                    f"{path}: shape {shape} spec {phys} — dim[{i}]={dim} "
                    f"not divisible by mesh axes {names} (size {n})")

    _walk("", shapes_tree, specs_tree, check)
    return problems


def _names(entry) -> tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf laid out on a mesh by a physical spec (the reference's
    ``NamedSharding``): every dim whose entry names mesh axes is cut into
    that many contiguous pieces, indexed row-major over the axes, and a
    rank holds the piece at its coordinate; a dim whose entry is a
    ``Pieces`` is cut segment by segment (its whole segments kept).
    ``mesh`` is a ``meshes.Mesh`` (or, to ``shard`` only, a
    ``ServeMesh``)."""
    mesh: Any
    spec: PartitionSpec

    def _cuts(self):
        """(dim, entry, pieces, this rank's piece) of every sharded dim."""
        axes = self.mesh.shape
        coord = (self.mesh.named_coord if hasattr(self.mesh, "named_coord")
                 else dict(zip(axes, self.mesh.coord)))
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            n, idx = 1, 0
            for a in _names(entry):
                n, idx = n * axes[a], idx * axes[a] + coord[a]
            yield i, entry, n, idx

    @property
    def axes(self) -> set[str]:
        """The mesh axes the leaf is cut over."""
        return {a for e in self.spec if e is not None for a in _names(e)}

    def replicas(self) -> int:
        """How many ranks hold each piece: the product of the mesh axes the
        leaf is not cut over (a ``Pieces`` dim's whole segments are held
        on that many times its axis's ranks: ``share``)."""
        return math.prod(n for a, n in self.mesh.shape.items()
                         if a not in self.axes)

    def share(self, ndim: int):
        """Each element's share of a sum over every rank's piece that
        counts each element of the full array once: 1 / the ranks holding
        it. A float, or where a ``Pieces`` dim holds whole segments a
        tensor broadcasting along that dim of a piece of ``ndim`` dims (the
        leaf's own; a leading layer axis in front broadcasts too)."""
        out = 1.0 / self.replicas()
        for i, entry, n, _ in self._cuts():
            if isinstance(entry, Pieces) and not all(entry.cut):
                w = torch.cat([torch.full((size,), 1.0 if c else 1.0 / n)
                               for size, c in zip(entry.local_sizes(n),
                                                  entry.cut)])
                shape = [1] * ndim
                shape[i] = -1
                out = out * w.view(shape)
        return out

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a full array (a contiguous copy, so that the
        full array can be freed; a leaf cut over no axis as it is)."""
        out = full
        for i, entry, n, idx in self._cuts():
            if isinstance(entry, Pieces):
                segs = out.split(list(entry.sizes), dim=i)
                out = torch.cat([
                    seg.narrow(i, idx * (size // n), size // n) if c else seg
                    for seg, size, c in zip(segs, entry.sizes, entry.cut)],
                    dim=i)
                continue
            if full.shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(full.shape)} does not "
                                 f"divide into {n} pieces ({self.spec})")
            size = full.shape[i] // n
            out = out.narrow(i, idx * size, size)
        return (out if out is full
                else out.clone(memory_format=torch.contiguous_format))

    def gather(self, piece: torch.Tensor) -> torch.Tensor:
        """The full array from every rank's piece (one ``all_gather`` a
        sharded dim, over the group of its axes; a ``Pieces`` dim gathers
        its cut segments in one call and keeps its whole ones)."""
        out = piece
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            group = self.mesh.group(_names(entry))
            if not isinstance(entry, Pieces):
                out = comm.all_gather(out, group, i)
                continue
            n = group.size
            local = entry.local_sizes(n)
            segs = out.split(list(local), dim=i)
            cut = [seg for seg, c in zip(segs, entry.cut) if c]
            if not cut:
                continue
            every = comm.all_gather(torch.cat(cut, dim=i), group, i)
            ranks = every.chunk(n, dim=i)
            sizes = [size for size, c in zip(local, entry.cut) if c]
            parts = [r.split(sizes, dim=i) for r in ranks]
            full, k = [], 0
            for seg, c in zip(segs, entry.cut):
                if c:
                    full.append(torch.cat([p[k] for p in parts], dim=i))
                    k += 1
                else:
                    full.append(seg)
            out = torch.cat(full, dim=i)
        return out


@dataclasses.dataclass(frozen=True)
class TrainShard:
    """What one rank's training model reads of its mesh (the sharded train
    step builds it, ``train.steps.make_sharded_train_step``): the "model"
    group and what is cut over it, at a "model" axis of more than one rank
    (``heads``, ``ff``, ``vocab``, ``experts``: those the rules put on
    "model"; ``ssm``: the SSM by head group, where the rules keep
    "ssm_ff"), the global head, vocab, expert and SSM head counts, the
    data group and whether the batch rows are cut over it (a replicated
    batch is the same rows on every data rank)."""
    model: Any
    data: Any
    heads: bool
    ff: bool
    vocab: bool
    num_heads: int
    num_kv_heads: int
    vocab_size: int
    batch_sharded: bool
    experts: bool = False
    num_experts: int = 0
    ssm: bool = False
    ssm_num_heads: int = 0

    @property
    def kv_split(self) -> bool:
        """A kv head is cut across ranks (fewer kv heads than "model"
        ranks): each rank's K/V columns are gathered and its q heads' kv
        head taken whole."""
        return self.heads and self.num_kv_heads % self.model.size != 0

    @property
    def head_offset(self) -> int:
        """This rank's first q head in the global count."""
        return (self.model.index * (self.num_heads // self.model.size)
                if self.heads else 0)

    @property
    def expert_range(self) -> tuple[int, int]:
        """This rank's experts [first, last) of the global count: its
        contiguous part, the reference's "expert" cut (all of them where
        the experts are not cut)."""
        if not self.experts:
            return 0, self.num_experts
        n = self.num_experts // self.model.size
        return self.model.index * n, (self.model.index + 1) * n

    @property
    def ssm_head_range(self) -> tuple[int, int]:
        """This rank's SSM heads [first, last) (all of them where the SSM
        is not cut)."""
        if not self.ssm:
            return 0, self.ssm_num_heads
        n = self.ssm_num_heads // self.model.size
        return self.model.index * n, (self.model.index + 1) * n

    def batch_offset(self, rows: int) -> int:
        """This rank's first row of a global batch of which it holds
        ``rows``."""
        return self.data.index * rows if self.batch_sharded else 0


@dataclasses.dataclass(frozen=True)
class DecodeShard(TrainShard):
    """What one rank of a sequence-sharded decode reads of its mesh
    (``train.steps.make_sharded_serve_steps`` builds it): the params'
    cuts of a ``TrainShard`` (``heads``: the q/k/v columns and ``wo``'s
    rows, which need not be whole heads, since every rank gathers every
    head of the new token), ``kv_seq``: the KV capacity, or the page
    pool's pages, cut over "model"; ``batch_sharded``: the decode lanes
    cut over the data axes; ``world``: the whole mesh's group."""
    world: Any = None
    kv_seq: bool = False

    @property
    def kv_rank(self) -> tuple[int, int]:
        """(ranks the KV capacity is cut over, this rank's piece)."""
        if not self.kv_seq:
            return 1, 0
        return self.model.size, self.model.index


def decode_cuts(cfg, shape: Mapping[str, int],
                rules: Mapping[str, Any]) -> dict[str, bool]:
    """What a sequence-sharded decode rank cuts over a "model" axis of
    more than one rank (the params' cuts of ``train_cuts``, with the
    heads cut wherever the rules put them on "model": the decode gathers
    the token's columns, so they need not be whole heads), ``kv_seq``
    (the capacity or pages) and ``lanes`` (the decode lanes over the
    data axes)."""
    m = shape.get("model", 1)
    d = math.prod(shape.get(a, 1) for a in ("pod", "data"))

    def cut(axis):
        return m > 1 and rules.get(axis) == "model"

    cuts = dict(train_cuts(cfg, shape, rules))
    cuts["heads"] = cut("heads") and cfg.num_heads > 0
    cuts["kv_seq"] = cut("kv_seq")
    cuts["lanes"] = d > 1 and rules.get("data") is not None
    return cuts


def expected_kv_seq_decode_census(cfg, m: int, *, data: int = 1,
                                  paged: bool = False, rules=None
                                  ) -> dict[str, int]:
    """The collectives one decode step of ``make_sharded_serve_steps`` must
    count on every rank of a ``("data", "model")`` mesh of ``data`` x
    ``m`` ranks with its state sharded by the decode specs, from the
    config and the rules (default ``rules_for_mesh``). Per attention
    layer: one ``all_gather`` of the new token's q/k/v columns where the
    heads are cut (over "model"; for a pool that every data rank holds,
    of every data rank's lanes too, over the whole mesh), one of the
    fp32 split partials where the capacity is cut, and one
    ``all_reduce`` of ``wo``'s rows where the heads are cut; a decoder
    block's cross-attention the same but for the token's K/V. An SSM cut
    by head group two ``all_reduce`` (the gated norm's sum of squares,
    ``out_proj``), an MLP with its hidden dim cut or an MoE with its
    experts cut one. Per step: a cut vocab one ``all_reduce`` (the
    embedding) and one ``all_gather`` (the logits); a pool shared by
    the data ranks one ``all_gather`` of their page tables and
    lengths."""
    shape = {"data": data, "model": m}
    rules = rules or rules_for_mesh(shape)
    cuts = decode_cuts(cfg, shape, rules)
    census: dict[str, int] = {}

    def add(kind, n):
        if n:
            census[kind] = census.get(kind, 0) + n

    shared = paged and cuts["lanes"]
    L = cfg.num_layers
    if cfg.family != "ssm":
        add("all_gather", L * ((cuts["heads"] or shared) + cuts["kv_seq"]))
        add("all_reduce", L * cuts["heads"])
    if cfg.num_encoder_layers > 0:
        # a decoder block's cross-attention: the token's q columns and the
        # partials over the rank's encoder rows
        add("all_gather", L * (cuts["heads"] + cuts["kv_seq"]))
        add("all_reduce", L * cuts["heads"])
    if (cfg.family == "ssm" or cfg.hybrid) and cuts["ssm"]:
        add("all_reduce", 2 * L)
    if cfg.family == "moe":
        add("all_reduce", L * cuts["experts"])
    elif cfg.d_ff > 0:
        add("all_reduce", L * cuts["ff"])
    add("all_reduce", cuts["vocab"])
    add("all_gather", cuts["vocab"] + shared)
    return census


def resolve_tree(specs, mesh, rules: Mapping[str, Any]):
    """The logical spec tree resolved on the mesh: a tree of
    ``NamedSharding`` (the reference's ``resolve_tree``)."""
    return _walk("", specs, specs,
                 lambda _, __, spec: NamedSharding(mesh,
                                                   resolve_spec(spec, rules)))


def shard_params(params, specs, mesh, rules: Mapping[str, Any]):
    """This rank's slices of a full parameter tree, or of a full decode
    state (``Model.decode_state_specs`` / ``paged_decode_state_specs``:
    "data" cuts the lanes, "kv_seq" the capacity or the pool's pages,
    "ssm_heads" / "ssm_ff" the SSM state by head group): every dim whose
    spec resolves to mesh axes is cut into that many contiguous pieces
    (a ``Pieces`` dim segment by segment) and the piece at the rank's
    coordinate kept (a copy, so the full tree can be freed); replicated
    leaves are kept as they are. Raises with the preflight's messages,
    each naming its leaf, where a dim does not divide."""
    problems = validate_divisibility(params, specs, mesh, rules)
    if problems:
        raise ValueError("sharding preflight failed:\n" + "\n".join(problems))
    return _walk("", params, specs, lambda _, leaf, spec: NamedSharding(
        mesh, resolve_spec(spec, rules)).shard(leaf))


def _pairs(tree, shardings, fn):
    """fn(leaf, sharding) over a tree and its tree of shardings."""
    if isinstance(shardings, dict):
        return {k: _pairs(tree[k], shardings[k], fn) for k in shardings}
    if isinstance(shardings, list):
        return [_pairs(t, sh, fn) for t, sh in zip(tree, shardings)]
    return fn(tree, shardings)


def shard_tree(tree, shardings):
    """This rank's pieces of a tree of full arrays (``NamedSharding.shard``
    leaf by leaf); the elastic restore's re-slicing."""
    return _pairs(tree, shardings, lambda t, sh: sh.shard(t))


def unshard(tree, shardings):
    """The full arrays of a tree of this rank's pieces (``NamedSharding.
    gather`` leaf by leaf: a collective every rank of the mesh must run in
    the same order)."""
    return _pairs(tree, shardings, lambda t, sh: sh.gather(t))
