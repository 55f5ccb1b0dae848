"""Grouped-query self-attention layer on the flash core (port of the dense
parts of ``repro.models.attention_layer``), with optional qk-norm (an RMS
normalization of every q and k head before RoPE, scaled by ``q_norm`` /
``k_norm``) and a head_dim decoupled from d_model (``wq`` is
(d_model, hq * head_dim)).

Five execution modes: full-sequence training (``apply_attention``, with
segment-relative RoPE and attention dropout; or cross-attention over an
encoder's output, with its prefill in ``cross_prefill_attention`` and
its decode in ``cross_decode_attention_step``), packed prefill
(``prefill_attention``, optionally writing a fixed-capacity slot cache),
chunked prefill against the shared page pool
(``chunk_prefill_attention_step``), single-token decode against the slot
cache (``decode_attention_step``) and against the pool
(``paged_decode_attention_step``).

Under tensor parallelism (a ``ServeMesh`` passed as ``mesh``; DESIGN.md
§13) the config holds one rank's heads, and ``_tp_reduce`` sums the
output projection's partial result over the tp group: the one collective
the layer needs, since each q-head group lives with its kv head. Under
sequence parallelism (§14) the chunk step's q rows are one rank's slab,
and ``_sp_gather_kv`` assembles the whole chunk's K/V before the pool
write. A mesh of None runs neither.

Tensor-parallel TRAINING (a ``distributed.sharding.TrainShard`` passed as
``shard`` to ``apply_attention``, with heads cut over its "model" group)
puts Megatron's pair around the layer: ``comm.copy_to_group`` on the
input (each rank's q/k/v columns give a partial input gradient, summed in
the backward; a cross-attention's encoder stream too) and on the
replicated qk-norm scales, and
``comm.reduce_from_group`` on the output projection (a sum forward, the
identity backward). Where a kv head is cut across ranks (fewer kv heads
than ranks), each rank's K/V columns are gathered
(``comm.gather_from_group``) and its q heads' kv head taken whole. The
dropout hash then reads the global (batch row, head, head count).

The JAX step functions return a new cache and rely on jit buffer donation
to update it in place; here the cache and pool tensors are updated IN
PLACE and the same dict is returned. JAX's ``mode="drop"`` scatters (out-of-range page
index = write dropped) become explicit masks: rows whose destination is
out of range are removed before the write, so they can never land in —
and corrupt — a live page.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (AttentionSpec, attention,
                                        decode_attention,
                                        paged_decode_attention,
                                        paged_prefill_attention)
from repro_torch.core.masks import segment_relative_positions
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import P
from repro_torch.kernels.flash_decode import (_merge_split_partials,
                                             flash_decode_paged_slice,
                                             flash_decode_slice)
from repro_torch.models.layers import apply_rope, dense_init, rms_normalize


def attn_spec_from_config(cfg: ModelConfig) -> AttentionSpec:
    return AttentionSpec(impl=cfg.attn_impl, causal=cfg.causal,
                         window=cfg.window, dropout_p=cfg.attn_dropout,
                         block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
                         chunk_size=cfg.attn_chunk_size,
                         pv_bf16=cfg.attn_pv_bf16,
                         banded_window=cfg.banded_window,
                         num_decode_splits=cfg.num_decode_splits,
                         use_decode_kernel=cfg.use_decode_kernel,
                         tp_shards=cfg.tp_shards)


def _tp_reduce(y, cfg: ModelConfig, mesh):
    """The output projection's partial result summed over the mesh's tp
    group, in y's dtype (each rank's ``_merge_heads(o) @ wo`` covers only
    its own heads' rows of ``wo``). Counted at tp=1 too, as the
    reference's ``psum`` over an axis of one. No mesh: y."""
    if mesh is None:
        return y
    return comm.all_reduce_sum(y, mesh.tp_group)


def _sp_gather_kv(k, v, cfg: ModelConfig, mesh):
    """The whole chunk's K/V on every sp rank (DESIGN.md §14): each rank
    projected only its slab of the packed q rows, and the pool is
    replicated over sp, so every rank must write every chunk row. By
    ``cfg.sp_strategy``:

      * ``"allgather"`` — one ``all_gather`` a layer over the stacked
        (k, v), in slab order;
      * ``"ring"`` — ``sp - 1`` ring shifts, each arriving slab placed at
        its sender's slot.

    Both move bits only, so every sp rank holds the same K/V and the pool
    replicas stay equal. No mesh, or sp of one: (k, v)."""
    if mesh is None or mesh.sp == 1:
        return k, v
    kv = torch.stack([k, v])                     # (2, 1, hkv, slab, hd)
    group, n = mesh.sp_group, mesh.sp
    if cfg.sp_strategy == "allgather":
        full = comm.all_gather(kv, group, dim=3)
    elif cfg.sp_strategy == "ring":
        slab = kv.shape[3]
        full = kv.new_zeros(kv.shape[:3] + (slab * n,) + kv.shape[4:])
        src, cur = group.index, kv
        for step in range(n):
            full[:, :, :, src * slab:(src + 1) * slab] = cur
            if step < n - 1:
                cur = comm.ring_shift(cur, group)
                src = (src - 1) % n          # it came from the left
    else:
        raise ValueError(f"unknown sp_strategy {cfg.sp_strategy!r}")
    return full[0], full[1]


def attention_specs(cfg: ModelConfig):
    """Logical axes of the layer's params (the reference's)."""
    s = {"wq": P("embed", "heads"), "wk": P("embed", "heads"),
         "wv": P("embed", "heads"), "wo": P("heads", "embed")}
    if cfg.qk_norm:
        s["q_norm"] = P(None)
        s["k_norm"] = P(None)
    return s


def init_attention(cfg: ModelConfig, dtype, *, generator, device):
    hq, hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(generator=generator, device=device)
    p = {"wq": dense_init(d, hq * hd, dtype, **kw),
         "wk": dense_init(d, hkv * hd, dtype, **kw),
         "wv": dense_init(d, hkv * hd, dtype, **kw),
         "wo": dense_init(hq * hd, d, dtype, **kw)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _whole_kv_head(cols, shard, hd: int):
    """A rank's K or V columns (b, s, hkv * hd / m) of a kv head cut across
    the "model" ranks -> the whole kv head its q heads read (b, s, hd)."""
    full = comm.gather_from_group(cols, shard.model, -1)
    head = shard.model.index // (shard.model.size // shard.num_kv_heads)
    return full[..., head * hd:(head + 1) * hd]


def _project_qkv(params, cfg: ModelConfig, x, kv_x, positions, kv_positions,
                 shard=None):
    """q, k, v heads (b, h, s, hd), qk-normed and rotated; ``shard``: the
    rank's heads of a tensor-parallel training step."""
    hd = cfg.head_dim
    q = x @ params["wq"]
    k, v = kv_x @ params["wk"], kv_x @ params["wv"]
    if shard is not None and shard.kv_split:
        k, v = _whole_kv_head(k, shard, hd), _whole_kv_head(v, shard, hd)
    return _qkv_heads(params, cfg, q, k, v, positions, kv_positions, shard)


def _qkv_heads(params, cfg: ModelConfig, q, k, v, positions, kv_positions,
               shard=None):
    """Projected columns (b, s, h * hd) -> heads (b, h, s, hd), qk-normed
    and rotated (RoPE where positions are given)."""
    hd = cfg.head_dim
    q = _split_heads(q, q.shape[-1] // hd, hd)
    k = _split_heads(k, k.shape[-1] // hd, hd)
    v = _split_heads(v, v.shape[-1] // hd, hd)
    if cfg.qk_norm:
        qn, kn = params["q_norm"], params["k_norm"]
        if shard is not None:
            qn = comm.copy_to_group(qn, shard.model)
            kn = comm.copy_to_group(kn, shard.model)
        q = rms_normalize(q) * qn
        k = rms_normalize(k) * kn
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    if kv_positions is not None:
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def apply_attention(params, cfg: ModelConfig, x, *,
                    spec: AttentionSpec | None = None, kv_x=None,
                    positions=None, kv_mask=None, segment_ids=None,
                    block_layout=None, deterministic: bool = True,
                    dropout_seed=0, mesh=None, shard=None, batch_offset=0):
    """Full-sequence attention, x: (b, s, d_model) -> (b, s, d_model).
    Self-attention by default: ``segment_ids`` isolates packed documents
    AND makes RoPE segment-relative (positions restart at every document
    boundary), so packed training is position-identical to per-document
    training. Given ``kv_x`` (b, s_kv, d_model), cross-attention: keys and
    values from ``kv_x``, no RoPE on q or k (decoder queries and encoder
    keys live in different position spaces), never causal and never
    windowed, and ``segment_ids`` ignored (the encoder stream is one), as
    in the JAX package. ``block_layout`` is an Alg. 5 sparse pattern
    (``impl`` ``pallas`` or ``block_sparse``). ``shard`` (a ``TrainShard``)
    runs the rank's part of a sharded training step, whose batch rows
    start at ``batch_offset`` of the global batch (module docstring)."""
    cross = kv_x is not None
    if positions is None and not cross:
        positions = (segment_relative_positions(segment_ids)
                     if segment_ids is not None
                     else torch.arange(x.shape[1], device=x.device))
    rope = None if cross else positions
    tp = shard is not None and shard.heads
    if tp:
        x = comm.copy_to_group(x, shard.model)
        if cross:
            kv_x = comm.copy_to_group(kv_x, shard.model)
    q, k, v = _project_qkv(params, cfg, x, kv_x if cross else x, rope, rope,
                           shard if tp else None)
    spec = spec or attn_spec_from_config(cfg)
    if cross:
        spec = dataclasses.replace(spec, causal=False, window=None)
    coords = None
    if shard is not None:
        coords = (batch_offset, shard.head_offset, shard.num_heads)
    o = attention(q, k, v, spec, kv_mask=kv_mask,
                  segment_ids=None if cross else segment_ids,
                  block_layout=block_layout, deterministic=deterministic,
                  dropout_seed=dropout_seed, dropout_coords=coords)
    out = _merge_heads(o) @ params["wo"]
    if tp:
        return comm.reduce_from_group(out, shard.model)
    return _tp_reduce(out, cfg, mesh)


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                  device):
    """One layer's fixed-capacity slot cache, (batch, hkv, capacity, hd)
    per K/V leaf."""
    shape = (batch, cfg.num_kv_heads, capacity, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_specs():
    """Logical specs of one layer's slot cache (the reference's): lanes
    over "data", the capacity over "kv_seq" (the sequence-sharded decode
    cuts it over "model"; the kv heads stay whole)."""
    return {"k": P("data", None, "kv_seq", None),
            "v": P("data", None, "kv_seq", None)}


def init_paged_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                        dtype, device):
    """One layer's page pool, (hkv, num_pages, page_size, hd) per K/V
    leaf: no lane axis, any lane's page table may point anywhere in it."""
    shape = (cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_kv_cache_specs():
    """Logical specs of one layer's page pool (the reference's): the pages
    over "kv_seq", as the slot cache's capacity."""
    return {"k": P(None, "kv_seq", None, None),
            "v": P(None, "kv_seq", None, None)}


def prefill_attention(params, cfg: ModelConfig, x, cache=None, *,
                      kv_mask=None, segment_ids=None, positions=None,
                      spec: AttentionSpec | None = None, mesh=None):
    """Full-sequence self-attention that also returns its K/V rows: written
    in place into ``cache`` at [0, s) when one is given (the slot cache of
    ``init_kv_cache``), else as ``{"k", "v"}`` of shape (b, hkv, s, hd) (the
    JAX cache at capacity s). Packed prefill passes ``segment_ids``: RoPE
    restarts per segment, so each request's K/V rows equal a batch-1
    prefill of it."""
    sq = x.shape[1]
    if positions is None:
        positions = (segment_relative_positions(segment_ids)
                     if segment_ids is not None
                     else torch.arange(sq, device=x.device))
    q, k, v = _project_qkv(params, cfg, x, x, positions, positions)
    spec = spec or attn_spec_from_config(cfg)
    o = attention(q, k, v, spec, kv_mask=kv_mask, segment_ids=segment_ids)
    if cache is None:
        cache = {"k": k, "v": v}
    else:
        cache["k"][:, :, :sq] = k.to(cache["k"].dtype)
        cache["v"][:, :, :sq] = v.to(cache["v"].dtype)
    return _tp_reduce(_merge_heads(o) @ params["wo"], cfg, mesh), cache


def decode_attention_step(params, cfg: ModelConfig, x, cache, kv_len,
                          *, spec: AttentionSpec | None = None, mesh=None):
    """Single-token decode against the slot cache. x: (b, 1, d_model);
    cache leaves (b, hkv, capacity, hd); kv_len (b,) current lengths.
    Writes the new K/V at each sequence's ``kv_len`` in place (clamped to
    the last slot, as JAX's ``dynamic_update_slice`` clamps), then attends
    over [0, kv_len]. RoPE positions are ``kv_len``. Returns (out, cache)."""
    positions = kv_len[:, None]
    q, k, v = _project_qkv(params, cfg, x, x, positions, positions)
    capacity = cache["k"].shape[2]
    rows = torch.arange(x.shape[0], device=x.device)
    pos = torch.clamp(kv_len, max=capacity - 1).long()
    cache["k"][rows, :, pos] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][rows, :, pos] = v[:, :, 0].to(cache["v"].dtype)
    spec = spec or attn_spec_from_config(cfg)
    o = decode_attention(q, cache["k"], cache["v"], kv_len + 1, spec)
    return _tp_reduce(_merge_heads(o) @ params["wo"], cfg, mesh), cache


def cross_prefill_attention(params, cfg: ModelConfig, x, enc_out,
                            capacity: int):
    """``apply_attention(kv_x=enc_out)`` (cross-attention: no RoPE, never
    causal or windowed) that also returns the encoder's K/V for decode,
    projected once: (b, hkv, capacity, hd) each, rows [0, s_enc) from
    ``enc_out`` (b, s_enc, d_model) and zeros past them (``capacity`` >=
    s_enc pads the cache to the decode kernel's tile; the decode masks the
    padding through ``kv_len = s_enc``). Returns (out, cache)."""
    b, s_enc, _ = enc_out.shape
    q, k, v = _project_qkv(params, cfg, x, enc_out, None, None)
    spec = dataclasses.replace(attn_spec_from_config(cfg), causal=False,
                               window=None)
    o = attention(q, k, v, spec)
    cache = init_kv_cache(cfg, b, capacity, enc_out.dtype, enc_out.device)
    cache["k"][:, :, :s_enc] = k
    cache["v"][:, :, :s_enc] = v
    return _merge_heads(o) @ params["wo"], cache


def cross_decode_attention_step(params, cfg: ModelConfig, x, cache,
                                enc_len, *, spec: AttentionSpec | None = None):
    """One decoder token's cross-attention over the encoder's cached K/V
    (``cross_prefill_attention``; read only). x: (b, 1, d_model);
    ``enc_len`` (b,) the encoder rows, the rest of the cache padding. No
    RoPE on q and no window, as in the full-sequence cross-attention; the
    decode path of ``spec`` (the split-KV kernel under
    ``use_decode_kernel``) with kv_len = enc_len."""
    q = _split_heads(x @ params["wq"], cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_normalize(q) * params["q_norm"]
    spec = dataclasses.replace(spec or attn_spec_from_config(cfg),
                               window=None)
    o = decode_attention(q, cache["k"], cache["v"], enc_len, spec)
    return _merge_heads(o) @ params["wo"]


def write_page_rows(pool, rows, page, off):
    """pool[:, page[i], off[i], :] = rows[:, i, :] for every row whose page
    is a real pool page; rows aimed past the pool (padding, idle lanes,
    overflow) are dropped — the explicit form of JAX's ``mode="drop"``.
    In place."""
    keep = (page >= 0) & (page < pool.shape[1])
    idx = keep.nonzero().squeeze(1)
    pool[:, page[idx].long(), off[idx].long(), :] = rows[:, idx].to(pool.dtype)


def chunk_prefill_attention_step(params, cfg: ModelConfig, x, pool,
                                 dest_page, dest_off, page_list,
                                 q_seg, kv_seg, q_pos, kv_pos,
                                 *, spec: AttentionSpec | None = None,
                                 mesh=None):
    """Packed chunked-prefill attention against the shared page pool, in
    place (DESIGN.md §10, §11). x: (1, S, d_model) — the next chunks of
    several sequences packed (q_seg isolates them). The chunk's K/V rows
    are written into pool pages at ``(dest_page, dest_off)``; then each
    segment's full logical prefix is attended THROUGH ``page_list`` with the
    per-segment positions (exact attention over the atomic prefix). RoPE
    uses the same logical positions. Returns (out, pool), pool updated in
    place.

    Under sequence parallelism x, ``q_seg`` and ``q_pos`` are this rank's
    slab of the packed chunk while the kv side (``dest_page`` /
    ``dest_off`` for the whole chunk, ``page_list``, ``kv_seg``,
    ``kv_pos``) is whole: the slab is projected at its own positions,
    ``_sp_gather_kv`` assembles the chunk's K/V, every rank writes all of
    it and attends its slab's queries."""
    q, k, v = _project_qkv(params, cfg, x, x, q_pos, q_pos)
    k, v = _sp_gather_kv(k, v, cfg, mesh)
    write_page_rows(pool["k"], k[0], dest_page, dest_off)
    write_page_rows(pool["v"], v[0], dest_page, dest_off)
    spec = spec or attn_spec_from_config(cfg)
    o = paged_prefill_attention(q, pool["k"], pool["v"], page_list, spec,
                                q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                q_positions=q_pos, kv_positions=kv_pos)
    return _tp_reduce(_merge_heads(o) @ params["wo"], cfg, mesh), pool


def decode_write_destination(page_table, kv_len, page_size, num_pages):
    """Physical (page, offset) of each lane's new token: page
    ``page_table[b, kv_len // ps]`` at offset ``kv_len % ps``. Unallocated
    entries (idle lanes) AND rows already at full table capacity map to
    ``num_pages`` — dropped by the write. Without the capacity guard the
    clamp of the logical page would redirect an overflow write into the
    LAST allocated page, corrupting live rows."""
    T = page_table.shape[1]
    lp = torch.clamp(kv_len // page_size, max=T - 1).long()
    off = kv_len % page_size
    phys = page_table.gather(1, lp[:, None])[:, 0]
    phys = torch.where((phys < 0) | (kv_len >= T * page_size),
                       torch.full_like(phys, num_pages), phys)
    return phys, off


def paged_decode_attention_step(params, cfg: ModelConfig, x, pool,
                                page_table, kv_len,
                                *, spec: AttentionSpec | None = None,
                                mesh=None):
    """Single-token decode against the shared page pool. x: (b, 1, d_model);
    pool leaves (hkv, num_pages, page_size, hd); page_table (b, T) int32,
    negative = unallocated; kv_len (b,). Writes the new K/V in place, then
    attends over [0, kv_len]. RoPE positions are the logical ``kv_len``.
    Returns (out, pool)."""
    positions = kv_len[:, None]
    q, k, v = _project_qkv(params, cfg, x, x, positions, positions)
    num_pages, page_size = pool["k"].shape[1], pool["k"].shape[2]
    phys, off = decode_write_destination(page_table, kv_len, page_size,
                                         num_pages)
    # (b, hkv, 1, hd) -> (hkv, b, hd)
    write_page_rows(pool["k"], k[:, :, 0].transpose(0, 1), phys, off)
    write_page_rows(pool["v"], v[:, :, 0].transpose(0, 1), phys, off)
    spec = spec or attn_spec_from_config(cfg)
    o = paged_decode_attention(q, pool["k"], pool["v"], page_table,
                               kv_len + 1, spec)
    return _tp_reduce(_merge_heads(o) @ params["wo"], cfg, mesh), pool


# ---------------------------------------------------------------------------
# sequence-sharded decode: the KV capacity or the page pool cut over "model"
# ---------------------------------------------------------------------------

def gather_columns(cols, shard, *, all_lanes: bool = False):
    """Every head's columns of the rank's column-parallel projections:
    ``cols`` (b, s, c_i) each, this rank's columns of its lanes, gathered
    over "model" where the heads are cut (in rank order: the reference's
    contiguous column cut), and with ``all_lanes`` (a pool every data rank
    holds whole) every data rank's lanes too, over the whole mesh (over
    "data" where the heads are whole). One ``all_gather``; ``cols`` as
    they are where nothing is cut."""
    heads = shard.heads
    lanes = all_lanes and shard.batch_sharded and shard.data.size > 1
    if not (heads or lanes):
        return list(cols)
    group = (shard.world if heads and lanes else
             shard.model if heads else shard.data)
    m = shard.model.size if heads else 1
    sizes = [c.shape[-1] for c in cols]
    flat = torch.cat(cols, dim=-1)
    b, s = flat.shape[:2]
    every = comm.all_gather(flat, group, dim=0).view(-1, m, b, s, sum(sizes))
    return [part.permute(0, 2, 3, 1, 4).reshape(-1, s, m * part.shape[-1])
            for part in every.split(sizes, dim=-1)]


def _rank_output(params, o, shard):
    """``wo`` of every head's output o (b, h, s, hd): where the heads are
    cut, this rank's columns of it through its rows of ``wo``, summed
    over "model"."""
    flat = _merge_heads(o)
    if not shard.heads:
        return flat @ params["wo"]
    w = params["wo"].shape[0]
    r = shard.model.index
    out = flat[..., r * w:(r + 1) * w] @ params["wo"]
    return comm.all_reduce_sum(out, shard.model)


def merge_rank_partials(parts, shard, dtype):
    """One output (b, hq, 1, d) from the fp32 split partials of every
    rank's slice: gathered over "model" (one ``all_gather``) where the
    capacity is cut, then merged over all ranks' splits
    (``_merge_split_partials``; an empty split weighs 0)."""
    o_p, m_p, l_p = parts
    if shard.kv_seq:
        packed = torch.cat([o_p, m_p[..., None], l_p[..., None]], dim=-1)
        every = comm.all_gather(packed, shard.model, dim=2)
        o_p, m_p, l_p = every[..., :-2], every[..., -2], every[..., -1]
    return _merge_split_partials(o_p, m_p, l_p, dtype)


def kv_seq_prefill_attention(params, cfg: ModelConfig, x, shard, *,
                             kv_x=None, causal: bool = True,
                             spec: AttentionSpec | None = None):
    """Full-sequence attention of a prompt x (b, s, d_model) on one rank of
    a sequence-sharded decode: the tensor-parallel prefill at the rank's
    heads. Where the rules cut the heads whole (q heads with their kv
    head, ``sharding.heads_cut_whole``) the rank attends its q heads
    only, its K/V columns gathered over "model" (the cache needs every
    head); otherwise it gathers q too and attends every head. Self
    attention (causal unless ``causal`` is False: an encoder's), or with
    ``kv_x`` (b, s_kv, d_model) cross-attention (no RoPE, never causal or
    windowed). Returns (out (b, s, d_model), k, v): every kv head's rows
    (b, hkv, s or s_kv, hd), of which the caller keeps its slice."""
    from repro_torch.distributed.sharding import heads_cut_whole
    cross = kv_x is not None
    src = kv_x if cross else x
    pos = None if cross else torch.arange(x.shape[1], device=x.device)
    q, k, v = x @ params["wq"], src @ params["wk"], src @ params["wv"]
    m, r = shard.model.size, shard.model.index
    whole = shard.heads and heads_cut_whole(cfg, m)
    if whole:
        k, v = gather_columns([k, v], shard)
    else:
        q, k, v = gather_columns([q, k, v], shard)
    q, k, v = _qkv_heads(params, cfg, q, k, v, pos, pos)
    spec = spec or attn_spec_from_config(cfg)
    if cross or not causal:
        spec = dataclasses.replace(spec, causal=False, window=None)
    ka, va = k, v
    if whole:
        hq = q.shape[1]
        n_rep = cfg.num_heads // cfg.num_kv_heads
        lo, hi = r * hq // n_rep, ((r + 1) * hq - 1) // n_rep + 1
        ka, va = k[:, lo:hi], v[:, lo:hi]
        spec = dataclasses.replace(spec, tp_shards=m)
        o = attention(q, ka, va, spec)
        out = comm.all_reduce_sum(_merge_heads(o) @ params["wo"], shard.model)
    else:
        out = _rank_output(params, attention(q, ka, va, spec), shard)
    return out, k, v


def kv_seq_decode_attention_step(params, cfg: ModelConfig, x, cache, kv_len,
                                 shard, *, spec: AttentionSpec | None = None):
    """Single-token decode on one rank of a sequence-sharded slot cache.
    x: (b, 1, d_model), the rank's lanes; cache leaves (b, hkv, C / m, hd),
    this rank's slice [r C / m, (r + 1) C / m) of every head; kv_len (b,)
    the global lengths. The new token's q/k/v columns are gathered over
    "model" (every rank then holds every head), the new K/V is written
    on its owner only, the rank whose slice holds position
    ``min(kv_len, C - 1)`` (the reference's clamp at the last slot), the
    rank attends its slice (``flash_decode_slice``: #7 on the card) and
    the fp32 split partials of every rank are merged
    (``merge_rank_partials``). Returns (out, cache), cache updated in
    place."""
    q, k, v = gather_columns([x @ params[w] for w in ("wq", "wk", "wv")],
                             shard)
    q, k, v = _qkv_heads(params, cfg, q, k, v, kv_len[:, None],
                         kv_len[:, None])
    m, r = shard.kv_rank
    cs = cache["k"].shape[2]
    off = r * cs
    pos = torch.clamp(kv_len, max=m * cs - 1).long() - off
    own = ((pos >= 0) & (pos < cs))[:, None, None]
    idx = pos.clamp(0, cs - 1)
    rows = torch.arange(x.shape[0], device=x.device)
    for c, new in ((cache["k"], k), (cache["v"], v)):
        c[rows, :, idx] = torch.where(own, new[:, :, 0].to(c.dtype),
                                      c[rows, :, idx])
    spec = spec or attn_spec_from_config(cfg)
    parts = flash_decode_slice(q, cache["k"], cache["v"], kv_len + 1,
                               offset=off, block_k=spec.block_k,
                               num_splits=spec.num_decode_splits,
                               window=spec.window)
    o = merge_rank_partials(parts, shard, q.dtype)
    return _rank_output(params, o, shard), cache


def kv_seq_paged_decode_attention_step(params, cfg: ModelConfig, x, pool,
                                       page_table, kv_len, shard, *,
                                       lanes=None,
                                       spec: AttentionSpec | None = None):
    """Single-token decode on one rank of a page pool cut over "model":
    pool leaves (hkv, N / m, page_size, hd), this rank's pages [r N / m,
    (r + 1) N / m); page_table (b, T) and kv_len (b,) the rank's lanes in
    global page indices and lengths. ``lanes``: (page_table, kv_len) of
    every data rank's lanes where the pool is every data rank's (the
    reference's pool is replicated over "data"): the new K/V of all of
    them is gathered and written, each row by the rank that owns its
    page. The rank attends its pages through the global table
    (``flash_decode_paged_slice``: #8 on the card) and the partials are
    merged over "model". Returns (out, pool), pool updated in place."""
    cols = [x @ params[w] for w in ("wq", "wk", "wv")]
    q, k, v = gather_columns(cols, shard, all_lanes=lanes is not None)
    table, lengths = lanes if lanes is not None else (page_table, kv_len)
    q, k, v = _qkv_heads(params, cfg, q, k, v, lengths[:, None],
                         lengths[:, None])
    if lanes is not None:
        b = x.shape[0]
        q = q[shard.data.index * b:(shard.data.index + 1) * b]
    m, r = shard.kv_rank
    n, ps = pool["k"].shape[1], pool["k"].shape[2]
    phys, off = decode_write_destination(table, lengths, ps, m * n)
    local = phys - r * n
    local = torch.where((local >= 0) & (local < n), local,
                        torch.full_like(local, n))
    write_page_rows(pool["k"], k[:, :, 0].transpose(0, 1), local, off)
    write_page_rows(pool["v"], v[:, :, 0].transpose(0, 1), local, off)
    spec = spec or attn_spec_from_config(cfg)
    parts = flash_decode_paged_slice(q, pool["k"], pool["v"], page_table,
                                     kv_len + 1, first_page=r * n,
                                     num_splits=spec.num_decode_splits,
                                     window=spec.window)
    o = merge_rank_partials(parts, shard, q.dtype)
    return _rank_output(params, o, shard), pool


def kv_seq_cross_decode_step(params, cfg: ModelConfig, x, cache, enc_len,
                             shard, *, spec: AttentionSpec | None = None):
    """One decoder token's cross-attention on one rank of a
    sequence-sharded decode: cache leaves (b, hkv, S_enc / m, hd), this
    rank's rows of the encoder's K/V; enc_len (b,) the encoder's length.
    The token's q columns are gathered over "model", the rank attends its
    rows (``flash_decode_slice``, no window) and the partials are merged
    over "model" (``merge_rank_partials``). No RoPE, as in the
    full-sequence cross-attention. Returns out (b, 1, d_model)."""
    (q,) = gather_columns([x @ params["wq"]], shard)
    q = _split_heads(q, q.shape[-1] // cfg.head_dim, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_normalize(q) * params["q_norm"]
    _, r = shard.kv_rank
    cs = cache["k"].shape[2]
    spec = spec or attn_spec_from_config(cfg)
    parts = flash_decode_slice(q, cache["k"], cache["v"], enc_len,
                               offset=r * cs, block_k=spec.block_k,
                               num_splits=spec.num_decode_splits)
    o = merge_rank_partials(parts, shard, q.dtype)
    return _rank_output(params, o, shard)
