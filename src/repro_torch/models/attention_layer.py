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
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], hq, hd)
    k, v = kv_x @ params["wk"], kv_x @ params["wv"]
    if shard is not None and shard.kv_split:
        k, v = _whole_kv_head(k, shard, hd), _whole_kv_head(v, shard, hd)
    k, v = _split_heads(k, hkv, hd), _split_heads(v, hkv, hd)
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
