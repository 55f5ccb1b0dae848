"""Grouped-query self-attention layer on the flash core (port of the dense
parts of ``repro.models.attention_layer``), with optional qk-norm (an RMS
normalization of every q and k head before RoPE, scaled by ``q_norm`` /
``k_norm``) and a head_dim decoupled from d_model (``wq`` is
(d_model, hq * head_dim)).

Five execution modes: full-sequence training (``apply_attention``, with
segment-relative RoPE and attention dropout), packed prefill
(``prefill_attention``, optionally writing a fixed-capacity slot cache),
chunked prefill against the shared page pool
(``chunk_prefill_attention_step``), single-token decode against the slot
cache (``decode_attention_step``) and against the pool
(``paged_decode_attention_step``).

The JAX step functions return a new cache and rely on jit buffer donation
to update it in place; here the cache and pool tensors are updated IN
PLACE and the same dict is returned. JAX's ``mode="drop"`` scatters (out-of-range page
index = write dropped) become explicit masks: rows whose destination is
out of range are removed before the write, so they can never land in —
and corrupt — a live page.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (AttentionSpec, attention,
                                        decode_attention,
                                        paged_decode_attention,
                                        paged_prefill_attention)
from repro_torch.core.masks import segment_relative_positions
from repro_torch.models.layers import apply_rope, dense_init, rms_normalize


def attn_spec_from_config(cfg: ModelConfig) -> AttentionSpec:
    return AttentionSpec(impl=cfg.attn_impl, causal=cfg.causal,
                         window=cfg.window, dropout_p=cfg.attn_dropout,
                         block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
                         num_decode_splits=cfg.num_decode_splits,
                         use_decode_kernel=cfg.use_decode_kernel)


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


def _project_qkv(params, cfg: ModelConfig, x, kv_x, positions, kv_positions):
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], hq, hd)
    k = _split_heads(kv_x @ params["wk"], hkv, hd)
    v = _split_heads(kv_x @ params["wv"], hkv, hd)
    if cfg.qk_norm:
        q = rms_normalize(q) * params["q_norm"]
        k = rms_normalize(k) * params["k_norm"]
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    if kv_positions is not None:
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def apply_attention(params, cfg: ModelConfig, x, *,
                    spec: AttentionSpec | None = None, positions=None,
                    kv_mask=None, segment_ids=None,
                    deterministic: bool = True, dropout_seed=0):
    """Full-sequence self-attention, x: (b, s, d_model) -> (b, s, d_model).
    ``segment_ids`` isolates packed documents AND makes RoPE
    segment-relative (positions restart at every document boundary), so
    packed training is position-identical to per-document training."""
    if positions is None:
        positions = (segment_relative_positions(segment_ids)
                     if segment_ids is not None
                     else torch.arange(x.shape[1], device=x.device))
    q, k, v = _project_qkv(params, cfg, x, x, positions, positions)
    spec = spec or attn_spec_from_config(cfg)
    o = attention(q, k, v, spec, kv_mask=kv_mask, segment_ids=segment_ids,
                  deterministic=deterministic, dropout_seed=dropout_seed)
    return _merge_heads(o) @ params["wo"]


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                  device):
    """One layer's fixed-capacity slot cache, (batch, hkv, capacity, hd)
    per K/V leaf."""
    shape = (batch, cfg.num_kv_heads, capacity, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_attention(params, cfg: ModelConfig, x, cache=None, *,
                      kv_mask=None, segment_ids=None, positions=None,
                      spec: AttentionSpec | None = None):
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
    return _merge_heads(o) @ params["wo"], cache


def decode_attention_step(params, cfg: ModelConfig, x, cache, kv_len,
                          *, spec: AttentionSpec | None = None):
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
    return _merge_heads(o) @ params["wo"], cache


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
                                 *, spec: AttentionSpec | None = None):
    """Packed chunked-prefill attention against the shared page pool, in
    place (DESIGN.md §10, §11). x: (1, S, d_model) — the next chunks of
    several sequences packed (q_seg isolates them). The chunk's K/V rows
    are written into pool pages at ``(dest_page, dest_off)``; then each
    segment's full logical prefix is attended THROUGH ``page_list`` with the
    per-segment positions (exact attention over the atomic prefix). RoPE
    uses the same logical positions. Returns (out, pool), pool updated in
    place."""
    q, k, v = _project_qkv(params, cfg, x, x, q_pos, q_pos)
    write_page_rows(pool["k"], k[0], dest_page, dest_off)
    write_page_rows(pool["v"], v[0], dest_page, dest_off)
    spec = spec or attn_spec_from_config(cfg)
    o = paged_prefill_attention(q, pool["k"], pool["v"], page_list, spec,
                                q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                q_positions=q_pos, kv_positions=kv_pos)
    return _merge_heads(o) @ params["wo"], pool


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
                                *, spec: AttentionSpec | None = None):
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
    return _merge_heads(o) @ params["wo"], pool
