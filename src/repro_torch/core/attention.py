"""Attention dispatch: one API, several implementations (port of
``repro.core.attention``).

``attention(...)`` picks the implementation by ``AttentionSpec.impl``:
  * ``pallas``    — the FlashAttention kernels. The name is kept so that
                    reference configs port unchanged; in this package it
                    maps to the hand-written CUDA kernels (their plain
                    versions for CPU tensors).
  * ``chunked``   — Algorithm 1 in plain PyTorch (online softmax over kv
                    chunks of ``chunk_size``, O(N) memory; ``pv_bf16``
                    rounds P and V to bf16 for P@V). The default, as in
                    the JAX package. With ``banded_window`` and a window,
                    a causal self-attention with no mask, segments or
                    positions takes ``window_banded_attention`` instead
                    (the reference's dispatch rule).
  * ``reference`` — Algorithm 0 (materializes S/P).
  * ``block_sparse`` — the ``pallas`` path with an Alg. 5 sparse pattern
                    (``block_layout``, required): the pattern joins the one
                    block-layout compilation of ``kernels/ops.py``.

``attention`` takes the JAX signature's ``dropout_seed`` and
``deterministic``: attention dropout (``AttentionSpec.dropout_p``) runs
only when ``deterministic`` is False, on ``pallas`` and ``reference``;
``chunked`` raises on it, as in the JAX package.

``decode_attention`` is the single-token path against a contiguous cache:
the split-KV kernel (``use_decode_kernel``) or a plain masked softmax.
``paged_prefill_attention`` / ``paged_decode_attention`` attend the shared
page pool: in place through the kernels, or through a clamped gather plus
the same fused mask on every other path. ``paged_prefill_attention`` is
differentiable on every path (the paged op's backward runs the paged dq
and dkv kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import masks
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged

AttnImpl = Literal["pallas", "chunked", "reference", "block_sparse"]


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Static attention configuration carried by model configs. Tiles
    ``block_q``/``block_k`` None come from ``kernels.tuning``;
    ``num_decode_splits`` None = auto."""
    impl: AttnImpl = "chunked"
    causal: bool = True
    window: int | None = None
    dropout_p: float = 0.0
    block_q: int | None = None
    block_k: int | None = None
    chunk_size: int = 1024          # ``chunked``'s kv chunk
    variant: str = "fa2"            # pallas accumulator variant: "paper"|"fa2"
    num_decode_splits: int | None = None
    use_decode_kernel: bool = False
    pv_bf16: bool = False           # bf16 P and V for P@V (fp32 sums)
    banded_window: bool = False     # banded layout for sliding-window attn
    tp_shards: int = 1              # tensor-parallel shards: tiles and
                                    # decode split target (tuning)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    spec: AttentionSpec,
    *,
    kv_mask: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    block_layout=None,
    dropout_seed=0,
    dropout_coords: tuple[int, int, int] | None = None,
    deterministic: bool = True,
    q_offset: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """(b, hq, sq, d) x (b, hkv, sk, d)^2 -> (b, hq, sq, d); every impl
    evaluates the same fused mask. ``block_layout`` (an Alg. 5 sparse
    pattern) reaches the kernels on ``pallas`` and ``block_sparse``, as in
    the JAX package; the other impls do not read it. ``dropout_coords`` =
    (b0, h0, H) places the tensors' rows and heads in a global batch of H
    heads for the dropout hash (a rank of a sharded step)."""
    dropout_p = 0.0 if deterministic else spec.dropout_p
    common = dict(causal=spec.causal, window=spec.window, kv_mask=kv_mask,
                  segment_ids=segment_ids, q_segment_ids=q_segment_ids,
                  kv_segment_ids=kv_segment_ids, q_positions=q_positions,
                  kv_positions=kv_positions, scale=scale, q_offset=q_offset)
    if spec.impl in ("pallas", "block_sparse"):
        if spec.impl == "block_sparse" and block_layout is None:
            raise ValueError("impl=block_sparse requires block_layout")
        return kops.flash_attention(
            q, k, v, dropout_p=dropout_p, dropout_seed=dropout_seed,
            dropout_coords=dropout_coords, block_q=spec.block_q,
            block_k=spec.block_k, variant=spec.variant,
            block_layout=block_layout, shards=spec.tp_shards, **common)
    if spec.impl == "chunked":
        if dropout_p > 0.0:
            raise ValueError("attention dropout requires impl='pallas'")
        if (spec.banded_window and spec.window is not None
                and kv_mask is None and segment_ids is None
                and q_segment_ids is None and q_positions is None
                and q.shape[2] == k.shape[2] and q_offset in (None, 0)):
            return kref.window_banded_attention(
                q, k, v, window=spec.window, scale=scale,
                pv_bf16=spec.pv_bf16)
        return kref.chunked_attention(q, k, v, chunk_size=spec.chunk_size,
                                      pv_bf16=spec.pv_bf16, **common)
    if spec.impl == "reference":
        return kref.standard_attention(
            q, k, v, dropout_p=dropout_p, dropout_seed=dropout_seed,
            dropout_coords=dropout_coords, **common)
    raise ValueError(f"unknown attention impl {spec.impl!r}")


def decode_attention(
    q: torch.Tensor,            # (b, hq, 1, d)
    k_cache: torch.Tensor,      # (b, hkv, capacity, d)
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,       # (b,) int32
    spec: AttentionSpec,
    *,
    kv_mask: torch.Tensor | None = None,   # (b, capacity) True = valid slot
    scale: float | None = None,
) -> torch.Tensor:
    """The split-KV decode kernel (``spec.use_decode_kernel``; its tile is
    ``spec.block_k``, as in the JAX package), else a GQA-native masked
    softmax over the cache: q reshaped to (b, hkv, rep, 1, d) against the
    unexpanded cache. Validity comes from ``masks.decode_kv_valid``
    (kv_len + window + optional slot mask) on both paths."""
    if spec.use_decode_kernel:
        return flash_decode(q, k_cache, v_cache, kv_len, scale=scale,
                            block_k=spec.block_k,
                            num_splits=spec.num_decode_splits,
                            window=spec.window, kv_mask=kv_mask,
                            shards=spec.tp_shards)
    b, hq, sq, d = q.shape
    _, hkv, capacity, _ = k_cache.shape
    rep = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, rep, sq, d)
    s = torch.einsum("bkrqd,bksd->bkrqs", qg.float(), k_cache.float()) * scale
    kvm = masks.decode_kv_valid(kv_len, capacity, window=spec.window,
                                kv_mask=kv_mask)
    s = torch.where(kvm[:, None, None, None, :], s,
                    torch.full_like(s, masks.NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= masks.NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    # fully-masked rows (kv_len == 0 / idle lanes) emit zeros, the same
    # convention as the split-KV kernel's empty-partial merge.
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bkrqs,bksd->bkrqd", p, v_cache.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def paged_prefill_attention(
    q: torch.Tensor,            # (b, hq, sq, d) — the suffix chunk's queries
    k_pool: torch.Tensor,       # (hkv, num_pages, page_size, d)
    v_pool: torch.Tensor,
    page_list: torch.Tensor,    # (b, T) int32; negative = dead (never read)
    spec: AttentionSpec,
    *,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,   # (b, T*page_size), SEG_PAD_KV on dead rows
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,     # (b, T*page_size), POS_PAD on dead rows
    scale: float | None = None,
) -> torch.Tensor:
    """Chunked-prefill attention over the PAGED prefix. ``pallas`` reads the
    pool in place through the page list (the paged kernel); every other
    impl is the parity path: gather the pages into the logical view and
    reuse ``attention``. Dead rows carry sentinels either way."""
    if spec.impl == "pallas":
        return kops.flash_prefill_paged(
            q, k_pool, v_pool, page_list,
            q_positions=q_positions, kv_positions=kv_positions,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            causal=spec.causal, window=spec.window, scale=scale,
            block_q=spec.block_q, variant=spec.variant,
            shards=spec.tp_shards)
    return attention(
        q, kref.gather_pages(k_pool, page_list), kref.gather_pages(v_pool, page_list),
        spec, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        q_positions=q_positions, kv_positions=kv_positions, scale=scale)


def paged_decode_attention(
    q: torch.Tensor,            # (b, hq, 1, d)
    k_pool: torch.Tensor,       # (hkv, num_pages, page_size, d)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,   # (b, pages_per_seq) int32; negative = unallocated
    kv_len: torch.Tensor,       # (b,) int32
    spec: AttentionSpec,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token decode against the paged cache: the split-KV kernel
    walks the page table (``use_decode_kernel``), else the parity path
    gathers the pages and reuses ``decode_attention`` with unallocated
    entries masked as invalid slots."""
    if spec.use_decode_kernel:
        return flash_decode_paged(q, k_pool, v_pool, page_table, kv_len,
                                  scale=scale,
                                  num_splits=spec.num_decode_splits,
                                  window=spec.window, shards=spec.tp_shards)
    page_size = k_pool.shape[2]
    alloc = (page_table >= 0).repeat_interleave(page_size, dim=1)
    return decode_attention(
        q, kref.gather_pages(k_pool, page_table), kref.gather_pages(v_pool, page_table),
        kv_len, dataclasses.replace(spec, use_decode_kernel=False),
        kv_mask=alloc, scale=scale)
