"""FlashAttention forward and backward: hand-written Hopper kernels and
their plain versions (port of ``repro.kernels.flash_attention``).

``flash_attention_forward`` (contiguous K/V) and
``flash_prefill_paged_forward`` (K/V read in place from page-pool pages
through a page list) return ``(o, m, l)`` exactly as the Pallas kernels do:
o in the input dtype, per-row max m and normalizer l in fp32, rows with no
unmasked key at o = 0, l = 0, m = NEG_INF. ``flash_attention_backward``
returns ``(dq, dk, dv)`` with dk and dv summed over each GQA group;
``flash_prefill_paged_backward`` returns ``(dq, dk_pool, dv_pool)``: the
paged dkv kernel writes packed page-aligned rows, which a fold kernel
(plain version ``fold_packed_to_pool``) sums into pool shape (dead slots
dropped, pages shared across rows accumulated in a fixed order:
deterministic). All of
them take the COMPILED block layout (``core.masks.compile_block_layout``)
as the single source of block-run truth and fold the softmax scale into q
once, in q's dtype, before the kernel.

Attention dropout is the counter-based hash of ``kernels.ref``
(``dropout_keep_mask``) over BUFFER coordinates (b, q-head, row, column)
with the unpadded ``dropout_dims`` as strides, so the backward regenerates
the forward's mask bit for bit; ``dropout_coords`` = (b0, h0, H) places
the buffer at rows b0 + b and heads h0 + h of H (a rank of a sharded
step; default (0, 0, the buffer's heads)). ``variant="paper"`` renormalizes the
accumulator at every kv tile (Alg. 1 line 12); ``"fa2"`` divides once at
the end. A dense plain version has no tile order, so both variants compute
the same dense softmax there.

On a CUDA tensor each wrapper launches ``csrc/flash_fwd_sm90.cu``,
``csrc/flash_fwd.cu``, ``csrc/flash_bwd_sm90.cu`` or ``csrc/flash_bwd.cu``
(built at first use, see ``kernels/build.py``) and counts the launch in
``LAUNCHES``; on a CPU tensor it runs the plain version beside it, which
computes the same function (layout included) densely in fp32. There is no
fallback between the two, nor between two bodies of one kernel. Which body
runs is a static rule. The forward's, ``forward_body``: bf16 at head_dim
64, 96 or 128 over 64-row q blocks (or one q block of at most 64 rows) and
64-key blocks (or one), or pages of 8-64 rows, runs the wgmma/TMA body of
``flash_fwd_sm90.cu`` (counted as ``flash_fwd_sm90`` /
``flash_fwd_paged_sm90``). The backward pair's, ``backward_body``: the
bf16 pair at head_dim 64, 96 or 128 over 64-row q blocks and 64-key
blocks, or paged over pages of 8-64 rows, runs ``flash_bwd_sm90.cu``
(``flash_bwd_dq_sm90`` / ``flash_bwd_dkv_sm90``; paged
``flash_bwd_dq_paged_sm90`` / ``flash_bwd_dkv_paged_sm90``). Every other
call on the card runs the ``flash_fwd.cu`` / ``flash_bwd.cu`` bodies
(mma.sync in bf16, the scalar parity body in fp32).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import masks as M
from repro_torch.core.masks import NEG_INF
from repro_torch.kernels import build
from repro_torch.kernels.ref import (dropout_threshold, full_dropout_keep_mask,
                                     gather_pages, repeat_kv)
from repro_torch.kernels.tuning import (KERNEL_HEAD_DIMS, MAX_TILE,
                                        PAGE_SIZES, ROW_ALIGN,
                                        SM90_BWD_HEAD_DIMS,
                                        SM90_FWD_HEAD_DIMS, SM90_FWD_MAX_WALK,
                                        SM90_MAX_WALK, SMEM_PER_BLOCK,
                                        attention_working_set_bytes,
                                        fwd_pages_per_tile, sm90_bwd_rows,
                                        sm90_fwd_rows, sm90_fwd_splits)

# launches of the CUDA kernel per wrapper (never counts plain-version calls)
LAUNCHES = {"flash_fwd": 0, "flash_fwd_paged": 0, "flash_fwd_sm90": 0,
            "flash_fwd_paged_sm90": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_bwd_dq_sm90": 0, "flash_bwd_dkv_sm90": 0,
            "flash_bwd_dq_paged": 0, "flash_bwd_dkv_paged": 0,
            "flash_bwd_dq_paged_sm90": 0, "flash_bwd_dkv_paged_sm90": 0,
            "flash_bwd_fold_paged": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("flash_fwd")
    if not getattr(lib, "_typed", False):
        c_int, c_p = ctypes.c_int, ctypes.c_void_p
        lib.flash_fwd.argtypes = ([c_int] * 3 + [c_p] * 7 + [ctypes.c_longlong]
                                  + [c_p] * 6 + [c_int] * 15 + _DROPOUT_ARGS
                                  + [c_p])
        lib.flash_fwd.restype = c_int
        lib._typed = True
    return lib


def _fwd_sm90_lib():
    lib = build.load("flash_fwd_sm90")
    if not getattr(lib, "_typed", False):
        c_int, c_p = ctypes.c_int, ctypes.c_void_p
        lib.flash_fwd_sm90.argtypes = (
            [c_int] * 3 + [c_p] * 7 + [ctypes.c_longlong] + [c_p] * 6
            + [c_int] * 15 + _DROPOUT_ARGS + [c_p, c_int, c_int])
        lib.flash_fwd_sm90.restype = c_int
        lib._typed = True
    return lib


def _bwd_lib():
    lib = build.load("flash_bwd")
    if not getattr(lib, "_typed", False):
        c_int, c_p = ctypes.c_int, ctypes.c_void_p
        args = ([c_int] * 2 + [c_p] * 10 + [ctypes.c_longlong] + [c_p] * 5
                + [c_int] * 13 + _DROPOUT_ARGS + [ctypes.c_float, c_p])
        for fn in (lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.argtypes = args
            fn.restype = c_int
        for fn in (lib.flash_bwd_dq_paged, lib.flash_bwd_dkv_paged):
            fn.argtypes = args + [c_p, c_int]   # page list, num_pages
            fn.restype = c_int
        lib.flash_bwd_fold_paged.argtypes = [c_int] + [c_p] * 6 + [c_int] * 5 + [c_p]
        lib.flash_bwd_fold_paged.restype = c_int
        lib._typed = True
    return lib


def _sm90_lib():
    lib = build.load("flash_bwd_sm90")
    if not getattr(lib, "_typed", False):
        c_int, c_p = ctypes.c_int, ctypes.c_void_p
        args = ([c_int] * 2 + [c_p] * 10 + [ctypes.c_longlong] + [c_p] * 5
                + [c_int] * 13 + _DROPOUT_ARGS + [ctypes.c_float, c_p])
        for fn in (lib.flash_bwd_sm90_dq, lib.flash_bwd_sm90_dkv):
            fn.argtypes = args + [c_int]          # the CTA tile
            fn.restype = c_int
        for fn in (lib.flash_bwd_sm90_dq_paged, lib.flash_bwd_sm90_dkv_paged):
            fn.argtypes = args + [c_p, c_int, c_int]   # page list, num_pages, tile
            fn.restype = c_int
        lib._typed = True
    return lib


def forward_body(*, on_card: bool, dtype: torch.dtype, head_dim: int,
                 block_q: int, block_k: int, paged: bool, nq: int = 1,
                 nk: int = 1) -> str:
    """Which body computes a forward call (``flash_attention_forward``, or
    with ``paged`` ``flash_prefill_paged_forward``, whose ``block_k`` is the
    page and ``nk`` the page slots): ``"plain"`` for CPU tensors; on the
    card ``"sm90"`` (``csrc/flash_fwd_sm90.cu``: wgmma, TMA, a producer
    warp) for bf16 at head_dim 64, 96 or 128 whose q blocks are 64 rows (or
    one block of at most 64), whose key blocks are 64 (or one block, a
    multiple of ``ROW_ALIGN``) or pages, and whose walk is at most
    ``SM90_FWD_MAX_WALK`` 64-key tiles; ``"mma"`` (``flash_fwd.cu``'s
    mma.sync body) for every other bf16 call (head_dim 16 or 32, several
    blocks below 64 rows) and ``"scalar"`` (its fp32 parity body) for fp32.
    Dropout (contiguous only) and the variant do not change it. A static
    rule: no call is ever retried on another body."""
    if not on_card:
        return "plain"
    if dtype != torch.bfloat16:
        return "scalar"
    tiles = -(-nk * block_k // MAX_TILE) if paged else nk
    q_ok = block_q == MAX_TILE or (nq == 1 and 0 < block_q <= MAX_TILE)
    k_ok = paged or block_k == MAX_TILE or (
        nk == 1 and 0 < block_k <= MAX_TILE and block_k % ROW_ALIGN == 0)
    if (head_dim in SM90_FWD_HEAD_DIMS and q_ok and k_ok
            and tiles <= SM90_FWD_MAX_WALK):
        return "sm90"
    return "mma"


def backward_body(*, on_card: bool, dtype: torch.dtype, head_dim: int,
                  block_q: int, block_k: int, paged: bool, nq: int = 1,
                  nk: int = 1) -> str:
    """Which body computes a backward pair call (``flash_attention_backward``,
    or with ``paged`` ``flash_prefill_paged_backward``, whose ``block_k`` is
    the page and ``nk`` the page slots): ``"plain"`` for CPU tensors; on the
    card ``"sm90"`` (``csrc/flash_bwd_sm90.cu``: wgmma, TMA, a producer
    warp) for bf16 at head_dim 64, 96 or 128 over 64-row q blocks whose key
    blocks are 64 (contiguous) or pages of 8, 16, 32 or 64 rows, and whose
    walks are at most ``SM90_MAX_WALK`` long: the q blocks of a layout
    column and the 64-key tiles of a row (paged: ``ceil(nk * page / 64)``);
    ``"mma"`` (``flash_bwd.cu``'s mma.sync body) for every other bf16 call
    (head_dim 16 or 32, smaller q blocks or key blocks) and ``"scalar"``
    (its fp32 parity body) for fp32. A static rule: no call is ever retried
    on another body."""
    if not on_card:
        return "plain"
    if dtype != torch.bfloat16:
        return "scalar"
    tiles = -(-nk * block_k // MAX_TILE) if paged else nk
    k_ok = block_k in PAGE_SIZES if paged else block_k == MAX_TILE
    if (head_dim in SM90_BWD_HEAD_DIMS and block_q == MAX_TILE and k_ok
            and max(nq, tiles) <= SM90_MAX_WALK):
        return "sm90"
    return "mma"


def _aligned(t):
    """``t``, or a copy of it where its address is not 16-byte aligned (the
    sm90 body's TMA and bulk copies address whole 16-byte units)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _num_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# (on, seed, threshold, keep probability, q_len and k_len strides, the
# global coordinates b0, h0 and head count H)
_DROPOUT_ARGS = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int]


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_variant(variant):
    if variant not in ("fa2", "paper"):
        raise ValueError(f"unknown variant {variant!r}")


def _dropout_args(dropout_p, dropout_seed, dropout_dims, sq, sk, hq,
                  dropout_coords=None):
    """The kernels' dropout arguments: the uint32 threshold is computed in
    Python (double precision) exactly as ``ref.dropout_threshold``."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    q_len, k_len = dropout_dims if dropout_dims is not None else (sq, sk)
    b0, h0, heads = (dropout_coords if dropout_coords is not None
                     else (0, 0, hq))
    return [int(dropout_p > 0.0), int(dropout_seed) & 0xFFFFFFFF,
            dropout_threshold(dropout_p), 1.0 - dropout_p, q_len, k_len,
            int(b0), int(h0), int(heads)]


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _expand_layout(layout, block_q, block_k, sq, sk):
    qb = torch.arange(sq, device=layout.device) // block_q
    kb = torch.arange(sk, device=layout.device) // block_k
    return layout[..., qb[:, None], kb[None, :]]


def _allowed(block_layout, kv_mask, *, b, sq, sk, dev, causal, window,
             q_offset, kv_valid_len, block_q, block_k, q_segment_ids,
             kv_segment_ids, q_positions, kv_positions):
    """(…, sq, sk) bool: which (q, k) pairs the kernels score. The layout
    decides which tiles run (SKIP none, FULL unmasked, PARTIAL the fused
    mask, PARTIAL_DATA its data terms); broadcastable to (b, h, sq, sk)."""
    if q_positions is not None:
        q_pos, k_pos = q_positions[:, :, None], kv_positions[:, None, :]
    else:
        q_pos = torch.arange(sq, device=dev)[:, None] + q_offset
        k_pos = torch.arange(sk, device=dev)[None, :]
    geo = M.element_mask(q_pos, k_pos, causal=causal, window=window)
    data = M.element_mask(
        None, torch.arange(sk, device=dev)[None, :],
        kv_valid_len=kv_valid_len,
        kv_valid=kv_mask[:, None, :] if kv_mask is not None else None,
        q_seg=q_segment_ids[:, :, None] if q_segment_ids is not None else None,
        kv_seg=kv_segment_ids[:, None, :] if kv_segment_ids is not None else None)
    blk = _expand_layout(block_layout.to(dev), block_q, block_k, sq, sk)
    if geo is None and data is None:
        allowed = blk != M.BLOCK_SKIP
    else:
        true = torch.ones((), dtype=torch.bool, device=dev)
        full_ok = (geo if geo is not None else true) & \
            (data if data is not None else true)
        data_ok = data if data is not None else ~true
        allowed = ((blk == M.BLOCK_FULL)
                   | ((blk == M.BLOCK_PARTIAL) & full_ok)
                   | ((blk == M.BLOCK_PARTIAL_DATA) & data_ok))
    return allowed[:, None] if allowed.ndim == 3 else allowed


def _keep_scale(dropout_p, dropout_seed, dropout_dims, dropout_coords, b, hq,
                sq, sk, dev):
    """Z of the paper's Alg. 2: 1/(1-p) where the hash keeps an element, 0
    where it drops it, over buffer coordinates with the unpadded strides."""
    keep = full_dropout_keep_mask(dropout_seed, b, hq, sq, sk, dropout_p,
                                  device=dev, strides=dropout_dims,
                                  coords=dropout_coords)
    return torch.where(keep, 1.0 / (1.0 - dropout_p), 0.0)


def flash_attention_forward_plain(
    q, k, v, kv_mask, block_layout, *, scale, causal, window, q_offset,
    kv_valid_len=None, dropout_p=0.0, dropout_seed=0, dropout_dims=None,
    dropout_coords=None, block_q, block_k, variant="fa2", q_segment_ids=None,
    kv_segment_ids=None, q_positions=None, kv_positions=None,
):
    """Dense fp32 computation of exactly the kernel's function: one masked
    softmax over the pairs the layout lets run, dropout on the normalized
    P, and m, l of the undropped P."""
    _check_variant(variant)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dev = q.device
    qs = (q * scale).float()
    kf = repeat_kv(k, hq // hkv).float()
    vf = repeat_kv(v, hq // hkv).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    allowed = _allowed(
        block_layout, kv_mask, b=b, sq=sq, sk=sk, dev=dev, causal=causal,
        window=window, q_offset=q_offset, kv_valid_len=kv_valid_len,
        block_q=block_q, block_k=block_k, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, q_positions=q_positions,
        kv_positions=kv_positions)
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    if dropout_p > 0.0:
        p = p * _keep_scale(dropout_p, dropout_seed, dropout_dims,
                            dropout_coords, b, hq, sq, sk, dev)
    o = (p @ vf) / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return o.to(q.dtype), m, l


def flash_attention_backward_plain(
    q, k, v, o, do, m, l, kv_mask, block_layout, *, scale, causal, window,
    q_offset, kv_valid_len=None, dropout_p=0.0, dropout_seed=0,
    dropout_dims=None, dropout_coords=None, block_q, block_k,
    q_segment_ids=None, kv_segment_ids=None, q_positions=None,
    kv_positions=None,
):
    """Dense fp32 backward (paper Alg. 4 with the same recompute as the
    Pallas kernels): P from the saved (m, l) under the layout-allowed mask,
    D = rowsum(dO∘O), dP = dO·Vᵀ∘Z, dS = P∘(dP − D), dq = scale·dS·K,
    dK = dSᵀ·q′ (q′ = scale·q), dV = (P∘Z)ᵀ·dO, dK/dV summed per group."""
    dq, dk, dv = _dense_backward(
        q, k, v, o, do, m, l, kv_mask, block_layout, scale=scale,
        causal=causal, window=window, q_offset=q_offset,
        kv_valid_len=kv_valid_len, dropout_p=dropout_p,
        dropout_seed=dropout_seed, dropout_dims=dropout_dims,
        dropout_coords=dropout_coords, block_q=block_q, block_k=block_k,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        q_positions=q_positions, kv_positions=kv_positions)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _dense_backward(
    q, k, v, o, do, m, l, kv_mask, block_layout, *, scale, causal, window,
    q_offset, kv_valid_len, dropout_p, dropout_seed, dropout_dims, block_q,
    block_k, q_segment_ids, kv_segment_ids, q_positions, kv_positions,
    dropout_coords=None,
):
    """``flash_attention_backward_plain`` with dk, dv left in fp32."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    n_rep = hq // hkv
    dev = q.device
    qs = (q * scale).float()
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    dof = do.float()
    dd = (dof * o.float()).sum(dim=-1)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    allowed = _allowed(
        block_layout, kv_mask, b=b, sq=sq, sk=sk, dev=dev, causal=causal,
        window=window, q_offset=q_offset, kv_valid_len=kv_valid_len,
        block_q=block_q, block_k=block_k, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, q_positions=q_positions,
        kv_positions=kv_positions)
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    empty = l == 0.0
    m_safe = torch.where(empty, torch.zeros_like(m), m)
    l_safe = torch.where(empty, torch.ones_like(l), l)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - m_safe[..., None])) / l_safe[..., None]
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    p_drop = p
    if dropout_p > 0.0:
        z = _keep_scale(dropout_p, dropout_seed, dropout_dims, dropout_coords,
                        b, hq, sq, sk, dev)
        dp, p_drop = dp * z, p * z
    ds = p * (dp - dd[..., None])
    dq = (scale * (ds @ kf)).to(q.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_drop, dof)
    dk = dk.reshape(b, hkv, n_rep, sk, d).sum(dim=2)
    dv = dv.reshape(b, hkv, n_rep, sk, d).sum(dim=2)
    return dq, dk, dv


def flash_prefill_paged_forward_plain(
    q, k_pool, v_pool, page_list, block_layout, *, scale, causal, window,
    q_segment_ids=None, kv_segment_ids=None, q_positions=None,
    kv_positions=None, block_q, variant="fa2",
):
    ps = k_pool.shape[2]
    return flash_attention_forward_plain(
        q, gather_pages(k_pool, page_list), gather_pages(v_pool, page_list),
        None, block_layout, scale=scale, causal=causal, window=window,
        q_offset=0, block_q=block_q, block_k=ps, variant=variant,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        q_positions=q_positions, kv_positions=kv_positions)


def fold_packed_to_pool(packed: torch.Tensor, page_list: torch.Tensor,
                        num_pages: int) -> torch.Tensor:
    """Packed page-aligned gradient rows (b, hkv, T*ps, d) -> pool shape
    (hkv, num_pages, ps, d) in fp32: slot t of row b lands on page
    ``page_list[b, t]``; dead slots (negative) are dropped, pages no slot
    names stay exactly zero, and a page named by several slots (a prefix
    shared across rows) receives their sum. Deterministic: the k-th
    occurrence of every page (in (b, t) order) is added in pass k, and
    within one pass the pages are distinct, so no two writes race and the
    sum order is fixed."""
    b, hkv, rows, d = packed.shape
    T = page_list.shape[1]
    ps = rows // T
    src = packed.float().reshape(b, hkv, T, ps, d).transpose(1, 2)
    src = src.reshape(b * T, hkv, ps, d)
    pages = page_list.reshape(-1).long()
    live = (pages >= 0).nonzero().squeeze(1)
    pages, src = pages[live], src[live]
    out = torch.zeros((hkv, num_pages, ps, d), dtype=torch.float32,
                      device=packed.device)
    if pages.numel() == 0:
        return out
    rank = (pages[:, None] == pages[None, :]).tril(-1).sum(dim=1)
    for r in range(int(rank.max()) + 1):
        sel = (rank == r).nonzero().squeeze(1)
        out[:, pages[sel]] += src[sel].transpose(0, 1)
    return out


def fold_order(page_list: torch.Tensor, num_pages: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The order in which ``flash_bwd_fold_paged`` folds packed rows, on
    the page list's device with no host sync: (pages, slots), the
    flattened page list (slot = b * T + t) stably sorted by page, a dead
    slot taking ``page = num_pages`` so that it sorts last. The slots
    naming one page are then consecutive and in (b, t) order, the order in
    which ``fold_packed_to_pool`` adds them."""
    pages = page_list.reshape(-1).to(torch.int32)
    pages = torch.where(pages >= 0, pages, num_pages)
    return torch.sort(pages, stable=True)


def flash_prefill_paged_backward_plain(
    q, k_pool, v_pool, page_list, o, do, m, l, block_layout, *, scale,
    causal, window, q_segment_ids=None, kv_segment_ids=None,
    q_positions=None, kv_positions=None, block_q,
):
    """Dense fp32 backward of the paged prefill over the GATHERED pages
    (the layout keeps dead slots SKIP), folded into pool-shaped gradients:
    (dq in q's dtype, dk_pool, dv_pool in the pools' dtype)."""
    num_pages, ps = k_pool.shape[1], k_pool.shape[2]
    dq, dk, dv = _dense_backward(
        q, gather_pages(k_pool, page_list), gather_pages(v_pool, page_list),
        o, do, m, l, None, block_layout, scale=scale, causal=causal,
        window=window, q_offset=0, kv_valid_len=None, dropout_p=0.0,
        dropout_seed=0, dropout_dims=None, block_q=block_q, block_k=ps,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        q_positions=q_positions, kv_positions=kv_positions)
    return (dq, fold_packed_to_pool(dk, page_list, num_pages).to(k_pool.dtype),
            fold_packed_to_pool(dv, page_list, num_pages).to(v_pool.dtype))


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _i32(t):
    return None if t is None else t.to(torch.int32).contiguous()


def _check_launch(kernel, q, others, *, hkv, sk, block_q, block_k,
                  block_layout, page_size=None):
    """Validate what every attention kernel takes (and, given a
    ``page_size``, that the paged forward takes that page); returns the
    int32 layout on q's device and the (nq, nk) block grid."""
    b, hq, sq, d = q.shape
    for name, t in others.items():
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{kernel}: {name} must match q's device and "
                             f"dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{kernel} takes float32 or bfloat16, got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} head_dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if page_size is not None:
        fwd_pages_per_tile(page_size)
    if not (0 < block_q <= MAX_TILE and 0 < block_k <= MAX_TILE):
        raise ValueError(f"{kernel} tiles must be <= {MAX_TILE}, got "
                         f"({block_q}, {block_k})")
    if sq % block_q or sk % block_k or hq % hkv:
        raise ValueError(f"{kernel} needs sq % block_q == sk % block_k == 0 "
                         "and hq % hkv == 0 (ops.py pads)")
    nq, nk = sq // block_q, sk // block_k
    layout = block_layout.to(device=q.device, dtype=torch.int32).contiguous()
    if layout.shape[-2:] != (nq, nk) or layout.ndim not in (2, 3):
        raise ValueError(f"layout shape {tuple(layout.shape)} does not match "
                         f"the ({nq}, {nk}) block grid")
    return layout, nq, nk


def _launch(*, paged, q, k, v, block_layout, kv_mask, q_seg, kv_seg, q_pos,
            kv_pos, page_list, scale, causal, window, q_offset, kv_valid_len,
            block_q, block_k, sk, num_pages, variant, dropout, mma_body):
    """One forward launch on the body ``forward_body`` names (``mma_body``
    forces flash_fwd.cu's on an sm90 call), counted in ``LAUNCHES``."""
    b, hq, sq, d = q.shape
    hkv = k.shape[0] if paged else k.shape[1]
    layout, nq, nk = _check_launch("flash_fwd", q, {"k": k, "v": v}, hkv=hkv,
                                   sk=sk, block_q=block_q, block_k=block_k,
                                   block_layout=block_layout,
                                   page_size=block_k if paged else None)
    qs = (q * scale).contiguous()   # the scale folded into q, in q's dtype
    k, v = k.contiguous(), v.contiguous()
    kvm = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    q_seg, kv_seg, q_pos, kv_pos = map(_i32, (q_seg, kv_seg, q_pos, kv_pos))
    page_list = _i32(page_list)
    o = torch.empty_like(qs)
    m = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    name = "flash_fwd_paged" if paged else "flash_fwd"
    body = forward_body(on_card=True, dtype=q.dtype, head_dim=d,
                        block_q=block_q, block_k=block_k, paged=paged, nq=nq,
                        nk=nk)
    sm90 = body == "sm90" and not mma_body
    if sm90:
        # TMA and the bulk copies address whole 16-byte units; kv_mask goes
        # as int32, the row vectors' type
        k, v = map(_aligned, (k, v))
        kvm = None if kvm is None else kvm.to(torch.int32)
        kvm, kv_seg, kv_pos = map(_aligned, (kvm, kv_seg, kv_pos))
    args = (_DTYPES[q.dtype], int(paged), d,
            _ptr(qs), _ptr(k), _ptr(v), _ptr(o), _ptr(m), _ptr(l),
            _ptr(layout), nq * nk if layout.ndim == 3 else 0,
            _ptr(kvm), _ptr(q_seg), _ptr(kv_seg), _ptr(q_pos), _ptr(kv_pos),
            _ptr(page_list),
            b, hq, hkv, sq, sk, nq, nk, block_q, block_k, num_pages,
            int(bool(causal)), -1 if window is None else int(window),
            int(q_offset), -1 if kv_valid_len is None else int(kv_valid_len),
            int(variant == "paper"), *dropout,
            torch.cuda.current_stream(q.device).cuda_stream)
    if sm90:
        name += "_sm90"
        sms = _num_sms(q.device)
        tiles = -(-sk // MAX_TILE)
        lib = _fwd_sm90_lib()
        err = lib.flash_fwd_sm90(*args, sm90_fwd_rows(b, hq, nq, sms),
                                 sm90_fwd_splits(b, hq, nq, tiles, sms))
        build.check(err, lib, "flash_fwd_sm90_error_string", name)
    else:
        lib = _lib()
        err = lib.flash_fwd(*args)
        build.check(err, lib, "flash_fwd_error_string", name)
    LAUNCHES[name] += 1
    return o, m, l


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_mask: torch.Tensor | None,
    block_layout: torch.Tensor,
    *,
    scale: float, causal: bool, window: int | None, q_offset: int,
    kv_valid_len: int | None = None,
    dropout_p: float = 0.0, dropout_seed=0,
    dropout_dims: tuple[int, int] | None = None,
    dropout_coords: tuple[int, int, int] | None = None,
    block_q: int, block_k: int, variant: str = "fa2",
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    _mma_body: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (o, m, l). q (b,hq,sq,d), k/v (b,hkv,sk,d), kv_mask (b, sk)
    or None; sq % block_q == 0 and sk % block_k == 0 (ops.py pads).
    ``block_layout`` is the compiled (nq, nk) or (b, nq, nk) layout;
    ``dropout_dims`` = (unpadded sq, sk) keeps the dropout hash independent
    of padding. On the card the body is ``forward_body``'s; ``_mma_body``
    forces flash_fwd.cu's on an sm90 call (the card's tests and chip_smoke
    hold the two bodies against each other)."""
    if q_positions is not None and kv_valid_len is not None:
        raise ValueError("kv_valid_len cannot combine with q/kv_positions")
    _check_variant(variant)
    dropout = _dropout_args(dropout_p, dropout_seed, dropout_dims,
                            q.shape[2], k.shape[2], q.shape[1], dropout_coords)
    if not q.is_cuda:
        return flash_attention_forward_plain(
            q, k, v, kv_mask, block_layout, scale=scale, causal=causal,
            window=window, q_offset=q_offset, kv_valid_len=kv_valid_len,
            dropout_p=dropout_p, dropout_seed=dropout_seed,
            dropout_dims=dropout_dims, dropout_coords=dropout_coords,
            block_q=block_q, block_k=block_k, variant=variant,
            q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, q_positions=q_positions,
            kv_positions=kv_positions)
    out = _launch(paged=False, q=q, k=k, v=v, block_layout=block_layout,
                  kv_mask=kv_mask, q_seg=q_segment_ids, kv_seg=kv_segment_ids,
                  q_pos=q_positions, kv_pos=kv_positions, page_list=None,
                  scale=scale, causal=causal, window=window, q_offset=q_offset,
                  kv_valid_len=kv_valid_len, block_q=block_q, block_k=block_k,
                  sk=k.shape[2], num_pages=0, variant=variant,
                  dropout=dropout, mma_body=_mma_body)
    return out


@dataclasses.dataclass
class BackwardOperands:
    """The validated, contiguous operands of one backward call on the card
    (q pre-scaled, D = rowsum(dO∘O) computed), shared by the dq and the dkv
    kernel; it keeps every tensor alive while a kernel may read it."""
    dtype: int
    head_dim: int
    tensors: tuple      # (q', k, v, dO, m, l, D)
    extra: tuple        # layout, kv_mask, q_seg, kv_seg, q_pos, kv_pos
    args: tuple         # the C arguments after the outputs
    body: str = "mma"   # backward_body's choice
    grid: tuple = ()    # (b, hq, hkv, nq, nk)


def prepare_backward(q, k, v, o, do, m, l, kv_mask, block_layout, *, scale,
                     causal, window, q_offset, kv_valid_len=None,
                     dropout_p=0.0, dropout_seed=0, dropout_dims=None,
                     dropout_coords=None, block_q, block_k, q_segment_ids=None,
                     kv_segment_ids=None, q_positions=None,
                     kv_positions=None, page_list=None) -> BackwardOperands:
    """Check and lay out a backward call for ``launch_dq``/``launch_dkv``,
    or, given a ``page_list``, for ``launch_dq_paged``/``launch_dkv_paged``
    (k, v are then pools (hkv, num_pages, block_k, d))."""
    b, hq, sq, d = q.shape
    if page_list is None:
        _, hkv, sk, _ = k.shape
    else:
        hkv, num_pages = k.shape[0], k.shape[1]
        sk = page_list.shape[1] * block_k
        if k.shape[2] != block_k or page_list.shape[0] != b:
            raise ValueError("flash_bwd paged: the layout block is one page "
                             "and page_list is (b, T)")
        if q.dtype == torch.bfloat16:
            # the tensor-core pair gathers whole pages into 64-key tiles
            fwd_pages_per_tile(block_k)
    dropout = _dropout_args(dropout_p, dropout_seed, dropout_dims, sq, sk, hq,
                            dropout_coords)
    layout, nq, nk = _check_launch(
        "flash_bwd", q, {"k": k, "v": v, "o": o, "do": do}, hkv=hkv, sk=sk,
        block_q=block_q, block_k=block_k, block_layout=block_layout)
    if attention_working_set_bytes(
            block_q, block_k, d, bf16=q.dtype == torch.bfloat16,
            paged=page_list is not None) > SMEM_PER_BLOCK:
        raise ValueError(f"flash_bwd tiles ({block_q}, {block_k}) exceed "
                         f"shared memory at head_dim {d}")
    for name, t in (("m", m), ("l", l)):
        if t.dtype != torch.float32 or t.shape != (b, hq, sq):
            raise ValueError(f"flash_bwd: {name} must be float32 "
                             f"{(b, hq, sq)}")
    # D_i = rowsum(dO ∘ O) (Alg. 4 line 19), O(N d) at the PyTorch level
    # as in the JAX package
    dd = (do.float() * o.float()).sum(dim=-1).contiguous()
    tensors = tuple(map(_aligned, (
        (q * scale).contiguous(), k.contiguous(), v.contiguous(),
        do.contiguous(), m.contiguous(), l.contiguous(), dd)))
    kvm = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    extra = (layout, *map(_aligned, (kvm, *map(_i32, (
        q_segment_ids, kv_segment_ids, q_positions, kv_positions)))))
    args = (_ptr(layout), nq * nk if layout.ndim == 3 else 0,
            *map(_ptr, extra[1:]),
            b, hq, hkv, sq, sk, nq, nk, block_q, block_k,
            int(bool(causal)), -1 if window is None else int(window),
            int(q_offset), -1 if kv_valid_len is None else int(kv_valid_len),
            *dropout, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if page_list is not None:
        page_list = _i32(page_list)
        extra += (page_list,)
        args += (_ptr(page_list), num_pages)
    body = backward_body(on_card=True, dtype=q.dtype, head_dim=d,
                         block_q=block_q, block_k=block_k,
                         paged=page_list is not None, nq=nq, nk=nk)
    return BackwardOperands(_DTYPES[q.dtype], d, tensors, extra, args, body,
                            (b, hq, hkv, nq, nk))


def launch_dq(ops: BackwardOperands, *, _mma_body: bool = False
              ) -> torch.Tensor:
    """The dq kernel: dq in q's dtype, (b, hq, sq, d). ``ops.body`` picks
    the body; ``_mma_body`` forces flash_bwd.cu's on an sm90 call (the
    card's tests and chip_smoke hold the two bodies against each other)."""
    dq = torch.empty_like(ops.tensors[0])
    if ops.body == "sm90" and not _mma_body:
        b, hq, _, nq, _ = ops.grid
        lib = _sm90_lib()
        err = lib.flash_bwd_sm90_dq(
            ops.dtype, ops.head_dim, *map(_ptr, ops.tensors), _ptr(dq), None,
            *ops.args, sm90_bwd_rows(b, hq, nq, _num_sms(dq.device)))
        build.check(err, lib, "flash_bwd_sm90_error_string",
                    "flash_bwd_dq_sm90")
        LAUNCHES["flash_bwd_dq_sm90"] += 1
        return dq
    lib = _bwd_lib()
    err = lib.flash_bwd_dq(ops.dtype, ops.head_dim, *map(_ptr, ops.tensors),
                           _ptr(dq), None, *ops.args)
    build.check(err, lib, "flash_bwd_error_string", "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def launch_dkv(ops: BackwardOperands, *, _mma_body: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dkv kernel: dk, dv summed over each GQA group, in k's dtype;
    ``_mma_body`` as in ``launch_dq``."""
    dk = torch.empty_like(ops.tensors[1])
    dv = torch.empty_like(ops.tensors[2])
    if ops.body == "sm90" and not _mma_body:
        b, _, hkv, _, nk = ops.grid
        lib = _sm90_lib()
        err = lib.flash_bwd_sm90_dkv(
            ops.dtype, ops.head_dim, *map(_ptr, ops.tensors), _ptr(dk),
            _ptr(dv), *ops.args,
            sm90_bwd_rows(b, hkv, nk, _num_sms(dk.device), kernel="dkv",
                          head_dim=ops.head_dim))
        build.check(err, lib, "flash_bwd_sm90_error_string",
                    "flash_bwd_dkv_sm90")
        LAUNCHES["flash_bwd_dkv_sm90"] += 1
        return dk, dv
    lib = _bwd_lib()
    err = lib.flash_bwd_dkv(ops.dtype, ops.head_dim, *map(_ptr, ops.tensors),
                            _ptr(dk), _ptr(dv), *ops.args)
    build.check(err, lib, "flash_bwd_error_string", "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _page_groups(ops: BackwardOperands) -> int:
    """The 64-key page groups of a paged call: the sm90 dkv grid's key axis."""
    T, ps = ops.extra[-1].shape[1], ops.tensors[1].shape[2]
    return -(-T * ps // MAX_TILE)


def launch_dq_paged(ops: BackwardOperands, *, _mma_body: bool = False
                    ) -> torch.Tensor:
    """The paged dq kernel: dq in q's dtype, (b, hq, sq, d). ``ops.body``
    picks the body; ``_mma_body`` forces flash_bwd.cu's on an sm90 call
    (the card's tests and chip_smoke hold the two bodies against each
    other)."""
    dq = torch.empty_like(ops.tensors[0])
    if ops.body == "sm90" and not _mma_body:
        b, hq, _, nq, _ = ops.grid
        lib = _sm90_lib()
        err = lib.flash_bwd_sm90_dq_paged(
            ops.dtype, ops.head_dim, *map(_ptr, ops.tensors), _ptr(dq), None,
            *ops.args, sm90_bwd_rows(b, hq, nq, _num_sms(dq.device)))
        build.check(err, lib, "flash_bwd_sm90_error_string",
                    "flash_bwd_dq_paged_sm90")
        LAUNCHES["flash_bwd_dq_paged_sm90"] += 1
        return dq
    lib = _bwd_lib()
    err = lib.flash_bwd_dq_paged(ops.dtype, ops.head_dim,
                                 *map(_ptr, ops.tensors), _ptr(dq), None,
                                 *ops.args)
    build.check(err, lib, "flash_bwd_error_string", "flash_bwd_dq_paged")
    LAUNCHES["flash_bwd_dq_paged"] += 1
    return dq


def launch_fold_paged(dk: torch.Tensor, dv: torch.Tensor,
                      page_list: torch.Tensor, num_pages: int,
                      dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The fold kernel: the paged dkv kernel's fp32 packed rows (b, hkv,
    T*ps, d) -> (dk_pool, dv_pool) of shape (hkv, num_pages, ps, d) in
    ``dtype``, summed per page in ``fold_order``; pages no slot names are
    zero. Its plain version is ``fold_packed_to_pool``."""
    b, hkv, rows, d = dk.shape
    T = page_list.shape[1]
    ps = rows // T
    pages, slots = fold_order(page_list, num_pages)
    dk_pool = torch.zeros((hkv, num_pages, ps, d), dtype=dtype,
                          device=dk.device)
    dv_pool = torch.zeros_like(dk_pool)
    lib = _bwd_lib()
    err = lib.flash_bwd_fold_paged(
        _DTYPES[dtype], _ptr(dk), _ptr(dv), _ptr(pages), _ptr(slots),
        _ptr(dk_pool), _ptr(dv_pool), b * T, T, hkv, ps * d, num_pages,
        torch.cuda.current_stream(dk.device).cuda_stream)
    build.check(err, lib, "flash_bwd_error_string", "flash_bwd_fold_paged")
    LAUNCHES["flash_bwd_fold_paged"] += 1
    return dk_pool, dv_pool


def launch_dkv_paged(ops: BackwardOperands, *, _mma_body: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The paged dkv kernel: fp32 dk, dv summed over each GQA group in the
    packed page-aligned layout (b, hkv, T*ps, d); ``_mma_body`` as in
    ``launch_dq_paged``."""
    q, k_pool = ops.tensors[0], ops.tensors[1]
    T, ps = ops.extra[-1].shape[1], k_pool.shape[2]
    shape = (q.shape[0], k_pool.shape[0], T * ps, ops.head_dim)
    dk = torch.empty(shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if ops.body == "sm90" and not _mma_body:
        b, _, hkv, _, _ = ops.grid
        lib = _sm90_lib()
        err = lib.flash_bwd_sm90_dkv_paged(
            ops.dtype, ops.head_dim, *map(_ptr, ops.tensors), _ptr(dk),
            _ptr(dv), *ops.args,
            sm90_bwd_rows(b, hkv, _page_groups(ops), _num_sms(dk.device),
                          kernel="dkv", head_dim=ops.head_dim))
        build.check(err, lib, "flash_bwd_sm90_error_string",
                    "flash_bwd_dkv_paged_sm90")
        LAUNCHES["flash_bwd_dkv_paged_sm90"] += 1
        return dk, dv
    lib = _bwd_lib()
    err = lib.flash_bwd_dkv_paged(ops.dtype, ops.head_dim,
                                  *map(_ptr, ops.tensors), _ptr(dk), _ptr(dv),
                                  *ops.args)
    build.check(err, lib, "flash_bwd_error_string", "flash_bwd_dkv_paged")
    LAUNCHES["flash_bwd_dkv_paged"] += 1
    return dk, dv


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
    kv_mask: torch.Tensor | None,
    block_layout: torch.Tensor,
    *,
    scale: float, causal: bool, window: int | None, q_offset: int,
    kv_valid_len: int | None = None,
    dropout_p: float = 0.0, dropout_seed=0,
    dropout_dims: tuple[int, int] | None = None,
    dropout_coords: tuple[int, int, int] | None = None,
    block_q: int, block_k: int,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dq, dk, dv), dk and dv already summed over each GQA group,
    from the forward's residuals (o, m, l) and the SAME compiled layout.
    On the card: D = rowsum(dO∘O) in PyTorch, then the dq kernel (one CTA
    per (b, hq, q tile)) and the dkv kernel (one CTA per (b, hkv, kv
    tile), group-summed in registers, no atomics: two calls are
    bit-identical), on the body ``backward_body`` names: in bf16 on the
    tensor cores (wgmma at d 64 / 96 / 128 over 64 x 64 blocks, mma.sync
    otherwise), in fp32 the scalar body (the card's parity mode)."""
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              kv_valid_len=kv_valid_len, dropout_p=dropout_p,
              dropout_seed=dropout_seed, dropout_dims=dropout_dims,
              dropout_coords=dropout_coords, block_q=block_q, block_k=block_k,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              q_positions=q_positions, kv_positions=kv_positions)
    if not q.is_cuda:
        return flash_attention_backward_plain(q, k, v, o, do, m, l, kv_mask,
                                              block_layout, **kw)
    ops = prepare_backward(q, k, v, o, do, m, l, kv_mask, block_layout, **kw)
    return (launch_dq(ops), *launch_dkv(ops))


def flash_prefill_paged_forward(
    q: torch.Tensor,             # (b, hq, sq, d) — sq % block_q == 0
    k_pool: torch.Tensor,        # (hkv, num_pages, page_size, d)
    v_pool: torch.Tensor,
    page_list: torch.Tensor,     # (b, T) int32 physical pages; negative = dead
    block_layout: torch.Tensor,  # (b, nq, T) compiled classes (paged-aware)
    *,
    scale: float, causal: bool, window: int | None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    block_q: int, variant: str = "fa2",
    _mma_body: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (o, m, l) computed directly against pool pages: logical row
    ``t*ps + r`` is row r of page ``page_list[b, t]``; masking is
    position-based. The layout is per page; the bf16 kernels gather
    ``tuning.fwd_pages_per_tile(ps)`` pages into one 64-key tile, so the
    page size must be 8, 16, 32 or 64 (any other raises before launch).
    The body is ``forward_body``'s (``_mma_body`` as in
    ``flash_attention_forward``)."""
    _check_variant(variant)
    if not q.is_cuda:
        return flash_prefill_paged_forward_plain(
            q, k_pool, v_pool, page_list, block_layout, scale=scale,
            causal=causal, window=window, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, q_positions=q_positions,
            kv_positions=kv_positions, block_q=block_q, variant=variant)
    hkv, num_pages, ps, _ = k_pool.shape
    T = page_list.shape[1]
    if block_layout.ndim != 3 or block_layout.shape[-1] != T:
        raise ValueError("the paged layout is (b, nq, T)")
    out = _launch(paged=True, q=q, k=k_pool, v=v_pool,
                  block_layout=block_layout, kv_mask=None,
                  q_seg=q_segment_ids, kv_seg=kv_segment_ids,
                  q_pos=q_positions, kv_pos=kv_positions,
                  page_list=page_list, scale=scale, causal=causal,
                  window=window, q_offset=0, kv_valid_len=None,
                  block_q=block_q, block_k=ps, sk=T * ps,
                  num_pages=num_pages, variant=variant,
                  dropout=_dropout_args(0.0, 0, None, 0, 0, 0),
                  mma_body=_mma_body)
    return out


def flash_prefill_paged_backward(
    q: torch.Tensor,             # (b, hq, sq, d) — sq % block_q == 0
    k_pool: torch.Tensor,        # (hkv, num_pages, page_size, d)
    v_pool: torch.Tensor,
    page_list: torch.Tensor,     # (b, T) int32 physical pages; negative = dead
    o: torch.Tensor, do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
    block_layout: torch.Tensor,  # (b, nq, T): the forward's layout
    *,
    scale: float, causal: bool, window: int | None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    block_q: int,
    _mma_body: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dq, dk_pool, dv_pool) of the paged prefill from the
    forward's residuals: dq in q's dtype, the pool gradients in the pools'
    dtype. On the card: D = rowsum(dO∘O) in PyTorch, the paged dq kernel
    (one CTA per (b, hq, q-block), kv pages through ``page_list``), the
    paged dkv kernel (one CTA per (b, hkv, 64-key page group), GQA group
    summed in registers, packed fp32 rows), then the fold kernel into pool
    shape; nothing on that path waits on the card. The pair runs on the
    body ``backward_body`` names (``_mma_body`` forces flash_bwd.cu's on an
    sm90 call): in bf16 on the tensor cores (wgmma at d 64 / 96 / 128 over
    64-row q blocks, mma.sync otherwise), gathering
    ``tuning.fwd_pages_per_tile(ps)`` pages into a 64-key tile, so the page
    size must be 8, 16, 32 or 64 (any other raises before launch)."""
    kw = dict(scale=scale, causal=causal, window=window,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              q_positions=q_positions, kv_positions=kv_positions,
              block_q=block_q)
    if not q.is_cuda:
        return flash_prefill_paged_backward_plain(
            q, k_pool, v_pool, page_list, o, do, m, l, block_layout, **kw)
    num_pages, ps = k_pool.shape[1], k_pool.shape[2]
    if block_layout.ndim != 3 or block_layout.shape[-1] != page_list.shape[1]:
        raise ValueError("the paged layout is (b, nq, T)")
    ops = prepare_backward(q, k_pool, v_pool, o, do, m, l, None, block_layout,
                           q_offset=0, block_k=ps, page_list=page_list, **kw)
    dq = launch_dq_paged(ops, _mma_body=_mma_body)
    dk, dv = launch_dkv_paged(ops, _mma_body=_mma_body)
    return (dq, *launch_fold_paged(dk, dv, ops.extra[-1], num_pages,
                                   k_pool.dtype))
