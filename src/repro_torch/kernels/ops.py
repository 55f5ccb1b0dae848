"""Public entry points of the attention kernels (port of
``repro.kernels.ops``).

Both ops are differentiable. ``flash_attention``: a
``torch.autograd.Function`` around the padded core saves q, k, v, o, m, l,
the compiled layout and the id/position tensors (the paper's O(N)
residuals) and its backward runs ``flash_attention_backward`` — the dq and
dkv kernels on a CUDA tensor, their plain version on a CPU tensor.
``flash_prefill_paged``: the same around the paged core; its backward runs
``flash_prefill_paged_backward`` (the paged dq and dkv kernels, then the
deterministic fold of the packed dk/dv into pool shape) and returns
gradients for q and both pools only (integer inputs get none). Padding
(``F.pad``) and the final slice stay outside the Functions, so autograd
carries their gradients. Each call's masks are compiled ONCE into the
block layout the kernels consume (``core.masks.compile_block_layout``),
under ``torch.no_grad()``, and the backward reuses it.

Tiles left ``None`` resolve through ``tuning.resolve_tiles`` (the
analytic chooser, or the autotuner when ``tuning.configure_tuning(
autotune=True)``), keyed by the call's mask class, head counts, the
tensor-parallel ``shards`` of the calling step, and whether the call is
trainable (a trainable call resolves the tiles its backward runs too). An
Alg. 5 ``block_layout`` (a static (nq, nk) sparse pattern) fixes the
block grid, as in the JAX package: ``block_q = ceil(sq / nq)``,
``block_k = ceil(sk / nk)``. A block above the kernels' 64-row tile that
is a multiple of it is refined exactly (``tuning.sparse_tile``,
``masks.refine_block_layout``); any other raises on a CUDA tensor.

The JAX package's kv-major re-layout (the whole GQA query group resident
in one block, ``block_q = n_rep * sq``) is not ported: it is a TPU VMEM
choice that does not fit Hopper shared memory, and the loop order is the
CUDA kernel's own business.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.masks import (MaskSpec, POS_PAD, SEG_PAD_KV, SEG_PAD_Q,
                                    compile_block_layout,
                                    paged_prefill_block_layout,
                                    refine_block_layout, resolve_segment_ids)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as kref
from repro_torch.kernels import tuning


class _FlashCore(torch.autograd.Function):
    """The padded core: forward kernel, residuals, backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_seg, kv_seg, q_pos, kv_pos, layout,
                call):
        o, m, l = fa.flash_attention_forward(
            q, k, v, kv_mask, layout, q_segment_ids=q_seg,
            kv_segment_ids=kv_seg, q_positions=q_pos, kv_positions=kv_pos,
            **call)
        ctx.save_for_backward(q, k, v, o, m, l, kv_mask, q_seg, kv_seg,
                              q_pos, kv_pos, layout)
        ctx.call = call
        return o

    @staticmethod
    def backward(ctx, do):
        (q, k, v, o, m, l, kv_mask, q_seg, kv_seg, q_pos, kv_pos,
         layout) = ctx.saved_tensors
        call = {n: x for n, x in ctx.call.items() if n != "variant"}
        dq, dk, dv = fa.flash_attention_backward(
            q, k, v, o, do, m, l, kv_mask, layout, q_segment_ids=q_seg,
            kv_segment_ids=kv_seg, q_positions=q_pos, kv_positions=kv_pos,
            **call)
        return dq, dk, dv, None, None, None, None, None, None, None


class _PagedCore(torch.autograd.Function):
    """The padded paged core: paged forward kernel, residuals, paged
    backward kernels."""

    @staticmethod
    def forward(ctx, q, k_pool, v_pool, page_list, q_seg, kv_seg, q_pos,
                kv_pos, layout, call):
        o, m, l = fa.flash_prefill_paged_forward(
            q, k_pool, v_pool, page_list, layout, q_segment_ids=q_seg,
            kv_segment_ids=kv_seg, q_positions=q_pos, kv_positions=kv_pos,
            **call)
        ctx.save_for_backward(q, k_pool, v_pool, page_list, o, m, l, q_seg,
                              kv_seg, q_pos, kv_pos, layout)
        ctx.call = call
        return o

    @staticmethod
    def backward(ctx, do):
        (q, k_pool, v_pool, page_list, o, m, l, q_seg, kv_seg, q_pos, kv_pos,
         layout) = ctx.saved_tensors
        call = {n: x for n, x in ctx.call.items() if n != "variant"}
        dq, dk_pool, dv_pool = fa.flash_prefill_paged_backward(
            q, k_pool, v_pool, page_list, o, do, m, l, layout,
            q_segment_ids=q_seg, kv_segment_ids=kv_seg, q_positions=q_pos,
            kv_positions=kv_pos, **call)
        return (dq, dk_pool, dv_pool, None, None, None, None, None, None,
                None)


def _pad_seq(x: torch.Tensor, axis: int, mult: int, value=0):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x, 0
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths, value=value), pad


def _trainable(*tensors) -> bool:
    """Will autograd run this call's backward?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(
    q: torch.Tensor,                      # (b, hq, sq, d)
    k: torch.Tensor,                      # (b, hkv, sk, d)
    v: torch.Tensor,                      # (b, hkv, sk, d)
    *,
    kv_mask: torch.Tensor | None = None,  # (b, sk) True = valid
    causal: bool = False,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int | None = None,
    block_q: int | None = None,           # None = tuning.resolve_tiles
    block_k: int | None = None,
    dropout_p: float = 0.0,
    dropout_seed=0,
    dropout_coords: tuple[int, int, int] | None = None,  # (b0, h0, H)
    variant: str = "fa2",
    block_layout=None,                    # (nq, nk) uint8 sparse pattern (Alg. 5)
    segment_ids: torch.Tensor | None = None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    shards: int = 1,                      # tensor-parallel shards (tuning)
) -> torch.Tensor:
    """Differentiable FlashAttention. Pads seq dims to block multiples; GQA
    from head counts. Padded tails take sentinel segments (q/kv pads
    differ) and POS_PAD positions, so padded rows come out fully masked.
    ``q_offset`` defaults to ``sk - sq``; positions are dropped when no
    geometric term uses them (the cheaper static-layout path). Dropout
    hashes buffer coordinates with the unpadded (sq, sk) as strides, at
    ``dropout_coords`` (b0, h0, H) of a global batch (a sharded step's
    rank; default (0, 0, hq)).
    ``block_layout`` is an Alg. 5 sparse pattern, authoritative over the
    geometry (its FULL blocks run unmasked, causal or not); its grid fixes
    the blocks (see the module docstring)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    q_seg, kv_seg = resolve_segment_ids(segment_ids, q_segment_ids,
                                        kv_segment_ids, sq, sk)
    if (q_positions is None) != (kv_positions is None):
        raise ValueError(
            "q_positions and kv_positions must be passed together")
    if q_positions is not None and not (causal or window is not None):
        q_positions = kv_positions = None
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q_offset is None:
        q_offset = sk - sq
    if block_layout is not None:
        # the pattern's grid is the tile decision
        nq_s, nk_s = np.asarray(block_layout).shape
        block_q = -(-sq // nq_s) if block_q is None else block_q
        block_k = -(-sk // nk_s) if block_k is None else block_k
    if block_q is None or block_k is None:
        tiles = tuning.resolve_tiles(
            block_q, block_k, sq=sq, sk=sk, head_dim=d, dtype=q.dtype,
            heads_q=hq, heads_kv=hkv, shards=shards,
            backward=_trainable(q, k, v), device=q.device,
            mask_class=tuning.mask_class_of(
                causal=causal, window=window,
                has_kv_mask=kv_mask is not None,
                has_segments=q_seg is not None,
                has_sparse=block_layout is not None,
                has_positions=q_positions is not None))
        block_q, block_k = tiles.block_q, tiles.block_k
    block_q = tuning.round_block(block_q, sq)
    block_k = tuning.round_block(block_k, sk)

    # pad to the pattern's blocks, then cut them into kernel tiles
    pad_q, pad_k = block_q, block_k
    if block_layout is not None:
        block_q, rq = tuning.sparse_tile(block_q, q.is_cuda)
        block_k, rk = tuning.sparse_tile(block_k, q.is_cuda)
        block_layout = refine_block_layout(block_layout, rq, rk)

    qp, qpad = _pad_seq(q, 2, pad_q)
    kp, kpad = _pad_seq(k, 2, pad_k)
    vp, _ = _pad_seq(v, 2, pad_k)
    with torch.no_grad():
        kvm = None
        if kv_mask is not None:
            kvm, _ = _pad_seq(kv_mask, 1, pad_k, value=False)
        if q_seg is not None:
            q_seg, _ = _pad_seq(q_seg.to(torch.int32), 1, pad_q, SEG_PAD_Q)
            kv_seg, _ = _pad_seq(kv_seg.to(torch.int32), 1, pad_k,
                                 SEG_PAD_KV)
        if q_positions is not None:
            # POS_PAD keys are causally unreachable from real queries, so
            # the kv padding tail self-masks.
            q_positions, _ = _pad_seq(q_positions.to(torch.int32), 1,
                                      pad_q, POS_PAD)
            kv_positions, _ = _pad_seq(kv_positions.to(torch.int32), 1,
                                       pad_k, POS_PAD)
        has_pos = q_positions is not None
        spec = MaskSpec(
            causal=causal, window=window,
            q_offset=0 if has_pos else q_offset,
            kv_valid_len=None if has_pos else (sk if kpad else None),
            kv_mask=kvm, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
            q_positions=q_positions, kv_positions=kv_positions,
            sparse_layout=block_layout)
        layout = compile_block_layout(spec, qp.shape[2], kp.shape[2],
                                      block_q, block_k).as_array(q.device)
    call = dict(scale=scale, causal=causal, window=window,
                q_offset=spec.q_offset, kv_valid_len=spec.kv_valid_len,
                dropout_p=dropout_p, dropout_seed=dropout_seed,
                dropout_dims=(sq, sk), dropout_coords=dropout_coords,
                block_q=block_q, block_k=block_k,
                variant=variant)
    o = _FlashCore.apply(qp, kp, vp, kvm, q_seg, kv_seg, q_positions,
                         kv_positions, layout, call)
    return o[:, :, :sq]


def flash_prefill_paged(
    q: torch.Tensor,             # (b, hq, sq, d)
    k_pool: torch.Tensor,        # (hkv, num_pages, page_size, d)
    v_pool: torch.Tensor,
    page_list: torch.Tensor,     # (b, T) int32; negative = dead slot (SKIP)
    *,
    q_positions: torch.Tensor,   # (b, sq) logical positions
    kv_positions: torch.Tensor,  # (b, T*page_size); POS_PAD on dead rows
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    block_q: int | None = None,
    variant: str = "fa2",
    shards: int = 1,             # tensor-parallel shards (tuning)
) -> torch.Tensor:
    """Differentiable FlashAttention over a PAGED kv prefix, read in place:
    logical kv row ``t*page_size + r`` is row r of physical page
    ``page_list[b, t]``; no gather materializes it. Causal/window masking
    compares LOGICAL positions, so positions are required; dead kv rows
    carry POS_PAD (and SEG_PAD_KV), which the layout compiler turns into
    SKIP pages, and dead slots get no gradient. ``block_q`` None resolves
    through ``tuning.resolve_tiles`` with the page as the pinned kv
    block."""
    b, hq, sq, d = q.shape
    hkv, num_pages, ps, _ = k_pool.shape
    if hq % hkv != 0:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if page_list.ndim != 2 or page_list.shape[0] != b:
        raise ValueError(f"page_list must be (batch, T), got "
                         f"{tuple(page_list.shape)}")
    T = page_list.shape[1]
    sk = T * ps
    if tuple(kv_positions.shape) != (b, sk):
        raise ValueError(
            f"kv_positions must be (batch, T*page_size)=({b}, {sk}), got "
            f"{tuple(kv_positions.shape)}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("segment ids must be passed together")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if block_q is None:
        block_q = tuning.resolve_tiles(
            None, ps, sq=sq, sk=sk, head_dim=d, dtype=q.dtype, heads_q=hq,
            heads_kv=hkv, shards=shards, paged=True,
            backward=_trainable(q, k_pool, v_pool), device=q.device,
            mask_class=tuning.mask_class_of(
                causal=causal, window=window,
                has_segments=q_segment_ids is not None,
                has_positions=True)).block_q
    block_q = tuning.round_block(block_q, sq)

    qp, _ = _pad_seq(q, 2, block_q)
    with torch.no_grad():
        page_list = page_list.to(torch.int32)
        q_positions, _ = _pad_seq(q_positions.to(torch.int32), 1, block_q,
                                  POS_PAD)
        kv_positions = kv_positions.to(torch.int32)
        if q_segment_ids is not None:
            q_segment_ids, _ = _pad_seq(q_segment_ids.to(torch.int32), 1,
                                        block_q, SEG_PAD_Q)
            kv_segment_ids = kv_segment_ids.to(torch.int32)
        spec = MaskSpec(causal=causal, window=window, q_offset=0,
                        q_segment_ids=q_segment_ids,
                        kv_segment_ids=kv_segment_ids,
                        q_positions=q_positions, kv_positions=kv_positions)
        layout = compile_block_layout(spec, qp.shape[2], sk, block_q,
                                      ps).as_array(q.device)
        layout = paged_prefill_block_layout(layout, page_list)
    call = dict(scale=scale, causal=causal, window=window, block_q=block_q,
                variant=variant)
    o = _PagedCore.apply(qp, k_pool, v_pool, page_list, q_segment_ids,
                         kv_segment_ids, q_positions, kv_positions, layout,
                         call)
    return o[:, :, :sq]


# the reference entry points re-exported, as the reference's ops does, so
# that benchmarks and tests import everything from ops
standard_attention = kref.standard_attention
chunked_attention = kref.chunked_attention
