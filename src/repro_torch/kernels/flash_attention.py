"""FlashAttention forward: hand-written Hopper kernel + its plain version
(port of the forward half of ``repro.kernels.flash_attention``).

``flash_attention_forward`` (contiguous K/V) and
``flash_prefill_paged_forward`` (K/V read in place from page-pool pages
through a page list) return ``(o, m, l)`` exactly as the Pallas kernels do:
o in the input dtype, per-row max m and normalizer l in fp32, rows with no
unmasked key at o = 0, l = 0, m = NEG_INF. Both take the COMPILED block
layout (``core.masks.compile_block_layout``) as the single source of
block-run truth and fold the softmax scale into q once, in q's dtype,
before the kernel.

On a CUDA tensor each wrapper launches ``csrc/flash_fwd.cu`` (built at
first use, see ``kernels/build.py``) and counts the launch in
``LAUNCHES``; on a CPU tensor it runs the plain version beside it, which
computes the same function (layout included) densely in fp32. There is no
fallback between the two. The backward kernels, dropout and the "paper"
accumulator variant wait for the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import masks as M
from repro_torch.core.masks import NEG_INF
from repro_torch.kernels import build
from repro_torch.kernels.ref import gather_pages, repeat_kv
from repro_torch.kernels.tuning import KERNEL_HEAD_DIMS, MAX_TILE

# launches of the CUDA kernel per wrapper (never counts plain-version calls)
LAUNCHES = {"flash_fwd": 0, "flash_fwd_paged": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("flash_fwd")
    if not getattr(lib, "_typed", False):
        c_int, c_p = ctypes.c_int, ctypes.c_void_p
        lib.flash_fwd.argtypes = ([c_int] * 3 + [c_p] * 7 + [ctypes.c_longlong]
                                  + [c_p] * 6 + [c_int] * 14 + [c_p])
        lib.flash_fwd.restype = c_int
        lib._typed = True
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_common(q, dropout_p, variant):
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout comes with the training slice")
    if variant not in ("fa2", "paper"):
        raise ValueError(f"unknown variant {variant!r}")
    if q.is_cuda and variant != "fa2":
        raise NotImplementedError(
            "the CUDA forward implements the fa2 accumulator; variant="
            "'paper' comes with the training slice")


# ---------------------------------------------------------------------------
# plain version (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _expand_layout(layout, block_q, block_k, sq, sk):
    qb = torch.arange(sq, device=layout.device) // block_q
    kb = torch.arange(sk, device=layout.device) // block_k
    return layout[..., qb[:, None], kb[None, :]]


def flash_attention_forward_plain(
    q, k, v, kv_mask, block_layout, *, scale, causal, window, q_offset,
    kv_valid_len=None, dropout_p=0.0, block_q, block_k, variant="fa2",
    q_segment_ids=None, kv_segment_ids=None, q_positions=None,
    kv_positions=None,
):
    """Dense fp32 computation of exactly the kernel's function: the layout
    decides which tiles run (SKIP none, FULL unmasked, PARTIAL the fused
    mask, PARTIAL_DATA its data terms), then one masked softmax."""
    _check_common(q, dropout_p, variant)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dev = q.device
    qs = (q * scale).float()
    kf = repeat_kv(k, hq // hkv).float()
    vf = repeat_kv(v, hq // hkv).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)

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
    if allowed.ndim == 3:
        allowed = allowed[:, None]
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    o = (p @ vf) / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return o.to(q.dtype), m, l


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


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _i32(t):
    return None if t is None else t.to(torch.int32).contiguous()


def _launch(*, paged, q, k, v, block_layout, kv_mask, q_seg, kv_seg, q_pos,
            kv_pos, page_list, scale, causal, window, q_offset, kv_valid_len,
            block_q, block_k, sk, num_pages):
    b, hq, sq, d = q.shape
    hkv = k.shape[0] if paged else k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_fwd takes float32 or bfloat16, got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd head_dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if not (0 < block_q <= MAX_TILE and 0 < block_k <= MAX_TILE):
        raise ValueError(f"flash_fwd tiles must be <= {MAX_TILE}, got "
                         f"({block_q}, {block_k})")
    if sq % block_q or sk % block_k or hq % hkv:
        raise ValueError("flash_fwd needs sq % block_q == sk % block_k == 0 "
                         "and hq % hkv == 0 (ops.py pads)")
    nq, nk = sq // block_q, sk // block_k
    layout = block_layout.to(device=q.device, dtype=torch.int32).contiguous()
    if layout.shape[-2:] != (nq, nk) or layout.ndim not in (2, 3):
        raise ValueError(f"layout shape {tuple(layout.shape)} does not match "
                         f"the ({nq}, {nk}) block grid")
    qs = (q * scale).contiguous()   # the scale folded into q, in q's dtype
    k, v = k.contiguous(), v.contiguous()
    kvm = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    q_seg, kv_seg, q_pos, kv_pos = map(_i32, (q_seg, kv_seg, q_pos, kv_pos))
    page_list = _i32(page_list)
    o = torch.empty_like(qs)
    m = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = _lib()
    err = lib.flash_fwd(
        _DTYPES[q.dtype], int(paged), d,
        _ptr(qs), _ptr(k), _ptr(v), _ptr(o), _ptr(m), _ptr(l),
        _ptr(layout), nq * nk if layout.ndim == 3 else 0,
        _ptr(kvm), _ptr(q_seg), _ptr(kv_seg), _ptr(q_pos), _ptr(kv_pos),
        _ptr(page_list),
        b, hq, hkv, sq, sk, nq, nk, block_q, block_k, num_pages,
        int(bool(causal)), -1 if window is None else int(window),
        int(q_offset), -1 if kv_valid_len is None else int(kv_valid_len),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, lib, "flash_fwd_error_string", "flash_fwd")
    return o, m, l


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_mask: torch.Tensor | None,
    block_layout: torch.Tensor,
    *,
    scale: float, causal: bool, window: int | None, q_offset: int,
    kv_valid_len: int | None = None,
    dropout_p: float = 0.0,
    block_q: int, block_k: int, variant: str = "fa2",
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (o, m, l). q (b,hq,sq,d), k/v (b,hkv,sk,d), kv_mask (b, sk)
    or None; sq % block_q == 0 and sk % block_k == 0 (ops.py pads).
    ``block_layout`` is the compiled (nq, nk) or (b, nq, nk) layout."""
    if q_positions is not None and kv_valid_len is not None:
        raise ValueError("kv_valid_len cannot combine with q/kv_positions")
    if not q.is_cuda:
        return flash_attention_forward_plain(
            q, k, v, kv_mask, block_layout, scale=scale, causal=causal,
            window=window, q_offset=q_offset, kv_valid_len=kv_valid_len,
            dropout_p=dropout_p, block_q=block_q, block_k=block_k,
            variant=variant, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, q_positions=q_positions,
            kv_positions=kv_positions)
    _check_common(q, dropout_p, variant)
    out = _launch(paged=False, q=q, k=k, v=v, block_layout=block_layout,
                  kv_mask=kv_mask, q_seg=q_segment_ids, kv_seg=kv_segment_ids,
                  q_pos=q_positions, kv_pos=kv_positions, page_list=None,
                  scale=scale, causal=causal, window=window, q_offset=q_offset,
                  kv_valid_len=kv_valid_len, block_q=block_q, block_k=block_k,
                  sk=k.shape[2], num_pages=0)
    LAUNCHES["flash_fwd"] += 1
    return out


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (o, m, l) computed directly against pool pages: the kv tile
    is the page, logical row ``t*ps + r`` is row r of page
    ``page_list[b, t]``; masking is position-based."""
    if not q.is_cuda:
        return flash_prefill_paged_forward_plain(
            q, k_pool, v_pool, page_list, block_layout, scale=scale,
            causal=causal, window=window, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, q_positions=q_positions,
            kv_positions=kv_positions, block_q=block_q, variant=variant)
    _check_common(q, 0.0, variant)
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
                  num_pages=num_pages)
    LAUNCHES["flash_fwd_paged"] += 1
    return out
