"""Plain-PyTorch attention oracles (port of ``repro.kernels.ref``).

* ``standard_attention`` — Algorithm 0 of the paper: materializes S and P.
* ``chunked_attention`` — Algorithm 1 as a Python loop over kv chunks
  (online softmax, O(N) memory; FlashAttention's single-accumulator
  update). The ``chunked`` attention impl; ``pv_bf16`` rounds P and V to
  bf16 for P@V and sums in float32.
* ``window_banded_attention`` — causal sliding-window attention on a
  banded layout: q in chunks of W = window rows, each against [previous
  chunk | own chunk], one local softmax a chunk (score bytes s * 2W
  instead of s * s). The ``chunked`` impl's ``banded_window`` lever.

Both accept GQA, causal / sliding-window masks, a kv padding mask, packed
segment ids, logical positions and a softmax scale, with shapes
(batch, heads, seq, head_dim). Every mask term is evaluated through
``core.masks.element_mask`` — the same fused predicate the kernels apply
to PARTIAL blocks. ``standard_attention`` also applies attention dropout
through the counter-based keep mask the kernels share
(``dropout_keep_mask``), bit-identical to the JAX package's.
"""

from __future__ import annotations

import torch

from repro_torch.core import masks as M
from repro_torch.core.masks import resolve_segment_ids
from repro_torch.core.online_softmax import (NEG_INF, SoftmaxState,
                                             block_state, finalize,
                                             init_state, merge_states,
                                             pv_product)


M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x an int64 tensor of uint32 values and
    0 <= c < 2**32, split into 16-bit halves so no int64 product wraps."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 (the JAX package's
    ``_mix32``, and ``mix32`` in ``csrc/flash_common.cuh``)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_threshold(p_drop: float) -> int:
    """The uint32 keep threshold, computed in double precision exactly as
    the JAX package does: keep = hash >= threshold."""
    return int(p_drop * float(2**32 - 1))


def dropout_keep_mask(seed, b, h, q_pos, k_pos, p_drop: float,
                      num_heads: int, q_len: int, k_len: int) -> torch.Tensor:
    """Boolean keep mask from global coordinates (all broadcastable): a pure
    function of (seed, b, h, q, k), so the backward regenerates it.
    ``idx = ((b*H + h)*q_len + q)*k_len + k`` wraps at 32 bits, then
    ``r = mix32(idx ^ mix32(seed))``."""
    def u32(x):
        return torch.as_tensor(x).to(torch.int64) & M32

    idx = _mul32(_mul32(u32(b), num_heads & M32) + u32(h) & M32,
                 q_len & M32) + u32(q_pos) & M32
    idx = _mul32(idx, k_len & M32) + u32(k_pos) & M32
    r = _mix32(idx ^ _mix32(u32(seed)))
    return r >= dropout_threshold(p_drop)


def full_dropout_keep_mask(seed, batch: int, num_heads: int, q_len: int,
                           k_len: int, p_drop: float, device=None,
                           strides: tuple[int, int] | None = None,
                           coords: tuple[int, int, int] | None = None
                           ) -> torch.Tensor:
    """(batch, num_heads, q_len, k_len) keep mask. ``strides`` = the
    (q_len, k_len) of the hash when the tensor is a padded buffer (the
    kernels hash buffer coordinates with the unpadded lengths). ``coords``
    = (b0, h0, H): the tensor's rows and heads sit at b0 + b and h0 + h of
    a global batch of H heads (a rank of a sharded step); default (0, 0,
    num_heads)."""
    def ar(n, start=0):
        return torch.arange(start, start + n, dtype=torch.int64, device=device)

    q_stride, k_stride = strides if strides is not None else (q_len, k_len)
    b0, h0, heads = coords if coords is not None else (0, 0, num_heads)
    return dropout_keep_mask(
        seed, ar(batch, b0)[:, None, None, None],
        ar(num_heads, h0)[None, :, None, None],
        ar(q_len)[None, None, :, None], ar(k_len)[None, None, None, :],
        p_drop, heads, q_stride, k_stride)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, kv_heads, s, d) -> (b, kv_heads * n_rep, s, d)."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(hkv, P, ps, d) page pool + (b, T) page table -> the logical
    (b, hkv, T*ps, d) view, logical row ``t*ps + r`` = row r of page
    ``table[b, t]``. Negative (dead) entries are clamped to page 0 for the
    fetch only: callers mask those rows (sentinels or a SKIP layout)."""
    hkv, num_pages, ps, d = pool.shape
    b, T = table.shape
    safe = table.clamp(0, num_pages - 1).long()
    return pool[:, safe].permute(1, 0, 2, 3, 4).reshape(b, hkv, T * ps, d)


def standard_attention(
    q: torch.Tensor,             # (b, hq, sq, d)
    k: torch.Tensor,             # (b, hkv, sk, d)
    v: torch.Tensor,             # (b, hkv, sk, d)
    *,
    causal: bool = False,
    window: int | None = None,
    kv_mask: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    scale: float | None = None,
    dropout_p: float = 0.0,
    dropout_seed=0,
    dropout_coords: tuple[int, int, int] | None = None,
    q_offset: int | None = None,
) -> torch.Tensor:
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    q_seg, kv_seg = resolve_segment_ids(segment_ids, q_segment_ids,
                                        kv_segment_ids, sq, sk)
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("q_positions and kv_positions must be passed together")
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q_offset is None:
        q_offset = sk - sq

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if q_positions is not None:
        q_pos = q_positions[:, None, :, None]
        k_pos = kv_positions[:, None, None, :]
    else:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(sk, device=q.device)[None, :]
    ok = M.element_mask(
        q_pos, k_pos, causal=causal, window=window,
        kv_valid=kv_mask[:, None, None, :] if kv_mask is not None else None,
        q_seg=q_seg[:, None, :, None] if q_seg is not None else None,
        kv_seg=kv_seg[:, None, None, :] if kv_seg is not None else None)
    if ok is not None:
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))

    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    if dropout_p > 0.0:
        keep = full_dropout_keep_mask(dropout_seed, b, hq, sq, sk, dropout_p,
                                      device=q.device, coords=dropout_coords)
        p = torch.where(keep, p / (1.0 - dropout_p), torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: int | None = None,
    kv_mask: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    scale: float | None = None,
    chunk_size: int = 1024,
    q_offset: int | None = None,
    pv_bf16: bool = False,
) -> torch.Tensor:
    """IO-aware attention: online softmax over kv chunks, never
    materializing the (sq, sk) score matrix (peak temp is (sq, chunk)).
    ``pv_bf16``: P and V rounded to bf16 for P@V, summed in float32 (the
    reference's bf16 P tile); m and l stay float32."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    n_rep = hq // hkv
    q_seg, kv_seg = resolve_segment_ids(segment_ids, q_segment_ids,
                                        kv_segment_ids, sq, sk)
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("q_positions and kv_positions must be passed together")
    # self-packing (one id tensor both sides): every causal q row keeps its
    # own diagonal key, so the guard-free fast path stays NaN-safe.
    self_seg = q_seg is kv_seg
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q_offset is None:
        q_offset = sk - sq
    dev = q.device

    if sk % chunk_size:
        pad = chunk_size - sk % chunk_size
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        valid = torch.arange(sk + pad, device=dev) < sk
        if kv_mask is None:
            kv_mask = valid[None, :].expand(b, sk + pad)
        else:
            kv_mask = torch.nn.functional.pad(kv_mask, (0, pad)) & valid[None, :]
        if kv_seg is not None:
            kv_seg = torch.nn.functional.pad(kv_seg, (0, pad),
                                             value=M.SEG_PAD_KV)
        if kv_positions is not None:
            kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                                   value=M.POS_PAD)
    n_chunks = k.shape[2] // chunk_size

    qf = q.float()
    q_pos = torch.arange(sq, device=dev) + q_offset
    # Guard-free fast path: causal self-attention without a padding mask
    # keeps every row's own diagonal in chunk 0, so masking with the soft
    # sentinel (exp underflows to exactly 0) needs no NaN guards.
    fast = (causal and kv_mask is None and window is None and q_offset >= 0
            and (q_seg is None or self_seg) and q_positions is None)

    p_dtype = torch.bfloat16 if pv_bf16 else None
    state = init_state((b, hq, sq), d, device=dev)
    for ci in range(n_chunks):
        sl = slice(ci * chunk_size, (ci + 1) * chunk_size)
        kb = repeat_kv(k[:, :, sl], n_rep)
        vb = repeat_kv(v[:, :, sl], n_rep)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()) * scale
        if kv_positions is not None:
            qp = q_positions[:, None, :, None]
            kp = kv_positions[:, None, None, sl]
        else:
            qp = q_pos[:, None]
            kp = torch.arange(sl.start, sl.stop, device=dev)[None, :]
        ok = M.element_mask(
            qp, kp, causal=causal, window=window,
            kv_valid=(kv_mask[:, None, None, sl]
                      if kv_mask is not None else None),
            q_seg=q_seg[:, None, :, None] if kv_seg is not None else None,
            kv_seg=kv_seg[:, None, None, sl] if kv_seg is not None else None)
        neg = M.NEG_INF_SOFT if fast else NEG_INF
        if ok is not None:
            s = torch.where(ok, s, torch.full_like(s, neg))
        if fast:
            m = torch.maximum(state.m, s.amax(dim=-1))
            p = torch.exp(s - m[..., None])
            pv = pv_product(p, vb, p_dtype)
            corr = torch.exp(state.m - m)
            state = SoftmaxState(m=m, l=state.l * corr + p.sum(dim=-1),
                                 acc=state.acc * corr[..., None] + pv)
        else:
            state = merge_states(state, block_state(s, vb, p_dtype))
    out, _ = finalize(state, dtype=q.dtype)
    return out


def window_banded_attention(
    q: torch.Tensor,             # (b, hq, s, d)
    k: torch.Tensor,             # (b, hkv, s, d)
    v: torch.Tensor,
    *,
    window: int,
    scale: float | None = None,
    pv_bf16: bool = False,
) -> torch.Tensor:
    """Causal sliding-window attention on a banded layout: q in chunks of
    W = window rows, each attending to exactly [previous chunk | own
    chunk] (2W keys, zeros before the first), which covers the causal
    window, so one local softmax a chunk is exact, with no running
    (m, l). The fused mask (causal, window, key position >= 0) is
    ``element_mask`` on the band's coordinates. Score bytes: s * 2W
    instead of s * s. ``pv_bf16`` as in ``chunked_attention``."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    W = window
    pad = (-s) % W
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (q, k, v))
    sp = q.shape[2]
    nc = sp // W
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    dev = q.device

    qc = q.reshape(b, hq, nc, W, d)
    # banded keys: [chunk i-1 | chunk i], left-padded with W zero rows
    rows = (torch.arange(nc, device=dev)[:, None] * W
            + torch.arange(2 * W, device=dev)[None, :])       # (nc, 2W)
    kb = torch.nn.functional.pad(k, (0, 0, W, 0))[:, :, rows]  # (b,h,nc,2W,d)
    vb = torch.nn.functional.pad(v, (0, 0, W, 0))[:, :, rows]

    sc = torch.einsum("bhcqd,bhckd->bhcqk", qc.float(), kb.float()) * scale
    i = torch.arange(nc, device=dev)[:, None, None]
    q_pos = i * W + torch.arange(W, device=dev)[None, :, None]        # (nc,W,1)
    k_pos = i * W - W + torch.arange(2 * W, device=dev)[None, None, :]
    ok = M.element_mask(q_pos, k_pos, causal=True, window=W,
                        kv_valid=k_pos >= 0)                       # (nc,W,2W)
    sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))

    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = torch.where(sc <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    o = pv_product(p, vb, torch.bfloat16 if pv_bf16 else None)
    return o.reshape(b, hq, sp, d)[:, :, :s].to(q.dtype)
