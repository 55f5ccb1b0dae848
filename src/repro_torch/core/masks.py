"""Mask IR: one declarative ``MaskSpec`` + one layout compiler feeding every
attention consumer (PyTorch port of ``repro.core.masks``; DESIGN.md §3).

Three layers, as in the JAX package:

  * **MaskSpec** — a declarative description of the attention mask
    (causal ∧ sliding window ∧ kv padding ∧ packed segments ∧ sparse
    pattern, plus a query position offset).
  * **element_mask(...)** — the single fused element-level attend-mask
    predicate. The CUDA kernels evaluate the same terms per tile (PARTIAL
    blocks); the plain versions and the oracles evaluate it over full
    (q, k) ranges.
  * **compile_block_layout(spec, ...)** — lowers a MaskSpec to a block
    layout: a static ``(nq, nk)`` uint8 numpy array when the mask
    structure is known on the host, widened to a ``(b, nq, nk)`` int32
    tensor on the call's device when data-dependent components (kv_mask,
    segment ids, positions) participate.

Layout values:
  0 = SKIP          no unmasked element; the kernel never touches the tile
  1 = FULL          every element unmasked; no element masking at all
  2 = PARTIAL       apply the fused element mask (geometry + data terms)
  3 = PARTIAL_DATA  apply only the data terms (kv validity / segments)

Validity and isolation (kv padding, kv_mask, segments) are never dropped by
a FULL override — a block is only FULL when they are provably all-true.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# Canonical masked-score sentinel. Large-negative instead of -inf keeps
# exp/max NaN-free; every impl (kernels, plain versions, decode) masks with
# this.
NEG_INF = float(-1e30)

# Soft sentinel for the guard-free chunked causal path: exp(-3e4 - m)
# underflows to exactly 0.0 in fp32 for any finite real score m.
NEG_INF_SOFT = float(-3e4)

BLOCK_SKIP = 0
BLOCK_FULL = 1
BLOCK_PARTIAL = 2
BLOCK_PARTIAL_DATA = 3

# Sentinel segment ids for padded tails: q and kv pads differ, so a padded
# query row never matches a padded key and comes out fully masked.
SEG_PAD_Q = -1
SEG_PAD_KV = -2

# Sentinel POSITION for padded rows when q/kv positions are in play: far
# beyond any real token position, small enough that int32 ``q_pos - k_pos``
# cannot overflow. A padded key at POS_PAD is causally unreachable.
POS_PAD = 1 << 28


# ---------------------------------------------------------------------------
# The fused element-level mask (single source of truth)
# ---------------------------------------------------------------------------

def element_mask(q_pos, k_pos, *,
                 causal: bool = False,
                 window: int | None = None,
                 kv_valid_len: int | None = None,
                 kv_valid=None,
                 q_seg=None,
                 kv_seg=None):
    """Fused boolean attend-mask from broadcastable coordinate/row tensors.

    Terms (ANDed): causal ``q_pos >= k_pos``; sliding window
    ``q_pos - k_pos < window`` (implies causal); static kv validity
    ``k_pos < kv_valid_len``; traced kv validity ``kv_valid``;
    packed-segment isolation ``q_seg == kv_seg``. Returns ``None`` when no
    term is active (attend everything)."""
    ok = None

    def _and(acc, term):
        return term if acc is None else acc & term

    if causal or window is not None:
        ok = _and(ok, q_pos >= k_pos)
    if window is not None:
        ok = _and(ok, (q_pos - k_pos) < window)
    if kv_valid_len is not None:
        ok = _and(ok, k_pos < kv_valid_len)
    if kv_valid is not None:
        ok = _and(ok, kv_valid)
    if q_seg is not None:
        ok = _and(ok, q_seg == kv_seg)
    return ok


# ---------------------------------------------------------------------------
# MaskSpec — the declarative IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Declarative attention-mask description. Scalar fields are static;
    tensor fields are data. ``sparse_layout`` is an authoritative Alg. 5
    block pattern (its FULL blocks attend fully regardless of geometry).

    ``q_positions`` / ``kv_positions`` ((b, sq) / (b, sk) int32, both or
    neither) generalize the static ``q_offset``: the causal/window terms
    then compare these LOGICAL token positions instead of buffer indices
    (per-segment q_offset of packed chunked prefill, DESIGN.md §10).
    ``q_offset`` is ignored when positions are given, and ``kv_valid_len``
    must be None."""
    causal: bool = False
    window: int | None = None
    q_offset: int = 0
    kv_valid_len: int | None = None       # static: keys >= this are padding
    kv_mask: Any = None                   # (b, sk) bool tensor
    q_segment_ids: Any = None             # (b, sq) int32 tensor
    kv_segment_ids: Any = None            # (b, sk) int32 tensor
    q_positions: Any = None               # (b, sq) int32 tensor
    kv_positions: Any = None              # (b, sk) int32 tensor
    sparse_layout: Any = None             # static (nq, nk) uint8 pattern

    def __post_init__(self):
        if (self.q_positions is None) != (self.kv_positions is None):
            raise ValueError(
                "q_positions and kv_positions must be passed together")
        if self.q_positions is not None and self.kv_valid_len is not None:
            raise ValueError(
                "kv_valid_len is a buffer-index term and cannot combine with "
                "logical q/kv_positions; express the padding tail through "
                "kv_mask or out-of-range kv positions")
        if self.q_positions is not None and self.sparse_layout is not None:
            raise ValueError(
                "a static sparse_layout cannot govern traced positions")

    @property
    def has_geometry(self) -> bool:
        """Geometric terms (subject to a sparse pattern's FULL override)."""
        return self.causal or self.window is not None

    @property
    def has_positions(self) -> bool:
        return self.q_positions is not None

    @property
    def has_data(self) -> bool:
        """Validity and isolation terms (never overridden by FULL)."""
        return (self.kv_valid_len is not None or self.kv_mask is not None
                or self.q_segment_ids is not None)

    @property
    def has_traced(self) -> bool:
        return (self.kv_mask is not None or self.q_segment_ids is not None
                or self.q_positions is not None)

    def _device(self):
        for t in (self.q_positions, self.q_segment_ids, self.kv_mask):
            if t is not None:
                return t.device
        return torch.device("cpu")

    def element_mask(self, q_len: int, k_len: int):
        """Full-range fused mask: (b, 1, q, k) if data terms participate,
        (q, k) otherwise, or None if unmasked."""
        dev = self._device()
        if self.q_positions is not None:
            q_pos = self.q_positions[:, None, :, None]
            k_pos = self.kv_positions[:, None, None, :]
        else:
            q_pos = torch.arange(q_len, device=dev)[:, None] + self.q_offset
            k_pos = torch.arange(k_len, device=dev)[None, :]
        return element_mask(
            q_pos, k_pos, causal=self.causal, window=self.window,
            kv_valid_len=self.kv_valid_len,
            kv_valid=(self.kv_mask[:, None, None, :]
                      if self.kv_mask is not None else None),
            q_seg=(self.q_segment_ids[:, None, :, None]
                   if self.q_segment_ids is not None else None),
            kv_seg=(self.kv_segment_ids[:, None, None, :]
                    if self.kv_segment_ids is not None else None))


# ---------------------------------------------------------------------------
# Element-level convenience masks (oracles / bias construction)
# ---------------------------------------------------------------------------

def causal_mask(q_len: int, k_len: int, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """Boolean (q, k): True where a query may attend; ``q_offset`` shifts
    the query positions (q a suffix of the kv sequence, e.g. decode)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(k_len, device=device)[None, :]
    return element_mask(q_pos, k_pos, causal=True)


def sliding_window_mask(q_len: int, k_len: int, window: int,
                        q_offset: int = 0, device=None) -> torch.Tensor:
    """Causal sliding window: attend to keys in (pos - window, pos]."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(k_len, device=device)[None, :]
    return element_mask(q_pos, k_pos, causal=True, window=window)


def padding_mask_to_bias(kv_mask: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """(batch, k) boolean -> (batch, 1, 1, k) additive bias: 0 where valid,
    ``NEG_INF`` where padding."""
    zero = torch.zeros((), dtype=dtype, device=kv_mask.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=kv_mask.device)
    return torch.where(kv_mask[:, None, None, :], zero, neg)


def segment_mask(q_segment_ids: torch.Tensor,
                 kv_segment_ids: torch.Tensor) -> torch.Tensor:
    """(b, sq) x (b, sk) segment ids -> (b, 1, sq, sk) boolean attend-mask:
    True where query and key belong to the same packed segment (it
    broadcasts against per-head scores (b, h, sq, sk))."""
    return q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]


def decode_kv_valid(kv_len: torch.Tensor, capacity: int, *,
                    window: int | None = None,
                    kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(b,) valid lengths -> (b, capacity) key validity for one-token
    decode: the fused mask with ``q_pos = kv_len - 1``."""
    k_pos = torch.arange(capacity, device=kv_len.device)[None, :]
    return element_mask((kv_len - 1)[:, None], k_pos, causal=True,
                        window=window, kv_valid=kv_mask)


# ---------------------------------------------------------------------------
# Packed-segment (varlen) helpers
# ---------------------------------------------------------------------------

def resolve_segment_ids(segment_ids, q_segment_ids, kv_segment_ids,
                        sq: int, sk: int):
    """Normalize the two ways of passing segment ids into a (q_seg, kv_seg)
    pair (either may be None). ``segment_ids`` is the self-attention
    shorthand (requires sq == sk)."""
    if segment_ids is not None:
        if q_segment_ids is not None or kv_segment_ids is not None:
            raise ValueError(
                "pass either segment_ids or q_/kv_segment_ids, not both")
        if sq != sk:
            raise ValueError(
                f"segment_ids shorthand requires sq == sk (got {sq} != {sk}); "
                "pass q_segment_ids / kv_segment_ids explicitly")
        return segment_ids, segment_ids
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be passed together")
    return q_segment_ids, kv_segment_ids


def segment_ids_from_boundaries(boundary: np.ndarray) -> np.ndarray:
    """(b, s) boolean new-document flags -> (b, s) int32 segment ids.
    boundary[i] = True marks position i as the FIRST token of a new packed
    document; ids count up from 0 within each row (numpy, as the data
    pipeline builds its batches in numpy)."""
    return np.cumsum(np.asarray(boundary, np.int64), axis=-1).astype(np.int32)


def segment_relative_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """(b, s) segment ids -> (b, s) within-segment token positions (RoPE
    restarts at every packed-document boundary). Boundaries are detected by
    adjacent inequality, so ids need not be sorted."""
    s = segment_ids.shape[-1]
    idx = torch.arange(s, dtype=torch.int32, device=segment_ids.device)
    boundary = torch.cat(
        [torch.ones_like(segment_ids[..., :1], dtype=torch.bool),
         segment_ids[..., 1:] != segment_ids[..., :-1]], dim=-1)
    start = torch.cummax(torch.where(boundary, idx, torch.zeros_like(idx)),
                         dim=segment_ids.ndim - 1).values
    return idx - start


# ---------------------------------------------------------------------------
# Static block-layout builders (vectorized numpy — host-known structure)
# ---------------------------------------------------------------------------

def _block_bounds(n_len: int, block: int, offset: int = 0):
    """Per-block inclusive [lo, hi] position ranges (ragged tail capped)."""
    n = (n_len + block - 1) // block
    idx = np.arange(n)
    lo = idx * block + offset
    hi = np.minimum((idx + 1) * block, n_len) - 1 + offset
    return lo, hi


def causal_block_layout(q_len: int, k_len: int, block_q: int, block_k: int,
                        q_offset: int = 0) -> np.ndarray:
    """Causal layout: blocks fully below the diagonal FULL, diagonal
    PARTIAL, above SKIP."""
    q_lo, q_hi = _block_bounds(q_len, block_q, q_offset)
    k_lo, k_hi = _block_bounds(k_len, block_k)
    full = q_lo[:, None] >= k_hi[None, :]
    run = q_hi[:, None] >= k_lo[None, :]
    return np.where(full, BLOCK_FULL,
                    np.where(run, BLOCK_PARTIAL, BLOCK_SKIP)).astype(np.uint8)


def full_block_layout(q_len: int, k_len: int, block_q: int, block_k: int) -> np.ndarray:
    nq = (q_len + block_q - 1) // block_q
    nk = (k_len + block_k - 1) // block_k
    return np.full((nq, nk), BLOCK_FULL, np.uint8)


def butterfly_block_layout(q_len: int, k_len: int, block_q: int, block_k: int,
                           causal: bool = False) -> np.ndarray:
    """Fixed butterfly sparsity (paper §3.3): block (i, j) is kept (FULL)
    on the block-diagonal band, where j ≡ i (mod round(sqrt(n))), or where
    |i - j| is a power of two; every other block is SKIP. With ``causal``
    the pattern is capped elementwise by the causal layout, so blocks above
    the diagonal drop and the diagonal stays FULL (min(FULL, PARTIAL)), as
    in the JAX package."""
    nq = (q_len + block_q - 1) // block_q
    nk = (k_len + block_k - 1) // block_k
    n = max(nq, nk)
    root = max(1, int(round(np.sqrt(n))))
    i = np.arange(nq)[:, None]
    j = np.arange(nk)[None, :]
    dist = np.abs(i - j)
    keep = ((dist <= 1)
            | ((i % root) == (j % root))
            | ((dist > 0) & ((dist & (dist - 1)) == 0)))
    out = np.where(keep, BLOCK_FULL, BLOCK_SKIP).astype(np.uint8)
    if causal:
        out = np.minimum(out, causal_block_layout(q_len, k_len, block_q,
                                                  block_k))
    return out


def refine_block_layout(layout: np.ndarray, rq: int, rk: int) -> np.ndarray:
    """A static (nq, nk) pattern at blocks ``rq`` x ``rk`` times finer: each
    coarse class repeated over its rq x rk sub-blocks (SKIP stays SKIP,
    FULL stays FULL, PARTIAL and PARTIAL_DATA keep their class), so the
    element mask it selects is unchanged."""
    return np.repeat(np.repeat(np.asarray(layout, np.uint8), rq, axis=0),
                     rk, axis=1)


def sliding_window_block_layout(q_len: int, k_len: int, block_q: int, block_k: int,
                                window: int, q_offset: int = 0) -> np.ndarray:
    """Block layout for a causal sliding-window mask."""
    q_lo, q_hi = _block_bounds(q_len, block_q, q_offset)
    k_lo, k_hi = _block_bounds(k_len, block_k)
    outside = ((q_lo[:, None] > k_hi[None, :] + window - 1)
               | (q_hi[:, None] < k_lo[None, :]))
    fully_inside = ((q_lo[:, None] >= k_hi[None, :])
                    & ((q_hi[:, None] - k_lo[None, :]) < window))
    return np.where(outside, BLOCK_SKIP,
                    np.where(fully_inside, BLOCK_FULL,
                             BLOCK_PARTIAL)).astype(np.uint8)


# ---------------------------------------------------------------------------
# Data-dependent block classifiers (one pass per call on the device)
# ---------------------------------------------------------------------------

def _const(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=like.device)


def kv_block_layout(kv_valid: torch.Tensor, block_k: int) -> torch.Tensor:
    """(b, sk) boolean key validity -> (b, nk) int32 per-kv-block classes:
    all valid FULL, none SKIP, else PARTIAL (sk % block_k == 0)."""
    b, sk = kv_valid.shape
    r = kv_valid.reshape(b, sk // block_k, block_k)
    allv = r.all(dim=-1)
    anyv = r.any(dim=-1)
    return torch.where(allv, _const(BLOCK_FULL, r),
                       torch.where(anyv, _const(BLOCK_PARTIAL, r),
                                   _const(BLOCK_SKIP, r)))


def paged_block_layout(kv_len: torch.Tensor, page_table: torch.Tensor,
                       page_size: int, *,
                       window: int | None = None,
                       kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(b,) lengths + (b, T) page tables -> (b, T) block classes in LOGICAL
    page space. The page IS the kv block, so the decode validity band
    classifies pages exactly as it classifies contiguous blocks;
    unallocated (negative) table entries are forced SKIP so a kernel never
    forms their address."""
    b, T = page_table.shape
    valid = decode_kv_valid(kv_len, T * page_size, window=window,
                            kv_mask=kv_mask)
    lay = kv_block_layout(valid, page_size)
    return torch.where(page_table < 0, _const(BLOCK_SKIP, lay), lay)


def paged_prefill_block_layout(layout: torch.Tensor,
                               page_list: torch.Tensor) -> torch.Tensor:
    """Force dead page slots (negative ``page_list`` entries) SKIP across
    every q row of a compiled (b, nq, T) prefill layout."""
    return torch.where((page_list < 0)[:, None, :],
                       _const(BLOCK_SKIP, layout), layout)


def position_block_layout(q_positions: torch.Tensor,
                          kv_positions: torch.Tensor,
                          block_q: int, block_k: int, *,
                          causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """(b, sq) x (b, sk) logical positions -> (b, nq, nk) int32 geometry
    classes, range-based and sound for arbitrary position arrays:
    ``q_min >= k_max`` FULL, ``q_max < k_min`` SKIP; the window term is
    all-true iff ``q_max - k_min < w`` and all-false iff
    ``q_min - k_max >= w``."""
    b, sq = q_positions.shape
    _, sk = kv_positions.shape
    qr = q_positions.reshape(b, sq // block_q, block_q)
    kr = kv_positions.reshape(b, sk // block_k, block_k)
    qmin, qmax = qr.amin(-1)[:, :, None], qr.amax(-1)[:, :, None]
    kmin, kmax = kr.amin(-1)[:, None, :], kr.amax(-1)[:, None, :]
    if not (causal or window is not None):
        return torch.full((b, qr.shape[1], kr.shape[1]), BLOCK_FULL,
                          dtype=torch.int32, device=q_positions.device)
    skip = qmax < kmin
    full = qmin >= kmax
    if window is not None:
        skip = skip | ((qmin - kmax) >= window)
        full = full & ((qmax - kmin) < window)
    return torch.where(skip, _const(BLOCK_SKIP, qr),
                       torch.where(full, _const(BLOCK_FULL, qr),
                                   _const(BLOCK_PARTIAL, qr)))


def _both_numpy(a, b) -> bool:
    return isinstance(a, np.ndarray) and isinstance(b, np.ndarray)


def _as_tensor(x, other):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    dev = other.device if isinstance(other, torch.Tensor) else "cpu"
    return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)


def combine_geometry_layouts(layout, geo):
    """Fold a GEOMETRY block classification (position-based causal/window)
    into a layout: where the geometry is PARTIAL, FULL and PARTIAL_DATA
    alike demote to PARTIAL (the geometric terms must re-apply); SKIP
    dominates. numpy x numpy stays numpy."""
    if _both_numpy(layout, geo):
        run = (layout != BLOCK_SKIP) & (geo != BLOCK_SKIP)
        demoted = np.where(geo == BLOCK_FULL, layout, BLOCK_PARTIAL)
        return np.where(run, demoted, BLOCK_SKIP)
    layout, geo = _as_tensor(layout, geo), _as_tensor(geo, layout)
    run = (layout != BLOCK_SKIP) & (geo != BLOCK_SKIP)
    demoted = torch.where(geo == BLOCK_FULL, layout,
                          _const(BLOCK_PARTIAL, layout))
    return torch.where(run, demoted, _const(BLOCK_SKIP, layout))


def segment_block_layout(q_segment_ids: torch.Tensor,
                         kv_segment_ids: torch.Tensor,
                         block_q: int, block_k: int) -> torch.Tensor:
    """(b, sq) x (b, sk) ids -> (b, nq, nk) int32 segment block classes:
    disjoint id ranges SKIP, both blocks uniform with the same id FULL,
    else PARTIAL."""
    b, sq = q_segment_ids.shape
    _, sk = kv_segment_ids.shape
    qr = q_segment_ids.reshape(b, sq // block_q, block_q)
    kr = kv_segment_ids.reshape(b, sk // block_k, block_k)
    qmin, qmax = qr.amin(-1)[:, :, None], qr.amax(-1)[:, :, None]
    kmin, kmax = kr.amin(-1)[:, None, :], kr.amax(-1)[:, None, :]
    intersect = (qmin <= kmax) & (kmin <= qmax)
    uniform = (qmin == qmax) & (kmin == kmax) & (qmin == kmin)
    return torch.where(intersect,
                       torch.where(uniform, _const(BLOCK_FULL, qr),
                                   _const(BLOCK_PARTIAL, qr)),
                       _const(BLOCK_SKIP, qr))


def combine_block_layouts(layout, data):
    """Fold a data-mask block classification into a layout: SKIP dominates;
    a data-PARTIAL demotes FULL to PARTIAL_DATA and leaves PARTIAL /
    PARTIAL_DATA as they are. numpy x numpy stays numpy."""
    if _both_numpy(layout, data):
        run = (layout != BLOCK_SKIP) & (data != BLOCK_SKIP)
        demoted = np.where(data == BLOCK_FULL, layout,
                           np.where(layout == BLOCK_PARTIAL, BLOCK_PARTIAL,
                                    BLOCK_PARTIAL_DATA))
        return np.where(run, demoted, BLOCK_SKIP)
    layout, data = _as_tensor(layout, data), _as_tensor(data, layout)
    run = (layout != BLOCK_SKIP) & (data != BLOCK_SKIP)
    demoted = torch.where(
        data == BLOCK_FULL, layout,
        torch.where(layout == BLOCK_PARTIAL, _const(BLOCK_PARTIAL, layout),
                    _const(BLOCK_PARTIAL_DATA, layout)))
    return torch.where(run, demoted, _const(BLOCK_SKIP, layout))


# ---------------------------------------------------------------------------
# The layout compiler: MaskSpec -> block layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Compiled block layout: a static (nq, nk) numpy uint8 array when the
    spec has no data terms, else a (b, nq, nk) int32 tensor."""
    layout: Any
    block_q: int
    block_k: int
    q_len: int
    k_len: int

    @property
    def is_static(self) -> bool:
        return isinstance(self.layout, np.ndarray)

    def as_array(self, device=None) -> torch.Tensor:
        """Kernel-operand form: int32 tensor on ``device`` (default: the
        layout's own device, the CPU for a static layout)."""
        if self.is_static:
            return torch.as_tensor(self.layout.astype(np.int32),
                                   device=device or "cpu")
        return self.layout.to(device=device or self.layout.device,
                              dtype=torch.int32)

    def density(self) -> float:
        """Fraction of non-skipped blocks (Prop. 4's sparsity fraction s)."""
        return layout_density(self)

    def skip_count(self) -> int:
        return int((_grid(self) == BLOCK_SKIP).sum())

    def block_count(self) -> int:
        return int(_grid(self).numel())


def compile_block_layout(spec: MaskSpec, q_len: int, k_len: int,
                         block_q: int, block_k: int) -> BlockLayout:
    """Lower a MaskSpec to a block layout. Static lowering (numpy): sparse
    pattern if given, else causal/window classification, else all-FULL;
    then the static kv padding tail. Data widening (tensors, once per
    call): position geometry, kv_mask block classes and packed-segment
    range classes. Data terms require lengths divisible by the blocks
    (``kernels/ops.py`` pads)."""
    nq = (q_len + block_q - 1) // block_q
    nk = (k_len + block_k - 1) // block_k

    if spec.has_positions:
        static = full_block_layout(q_len, k_len, block_q, block_k)
    elif spec.sparse_layout is not None:
        static = np.asarray(spec.sparse_layout, np.uint8)
        if static.shape != (nq, nk):
            raise ValueError(
                f"sparse_layout shape {static.shape} != block grid ({nq}, {nk}) "
                f"for lengths ({q_len}, {k_len}) and blocks ({block_q}, {block_k})")
    elif spec.window is not None:
        static = sliding_window_block_layout(q_len, k_len, block_q, block_k,
                                             spec.window, spec.q_offset)
    elif spec.causal:
        static = causal_block_layout(q_len, k_len, block_q, block_k,
                                     spec.q_offset)
    else:
        static = full_block_layout(q_len, k_len, block_q, block_k)

    if spec.kv_valid_len is not None and spec.kv_valid_len < k_len:
        k_lo, k_hi = _block_bounds(k_len, block_k)
        tail = np.where(k_lo >= spec.kv_valid_len, BLOCK_SKIP,
                        np.where(k_hi >= spec.kv_valid_len, BLOCK_PARTIAL,
                                 BLOCK_FULL)).astype(np.uint8)
        static = combine_block_layouts(static, tail[None, :]).astype(np.uint8)

    if not spec.has_traced:
        return BlockLayout(static, block_q, block_k, q_len, k_len)

    if q_len % block_q or k_len % block_k:
        raise ValueError(
            "traced mask components (kv_mask / segment ids) require lengths "
            f"divisible by block sizes, got ({q_len}, {k_len}) vs "
            f"({block_q}, {block_k})")
    dev = spec._device()
    layout = torch.as_tensor(static.astype(np.int32), device=dev)[None]
    if spec.has_positions:
        geo = position_block_layout(spec.q_positions, spec.kv_positions,
                                    block_q, block_k, causal=spec.causal,
                                    window=spec.window)
        layout = combine_geometry_layouts(layout, geo)
    if spec.kv_mask is not None:
        col = kv_block_layout(spec.kv_mask, block_k)
        layout = combine_block_layouts(layout, col[:, None, :])
    if spec.q_segment_ids is not None:
        seg = segment_block_layout(spec.q_segment_ids, spec.kv_segment_ids,
                                   block_q, block_k)
        layout = combine_block_layouts(layout, seg)
    return BlockLayout(layout, block_q, block_k, q_len, k_len)


# ---------------------------------------------------------------------------
# Layout introspection and expansion for the oracles
# ---------------------------------------------------------------------------

def _grid(layout):
    arr = layout.layout if isinstance(layout, BlockLayout) else layout
    return torch.as_tensor(np.asarray(arr) if isinstance(arr, np.ndarray)
                           else arr)


def layout_density(layout) -> float:
    """Fraction s of non-skipped blocks (Prop. 4's sparsity fraction), in
    float32 as the count times float32(1 / blocks): the rounding of the
    JAX package's ``jnp.mean`` on the CPU, so that the two agree bit for
    bit."""
    grid = _grid(layout)
    kept = np.float32(int((grid != BLOCK_SKIP).sum()))
    return float(kept * np.float32(1.0 / grid.numel()))


def layout_skip_rate(layout) -> float:
    """Fraction of SKIP blocks: work avoided at block level."""
    return 1.0 - layout_density(layout)


def layout_to_element_mask(layout, block_q: int, block_k: int,
                           q_len: int, k_len: int,
                           base_mask: torch.Tensor | None = None,
                           data_mask: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Expand a block layout to a boolean element mask for the oracles.
    FULL blocks are all-True, SKIP all-False; PARTIAL blocks intersect with
    ``base_mask`` (the fused geometry + data mask) and PARTIAL_DATA blocks
    with ``data_mask`` (default ``base_mask``). A static (nq, nk) or
    batched (b, nq, nk) layout (the result then has the batch dim); 4-D
    (b, 1, q, k) masks (``MaskSpec.element_mask``'s batched shape) are
    squeezed so that the batch dims align."""
    grid = _grid(layout)
    dev = base_mask.device if base_mask is not None else grid.device
    grid = grid.to(dev)
    qb = torch.arange(q_len, device=dev) // block_q
    kb = torch.arange(k_len, device=dev) // block_k
    blk = grid[..., qb[:, None], kb[None, :]]
    mask = blk != BLOCK_SKIP
    if data_mask is None:
        data_mask = base_mask

    def _align(m):
        return m[:, 0] if (m is not None and m.ndim == 4) else m

    base_mask, data_mask = _align(base_mask), _align(data_mask)
    if base_mask is not None:
        part = torch.where(blk == BLOCK_PARTIAL_DATA, data_mask, base_mask)
        mask = mask & ((blk == BLOCK_FULL) | part)
    return mask
