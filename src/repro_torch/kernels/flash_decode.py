"""Split-KV decode: one hand-written Hopper kernel + its plain versions
(port of ``repro.kernels.flash_decode``).

Serving decode computes attention for ONE new query token against a long
KV cache. Parallelism comes from splitting the kv axis: each split runs
the Algorithm-1 loop over its kv blocks and emits a partial softmax state
(acc, m, l); ``_merge_split_partials`` combines them with the
online-softmax merge (XLA-level code in the JAX package). Two cache
geometries, one kernel body (``csrc/flash_decode.cu``) that also merges the
splits in the same launch:

  * ``flash_decode`` — a contiguous per-sequence cache (b, hkv, capacity,
    d): dense slot serving. Validity is ``kv_len`` + optional window +
    optional per-slot ``kv_mask``, lowered by ``masks.kv_block_layout`` of
    ``masks.decode_kv_valid`` into per-block classes.
  * ``flash_decode_paged`` — a shared page pool (hkv, pages, page_size, d)
    read through per-sequence page tables; the page is the kv block
    (``masks.paged_block_layout``).

SKIP blocks (past kv_len, before the window, masked out, unallocated) never
run, FULL blocks drop the element compares, PARTIAL blocks apply them. On
a CUDA tensor each decode is one kernel launch (counted in ``LAUNCHES``)
that writes the split partials and the merged output; on a CPU tensor it
runs the plain partials and ``_merge_split_partials``. The
``*_from_layout`` functions are the whole decode for a lowered layout and
return both, the ``*_partials`` functions the partials alone (the
comparison surface of the tests). Geometry is validated up front
(capacity % block multiples); nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import masks as M
from repro_torch.core.masks import NEG_INF
from repro_torch.kernels import build
from repro_torch.kernels.ref import gather_pages, repeat_kv
from repro_torch.kernels.tuning import (KERNEL_HEAD_DIMS, check_decode_splits,
                                        check_page_size)

LAUNCHES = {"flash_decode": 0, "flash_decode_paged": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("flash_decode")
    if not getattr(lib, "_typed", False):
        c_int, c_p = ctypes.c_int, ctypes.c_void_p
        lib.flash_decode_paged.argtypes = ([c_int] * 2 + [c_p] * 10
                                           + [c_int] * 8 + [ctypes.c_float, c_p])
        lib.flash_decode_paged.restype = c_int
        lib.flash_decode.argtypes = ([c_int] * 2 + [c_p] * 10 + [c_int] * 7
                                     + [ctypes.c_float, c_p])
        lib.flash_decode.restype = c_int
        lib.flash_decode_smem_bytes.argtypes = [c_int, c_int,
                                                ctypes.POINTER(c_int)]
        lib.flash_decode_smem_bytes.restype = c_int
        lib._typed = True
    return lib


def smem_bytes(dtype: torch.dtype, head_dim: int) -> tuple[int, int]:
    """(dynamic shared memory bytes of one CTA, ring stages) of the decode
    kernel for a dtype and head dim, as its launcher computes them (card
    only: asks the built library)."""
    stages = ctypes.c_int(0)
    n = _lib().flash_decode_smem_bytes(_DTYPES[dtype], head_dim,
                                       ctypes.byref(stages))
    if n < 0:
        raise ValueError(f"flash_decode takes {tuple(_DTYPES)} and head dims "
                         f"{KERNEL_HEAD_DIMS}, got {dtype}, {head_dim}")
    return n, stages.value


def _card_operands(name, q, kv, num_splits):
    """Check the CUDA operands of one decode launch (device, dtype, head
    dim, split limit, 16-byte alignment of the vector loads) and return
    (q, k, v) contiguous; raises before any launch."""
    for tname, t in zip(("k", "v"), kv):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} must match q's device and dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} (one of "
                         f"{KERNEL_HEAD_DIMS}) required")
    check_decode_splits(num_splits)
    ts = [t.contiguous() for t in (q, *kv)]
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: q, k and v must start on 16-byte "
                         f"boundaries (the kernel reads 16-byte vectors)")
    return ts


def _card_outputs(q, num_splits):
    """(out, o_p, m_p, l_p) of one launch, uninitialized."""
    b, hq, _, d = q.shape
    o_p = torch.empty((b, hq, num_splits, d), dtype=torch.float32,
                      device=q.device)
    m_p = torch.empty((b, hq, num_splits), dtype=torch.float32,
                      device=q.device)
    return torch.empty_like(q), o_p, m_p, torch.empty_like(m_p)


def validate_decode_geometry(capacity: int, block_k: int,
                             num_splits: int) -> tuple[int, int]:
    """Clamp-then-validate the contiguous decode grid: a block cannot exceed
    the cache and there cannot be more splits than blocks (documented
    shape clamps); misalignment raises instead of padding the cache.
    Returns the clamped ``(block_k, num_splits)``."""
    block_k = min(block_k, capacity)
    num_splits = min(num_splits, max(1, capacity // max(block_k, 1)))
    if capacity % block_k:
        raise ValueError(
            f"flash_decode: cache capacity ({capacity}) must be a multiple "
            f"of block_k ({block_k}); pad the cache at allocation time")
    nk = capacity // block_k
    if nk % num_splits:
        raise ValueError(
            f"flash_decode: cache capacity ({capacity}) must be a multiple "
            f"of num_splits * block_k ({num_splits} * {block_k}); choose a "
            f"num_splits dividing the {nk} kv blocks")
    return block_k, num_splits


def validate_paged_decode_geometry(pages_per_seq: int,
                                   num_splits: int) -> int:
    """The page IS the block, so only the split count can misalign.
    Returns the clamped num_splits."""
    num_splits = min(num_splits, pages_per_seq)
    if pages_per_seq % num_splits:
        raise ValueError(
            f"flash_decode_paged: pages per sequence ({pages_per_seq}) must "
            f"be a multiple of num_splits ({num_splits})")
    return num_splits


def _merge_split_partials(o_p, m_p, l_p, dtype):
    """Combine per-split partial softmax states (vectorized over splits).
    o_p: (b, hq, splits, d); m_p/l_p: (b, hq, splits). Fully-masked rows
    (all partials empty) emit zeros."""
    m = m_p.amax(dim=-1)
    w = torch.where(m_p <= NEG_INF / 2, torch.zeros_like(m_p),
                    torch.exp(m_p - m[..., None]))
    l = (l_p * w).sum(dim=-1)
    acc = (o_p * w[..., None]).sum(dim=2)
    out = (acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None])
    return out.to(dtype)[:, :, None, :]


def flash_decode_paged_partials_plain(q, k_pool, v_pool, page_table, kv_len,
                                      layout, *, scale, num_splits, window):
    """The kernel's function densely in fp32: (o_p, m_p, l_p) partials."""
    b, hq, _, d = q.shape
    hkv, num_pages, ps, _ = k_pool.shape
    T = page_table.shape[1]
    n_rep = hq // hkv

    def gather(pool):     # (b, hq, T*ps, d), GQA heads expanded
        return repeat_kv(gather_pages(pool, page_table), n_rep).float()

    s = torch.einsum("bhd,bhkd->bhk", q[:, :, 0].float(), gather(k_pool)) * scale
    blk = layout.repeat_interleave(ps, dim=1)[:, None, :]        # (b, 1, T*ps)
    ok = M.decode_kv_valid(kv_len, T * ps, window=window)[:, None, :]
    allowed = (blk == M.BLOCK_FULL) | ((blk == M.BLOCK_PARTIAL) & ok)
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    s = s.reshape(b, hq, num_splits, -1)
    m_p = s.amax(dim=-1)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - m_p[..., None]))
    l_p = p.sum(dim=-1)
    vv = gather(v_pool).reshape(b, hq, num_splits, -1, d)
    o_p = torch.einsum("bhsk,bhskd->bhsd", p, vv)
    return o_p, m_p, l_p


def flash_decode_paged_from_layout(q, k_pool, v_pool, page_table, kv_len,
                                  layout, *, scale, num_splits, window):
    """The whole paged decode for a lowered (b, T) page layout:
    ``(out, (o_p, m_p, l_p))``. On a CUDA tensor ONE kernel launch writes
    the split partials and merges them in a thread-block cluster; on a
    CPU tensor the plain partials and ``_merge_split_partials``."""
    if not q.is_cuda:
        parts = flash_decode_paged_partials_plain(
            q, k_pool, v_pool, page_table, kv_len, layout, scale=scale,
            num_splits=num_splits, window=window)
        return _merge_split_partials(*parts, q.dtype), parts
    b, hq, sq, d = q.shape
    hkv, num_pages, ps, _ = k_pool.shape
    T = page_table.shape[1]
    check_page_size(ps)
    if hq % hkv or T % num_splits or tuple(layout.shape) != (b, T):
        raise ValueError(
            f"flash_decode_paged: hq % hkv == 0, T % num_splits == 0 and a "
            f"(b, T) layout required")
    q, k_pool, v_pool = _card_operands("flash_decode_paged", q,
                                       (k_pool, v_pool), num_splits)
    pt = page_table.to(torch.int32).contiguous()
    kl = kv_len.to(torch.int32).contiguous()
    lay = layout.to(torch.int32).contiguous()
    out, o_p, m_p, l_p = _card_outputs(q, num_splits)
    lib = _lib()
    err = lib.flash_decode_paged(
        _DTYPES[q.dtype], d, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), pt.data_ptr(), kl.data_ptr(), lay.data_ptr(),
        o_p.data_ptr(), m_p.data_ptr(), l_p.data_ptr(), out.data_ptr(),
        b, hq, hkv, num_pages, ps, T, num_splits,
        -1 if window is None else int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, lib, "flash_decode_error_string", "flash_decode_paged")
    LAUNCHES["flash_decode_paged"] += 1
    return out, (o_p, m_p, l_p)


def flash_decode_paged_partials(q, k_pool, v_pool, page_table, kv_len, layout,
                                *, scale, num_splits, window):
    """(o_p, m_p, l_p) split partials: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not q.is_cuda:
        return flash_decode_paged_partials_plain(
            q, k_pool, v_pool, page_table, kv_len, layout, scale=scale,
            num_splits=num_splits, window=window)
    return flash_decode_paged_from_layout(
        q, k_pool, v_pool, page_table, kv_len, layout, scale=scale,
        num_splits=num_splits, window=window)[1]


def flash_decode_paged(
    q: torch.Tensor,            # (b, hq, 1, d)
    k_pool: torch.Tensor,       # (hkv, num_pages, page_size, d)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,   # (b, pages_per_seq) int32; negative = unallocated
    kv_len: torch.Tensor,       # (b,) int32 valid lengths
    *,
    scale: float | None = None,
    num_splits: int | None = None,
    window: int | None = None,
    shards: int = 1,
) -> torch.Tensor:
    """Split-KV decode against a PAGED KV cache; returns (b, hq, 1, d) in
    q's dtype. ``page_table`` maps each sequence's logical page t
    (positions [t*ps, (t+1)*ps)) to a physical pool page. ``shards`` is
    the tensor-parallel shard count whose per-shard heads ``q`` holds: an
    auto split count aims at ``tuning.decode_split_target(shards)``, or is
    the autotuner's (``tuning.resolve_decode_geometry``)."""
    from repro_torch.kernels.tuning import resolve_decode_geometry
    b, hq, sq, d = q.shape
    hkv, num_pages, page_size, _ = k_pool.shape
    if sq != 1:
        raise ValueError("flash_decode_paged handles single-token decode")
    if any(t.requires_grad for t in (q, k_pool, v_pool)):
        raise ValueError("flash_decode_paged is forward-only (serving)")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    T = page_table.shape[1]
    _, num_splits = resolve_decode_geometry(
        T * page_size, None, num_splits, head_dim=d, dtype=k_pool.dtype,
        page_size=page_size, shards=shards, on_card=q.is_cuda,
        device=q.device)
    with torch.inference_mode():
        kv_len = kv_len.to(torch.int32)
        # one lowering per call: (b, T) page classes; unallocated entries
        # are SKIP, so the kernel never forms their address.
        layout = M.paged_block_layout(kv_len, page_table, page_size,
                                      window=window)
        return flash_decode_paged_from_layout(
            q, k_pool, v_pool, page_table, kv_len, layout, scale=scale,
            num_splits=num_splits, window=window)[0]


# ---------------------------------------------------------------------------
# contiguous cache (dense slot mode)
# ---------------------------------------------------------------------------

def flash_decode_partials_plain(q, k, v, kv_len, layout, *, scale, block_k,
                                num_splits, window, kv_mask=None):
    """The contiguous kernel's function densely in fp32: (o_p, m_p, l_p)
    per split, over the keys the layout lets run (FULL blocks unmasked,
    PARTIAL blocks through ``decode_kv_valid``)."""
    b, hq, _, d = q.shape
    _, hkv, cap, _ = k.shape
    n_rep = hq // hkv
    s = torch.einsum("bhd,bhkd->bhk", q[:, :, 0].float(),
                     repeat_kv(k, n_rep).float()) * scale
    blk = layout.repeat_interleave(block_k, dim=1)[:, None, :]    # (b, 1, cap)
    ok = M.decode_kv_valid(kv_len, cap, window=window,
                           kv_mask=kv_mask)[:, None, :]
    allowed = (blk == M.BLOCK_FULL) | ((blk == M.BLOCK_PARTIAL) & ok)
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    s = s.reshape(b, hq, num_splits, -1)
    m_p = s.amax(dim=-1)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - m_p[..., None]))
    l_p = p.sum(dim=-1)
    vv = repeat_kv(v, n_rep).float().reshape(b, hq, num_splits, -1, d)
    o_p = torch.einsum("bhsk,bhskd->bhsd", p, vv)
    return o_p, m_p, l_p


def flash_decode_from_layout(q, k, v, kv_len, layout, *, scale, block_k,
                             num_splits, window, kv_mask=None):
    """The whole contiguous-cache decode for a lowered (b, capacity //
    block_k) layout: ``(out, (o_p, m_p, l_p))``. On a CUDA tensor ONE
    kernel launch writes the split partials and merges them in a
    thread-block cluster; on a CPU tensor the plain partials and
    ``_merge_split_partials``."""
    kw = dict(scale=scale, block_k=block_k, num_splits=num_splits,
              window=window, kv_mask=kv_mask)
    if not q.is_cuda:
        parts = flash_decode_partials_plain(q, k, v, kv_len, layout, **kw)
        return _merge_split_partials(*parts, q.dtype), parts
    b, hq, sq, d = q.shape
    _, hkv, cap, _ = k.shape
    nk = cap // block_k
    if (hq % hkv or cap % block_k or nk % num_splits
            or tuple(layout.shape) != (b, nk)):
        raise ValueError(
            f"flash_decode: hq % hkv == 0, capacity % block_k == 0, blocks % "
            f"num_splits == 0 and a (b, capacity // block_k) layout required")
    q, k, v = _card_operands("flash_decode", q, (k, v), num_splits)
    kl = kv_len.to(torch.int32).contiguous()
    lay = layout.to(torch.int32).contiguous()
    kvm = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    out, o_p, m_p, l_p = _card_outputs(q, num_splits)
    lib = _lib()
    err = lib.flash_decode(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kl.data_ptr(), lay.data_ptr(), None if kvm is None else kvm.data_ptr(),
        o_p.data_ptr(), m_p.data_ptr(), l_p.data_ptr(), out.data_ptr(),
        b, hq, hkv, cap, block_k, num_splits,
        -1 if window is None else int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, lib, "flash_decode_error_string", "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out, (o_p, m_p, l_p)


def flash_decode_partials(q, k, v, kv_len, layout, *, scale, block_k,
                          num_splits, window, kv_mask=None):
    """(o_p, m_p, l_p) split partials over a contiguous cache: the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    kw = dict(scale=scale, block_k=block_k, num_splits=num_splits,
              window=window, kv_mask=kv_mask)
    if not q.is_cuda:
        return flash_decode_partials_plain(q, k, v, kv_len, layout, **kw)
    return flash_decode_from_layout(q, k, v, kv_len, layout, **kw)[1]


def flash_decode(
    q: torch.Tensor,            # (b, hq, 1, d)
    k: torch.Tensor,            # (b, hkv, capacity, d) — the KV cache
    v: torch.Tensor,
    kv_len: torch.Tensor,       # (b,) int32 valid lengths
    *,
    scale: float | None = None,
    block_k: int | None = None,       # None = resolve via kernels.tuning
    num_splits: int | None = None,
    window: int | None = None,
    kv_mask: torch.Tensor | None = None,   # (b, capacity) True = valid slot
    shards: int = 1,
) -> torch.Tensor:
    """One-token attention against a fixed-capacity KV cache; returns
    (b, hq, 1, d) in q's dtype. ``window`` keeps only the last ``window``
    valid cache positions; ``kv_mask`` masks out single slots. Blocks
    past the valid length, before the window or fully masked out are SKIP
    in the compiled per-sequence layout and never run. ``block_k`` /
    ``num_splits`` left None resolve through ``tuning.resolve_decode_geometry``
    (divisor-valid by construction; ``shards``, the tensor-parallel shard
    count, scales the split target); explicit values are validated."""
    from repro_torch.kernels.tuning import resolve_decode_geometry
    b, hq, sq, d = q.shape
    cap = k.shape[2]
    if sq != 1:
        raise ValueError("flash_decode handles single-token decode")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_decode is forward-only (serving)")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    block_k, num_splits = resolve_decode_geometry(
        cap, block_k, num_splits, head_dim=d, dtype=k.dtype, shards=shards,
        on_card=q.is_cuda, device=q.device)
    with torch.inference_mode():
        kv_len = kv_len.to(torch.int32)
        # one lowering per call: (b, capacity // block_k) block classes
        valid = M.decode_kv_valid(kv_len, cap, window=window, kv_mask=kv_mask)
        layout = M.kv_block_layout(valid, block_k)
        return flash_decode_from_layout(
            q, k, v, kv_len, layout, scale=scale, block_k=block_k,
            num_splits=num_splits, window=window, kv_mask=kv_mask)[0]


# ---------------------------------------------------------------------------
# a rank's slice of a sequence-sharded cache
# ---------------------------------------------------------------------------

def flash_decode_slice(q, k, v, kv_len, *, offset: int,
                       scale: float | None = None,
                       block_k: int | None = None,
                       num_splits: int | None = None,
                       window: int | None = None):
    """The split partials ``(o_p, m_p, l_p)`` of one-token attention over a
    SLICE of a contiguous cache: ``k``, ``v`` (b, hkv, cs, d) hold the
    global positions [offset, offset + cs) of each lane, ``kv_len`` (b,)
    the global lengths. One rank of a sequence-sharded decode runs this
    over its slice (#7 on a CUDA tensor, its plain version on a CPU
    tensor) and merges every rank's partials (``_merge_split_partials``).
    The slice's valid keys are those of the whole cache, ``kv_len`` and
    ``window`` counted globally: the kernel gets the length within the
    slice (clamped to [0, cs]) and, under a window, the slice's valid
    slots as its ``kv_mask``, since the window's lower edge belongs to
    the global length. The block and splits resolve at the slice's
    capacity with ``shards=1`` (every rank holds every head). A lane with
    no valid key in the slice gives splits of m = NEG_INF, l = 0, which
    the merge weighs 0."""
    from repro_torch.kernels.tuning import resolve_decode_geometry
    b, hq, sq, d = q.shape
    cs = k.shape[2]
    if sq != 1:
        raise ValueError("flash_decode_slice handles single-token decode")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    block_k, num_splits = resolve_decode_geometry(
        cs, block_k, num_splits, head_dim=d, dtype=k.dtype, shards=1,
        on_card=q.is_cuda, device=q.device)
    with torch.inference_mode():
        kv_len = kv_len.to(torch.int32)
        pos = offset + torch.arange(cs, device=q.device)
        valid = M.element_mask((kv_len - 1)[:, None], pos[None, :],
                               causal=True, window=window)
        local = torch.clamp(kv_len - offset, 0, cs)
        layout = M.kv_block_layout(valid, block_k)
        return flash_decode_from_layout(
            q, k, v, local, layout, scale=scale, block_k=block_k,
            num_splits=num_splits, window=None,
            kv_mask=None if window is None else valid)[1]


def flash_decode_paged_slice(q, k_pool, v_pool, page_table, kv_len, *,
                             first_page: int, scale: float | None = None,
                             num_splits: int | None = None,
                             window: int | None = None):
    """The split partials ``(o_p, m_p, l_p)`` of one-token attention over
    the pages [first_page, first_page + num_pages) of a page pool cut
    over ranks: ``k_pool``, ``v_pool`` (hkv, num_pages, page_size, d) are
    this rank's pages, ``page_table`` (b, T) the global table and
    ``kv_len`` the global lengths. Entries of pages the rank does not own
    become -1, which ``masks.paged_block_layout`` forces SKIP, so the
    kernel (#8 on a CUDA tensor, its plain version on a CPU tensor) never
    forms their address; the table stays in logical page space, so the
    lengths and the window are the global ones. The splits resolve over
    the table's T pages with ``shards=1``."""
    from repro_torch.kernels.tuning import resolve_decode_geometry
    b, hq, sq, d = q.shape
    hkv, n, ps, _ = k_pool.shape
    T = page_table.shape[1]
    if sq != 1:
        raise ValueError("flash_decode_paged_slice handles single-token "
                         "decode")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    _, num_splits = resolve_decode_geometry(
        T * ps, None, num_splits, head_dim=d, dtype=k_pool.dtype,
        page_size=ps, shards=1, on_card=q.is_cuda, device=q.device)
    with torch.inference_mode():
        kv_len = kv_len.to(torch.int32)
        local = page_table.to(torch.int32) - first_page
        local = torch.where((local >= 0) & (local < n), local,
                            torch.full_like(local, -1))
        layout = M.paged_block_layout(kv_len, local, ps, window=window)
        return flash_decode_paged_from_layout(
            q, k_pool, v_pool, local, kv_len, layout, scale=scale,
            num_splits=num_splits, window=window)[1]
