"""The paper's IO-cost model (Theorem 2 / Props. 3-4), port of
``repro.core.io_model``: the device-independent HBM-byte and FLOP counts,
verbatim, the H100's rates and shared memory in place of the TPU's, and
the shared-memory arithmetic of the Hopper kernels.

Two granularities, as in the reference:

* **M-derived** (``flash_attention_hbm_bytes``): the paper's own accounting,
  parameterized by the SRAM budget M with ``B_c = ceil(M/4d)``.
* **Tile-derived** (``flash_hbm_bytes_tiled``, ``prefill_order_hbm_bytes``):
  the same pass counting for an explicit ``(block_q, block_k)`` and loop
  order; the serving engine's IO ledger prices its steps with these
  (``telemetry.io_ledger``).

``fwd_smem_bytes`` / ``bwd_smem_bytes`` (and ``attention_working_set_bytes``,
the reference's name for the larger of the two) are the shared memory one
block of ``kernels/csrc/flash_fwd.cu`` / ``flash_bwd.cu`` takes: the Hopper
counterpart of the reference's VMEM working sets of a Pallas grid step.
``kernels.tuning`` imports them, so there is one copy of the arithmetic.
The reference's kv-major and decode working sets
(``kv_major_working_set_bytes``, ``decode_working_set_bytes``) are kept as
its counts, verbatim: VMEM of a Pallas grid step at the TPU's lanes. No
Hopper tile decision reads them: the bodies walk q-major, and the decode
kernel's shared memory is its fixed ring (``flash_decode_smem_bytes``).
"""

from __future__ import annotations

import numpy as np

# paper Fig. 2 setting (A100): used for the analytic reproduction numbers
A100_SRAM_BYTES = 192 * 1024          # per SM
A100_HBM_BW = 1.555e12

# NVIDIA H100 SXM (data sheet; dense bf16 tensor-core rate, at 700 W): the
# bounds every kernel and serve step is held against
H100_HBM_BW = 3.35e12                 # bytes/s
H100_BF16_FLOPS = 989e12              # FLOP/s
H100_FP32_FLOPS = 67e12               # FLOP/s outside the tensor cores
H100_SMEM_PER_BLOCK = 232_448         # bytes of shared memory one block may use
# the tuner's default budget (``kernels.tuning.sram_budget``): what one
# block may hold, the card's counterpart of the reference's
# ``TPU_CORE_VMEM_BYTES // 2`` (half a TPU core's VMEM, the rest left to
# Pallas's double buffering); the Hopper bodies stage their own pipeline
# inside the footprint ``attention_working_set_bytes`` counts
DEFAULT_SRAM_BUDGET = H100_SMEM_PER_BLOCK

MAX_TILE = 64          # rows of a q or kv tile in the Hopper bodies
# the reference's f32 sublane count: a sequence-parallel engine rounds its
# prefill bucket to sp * SUBLANES rows, so that its chunks are the JAX
# engine's
SUBLANES = 8


# ---------------------------------------------------------------------------
# IO-cost model (exact accounting of Algorithm 0 vs Algorithm 1/5)
# ---------------------------------------------------------------------------

def standard_attention_hbm_bytes(n: int, d: int, heads: int, batch: int,
                                 elt: int = 2, fwd_and_bwd: bool = True) -> float:
    """Algorithm 0: Theta(Nd + N^2) accesses, counted exactly:
    fwd: read Q,K (2Nd) write S (N^2), read S write P (2N^2),
    read P,V (N^2 + Nd) write O (Nd) => 4Nd + 4N^2 (elements).
    bwd (Alg. 3): read P,dO write dV; read dO,V write dP; read P,dP write dS;
    read dS,K write dQ; read dS,Q write dK => 6Nd + 5N^2 + (dS write) N^2.
    """
    bh = batch * heads
    fwd = 4 * n * d + 4 * n * n
    bwd = 8 * n * d + 6 * n * n
    total = fwd + (bwd if fwd_and_bwd else 0)
    return float(total * bh * elt)


def flash_attention_hbm_bytes(n: int, d: int, heads: int, batch: int,
                              sram_bytes: float, elt: int = 2,
                              fwd_and_bwd: bool = True,
                              block_c: int | None = None) -> float:
    """Algorithm 1: Theta(N^2 d^2 M^-1). With B_c = ceil(M/4d) (paper line 1),
    T_c = ceil(N/B_c) passes over Q and O:
    fwd: read K,V once (2Nd) + T_c * (read Q + read/write O) (3Nd T_c)
    bwd (Alg. 4): K,V once + dK,dV once (4Nd) + T_c * (Q,O,dO,dQ r/w: 5Nd).
    """
    m_elems = sram_bytes / elt
    bc = block_c if block_c is not None else max(1, int(m_elems // (4 * d)))
    tc = int(np.ceil(n / bc))
    bh = batch * heads
    fwd = 2 * n * d + 3 * n * d * tc
    bwd = 4 * n * d + 5 * n * d * tc
    total = fwd + (bwd if fwd_and_bwd else 0)
    return float(total * bh * elt)


def blocksparse_flash_hbm_bytes(n: int, d: int, heads: int, batch: int,
                                sram_bytes: float, density: float,
                                elt: int = 2, fwd_and_bwd: bool = True) -> float:
    """Prop. 4: Theta(Nd + N^2 d^2 M^-1 s): the T_c passes scale by s."""
    m_elems = sram_bytes / elt
    bc = max(1, int(m_elems // (4 * d)))
    tc = int(np.ceil(n / bc))
    bh = batch * heads
    fwd = 2 * n * d + 3 * n * d * tc * density
    bwd = 4 * n * d + 5 * n * d * tc * density
    total = fwd + (bwd if fwd_and_bwd else 0)
    return float(total * bh * elt)


def attention_flops(n: int, d: int, heads: int, batch: int,
                    fwd_and_bwd: bool = True, recompute: bool = True) -> float:
    """Matmul FLOPs: fwd 4N^2d (QK^T + PV), bwd 8N^2d (dV, dP, dQ, dK)
    + recomputation of S in the flash backward (+2N^2d)."""
    bh = batch * heads
    fwd = 4 * n * n * d
    bwd = 8 * n * n * d + (2 * n * n * d if recompute else 0)
    return float((fwd + (bwd if fwd_and_bwd else 0)) * bh)


# ---------------------------------------------------------------------------
# Tile-level accounting
# ---------------------------------------------------------------------------

def flash_hbm_bytes_tiled(n_q: int, n_k: int, d: int, heads: int, batch: int,
                          block_q: int, block_k: int, elt: int = 2,
                          fwd_and_bwd: bool = True, density: float = 1.0,
                          kv_major: bool = False) -> float:
    """Theorem-2 pass counting for an EXPLICIT tile choice and loop order.

    ``kv_major=False`` is the forward/dq order (q outer, kv innermost,
    accumulators in registers across the kv sweep): Q read and O written
    once, K/V re-streamed once per q block => 3·N_q·d + 2·N_k·d·T_r with
    T_r = ceil(N_q/B_q). ``kv_major=True`` is the transposed order (the dkv
    backward kernel; also Alg. 1's outer loop): K/V once, Q/O per kv block.
    ``density`` scales the re-streamed term by the block layout's run
    fraction (Prop. 4): SKIP tiles are never read.

    The backward charges both orders (the dq kernel is q-major, the dkv
    kernel kv-major, each re-streaming the opposite operand set of
    {q, o, do} / {k, v} plus its own accumulator traffic).
    """
    bh = batch * heads
    t_r = int(np.ceil(n_q / block_q))
    t_c = int(np.ceil(n_k / block_k))
    if kv_major:
        fwd = 2 * n_k * d + 3 * n_q * d * t_c * density
    else:
        fwd = 3 * n_q * d + 2 * n_k * d * t_r * density
    # dq kernel (q-major): q,do read + dq written once (3·N_q·d); k,v,m,l,o
    # re-streamed per q block. dkv kernel (kv-major): k,v read + dk,dv
    # written once (4·N_k·d); q,o,do re-streamed per kv block.
    bwd = (3 * n_q * d + 3 * n_k * d * t_r * density
           + 4 * n_k * d + 3 * n_q * d * t_c * density)
    total = fwd + (bwd if fwd_and_bwd else 0)
    return float(total * bh * elt)


def prefill_order_hbm_bytes(n_q: int, n_k: int, d: int, heads_q: int,
                            heads_kv: int, batch: int, block_q: int,
                            block_k: int, elt: int = 2,
                            density: float = 1.0) -> dict[str, float]:
    """Head-aware forward HBM bytes for BOTH loop orders of one attention
    call — the cost surface the loop-order chooser compares.

    * ``q_major``: the default grid ``(b, hq, nq, nk)``. Per q head: q read
      and o/m/l written once, K/V re-streamed once per q block. With GQA the
      same kv head is additionally re-streamed by each of its ``hq/hkv``
      query heads: 2·N_k·d·T_r·h_q total kv bytes.
    * ``kv_major``: the resident-q transposed order, grid ``(b, hkv, 1, nk)``
      — the whole (grouped) query block stays resident across the kv
      sweep, so K/V are read exactly ONCE per kv head while q/o traffic is
      unchanged. Strictly cheaper whenever ``hq·T_r > hkv``; the catch is
      the working set, which is why it only wins at short-N_q/long-N_k
      (suffix-chunk) shapes. The Hopper bodies walk q-major.
    """
    t_r = int(np.ceil(n_q / block_q))
    q_side = 3 * n_q * d * heads_q                 # q read + o written, m/l ~0
    q_major = q_side + 2 * n_k * d * t_r * density * heads_q
    kv_major = q_side + 2 * n_k * d * density * heads_kv
    return {"q_major": float(q_major * batch * elt),
            "kv_major": float(kv_major * batch * elt)}


def gather_hbm_bytes(span: int, d: int, heads_kv: int, elt: int = 2,
                     layers: int = 1) -> float:
    """HBM cost of materializing a paged prefix contiguously before
    attending (a chunked prefill without the paged kernel): per layer, read
    K and V from the pool and write them back packed — 4·span·d·h_kv
    elements.
    The in-place paged kernel charges zero of this; adding it to the
    q_major total is what makes ``prefill_order_hbm_bytes`` prove the
    in-place win on the serving shapes."""
    return float(4 * span * d * heads_kv * elt * layers)


def prefix_cache_hbm_bytes_saved(cached: int, d: int, heads_q: int,
                                 heads_kv: int, elt: int = 2,
                                 layers: int = 1,
                                 block_q: int = 128) -> float:
    """HBM traffic a prefix-cache hit avoids: the prefill that never runs.

    A request mapping ``cached`` prompt rows from shared pages skips, per
    layer, (a) writing those rows' K/V into the pool (``2·cached·d·h_kv``),
    (b) the q-side traffic of attending them as queries (q read + o/m/l
    written, ``3·cached·d·h_q``), and (c) re-streaming the causal prefix
    under them — the q-major Theorem-2 term ``2·N_k·d·T_r·h_q`` with the
    average causal prefix ``N_k = cached/2`` and ``T_r = ceil(cached/B_q)``
    q-block sweeps (cf. ``prefill_order_hbm_bytes``). The suffix still
    pays its own (smaller) cost; this prices only the skipped rows, so the
    engine can credit a hit in the units its IO ledger prices steps in."""
    if cached <= 0:
        return 0.0
    t_r = int(np.ceil(cached / block_q))
    kv_writes = 2 * cached * d * heads_kv
    q_side = 3 * cached * d * heads_q
    kv_stream = 2 * (cached / 2) * d * t_r * heads_q
    return float((kv_writes + q_side + kv_stream) * elt * layers)


def kv_major_working_set_bytes(n_q_group: int, block_k: int, d: int,
                               in_elt: int = 4, acc_elt: int = 4,
                               lanes: int = 128) -> int:
    """The reference's VMEM residency of one kv-major forward grid step
    (the whole grouped query block of ``n_q_group`` rows resident, one
    (B_k x d) k/v tile streaming, m and l over the TPU's 128 lanes),
    verbatim. The port runs no kv-major
    order; this is the reference's count, kept bit-equal."""
    s_tile = n_q_group * block_k * acc_elt
    ml = n_q_group * lanes * acc_elt
    return int(2 * n_q_group * d * in_elt + 2 * block_k * d * in_elt
               + s_tile + n_q_group * d * acc_elt + 2 * ml)


def decode_working_set_bytes(block_k: int, d: int, in_elt: int = 4,
                             acc_elt: int = 4, lanes: int = 128) -> int:
    """The reference's VMEM residency of one split-KV decode grid step
    (k/v tiles, the (1, B_k) score row, the (1, d) / (1, 128-lane)
    accumulator scratch), verbatim. The Hopper decode's shared memory is
    its ring (``flash_decode_smem_bytes``), whatever the block."""
    return int(2 * block_k * d * in_elt + block_k * acc_elt
               + d * acc_elt + 2 * lanes * acc_elt)


# ---------------------------------------------------------------------------
# Shared memory of the Hopper attention kernels
# ---------------------------------------------------------------------------

def fwd_kv_groups(head_dim: int, paged: bool) -> int:
    """Warp groups that split one bf16 forward CTA's kv walk
    (``csrc/flash_fwd.cu`` kSplit) and one bf16 dq CTA's
    (``csrc/flash_bwd.cu`` kDqSplit): the paged prefill runs few CTAs,
    each walking a whole prefix, so its CTA splits the walk over 3 groups
    of 4 warps (2 above head_dim 64, for registers); a contiguous CTA is
    one group."""
    return (3 if head_dim <= 64 else 2) if paged else 1


def fwd_smem_bytes(block_q: int, block_k: int, head_dim: int, *,
                   bf16: bool = False, paged: bool = False) -> int:
    """Dynamic shared memory of one flash_fwd block.

    fp32 (the scalar body): the q tile, the K tile padded by one column
    (bank-conflict-free row dots), the V tile and the P tile.
    bf16 (the tensor-core body): whatever the tiles, Q at ``MAX_TILE``
    rows and, per warp group (``fwd_kv_groups``), two stages each of K and
    V at ``MAX_TILE`` rows, all bf16 (smaller tiles are zero-padded in
    place), then per group and stage the tile's kv_pos, kv_seg and kv_mask
    rows as int32, then the table of kv tile classes (one per thread):
    83,968 bytes contiguous and 151,552 paged at d = 128."""
    if bf16:
        groups = fwd_kv_groups(head_dim, paged)
        return (2 * head_dim * MAX_TILE * (1 + 2 * 2 * groups)
                + 4 * groups * (2 * 3 * MAX_TILE + 128))
    return 4 * (block_q * head_dim + block_k * (head_dim + 1)
                + block_k * head_dim + block_q * block_k)


def bwd_smem_bytes(block_q: int, block_k: int, head_dim: int, *,
                   bf16: bool = False, paged: bool = False) -> int:
    """Dynamic shared memory of the larger of the two backward blocks.

    fp32 (the scalar body) stages its tiles as fp32. dq: q and dO tiles,
    K and V tiles padded by one column, the dS tile. dkv: K, V, q and dO
    tiles padded by one column, the (P∘Z)ᵀ and dSᵀ tiles, and five per-row
    vectors (m, l, D, position, segment).
    bf16 (the tensor-core body), whatever the tiles: dq stages Q' and dO
    at ``MAX_TILE`` rows and, per warp group (``fwd_kv_groups``: 3, or 2
    above d = 64, paged; one contiguous), two stages each of K and V at
    ``MAX_TILE`` rows, all bf16, then per group and stage the tile's
    kv_pos, kv_seg and kv_mask rows as int32 and the class table (one entry
    a thread); dkv stages K, V and two stages each of Q' and dO at
    ``MAX_TILE`` rows, then per stage five per-row words, the class table
    (128 entries) and a 4-word reduction. At d = 128: 101,392 bytes
    contiguous (dkv is the larger) and 167,936 paged (dq)."""
    if bf16:
        groups = fwd_kv_groups(head_dim, paged)
        dq = (2 * head_dim * MAX_TILE * (2 + 2 * 2 * groups)
              + 4 * groups * (2 * 3 * MAX_TILE + 128))
        dkv = 2 * 6 * MAX_TILE * head_dim + 4 * (2 * 5 * MAX_TILE + 128 + 4)
        return max(dq, dkv)
    dq = 4 * (2 * block_q * head_dim + 2 * block_k * (head_dim + 1)
              + block_q * block_k)
    dkv = 4 * ((2 * block_k + 2 * block_q) * (head_dim + 1)
               + 2 * block_k * block_q + 5 * block_q)
    return max(dq, dkv)


def attention_working_set_bytes(block_q: int, block_k: int, d: int, *,
                                bf16: bool = False, paged: bool = False,
                                backward: bool = True) -> int:
    """Shared memory of one block of the attention kernels at these tiles
    (the reference's name, there the VMEM of a Pallas grid step): the
    forward's, or with ``backward`` the largest of the forward and the two
    backward blocks (one tile choice serves the forward and the backward,
    as in the reference). The tile helpers of ``kernels.tuning`` and the
    backward's launch check hold it against ``H100_SMEM_PER_BLOCK``."""
    fwd = fwd_smem_bytes(block_q, block_k, d, bf16=bf16, paged=paged)
    if not backward:
        return fwd
    return max(fwd, bwd_smem_bytes(block_q, block_k, d, bf16=bf16,
                                   paged=paged))


# ---------------------------------------------------------------------------
# Tensor-parallel serving costs
# ---------------------------------------------------------------------------

def tp_psum_hbm_bytes(n_tokens: int, d_model: int, shards: int,
                      elt: int = 2, reduces_per_layer: int = 2,
                      layers: int = 1) -> float:
    """Per-device bytes moved by the projection-boundary all-reduces of one
    tensor-parallel step (ring psum: each device sends+receives
    ``2 * (shards-1)/shards`` of the payload per reduce).

    The head-sharded serving layout needs exactly TWO reduces per layer —
    the attention-output and MLP down projections — and nothing inside
    attention/decode itself (GQA co-location), so this IS the step's whole
    communication tax. The payload is the activation tile
    ``n_tokens x d_model`` (logits never reduce: lm_head is replicated).
    """
    if shards <= 1:
        return 0.0
    payload = n_tokens * d_model * elt
    return float(2.0 * (shards - 1) / shards * payload
                 * reduces_per_layer * layers)


# A collective launch is not free even when its payload is: host-side
# dispatch, barriers and per-step latency amortize like a fixed byte cost.
# The ring strategy pays this (sp-1) times per layer, the all-gather once;
# it is what makes the strategy choice shape-dependent (the reference's
# constant, kept so that the counts agree).
SP_COLLECTIVE_LAUNCH_BYTES = 256 * 1024


def sp_prefill_hbm_bytes(chunk: int, prefix: int, d: int, heads_q: int,
                         heads_kv: int, sp: int, *, block_q: int = 128,
                         elt: int = 2, layers: int = 1) -> dict[str, float]:
    """Per-shard HBM + interconnect bytes of prefilling ONE chunk of
    ``chunk`` query rows against a ``prefix``-row causal prefix, three
    ways — the cost surface a sequence-parallel strategy choice
    minimizes:

    * ``replicated``: every shard runs the FULL chunk (the pre-sp, tp-only
      behaviour) — the q-major Theorem-2 forward term for ``chunk`` rows.
    * ``allgather``: each shard computes its ``chunk/sp`` slab, then one
      all-gather per layer materializes the full chunk K/V before the
      pool scatter. Pays the comm bytes plus a write+re-read of the
      gathered buffer's non-local part, but only ONE collective launch
      per layer.
    * ``ring``: ``sp - 1`` neighbor ppermutes per layer; each incoming
      slab is placed directly (no full-buffer round trip beyond the
      placement write the scatter needs anyway), at the price of
      ``sp - 1`` sequential collective launches per layer
      (``SP_COLLECTIVE_LAUNCH_BYTES`` each).

    Returns ``{"replicated", "allgather", "ring", "best"}`` where "best"
    names the cheaper sharded strategy (or "replicated" at sp=1). Small
    chunks favor the single gather launch; large chunks amortize the ring
    launches and skip the gather-buffer materialization.
    """
    sp = max(1, int(sp))
    n_k = prefix + chunk

    def _compute(rows: int) -> float:
        # q-major forward: q read + o written once, prefix K/V re-streamed
        # once per q block (flash_hbm_bytes_tiled, fwd only), GQA-aware.
        t_r = max(1, int(np.ceil(rows / block_q)))
        return float(3 * rows * d * heads_q + 2 * n_k * d * t_r * heads_q)

    replicated = _compute(chunk) * elt * layers
    if sp == 1:
        return {"replicated": replicated, "allgather": replicated,
                "ring": replicated, "best": "replicated"}

    slab = int(np.ceil(chunk / sp))
    kv_payload = 2.0 * chunk * d * heads_kv * elt          # full-chunk K+V
    comm = 2.0 * (sp - 1) / sp * kv_payload                # send + receive
    gather_extra = 2.0 * (sp - 1) / sp * kv_payload        # write + re-read
    allgather = ((_compute(slab) * elt + comm + gather_extra) * layers
                 + SP_COLLECTIVE_LAUNCH_BYTES * layers)
    ring = ((_compute(slab) * elt + comm) * layers
            + SP_COLLECTIVE_LAUNCH_BYTES * (sp - 1) * layers)
    best = "allgather" if allgather <= ring else "ring"
    return {"replicated": float(replicated), "allgather": float(allgather),
            "ring": float(ring), "best": best}


def tp_sharded_hbm_bytes(total_bytes: float, shards: int,
                         n_tokens: int = 0, d_model: int = 0,
                         elt: int = 2, reduces_per_layer: int = 2,
                         layers: int = 1) -> float:
    """Per-device HBM cost of a head-sharded attention step: the unsharded
    attention traffic divided over the shards (Q/K/V/O and the page pool
    all shard on heads) PLUS the psum bytes — the surface the report uses
    to show the real communication tax of going tensor-parallel."""
    local = float(total_bytes) / max(1, int(shards))
    return local + tp_psum_hbm_bytes(n_tokens, d_model, shards, elt=elt,
                                     reduces_per_layer=reduces_per_layer,
                                     layers=layers)
