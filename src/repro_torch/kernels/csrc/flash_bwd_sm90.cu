// FlashAttention backward (paper Alg. 4, split into a dq and a dkv kernel)
// on Hopper's own instructions, sm_90a: wgmma, TMA and an mbarrier ring fed
// by a producer warp. The bf16 pair at head_dim 64, 96 or 128 over 64-row q
// blocks: contiguous K/V over a layout compiled at block_q = block_k = 64
// (Paged = false), or K/V read in place from page-pool pages of 8, 16, 32 or
// 64 rows through a page list, the layout's kv block one page (Paged = true).
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/flash_attention.py:flash_attention_backward:
//   * flash_bwd_dq_sm90_kernel<D, false, .>  <- `_dq_kernel` (pl.pallas_call
//     at l.581)
//   * flash_bwd_dkv_sm90_kernel<D, false, .> <- `_dkv_kernel` (pl.pallas_call
//     at l.612) together with the GQA group sum outside it (l.631-636);
// and of src/repro/kernels/flash_attention.py:flash_prefill_paged_backward:
//   * flash_bwd_dq_sm90_kernel<D, true, false>  <- the paged dq
//     (pl.pallas_call at l.851)
//   * flash_bwd_dkv_sm90_kernel<D, true, false> <- the paged dkv
//     (pl.pallas_call at l.897) with its GQA sum (l.918-920), writing fp32
//     rows of the PACKED page-aligned (b, hkv, T*ps, D) layout, which
//     flash_bwd.cu's fold kernel sums into pool shape.
// flash_bwd.cu keeps the other instantiations of the pair: fp32 (the
// scalar parity body), head dims 16 and 32 and tiles below 64, all on
// mma.sync, and the fold. The function is the same as
// there: P = diag(l)^-1 exp(S - m) recomputed from the pre-scaled
// q' = scale * q, k and the forward's (m, l) (rows with l = 0 use m = 0,
// l = 1 and contribute nothing), dP = dO V^T (o Z), dS = P o (dP - D),
// dq = scale * dS K, dK = dS^T q', dV = (P o Z)^T dO, the dropout keep mask
// regenerated from the hash of flash_common.cuh, and the SAME compiled
// block layout as the forward. D = rowsum(dO o O) and q' come from the
// caller.
//
// What bounds it on an H100: the pair does seven products of 2*d FLOPs per
// unmasked (q, k) pair (S and dP in both kernels, dV, dK, dq), the bound
// counts the five of a fused backward; at the training shapes that is
// ~1e11 FLOP against ~1.5e8 bytes, bound by operations (989 TFLOP/s bf16).
// The mma.sync body (flash_bwd.cu) stays far above that bound because its
// 16-row warps issue small products between element work and reload every
// K/V (dq) or Q'/dO (dkv) tile once per 64 rows, copies and products taking
// turns. This body:
//   * issues every product as a warpgroup wgmma m64nNk16: S and dP with
//     both operands in shared memory (K-major, 128-byte swizzle), dV, dK
//     and dq with A (P, dS rounded to bf16) taken from registers and B read
//     MN-major (the transposed operand), N split into 64-column chunks
//     (64 + 32 at d = 96), each chunk one 64-column TMA box;
//   * loads every tile by TMA (cp.async.bulk.tensor, 64 x 64 boxes of a
//     (d, seq, b*h) tensor map, 128-byte swizzle; a row wider than 64 is
//     several boxes, 8 KiB apart, the last one zero-filled past d = 96)
//     and the per-row vectors (m, l, D, positions, segments, kv_mask) by
//     bulk copies, all completing on the stage's `full` mbarrier;
//   * runs three warpgroups: warpgroup 2 is the producer (one thread
//     issues the copies into a ring of STAGES = 4 stages, each guarded by
//     a full and an empty mbarrier; the paged pair: 8 stages at d 64, and
//     four warps feed the paged dq's ring), warpgroups 0 and 1 consume;
//   * works on wgmma's accumulator layout, which within a warp is
//     mma.sync's C fragment repeated every 8 columns (rows 16w + g and
//     16w + g + 8, columns 8j + 2*t4 + {0, 1}), so the mask, P-from-(m, l)
//     and dropout code of the mma.sync body carries over, and so does
//     FlashAttention-2's C -> A trick (two adjacent n8 blocks of C are the
//     A fragment of one k16 step);
//   * keeps the element work between products short and branch-free: the
//     mask terms a call has are hoisted (ElementMask), a FULL tile skips the
//     mask, P is one FFMA and one ex2.approx.ftz (a probability below
//     2^-126 flushes to 0), the lse of an item's 64 q rows is computed once
//     per warpgroup into shared memory (dkv) or once per CTA (dq), and the
//     dropout keep bits of an item are made before its products start.
//     With exp2f (its denormal fix-ups) and per-element mask branches the
//     element loop ran one element at a time and set the pace, not the
//     tensor cores;
//   * overlaps products with element work inside a warpgroup: S and dP are
//     issued together, P is computed while dP runs; dkv then issues dV and
//     computes dS while dV runs (d 64 and 96), and dK (dq: dS K) is left in
//     flight into the next item, whose S wait also releases the stage it
//     reads (the `held` stage; dkv at d 64 only, see registers);
//   * registers: 2 x 128 consumer threads at 240 (setmaxnreg), the
//     producer's 128 at 24 (it re-reads what it needs from the parameters
//     and shared memory instead of carrying it across setmaxnreg). At d 128
//     dkv holds dK and dV (128 fp32 a thread) beside S^T and dP^T (64):
//     it always takes the 128-row tile (no alternation or merge), waits
//     for dV before dS, reads its keys' positions, segments and kv_mask
//     only in masked items and keeps the dropout bits in shared memory,
//     and ptxas reports no spill for any instantiation.
//
// CTA tile, `rows` (64 or 128, chosen per shape by tuning.sm90_bwd_rows:
// 128 where the 128-row grid still fills the card, and always for dkv at
// d 128):
//   * dkv: one CTA per (b, hkv, `rows` keys). At 128 the two consumer
//     warpgroups own 64 keys each, which is one layout column each, and
//     both read every stage; a stage runs if either column runs, and each
//     warpgroup applies its own column's class (SKIP, FULL, PARTIAL,
//     PARTIAL_DATA), so the mask is exact per element. At 64 both
//     warpgroups own the CTA's 64 keys and take alternate (q-block, head)
//     items, and warpgroup 0 adds warpgroup 1's dK, dV at the end (a fixed
//     order). The walk is the layout column's q-blocks that run, each for
//     the n_rep heads of the GQA group (the group sum stays in fp32
//     registers; dk, dv are written once in bf16).
//   * dq: one CTA per (b, hq, `rows` q rows), the same way round: at 128
//     each warpgroup owns one layout row and the stage is the kv tile; at
//     64 both own the same 64 q rows, take alternate kv tiles and merge.
//     dq = scale * dq once at the end. Grid order: longest walks first,
//     as flash_bwd.cu (dkv key block 0 up, dq q block nq - 1 down).
//   * the walk is compacted before the roles split: all 384 threads read
//     the layout column (dkv) or row (dq) once and write the indices that
//     run, in order, with their classes, into shared memory (at most
//     MAX_WALK tiles); producer and consumers then step through the same
//     list, so no stage carries an end marker.
//   * a 128-row tile over a sequence padded only to 64: the second
//     warpgroup's rows lie past the end; TMA zero-fills them, their class
//     is SKIP, and nothing is written there.
// Paged (the trainable paged prefill's backward: a chunk of q rows against a
// paged prefix; no dropout, no kv_mask, as in the JAX package). What differs
// from the contiguous body, and why:
//   * K/V come from a (d, num_pages * ps, hkv) tensor map in boxes of one
//     page (sm90_common.cuh: make_paged_map, paged_kv_box): a 64-key tile is
//     64 / ps boxes a 64-column chunk, at row offsets jj * ps of the tile (a
//     multiple of 8 rows, so the 128-byte swizzle is the contiguous tile's).
//     A page that does not run (a dead slot, a slot past the list, a page
//     SKIP for every row the CTA reads it for) is asked past the pool: TMA
//     zero-fills it and counts its bytes, and the page is never addressed.
//   * the walk's entries are the tile index and each warpgroup's word of
//     per-page bits (sm90_common.cuh: tile_word, build_walk): each page of a
//     tile applies its own class (SKIP, FULL, PARTIAL, PARTIAL_DATA) to its
//     ps keys, so the mask is exact per element; a page that does not run
//     has P = 0 (its zero-filled K gives S = 0, which the select drops). A
//     tile all of whose pages run as FULL skips the mask. Every wgmma of an
//     item is issued on every path (no product sits under a per-page branch,
//     which ptxas would serialize: its note C7520).
//   * dq: the stage is one 64-key tile of the layout row, its pages issued
//     one box a lane (up to 32 boxes: page 8 at d 96 / 128) by one of the
//     producer warpgroup's four warps, which take the walk's tiles in turn
//     (a stage belongs to one warp); each lane reads its slot's page of the
//     warp's next tile from the page list while the current tile's boxes go
//     out; the tile's kv_pos / kv_seg (a ragged last tile: its columns
//     inside T * ps) by bulk copies on the same `full` barrier. One warp
//     issuing every tile set the pace at the paged grad shape (24-tile
//     walks); scripts/sm90_paged_probe.py times one, two and four warps and
//     4 or 8 stages at d 64 (PERF.md §6). The walk of a long prefix is the
//     contiguous body's dq walk over its tiles.
//   * dkv: the CTA's `rows` keys are one page group (64 keys) per consumer
//     warpgroup, loaded once by TMA (up to 64 boxes at page 8 and d 128 with
//     the 128-key tile: two a producer lane); the pages the walk never runs
//     are read as zeros and their packed rows written as 0. The walk is the
//     q-blocks of its page groups' layout column that run, each for the
//     n_rep heads of the GQA group, Q' and dO streamed through the ring as
//     in the contiguous body; the group sum stays in fp32 registers and the
//     epilogue writes fp32 packed rows of the slots < T (the fold drops the
//     dead ones). A page shared by two rows is two packed slots; the fold
//     adds them in its fixed order.
// Deterministic: no atomics on any sum; every sum (k16 steps, items in list
// order, the 64-row merge) has a fixed order, so two calls are
// bit-identical. (The dkv CTA ORs its walk's page bits into shared memory
// with atomicOr: an OR, whatever its order.)

#include "sm90_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int MAX_WALK = 2048;             // tiles of one layout row / column
constexpr int PAGED_PRODUCERS = 4;         // paged dq: producer warps, an item each in turn
constexpr int META_BYTES = 5 * 64 * 4;     // per stage: five 64-entry vectors

// list entries: tile index << 8 | terms of warpgroup 0 | terms of wg 1 << 4,
// terms = run (1) | geometric terms (2) | data terms (4)
constexpr uint32_t RUNS_ANY = 0x11u;

struct Sm90Params {
  CUtensorMap tq, tdo;   // (d, sq, b * hq)
  CUtensorMap tk, tv;    // (d, sk, b * hkv)
  const float* m;        // (b, hq, sq)
  const float* l;
  const float* dd;       // D = rowsum(dO o O)
  void* out0;            // dq | dk (paged: fp32 packed rows)
  void* out1;            // -  | dv
  const int32_t* page_list;   // paged: (b, nk) physical pages; K/V pools
  MaskParams mask;
  DropoutParams drop;
  int b, hq, hkv, sq, sk, nq, nk;
  int ntiles;            // 64-key tiles of the key axis: nk, or ceil(nk * ps / 64) paged
  int lg_ps;             // paged: log2 of the page size
  int num_pages;         // paged: pages of the pool
  int rows;              // CTA tile: 64 or 128
  float scale;
  float z_keep;          // Z of a kept element, 1 / (1 - p) (read from the
                         // parameters where used: no register holds it)
};

template <int D, bool Paged>
struct Smem {
  static constexpr int NB = (D + BOX - 1) / BOX;   // boxes per 64-row tile
  static constexpr int TILE = NB * BOX_BYTES;     // one 64-row tile
  // ring depth: 4, and 8 for the paged pair at d 64, where shared memory
  // holds them beside the walk's page words
  static constexpr int STAGES = Paged && D == 64 ? 8 : 4;
  // dkv: K[2], V[2] (the CTA's keys), Q'[STAGES], dO[STAGES];
  // dq:  Q'[2], dO[2] (the CTA's q rows), K[STAGES], V[STAGES]
  static constexpr int own0 = 0, own1 = 2 * TILE;
  static constexpr int ring0 = 4 * TILE, ring1 = ring0 + STAGES * TILE;
  static constexpr int meta = ring1 + STAGES * TILE;
  static constexpr int bars = meta + STAGES * META_BYTES;
  // the walk: contiguous, one word an entry (tile << 8 | each warpgroup's
  // terms); paged, the tile indices and each warpgroup's word of per-page
  // bits (MAX_WALK each), then dkv's page slots' pages (MAX_PAGES for each
  // of two page groups) and the union of each group's page bits over the walk
  static constexpr int walk = bars + 8 * (2 * STAGES + 2);
  static constexpr int walk_bytes = Paged ? 4 * (3 * MAX_WALK + 2 * MAX_PAGES + 2) : 4 * MAX_WALK;
  static constexpr int counts = walk + walk_bytes;
  // dkv: per consumer warpgroup two 64-entry lse vectors (by item parity)
  static constexpr int lse = counts + 4 * (WARPS_ALL + 4);   // + the walk's length
  // dkv with dropout: each consumer thread's keep bits of its item
  static constexpr int keep = lse + CONSUMERS * 2 * 64 * 4;
  static constexpr int bytes = keep + CONSUMERS * 128 * 4;
  static constexpr size_t launch_bytes = bytes + 1024;   // 1 KiB alignment slack
  // the 64-row merge hands a warpgroup's fp32 accumulators through the ring
  static_assert(2 * 128 * (D / 2) * 4 <= 2 * STAGES * TILE, "merge buffer exceeds the ring");
  static_assert(bytes + 1024 <= 232448, "shared memory of one block");
  // a warpgroup holds its last item's stage until its next item's S has
  // landed; the 64-row tile's alternate items are two apart
  static_assert(STAGES >= 3, "the held stage would be the one the next item waits for");
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}
// the 128 threads of warpgroup wg (named barriers 2 and 3)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// P = exp2(s * log2(e) - lse) with lse = m * log2(e) + log2(l); a row with
// l = 0 uses m = 0, l = 1 (`_recompute_p`)
__device__ __forceinline__ float log2_lse(float m, float l) {
  return l == 0.f ? 0.f : fmaf(m, LOG2E, __log2f(l));
}

// Ordered compaction of the n candidate tiles into `walk` (entries whose
// RUNS_ANY bits are set), by every thread of the CTA; the count lands in
// counts[WARPS_ALL], where both roles read it (a register would carry it
// across setmaxnreg and through the whole walk)
template <typename F>
__device__ __forceinline__ void build_walk(uint32_t* walk, int* counts, int n, F entry) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int count = 0;
  for (int base = 0; base < n; base += THREADS_ALL) {
    const int i = base + tid;
    const uint32_t e = i < n ? entry(i) : 0u;
    const bool runs = (e & RUNS_ANY) != 0u;
    const unsigned bal = __ballot_sync(0xffffffffu, runs);
    if (lane == 0) counts[warp] = __popc(bal);
    __syncthreads();
    int off = count, total = 0;
    // not unrolled: before the roles split, registers are the producer's few
#pragma unroll 1
    for (int w = 0; w < WARPS_ALL; ++w) {
      const int c = counts[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (runs) walk[off + __popc(bal & ((1u << lane) - 1u))] = e;
    count += total;
    if (tid == 0) counts[WARPS_ALL] = count;
    __syncthreads();
  }
}

// --------------------------------------------------------------------------
// dkv: one CTA per (key tile, hkv, b)
// --------------------------------------------------------------------------
template <int D, bool Paged, bool Dropout>
__global__ void __launch_bounds__(THREADS_ALL, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ Sm90Params p) {
  static_assert(!(Paged && Dropout), "paged K/V never take dropout");
  using S = Smem<D, Paged>;
  constexpr int STAGES = S::STAGES;               // ring depth
  extern __shared__ unsigned char smem_raw[];
  // 1 KiB aligned (the 128-byte swizzle's pattern repeats every 1 KiB),
  // as an offset of smem_raw so that loads stay shared-space loads
  unsigned char* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* own_bar = empty + STAGES;
  // contiguous: the walk's entries; paged: its q-block indices, each
  // warpgroup's words, the CTA's pages and their union over the walk
  uint32_t* walk = reinterpret_cast<uint32_t*>(sm + S::walk);
  uint32_t* wb0 = walk + MAX_WALK;
  uint32_t* wb1 = wb0 + MAX_WALK;
  int* cta_pages = reinterpret_cast<int*>(wb1 + MAX_WALK);
  uint32_t* col_live = reinterpret_cast<uint32_t*>(cta_pages + 2 * MAX_PAGES);
  int* counts = reinterpret_cast<int*>(sm + S::counts);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int kvh = blockIdx.x, b = blockIdx.y, ct = blockIdx.z;
  // one layout column (paged: one 64-key page group) per warpgroup; d 128
  // always takes it (the 64-row tile's alternate items and merge cost
  // registers its dK, dV leave none for)
  const bool two = D == 128 || p.rows == 128;
  const int kc0 = two ? 2 * ct : ct;              // the CTA's first layout column
  const int n_rep = p.hq / p.hkv;
  const MaskParams mp = p.mask;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], (two ? CONSUMERS : 1) * 128);
    }
    mbar_init(own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (Paged) {
    // the pages of the CTA's two page groups' slots (the second one's are
    // read only with `two`), read once, before any page address is formed
    if (tid < 2) {
      int pages[MAX_PAGES];
      tile_pages(p.page_list, b, p.nk, kc0 + tid, p.lg_ps, pages);
#pragma unroll
      for (int j = 0; j < MAX_PAGES; ++j) cta_pages[tid * MAX_PAGES + j] = pages[j];
      col_live[tid] = 0u;
    }
    __syncthreads();
    uint32_t u0 = 0u, u1 = 0u;                    // this thread's page bits
    build_walk<false>(walk, wb0, wb1, nullptr, counts, p.nq,
                      [&](int qi, uint32_t& w0, uint32_t& w1, int (&)[MAX_PAGES]) {
      int pages[MAX_PAGES];
#pragma unroll
      for (int j = 0; j < MAX_PAGES; ++j) pages[j] = cta_pages[j];
      w0 = tile_word<true>(mp, b, qi, kc0, p.nq, p.nk, p.sk, p.lg_ps, pages);
      if (two) {
#pragma unroll
        for (int j = 0; j < MAX_PAGES; ++j) pages[j] = cta_pages[MAX_PAGES + j];
        w1 = tile_word<true>(mp, b, qi, kc0 + 1, p.nq, p.nk, p.sk, p.lg_ps, pages);
      }
      u0 |= w0;
      u1 |= w1;
    });
    // each group's pages that run for some item of the walk
    u0 = __reduce_or_sync(0xffffffffu, u0 & 0xffu);
    u1 = __reduce_or_sync(0xffffffffu, u1 & 0xffu);
    if (lane == 0) {
      atomicOr(&col_live[0], u0);
      atomicOr(&col_live[1], u1);
    }
    __syncthreads();
  } else {
    build_walk(walk, counts, p.nq, [&](int qi) {
      uint32_t e = terms(mp, b, qi, kc0);
      if (two && kc0 + 1 < p.nk) e |= terms(mp, b, qi, kc0 + 1) << 4;
      return ((uint32_t)qi << 8) | e;
    });
  }
  // the walk's length: read from shared memory by each role where needed
  const int* walk_len = counts + WARPS_ALL;

  // the producer: one thread issues every copy. It runs on 24 registers,
  // so what it needs is read again from the parameters and shared memory
  // rather than carried across setmaxnreg
  auto produce = [&]() {
    const int n = *walk_len * n_rep;
    const int ntile = two ? 2 : 1;
    if constexpr (Paged) {
      // the first warp loads the CTA's K/V pages, one box a lane (two where
      // the tile is two page groups of 8 pages at d 96 / 128); then its
      // first thread feeds the ring
      if (threadIdx.x >= CONSUMERS * 128 + 32 || n == 0) return;
      const int lane = threadIdx.x & 31;
      if (lane == 0) mbar_expect(own_bar, 2 * ntile * S::TILE);
      __syncwarp();                                 // the bytes are expected first
      constexpr int PER = 2 * S::NB * MAX_PAGES;    // boxes of one page group
      for (int bx = lane; bx < ntile * PER; bx += 32) {
        const int tt = bx / PER, x = bx % PER;
        paged_kv_box<S::NB>(x, sm + S::own0 + tt * S::TILE, sm + S::own1 + tt * S::TILE, &p.tk,
                            &p.tv, own_bar, col_live[tt],
                            cta_pages[tt * MAX_PAGES + box_page<S::NB>(x)],
                            p.lg_ps, p.num_pages, kvh);
      }
      if (lane != 0) return;
    } else {
      if (threadIdx.x != CONSUMERS * 128 || n == 0) return;
      mbar_expect(own_bar, 2 * ntile * S::TILE);
      for (int t = 0; t < ntile; ++t) {
        const int r0 = (kc0 + t) * BOX;
        tma_tile<D>(sm + S::own0 + t * S::TILE, &p.tk, own_bar, r0, b * p.hkv + kvh);
        tma_tile<D>(sm + S::own1 + t * S::TILE, &p.tv, own_bar, r0, b * p.hkv + kvh);
      }
    }
    const unsigned bytes =
        2 * S::TILE + 3 * 256 + (p.mask.q_pos ? 256 : 0) + (p.mask.q_seg ? 256 : 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      const int qi = (int)(Paged ? walk[i / n_rep] : walk[i / n_rep] >> 8);
      const int h = kvh * n_rep + i % n_rep;
      mbar_expect(&full[s], bytes);
      tma_tile<D>(sm + S::ring0 + s * S::TILE, &p.tq, &full[s], qi * BOX, b * p.hq + h);
      tma_tile<D>(sm + S::ring1 + s * S::TILE, &p.tdo, &full[s], qi * BOX, b * p.hq + h);
      float* meta = reinterpret_cast<float*>(sm + S::meta + s * META_BYTES);
      const long long row0 = ((long long)b * p.hq + h) * p.sq + (long long)qi * BOX;
      bulk_copy(meta, p.m + row0, 256, &full[s]);
      bulk_copy(meta + 64, p.l + row0, 256, &full[s]);
      bulk_copy(meta + 128, p.dd + row0, 256, &full[s]);
      const long long pos0 = (long long)b * p.sq + (long long)qi * BOX;
      if (p.mask.q_pos) bulk_copy(meta + 192, p.mask.q_pos + pos0, 256, &full[s]);
      if (p.mask.q_seg) bulk_copy(meta + 256, p.mask.q_seg + pos0, 256, &full[s]);
    }
  };

  // the consumers: two warpgroups
  auto consume = [&]() {
    const int w4 = warp & 3, g = lane >> 2, t4 = lane & 3;
    const int rb = two ? wg : 0;                    // this warpgroup's key tile
    const int kcol = kc0 + rb;                      // and its layout column
    const bool col_in = kcol < p.ntiles;
    const uint32_t* wbr = rb ? wb1 : wb0;           // paged: this warpgroup's words
    // paged: the word of a tile all of whose pages run unmasked
    const uint32_t all_live = Paged ? (1u << (BOX >> p.lg_ps)) - 1u : 0u;
    // this thread's two keys (rows 16 w4 + g + 8 hh of the tile)
    // this thread's keys: key0 and key0 + 8 (their positions, segments and
    // kv_mask are read in a masked item only: registers are scarce at d 128)
    const int key0 = kcol * BOX + 16 * w4 + g;
    constexpr int NA = D / 2;                       // registers of a 64 x D accumulator
    float dk[NA], dv[NA];
#pragma unroll
    for (int x = 0; x < NA; ++x) dk[x] = dv[x] = 0.f;
    const uint32_t k_tile = smem_addr(sm + S::own0 + rb * S::TILE);
    const uint32_t v_tile = smem_addr(sm + S::own1 + rb * S::TILE);
    float* lse_s = reinterpret_cast<float*>(sm + S::lse) + wg * 128;
    uint32_t* keep_s = reinterpret_cast<uint32_t*>(sm + S::keep) + wg * 128;
    const int t = tid & 127;
    if (*walk_len > 0) mbar_wait(own_bar, 0);

    int mine = 0;          // items this warpgroup computed (picks the lse vector)
    int held = -1;         // the stage the last dK product still reads
    for (int i = 0; i < *walk_len * n_rep; ++i) {
      if (!two && (i & 1) != wg) continue;          // 64-row tile: alternate items
      const int s = i % STAGES;
      const uint32_t e = walk[i / n_rep];
      // contiguous: this warpgroup's terms; paged: its word of page bits
      const uint32_t bits = Paged ? 0u : (e >> (4 * rb)) & 7u;
      const uint32_t w = Paged ? wbr[i / n_rep] : 0u;
      const bool runs = Paged ? (w & 0xffu) != 0u : (bits & 1u) != 0u;
      if (!(runs && col_in)) {
        // release the held stage before waiting: the copies of a later item
        // may wait for it
        if (held >= 0) {
          wg_wait<0>();
          mbar_arrive(&empty[held]);
          held = -1;
        }
        mbar_wait(&full[s], (i / STAGES) & 1);
        mbar_arrive(&empty[s]);
        continue;
      }
      mbar_wait(&full[s], (i / STAGES) & 1);
      const int qi = (int)(Paged ? e : e >> 8), h = kvh * n_rep + i % n_rep;
      const uint32_t q_tile = smem_addr(sm + S::ring0 + s * S::TILE);
      const uint32_t do_tile = smem_addr(sm + S::ring1 + s * S::TILE);
      const float* meta = reinterpret_cast<const float*>(sm + S::meta + s * META_BYTES);
      const int* imeta = reinterpret_cast<const int*>(meta);
      // the item's 64 q rows' lse, once per warpgroup; two vectors by item
      // parity, so one barrier orders these writes after the reads of the
      // item before
      float* lse = lse_s + 64 * (mine++ & 1);
      if (t < 64) lse[t] = log2_lse(meta[t], meta[64 + t]);
      warpgroup_sync(wg);
      // the dropout keep mask, before the accumulators are live; kept in
      // shared memory (this thread's word) between its two uses
      if constexpr (Dropout) {
        const DropoutParams& drop = p.drop;
        const uint32_t row0 = ((uint32_t)b + drop.b0) * drop.num_heads + (uint32_t)h + drop.h0;
        const uint32_t base = row0 * drop.q_len + (uint32_t)(qi * BOX);
        uint32_t keep = 0u;
#pragma unroll 4
        for (int x = 0; x < 32; ++x) {
          const uint32_t c = 8 * (x >> 2) + 2 * t4 + (x & 1);
          const uint32_t idx = (base + c) * drop.k_len + (uint32_t)(key0 + 8 * ((x >> 1) & 1));
          keep |= (uint32_t)(mix32(idx ^ drop.seed_mix) >= drop.threshold) << x;
        }
        keep_s[t] = keep;
      }
      // S^T = K Q'^T and dP^T = V dO^T: rows = keys, columns = q rows
      float st[32], dpt[32];
      wg_fence();
      ss_product<D>(st, k_tile, q_tile);
      wg_commit();
      ss_product<D>(dpt, v_tile, do_tile);
      wg_commit();
      wg_wait<1>();                                 // S^T (and the last dK) landed
      if (held >= 0) mbar_arrive(&empty[held]);
      held = -1;
      pin<32>(st);
      // P^T, masked, while dP^T runs (paged: a tile whose pages do not all
      // run unmasked; each of this thread's two keys takes its page's bits)
      const bool geo_on = bits & 2u, data_on = bits & 4u;
      if (Paged ? w != all_live : (geo_on || data_on)) {
        // the mask's terms and operands are read from the kernel's parameters
        // here (no register holds them through the loop)
        const ElementMask em(p.mask);
        int kpos[2], kseg[2], kval[2];
        bool live[2], geo[2], data[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = key0 + 8 * hh;
          const bool in = !Paged || key < p.sk;     // paged: a ragged last group
          const long long kv_row = (long long)b * p.sk + key;
          kpos[hh] = p.mask.kv_pos != nullptr && in ? p.mask.kv_pos[kv_row] : key;
          kseg[hh] = p.mask.kv_seg != nullptr && in ? p.mask.kv_seg[kv_row] : 0;
          kval[hh] = p.mask.kv_mask != nullptr ? p.mask.kv_mask[kv_row] : 1;
          if constexpr (Paged) {
            const int j = (key & (BOX - 1)) >> p.lg_ps;   // the key's page slot
            live[hh] = (w >> j) & 1u;
            geo[hh] = (w >> (8 + j)) & 1u;
            data[hh] = (w >> (16 + j)) & 1u;
          } else {
            live[hh] = true;
            geo[hh] = geo_on;
            data[hh] = data_on;
          }
        }
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int c = 8 * (x >> 2) + 2 * t4 + (x & 1);   // q row within the q-block
          const int hh = (x >> 1) & 1;
          const int qpos =
              p.mask.q_pos != nullptr ? imeta[192 + c] : qi * BOX + c + p.mask.q_offset;
          const int qseg = p.mask.q_seg != nullptr ? imeta[256 + c] : 0;
          const bool ok = live[hh] & em.ok(geo[hh], data[hh], qpos, qseg, kpos[hh], kseg[hh],
                                           kval[hh], key0 + 8 * hh);
          const float pv = ex2(fmaf(st[x], LOG2E, -lse[c]));
          st[x] = ok ? pv : 0.f;
        }
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int c = 8 * (x >> 2) + 2 * t4 + (x & 1);
          st[x] = ex2(fmaf(st[x], LOG2E, -lse[c]));
        }
      }
      // dV += (P o Z)^T dO: the kept P (Z's 1 / (1 - p) once at the end)
      uint32_t pa[4][4];
      to_a(pa, st, Dropout ? keep_s[t] : ~0u);
      wg_fence();
      rs_product<D>(dv, pa, do_tile);
      wg_commit();
      if constexpr (D == 128) {
        wg_wait<0>();      // d 128: pa's registers are needed for dS (no spill)
      } else {
        wg_wait<1>();      // dP^T landed; dV may still run
      }
      pin<32>(dpt);
      // dS^T = P^T o (dP^T o Z - D), the undropped P (0 where masked)
      const uint32_t keep = Dropout ? keep_s[t] : ~0u;
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int c = 8 * (x >> 2) + 2 * t4 + (x & 1);
        float dpz = dpt[x];
        if constexpr (Dropout) dpz = ((keep >> x) & 1u) ? dpz * p.z_keep : 0.f;
        dpt[x] = st[x] * (dpz - meta[128 + c]);
      }
      wg_wait<0>();                                 // dV read pa: its registers are free
      uint32_t sa[4][4];
      to_a(sa, dpt);
      // dK += dS^T Q'
      wg_fence();
      rs_product<D>(dk, sa, q_tile);
      wg_commit();
      if constexpr (D == 64) {
        held = s;                                   // released once dK has read it
      } else {
        // wider rows: dK's A fragments would stay live through the next
        // item's products and spill; wait for dK here instead
        wg_wait<0>();
        mbar_arrive(&empty[s]);
      }
    }
    wg_wait<0>();
    if (held >= 0) mbar_arrive(&empty[held]);
    pin<NA>(dk);
    pin<NA>(dv);

    if (!two) {
      // warpgroup 0 adds warpgroup 1's sums through the (now idle) ring
      float* buf = reinterpret_cast<float*>(sm + S::ring0);
      consumer_sync();
      if (wg == 1) {
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          buf[(2 * x) * 128 + t] = dk[x];
          buf[(2 * x + 1) * 128 + t] = dv[x];
        }
      }
      consumer_sync();
      if (wg == 1) return;
#pragma unroll
      for (int x = 0; x < NA; ++x) {
        dk[x] += buf[(2 * x) * 128 + t];
        dv[x] += buf[(2 * x + 1) * 128 + t];
      }
    }
    if (!col_in) return;
    if constexpr (Paged) {
      // fp32 packed rows of the group's slots < nk; a slot whose page never
      // runs (dead, or SKIP for every item) is written as 0
      const uint32_t live = col_live[rb];
      float* dkg = static_cast<float*>(p.out0) + ((long long)b * p.hkv + kvh) * p.sk * D;
      float* dvg = static_cast<float*>(p.out1) + ((long long)b * p.hkv + kvh) * p.sk * D;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int key = key0 + 8 * hh;
        if (key >= p.sk) continue;
        const bool runs = (live >> ((key & (BOX - 1)) >> p.lg_ps)) & 1u;
        const long long o = (long long)key * D;
#pragma unroll
        for (int x = 2 * hh; x < NA; x += 4) {
          const int col = col_of(x, t4);
          *reinterpret_cast<float2*>(dkg + o + col) =
              runs ? make_float2(dk[x], dk[x + 1]) : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(dvg + o + col) =
              runs ? make_float2(dv[x], dv[x + 1]) : make_float2(0.f, 0.f);
        }
      }
      return;
    }
    // the tile's keys in k's dtype; dV takes Z's 1 / (1 - p) here
    bf16* dkg = static_cast<bf16*>(p.out0) + ((long long)b * p.hkv + kvh) * p.sk * D;
    bf16* dvg = static_cast<bf16*>(p.out1) + ((long long)b * p.hkv + kvh) * p.sk * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long o = (long long)(key0 + 8 * hh) * D;
#pragma unroll
      for (int x = 2 * hh; x < NA; x += 4) {
        const int col = col_of(x, t4);
        *reinterpret_cast<uint32_t*>(dkg + o + col) = pack_bf16(dk[x], dk[x + 1]);
        const float z = Dropout ? p.z_keep : 1.f;
        *reinterpret_cast<uint32_t*>(dvg + o + col) = pack_bf16(z * dv[x], z * dv[x + 1]);
      }
    }
  };

  // one if / else whose branches never meet again, so that setmaxnreg
  // holds: the producer warpgroup gives registers to the consumers
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    produce();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume();
  }
}

// --------------------------------------------------------------------------
// dq: one CTA per (q tile, hq, b)
// --------------------------------------------------------------------------
template <int D, bool Paged, bool Dropout>
__global__ void __launch_bounds__(THREADS_ALL, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ Sm90Params p) {
  static_assert(!(Paged && Dropout), "paged K/V never take dropout");
  using S = Smem<D, Paged>;
  constexpr int STAGES = S::STAGES;               // ring depth
  extern __shared__ unsigned char smem_raw[];
  // 1 KiB aligned (the 128-byte swizzle's pattern repeats every 1 KiB),
  // as an offset of smem_raw so that loads stay shared-space loads
  unsigned char* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* own_bar = empty + STAGES;
  // contiguous: the walk's entries; paged: its tile indices and each
  // warpgroup's words
  uint32_t* walk = reinterpret_cast<uint32_t*>(sm + S::walk);
  uint32_t* wb0 = walk + MAX_WALK;
  uint32_t* wb1 = wb0 + MAX_WALK;
  int* counts = reinterpret_cast<int*>(sm + S::counts);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int h = blockIdx.x, b = blockIdx.y;
  const bool two = p.rows == 128;                 // one layout row per warpgroup
  const int nqt = two ? (p.nq + 1) / 2 : p.nq;    // the CTA tiles of the q axis
  const int qt = nqt - 1 - (int)blockIdx.z;       // longest walks first
  const int qb0 = two ? 2 * qt : qt;
  const int kvh = h / (p.hq / p.hkv);
  const MaskParams mp = p.mask;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], (two ? CONSUMERS : 1) * 128);
    }
    mbar_init(own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (Paged) {
    // the layout row's 64-key tiles, each 64 / ps page slots
    build_walk<false>(walk, wb0, wb1, nullptr, counts, p.ntiles,
                      [&](int t, uint32_t& w0, uint32_t& w1, int (&pages)[MAX_PAGES]) {
      tile_pages(p.page_list, b, p.nk, t, p.lg_ps, pages);
      w0 = tile_word<true>(mp, b, qb0, t, p.nq, p.nk, p.sk, p.lg_ps, pages);
      if (two) w1 = tile_word<true>(mp, b, qb0 + 1, t, p.nq, p.nk, p.sk, p.lg_ps, pages);
    });
  } else {
    build_walk(walk, counts, p.nk, [&](int ki) {
      uint32_t e = terms(mp, b, qb0, ki);
      if (two && qb0 + 1 < p.nq) e |= terms(mp, b, qb0 + 1, ki) << 4;
      return ((uint32_t)ki << 8) | e;
    });
  }
  const int* walk_len = counts + WARPS_ALL;

  // the producer: one thread issues every copy (on 24 registers, as dkv's);
  // paged, the PAGED_PRODUCERS warps of the producer warpgroup take the
  // walk's items in turn (warp w items w, w + 4, ...: each stage belongs to
  // one warp, which fills it in order), one K/V page box a lane
  auto produce = [&]() {
    const int n = *walk_len;
    if (threadIdx.x >= CONSUMERS * 128 + (Paged ? 32 * PAGED_PRODUCERS : 1) || n == 0) return;
    const int ntile = two ? 2 : 1;
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect(own_bar, 2 * ntile * S::TILE);
      for (int t = 0; t < ntile; ++t) {
        const int r0 = (qb0 + t) * BOX;
        tma_tile<D>(sm + S::own0 + t * S::TILE, &p.tq, own_bar, r0, b * p.hq + h);
        tma_tile<D>(sm + S::own1 + t * S::TILE, &p.tdo, own_bar, r0, b * p.hq + h);
      }
    }
    if constexpr (Paged) {
      const int lane = threadIdx.x & 31;
      constexpr int PW = PAGED_PRODUCERS;
      static_assert(STAGES % PW == 0, "a stage belongs to one producer warp");
      const int pw = (threadIdx.x - CONSUMERS * 128) >> 5;
      const int G = BOX >> p.lg_ps, jj = box_page<S::NB>(lane);
      // this lane's page of walk item i (its slot past the tile or the list: 0,
      // never addressed); read one item ahead, while the boxes of the item
      // before go out
      auto page_of = [&](int i) {
        const int slot = (int)walk[i] * G + jj;
        return jj < G && slot < p.nk ? p.page_list[(long long)b * p.nk + slot] : 0;
      };
      int next = pw < n ? page_of(pw) : 0;
      for (int i = pw; i < n; i += PW) {
        const int s = i % STAGES;
        const int page = next;
        if (i + PW < n) next = page_of(i + PW);
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        const int t = (int)walk[i];
        // the tile's columns inside the key axis (a ragged last tile: fewer)
        const unsigned vec = 4u * min(BOX, p.sk - t * BOX);
        if (lane == 0) {
          mbar_expect(&full[s], 2 * S::TILE + (p.mask.kv_pos ? vec : 0u) +
                                    (p.mask.kv_seg ? vec : 0u));
          unsigned char* meta = sm + S::meta + s * META_BYTES;
          const long long kv0 = (long long)b * p.sk + (long long)t * BOX;
          if (p.mask.kv_pos) bulk_copy(meta, p.mask.kv_pos + kv0, vec, &full[s]);
          if (p.mask.kv_seg) bulk_copy(meta + 256, p.mask.kv_seg + kv0, vec, &full[s]);
        }
        __syncwarp();                               // the bytes are expected first
        paged_kv_box<S::NB>(lane, sm + S::ring0 + s * S::TILE, sm + S::ring1 + s * S::TILE,
                            &p.tk, &p.tv, &full[s], (wb0[i] | wb1[i]) & 0xffu, page, p.lg_ps,
                            p.num_pages, kvh);
      }
      return;
    }
    const unsigned bytes = 2 * S::TILE + (p.mask.kv_pos ? 256 : 0) +
                           (p.mask.kv_seg ? 256 : 0) + (p.mask.kv_mask ? 64 : 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      const int ki = (int)(walk[i] >> 8);
      mbar_expect(&full[s], bytes);
      tma_tile<D>(sm + S::ring0 + s * S::TILE, &p.tk, &full[s], ki * BOX, b * p.hkv + kvh);
      tma_tile<D>(sm + S::ring1 + s * S::TILE, &p.tv, &full[s], ki * BOX, b * p.hkv + kvh);
      unsigned char* meta = sm + S::meta + s * META_BYTES;
      const long long kv0 = (long long)b * p.sk + (long long)ki * BOX;
      if (p.mask.kv_pos) bulk_copy(meta, p.mask.kv_pos + kv0, 256, &full[s]);
      if (p.mask.kv_seg) bulk_copy(meta + 256, p.mask.kv_seg + kv0, 256, &full[s]);
      if (p.mask.kv_mask) bulk_copy(meta + 512, p.mask.kv_mask + kv0, 64, &full[s]);
    }
  };

  // the consumers: two warpgroups
  auto consume = [&]() {
    const int w4 = warp & 3, g = lane >> 2, t4 = lane & 3;
    const ElementMask em(mp);
    const int rb = two ? wg : 0;                    // this warpgroup's q tile
    const int qblk = qb0 + rb;                      // and its layout row
    const bool row_in = qblk < p.nq;
    const DropoutParams drop = p.drop;
    const long long q_row0 = ((long long)b * p.hq + h) * p.sq;
    // this thread's two q rows: position, segment, lse, D
    int qrow[2], qpos[2], qseg[2];
    float lse[2], ddr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = qblk * BOX + 16 * w4 + g + 8 * hh;
      const int rr = row_in ? r : 0;
      qrow[hh] = r;
      qpos[hh] = mp.q_position(b, p.sq, rr);
      qseg[hh] = mp.q_segment(b, p.sq, rr);
      lse[hh] = log2_lse(p.m[q_row0 + rr], p.l[q_row0 + rr]);
      ddr[hh] = p.dd[q_row0 + rr];
    }
    constexpr int NA = D / 2;                       // registers of a 64 x D accumulator
    float acc[NA];
#pragma unroll
    for (int x = 0; x < NA; ++x) acc[x] = 0.f;
    const uint32_t q_tile = smem_addr(sm + S::own0 + rb * S::TILE);
    const uint32_t do_tile = smem_addr(sm + S::own1 + rb * S::TILE);
    const uint32_t* wbr = rb ? wb1 : wb0;           // paged: this warpgroup's words
    // paged: the word of a tile all of whose pages run unmasked
    const uint32_t all_live = Paged ? (1u << (BOX >> p.lg_ps)) - 1u : 0u;
    if (*walk_len > 0) mbar_wait(own_bar, 0);

    int held = -1;         // the stage the last dq product still reads
    for (int i = 0; i < *walk_len; ++i) {
      if (!two && (i & 1) != wg) continue;          // 64-row tile: alternate items
      const int s = i % STAGES;
      const uint32_t e = walk[i];
      // contiguous: this warpgroup's terms; paged: its word of page bits
      const uint32_t bits = Paged ? 0u : (e >> (4 * rb)) & 7u;
      const uint32_t w = Paged ? wbr[i] : 0u;
      const bool runs = Paged ? (w & 0xffu) != 0u : (bits & 1u) != 0u;
      if (!(runs && row_in)) {
        // release the held stage before waiting: the copies of a later item
        // may wait for it
        if (held >= 0) {
          wg_wait<0>();
          mbar_arrive(&empty[held]);
          held = -1;
        }
        mbar_wait(&full[s], (i / STAGES) & 1);
        mbar_arrive(&empty[s]);
        continue;
      }
      mbar_wait(&full[s], (i / STAGES) & 1);
      const int ki = (int)(Paged ? e : e >> 8);
      const uint32_t k_tile = smem_addr(sm + S::ring0 + s * S::TILE);
      const uint32_t v_tile = smem_addr(sm + S::ring1 + s * S::TILE);
      const unsigned char* meta = sm + S::meta + s * META_BYTES;
      const int* kpos_s = reinterpret_cast<const int*>(meta);
      const int* kseg_s = reinterpret_cast<const int*>(meta + 256);
      const uint8_t* kval_s = meta + 512;
      // the dropout keep mask, before the accumulators are live
      uint32_t keep = 0u;
      if constexpr (Dropout) {
#pragma unroll 4
        for (int x = 0; x < 32; ++x) {
          const int c = 8 * (x >> 2) + 2 * t4 + (x & 1);
          keep |= (uint32_t)drop.keeps(b, h, qrow[(x >> 1) & 1], ki * BOX + c) << x;
        }
      }
      // S = Q' K^T and dP = dO V^T: rows = q rows, columns = keys
      float sc[32], dp[32];
      wg_fence();
      ss_product<D>(sc, q_tile, k_tile);
      wg_commit();
      ss_product<D>(dp, do_tile, v_tile);
      wg_commit();
      wg_wait<1>();                                 // S (and the last dq product) landed
      if (held >= 0) mbar_arrive(&empty[held]);
      held = -1;
      pin<32>(sc);
      // P, masked, while dP runs (paged: a tile whose pages do not all run
      // unmasked; each key takes its page's bits)
      const bool geo_on = bits & 2u, data_on = bits & 4u;
      if (Paged ? w != all_live : (geo_on || data_on)) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int c = 8 * (x >> 2) + 2 * t4 + (x & 1);   // key within the tile
          const int hh = (x >> 1) & 1;
          const int col = ki * BOX + c;
          bool live = true, geo = geo_on, data = data_on;
          if constexpr (Paged) {
            const int j = c >> p.lg_ps;               // the key's page slot
            live = (w >> j) & 1u;
            geo = (w >> (8 + j)) & 1u;
            data = (w >> (16 + j)) & 1u;
          }
          const int kp = mp.kv_pos != nullptr ? kpos_s[c] : col;
          const int ks = mp.kv_seg != nullptr ? kseg_s[c] : 0;
          const int kv = mp.kv_mask != nullptr ? (int)kval_s[c] : 1;
          const bool ok = live & em.ok(geo, data, qpos[hh], qseg[hh], kp, ks, kv, col);
          const float pv = ex2(fmaf(sc[x], LOG2E, -lse[hh]));
          sc[x] = ok ? pv : 0.f;
        }
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) sc[x] = ex2(fmaf(sc[x], LOG2E, -lse[(x >> 1) & 1]));
      }
      wg_wait<0>();                                 // dP landed
      pin<32>(dp);
      // dS = P o (dP o Z - D), Z = keep / (1 - p)
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        float dpz = dp[x];
        if constexpr (Dropout) dpz = ((keep >> x) & 1u) ? dpz * p.z_keep : 0.f;
        sc[x] = sc[x] * (dpz - ddr[(x >> 1) & 1]);
      }
      uint32_t sa[4][4];
      to_a(sa, sc);
      // dq += dS K
      wg_fence();
      rs_product<D>(acc, sa, k_tile);
      wg_commit();
      held = s;                                     // released once the product has read it
    }
    wg_wait<0>();
    if (held >= 0) mbar_arrive(&empty[held]);
    pin<NA>(acc);

    const int t = tid & 127;
    if (!two) {
      // warpgroup 0 adds warpgroup 1's sums through the (now idle) ring
      float* buf = reinterpret_cast<float*>(sm + S::ring0);
      consumer_sync();
      if (wg == 1) {
#pragma unroll
        for (int x = 0; x < NA; ++x) buf[x * 128 + t] = acc[x];
      }
      consumer_sync();
      if (wg == 1) return;
#pragma unroll
      for (int x = 0; x < NA; ++x) acc[x] += buf[x * 128 + t];
    }
    if (!row_in) return;
    // chain rule for the folded scale: one multiply at the end
    bf16* dqg = static_cast<bf16*>(p.out0) + q_row0 * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long o = (long long)qrow[hh] * D;
#pragma unroll
      for (int x = 2 * hh; x < NA; x += 4) {
        *reinterpret_cast<uint32_t*>(dqg + o + col_of(x, t4)) =
            pack_bf16(p.scale * acc[x], p.scale * acc[x + 1]);
      }
    }
  };

  // one if / else whose branches never meet again, so that setmaxnreg
  // holds: the producer warpgroup gives registers to the consumers
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    produce();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume();
  }
}

// --------------------------------------------------------------------------
// host side: tensor maps and launches
// --------------------------------------------------------------------------

template <typename K>
cudaError_t launch_kernel(K kern, dim3 grid, size_t smem, const Sm90Params& p,
                          cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS_ALL, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool Paged, bool Dropout>
cudaError_t launch(int which, const Sm90Params& p, cudaStream_t stream) {
  const int per = p.rows / BOX;
  constexpr size_t smem = Smem<D, Paged>::launch_bytes;
  if (which == 0) {
    const dim3 grid(p.hq, p.b, (p.nq + per - 1) / per);
    return launch_kernel(flash_bwd_dq_sm90_kernel<D, Paged, Dropout>, grid, smem, p, stream);
  }
  const dim3 grid(p.hkv, p.b, (p.ntiles + per - 1) / per);
  return launch_kernel(flash_bwd_dkv_sm90_kernel<D, Paged, Dropout>, grid, smem, p, stream);
}

// paged K/V never take dropout (as in the JAX package)
template <int D>
cudaError_t launch_variant(int which, bool paged, const Sm90Params& p, cudaStream_t stream) {
  if (paged) return launch<D, true, false>(which, p, stream);
  return p.drop.on ? launch<D, false, true>(which, p, stream)
                   : launch<D, false, false>(which, p, stream);
}

int run(int which, bool paged, int dtype, int head_dim, const void* q, const void* k, const void* v,
        const void* dout, const float* m, const float* l, const float* dd, void* out0,
        void* out1, const int32_t* layout, long long layout_b_stride, const uint8_t* kv_mask,
        const int32_t* q_seg, const int32_t* kv_seg, const int32_t* q_pos,
        const int32_t* kv_pos, int b, int hq, int hkv, int sq, int sk, int nq, int nk,
        int block_q, int block_k, int causal, int window, int q_offset, int kv_valid_len,
        int dropout_on, unsigned dropout_seed, unsigned dropout_threshold, float dropout_keep,
        int dropout_q_len, int dropout_k_len, int dropout_b0, int dropout_h0,
        int dropout_heads, float scale, void* stream, const int32_t* page_list, int num_pages,
        int rows) {
  // what this body takes: bf16, d 64 / 96 / 128, 64-row q blocks and 64-key
  // blocks or (paged) pages of 8-64 rows, a CTA tile of 64 or 128 rows,
  // walks of at most MAX_WALK tiles (dkv at d 128 takes 128 only: see the
  // kernel)
  const int lg_ps = paged ? __builtin_ctz((unsigned)(block_k > 0 ? block_k : 1)) : 0;
  const int ntiles = paged ? (nk * block_k + BOX - 1) / BOX : nk;
  if (dtype != 1 || block_q != BOX || (rows != 64 && rows != 128) ||
      (which == 1 && head_dim == 128 && rows != 128) ||
      hkv <= 0 || hq % hkv != 0 || sq != nq * BOX || nq > MAX_WALK || ntiles > MAX_WALK ||
      ntiles < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (paged) {
    if (page_list == nullptr || dropout_on || kv_mask != nullptr || block_k < 8 ||
        block_k > BOX || (1 << lg_ps) != block_k || sk != nk * block_k || num_pages <= 0) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (block_k != BOX || sk != nk * BOX) {
    return (int)cudaErrorInvalidValue;
  }
  // the bulk copies of the row vectors need 16-byte aligned sources
  const void* vectors[] = {m, l, dd, kv_mask, q_seg, kv_seg, q_pos, kv_pos};
  for (const void* ptr : vectors) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  Sm90Params p;
  cudaError_t err;
  if ((err = make_map(&p.tq, q, head_dim, sq, b * hq)) != cudaSuccess ||
      (err = make_map(&p.tdo, dout, head_dim, sq, b * hq)) != cudaSuccess ||
      (err = paged ? make_paged_map(&p.tk, k, head_dim, num_pages, block_k, hkv)
                   : make_map(&p.tk, k, head_dim, sk, b * hkv)) != cudaSuccess ||
      (err = paged ? make_paged_map(&p.tv, v, head_dim, num_pages, block_k, hkv)
                   : make_map(&p.tv, v, head_dim, sk, b * hkv)) != cudaSuccess) {
    return (int)err;
  }
  p.m = m; p.l = l; p.dd = dd; p.out0 = out0; p.out1 = out1; p.page_list = page_list;
  p.mask.layout = layout; p.mask.layout_b_stride = layout_b_stride;
  p.mask.kv_mask = kv_mask; p.mask.q_seg = q_seg; p.mask.kv_seg = kv_seg;
  p.mask.q_pos = q_pos; p.mask.kv_pos = kv_pos;
  p.mask.nq = nq; p.mask.nk = nk;
  p.mask.causal = causal; p.mask.window = window; p.mask.q_offset = q_offset;
  p.mask.kv_valid_len = kv_valid_len;
  p.drop = make_dropout(dropout_on, dropout_seed, dropout_threshold, dropout_keep, dropout_heads,
                        dropout_q_len, dropout_k_len, dropout_b0, dropout_h0);
  p.b = b; p.hq = hq; p.hkv = hkv; p.sq = sq; p.sk = sk; p.nq = nq; p.nk = nk;
  p.ntiles = ntiles; p.lg_ps = lg_ps; p.num_pages = num_pages;
  p.rows = rows; p.scale = scale;
  p.z_keep = 1.f / dropout_keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: err = launch_variant<64>(which, paged, p, s); break;
    case 96: err = launch_variant<96>(which, paged, p, s); break;
    case 128: err = launch_variant<128>(which, paged, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

extern "C" {

// The arguments of flash_bwd.cu's flash_bwd_dq / flash_bwd_dkv (dtype must
// be 1 = bfloat16, q pre-scaled), then the CTA tile `rows` (64 or 128);
// the _paged entry points take those of flash_bwd_dq_paged /
// flash_bwd_dkv_paged (k, v as pools (hkv, num_pages, ps, D), the layout
// block one page, the page list (b, nk), no dropout, no kv_mask; ps 8, 16,
// 32 or 64), then `rows`, and flash_bwd_sm90_dkv_paged writes fp32 packed
// (b, hkv, sk, D). Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a call outside this body's scope or an operand
// the TMA cannot address.
#define FLASH_BWD_SM90_ARGS                                                               \
  int dtype, int head_dim, const void *q, const void *k, const void *v, const void *dout, \
      const float *m, const float *l, const float *dd, void *out0, void *out1,            \
      const int32_t *layout, long long layout_b_stride, const uint8_t *kv_mask,           \
      const int32_t *q_seg, const int32_t *kv_seg, const int32_t *q_pos,                  \
      const int32_t *kv_pos, int b, int hq, int hkv, int sq, int sk, int nq, int nk,      \
      int block_q, int block_k, int causal, int window, int q_offset, int kv_valid_len,   \
      int dropout_on, unsigned dropout_seed, unsigned dropout_threshold,                  \
      float dropout_keep, int dropout_q_len, int dropout_k_len, int dropout_b0,           \
      int dropout_h0, int dropout_heads, float scale, void *stream
#define FLASH_BWD_SM90_PASS                                                                \
  dtype, head_dim, q, k, v, dout, m, l, dd, out0, out1, layout, layout_b_stride, kv_mask,  \
      q_seg, kv_seg, q_pos, kv_pos, b, hq, hkv, sq, sk, nq, nk, block_q, block_k, causal,  \
      window, q_offset, kv_valid_len, dropout_on, dropout_seed, dropout_threshold,         \
      dropout_keep, dropout_q_len, dropout_k_len, dropout_b0, dropout_h0, dropout_heads,   \
      scale, stream

int flash_bwd_sm90_dq(FLASH_BWD_SM90_ARGS, int rows) {
  return run(0, false, FLASH_BWD_SM90_PASS, nullptr, 0, rows);
}

int flash_bwd_sm90_dkv(FLASH_BWD_SM90_ARGS, int rows) {
  return run(1, false, FLASH_BWD_SM90_PASS, nullptr, 0, rows);
}

int flash_bwd_sm90_dq_paged(FLASH_BWD_SM90_ARGS, const int32_t* page_list, int num_pages,
                            int rows) {
  return run(0, true, FLASH_BWD_SM90_PASS, page_list, num_pages, rows);
}

int flash_bwd_sm90_dkv_paged(FLASH_BWD_SM90_ARGS, const int32_t* page_list, int num_pages,
                             int rows) {
  return run(1, true, FLASH_BWD_SM90_PASS, page_list, num_pages, rows);
}

const char* flash_bwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
