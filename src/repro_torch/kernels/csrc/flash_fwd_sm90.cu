// FlashAttention forward (paper Alg. 1; FA-2 or "paper" accumulator, optional
// attention dropout) on Hopper's own instructions, sm_90a: wgmma, TMA and an
// mbarrier ring fed by a producer warp. bf16 at head_dim 64, 96 or 128.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` as launched by
//   * src/repro/kernels/flash_attention.py:flash_attention_forward
//     (pl.pallas_call at l.325; contiguous K/V): Paged = false, and
//   * src/repro/kernels/flash_attention.py:flash_prefill_paged_forward
//     (pl.pallas_call at l.765; K/V read from page-pool pages through a page
//     list): Paged = true.
// flash_fwd.cu keeps every other instantiation of the same function: fp32
// (the scalar parity body), head dims 16 and 32, and layouts whose blocks
// are below 64 rows unless the whole axis is one block. The function is
// the same: o in bf16, m and l (fp32) of the UNDROPPED P, a row with no
// unmasked key at o = 0, l = 0, m = NEG_INF; the compiled block layout
// decides which tiles run (SKIP tiles and dead pages are never addressed),
// FULL tiles run unmasked, PARTIAL tiles take every term of the fused
// element mask (causal, window, q_offset, kv_valid_len, segments,
// positions, kv_mask), PARTIAL_DATA its data terms; dropout (contiguous
// only) is the hash of flash_common.cuh over buffer coordinates, so the
// backward (flash_bwd_sm90.cu) regenerates the mask bit for bit; "fa2"
// divides once at the end, "paper" renormalizes after every tile. q is
// pre-scaled by the caller (the backward recomputes P from the same q').
//
// What bounds it on an H100 (4d FLOPs per unmasked (q, k) pair against each
// input read once): the training layers (granite's (4, 32/8, 2048, 64)
// causal over packed documents, ~0.037 ms of bf16 tensor-core work, bert's,
// olmo's, phi-3-vision's) are bound by operations; the serving calls (a
// 256-row chunk against a paged prefix, seamless's 64 decoder rows against
// 1024 encoder rows: ~0.005 ms of bytes) by bytes, and in practice by how
// few CTAs they give the card. What the mma.sync body (flash_fwd.cu) did
// about neither, and what this body does:
//   1. products: every product is a warpgroup wgmma m64nNk16. S = Q'K^T
//      with both operands in shared memory (K-major, 128-byte swizzle; Q'
//      loaded once per CTA), O += P V with P rounded to bf16 in registers
//      as the A operand and V read MN-major, N in 64-column chunks (64 + 32
//      at d 96). m, l and the accumulator stay in fp32 registers.
//   2. copies: K and V arrive by TMA (cp.async.bulk.tensor) into a ring of
//      stages (8 at d 64; 5 at d 96 / 128, 4 paged: what shared memory
//      holds), each guarded by a full and an empty mbarrier, fed by one
//      producer warp, one TMA box a lane, in a warpgroup running at 24
//      registers (setmaxnreg) while the two consumer warpgroups run at 240.
//      A paged walk's page rows are read into shared memory with the walk,
//      so the producer never waits on the page list. Contiguous
//      K/V: 64 x 64 boxes of a (d, sk, b * hkv) tensor map. Paged: a
//      (d, num_pages * ps, hkv) map in boxes of `ps` rows, 64 / ps boxes a
//      64-column chunk on one `full` barrier; a dead or SKIP page's box is
//      asked at a row past the pool, which TMA zero-fills without reading
//      memory, so the transaction bytes stay those of a whole tile and the
//      page is never addressed. The row vectors of a masked call (kv_pos,
//      kv_seg, kv_mask as int32) come by bulk copies on the same barrier.
//   3. element work between the products is short and branch-free: the
//      mask terms a call has are hoisted (ElementMask) and make one bit an
//      element before one select each, a FULL tile skips the mask, P is one
//      FFMA and one ex2.approx.ftz with log2(e) folded into the row max, l
//      is summed per thread and reduced over the quad once at the end
//      ("fa2"), and a tile's dropout keep bits are hashed while its S
//      product runs. On the card the softmax still takes most of a tile's
//      time (PERF.md §6: the MUFU's exp2 rate).
//   4. overlap inside a warpgroup: tile i's S is issued together with tile
//      i-1's P V, and the softmax of tile i runs while that P V is on the
//      tensor cores; the two consumer warpgroups interleave besides. Every
//      wgmma is issued on every path: ptxas serializes a wgmma that sits
//      under a branch it cannot prove warpgroup-uniform (its note C7520),
//      and with the first body's conditional P V every product of every
//      instantiation ran serialized.
//   5. the CTA tile and grid (tuning.sm90_fwd_rows / sm90_fwd_splits):
//      * 128 rows: each consumer warpgroup owns one 64-row layout block and
//        both read every stage (a stage runs if either block runs; each
//        applies its own classes), so K/V are read once per 128 q rows;
//      * 64 rows: both warpgroups own the same 64 rows, take alternate kv
//        tiles of the walk and merge (m, l, acc) at the end in a fixed
//        order (as flash_fwd.cu's paged kSplit did);
//      * split: where even 64-row CTAs leave most SMs idle (seamless's
//        cross prefill: 64 CTAs), the walk of one 64-row block is dealt
//        over `splits` (<= 8) CTAs of one thread-block cluster, item i to
//        rank i % splits, and the partials merge through distributed
//        shared memory in rank order, each rank writing a slice of the
//        output columns (as flash_decode.cu merges its splits).
//      Grid order: longest walks first (q block nq - 1 down).
// The walk is compacted before the roles split: all 384 threads read the
// layout row(s) (and, paged, which pages are live) once and write the kv
// tiles that run, with each warpgroup's word of per-page bits, into shared
// memory; producer and consumers step through the same list.
// Deterministic: no atomics, every sum in a fixed order.

#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_WALK = 1024;             // 64-key tiles of one walk
constexpr int MAX_SPLITS = 8;              // CTAs of one (portable) cluster
constexpr int META_BYTES = 3 * 64 * 4;     // per stage: kv_pos, kv_seg, kv_mask (int32)

struct FwdParams {
  CUtensorMap tq;            // (d, sq, b * hq)
  CUtensorMap tk, tv;        // (d, sk, b * hkv); paged (d, num_pages * ps, hkv)
  void* o;                   // (b, hq, sq, D)
  float* m;                  // (b, hq, sq)
  float* l;
  const int32_t* page_list;  // (b, nk) paged only
  MaskParams mask;           // mask.kv_mask is int32 here
  DropoutParams drop;
  int b, hq, hkv, sq, sk, nq, nk;
  int ntiles;                // 64-key tiles: nk (contiguous), ceil(nk * ps / 64) (paged)
  int lg_ps;                 // paged: log2 of the page size
  int num_pages;
  int rows;                  // CTA tile: 64 or 128
  int splits;                // CTAs of a cluster dealing one walk
  float z_keep;              // Z of a kept element, 1 / (1 - p)
};

template <int D, bool Paged>
struct Smem {
  static constexpr int NB = (D + BOX - 1) / BOX;   // boxes per 64-row tile
  static constexpr int TILE = NB * BOX_BYTES;     // one 64-row tile
  // ring depth: what shared memory holds beside Q' (and, paged, the walk's
  // page rows); a warpgroup holds its last tile's stage until that tile's
  // P V has run, and a 64-row CTA's warpgroups take alternate tiles
  static constexpr int STAGES = D == 64 ? 8 : (Paged ? 4 : 5);
  static constexpr int q0 = 0;                    // Q'[2] (the CTA's q rows)
  static constexpr int k0 = 2 * TILE;             // K[STAGES]
  static constexpr int v0 = k0 + STAGES * TILE;   // V[STAGES]
  static constexpr int meta = v0 + STAGES * TILE;
  static constexpr int bars = meta + STAGES * META_BYTES;
  static constexpr int walk = bars + 8 * (2 * STAGES + 1);
  // paged: each walk tile's page rows (MAX_PAGES a tile), read once by the
  // whole CTA while the walk is built, so the producer never waits on them
  static constexpr int pages = walk + 3 * 4 * MAX_WALK;
  static constexpr int counts = pages + (Paged ? 4 * MAX_PAGES * MAX_WALK : 0);
  static constexpr int bytes = counts + 4 * (WARPS_ALL + 4);   // + the walk's length
  static constexpr size_t launch_bytes = bytes + 1024;   // 1 KiB alignment slack
  // the merges hand a warpgroup's (acc, m, l) through the (idle) ring
  static_assert(128 * (D / 2 + 4) * 4 <= 2 * STAGES * TILE, "merge buffer exceeds the ring");
  static_assert(bytes + 1024 <= 232448, "shared memory of one block");
  static_assert(META_BYTES % 16 == 0 && bars % 8 == 0, "alignment of the stage vectors");
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// every thread of every CTA of the cluster (not .aligned: the roles reach
// it on their own paths)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// a float of rank `rank`'s shared memory at this CTA's address `local`
__device__ __forceinline__ float ld_cluster(const float* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

template <int D, bool Paged, bool Dropout, bool Paper>
__global__ void __launch_bounds__(THREADS_ALL, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ FwdParams p) {
  using S = Smem<D, Paged>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 1 KiB aligned (the 128-byte swizzle's pattern repeats every 1 KiB),
  // as an offset of smem_raw so that loads stay shared-space loads
  unsigned char* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;
  int* wpages = reinterpret_cast<int*>(sm + S::pages);
  uint32_t* widx = reinterpret_cast<uint32_t*>(sm + S::walk);
  uint32_t* wb0 = widx + MAX_WALK;
  uint32_t* wb1 = wb0 + MAX_WALK;
  int* counts = reinterpret_cast<int*>(sm + S::counts);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int b = blockIdx.y / p.hq, h = blockIdx.y % p.hq;
  const bool two = p.rows == 128;                 // one layout row per warpgroup
  const int nqt = two ? (p.nq + 1) / 2 : p.nq;
  const int qb0 = (two ? 2 : 1) * (nqt - 1 - (int)blockIdx.z);   // longest walks first
  const MaskParams mp = p.mask;

  // the warpgroups that consume every stage: both of a 128-row CTA, but
  // one where its second layout row lies past nq (that warpgroup takes no
  // item); one of a 64-row CTA, whose warpgroups take alternate items
  const bool both = two && qb0 + 1 < p.nq;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], (both ? CONSUMERS : 1) * 128);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  build_walk<Paged>(widx, wb0, wb1, wpages, counts, p.ntiles,
                    [&](int t, uint32_t& w0, uint32_t& w1, int (&pages)[MAX_PAGES]) {
    if constexpr (Paged) tile_pages(p.page_list, b, p.nk, t, p.lg_ps, pages);
    // each warpgroup's word for kv tile t of its layout row
    w0 = tile_word<Paged>(mp, b, qb0, t, p.nq, p.nk, p.sk, p.lg_ps, pages);
    if (two) w1 = tile_word<Paged>(mp, b, qb0 + 1, t, p.nq, p.nk, p.sk, p.lg_ps, pages);
  });
  // the walk's length: read from shared memory by each role where needed
  const int* walk_len = counts + WARPS_ALL;

  // the producer: the first warp of the last warpgroup issues every copy of
  // this CTA's items (walk items rank, rank + splits, ...), one TMA box a
  // lane (a paged tile is up to 32 boxes: page 8 at d 96 / 128; one thread
  // issuing them all in turn starved the consumers on long paged walks).
  // It runs on 24 registers, so what it needs is read again from the
  // parameters and shared memory
  auto produce = [&]() {
    const int n = *walk_len, rank = blockIdx.x;
    const int mine = n > rank ? (n - rank + p.splits - 1) / p.splits : 0;
    if (threadIdx.x >= CONSUMERS * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    const int bb = blockIdx.y / p.hq, kvh = (blockIdx.y % p.hq) / (p.hq / p.hkv);
    if (lane == 0) {
      const int ntile = p.rows / BOX;
      mbar_expect(q_bar, ntile * S::TILE);
      for (int t = 0; t < ntile; ++t) {
        tma_tile<D>(sm + S::q0 + t * S::TILE, &p.tq, q_bar,
                    (qb0 + t) * BOX, (int)blockIdx.y);   // rows past sq read as zero
      }
      // (loaded even for an empty walk: the consumers' last product names it)
    }
    for (int j = 0; j < mine; ++j) {
      const int s = j % STAGES;
      if (j >= STAGES) mbar_wait_bounded(&empty[s], ((j / STAGES) & 1) ^ 1);
      const int i = rank + j * p.splits;
      const int t = (int)widx[i];
      // the tile's columns inside the key axis (a ragged last tile: fewer)
      const int cols = min(BOX, p.sk - t * BOX);
      const unsigned vec = 4u * cols;
      unsigned char* meta = sm + S::meta + s * META_BYTES;
      if (lane == 0) {
        mbar_expect(&full[s], 2 * S::TILE + (p.mask.kv_pos ? vec : 0u) +
                                  (p.mask.kv_seg ? vec : 0u) + (p.mask.kv_mask ? vec : 0u));
        const long long kv0 = (long long)bb * p.sk + (long long)t * BOX;
        if (p.mask.kv_pos) bulk_copy(meta, p.mask.kv_pos + kv0, vec, &full[s]);
        if (p.mask.kv_seg) bulk_copy(meta + 256, p.mask.kv_seg + kv0, vec, &full[s]);
        if (p.mask.kv_mask) {
          bulk_copy(meta + 512, reinterpret_cast<const int32_t*>(p.mask.kv_mask) + kv0, vec,
                    &full[s]);
        }
      }
      __syncwarp();                                 // the bytes are expected first
      // box `lane`: K or V (lane & 1), 64-column chunk nb, and (paged) page
      // slot jj (paged_kv_box)
      if constexpr (Paged) {
        const int jj = box_page<S::NB>(lane);
        const uint32_t live = (wb0[i] | wb1[i]) & 0xffu;
        const int page = jj < MAX_PAGES && ((live >> jj) & 1u) ? wpages[i * MAX_PAGES + jj] : 0;
        paged_kv_box<S::NB>(lane, sm + S::k0 + s * S::TILE, sm + S::v0 + s * S::TILE, &p.tk,
                            &p.tv, &full[s], live, page, p.lg_ps, p.num_pages, kvh);
      } else {
        const int nb = (lane >> 1) % S::NB;
        unsigned char* dst = sm + ((lane & 1) ? S::v0 : S::k0) + s * S::TILE + nb * BOX_BYTES;
        const CUtensorMap* map = (lane & 1) ? &p.tv : &p.tk;
        if (lane < 2 * S::NB) tma_box(dst, map, &full[s], nb * BOX, t * BOX, bb * p.hkv + kvh);
      }
    }
  };

  // the consumers: two warpgroups
  auto consume = [&]() {
    const int w4 = warp & 3, g = lane >> 2, t4 = lane & 3, t = tid & 127;
    const int rb = two ? wg : 0;                    // this warpgroup's q block
    const int qblk = qb0 + rb;                      // and its layout row
    const int rank = blockIdx.x;
    const long long q_row0 = ((long long)b * p.hq + h) * p.sq;
    // this thread's two q rows: buffer row, position, segment
    int qrow[2], qpos[2], qseg[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = qblk * BOX + 16 * w4 + g + 8 * hh;
      const int rr = r < p.sq ? r : 0;
      qrow[hh] = r;
      qpos[hh] = mp.q_position(b, p.sq, rr);
      qseg[hh] = mp.q_segment(b, p.sq, rr);
    }
    constexpr int NA = D / 2;                       // registers of a 64 x D accumulator
    float acc[NA];
#pragma unroll
    for (int x = 0; x < NA; ++x) acc[x] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
    const uint32_t q_tile = smem_addr(sm + S::q0 + rb * S::TILE);
    const uint32_t* wb = rb ? wb1 : wb0;
    const int n = *walk_len;
    const int mine = n > rank ? (n - rank + p.splits - 1) / p.splits : 0;
    const uint32_t all_live = Paged ? (1u << (BOX >> p.lg_ps)) - 1u : 1u;
    mbar_wait_bounded(q_bar, 0);

    // Every wgmma is issued on every path (ptxas serializes the products of
    // a wgmma it finds under a branch it cannot prove warpgroup-uniform):
    // each warpgroup steps over its own items only; a tile its rows skip
    // (128-row CTAs) runs masked whole (P = 0); the first P V multiplies
    // zero fragments, and the last one is issued after the loop, both
    // naming this warpgroup's Q' tile, which is always loaded
    int pending = -1;      // the stage of the P V still to be issued
    uint32_t pa[4][4];     // that tile's P as A fragments
    uint32_t pv_tile = q_tile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = 0u;
    }
    const int my_end = two && qblk >= p.nq ? 0 : mine;   // a row past nq takes none
    for (int j = two ? 0 : wg; j < my_end; j += two ? 1 : 2) {   // 64-row: alternate items
      const int s = j % STAGES;
      const int i = rank + j * p.splits;
      const uint32_t w = wb[i];
      mbar_wait_bounded(&full[s], (j / STAGES) & 1);
      const int kt = (int)widx[i];
      // the dropout keep bits while the products run; at d 128 "paper"
      // once the last P V has landed and its A fragments are dead
      // (registers)
      constexpr bool overlap_keep = !(D == 128 && Paper);
      uint32_t keep = ~0u;                          // without dropout: every element
      auto hash_keep = [&]() {
        const DropoutParams& drop = p.drop;
        keep = 0u;
#pragma unroll 4
        for (int x = 0; x < 32; ++x) {
          const int c = 8 * (x >> 2) + 2 * t4 + (x & 1);
          keep |= (uint32_t)drop.keeps(b, h, qrow[(x >> 1) & 1], kt * BOX + c) << x;
        }
      };
      // S = Q' K^T (rows = q rows, columns = the tile's keys), issued with
      // the last tile's P V
      float sc[32];
      wg_fence();
      ss_product<D>(sc, q_tile, smem_addr(sm + S::k0 + s * S::TILE));
      wg_commit();
      rs_product<D>(acc, pa, pv_tile);
      wg_commit();
      if constexpr (Dropout && overlap_keep) hash_keep();
      wg_wait<1>();                                 // S landed; P V may still run
      pin<32>(sc);
      float corr[2] = {1.f, 1.f}, psum[2] = {0.f, 0.f};
      if (w & 0xffu) {                              // this warpgroup's rows take the tile
        // the mask on the accumulator's (row, column) coordinates: first
        // a bit per element, column by column (bit x: row (x >> 1) & 1,
        // column 8 (x >> 2) + 2 t4 + (x & 1)), then one select each; the
        // column loop is not unrolled whole, so its loads do not all stay
        // live at once (registers)
        if (w != all_live) {
          const ElementMask em(mp);
          const int* meta = reinterpret_cast<const int*>(sm + S::meta + s * META_BYTES);
          uint32_t okbits = 0u;
#pragma unroll 2
          for (int ci = 0; ci < 16; ++ci) {
            const int c = 8 * (ci >> 1) + 2 * t4 + (ci & 1);  // key within the tile
            const int jb = Paged ? c >> p.lg_ps : 0;          // its layout block
            const int col = kt * BOX + c;
            const int kp = mp.kv_pos != nullptr ? meta[c] : col;
            const int ks = mp.kv_seg != nullptr ? meta[64 + c] : 0;
            const int kv = mp.kv_mask != nullptr ? meta[128 + c] : 1;
            const bool live = ((w >> jb) & 1u) & (col < p.sk);
            const bool geo_on = (w >> (8 + jb)) & 1u, data_on = (w >> (16 + jb)) & 1u;
            const int x0 = 4 * (ci >> 1) + (ci & 1);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const bool ok =
                  live & em.ok(geo_on, data_on, qpos[hh], qseg[hh], kp, ks, kv, col);
              okbits |= (uint32_t)ok << (x0 + 2 * hh);
            }
          }
#pragma unroll
          for (int x = 0; x < 32; ++x) sc[x] = (okbits >> x) & 1u ? sc[x] : NEG_INF;
        }
        // online softmax: rows 16 w4 + g (+ 8) are shared by a quad's 4 lanes
        float mt[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int x = 0; x < 32; ++x) mt[(x >> 1) & 1] = fmaxf(mt[(x >> 1) & 1], sc[x]);
        float ms[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
          mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
          // a row with no key yet keeps P at 0 (its scores are NEG_INF); an
          // unchanged max rescales by exactly 1
          ms[hh] = mt[hh] <= NEG_INF / 2 ? 0.f : mt[hh] * LOG2E;
          corr[hh] = ex2((m_r[hh] - mt[hh]) * LOG2E);
          m_r[hh] = mt[hh];
        }
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int hh = (x >> 1) & 1;
          const float pv = ex2(fmaf(sc[x], LOG2E, -ms[hh]));
          psum[hh] += pv;                             // l sums the undropped fp32 P
          sc[x] = pv;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float corr_l = corr[hh];
        if constexpr (Paper) {
          // "paper" needs the whole row's l now; its accumulator takes the
          // last tile's 1 / l (Alg. 1 line 12, after that tile's P V) and
          // this tile's l_prev * corr, as one factor a row
          psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 1);
          psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 2);
          const float inv = pending >= 0 ? 1.f / (l_r[hh] == 0.f ? 1.f : l_r[hh]) : 1.f;
          corr[hh] = inv * (l_r[hh] * corr[hh]);
        }
        l_r[hh] = l_r[hh] * corr_l + psum[hh];      // "fa2": this thread's columns only
      }
      wg_wait<0>();                                 // the last tile's P V landed
      pin<NA>(acc);
      if (pending >= 0) mbar_arrive(&empty[pending]);
      if constexpr (Dropout && !overlap_keep) hash_keep();
#pragma unroll
      for (int x = 0; x < NA; ++x) acc[x] *= corr[(x >> 1) & 1];
      to_a(pa, sc, keep);                           // dropped P: 0
      // a tile this warpgroup's rows skip (the other's take it) ran its
      // products as every tile does, and its P is 0 (no branch writes the
      // accumulator: ptxas would serialize the products)
      const uint32_t take = (w & 0xffu) ? ~0u : 0u;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[kk][x] &= take;
      }
      pending = s;
      pv_tile = smem_addr(sm + S::v0 + s * S::TILE);
    }
    wg_fence();
    rs_product<D>(acc, pa, pv_tile);
    wg_commit();
    wg_wait<0>();
    pin<NA>(acc);
    if (pending >= 0) mbar_arrive(&empty[pending]);
    if constexpr (Paper) {                          // the last tile's 1 / l
#pragma unroll
      for (int x = 0; x < NA; ++x) acc[x] *= 1.f / (l_r[(x >> 1) & 1] == 0.f ? 1.f : l_r[(x >> 1) & 1]);
    }
    if constexpr (!Paper) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l_r[hh] += __shfl_xor_sync(0xffffffffu, l_r[hh], 1);
        l_r[hh] += __shfl_xor_sync(0xffffffffu, l_r[hh], 2);
      }
    }

    // the merges add unnormalized accumulators ("paper": acc * l)
    bool unnormalized = !Paper;
    if (!two || p.splits > 1) {
      if constexpr (Paper) {
#pragma unroll
        for (int x = 0; x < NA; ++x) acc[x] *= l_r[(x >> 1) & 1];
      }
      unnormalized = true;
    }
    float* buf = reinterpret_cast<float*>(sm + S::k0);
    if (!two) {
      // warpgroup 0 merges warpgroup 1's state through the (now idle) ring
      consumer_sync();
      if (wg == 1) {
#pragma unroll
        for (int x = 0; x < NA; ++x) buf[x * 128 + t] = acc[x];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          buf[(NA + hh) * 128 + t] = m_r[hh];
          buf[(NA + 2 + hh) * 128 + t] = l_r[hh];
        }
      }
      consumer_sync();
      if (wg == 0) {
        float a0[2], a1[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float m1 = buf[(NA + hh) * 128 + t], l1 = buf[(NA + 2 + hh) * 128 + t];
          const float mn = fmaxf(m_r[hh], m1);
          a0[hh] = ex2((m_r[hh] - mn) * LOG2E);
          a1[hh] = ex2((m1 - mn) * LOG2E);
          l_r[hh] = l_r[hh] * a0[hh] + l1 * a1[hh];
          m_r[hh] = mn;
        }
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          acc[x] = acc[x] * a0[(x >> 1) & 1] + buf[x * 128 + t] * a1[(x >> 1) & 1];
        }
      }
    }
    bf16* og = static_cast<bf16*>(p.o) + q_row0 * D;
    if (p.splits > 1) {
      // the cluster's ranks merge in rank order; rank r writes the column
      // pairs xp with xp % splits == r, rank 0 the rows' m and l
      if (wg == 0) {
#pragma unroll
        for (int x = 0; x < NA; ++x) buf[x * 128 + t] = acc[x];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          buf[(NA + hh) * 128 + t] = m_r[hh];
          buf[(NA + 2 + hh) * 128 + t] = l_r[hh];
        }
      }
      cluster_sync();
      if (wg == 0) {
        float wgt[MAX_SPLITS][2], mx[2] = {NEG_INF, NEG_INF}, ll[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < MAX_SPLITS; ++r) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            wgt[r][hh] = r < p.splits ? ld_cluster(buf + (NA + hh) * 128 + t, r) : NEG_INF;
            mx[hh] = fmaxf(mx[hh], wgt[r][hh]);
          }
        }
#pragma unroll
        for (int r = 0; r < MAX_SPLITS; ++r) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            wgt[r][hh] = ex2((wgt[r][hh] - mx[hh]) * LOG2E);
            if (r < p.splits) ll[hh] += ld_cluster(buf + (NA + 2 + hh) * 128 + t, r) * wgt[r][hh];
          }
        }
        float inv[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          inv[hh] = 1.f / (ll[hh] == 0.f ? 1.f : ll[hh]);
          if constexpr (Dropout) inv[hh] *= p.z_keep;
        }
        // column pairs xp of this rank; the row half (xp & 1) picked by
        // selects, never as an index (a runtime index puts an array in local
        // memory)
        for (int xp = rank; xp < NA / 2; xp += p.splits) {
          const int x = 2 * xp;
          const bool hi = xp & 1;
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int r = 0; r < MAX_SPLITS; ++r) {
            if (r < p.splits) {
              const float wr = hi ? wgt[r][1] : wgt[r][0];
              a0 += ld_cluster(buf + x * 128 + t, r) * wr;
              a1 += ld_cluster(buf + (x + 1) * 128 + t, r) * wr;
            }
          }
          const int row = hi ? qrow[1] : qrow[0];
          const float iv = hi ? inv[1] : inv[0];
          if (row < p.sq) {
            *reinterpret_cast<uint32_t*>(og + (long long)row * D + col_of(x, t4)) =
                pack_bf16(a0 * iv, a1 * iv);
          }
        }
        if (rank == 0 && t4 == 0) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (qrow[hh] < p.sq) {
              p.m[q_row0 + qrow[hh]] = mx[hh];
              p.l[q_row0 + qrow[hh]] = ll[hh];
            }
          }
        }
      }
      cluster_sync();                               // every rank stays until read
      return;
    }
    if (!two && wg == 1) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = qrow[hh];
      if (qblk >= p.nq || r >= p.sq) continue;
      float inv = unnormalized ? 1.f / (l_r[hh] == 0.f ? 1.f : l_r[hh]) : 1.f;
      if constexpr (Dropout) inv *= p.z_keep;      // the kept P's 1 / (1 - p), in fp32
#pragma unroll
      for (int x = 2 * hh; x < NA; x += 4) {
        *reinterpret_cast<uint32_t*>(og + (long long)r * D + col_of(x, t4)) =
            pack_bf16(acc[x] * inv, acc[x + 1] * inv);
      }
      if (t4 == 0) {
        p.m[q_row0 + r] = m_r[hh];
        p.l[q_row0 + r] = l_r[hh];
      }
    }
  };

  // one if / else whose branches never meet again, so that setmaxnreg
  // holds: the producer warpgroup gives registers to the consumers
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    produce();
    if (p.splits > 1) {                             // the consumers' two merge barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume();
  }
}

// --------------------------------------------------------------------------
// host side: tensor maps and launches
// --------------------------------------------------------------------------

template <int D, bool Paged, bool Dropout, bool Paper>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  auto kern = flash_fwd_sm90_kernel<D, Paged, Dropout, Paper>;
  constexpr size_t smem = Smem<D, Paged>::launch_bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nqt = p.rows == 128 ? (p.nq + 1) / 2 : p.nq;
  const dim3 grid(p.splits, p.b * p.hq, nqt);
  if (p.splits == 1) {
    kern<<<grid, THREADS_ALL, smem, stream>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS_ALL);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// paged K/V never take dropout (as in the JAX package)
template <int D>
cudaError_t dispatch_variant(const FwdParams& p, bool paged, bool paper, cudaStream_t s) {
  if (paged) return paper ? launch<D, true, false, true>(p, s) : launch<D, true, false, false>(p, s);
  if (p.drop.on) {
    return paper ? launch<D, false, true, true>(p, s) : launch<D, false, true, false>(p, s);
  }
  return paper ? launch<D, false, false, true>(p, s) : launch<D, false, false, false>(p, s);
}

int run(int dtype, int paged, int head_dim, const void* q, const void* k, const void* v, void* o,
        float* m, float* l, const int32_t* layout, long long layout_b_stride,
        const int32_t* kv_mask, const int32_t* q_seg, const int32_t* kv_seg,
        const int32_t* q_pos, const int32_t* kv_pos, const int32_t* page_list, int b, int hq,
        int hkv, int sq, int sk, int nq, int nk, int block_q, int block_k, int num_pages,
        int causal, int window, int q_offset, int kv_valid_len, int paper, int dropout_on,
        unsigned dropout_seed, unsigned dropout_threshold, float dropout_keep,
        int dropout_q_len, int dropout_k_len, int dropout_b0, int dropout_h0,
        int dropout_heads, void* stream, int rows, int splits) {
  // what this body takes: bf16, d 64 / 96 / 128, q blocks of 64 rows (or
  // one block of at most 64), kv blocks of 64 (or one) or pages of 8-64
  // rows, walks of at most MAX_WALK tiles, a CTA tile of 64 or 128 rows and
  // 1-8 splits of a 64-row tile
  const int lg_ps = paged ? __builtin_ctz((unsigned)(block_k > 0 ? block_k : 1)) : 0;
  const int ntiles = paged ? (nk * block_k + BOX - 1) / BOX : nk;
  if (dtype != 1 || (head_dim != 64 && head_dim != 96 && head_dim != 128) || hkv <= 0 ||
      hq % hkv != 0 || block_q <= 0 || block_q > BOX || (block_q != BOX && nq != 1) ||
      sq != nq * block_q || (rows != 64 && rows != 128) || splits < 1 ||
      splits > MAX_SPLITS || (splits > 1 && rows != 64) || ntiles > MAX_WALK || ntiles < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (paged) {
    if (dropout_on || block_k < 8 || block_k > BOX || (1 << lg_ps) != block_k ||
        sk != nk * block_k || num_pages <= 0) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (block_k <= 0 || block_k > BOX || (block_k != BOX && nk != 1) ||
             sk != nk * block_k) {
    return (int)cudaErrorInvalidValue;
  }
  // the bulk copies of the row vectors need 16-byte aligned rows and sources
  const void* vectors[] = {kv_mask, kv_seg, kv_pos};
  for (const void* ptr : vectors) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  if (sk % 4 != 0) return (int)cudaErrorInvalidValue;
  FwdParams p;
  cudaError_t err;
  if ((err = make_map(&p.tq, q, head_dim, sq, b * hq)) != cudaSuccess) return (int)err;
  if (paged) {
    err = make_paged_map(&p.tk, k, head_dim, num_pages, block_k, hkv);
    if (err == cudaSuccess) err = make_paged_map(&p.tv, v, head_dim, num_pages, block_k, hkv);
  } else {
    err = make_map(&p.tk, k, head_dim, sk, b * hkv);
    if (err == cudaSuccess) err = make_map(&p.tv, v, head_dim, sk, b * hkv);
  }
  if (err != cudaSuccess) return (int)err;
  p.o = o; p.m = m; p.l = l; p.page_list = page_list;
  p.mask.layout = layout; p.mask.layout_b_stride = layout_b_stride;
  p.mask.kv_mask = reinterpret_cast<const uint8_t*>(kv_mask);
  p.mask.q_seg = q_seg; p.mask.kv_seg = kv_seg;
  p.mask.q_pos = q_pos; p.mask.kv_pos = kv_pos;
  p.mask.nq = nq; p.mask.nk = nk;
  p.mask.causal = causal; p.mask.window = window; p.mask.q_offset = q_offset;
  p.mask.kv_valid_len = kv_valid_len;
  p.drop = make_dropout(dropout_on, dropout_seed, dropout_threshold, dropout_keep, dropout_heads,
                        dropout_q_len, dropout_k_len, dropout_b0, dropout_h0);
  p.b = b; p.hq = hq; p.hkv = hkv; p.sq = sq; p.sk = sk; p.nq = nq; p.nk = nk;
  p.ntiles = ntiles; p.lg_ps = lg_ps; p.num_pages = num_pages;
  p.rows = rows; p.splits = splits;
  p.z_keep = 1.f / dropout_keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: err = dispatch_variant<64>(p, paged != 0, paper != 0, s); break;
    case 96: err = dispatch_variant<96>(p, paged != 0, paper != 0, s); break;
    case 128: err = dispatch_variant<128>(p, paged != 0, paper != 0, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

extern "C" {

// The arguments of flash_fwd.cu's flash_fwd (dtype must be 1 = bfloat16, q
// pre-scaled; kv_mask as int32), then the CTA tile `rows` (64 or 128) and
// the `splits` (1-8) of a 64-row tile's walk. Returns a cudaError_t (0 =
// launched); cudaErrorInvalidValue for a call outside this body's scope or
// an operand the TMA cannot address.
int flash_fwd_sm90(int dtype, int paged, int head_dim, const void* q, const void* k,
                   const void* v, void* o, float* m, float* l, const int32_t* layout,
                   long long layout_b_stride, const int32_t* kv_mask, const int32_t* q_seg,
                   const int32_t* kv_seg, const int32_t* q_pos, const int32_t* kv_pos,
                   const int32_t* page_list, int b, int hq, int hkv, int sq, int sk, int nq,
                   int nk, int block_q, int block_k, int num_pages, int causal, int window,
                   int q_offset, int kv_valid_len, int paper, int dropout_on,
                   unsigned dropout_seed, unsigned dropout_threshold, float dropout_keep,
                   int dropout_q_len, int dropout_k_len, int dropout_b0, int dropout_h0,
                   int dropout_heads, void* stream, int rows, int splits) {
  return run(dtype, paged, head_dim, q, k, v, o, m, l, layout, layout_b_stride, kv_mask, q_seg,
             kv_seg, q_pos, kv_pos, page_list, b, hq, hkv, sq, sk, nq, nk, block_q, block_k,
             num_pages, causal, window, q_offset, kv_valid_len, paper, dropout_on, dropout_seed,
             dropout_threshold, dropout_keep, dropout_q_len, dropout_k_len, dropout_b0,
             dropout_h0, dropout_heads, stream, rows, splits);
}

const char* flash_fwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
