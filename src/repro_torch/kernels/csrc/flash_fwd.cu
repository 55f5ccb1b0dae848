// FlashAttention forward (paper Alg. 1; FA-2 or "paper" accumulator, optional
// attention dropout) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` as launched by
//   * src/repro/kernels/flash_attention.py:flash_attention_forward
//     (pl.pallas_call at l.325; contiguous K/V), and
//   * src/repro/kernels/flash_attention.py:flash_prefill_paged_forward
//     (pl.pallas_call at l.765; K/V tiles read from page-pool pages).
// One template, `Paged`, covers both: only where a kv tile's rows come from
// changes (contiguous stride vs. page_list[b, t]).
//
// What bounds it on an H100 (4d FLOPs per unmasked (q, k) pair against each
// input read once):
//   * the contiguous forward at the training shape (b 4, 32/8 heads, 2048
//     tokens, d 64, causal packed documents) is bound by operations: ~37 us
//     of bf16 tensor-core work against ~26 us of bytes;
//   * the contiguous forward at the serving shape (one 2048-token packed
//     prefill of 5 documents) is bound by bytes: the documents' block
//     diagonal leaves few pairs per byte;
//   * the paged prefill (192 + 64 chunk rows against 1536/600-token
//     prefixes) is bound by operations, and in practice by the serial walk
//     of its longest CTA: 4 q-blocks x 32 heads = 128 CTAs on 132 SMs, each
//     walking its whole prefix alone.
// What the design does about each: the products run on the tensor cores,
// K/V tiles stream in through asynchronous copies that overlap the products
// of the previous tile, and a paged tile gathers 64 keys from several pages
// so the serial walk takes 4x fewer, 4x wider steps at page 16; the paged
// CTA also splits its walk over several warp groups, so one SM's CTA keeps
// more than one warp per scheduler busy.
//
// bf16 (the serving and training dtype): tensor-core body, `fwd_mma`.
//   * products: mma.sync.m16n8k16 bf16 -> fp32 for S = Q Kt and O += P V,
//     fragments loaded with ldmatrix (.trans for V) from bf16 tiles whose
//     16-byte chunks are XOR-swizzled (flash_common.cuh `swizzle`), so
//     ldmatrix and the copies are bank-conflict free. mma.sync, not wgmma:
//     block_q runs 8..64 in steps of 8 and pages 8..64 rows, while wgmma
//     needs 64-row warpgroup tiles; the per-thread fragment layout makes the
//     element mask, the dropout hash and dead pages simple to apply.
//   * mapping: a group of 4 warps covers the q block: warp w of a group
//     owns q rows 16w..16w+15, so block_q = 64 runs all four and a smaller
//     block_q runs ceil(block_q/16) of them (the others only copy). Q rows
//     past block_q are zero in shared memory and never stored. For the C
//     fragment of n8 tile j, lane l holds rows l/4 and l/4 + 8, columns
//     8j + 2(l%4) + {0, 1}; the mask and dropout are applied on those
//     coordinates. A contiguous CTA is one group (128 threads). A paged CTA
//     is 3 groups (d <= 64; 2 above): group i takes the i-th of every
//     3 (2) tiles that run, in its own two stages, and at the end hands its
//     (m, l, acc) to group 0 through shared memory, which merges them as
//     split-KV does (kSplit).
//   * m, l and the accumulator stay in fp32 registers for the whole kv loop;
//     P is rounded to bf16 only as the A operand of P V, and l sums the fp32
//     P (as FlashAttention-2).
//   * tile classes: the CTA classifies its kv tiles into a shared-memory
//     table, one tile per thread (the layout classes and pages of a tile
//     are independent loads, issued together); finding the next tile that
//     runs is then a scan of shared memory.
//   * pipeline: Q is copied once per CTA (cp.async) with the first kv tile,
//     and each q row's position and segment go to registers. K and V move
//     by cp.async.cg (16 bytes a thread) into two shared-memory stages per
//     group: tile i+1 is issued right after the one barrier of iteration i
//     and lands while tile i computes. The tile's kv_pos, kv_seg (and
//     kv_mask) are staged beside it, so the element mask reads shared
//     memory.
//   * kv tiles: contiguous K/V keep the layout's block_k (<= 64; rows past
//     it are zero and score NEG_INF, a block_k that is not a multiple of
//     16 is padded to one). A paged tile is 64 keys gathered from
//     64 / page_size pages of page_list (page 8, 16, 32 or 64); the layout
//     stays per page. Each page's class is read before any address of the
//     page is formed: a SKIP or dead page (page_list < 0) inside a tile is
//     never addressed, its rows are zero-filled and its scores forced to
//     NEG_INF; a tile whose pages are all SKIP is skipped whole; FULL pages
//     run unmasked, PARTIAL and PARTIAL_DATA pages apply their terms of the
//     element mask to their own columns. The last tile is padded with dead
//     slots when the page count is not a multiple of the pages per tile.
//
// fp32: the scalar body, `fwd_scalar` (the first version, unchanged): K/V in
// shared memory as fp32, scalar FMA, 8 warps of 8 q rows. It is the card's
// parity mode (fp32 engine and train on cuda against cpu: identical tokens,
// losses within 1e-4), which TF32 tensor cores (~3 decimal digits) would
// break.
//
// Both bodies:
//   * one CTA per (b, hq, q-block); the kv loop runs INSIDE the CTA (the
//     TPU's sequential kv grid axis has no Hopper counterpart).
//   * the CTA reads the compiled block-layout class of a tile BEFORE it
//     forms any address: SKIP tiles (causal/window geometry, cross-document
//     tiles, dead pages) are never read.
//   * the fused element mask (core/masks.element_mask) is applied only on
//     PARTIAL tiles (all terms) and PARTIAL_DATA tiles (data terms only);
//     FULL tiles run unmasked. q is pre-scaled by the caller, exactly as the
//     Pallas wrapper does.
//   * outputs o (input dtype), m and l (fp32) exactly as the Pallas kernel:
//     rows with no unmasked key give o = 0, l = 0, m = NEG_INF. m and l are
//     those of the UNDROPPED P (the backward recomputes P from them).
//   * variant "paper" (Alg. 1 line 12) renormalizes the accumulator at every
//     tile: acc = (acc * l_prev * corr + P~V) / l_new; "fa2" keeps it
//     unnormalized and divides once at the end.
//   * dropout (contiguous K/V only, as in the JAX package) applies the hash
//     keep mask of flash_common.cuh to P before P.V, over the buffer
//     coordinates (b, h, qi*bq + r, ki*bk + c), so the backward's
//     regenerated mask agrees bit for bit. The scalar body multiplies the
//     kept P by 1 / (1 - p); the bf16 body zeroes the dropped P and scales
//     the output by 1 / (1 - p) in fp32 at the end (the same product;
//     scaling P before its bf16 rounding would cost ~0.2% on every kept
//     element).
// The layout read, the element mask, the hash and the fragment helpers live
// in flash_common.cuh, shared with the backward kernels (flash_bwd.cu).

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int ROWS = MAX_BQ / NUM_WARPS;   // q rows per warp (scalar body)
constexpr int COLS = MAX_BK / 32;          // kv columns per lane (scalar body)

struct FwdParams {
  const void* q;            // (b, hq, sq, D), pre-scaled
  const void* k;            // contiguous: (b, hkv, sk, D); paged: (hkv, P, ps, D)
  const void* v;
  void* o;                  // (b, hq, sq, D)
  float* m;                 // (b, hq, sq)
  float* l;                 // (b, hq, sq)
  const int32_t* page_list; // (b, nk) paged only
  MaskParams mask;
  DropoutParams drop;
  int b, hq, hkv, sq, sk, nq, nk, block_q, block_k, num_pages, paper;
};

// fp32: scalar FMA from fp32 copies of the tiles (THREADS threads)
template <typename T, int D, bool Paged, bool Dropout, bool Paper>
__device__ __forceinline__ void fwd_scalar(const FwdParams& p) {
  constexpr int DPL = (D + 31) / 32;        // output dims per lane
  extern __shared__ float smem[];
  const int bq = p.block_q, bk = p.block_k;
  float* q_s = smem;                        // bq x D
  float* k_s = q_s + bq * D;                // bk x (D + 1)
  float* v_s = k_s + bk * (D + 1);          // bk x D
  float* p_s = v_s + bk * D;                // bq x bk

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const MaskParams mp = p.mask;           // by value: see flash_common.cuh
  const DropoutParams drop = p.drop;

  const long long q_row0 = ((long long)b * p.hq + h) * p.sq + (long long)qi * bq;
  const T* qg = static_cast<const T*>(p.q) + q_row0 * D;
  for (int i = tid; i < bq * D; i += THREADS) q_s[i] = to_f32(qg[i]);

  float m_r[ROWS], l_r[ROWS], div_r[ROWS], acc[ROWS][DPL];
  int qpos_r[ROWS], qseg_r[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
    div_r[i] = 1.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
    const int r = warp * ROWS + i;
    const int row = qi * bq + (r < bq ? r : 0);
    qpos_r[i] = mp.q_position(b, p.sq, row);
    qseg_r[i] = mp.q_segment(b, p.sq, row);
  }

  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  for (int ki = 0; ki < p.nk; ++ki) {
    // the tile's class is read before any address of it is formed
    bool geo_on, data_on;
    if (!mp.tile_terms(mp.block_class(b, qi, ki), geo_on, data_on)) continue;

    long long kv_off;
    if (Paged) {
      const int page = p.page_list[(long long)b * p.nk + ki];
      kv_off = ((long long)kvh * p.num_pages + page) * bk * D;
    } else {
      kv_off = (((long long)b * p.hkv + kvh) * p.sk + (long long)ki * bk) * D;
    }
    __syncthreads();                      // previous tile fully consumed
    for (int i = tid; i < bk * D; i += THREADS) {
      const int row = i / D, col = i - row * D;
      k_s[row * (D + 1) + col] = to_f32(kg[kv_off + i]);
      v_s[i] = to_f32(vg[kv_off + i]);
    }
    __syncthreads();

    const long long kv_row0 = (long long)b * p.sk + (long long)ki * bk;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i;
      if (r >= bq) break;                 // warp-uniform
      float s[COLS];
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
        const int c = lane + 32 * cc;
        s[cc] = NEG_INF;
        if (c < bk) {
          float dot = 0.f;
          const float* qr = q_s + r * D;
          const float* kr = k_s + c * (D + 1);
#pragma unroll 16
          for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
          const bool ok = mp.element_ok(geo_on, data_on, qpos_r[i], qseg_r[i],
                                        kv_row0 + c, ki * bk + c);
          s[cc] = ok ? dot : NEG_INF;
        }
      }
      float mt = s[0];
#pragma unroll
      for (int cc = 1; cc < COLS; ++cc) mt = fmaxf(mt, s[cc]);
      mt = warp_max(mt);
      const float m_prev = m_r[i];
      const float m_new = fmaxf(m_prev, mt);
      float psum = 0.f;
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
        const int c = lane + 32 * cc;
        float pv = (s[cc] <= NEG_INF / 2) ? 0.f : expf(s[cc] - m_new);
        psum += pv;                       // l sums the undropped P
        if (c < bk) {
          if (Dropout) {
            pv = drop.keeps(b, h, qi * bq + r, ki * bk + c) ? pv / drop.keep : 0.f;
          }
          p_s[r * bk + c] = pv;
        }
      }
      psum = warp_sum(psum);
      const float corr = (m_prev <= NEG_INF / 2) ? 0.f : expf(m_prev - m_new);
      const float l_prev = l_r[i];
      const float l_new = l_prev * corr + psum;
      l_r[i] = l_new;
      m_r[i] = m_new;
      const float acc_scale = Paper ? l_prev * corr : corr;
      div_r[i] = (l_new == 0.f) ? 1.f : l_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= acc_scale;
    }
    __syncwarp();                         // this warp's P rows are visible
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i;
      if (r >= bq) break;
      const float* pr = p_s + r * bk;
      for (int c = 0; c < bk; ++c) {
        const float pc = pr[c];
        const float* vr = v_s + c * D;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[i][j] = fmaf(pc, vr[d], acc[i][j]);
        }
      }
      if (Paper) {
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] /= div_r[i];
      }
    }
  }

  T* og = static_cast<T*>(p.o) + q_row0 * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp * ROWS + i;
    if (r >= bq) break;
    const float l = l_r[i];
    const float inv = Paper ? 1.f : 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store_out(og + (long long)r * D + d, acc[i][j] * inv);
    }
    if (lane == 0) {
      p.m[q_row0 + r] = m_r[i];
      p.l[q_row0 + r] = l;
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor-core body
// ---------------------------------------------------------------------------

constexpr int ROW_WARPS = MAX_BQ / 16;       // warps of one group: 16 q rows each
constexpr int GROUP_THREADS = ROW_WARPS * 32;
constexpr int KV_TILE = MAX_BK;              // keys of one kv tile
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)

// Groups of ROW_WARPS warps that split a CTA's kv walk: each group takes
// every Split-th tile that runs and the groups merge (m, l, acc) at the end.
// The paged prefill runs few CTAs (a chunk's q-blocks x heads: 128 on 132
// SMs at the serving shape), each walking a whole prefix, so one group per
// SM would leave each scheduler one warp; contiguous calls fill the card
// with CTAs and keep one group. 3 groups (384 threads, <= 170 registers)
// measured as fast as 4 at d = 64, where 4 (<= 128 registers) spill; 2 at
// d = 96 and 128, whose accumulators alone are 48 and 64 registers.
template <int D, bool Paged>
constexpr int kSplit = Paged ? (D <= 64 ? 3 : 2) : 1;

// dynamic shared memory of fwd_mma: Q (64 x D), then per group two stages
// of K and of V (64 x D each), all bf16, swizzled; then per group and stage
// kv_pos, kv_seg, kv_mask of the tile's 64 columns as int32; then the table
// of tile classes (one per thread)
template <int D, int Split>
struct MmaSmem {
  static constexpr int threads = Split * GROUP_THREADS;
  static constexpr int kv = KV_TILE * D;     // bf16 elements of one K or V stage
  static constexpr int k_off = MAX_BQ * D;
  static constexpr int v_off = k_off + 2 * Split * kv;
  static constexpr int bf16_elems = v_off + 2 * Split * kv;
  static constexpr int meta = 3 * KV_TILE;   // int32 per stage
  static constexpr size_t bytes =
      2 * (size_t)bf16_elems + 4 * (2 * Split * (size_t)meta + threads);
  // the merge of the groups' (acc, m, l) reuses the K and V stages
  static_assert((Split - 1) * GROUP_THREADS * (D / 2 + 4) * 4 <= 2 * 2 * 2 * Split * kv,
                "merge buffer exceeds the K and V stages");
};

// one kv tile: its index and, per layout block j inside it (one page, or
// the whole contiguous tile), whether it runs and which mask terms it takes
struct KvTile {
  int t;
  unsigned live, geo, data;
};

template <int D, bool Paged, bool Dropout, bool Paper>
__device__ __forceinline__ void fwd_mma(const FwdParams& p) {
  using bf16 = __nv_bfloat16;
  constexpr int Split = kSplit<D, Paged>;
  using Smem = MmaSmem<D, Split>;
  constexpr int THREADS_ALL = Smem::threads;
  constexpr int CPR = D / 8;                 // 16-byte chunks per row
  constexpr int NT = KV_TILE / 8;            // n8 tiles of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  int* meta_base = reinterpret_cast<int*>(q_s + Smem::bf16_elems);
  unsigned* table_s = reinterpret_cast<unsigned*>(meta_base + 2 * Split * Smem::meta);

  const int bq = p.block_q;
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = warp / ROW_WARPS, gtid = tid % GROUP_THREADS;
  const int g = lane >> 2, t4 = lane & 3;
  const MaskParams mp = p.mask;             // by value: see flash_common.cuh
  const DropoutParams drop = p.drop;
  // this group's two stages
  bf16* k_s = q_s + Smem::k_off + 2 * group * Smem::kv;
  bf16* v_s = q_s + Smem::v_off + 2 * group * Smem::kv;
  int* meta_s = meta_base + 2 * group * Smem::meta;

  // R rows per layout block (the page, or the contiguous block_k); G blocks
  // per kv tile; W logical columns per tile; kp rows the products run over
  const int R = p.block_k;
  const int lg_r = Paged ? __ffs(R) - 1 : 0;
  const int G = Paged ? KV_TILE >> lg_r : 1;
  const int W = Paged ? KV_TILE : R;
  const int kp = (W + 15) & ~15;
  const int ntiles = (p.nk + G - 1) / G;
  const unsigned all_live = (1u << G) - 1u;

  const long long q_row0 = ((long long)b * p.hq + h) * p.sq + (long long)qi * bq;
  const bf16* qg = static_cast<const bf16*>(p.q) + q_row0 * D;
  const bf16* kg = static_cast<const bf16*>(p.k);
  const bf16* vg = static_cast<const bf16*>(p.v);

  // the classes of the kv tiles' layout blocks, read before any address is
  // formed: one tile per thread, THREADS_ALL tiles at a time, into shared
  // memory (bit j of byte 0 / 1 / 2: block j runs / takes the geometric
  // terms / takes the data terms); every thread then scans the table in
  // step, so a run of SKIP tiles costs shared-memory reads, not a chain of
  // dependent device-memory loads
  int table0 = -THREADS_ALL;                // the table's first tile
  auto fill_table = [&](int w) {
    __syncthreads();                        // every thread is done reading it
    const int t = w + tid;
    unsigned bits = 0u;
    if (t < ntiles) {
      constexpr int MAX_G = Paged ? KV_TILE / 8 : 1;
      int cls[MAX_G], page[MAX_G];
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) {     // independent loads, issued together
        const int s = t * G + j;
        const bool in = j < G && s < p.nk;  // past nk: dead slots of a ragged tile
        cls[j] = in ? mp.block_class(b, qi, s) : BLOCK_SKIP;
        page[j] = (Paged && in) ? p.page_list[(long long)b * p.nk + s] : 0;
      }
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) {
        bool geo_on, data_on;
        if (!mp.tile_terms(cls[j], geo_on, data_on) || page[j] < 0) continue;
        bits |= (1u | ((unsigned)geo_on << 8) | ((unsigned)data_on << 16)) << j;
      }
    }
    table_s[tid] = bits;
    table0 = w;
    __syncthreads();
  };
  auto next_live = [&](int t, KvTile& kt) {
    for (; t < ntiles; ++t) {
      if (t >= table0 + THREADS_ALL) fill_table(t);
      const unsigned bits = table_s[t - table0];
      if (bits & 0xffu) {
        kt.t = t;
        kt.live = bits & 0xffu;
        kt.geo = (bits >> 8) & 0xffu;
        kt.data = (bits >> 16) & 0xffu;
        return;
      }
    }
    kt.t = ntiles;
  };
  // the next round from tile `from`: the next Split tiles that run, one per
  // group in order; sets this group's (t = ntiles: none), advances `from`
  // past the round and returns whether the round has any; every thread
  // scans in step
  auto next_round = [&](int& from, KvTile& mine) {
    bool any = false;
    mine.t = ntiles;
#pragma unroll
    for (int gi = 0; gi < Split; ++gi) {
      KvTile kt;
      next_live(from, kt);
      if (gi == 0) any = kt.t < ntiles;
      if (gi == group) mine = kt;
      from = kt.t < ntiles ? kt.t + 1 : ntiles;
    }
    return any;
  };
  // issue the copies of tile kt into this group's stage st; rows of a block
  // that does not run, and rows past W, are zero-filled and never addressed
  auto load = [&](const KvTile& kt, int st) {
    bf16* kd = k_s + st * Smem::kv;
    bf16* vd = v_s + st * Smem::kv;
#pragma unroll
    for (int it = 0; it < KV_TILE * CPR / GROUP_THREADS; ++it) {
      const int i = gtid + it * GROUP_THREADS;
      const int row = i / CPR, ch = i % CPR;
      if (row >= kp) break;
      const int j = Paged ? row >> lg_r : 0;
      const int off = swizzle<D>(row, ch);
      if (row < W && ((kt.live >> j) & 1u)) {
        long long src;
        if (Paged) {
          const int page = p.page_list[(long long)b * p.nk + kt.t * G + j];
          src = (((long long)kvh * p.num_pages + page) * R + (row & (R - 1))) * D;
        } else {
          src = (((long long)b * p.hkv + kvh) * p.sk + (long long)kt.t * R + row) * D;
        }
        cp_async16(kd + off, kg + src + ch * 8);
        cp_async16(vd + off, vg + src + ch * 8);
      } else {
        *reinterpret_cast<uint4*>(kd + off) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd + off) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    const unsigned masked = kt.geo | kt.data;
    if (masked) {                           // what the element mask reads
      int* md = meta_s + st * Smem::meta;
      for (int c = gtid; c < W; c += GROUP_THREADS) {
        if (!((masked >> (Paged ? c >> lg_r : 0)) & 1u)) continue;
        const long long kv_row = (long long)b * p.sk + (long long)kt.t * W + c;
        if (mp.kv_pos != nullptr) cp_async4(md + c, mp.kv_pos + kv_row);
        if (mp.kv_seg != nullptr) cp_async4(md + KV_TILE + c, mp.kv_seg + kv_row);
        if (mp.kv_mask != nullptr) md[2 * KV_TILE + c] = mp.kv_mask[kv_row];
      }
    }
  };

  // Q once per CTA (rows past block_q zero), in the first copy group
#pragma unroll
  for (int it = 0; it < (MAX_BQ * CPR + THREADS_ALL - 1) / THREADS_ALL; ++it) {
    const int i = tid + it * THREADS_ALL;
    if (i >= MAX_BQ * CPR) break;
    const int row = i / CPR, ch = i % CPR;
    bf16* dst = q_s + swizzle<D>(row, ch);
    if (row < bq) {
      cp_async16(dst, qg + (long long)row * D + ch * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const int r0 = (warp % ROW_WARPS) * 16;   // this warp's q rows
  const bool has_rows = r0 < bq;            // warp-uniform
  int qpos[2], qseg[2];
  float m_r[2], l_r[2];
  float acc[D / 8][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    const int row = qi * bq + (r < bq ? r : 0);
    qpos[hh] = mp.q_position(b, p.sq, row);
    qseg[hh] = mp.q_segment(b, p.sq, row);
    m_r[hh] = NEG_INF;
    l_r[hh] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  int from = 0;
  KvTile cur;
  bool more = next_round(from, cur);
  if (cur.t < ntiles) load(cur, 0);
  cp_async_commit();
  int st = 0;
  while (more) {
    KvTile nxt;
    const bool more_next = next_round(from, nxt);
    cp_async_wait_all();
    // every group's tile (and Q) landed for every thread; stage st ^ 1 of
    // every group is free
    __syncthreads();
    if (nxt.t < ntiles) load(nxt, st ^ 1);
    cp_async_commit();
    if (has_rows && cur.t < ntiles) {
      const bf16* ks = k_s + st * Smem::kv;
      const bf16* vs = v_s + st * Smem::kv;
      const int* md = meta_s + st * Smem::meta;

      // S = Q K^T (16 rows x kp columns per warp; columns past kp score
      // NEG_INF and run no product)
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = (n * 8 < kp) ? 0.f : NEG_INF;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, q_s + swizzle<D>(r0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if (np * 16 < kp) {
            uint32_t bb[4];
            ldsm_x4(bb, ks + swizzle<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                        2 * kk + ((lane >> 3) & 1)));
            mma_bf16(s[2 * np], a, bb[0], bb[1]);
            mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
          }
        }
      }

      // the mask on the fragment's (row, column) coordinates
      const unsigned masked = cur.geo | cur.data;
      if (cur.live != all_live || masked || W != kp) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = n * 8 + 2 * t4 + (e & 1);
            const int j = Paged ? c >> lg_r : 0;
            bool ok = c < W && ((cur.live >> j) & 1u);
            if (ok && ((masked >> j) & 1u)) {
              const int col = cur.t * W + c;
              ok = mp.element_ok_staged(
                  (cur.geo >> j) & 1u, (cur.data >> j) & 1u, qpos[e >> 1], qseg[e >> 1],
                  mp.kv_pos != nullptr ? md[c] : col, md[KV_TILE + c], md[2 * KV_TILE + c],
                  col);
            }
            if (!ok) s[n][e] = NEG_INF;
          }
        }
      }

      // online softmax; rows g and g + 8 are shared by the 4 lanes of a quad
      float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
      float m_new[2], m_log2[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
        m_new[hh] = fmaxf(m_r[hh], mt[hh]);
        m_log2[hh] = m_new[hh] * LOG2E;
        corr[hh] = (m_r[hh] <= NEG_INF / 2) ? 0.f : exp2f(fmaf(m_r[hh], LOG2E, -m_log2[hh]));
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const float x = s[n][e];
          float pv = (x <= NEG_INF / 2) ? 0.f : exp2f(fmaf(x, LOG2E, -m_log2[hh]));
          psum[hh] += pv;                   // l sums the undropped fp32 P
          if (Dropout) {
            const int r = r0 + g + 8 * hh;
            const int c = n * 8 + 2 * t4 + (e & 1);
            if (!drop.keeps(b, h, qi * bq + r, cur.t * W + c)) pv = 0.f;
          }
          s[n][e] = pv;
        }
      }
      float acc_scale[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 1);
        psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 2);
        const float l_new = l_r[hh] * corr[hh] + psum[hh];
        acc_scale[hh] = Paper ? l_r[hh] * corr[hh] : corr[hh];
        l_r[hh] = l_new;
        m_r[hh] = m_new[hh];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= acc_scale[e >> 1];
      }

      // O += P V: the C fragments of S n8 tiles 2k, 2k+1 are the A fragment
      // of key slice k, rounded to bf16
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if (kk * 16 < kp) {
          const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                 pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                 pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                 pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dn = 0; dn < D / 16; ++dn) {
            uint32_t bb[4];
            ldsm_x4_trans(bb, vs + swizzle<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                              2 * dn + (lane >> 4)));
            mma_bf16(acc[2 * dn], a, bb[0], bb[1]);
            mma_bf16(acc[2 * dn + 1], a, bb[2], bb[3]);
          }
        }
      }
      if (Paper) {                          // 1 / l_new, formed after P V (registers)
        float l_inv[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l_inv[hh] = 1.f / ((l_r[hh] == 0.f) ? 1.f : l_r[hh]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= l_inv[e >> 1];
        }
      }
    }
    st ^= 1;
    cur = nxt;
    more = more_next;
  }
  cp_async_wait_all();                      // no copy outlives the CTA

  // merge the groups: every group but 0 hands its unnormalized acc ("paper"
  // keeps acc / l: times l) and its m, l to group 0 through the K and V
  // stages, laid out so that lane l of a warp reads what lane l wrote
  bool unnormalized = !Paper;
  if constexpr (Split > 1) {
    constexpr int PER = D / 2 + 4;          // floats a thread hands over
    float* mbuf = reinterpret_cast<float*>(q_s + Smem::k_off);
    const int wq = warp % ROW_WARPS;
    __syncthreads();                        // every group is done with its stages
    if (group > 0 && has_rows) {
      float* mb = mbuf + ((group - 1) * ROW_WARPS + wq) * PER * 32 + lane;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mb[(n * 4 + e) * 32] = Paper ? acc[n][e] * l_r[e >> 1] : acc[n][e];
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mb[(D / 2 + hh) * 32] = m_r[hh];
        mb[(D / 2 + 2 + hh) * 32] = l_r[hh];
      }
    }
    __syncthreads();
    if (group > 0 || !has_rows) return;
    if (Paper) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= l_r[e >> 1];
      }
    }
    for (int gi = 1; gi < Split; ++gi) {
      const float* mb = mbuf + ((gi - 1) * ROW_WARPS + wq) * PER * 32 + lane;
      float a_self[2], a_other[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_o = mb[(D / 2 + hh) * 32], l_o = mb[(D / 2 + 2 + hh) * 32];
        const float m_new = fmaxf(m_r[hh], m_o);
        a_self[hh] = (m_r[hh] <= NEG_INF / 2) ? 0.f : exp2f((m_r[hh] - m_new) * LOG2E);
        a_other[hh] = (m_o <= NEG_INF / 2) ? 0.f : exp2f((m_o - m_new) * LOG2E);
        l_r[hh] = l_r[hh] * a_self[hh] + l_o * a_other[hh];
        m_r[hh] = m_new;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[n][e] = acc[n][e] * a_self[e >> 1] + mb[(n * 4 + e) * 32] * a_other[e >> 1];
        }
      }
    }
    unnormalized = true;
  }

  if (!has_rows) return;
  bf16* og = static_cast<bf16*>(p.o) + q_row0 * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r >= bq) continue;
    const float l = l_r[hh];
    float inv = unnormalized ? 1.f / (l == 0.f ? 1.f : l) : 1.f;
    if (Dropout) inv /= drop.keep;          // the kept P's 1 / (1 - p), in fp32
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(og + (long long)r * D + n * 8 + 2 * t4) =
          pack_bf16(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
    }
    if (t4 == 0) {
      p.m[q_row0 + r] = m_r[hh];
      p.l[q_row0 + r] = l;
    }
  }
}

template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
template <typename T, int D, bool Paged>
constexpr int kThreads = kMma<T> ? kSplit<D, Paged> * GROUP_THREADS : THREADS;

template <typename T, int D, bool Paged, bool Dropout, bool Paper>
__device__ __forceinline__ void fwd_body(const FwdParams& p) {
  if constexpr (kMma<T>) {
    fwd_mma<D, Paged, Dropout, Paper>(p);
  } else {
    fwd_scalar<T, D, Paged, Dropout, Paper>(p);
  }
}

// Dropout and Paper are compile-time, so the serving instantiations (no
// dropout, fa2) carry none of the training variants' code or registers.
template <typename T, int D, bool Paged, bool Dropout, bool Paper>
__global__ void __launch_bounds__(kThreads<T, D, Paged>) flash_fwd_kernel(const FwdParams p) {
  fwd_body<T, D, Paged, Dropout, Paper>(p);
}

// Given launch bounds without a count of CTAs an SM must hold, ptxas cuts a
// kernel's registers to the next CTA tier when it is close to one, and may
// spill to get there: at d = 96 it did (the bf16 contiguous dropout body:
// 168 registers and 24 bytes of spill, on the card). The d = 96 bodies
// launch through this kernel, whose count of 1 turns that cut off; the
// other head dims keep the kernel they were measured with.
template <typename T, int D, bool Paged, bool Dropout, bool Paper>
__global__ void __launch_bounds__(kThreads<T, D, Paged>, 1)
    flash_fwd_kernel_min(const FwdParams p) {
  fwd_body<T, D, Paged, Dropout, Paper>(p);
}

// the kernel of one instantiation (only the one it launches is compiled)
template <typename T, int D, bool Paged, bool Dropout, bool Paper>
auto fwd_kernel() {
  if constexpr (D == 96) {
    return flash_fwd_kernel_min<T, D, Paged, Dropout, Paper>;
  } else {
    return flash_fwd_kernel<T, D, Paged, Dropout, Paper>;
  }
}

template <typename T, int D, bool Paged, bool Dropout, bool Paper>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  const size_t smem =
      kMma<T> ? MmaSmem<D, kSplit<D, Paged>>::bytes
              : sizeof(float) * ((size_t)p.block_q * D + (size_t)p.block_k * (D + 1) +
                                 (size_t)p.block_k * D + (size_t)p.block_q * p.block_k);
  auto kern = fwd_kernel<T, D, Paged, Dropout, Paper>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.nq, p.hq, p.b);
  kern<<<grid, kThreads<T, D, Paged>, smem, stream>>>(p);
  return cudaGetLastError();
}

// paged K/V never take dropout (as in the JAX package)
template <typename T, int D>
cudaError_t dispatch_variant(const FwdParams& p, bool paged, cudaStream_t s) {
  if (paged) {
    return p.paper ? launch<T, D, true, false, true>(p, s) : launch<T, D, true, false, false>(p, s);
  }
  if (p.drop.on) {
    return p.paper ? launch<T, D, false, true, true>(p, s) : launch<T, D, false, true, false>(p, s);
  }
  return p.paper ? launch<T, D, false, false, true>(p, s) : launch<T, D, false, false, false>(p, s);
}

template <typename T>
cudaError_t dispatch_d(const FwdParams& p, bool paged, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return dispatch_variant<T, 16>(p, paged, stream);
    case 32: return dispatch_variant<T, 32>(p, paged, stream);
    case 64: return dispatch_variant<T, 64>(p, paged, stream);
    case 96: return dispatch_variant<T, 96>(p, paged, stream);
    case 128: return dispatch_variant<T, 128>(p, paged, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int flash_fwd(int dtype, int paged, int head_dim,
              const void* q, const void* k, const void* v,
              void* o, float* m, float* l,
              const int32_t* layout, long long layout_b_stride,
              const uint8_t* kv_mask, const int32_t* q_seg, const int32_t* kv_seg,
              const int32_t* q_pos, const int32_t* kv_pos, const int32_t* page_list,
              int b, int hq, int hkv, int sq, int sk, int nq, int nk,
              int block_q, int block_k, int num_pages,
              int causal, int window, int q_offset, int kv_valid_len, int paper,
              int dropout_on, unsigned dropout_seed, unsigned dropout_threshold,
              float dropout_keep, int dropout_q_len, int dropout_k_len,
              int dropout_b0, int dropout_h0, int dropout_heads,
              void* stream) {
  // a paged tile gathers MAX_BK / block_k whole pages: page 8, 16, 32 or 64
  if (block_q <= 0 || block_q > MAX_BQ || block_k <= 0 || block_k > MAX_BK ||
      (paged && (dropout_on || block_k < 8 || MAX_BK % block_k != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  FwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.m = m; p.l = l;
  p.page_list = page_list;
  p.mask.layout = layout; p.mask.layout_b_stride = layout_b_stride;
  p.mask.kv_mask = kv_mask; p.mask.q_seg = q_seg; p.mask.kv_seg = kv_seg;
  p.mask.q_pos = q_pos; p.mask.kv_pos = kv_pos;
  p.mask.nq = nq; p.mask.nk = nk;
  p.mask.causal = causal; p.mask.window = window; p.mask.q_offset = q_offset;
  p.mask.kv_valid_len = kv_valid_len;
  p.drop = make_dropout(dropout_on, dropout_seed, dropout_threshold, dropout_keep,
                        dropout_heads, dropout_q_len, dropout_k_len, dropout_b0,
                        dropout_h0);
  p.b = b; p.hq = hq; p.hkv = hkv; p.sq = sq; p.sk = sk; p.nq = nq; p.nk = nk;
  p.block_q = block_q; p.block_k = block_k; p.num_pages = num_pages;
  p.paper = paper;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(p, paged != 0, head_dim, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(p, paged != 0, head_dim, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
