// Split-KV decode (FlashDecoding-style Alg. 1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (src/repro/kernels/
// flash_decode.py l.49-99) in both of its launches, as one body
// flash_decode_kernel<T, D, Paged>:
//   * Paged = true  <- flash_decode_paged (pl.pallas_call at l.329): one new
//     query token per sequence against a shared page pool (hkv, P, ps, D),
//     read through each sequence's page table;
//   * Paged = false <- flash_decode (pl.pallas_call at l.169): the same
//     against a contiguous per-sequence cache (b, hkv, capacity, D), dense
//     slot serving, with an optional per-slot kv_mask.
// Each split emits one unnormalized partial softmax state (acc, m, l), as
// the Pallas kernel does, and the splits of one sequence and kv head are
// merged in the same launch with the arithmetic of the JAX package's
// _merge_split_partials (XLA-level code there).
//
// What bounds it on an H100: decode reads every valid K/V byte of the batch
// once and does 4 d FLOPs per (q head, key) pair, ~1 FLOP per byte, far
// below the ~295 FLOP/byte ridge: it is bound by memory bytes, and a
// bytes-bound kernel runs at the rate of the bytes it keeps in flight.
//
// Design:
//   * one CTA of 128 threads per (split, kv head, b) holds the whole GQA
//     group (up to HEADS q heads; a larger group takes several head
//     groups), so each K/V byte crosses from L2 into the SM once, not once
//     per q head;
//   * a split's kv positions are cut into 64-row tiles (64 / ps whole pages
//     when paged). A first pass (one lane per tile) reads each page's or kv
//     block's class (masks.paged_block_layout / masks.kv_block_layout)
//     BEFORE its page index, applies the element mask of PARTIAL units
//     (kv_len, window, kv_mask) and keeps the tile's rows that hold a valid
//     key as a 64-bit mask; it reads the page index of live pages only and
//     lists the tiles with any valid row. A tile (or a split) without one
//     issues no load, and a SKIP or unallocated page is never addressed;
//   * the listed tiles stream through a ring of STAGES shared-memory stages
//     by 16-byte cp.async; rows without a valid key are zero-filled, never
//     read. Several tiles of K and V are in flight per CTA, and several
//     CTAs per SM;
//   * scores and P.V from the ring, per warp, in one of two cores over the
//     same stage layout, listing, ring and merges: bf16 on the tensor cores
//     (mma.sync m16n8k16, the group's q heads as the rows of A, each warp
//     16 key rows of a tile, P from the C fragments of S to the A fragments
//     of P V in registers: MmaCore), fp32 on the CUDA cores (LPR lanes share
//     a key row, a power of two of them, each one or more 16-byte chunks,
//     partial dots reduced by xor shuffles: ScalarCore). The design first ran
//     every dtype on the CUDA cores; on the card that body was bound by its
//     own arithmetic (timed without its loads it took as long as its loads
//     without arithmetic), not by bytes. Each warp (fp32: each row group)
//     keeps its own fp32 online-softmax state, and the states merge in a fixed
//     order at the end (in the warp, then the four warps through shared
//     memory);
//   * the splits of one (b, head group) run as one thread-block cluster
//     (grid (splits, kv heads x head groups, b), cluster (splits, 1, 1)):
//     each CTA writes its partial to global memory and leaves it in shared
//     memory; after cluster.sync() each rank merges one slice of the
//     (head, dim) outputs from ranks 0..S-1 in rank order through
//     distributed shared memory and writes it in q's dtype (rank 0 alone
//     took ~2x longer); a second cluster.sync() keeps every rank alive
//     until the others have read it. No atomics, so every call gives the
//     same bits.
// Conventions, as the Pallas kernel's: q . k accumulated in fp32 and scaled
// in fp32; m, l and acc in fp32 (P enters the bf16 products rounded to bf16,
// as in flash_fwd.cu); NEG_INF = -1e30; an empty split gives m = NEG_INF,
// l = 0, acc = 0; a row with no valid key merges to zeros.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

namespace cg = cooperative_groups;
using flash::BLOCK_FULL;
using flash::BLOCK_PARTIAL;
using flash::NEG_INF;

constexpr int THREADS = 128;       // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;           // kv rows of one ring stage
constexpr int HEADS = 4;           // q heads one CTA holds (granite's GQA group)
constexpr int LIST_TILES = 32;     // tiles one listing pass reads: a lane each
constexpr int MAX_PPT = 8;         // pages of one tile: TILE / smallest page
constexpr int MAX_SPLITS = 8;      // portable thread-block cluster size
constexpr int RING_BUDGET = 48 * 1024;   // bytes of ring a CTA aims at

// Chunks one lane of the scalar core takes: the fewest that leave a power
// of two of lanes a row, since a row's lanes reduce their partial dots by
// xor shuffles. One everywhere but D = 96, whose 24 fp32 chunks go to 8
// lanes of 3 chunks (12 lanes a row would leave 8 lanes of a warp idle and
// a reduction across rows).
constexpr int chunks_per_lane(int chunks) {
  int c = 1;
  while (chunks % c != 0 || chunks / c > 32 || ((chunks / c) & (chunks / c - 1)) != 0) ++c;
  return c;
}

// The ring of one (T, D), and the scalar core's lane geometry: every lane
// owns CPL 16-byte chunks of a key row (chunks ch, ch + LPR, ...), LPR lanes
// a row; a row group of the CTA takes rows group, group + ROW_GROUPS, ... of
// each tile, KB of them per softmax update.
template <typename T, int D>
struct Geo {
  static constexpr int EPC = 16 / sizeof(T);          // elements per chunk
  static constexpr int CHUNKS = D / EPC;              // 16-byte chunks per row
  static constexpr int CPL = chunks_per_lane(CHUNKS); // chunks per lane
  static constexpr int LPR = CHUNKS / CPL;            // lanes per row, a power of two
  static_assert(LPR >= 2 && LPR <= 32, "head_dim out of range");
  static constexpr int RPW = 32 / LPR;                // rows per warp step
  static constexpr int ROW_GROUPS = WARPS * RPW;
  static constexpr int RG_ROWS = TILE / ROW_GROUPS;   // rows of a group per tile
  static constexpr int KB = RG_ROWS < 4 ? RG_ROWS : 4;
  static constexpr int STAGE_ELEMS = 2 * TILE * D;    // K then V
  static constexpr int STAGE_BYTES = STAGE_ELEMS * sizeof(T);
  static constexpr int STAGES =
      RING_BUDGET / STAGE_BYTES < 2 ? 2 : (RING_BUDGET / STAGE_BYTES > 4 ? 4 : RING_BUDGET / STAGE_BYTES);
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
};

// What the CTA keeps beside the ring: the listed tiles, the warps' partial
// states, and the CTA's partial (read by the cluster's ranks through
// distributed shared memory).
template <int D>
struct DecodeShared {
  unsigned long long rows_ok[LIST_TILES];   // bit r: row r holds a valid key
  int tile[LIST_TILES];                     // tile index in the split
  int pages[LIST_TILES][MAX_PPT];           // paged: pool page of each live page
  int n_live;
  float wm[WARPS][HEADS], wl[WARPS][HEADS];  // each warp's m and l
  float acc[HEADS][D];
  float m[HEADS], l[HEADS];
};

template <typename T, int D>
constexpr int smem_bytes() {
  return Geo<T, D>::RING_BYTES + (int)sizeof(DecodeShared<D>);
}

struct DecodeParams {
  const void* q;              // (b, hq, 1, D)
  const void* k;              // paged: (hkv, num_pages, ps, D); else (b, hkv, capacity, D)
  const void* v;
  const int32_t* page_table;  // paged: (b, n_units)
  const int32_t* kv_len;      // (b,)
  const int32_t* layout;      // (b, n_units): class of each page / kv block
  const uint8_t* kv_mask;     // contiguous: (b, capacity) or null
  float* o_p;                 // (b, hq, S, D)
  float* m_p;                 // (b, hq, S)
  float* l_p;                 // (b, hq, S)
  void* out;                  // (b, hq, 1, D) in T
  int b, hq, hkv, head_groups;
  int n_units, unit;          // pages per sequence and page size, or kv blocks and block_k
  int num_pages, num_splits, window;
  float scale;
};

// e^x through exp2 (the SFU's ex2, within 2 ulp): every exponential of the
// online softmax and of the merges
__device__ __forceinline__ float exp_f32(float x) { return exp2f(x * 1.4426950408889634f); }

// 16 bytes as four fp32
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// rows [a, e) of a tile as a mask
__device__ __forceinline__ unsigned long long row_range(int a, int e) {
  a = max(a, 0);
  e = min(e, TILE);
  if (e <= a) return 0ull;
  const unsigned long long n = e - a == TILE ? ~0ull : ((1ull << (e - a)) - 1ull);
  return n << a;
}

// The rows [a, a + n) of the tile at kv position r0 that one unit of class
// `cls` lets through: all of them when FULL; when PARTIAL those the decode
// mask at q_pos = kv_len - 1 keeps (k_pos <= q_pos, within the window, and
// kv_mask when given), as masks.decode_kv_valid.
__device__ __forceinline__ unsigned long long unit_rows(int cls, int a, int n, int r0, int qp,
                                                        int window, const uint8_t* kvm) {
  if (cls == BLOCK_FULL) return row_range(a, a + n);
  if (cls != BLOCK_PARTIAL) return 0ull;
  const int lo = window >= 0 ? qp - window + 1 - r0 : a;   // first row inside the window
  const int e = min(a + n, qp + 1 - r0);
  unsigned long long ok = row_range(max(a, lo), e);
  if (kvm != nullptr) {
    for (int r = max(max(a, lo), 0); r < e; ++r) {
      if (kvm[r0 + r] == 0) ok &= ~(1ull << r);
    }
  }
  return ok;
}

// The per-warp arithmetic of one ring stage, in two bodies over the same
// stage layout, listing, ring and merges. A core keeps its warp's online
// softmax state (fp32 m, l, acc) and, at the end, stages it for the CTA's
// merge: per (warp, group) its acc rows in `gacc` ([warp][group][head][D],
// every group of a warp at the warp's max) and per warp its m and l.

// fp32 (CUDA cores): LPR lanes share one key row, CPL 16-byte chunks each;
// the lanes form the partial dots of every q head and reduce them by xor
// shuffles, so every lane of the row holds the scores. Each row group of
// the CTA takes rows group, group + ROW_GROUPS, ... of a tile.
template <int D>
struct ScalarCore {
  using G = Geo<float, D>;
  static constexpr int GROUPS_PER_WARP = G::RPW;
  static constexpr int E = G::CPL * G::EPC;   // elements of a row this lane holds
  static_assert(G::EPC == 4, "a chunk is one float4");
  float q[HEADS][E];                     // this lane's chunks of q * scale
  float m[HEADS], l[HEADS], acc[HEADS][E];
  int ch, group, warp, lane;

  __device__ static int offset(int r, int c) { return r * D + c * G::EPC; }
  // element j * EPC of this lane's row slice: chunk ch + j * LPR
  __device__ int col(int j) const { return (ch + j * G::LPR) * G::EPC; }

  __device__ __forceinline__ void init(const float* qg, int nh, float scale, int w, int ln) {
    warp = w;
    lane = ln;
    ch = lane % G::LPR;
    group = warp * G::RPW + lane / G::LPR;
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
#pragma unroll
      for (int j = 0; j < G::CPL; ++j) {
        float* qj = q[h] + j * G::EPC;
        if (h < nh) {
          float f[G::EPC];
          unpack(*reinterpret_cast<const uint4*>(qg + h * D + col(j)), f);
#pragma unroll
          for (int e = 0; e < G::EPC; ++e) qj[e] = f[e] * scale;
        } else {
#pragma unroll
          for (int e = 0; e < G::EPC; ++e) qj[e] = 0.f;
        }
      }
      m[h] = NEG_INF;
      l[h] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
    }
  }

  // this lane's chunks of row r of a tile
  __device__ __forceinline__ void row(const float* t, int r, float (&f)[E]) const {
#pragma unroll
    for (int j = 0; j < G::CPL; ++j) {
      float c[G::EPC];
      unpack(*reinterpret_cast<const uint4*>(t + r * D + col(j)), c);
#pragma unroll
      for (int e = 0; e < G::EPC; ++e) f[j * G::EPC + e] = c[e];
    }
  }

  // one tile's scores and P.V into this row group's state
  __device__ __forceinline__ void tile(const float* ks, const float* vs, unsigned long long ok) {
#pragma unroll
    for (int k0 = 0; k0 < G::RG_ROWS; k0 += G::KB) {
      float s[G::KB][HEADS];
#pragma unroll
      for (int kk = 0; kk < G::KB; ++kk) {
        const int r = group + (k0 + kk) * G::ROW_GROUPS;
        float kf[E];
        row(ks, r, kf);
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(q[h][e], kf[e], dot);
#pragma unroll
          for (int o = 1; o < G::LPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          s[kk][h] = ((ok >> r) & 1ull) ? dot : NEG_INF;
        }
      }
      // online softmax per head; s becomes p
#pragma unroll
      for (int h = 0; h < HEADS; ++h) {
        float mx = m[h];
#pragma unroll
        for (int kk = 0; kk < G::KB; ++kk) mx = fmaxf(mx, s[kk][h]);
        const float corr = (m[h] <= NEG_INF / 2) ? 0.f : exp_f32(m[h] - mx);
        float sum = 0.f;
#pragma unroll
        for (int kk = 0; kk < G::KB; ++kk) {
          s[kk][h] = (s[kk][h] <= NEG_INF / 2) ? 0.f : exp_f32(s[kk][h] - mx);
          sum += s[kk][h];
        }
        l[h] = l[h] * corr + sum;
        m[h] = mx;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] *= corr;
      }
#pragma unroll
      for (int kk = 0; kk < G::KB; ++kk) {
        const int r = group + (k0 + kk) * G::ROW_GROUPS;
        float vf[E];
        row(vs, r, vf);
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[h][e] = fmaf(s[kk][h], vf[e], acc[h][e]);
        }
      }
    }
  }

  // the warp's max per head by shuffles, every row group rescaled to it, l
  // summed over the warp; each group's acc row staged
  __device__ __forceinline__ void stage(float* gacc, float (&wm)[WARPS][HEADS],
                                        float (&wl)[WARPS][HEADS]) {
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      float mx = m[h];
#pragma unroll
      for (int o = G::LPR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float w = (m[h] <= NEG_INF / 2) ? 0.f : exp_f32(m[h] - mx);
      float lw = l[h] * w;
#pragma unroll
      for (int o = G::LPR; o < 32; o <<= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
#pragma unroll
      for (int j = 0; j < G::CPL; ++j) {
        const float* a = acc[h] + j * G::EPC;
        *reinterpret_cast<float4*>(gacc + (group * HEADS + h) * D + col(j)) =
            make_float4(a[0] * w, a[1] * w, a[2] * w, a[3] * w);
      }
      if (lane == 0) {
        wm[warp][h] = mx;
        wl[warp][h] = lw;
      }
    }
  }
};

// bf16 (tensor cores, mma.sync m16n8k16 bf16 -> fp32): the group's q heads
// are the rows of A (rows past the group's heads are zero) and each warp
// takes rows 16 warp .. 16 warp + 15 of a tile: S = Q K^T from K by
// ldmatrix, scaled and masked in fp32, P = exp(S - m) rounded to bf16 as
// the A operand of O += P V (V by ldmatrix.trans; the C fragments of S are
// the A fragments of P, as in flash_fwd.cu). Lane l holds head l / 4: its
// four scores at rows 16 warp + 8 j + 2 (l % 4) + {0, 1}, and O at dims
// 8 nt + 2 (l % 4) + {0, 1}. The tiles are XOR-swizzled (flash::swizzle)
// so that ldmatrix and the 16-byte copies are conflict-free.
template <int D>
struct MmaCore {
  static_assert(HEADS <= 8, "q heads are the rows 0-7 of an m16n8k16 A tile");
  static constexpr int GROUPS_PER_WARP = 1;
  static constexpr int KS = D / 16;      // k steps of Q K^T
  static constexpr int NT = D / 8;       // 8-wide dim tiles of P V
  uint32_t qa[KS][2];                    // A fragments of q: rows l / 4, cols 2 (l % 4) (+8)
  float m, l, o[NT][4];
  float scale;
  int warp, lane;

  __device__ static int offset(int r, int c) { return flash::swizzle<D>(r, c); }

  __device__ __forceinline__ void init(const __nv_bfloat16* qg, int nh, float sc, int w, int ln) {
    warp = w;
    lane = ln;
    scale = sc;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      qa[k][0] = qa[k][1] = 0u;
      if (g < nh) {
        qa[k][0] = *reinterpret_cast<const uint32_t*>(qg + g * D + 16 * k + 2 * t);
        qa[k][1] = *reinterpret_cast<const uint32_t*>(qg + g * D + 16 * k + 8 + 2 * t);
      }
    }
    m = NEG_INF;
    l = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }

  __device__ __forceinline__ void tile(const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                       unsigned long long ok) {
    const int t = lane % 4, i = lane / 8;
    float c[2][4] = {};
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      // matrices: rows +0-7 / +8-15 (i / 2) x d 16 k + 0-7 / 8-15 (i % 2)
      uint32_t bk[4];
      flash::ldsm_x4(bk, ks + offset(16 * warp + (i / 2) * 8 + lane % 8, 2 * k + i % 2));
      const uint32_t a[4] = {qa[k][0], 0u, qa[k][1], 0u};
      flash::mma_bf16(c[0], a, bk[0], bk[1]);
      flash::mma_bf16(c[1], a, bk[2], bk[3]);
    }
    float s[2][2], mx = m;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * warp + 8 * j + 2 * t + e;
        s[j][e] = ((ok >> r) & 1ull) ? c[j][e] * scale : NEG_INF;
        mx = fmaxf(mx, s[j][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));   // the head's 4 lanes
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = (m <= NEG_INF / 2) ? 0.f : exp_f32(m - mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = (s[j][e] <= NEG_INF / 2) ? 0.f : exp_f32(s[j][e] - mx);
        sum += s[j][e];
      }
    }
    l = l * corr + sum;     // this lane's share of the head's l
    m = mx;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= corr;
      o[nt][1] *= corr;
    }
    const uint32_t a[4] = {flash::pack_bf16(s[0][0], s[0][1]), 0u,
                           flash::pack_bf16(s[1][0], s[1][1]), 0u};
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // matrices: rows +0-7 / +8-15 (i % 2) x d chunk 2 np / 2 np + 1 (i / 2)
      uint32_t bv[4];
      flash::ldsm_x4_trans(bv, vs + offset(16 * warp + (i % 2) * 8 + lane % 8, 2 * np + i / 2));
      flash::mma_bf16(o[2 * np], a, bv[0], bv[1]);
      flash::mma_bf16(o[2 * np + 1], a, bv[2], bv[3]);
    }
  }

  // one state per head and warp: l summed over the head's 4 lanes
  __device__ __forceinline__ void stage(float* gacc, float (&wm)[WARPS][HEADS],
                                        float (&wl)[WARPS][HEADS]) {
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int g = lane / 4, t = lane % 4;
    if (g < HEADS) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<float2*>(gacc + (warp * HEADS + g) * D + 8 * nt + 2 * t) =
            make_float2(o[nt][0], o[nt][1]);
      }
      if (t == 0) {
        wm[warp][g] = m;
        wl[warp][g] = l;
      }
    }
  }
};

template <typename T, int D, bool Paged>
__device__ __forceinline__ void decode_body(const DecodeParams& p) {
  using G = Geo<T, D>;
  using Core = std::conditional_t<std::is_same<T, __nv_bfloat16>::value, MmaCore<D>,
                                  ScalarCore<D>>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  DecodeShared<D>& sh = *reinterpret_cast<DecodeShared<D>*>(smem + G::RING_BYTES);

  const int si = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / p.head_groups, hg = blockIdx.y % p.head_groups;
  const int n_rep = p.hq / p.hkv;
  const int h0 = kvh * n_rep + hg * HEADS;           // first q head of the CTA
  const int nh = min(HEADS, n_rep - hg * HEADS);      // q heads it holds
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int kv_len = p.kv_len[b];
  const int qp = kv_len - 1;                          // decode: q_pos = kv_len - 1
  const int split_rows = p.n_units / p.num_splits * p.unit;
  const int row0 = si * split_rows;                   // first kv position of the split
  const int n_tiles = (split_rows + TILE - 1) / TILE;

  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  if constexpr (Paged) {
    const long long pool = (long long)kvh * p.num_pages * p.unit * D;
    kg += pool;
    vg += pool;
  } else {
    const long long seq = ((long long)b * p.hkv + kvh) * p.n_units * p.unit * D;
    kg += seq;
    vg += seq;
  }
  const int ps_shift = Paged ? __ffs(p.unit) - 1 : 0;  // pages are powers of two

  Core core;
  core.init(static_cast<const T*>(p.q) + ((long long)b * p.hq + h0) * D, nh, p.scale, warp,
            lane);

  // the 16-byte copies of listed tile `idx` into ring stage `st`
  auto issue = [&](int idx, int st) {
    const unsigned long long ok = sh.rows_ok[idx];
    const int r0 = row0 + sh.tile[idx] * TILE;
    T* ks = ring + st * G::STAGE_ELEMS;
    T* vs = ks + TILE * D;
    constexpr int CPR = D / G::EPC;                   // 16-byte chunks per row
#pragma unroll 2   // unrolled further, the fp32 paged bodies spill
    for (int i = tid; i < TILE * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      const bool valid = (ok >> r) & 1ull;
      long long off = 0;   // a dead row keeps the base address and is not read
      if (valid) {
        if constexpr (Paged) {
          const int page = sh.pages[idx][r >> ps_shift];
          off = ((long long)page * p.unit + (r & (p.unit - 1))) * D + c * G::EPC;
        } else {
          off = (long long)(r0 + r) * D + c * G::EPC;
        }
      }
      flash::cp_async16_zfill(ks + Core::offset(r, c), kg + off, valid);
      flash::cp_async16_zfill(vs + Core::offset(r, c), vg + off, valid);
    }
  };

  for (int c0 = 0; c0 < n_tiles; c0 += LIST_TILES) {
    __syncthreads();   // the previous pass's list and ring are consumed
    if (warp == 0) {
      // list the tiles c0 .. c0 + 31 of the split that hold a valid key
      const int t = c0 + lane;
      unsigned long long ok = 0ull;
      int pg[MAX_PPT];
#pragma unroll
      for (int i = 0; i < MAX_PPT; ++i) pg[i] = 0;
      if (t < n_tiles) {
        const int r0 = row0 + t * TILE;
        const int rows = min(TILE, split_rows - t * TILE);
        const int32_t* lay = p.layout + (long long)b * p.n_units;
        if constexpr (Paged) {
          const int u0 = r0 >> ps_shift, npg = rows >> ps_shift;
#pragma unroll
          for (int i = 0; i < MAX_PPT; ++i) {
            if (i < npg) {
              const int cls = lay[u0 + i];        // the class before the page index
              if (cls == BLOCK_FULL || cls == BLOCK_PARTIAL) {
                pg[i] = p.page_table[(long long)b * p.n_units + u0 + i];
                ok |= unit_rows(cls, i * p.unit, p.unit, r0, qp, p.window, nullptr);
              }
            }
          }
        } else {
          const uint8_t* kvm = p.kv_mask != nullptr
                                   ? p.kv_mask + (long long)b * p.n_units * p.unit : nullptr;
          for (int u = r0 / p.unit; u * p.unit < r0 + rows; ++u) {
            const int a = max(u * p.unit, r0) - r0;
            const int e = min((u + 1) * p.unit, r0 + rows) - r0;
            ok |= unit_rows(lay[u], a, e - a, r0, qp, p.window, kvm);
          }
        }
      }
      const unsigned live = __ballot_sync(0xffffffffu, ok != 0ull);
      if (ok != 0ull) {
        const int idx = __popc(live & ((1u << lane) - 1u));
        sh.rows_ok[idx] = ok;
        sh.tile[idx] = t;
        if constexpr (Paged) {
#pragma unroll
          for (int i = 0; i < MAX_PPT; ++i) sh.pages[idx][i] = pg[i];
        }
      }
      if (lane == 0) sh.n_live = __popc(live);
    }
    __syncthreads();
    const int n_live = sh.n_live;
#pragma unroll
    for (int s = 0; s < G::STAGES - 1; ++s) {
      if (s < n_live) issue(s, s);
      flash::cp_async_commit();
    }
    for (int i = 0; i < n_live; ++i) {
      const int nxt = i + G::STAGES - 1;
      if (nxt < n_live) issue(nxt, nxt % G::STAGES);
      flash::cp_async_commit();
      flash::cp_async_wait<G::STAGES - 1>();   // tile i has landed (this thread's part)
      __syncthreads();                          // ... and every thread's
      const T* ks = ring + (i % G::STAGES) * G::STAGE_ELEMS;
      core.tile(ks, ks + TILE * D, sh.rows_ok[i]);
      __syncthreads();                          // its stage may be refilled
    }
  }
  flash::cp_async_wait_all();

  // the CTA's partial: each warp's state staged through the (now idle) ring
  static_assert(WARPS * Core::GROUPS_PER_WARP * HEADS * D * 4 <= G::RING_BYTES,
                "acc staging exceeds the ring");
  float* gacc = reinterpret_cast<float*>(smem);   // [WARPS][GROUPS_PER_WARP][HEADS][D]
  __syncthreads();
  core.stage(gacc, sh.wm, sh.wl);
  __syncthreads();
  // then the four warps, in warp order: the CTA's partial
  for (int i = tid; i < HEADS * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sh.wm[w][h]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wgt = (sh.wm[w][h] <= NEG_INF / 2) ? 0.f : exp_f32(sh.wm[w][h] - mx);
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < Core::GROUPS_PER_WARP; ++g) {
        sum += gacc[((w * Core::GROUPS_PER_WARP + g) * HEADS + h) * D + d];
      }
      a += sum * wgt;
      ll += sh.wl[w][h] * wgt;
    }
    sh.acc[h][d] = a;
    if (d == 0) {
      sh.m[h] = mx;
      sh.l[h] = ll;
    }
    if (h < nh) {
      const long long row = ((long long)b * p.hq + h0 + h) * p.num_splits + si;
      p.o_p[row * D + d] = a;
      if (d == 0) {
        p.m_p[row] = mx;
        p.l_p[row] = ll;
      }
    }
  }

  // the cluster merges its partials: rank r takes the r-th slice of the
  // (head, dim) outputs and reads that slice of every rank's partial
  // through distributed shared memory, in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  {
    T* out = static_cast<T*>(p.out);
    const int n_out = nh * D, per = (n_out + p.num_splits - 1) / p.num_splits;
    const int first = cluster.block_rank() * per, last = min(n_out, first + per);
    for (int i = first + tid; i < last; i += THREADS) {
      const int h = i / D, d = i % D;
      float mr[MAX_SPLITS], lr[MAX_SPLITS], ar[MAX_SPLITS];
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < p.num_splits) {
          const DecodeShared<D>* o = cluster.map_shared_rank(&sh, r);
          mr[r] = o->m[h];
          lr[r] = o->l[h];
          ar[r] = o->acc[h][d];
        }
      }
      float mx = NEG_INF;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < p.num_splits) mx = fmaxf(mx, mr[r]);
      }
      float a = 0.f, ll = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < p.num_splits) {
          const float wgt = (mr[r] <= NEG_INF / 2) ? 0.f : exp_f32(mr[r] - mx);
          ll += lr[r] * wgt;
          a += ar[r] * wgt;
        }
      }
      flash::store_out(out + ((long long)b * p.hq + h0 + h) * D + d, a / (ll == 0.f ? 1.f : ll));
    }
  }
  cluster.sync();      // every rank stays until the others have read it
}

template <typename T, int D, bool Paged>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(const DecodeParams p) {
  decode_body<T, D, Paged>(p);
}

// Given launch bounds without a count of CTAs an SM must hold, ptxas cuts a
// kernel's registers to the next CTA tier when it is close to one, and may
// spill to get there: at d = 96 it did (the bf16 bodies: 128 registers and
// 4-8 bytes of spill, on the card). The d = 96 bodies launch through this
// kernel, which names the CTAs an SM must hold, so that ptxas keeps the
// registers that allow them: 3 in bf16 (at most 168 registers, where the
// ring's shared memory allows 4), 2 in fp32 (whose 101 KB of shared memory
// allow no more; at 3, its 168 registers spilled 12-24 bytes). The other
// head dims keep the kernel they were measured with.
template <typename T>
constexpr int kMinBlocks96 = std::is_same<T, __nv_bfloat16>::value ? 3 : 2;

template <typename T, int D, bool Paged>
__global__ void __launch_bounds__(THREADS, kMinBlocks96<T>)
    flash_decode_kernel_min(const DecodeParams p) {
  decode_body<T, D, Paged>(p);
}

// the kernel of one instantiation (only the one it launches is compiled)
template <typename T, int D, bool Paged>
auto decode_kernel() {
  if constexpr (D == 96) {
    return flash_decode_kernel_min<T, D, Paged>;
  } else {
    return flash_decode_kernel<T, D, Paged>;
  }
}

template <typename T, int D, bool Paged>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, D>();
  auto kernel = decode_kernel<T, D, Paged>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // all of the SM's unified memory as shared memory, so that several CTAs
  // fit on an SM (left to the driver, it may pick a carveout for one)
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.num_splits, p.hkv * p.head_groups, p.b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.num_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // the default (spread) placement left a quarter of the CTAs of a one-wave
  // grid (batch 8 x 8 kv heads x 8 splits) to a second wave; load
  // balancing places them all at once
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool Paged>
cudaError_t dispatch(int dtype, int head_dim, const DecodeParams& p, cudaStream_t s) {
#define FLASH_DECODE_D(T)                           \
  switch (head_dim) {                               \
    case 16: return launch<T, 16, Paged>(p, s);     \
    case 32: return launch<T, 32, Paged>(p, s);     \
    case 64: return launch<T, 64, Paged>(p, s);     \
    case 96: return launch<T, 96, Paged>(p, s);     \
    case 128: return launch<T, 128, Paged>(p, s);   \
    default: return cudaErrorInvalidValue;          \
  }
  if (dtype == 0) FLASH_DECODE_D(float)
  if (dtype == 1) FLASH_DECODE_D(__nv_bfloat16)
#undef FLASH_DECODE_D
  return cudaErrorInvalidValue;
}

DecodeParams make_params(const void* q, const void* k, const void* v, const int32_t* kv_len,
                         const int32_t* layout, float* o_p, float* m_p, float* l_p, void* out,
                         int b, int hq, int hkv, int n_units, int unit, int num_splits,
                         int window, float scale) {
  DecodeParams p = {};
  p.q = q; p.k = k; p.v = v;
  p.kv_len = kv_len; p.layout = layout;
  p.o_p = o_p; p.m_p = m_p; p.l_p = l_p; p.out = out;
  p.b = b; p.hq = hq; p.hkv = hkv;
  p.head_groups = (hq / hkv + HEADS - 1) / HEADS;
  p.n_units = n_units; p.unit = unit;
  p.num_splits = num_splits; p.window = window; p.scale = scale;
  return p;
}

bool bad_grid(int b, int hq, int hkv, int n_units, int num_splits) {
  return b <= 0 || hkv <= 0 || hq % hkv || num_splits < 1 || num_splits > MAX_SPLITS ||
         n_units % num_splits;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
// Writes the split partials (o_p, m_p, l_p) and the merged output `out`.
int flash_decode_paged(int dtype, int head_dim,
                       const void* q, const void* k_pool, const void* v_pool,
                       const int32_t* page_table, const int32_t* kv_len,
                       const int32_t* layout,
                       float* o_p, float* m_p, float* l_p, void* out,
                       int b, int hq, int hkv, int num_pages, int page_size,
                       int T, int num_splits, int window, float scale,
                       void* stream) {
  const bool page_ok = page_size == 8 || page_size == 16 || page_size == 32 || page_size == 64;
  if (!page_ok || bad_grid(b, hq, hkv, T, num_splits)) return (int)cudaErrorInvalidValue;
  DecodeParams p = make_params(q, k_pool, v_pool, kv_len, layout, o_p, m_p, l_p, out, b, hq,
                               hkv, T, page_size, num_splits, window, scale);
  p.page_table = page_table;
  p.num_pages = num_pages;
  return (int)dispatch<true>(dtype, head_dim, p, static_cast<cudaStream_t>(stream));
}

// The contiguous-cache decode; same conventions. kv_mask may be null.
int flash_decode(int dtype, int head_dim,
                 const void* q, const void* k, const void* v,
                 const int32_t* kv_len, const int32_t* layout, const uint8_t* kv_mask,
                 float* o_p, float* m_p, float* l_p, void* out,
                 int b, int hq, int hkv, int capacity, int block_k, int num_splits,
                 int window, float scale, void* stream) {
  if (block_k <= 0 || capacity % block_k ||
      bad_grid(b, hq, hkv, capacity / block_k, num_splits)) {
    return (int)cudaErrorInvalidValue;
  }
  DecodeParams p = make_params(q, k, v, kv_len, layout, o_p, m_p, l_p, out, b, hq, hkv,
                               capacity / block_k, block_k, num_splits, window, scale);
  p.kv_mask = kv_mask;
  return (int)dispatch<false>(dtype, head_dim, p, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one CTA and ring stages, for a (dtype, head_dim)
// the kernels take; -1 otherwise.
int flash_decode_smem_bytes(int dtype, int head_dim, int* stages) {
#define FLASH_DECODE_SMEM(T, D)                  \
  if (head_dim == D) {                           \
    *stages = Geo<T, D>::STAGES;                 \
    return smem_bytes<T, D>();                   \
  }
  if (dtype == 0) {
    FLASH_DECODE_SMEM(float, 16) FLASH_DECODE_SMEM(float, 32)
    FLASH_DECODE_SMEM(float, 64) FLASH_DECODE_SMEM(float, 96)
    FLASH_DECODE_SMEM(float, 128)
  } else if (dtype == 1) {
    FLASH_DECODE_SMEM(__nv_bfloat16, 16) FLASH_DECODE_SMEM(__nv_bfloat16, 32)
    FLASH_DECODE_SMEM(__nv_bfloat16, 64) FLASH_DECODE_SMEM(__nv_bfloat16, 96)
    FLASH_DECODE_SMEM(__nv_bfloat16, 128)
  }
#undef FLASH_DECODE_SMEM
  return -1;
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
