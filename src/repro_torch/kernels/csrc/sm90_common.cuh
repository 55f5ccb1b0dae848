// Building blocks of the Hopper (sm_90a) attention kernels written on
// wgmma, TMA and mbarriers: flash_bwd_sm90.cu (the backward pair) and
// flash_fwd_sm90.cu (the forward and the paged prefill). One definition of
// the PTX wrappers (mbarriers, TMA tile and bulk copies, wgmma in its SS and
// RS forms with 128-byte-swizzle descriptors, the accumulator -> A-fragment
// conversion), of the branch-free element mask, of the paged K/V pieces
// (the per-page tile words, the walk builder, one TMA box a page with a page
// that does not run asked past the pool) and of the host's tensor maps, so
// the kernels that share them cannot drift apart.
//
// wgmma's accumulator layout, within a warp, is mma.sync's C fragment
// repeated every 8 columns: register x of a 64 x N accumulator holds row
// 16 * warp + lane / 4 + 8 * ((x >> 1) & 1) and column
// 8 * (x >> 2) + 2 * (lane % 4) + (x & 1) (`col_of` for N > 64).

#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BOX = 64;                    // rows and columns of one TMA box
constexpr int BOX_BYTES = BOX * BOX * 2;   // 8 KiB, 128-byte rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int THREADS_ALL = (CONSUMERS + 1) * 128;
constexpr int WARPS_ALL = THREADS_ALL / 32;
constexpr int MAX_PAGES = 8;               // pages of one 64-key tile (page 8)

// A warpgroup's word for one kv tile: bit j of byte 0 / 1 / 2 = layout block
// j of the tile (one page, or the whole contiguous tile) runs / takes the
// geometric terms / takes the data terms; TAIL: the tile reaches past sk (a
// key axis of one block shorter than 64), so its columns are bounded
constexpr uint32_t TAIL = 1u << 24;

// --------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma
// --------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of copies on this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
// wait until the phase of parity `parity` has completed; a ring that never
// fills (a transaction count that cannot be met) traps after ~10 s of
// waiting instead of hanging the card. (The backward pair waits with
// mbar_wait: with this wait's clock reads in its consumers' loops, ptxas
// spilled registers in most of its instantiations.)
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}
// one 64 x 64 box of a 3-D tensor map at (column, row, head)
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                        int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) by the bulk engine
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// a row of tiles: the 64-row tile at (rows r0.., head hd) of `map`, NB boxes
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                         int r0, int hd) {
#pragma unroll
  for (int j = 0; j < (D + BOX - 1) / BOX; ++j) tma_box(dst + j * BOX_BYTES, map, bar, j * BOX, r0, hd);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of an accumulator across a wgmma
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start, leading and
// stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (rows = M or N, 128-byte rows of 64 values of K): k16
// step kk of a 64-row tile; 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024);
}
// MN-major B operand (rows = K, 128-byte rows of 64 values of N): k16 step
// kk of chunk j (columns 64j..64j+63) of a 64-row tile; 8-row groups of K
// 1024 bytes apart, and a chunk never leaves its box
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int j, int kk) {
  return sw128_desc(tile + j * BOX_BYTES + kk * 2048, 1024, 1024);
}

// d (64 x 64) += A (64 x 16) * B^T (64 x 16), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += A (64 x 16, registers) * B (16 x 32), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc (64 x D) += A (64 x 64, four k16 register fragments) * the 64-row
// tile B read MN-major, one wgmma per 64-column chunk (columns 64j.. are
// registers 32j..) and k16 step
template <int D>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                           uint32_t tile) {
#pragma unroll
  for (int j = 0; j < (D + BOX - 1) / BOX; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (D - 64 * j >= 64) {
        wgmma_rs_n64(acc + 32 * j, a[kk], mnmajor(tile, j, kk));
      } else {
        wgmma_rs_n32(acc + 32 * j, a[kk], mnmajor(tile, j, kk));
      }
    }
  }
}
// register x of a 64 x D accumulator holds row 8 * ((x >> 1) & 1) + g of
// the warp's 16 and column col_of<D>(x) + (x & 1)
__device__ __forceinline__ int col_of(int x, int t4) {
  return 64 * (x >> 5) + 8 * ((x & 31) >> 2) + 2 * t4;
}
// s (64 x 64) = A (a 64-row tile) * B^T (a 64-row tile), both K-major
template <int D>
__device__ __forceinline__ void ss_product(float (&s)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, kmajor(a_tile, kk), kmajor(b_tile, kk), kk);
}
// the A fragments of k16 steps 0-3 from a 64 x 64 accumulator, element i
// kept where bit i of `keep` is set and 0 elsewhere
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&c)[32],
                                     uint32_t keep = ~0u) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 8 * kk + 2 * x;
      a[kk][x] = pack_bf16(((keep >> i) & 1u) ? c[i] : 0.f,
                           ((keep >> (i + 1)) & 1u) ? c[i + 1] : 0.f);
    }
  }
}

// 2^x on the special function unit, denormal results flushed to 0 (a
// probability below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// MaskParams::element_ok_staged with the call's terms read once: which
// terms exist is uniform over a call, and the element test is then
// branch-free predicate logic
struct ElementMask {
  int window, kv_valid_len;
  bool win, valid, kvm, seg;
  __device__ __forceinline__ explicit ElementMask(const MaskParams& mp)
      : window(mp.window), kv_valid_len(mp.kv_valid_len), win(mp.window >= 0),
        valid(mp.kv_valid_len >= 0), kvm(mp.kv_mask != nullptr), seg(mp.q_seg != nullptr) {}
  __device__ __forceinline__ bool ok(bool geo_on, bool data_on, int qpos, int qseg, int kpos,
                                     int kseg, int kval, int col) const {
    const bool geo = (qpos >= kpos) & (!win | (qpos - kpos < window));
    const bool data =
        (!valid | (col < kv_valid_len)) & (!kvm | (kval != 0)) & (!seg | (qseg == kseg));
    return (!geo_on | geo) & (!data_on | data);
  }
};

__device__ __forceinline__ uint32_t terms(const MaskParams& mp, int b, int qi, int ki) {
  bool geo, data;
  if (!mp.tile_terms(mp.block_class(b, qi, ki), geo, data)) return 0u;
  return 1u | (geo ? 2u : 0u) | (data ? 4u : 0u);
}

// --------------------------------------------------------------------------
// paged K/V: a 64-key tile is 64 / ps page slots of the page list
// --------------------------------------------------------------------------

// A warpgroup's word for kv tile t of layout row qb (0: the row is past
// nq). Paged: ``pages`` holds the tile's slots' pages (< 0: dead), the
// layout block is one page of 2^lg_ps rows and nk counts page slots;
// contiguous: one block, nk blocks over sk keys
template <bool Paged>
__device__ __forceinline__ uint32_t tile_word(const MaskParams& mp, int b, int qb, int t, int nq,
                                              int nk, int sk, int lg_ps,
                                              const int (&pages)[MAX_PAGES]) {
  if (qb >= nq) return 0u;
  uint32_t w = 0u;
  if constexpr (Paged) {
    const int G = BOX >> lg_ps;
#pragma unroll 1
    for (int j = 0; j < G; ++j) {
      const int s = t * G + j;
      if (s >= nk) break;                           // dead slots of a ragged last tile
      const uint32_t e = terms(mp, b, qb, s);
      if (!(e & 1u) || pages[j] < 0) continue;
      w |= (1u | (((e >> 1) & 1u) << 8) | (((e >> 2) & 1u) << 16)) << j;
    }
  } else {
    const uint32_t e = terms(mp, b, qb, t);
    w = (e & 1u) | (((e >> 1) & 1u) << 8) | (((e >> 2) & 1u) << 16);
    if (w != 0u && (t + 1) * BOX > sk) w |= TAIL;
  }
  return w;
}

// the pages of paged kv tile t's slots (-1: past the tile's 64 / ps slots or
// past the list's nk), independent loads issued together
__device__ __forceinline__ void tile_pages(const int32_t* page_list, int b, int nk, int t,
                                           int lg_ps, int (&pages)[MAX_PAGES]) {
  const int G = BOX >> lg_ps;
#pragma unroll
  for (int j = 0; j < MAX_PAGES; ++j) {
    const int s = t * G + j;
    pages[j] = j < G && s < nk ? page_list[(long long)b * nk + s] : -1;
  }
}

// Ordered compaction of the `n` kv tiles into the walk: tile indices in
// widx, each warpgroup's word in wb0 / wb1, tiles whose words have no
// running block left out; by every thread of the CTA. With Paged, each
// tile's MAX_PAGES pages go to wpages too. The count lands in
// counts[WARPS_ALL], where both roles read it
template <bool Paged, typename F>
__device__ __forceinline__ void build_walk(uint32_t* widx, uint32_t* wb0, uint32_t* wb1,
                                           int* wpages, int* counts, int n, F words) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int count = 0;
  for (int base = 0; base < n; base += THREADS_ALL) {
    const int i = base + tid;
    uint32_t w0 = 0u, w1 = 0u;
    int pages[MAX_PAGES];
    if (i < n) words(i, w0, w1, pages);
    const bool runs = ((w0 | w1) & 0xffu) != 0u;
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
    if (runs) {
      const int at = off + __popc(bal & ((1u << lane) - 1u));
      widx[at] = (uint32_t)i;
      wb0[at] = w0;
      wb1[at] = w1;
      if constexpr (Paged) {
#pragma unroll
        for (int j = 0; j < MAX_PAGES; ++j) wpages[at * MAX_PAGES + j] = pages[j];
      }
    }
    count += total;
    if (tid == 0) counts[WARPS_ALL] = count;
    __syncthreads();
  }
}

// page slot of box `bx` of a paged 64-key tile of K and V (see paged_kv_box)
template <int NB>
__device__ __forceinline__ int box_page(int bx) {
  return (bx >> 1) / NB;
}
// Box `bx` of a paged 64-key tile of K and V, at k_dst / v_dst (NB 64-column
// boxes of 64 rows each): K or V (bx & 1), 64-column chunk (bx >> 1) % NB,
// page slot jj = box_page<NB>(bx), whose page is `page`; nothing past the
// tile's 64 / ps slots. A slot whose bit of `live` is clear (SKIP, dead,
// past the list) is asked past the pool: TMA zero-fills it without reading
// memory and still counts its bytes, so the page is never addressed
template <int NB>
__device__ __forceinline__ void paged_kv_box(int bx, unsigned char* k_dst, unsigned char* v_dst,
                                             const CUtensorMap* tk, const CUtensorMap* tv,
                                             uint64_t* bar, uint32_t live, int page, int lg_ps,
                                             int num_pages, int kvh) {
  const int nb = (bx >> 1) % NB, jj = box_page<NB>(bx);
  if (jj >= (BOX >> lg_ps)) return;
  const int row = (live >> jj) & 1u ? page << lg_ps : num_pages << lg_ps;
  unsigned char* dst = ((bx & 1) ? v_dst : k_dst) + nb * BOX_BYTES + (jj << lg_ps) * 128;
  tma_box(dst, (bx & 1) ? tv : tk, bar, nb * BOX, row, kvh);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the library does not link:
// it is reached through the CUDA runtime's entry-point query
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// a (d, rows, heads) bf16 tensor read as boxes of 64 columns by `box_rows`
// rows with the 128-byte swizzle; coordinates past d or rows read as zero
cudaError_t make_map(CUtensorMap* map, const void* base, int d, int rows, int heads,
                     int box_rows = BOX) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
// a page pool (heads, num_pages, ps, d) read as (d, num_pages * ps, heads)
// in boxes of one page; rows from num_pages * ps on read as zero
cudaError_t make_paged_map(CUtensorMap* map, const void* pool, int d, int num_pages, int ps,
                           int heads) {
  return make_map(map, pool, d, num_pages * ps, heads, ps);
}

}  // namespace
