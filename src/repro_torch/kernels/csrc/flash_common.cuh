// Shared pieces of the FlashAttention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_decode.cu): the compiled block-layout classes, the fused element
// mask, the counter-based dropout hash and the asynchronous copies. One
// definition, so the forward, the two backward kernels and the decode
// cannot drift apart.
//
//   * layout classes and the per-tile choice of mask terms follow
//     src/repro/kernels/flash_attention.py:_layout_branches: SKIP tiles run
//     nothing, FULL tiles run unmasked, PARTIAL tiles apply every term of
//     the fused mask, PARTIAL_DATA tiles only its data terms; a call with
//     no term at all runs every non-SKIP tile unmasked.
//   * the element mask is core/masks.element_mask: causal q_pos >= k_pos,
//     window q_pos - k_pos < window (implies causal), kv_valid_len on the
//     buffer column, kv_mask, and q_seg == kv_seg.
//   * dropout is kernels/ref.dropout_keep_mask (the JAX package's
//     _dropout_keep): idx = ((b*H + h)*q_len + q)*k_len + k in wrapping
//     uint32, keep = mix32(idx ^ mix32(seed)) >= threshold, over BUFFER
//     coordinates with the unpadded (q_len, k_len) as strides; a rank of a
//     sharded step hashes its global (b0 + b, h0 + h) with the global H.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr int BLOCK_SKIP = 0;
constexpr int BLOCK_FULL = 1;
constexpr int BLOCK_PARTIAL = 2;
constexpr int BLOCK_PARTIAL_DATA = 3;

constexpr int NUM_WARPS = 8;
constexpr int THREADS = NUM_WARPS * 32;
constexpr int MAX_BQ = 64;
constexpr int MAX_BK = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The compiled layout and the mask operands of one call. A kernel copies
// it (and DropoutParams) out of its parameter struct by value before use,
// so the member functions below work on registers, not on the parameter.
struct MaskParams {
  const int32_t* layout;      // (nq, nk) or (b, nq, nk)
  long long layout_b_stride;  // 0 for a static (nq, nk) layout
  const uint8_t* kv_mask;     // (b, sk) or null
  const int32_t* q_seg;       // (b, sq) or null
  const int32_t* kv_seg;      // (b, sk) or null
  const int32_t* q_pos;       // (b, sq) or null
  const int32_t* kv_pos;      // (b, sk) or null
  int nq, nk;
  int causal, window, q_offset, kv_valid_len;  // window / kv_valid_len < 0: none

  __device__ __forceinline__ bool has_geo() const { return causal || window >= 0; }
  __device__ __forceinline__ bool has_data() const {
    return kv_valid_len >= 0 || kv_mask != nullptr || q_seg != nullptr;
  }
  // the class of tile (qi, ki); read before any address of the tile is formed
  __device__ __forceinline__ int block_class(int b, int qi, int ki) const {
    return layout[(long long)b * layout_b_stride + (long long)qi * nk + ki];
  }
  // which terms tile class `blk` applies; false = the tile does not run
  __device__ __forceinline__ bool tile_terms(int blk, bool& geo_on, bool& data_on) const {
    if (blk == BLOCK_SKIP) return false;
    const bool geo = has_geo(), data = has_data();
    if (!geo && !data) {            // maskless call: every non-SKIP tile unmasked
      geo_on = data_on = false;
      return true;
    }
    if (blk == BLOCK_FULL) {
      geo_on = data_on = false;
      return true;
    }
    if (blk == BLOCK_PARTIAL) {
      geo_on = geo;
      data_on = data;
      return true;
    }
    if (blk == BLOCK_PARTIAL_DATA && data) {
      geo_on = false;
      data_on = true;
      return true;
    }
    return false;                   // no branch runs (as the Pallas kernels)
  }
  // logical position and segment of buffer row `row` of sequence b
  __device__ __forceinline__ int q_position(int b, int sq, int row) const {
    return q_pos != nullptr ? q_pos[(long long)b * sq + row] : row + q_offset;
  }
  __device__ __forceinline__ int q_segment(int b, int sq, int row) const {
    return q_seg != nullptr ? q_seg[(long long)b * sq + row] : 0;
  }
  // the fused element mask for buffer column `col` (kv_row = b * sk + col)
  __device__ __forceinline__ bool element_ok(bool geo_on, bool data_on, int qpos, int qseg,
                                             long long kv_row, int col) const {
    bool ok = true;
    if (geo_on) {
      const int kp = kv_pos != nullptr ? kv_pos[kv_row] : col;
      ok = qpos >= kp;
      if (window >= 0) ok = ok && (qpos - kp < window);
    }
    if (data_on) {
      if (kv_valid_len >= 0) ok = ok && (col < kv_valid_len);
      if (kv_mask != nullptr) ok = ok && (kv_mask[kv_row] != 0);
      if (q_seg != nullptr) ok = ok && (qseg == kv_seg[kv_row]);
    }
    return ok;
  }
  // element_ok on values staged in shared memory: kpos (kv_pos or the
  // buffer column), kseg (kv_seg) and kvalid (kv_mask) of column `col`
  __device__ __forceinline__ bool element_ok_staged(bool geo_on, bool data_on, int qpos,
                                                    int qseg, int kpos, int kseg, int kvalid,
                                                    int col) const {
    bool ok = true;
    if (geo_on) {
      ok = qpos >= kpos;
      if (window >= 0) ok = ok && (qpos - kpos < window);
    }
    if (data_on) {
      if (kv_valid_len >= 0) ok = ok && (col < kv_valid_len);
      if (kv_mask != nullptr) ok = ok && (kvalid != 0);
      if (q_seg != nullptr) ok = ok && (qseg == kseg);
    }
    return ok;
  }
};

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

struct DropoutParams {
  int on;
  uint32_t seed_mix;    // mix32(seed)
  uint32_t threshold;   // uint32(int(p * (2^32 - 1))), computed by the caller
  float keep;           // 1 - p
  uint32_t num_heads, q_len, k_len;
  uint32_t b0, h0;      // this buffer's first (batch, head) in the global hash

  __device__ __forceinline__ bool keeps(int b, int h, int row, int col) const {
    uint32_t idx = (((uint32_t)b + b0) * num_heads + (uint32_t)h + h0) * q_len +
                   (uint32_t)row;
    idx = idx * k_len + (uint32_t)col;
    return mix32(idx ^ seed_mix) >= threshold;
  }
};

inline DropoutParams make_dropout(int on, unsigned seed, unsigned threshold, float keep,
                                  int num_heads, int q_len, int k_len, int b0, int h0) {
  DropoutParams d;
  d.on = on;
  d.seed_mix = mix32(seed);
  d.threshold = threshold;
  d.keep = keep;
  d.num_heads = (uint32_t)num_heads;
  d.q_len = (uint32_t)q_len;
  d.k_len = (uint32_t)k_len;
  d.b0 = (uint32_t)b0;
  d.h0 = (uint32_t)h0;
  return d;
}

// ---------------------------------------------------------------------------
// Fragment-level pieces of the bf16 tensor-core forward (flash_fwd.cu):
// asynchronous 16-byte copies, ldmatrix, mma.sync m16n8k16 (bf16 in, fp32
// accumulate) and the XOR swizzle of 16-byte chunks that keeps both
// conflict-free. For m16n8k16, lane l holds A rows l/4 and l/4 + 8, B
// column l/4, and C rows l/4 and l/4 + 8 at columns 2*(l%4) + {0, 1}.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a * b for one 16x8x16 tile
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats as one bf16x2 register, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// element offset of 16-byte chunk `chunk` of row `row` in a bf16 tile of
// D-wide rows: chunks are XORed within each 128-byte line, so 8 rows at one
// chunk (an ldmatrix phase) and 8 consecutive chunks (a copy phase) fall in
// 8 different bank groups. D = 96 (12 chunks, a row and a half of banks):
// a permutation within the row, chunks 0-7 XORed by row & 7 and chunks 8-11
// by (row >> 1) & 3, so that 8 rows at one chunk still fall in 8 bank
// groups (a row starts 4 groups after the one before it)
template <int D>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  constexpr int CPR = D / 8;  // chunks per row
  if constexpr (CPR == 12) {
    const int c = chunk < 8 ? chunk ^ (row & 7) : 8 + ((chunk - 8) ^ ((row >> 1) & 3));
    return row * D + (c << 3);
  } else if constexpr (CPR >= 8) {
    static_assert(CPR % 8 == 0, "a row of chunks that is not whole 128-byte lines");
    return row * D + ((chunk ^ (row & 7)) << 3);
  } else {
    const int lin = row * CPR + chunk;
    return ((lin & ~7) | ((lin ^ (lin >> 3)) & 7)) << 3;
  }
}

// ---------------------------------------------------------------------------
// Pieces of the split-KV decode (flash_decode.cu).
// ---------------------------------------------------------------------------

// cp_async16, but when `valid` is false the 16 destination bytes are
// zero-filled and nothing is read (src-size 0): `src` must still be an
// address the kernel may form, never a dead row's.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// wait until at most N of this thread's newest commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace flash
