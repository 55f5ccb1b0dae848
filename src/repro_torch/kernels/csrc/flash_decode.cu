// Split-KV decode (FlashDecoding-style Alg. 1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (src/repro/kernels/
// flash_decode.py l.48-99) in both of its launches:
//   * flash_decode_paged_kernel <- flash_decode_paged (pl.pallas_call at
//     l.329): one new query token per sequence against a shared page pool,
//     reading each sequence's pages through its page table;
//   * flash_decode_kernel <- flash_decode (pl.pallas_call at l.169): the
//     same against a contiguous per-sequence cache (b, hkv, capacity, D),
//     dense slot serving, with an optional per-slot kv_mask.
// Each emits one unnormalized partial softmax state (acc, m, l) per kv
// split. The merge of the partials stays a PyTorch op
// (kernels/flash_decode.py), as it is XLA-level code in the JAX package.
// The two are separate __global__s over the same helpers, so the paged
// kernel's code does not change with the contiguous one.
//
// What bounds it on an H100: decode reads every valid K/V byte of the batch
// once and does 4 d FLOPs per (head, key) pair — ~1 FLOP per byte, far
// below the ~295 FLOP/byte ridge — so it is bound by memory bytes. The
// design keeps the byte stream simple: a split walks its pages in order and
// every K/V row is read with contiguous, coalesced loads.
//
// Design:
//   * one CTA (one warp) per (b, hq, split); the CTA loops over the pages
//     of its split, reading page_table itself (the TPU's scalar prefetch).
//   * the page's layout class (masks.paged_block_layout) is read BEFORE the
//     page index: SKIP pages (past kv_len, before the window, unallocated)
//     are never addressed, so a negative table entry is never dereferenced.
//   * a page's K rows are staged in shared memory (padded by one column) so
//     each lane computes one key's dot product conflict-free; V rows are
//     read straight from global memory, coalesced across the lanes' dims.
//   * q is scaled inside the kernel in fp32 (as the Pallas decode kernel);
//     m, l and the accumulator are fp32.
//   * only PARTIAL pages apply the element mask (k_pos < kv_len, window).
//   * the contiguous kernel is the same loop over the kv blocks of its
//     split (layout from masks.kv_block_layout of masks.decode_kv_valid);
//     a block larger than MAX_TILE rows is staged in sub-tiles, and
//     PARTIAL blocks also apply kv_mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BLOCK_FULL = 1;
constexpr int BLOCK_PARTIAL = 2;
constexpr int MAX_PAGE = 64;
constexpr int MAX_TILE = 64;   // contiguous kernel: K rows staged at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct DecodeParams {
  const void* q;              // (b, hq, 1, D)
  const void* k_pool;         // (hkv, P, ps, D)
  const void* v_pool;
  const int32_t* page_table;  // (b, T)
  const int32_t* kv_len;      // (b,)
  const int32_t* layout;      // (b, T)
  float* o_p;                 // (b, hq, S, D)
  float* m_p;                 // (b, hq, S)
  float* l_p;                 // (b, hq, S)
  int b, hq, hkv, num_pages, page_size, T, num_splits, window;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(32) flash_decode_paged_kernel(const DecodeParams p) {
  constexpr int DPL = (D + 31) / 32;
  __shared__ float q_s[D];
  __shared__ float k_s[MAX_PAGE * (D + 1)];

  const int si = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x;
  const int kvh = h / (p.hq / p.hkv);
  const int ps = p.page_size;
  const int t_in = p.T / p.num_splits;
  const int kv_len = p.kv_len[b];

  const T* qg = static_cast<const T*>(p.q) + ((long long)b * p.hq + h) * D;
  for (int d = lane; d < D; d += 32) q_s[d] = to_f32(qg[d]);
  __syncwarp();

  const T* kg = static_cast<const T*>(p.k_pool);
  const T* vg = static_cast<const T*>(p.v_pool);
  float m = NEG_INF, l = 0.f, acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int t = 0; t < t_in; ++t) {
    const int tt = si * t_in + t;
    // the page's class is read before its physical index
    const int blk = p.layout[(long long)b * p.T + tt];
    if (blk != BLOCK_FULL && blk != BLOCK_PARTIAL) continue;
    const int page = p.page_table[(long long)b * p.T + tt];
    const long long base = ((long long)kvh * p.num_pages + page) * ps * D;

    __syncwarp();
    for (int i = lane; i < ps * D; i += 32) {
      const int row = i / D, col = i - row * D;
      k_s[row * (D + 1) + col] = to_f32(kg[base + i]);
    }
    __syncwarp();

    float s0 = NEG_INF, s1 = NEG_INF;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = lane + 32 * cc;
      if (c >= ps) continue;
      float dot = 0.f;
      const float* kr = k_s + c * (D + 1);
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd) dot = fmaf(q_s[dd], kr[dd], dot);
      float s = dot * p.scale;
      if (blk == BLOCK_PARTIAL) {
        // decode is the fused mask at q_pos = kv_len - 1
        const int kp = tt * ps + c;
        const int qp = kv_len - 1;
        bool ok = qp >= kp;
        if (p.window >= 0) ok = ok && (qp - kp < p.window);
        if (!ok) s = NEG_INF;
      }
      if (cc == 0) s0 = s; else s1 = s;
    }
    const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
    const float p0 = (s0 <= NEG_INF / 2) ? 0.f : expf(s0 - m_new);
    const float p1 = (s1 <= NEG_INF / 2) ? 0.f : expf(s1 - m_new);
    const float corr = (m <= NEG_INF / 2) ? 0.f : expf(m - m_new);
    l = l * corr + warp_sum(p0 + p1);
    m = m_new;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= corr;
    for (int c = 0; c < ps; ++c) {
      const float a = __shfl_sync(0xffffffffu, p0, c & 31);
      const float bb = __shfl_sync(0xffffffffu, p1, c & 31);
      const float pc = (c < 32) ? a : bb;
      const T* vr = vg + base + (long long)c * D;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc[j] = fmaf(pc, to_f32(vr[d]), acc[j]);
      }
    }
  }

  const long long out = ((long long)b * p.hq + h) * p.num_splits + si;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    if (d < D) p.o_p[out * D + d] = acc[j];
  }
  if (lane == 0) {
    p.m_p[out] = m;
    p.l_p[out] = l;
  }
}

template <typename T, int D>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  dim3 grid(p.num_splits, p.hq, p.b);
  flash_decode_paged_kernel<T, D><<<grid, 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const DecodeParams& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

struct ContigDecodeParams {
  const void* q;              // (b, hq, 1, D)
  const void* k;              // (b, hkv, capacity, D)
  const void* v;
  const int32_t* kv_len;      // (b,)
  const int32_t* layout;      // (b, capacity / block_k)
  const uint8_t* kv_mask;     // (b, capacity) or null
  float* o_p;                 // (b, hq, S, D)
  float* m_p;                 // (b, hq, S)
  float* l_p;                 // (b, hq, S)
  int b, hq, hkv, capacity, block_k, num_splits, window;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(32) flash_decode_kernel(const ContigDecodeParams p) {
  constexpr int DPL = (D + 31) / 32;
  __shared__ float q_s[D];
  __shared__ float k_s[MAX_TILE * (D + 1)];

  const int si = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x;
  const int kvh = h / (p.hq / p.hkv);
  const int bk = p.block_k;
  const int nk = p.capacity / bk;
  const int nk_in = nk / p.num_splits;
  const int kv_len = p.kv_len[b];

  const T* qg = static_cast<const T*>(p.q) + ((long long)b * p.hq + h) * D;
  for (int d = lane; d < D; d += 32) q_s[d] = to_f32(qg[d]);
  __syncwarp();

  const long long seq = ((long long)b * p.hkv + kvh) * p.capacity * D;
  const T* kg = static_cast<const T*>(p.k) + seq;
  const T* vg = static_cast<const T*>(p.v) + seq;
  const uint8_t* kvm = p.kv_mask != nullptr ? p.kv_mask + (long long)b * p.capacity : nullptr;
  float m = NEG_INF, l = 0.f, acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int t = 0; t < nk_in; ++t) {
    const int kb = si * nk_in + t;
    // the block's class is read before any of its addresses is formed
    const int blk = p.layout[(long long)b * nk + kb];
    if (blk != BLOCK_FULL && blk != BLOCK_PARTIAL) continue;
    for (int r0 = 0; r0 < bk; r0 += MAX_TILE) {
      const int rows = min(MAX_TILE, bk - r0);
      const int k0 = kb * bk + r0;        // first cache slot of the sub-tile
      const T* kt = kg + (long long)k0 * D;

      __syncwarp();
      for (int i = lane; i < rows * D; i += 32) {
        const int row = i / D, col = i - row * D;
        k_s[row * (D + 1) + col] = to_f32(kt[i]);
      }
      __syncwarp();

      float s0 = NEG_INF, s1 = NEG_INF;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = lane + 32 * cc;
        if (c >= rows) continue;
        float dot = 0.f;
        const float* kr = k_s + c * (D + 1);
#pragma unroll 16
        for (int dd = 0; dd < D; ++dd) dot = fmaf(q_s[dd], kr[dd], dot);
        float s = dot * p.scale;
        if (blk == BLOCK_PARTIAL) {
          // decode is the fused mask at q_pos = kv_len - 1, and kv_mask
          const int kp = k0 + c;
          const int qp = kv_len - 1;
          bool ok = qp >= kp;
          if (p.window >= 0) ok = ok && (qp - kp < p.window);
          if (kvm != nullptr) ok = ok && (kvm[kp] != 0);
          if (!ok) s = NEG_INF;
        }
        if (cc == 0) s0 = s; else s1 = s;
      }
      const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
      const float p0 = (s0 <= NEG_INF / 2) ? 0.f : expf(s0 - m_new);
      const float p1 = (s1 <= NEG_INF / 2) ? 0.f : expf(s1 - m_new);
      const float corr = (m <= NEG_INF / 2) ? 0.f : expf(m - m_new);
      l = l * corr + warp_sum(p0 + p1);
      m = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] *= corr;
      for (int c = 0; c < rows; ++c) {
        const float a = __shfl_sync(0xffffffffu, p0, c & 31);
        const float bb = __shfl_sync(0xffffffffu, p1, c & 31);
        const float pc = (c < 32) ? a : bb;
        const T* vr = vg + (long long)(k0 + c) * D;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[j] = fmaf(pc, to_f32(vr[d]), acc[j]);
        }
      }
    }
  }

  const long long out = ((long long)b * p.hq + h) * p.num_splits + si;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    if (d < D) p.o_p[out * D + d] = acc[j];
  }
  if (lane == 0) {
    p.m_p[out] = m;
    p.l_p[out] = l;
  }
}

template <typename T, int D>
cudaError_t launch_contig(const ContigDecodeParams& p, cudaStream_t stream) {
  dim3 grid(p.num_splits, p.hq, p.b);
  flash_decode_kernel<T, D><<<grid, 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_contig_d(const ContigDecodeParams& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch_contig<T, 16>(p, stream);
    case 32: return launch_contig<T, 32>(p, stream);
    case 64: return launch_contig<T, 64>(p, stream);
    case 128: return launch_contig<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int flash_decode_paged(int dtype, int head_dim,
                       const void* q, const void* k_pool, const void* v_pool,
                       const int32_t* page_table, const int32_t* kv_len,
                       const int32_t* layout,
                       float* o_p, float* m_p, float* l_p,
                       int b, int hq, int hkv, int num_pages, int page_size,
                       int T, int num_splits, int window, float scale,
                       void* stream) {
  if (page_size <= 0 || page_size > MAX_PAGE || num_splits <= 0 || T % num_splits) {
    return (int)cudaErrorInvalidValue;
  }
  DecodeParams p;
  p.q = q; p.k_pool = k_pool; p.v_pool = v_pool;
  p.page_table = page_table; p.kv_len = kv_len; p.layout = layout;
  p.o_p = o_p; p.m_p = m_p; p.l_p = l_p;
  p.b = b; p.hq = hq; p.hkv = hkv; p.num_pages = num_pages;
  p.page_size = page_size; p.T = T; p.num_splits = num_splits;
  p.window = window; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(p, head_dim, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(p, head_dim, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The contiguous-cache kernel; same conventions. kv_mask may be null.
int flash_decode(int dtype, int head_dim,
                 const void* q, const void* k, const void* v,
                 const int32_t* kv_len, const int32_t* layout, const uint8_t* kv_mask,
                 float* o_p, float* m_p, float* l_p,
                 int b, int hq, int hkv, int capacity, int block_k, int num_splits,
                 int window, float scale, void* stream) {
  if (block_k <= 0 || num_splits <= 0 || hkv <= 0 || hq % hkv || capacity % block_k ||
      (capacity / block_k) % num_splits) {
    return (int)cudaErrorInvalidValue;
  }
  ContigDecodeParams p;
  p.q = q; p.k = k; p.v = v;
  p.kv_len = kv_len; p.layout = layout; p.kv_mask = kv_mask;
  p.o_p = o_p; p.m_p = m_p; p.l_p = l_p;
  p.b = b; p.hq = hq; p.hkv = hkv; p.capacity = capacity; p.block_k = block_k;
  p.num_splits = num_splits; p.window = window; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_contig_d<float>(p, head_dim, s);
  } else if (dtype == 1) {
    err = dispatch_contig_d<__nv_bfloat16>(p, head_dim, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
