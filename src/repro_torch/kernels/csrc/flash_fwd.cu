// FlashAttention forward (paper Alg. 1; FA-2 or "paper" accumulator, optional
// attention dropout) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` as launched by
//   * src/repro/kernels/flash_attention.py:flash_attention_forward
//     (pl.pallas_call at l.325; contiguous K/V), and
//   * src/repro/kernels/flash_attention.py:flash_prefill_paged_forward
//     (pl.pallas_call at l.765; K/V tiles read from page-pool pages).
// One template, `Paged`, covers both: only the address of a kv tile changes
// (contiguous stride vs. page_list[b, t]).
//
// What bounds it on an H100: at the serving shapes (packed prefill of ~2k
// tokens, d = 64, GQA 32/8) attention does ~4 d FLOPs per unmasked (q, k)
// pair against ~2 d bytes per K/V row read once, i.e. it is bound by
// operations, not bytes. This first version computes in scalar fp32 FMA
// from shared memory (no tensor cores), so it runs far below the bf16
// tensor-core peak; wgmma + TMA are work for a later change.
//
// Design, and what it does about the TPU -> Hopper differences:
//   * one CTA per (b, hq, q-block); the kv loop runs INSIDE the CTA (the
//     TPU's sequential kv grid axis has no Hopper counterpart). The
//     online-softmax state m, l and the accumulator stay in registers in
//     fp32 for the whole loop; S and P never leave the SM.
//   * the CTA reads the compiled block-layout class of a tile BEFORE it
//     forms any address: SKIP tiles (causal/window geometry, cross-document
//     tiles, dead pages) are never read, so a dead page's index is never
//     dereferenced.
//   * K/V tiles are staged in shared memory (fp32; K padded by one column
//     so the per-lane row dot products are bank-conflict free).
//   * the fused element mask (core/masks.element_mask) is applied only on
//     PARTIAL tiles (all terms) and PARTIAL_DATA tiles (data terms only);
//     FULL tiles run unmasked.
//   * 8 warps, each owning 8 q rows; a lane owns 2 kv columns of S and
//     ceil(D/32) output dims. q is pre-scaled by the caller, exactly as
//     the Pallas wrapper does.
//   * outputs o (input dtype), m and l (fp32) exactly as the Pallas kernel:
//     rows with no unmasked key give o = 0, l = 0, m = NEG_INF. m and l are
//     those of the UNDROPPED P (the backward recomputes P from them).
//   * variant "paper" (Alg. 1 line 12) renormalizes the accumulator at every
//     tile: acc = (acc * l_prev * corr + P~V) / l_new; "fa2" keeps it
//     unnormalized and divides once at the end.
//   * dropout (contiguous K/V only, as in the JAX package) multiplies P by
//     the hash keep mask of flash_common.cuh / (1 - p) before P.V, over the
//     buffer coordinates (b, h, qi*bq + r, ki*bk + c).
// The layout read, the element mask and the hash live in flash_common.cuh,
// shared with the backward kernels (flash_bwd.cu).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int ROWS = MAX_BQ / NUM_WARPS;   // q rows per warp
constexpr int COLS = MAX_BK / 32;          // kv columns per lane

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

// Dropout and Paper are compile-time, so the serving instantiations (no
// dropout, fa2) carry none of the training variants' code or registers.
template <typename T, int D, bool Paged, bool Dropout, bool Paper>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const FwdParams p) {
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

template <typename T, int D, bool Paged, bool Dropout, bool Paper>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)p.block_q * D + (size_t)p.block_k * (D + 1) +
                                       (size_t)p.block_k * D + (size_t)p.block_q * p.block_k);
  auto kern = flash_fwd_kernel<T, D, Paged, Dropout, Paper>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.nq, p.hq, p.b);
  kern<<<grid, THREADS, smem, stream>>>(p);
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
              void* stream) {
  if (block_q <= 0 || block_q > MAX_BQ || block_k <= 0 || block_k > MAX_BK ||
      (paged && dropout_on)) {
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
  p.drop = make_dropout(dropout_on, dropout_seed, dropout_threshold, dropout_keep, hq,
                        dropout_q_len, dropout_k_len);
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
