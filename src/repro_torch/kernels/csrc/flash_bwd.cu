// FlashAttention backward (paper Alg. 4, split into a dq and a dkv kernel)
// for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/flash_attention.py:flash_attention_backward:
//   * flash_bwd_dq_kernel  <- `_dq_kernel` (l.382-429, pl.pallas_call at l.581)
//   * flash_bwd_dkv_kernel <- `_dkv_kernel` (l.436-495, pl.pallas_call at
//     l.612) together with the GQA group sum outside it (l.631-636).
// and, with `Paged=true`, those of flash_prefill_paged_backward (l.778),
// the backward of the paged prefill (flash_fwd.cu with Paged=true):
//   * flash_bwd_dq_kernel<.., true>  <- the paged dq (pl.pallas_call at
//     l.851): kv tiles are pool pages read through page_list[b, t];
//   * flash_bwd_dkv_kernel<.., true> <- the paged dkv (pl.pallas_call at
//     l.897) with its GQA sum (l.918-920): one CTA per (b, hkv, page slot),
//     writing fp32 rows of the PACKED page-aligned (b, hkv, T*ps, D)
//     layout; the fold into pool shape (dead slots dropped, pages shared
//     across rows summed in a fixed order) is a PyTorch op
//     (kernels/flash_attention.py), as it is XLA-level code in the JAX
//     package.
// Only where a kv tile comes from changes with `Paged` (the tile is one
// page of ps rows), exactly as in flash_fwd.cu; the contiguous
// instantiations compile the same code as without it.
// Both recompute P = diag(l)^-1 exp(S - m) from the pre-scaled q' = scale*q,
// k and the forward's (m, l) (`_recompute_p`: rows with l = 0 use m = 0,
// l = 1 and contribute nothing), regenerate the dropout keep mask from the
// hash (flash_common.cuh) and consume the SAME compiled block layout as the
// forward. D = rowsum(dO o O) is computed by the caller (as the JAX package
// does at the XLA level).
//
//   dq kernel : dP = dO V^T (o Z), dS = P o (dP - D), dq += dS K, and
//               dq = scale * dq once at the end.
//   dkv kernel: dV += (P o Z)^T dO, dK += dS^T q'.
//
// What bounds it on an H100: at the training shape (q (4, 32, 2048, 64),
// k/v (4, 8, 2048, 64), bf16, causal, packed documents of mean length 512,
// ~1.4e8 unmasked (q, k) pairs over all heads) the minimal backward does
// five products of 2*d FLOPs per unmasked pair (S, dP, dV, dK, dq: 10*d),
// ~90 GFLOP, ~0.09 ms at the 989 TFLOP/s bf16 peak, against ~150 MB of
// q, k, v, dO, m, l, D read once and dq, dk, dv written once, ~0.045 ms at
// 3.35 TB/s: the pair is bound by operations. Of the two kernels, dkv
// carries four of the five products (bound by operations) and dq one
// (bound by its bytes). Splitting into two kernels recomputes S and dP in
// both (7 products in all instead of 5); the bound counts only the five.
// The paged pair at the serving chunk shape (192 + 64 q rows against
// 1536 / 600-token paged prefixes) has ~14x fewer unmasked pairs and is
// bound by bytes: the q, dO and live K/V pages in, dq and the pool-shaped
// dk, dv out.
// This first version computes in scalar fp32 FMA from shared memory, far
// below the tensor-core peak; mma/wgmma, TMA and pipelining are work for a
// later change.
//
// Design, and what it does about the TPU -> Hopper differences:
//   * the TPU carries dq (and dk, dv) in VMEM scratch across a sequential
//     grid axis. Here a CTA loops itself: the dq kernel owns one
//     (b, hq, q-block) and walks the kv tiles of its layout row; the dkv
//     kernel owns one (b, hkv, kv-block) and walks the n_rep query heads of
//     its group and the q tiles of its layout COLUMN. The accumulators stay
//     in fp32 registers for the whole loop.
//   * the dkv kernel sums the GQA group in registers and writes dk, dv once
//     in k's dtype: no (b, hq, sk, d) fp32 partial buffer, no atomics, and
//     the result does not depend on scheduling order (deterministic).
//   * a tile's class is read before any of its addresses is formed; SKIP
//     tiles are never read; PARTIAL tiles apply the fused element mask,
//     PARTIAL_DATA tiles its data terms, FULL tiles none (flash_common.cuh).
//     The paged dkv kernel scans its slot's layout column before it reads
//     the slot's page index: a dead slot (negative entry, SKIP in every
//     row) is never addressed and writes zeros.
//   * dq kernel: 8 warps x 8 q rows, a lane owns 2 kv columns of S/dP and
//     ceil(D/32) dims of dq. dkv kernel: 8 warps x 8 kv rows, a lane owns 2
//     q rows of S/dP and ceil(D/32) dims of dk and dv. Tiles are staged in
//     shared memory as fp32, rows padded by one column where a lane walks
//     a row (bank-conflict-free dot products).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int ROWS = MAX_BQ / NUM_WARPS;   // dq kernel: q rows per warp
constexpr int COLS = MAX_BK / 32;          // dq kernel: kv columns per lane
constexpr int KROWS = MAX_BK / NUM_WARPS;  // dkv kernel: kv rows per warp
constexpr int QCOLS = MAX_BQ / 32;         // dkv kernel: q rows per lane

struct BwdParams {
  const void* q;     // (b, hq, sq, D), pre-scaled by the caller
  const void* k;     // (b, hkv, sk, D)
  const void* v;
  const void* dout;  // (b, hq, sq, D)
  const float* m;    // (b, hq, sq)
  const float* l;
  const float* dd;   // D = rowsum(dO o O), (b, hq, sq)
  void* out0;        // dq (b, hq, sq, D) | dk (b, hkv, sk, D)
  void* out1;        // unused            | dv (b, hkv, sk, D)
  MaskParams mask;
  DropoutParams drop;
  int b, hq, hkv, sq, sk, nq, nk, block_q, block_k;
  float scale;
  const int32_t* page_list;  // paged: (b, nk) physical pages; K/V (hkv, P, ps, D)
  int num_pages;
};

// dkv output type: k's dtype, or fp32 packed rows for the paged kernel
template <typename T, bool Paged> struct DkvOut { using type = T; };
template <typename T> struct DkvOut<T, true> { using type = float; };

// P for one (row, col) from the saved statistics (`_recompute_p`)
__device__ __forceinline__ float recompute_p(float s, bool ok, float m_safe, float l_safe) {
  return (!ok || s <= NEG_INF / 2) ? 0.f : expf(s - m_safe) / l_safe;
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int dd = 0; dd < D; ++dd) acc = fmaf(a[dd], b[dd], acc);
  return acc;
}

// ---------------------------------------------------------------------------
// dq: one CTA per (q-block, hq, b)
// ---------------------------------------------------------------------------
template <typename T, int D, bool Paged>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int DPL = (D + 31) / 32;
  constexpr int LD = D + 1;                 // padded row stride
  extern __shared__ float smem[];
  const int bq = p.block_q, bk = p.block_k;
  float* q_s = smem;                        // bq x D
  float* do_s = q_s + bq * D;               // bq x D
  float* k_s = do_s + bq * D;               // bk x LD
  float* v_s = k_s + bk * LD;               // bk x LD
  float* ds_s = v_s + bk * LD;              // bq x bk

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const MaskParams mp = p.mask;             // by value: see flash_common.cuh
  const DropoutParams drop = p.drop;

  const long long q_row0 = ((long long)b * p.hq + h) * p.sq + (long long)qi * bq;
  const T* qg = static_cast<const T*>(p.q) + q_row0 * D;
  const T* dog = static_cast<const T*>(p.dout) + q_row0 * D;
  for (int i = tid; i < bq * D; i += THREADS) {
    q_s[i] = to_f32(qg[i]);
    do_s[i] = to_f32(dog[i]);
  }

  float acc[ROWS][DPL], msafe_r[ROWS], lsafe_r[ROWS], dd_r[ROWS];
  int qpos_r[ROWS], qseg_r[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
    const int r = warp * ROWS + i;
    const int rr = r < bq ? r : 0;
    const float l = p.l[q_row0 + rr];
    msafe_r[i] = (l == 0.f) ? 0.f : p.m[q_row0 + rr];
    lsafe_r[i] = (l == 0.f) ? 1.f : l;
    dd_r[i] = p.dd[q_row0 + rr];
    qpos_r[i] = mp.q_position(b, p.sq, qi * bq + rr);
    qseg_r[i] = mp.q_segment(b, p.sq, qi * bq + rr);
  }

  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  for (int ki = 0; ki < p.nk; ++ki) {
    bool geo_on, data_on;
    if (!mp.tile_terms(mp.block_class(b, qi, ki), geo_on, data_on)) continue;
    long long kv_off;
    if (Paged) {
      const int page = p.page_list[(long long)b * p.nk + ki];
      kv_off = ((long long)kvh * p.num_pages + page) * bk * D;
    } else {
      kv_off = (((long long)b * p.hkv + kvh) * p.sk + (long long)ki * bk) * D;
    }
    __syncthreads();                        // previous tile fully consumed
    for (int i = tid; i < bk * D; i += THREADS) {
      const int row = i / D, col = i - row * D;
      k_s[row * LD + col] = to_f32(kg[kv_off + i]);
      v_s[row * LD + col] = to_f32(vg[kv_off + i]);
    }
    __syncthreads();

    const long long kv_row0 = (long long)b * p.sk + (long long)ki * bk;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i;
      if (r >= bq) break;                   // warp-uniform
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
        const int c = lane + 32 * cc;
        if (c >= bk) continue;
        const float s = dot_rows<D>(q_s + r * D, k_s + c * LD);
        const bool ok = mp.element_ok(geo_on, data_on, qpos_r[i], qseg_r[i], kv_row0 + c,
                                      ki * bk + c);
        const float pv = recompute_p(s, ok, msafe_r[i], lsafe_r[i]);
        float dp = dot_rows<D>(do_s + r * D, v_s + c * LD);
        if (drop.on) {
          dp = drop.keeps(b, h, qi * bq + r, ki * bk + c) ? dp / drop.keep : 0.f;
        }
        ds_s[r * bk + c] = pv * (dp - dd_r[i]);
      }
    }
    __syncwarp();                           // this warp's dS rows are visible
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i;
      if (r >= bq) break;
      const float* dsr = ds_s + r * bk;
      for (int c = 0; c < bk; ++c) {
        const float dsc = dsr[c];
        const float* kr = k_s + c * LD;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[i][j] = fmaf(dsc, kr[d], acc[i][j]);
        }
      }
    }
  }

  // chain rule for the folded scale: one multiply at the end
  T* dqg = static_cast<T*>(p.out0) + q_row0 * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp * ROWS + i;
    if (r >= bq) break;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store_out(dqg + (long long)r * D + d, p.scale * acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dkv: one CTA per (kv-block, hkv, b), looping over the group's q heads
// ---------------------------------------------------------------------------
template <typename T, int D, bool Paged>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int DPL = (D + 31) / 32;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  const int bq = p.block_q, bk = p.block_k;
  float* k_s = smem;                        // bk x LD
  float* v_s = k_s + bk * LD;               // bk x LD
  float* q_s = v_s + bk * LD;               // bq x LD
  float* do_s = q_s + bq * LD;              // bq x LD
  float* pd_s = do_s + bq * LD;             // bk x bq: (P o Z)^T
  float* ds_s = pd_s + bk * bq;             // bk x bq: dS^T
  float* msafe_s = ds_s + bk * bq;          // bq
  float* lsafe_s = msafe_s + bq;            // bq
  float* dd_s = lsafe_s + bq;               // bq
  int* qpos_s = reinterpret_cast<int*>(dd_s + bq);  // bq
  int* qseg_s = qpos_s + bq;                         // bq

  const int ki = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rep = p.hq / p.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const MaskParams mp = p.mask;             // by value: see flash_common.cuh
  const DropoutParams drop = p.drop;

  // the output rows (paged: the slot's rows of the packed layout, sk = T*ps)
  const long long kv_off = (((long long)b * p.hkv + kvh) * p.sk + (long long)ki * bk) * D;
  long long kv_in = kv_off;
  bool live = true;
  if (Paged) {
    // the slot's column is read before its page index
    live = false;
    for (int qi = 0; qi < p.nq && !live; ++qi) live = mp.block_class(b, qi, ki) != BLOCK_SKIP;
    if (live) kv_in = ((long long)kvh * p.num_pages + p.page_list[(long long)b * p.nk + ki]) * bk * D;
  }
  if (live) {
    const T* kg = static_cast<const T*>(p.k) + kv_in;
    const T* vg = static_cast<const T*>(p.v) + kv_in;
    for (int i = tid; i < bk * D; i += THREADS) {
      const int row = i / D, col = i - row * D;
      k_s[row * LD + col] = to_f32(kg[i]);
      v_s[row * LD + col] = to_f32(vg[i]);
    }
  }

  float dk[KROWS][DPL], dv[KROWS][DPL];
#pragma unroll
  for (int i = 0; i < KROWS; ++i) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  const long long kv_row0 = (long long)b * p.sk + (long long)ki * bk;
  const T* qg_all = static_cast<const T*>(p.q);
  const T* dog_all = static_cast<const T*>(p.dout);
  for (int qi = 0; qi < p.nq; ++qi) {
    // the layout is indexed (qi, ki): this walk reads column ki
    bool geo_on, data_on;
    if (!mp.tile_terms(mp.block_class(b, qi, ki), geo_on, data_on)) continue;
    for (int hr = 0; hr < n_rep; ++hr) {
      const int h = kvh * n_rep + hr;
      const long long q_row0 = ((long long)b * p.hq + h) * p.sq + (long long)qi * bq;
      __syncthreads();                      // previous tile fully consumed
      const T* qg = qg_all + q_row0 * D;
      const T* dog = dog_all + q_row0 * D;
      for (int i = tid; i < bq * D; i += THREADS) {
        const int row = i / D, col = i - row * D;
        q_s[row * LD + col] = to_f32(qg[i]);
        do_s[row * LD + col] = to_f32(dog[i]);
      }
      for (int r = tid; r < bq; r += THREADS) {
        const float l = p.l[q_row0 + r];
        msafe_s[r] = (l == 0.f) ? 0.f : p.m[q_row0 + r];
        lsafe_s[r] = (l == 0.f) ? 1.f : l;
        dd_s[r] = p.dd[q_row0 + r];
        qpos_s[r] = mp.q_position(b, p.sq, qi * bq + r);
        qseg_s[r] = mp.q_segment(b, p.sq, qi * bq + r);
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < KROWS; ++i) {
        const int c = warp * KROWS + i;
        if (c >= bk) break;                 // warp-uniform
#pragma unroll
        for (int rr = 0; rr < QCOLS; ++rr) {
          const int r = lane + 32 * rr;
          if (r >= bq) continue;
          const float s = dot_rows<D>(q_s + r * LD, k_s + c * LD);
          const bool ok = mp.element_ok(geo_on, data_on, qpos_s[r], qseg_s[r], kv_row0 + c,
                                        ki * bk + c);
          const float pv = recompute_p(s, ok, msafe_s[r], lsafe_s[r]);
          float dp = dot_rows<D>(do_s + r * LD, v_s + c * LD);
          float z = 1.f;
          if (drop.on) {
            z = drop.keeps(b, h, qi * bq + r, ki * bk + c) ? 1.f / drop.keep : 0.f;
            dp *= z;
          }
          pd_s[c * bq + r] = pv * z;
          ds_s[c * bq + r] = pv * (dp - dd_s[r]);
        }
      }
      __syncwarp();                         // this warp's P/dS rows are visible
#pragma unroll
      for (int i = 0; i < KROWS; ++i) {
        const int c = warp * KROWS + i;
        if (c >= bk) break;
        const float* pdr = pd_s + c * bq;
        const float* dsr = ds_s + c * bq;
        for (int r = 0; r < bq; ++r) {
          const float pdv = pdr[r], dsv = dsr[r];
          const float* dor = do_s + r * LD;
          const float* qr = q_s + r * LD;
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            const int d = lane + 32 * j;
            if (d < D) {
              dv[i][j] = fmaf(pdv, dor[d], dv[i][j]);
              dk[i][j] = fmaf(dsv, qr[d], dk[i][j]);
            }
          }
        }
      }
    }
  }

  using OutT = typename DkvOut<T, Paged>::type;
  OutT* dkg = static_cast<OutT*>(p.out0) + kv_off;
  OutT* dvg = static_cast<OutT*>(p.out1) + kv_off;
#pragma unroll
  for (int i = 0; i < KROWS; ++i) {
    const int c = warp * KROWS + i;
    if (c >= bk) break;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        store_out(dkg + (long long)c * D + d, dk[i][j]);
        store_out(dvg + (long long)c * D + d, dv[i][j]);
      }
    }
  }
}

template <int D>
size_t dq_smem(const BwdParams& p) {
  return sizeof(float) * (2 * (size_t)p.block_q * D + 2 * (size_t)p.block_k * (D + 1) +
                          (size_t)p.block_q * p.block_k);
}

template <int D>
size_t dkv_smem(const BwdParams& p) {
  return sizeof(float) * ((size_t)(2 * p.block_k + 2 * p.block_q) * (D + 1) +
                          2 * (size_t)p.block_k * p.block_q + 5 * (size_t)p.block_q);
}

template <typename K>
cudaError_t launch_kernel(K kern, dim3 grid, size_t smem, const BwdParams& p,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool Paged>
cudaError_t launch(int which, const BwdParams& p, cudaStream_t stream) {
  if (which == 0) {
    return launch_kernel(flash_bwd_dq_kernel<T, D, Paged>, dim3(p.nq, p.hq, p.b),
                         dq_smem<D>(p), p, stream);
  }
  return launch_kernel(flash_bwd_dkv_kernel<T, D, Paged>, dim3(p.nk, p.hkv, p.b),
                       dkv_smem<D>(p), p, stream);
}

template <typename T, bool Paged>
cudaError_t dispatch_d(int which, const BwdParams& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16, Paged>(which, p, stream);
    case 32: return launch<T, 32, Paged>(which, p, stream);
    case 64: return launch<T, 64, Paged>(which, p, stream);
    case 128: return launch<T, 128, Paged>(which, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_paged(int which, bool paged, const BwdParams& p, int head_dim,
                           cudaStream_t stream) {
  return paged ? dispatch_d<T, true>(which, p, head_dim, stream)
               : dispatch_d<T, false>(which, p, head_dim, stream);
}

int run(int which, int dtype, int head_dim,
        const void* q, const void* k, const void* v, const void* dout,
        const float* m, const float* l, const float* dd, void* out0, void* out1,
        const int32_t* layout, long long layout_b_stride,
        const uint8_t* kv_mask, const int32_t* q_seg, const int32_t* kv_seg,
        const int32_t* q_pos, const int32_t* kv_pos,
        int b, int hq, int hkv, int sq, int sk, int nq, int nk, int block_q, int block_k,
        int causal, int window, int q_offset, int kv_valid_len,
        int dropout_on, unsigned dropout_seed, unsigned dropout_threshold,
        float dropout_keep, int dropout_q_len, int dropout_k_len,
        float scale, void* stream, const int32_t* page_list, int num_pages) {
  const bool paged = page_list != nullptr;
  if (block_q <= 0 || block_q > MAX_BQ || block_k <= 0 || block_k > MAX_BK || hkv <= 0 ||
      hq % hkv != 0 || (paged && dropout_on)) {
    return (int)cudaErrorInvalidValue;
  }
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.m = m; p.l = l; p.dd = dd;
  p.out0 = out0; p.out1 = out1;
  p.mask.layout = layout; p.mask.layout_b_stride = layout_b_stride;
  p.mask.kv_mask = kv_mask; p.mask.q_seg = q_seg; p.mask.kv_seg = kv_seg;
  p.mask.q_pos = q_pos; p.mask.kv_pos = kv_pos;
  p.mask.nq = nq; p.mask.nk = nk;
  p.mask.causal = causal; p.mask.window = window; p.mask.q_offset = q_offset;
  p.mask.kv_valid_len = kv_valid_len;
  p.drop = make_dropout(dropout_on, dropout_seed, dropout_threshold, dropout_keep, hq,
                        dropout_q_len, dropout_k_len);
  p.b = b; p.hq = hq; p.hkv = hkv; p.sq = sq; p.sk = sk; p.nq = nq; p.nk = nk;
  p.block_q = block_q; p.block_k = block_k; p.scale = scale;
  p.page_list = page_list; p.num_pages = num_pages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_paged<float>(which, paged, p, head_dim, s);
  } else if (dtype == 1) {
    err = dispatch_paged<__nv_bfloat16>(which, paged, p, head_dim, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q is pre-scaled (q' = scale * q).
// flash_bwd_dq writes dq into out0 (out1 unused); flash_bwd_dkv writes the
// group-summed dk, dv into out0, out1. Returns a cudaError_t (0 = launched).
// The _paged entry points take k, v as pools (hkv, num_pages, ps, D), the
// kv tile = one page (block_k = ps, sk = nk * ps), the page list (b, nk)
// and no dropout; flash_bwd_dkv_paged writes fp32 packed (b, hkv, sk, D).
#define FLASH_BWD_ARGS                                                                    \
  int dtype, int head_dim, const void *q, const void *k, const void *v, const void *dout, \
      const float *m, const float *l, const float *dd, void *out0, void *out1,            \
      const int32_t *layout, long long layout_b_stride, const uint8_t *kv_mask,           \
      const int32_t *q_seg, const int32_t *kv_seg, const int32_t *q_pos,                  \
      const int32_t *kv_pos, int b, int hq, int hkv, int sq, int sk, int nq, int nk,      \
      int block_q, int block_k, int causal, int window, int q_offset, int kv_valid_len,   \
      int dropout_on, unsigned dropout_seed, unsigned dropout_threshold,                  \
      float dropout_keep, int dropout_q_len, int dropout_k_len, float scale, void *stream
#define FLASH_BWD_PASS                                                                     \
  dtype, head_dim, q, k, v, dout, m, l, dd, out0, out1, layout, layout_b_stride, kv_mask,  \
      q_seg, kv_seg, q_pos, kv_pos, b, hq, hkv, sq, sk, nq, nk, block_q, block_k, causal,  \
      window, q_offset, kv_valid_len, dropout_on, dropout_seed, dropout_threshold,         \
      dropout_keep, dropout_q_len, dropout_k_len, scale, stream

int flash_bwd_dq(FLASH_BWD_ARGS) { return run(0, FLASH_BWD_PASS, nullptr, 0); }

int flash_bwd_dkv(FLASH_BWD_ARGS) { return run(1, FLASH_BWD_PASS, nullptr, 0); }

int flash_bwd_dq_paged(FLASH_BWD_ARGS, const int32_t* page_list, int num_pages) {
  if (page_list == nullptr) return (int)cudaErrorInvalidValue;
  return run(0, FLASH_BWD_PASS, page_list, num_pages);
}

int flash_bwd_dkv_paged(FLASH_BWD_ARGS, const int32_t* page_list, int num_pages) {
  if (page_list == nullptr) return (int)cudaErrorInvalidValue;
  return run(1, FLASH_BWD_PASS, page_list, num_pages);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
