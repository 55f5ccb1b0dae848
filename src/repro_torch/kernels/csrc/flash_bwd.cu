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
//     l.897) with its GQA sum (l.918-920): one CTA per (b, hkv, page slot)
//     in the scalar body, per 64-key group of slots in the bf16 one,
//     writing fp32 rows of the PACKED page-aligned (b, hkv, T*ps, D)
//     layout;
//   * flash_bwd_fold_kernel <- the XLA scatter-add that folds those rows
//     into pool shape (l.924-933): dead slots dropped, a page shared by
//     several slots summed in (b, t) order, no host sync (the order is a
//     device sort by the caller).
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
// dk, dv out. In practice both pairs are held far above these bounds by
// their per-tile element work (the mask, P from (m, l), the dropout hash,
// the bf16 packing) between the mma.sync products, and dkv also by the
// imbalance of its layout columns (a CTA walks every q-block that runs in
// its column, times n_rep heads).
//
// Which body runs: every bf16 instantiation, paged or contiguous, runs the
// tensor-core body (dq_mma, dkv_mma, below): mma.sync m16n8k16 with
// ldmatrix from swizzled bf16 tiles and cp.async double buffering, as
// flash_fwd.cu's fwd_mma. The fp32 instantiations run the first version's
// scalar fp32 FMA body from shared memory (dq_scalar, dkv_scalar): it is
// the card's parity mode (fp32 train on cuda against cpu within 1e-4),
// which tensor cores would break. What differs between paged and
// contiguous K/V is `if constexpr` on `Paged`:
//   * a paged kv tile is 64 keys gathered from 64 / ps pages (ps 8, 16,
//     32 or 64), whose classes and pages are read first, dead slots and
//     SKIP pages zero-filled and never addressed; a contiguous kv tile is
//     the layout's own block of block_k <= 64 keys, its class read from
//     the layout, rows past block_k (to a multiple of 16) zero with P = 0
//     (selects, never a multiply by stale shared memory);
//   * dropout exists only on contiguous K/V (as in the JAX package), as a
//     template parameter: the instantiations without it carry none of the
//     hash's code or registers;
//   * the paged dkv writes fp32 packed rows for the fold; the contiguous
//     dkv writes dk, dv once in k's dtype.
//
// Design of the tensor-core pair:
//   * dq: one CTA per (b, hq, q-block). Paged: 3 groups of 4 warps (2 above
//     d = 64) take every third live 64-key tile and merge their fp32 dq
//     partials in group order at the end (192 CTAs on 132 SMs at the
//     serving shape, each walking a whole prefix). Contiguous: one group
//     (4096 CTAs at the training shape fill the card). Warp w of a group
//     owns q rows 16w..16w+15; per 16 keys S = Q'K^T and dP = dO V^T (Q'
//     and, below d = 64 or in a contiguous CTA at d = 64, dO A fragments
//     held in registers), P from (m, l), dS = P o (dP o Z - D) rounded to
//     bf16 as the A operand of dq += dS K.
//   * dkv: one CTA per (b, hkv, kv-block): a 64-key page group, or the
//     layout's block_k keys. 4 warps x 16 kv rows; it walks the q-blocks
//     of its layout column that run and the n_rep heads of its group, Q'
//     and dO staged once per (q-block, head) and double-buffered. Per 16 q
//     rows S^T = K Q'^T and dP^T = V dO^T; P^T and dS^T go from C to A
//     fragments in registers (FlashAttention-2's layout trick) for
//     dV += (P o Z)^T dO and dK += dS^T Q'. A C fragment's row is a kv row
//     and its column a q row, so the dropout hash is evaluated at
//     (q row, kv column) = (qi*bq + column, ki*bk + row); the kept P
//     enters dV unscaled and dV takes 1 / (1 - p) once in fp32 at the end,
//     while dS uses the undropped P against dP o Z. q rows past block_q
//     (to a multiple of 16) are zero with P = 0.
//   * launch order, contiguous: the CTAs' walks are uneven (at the training
//     shape a dkv CTA walks 39 (q-block, head) items on average and up to
//     108; a dq CTA 9.7 kv tiles, up to 27), and the card starts CTAs in
//     grid order. The grid puts the block index outermost, longest walks
//     first in a causal layout: dkv kv-block 0 up (a column shortens as ki
//     grows), dq q-block nq - 1 down (a row lengthens as qi grows), so the
//     short walks fill the tail instead of the long ones. The paged grids
//     keep the block index innermost.
//   * the column scan of the scalar dkv becomes a parallel fill of the
//     layout classes (one q-block per thread, OR-reduced per warp).
//   * deterministic: no atomics; the group merge, the GQA sum and the fold
//     each add in a fixed order, so two calls are bit-identical.
//
// Design of both bodies, and what it does about the TPU -> Hopper differences:
//   * the TPU carries dq (and dk, dv) in VMEM scratch across a sequential
//     grid axis. Here a CTA loops itself: the dq kernel owns one
//     (b, hq, q-block) and walks the kv tiles of its layout row; the dkv
//     kernel owns one (b, hkv, kv-block) and walks the n_rep query heads of
//     its group and the q tiles of its layout COLUMN. The accumulators stay
//     in fp32 registers for the whole loop.
//   * the dkv kernel sums the GQA group in registers and writes dk, dv once:
//     no (b, hq, sk, d) fp32 partial buffer, no atomics, and the result
//     does not depend on scheduling order (deterministic).
//   * a tile's class is read before any of its addresses is formed; SKIP
//     tiles are never read; PARTIAL tiles apply the fused element mask,
//     PARTIAL_DATA tiles its data terms, FULL tiles none (flash_common.cuh).
//     The paged dkv kernel reads its slots' layout column before it reads
//     their page indices: a dead slot (negative entry, SKIP in every row)
//     is never addressed and writes zeros.
//   * scalar dq kernel: 8 warps x 8 q rows, a lane owns 2 kv columns of S/dP and
//     ceil(D/32) dims of dq. Scalar dkv kernel: 8 warps x 8 kv rows, a lane owns 2
//     q rows of S/dP and ceil(D/32) dims of dk and dv. Tiles are staged in
//     shared memory as fp32, rows padded by one column where a lane walks
//     a row (bank-conflict-free dot products).

#include <type_traits>

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
// scalar body (fp32, the card's parity mode): dq, one CTA per (q-block, hq, b)
// ---------------------------------------------------------------------------
template <typename T, int D, bool Paged>
__device__ __forceinline__ void dq_scalar(const BwdParams& p) {
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
// scalar body: dkv, one CTA per (kv-block, hkv, b), looping over the group's q heads
// ---------------------------------------------------------------------------
template <typename T, int D, bool Paged>
__device__ __forceinline__ void dkv_scalar(const BwdParams& p) {
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

  T* dkg = static_cast<T*>(p.out0) + kv_off;  // fp32 (paged: packed rows)
  T* dvg = static_cast<T*>(p.out1) + kv_off;
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

// ---------------------------------------------------------------------------
// bf16: tensor-core bodies, paged and contiguous K/V
// ---------------------------------------------------------------------------

constexpr int ROW_WARPS = 4;                  // warps of one group: 16 rows each
constexpr int GROUP_THREADS = ROW_WARPS * 32;
constexpr int KV_TILE = MAX_BK;               // keys of one kv tile (64 // ps pages)
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)

// P = exp2(s * log2(e) - lse) with lse = m * log2(e) + log2(l): the
// `_recompute_p` rule (a row with l = 0 uses m = 0, l = 1) with the division
// by l folded into the exponent (l >= 1 wherever it is not 0)
__device__ __forceinline__ float log2_lse(float m, float l) {
  return l == 0.f ? 0.f : fmaf(m, LOG2E, __log2f(l));
}

// cp.async groups still in flight may be the most recent one only
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Warp groups that split one dq CTA's kv walk, as the forward's kSplit:
// the paged dq runs few CTAs (2 * 3 * 32 = 192 on 132 SMs at the serving
// shape), each walking a whole prefix, so it splits the walk over 3 groups
// (2 above d = 64, for registers); the contiguous dq fills the card with
// CTAs (4096 at the training shape) and keeps one group.
template <int D, bool Paged>
constexpr int kDqSplit = Paged ? (D <= 64 ? 3 : 2) : 1;

template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
template <typename T, int D, bool Paged>
constexpr int kDqThreads = kMma<T> ? kDqSplit<D, Paged> * GROUP_THREADS : THREADS;
template <typename T>
constexpr int kDkvThreads = kMma<T> ? GROUP_THREADS : THREADS;

// one kv tile of the dq walk: its index and, per layout block j inside it
// (a page, or the whole contiguous tile), whether it runs and which mask
// terms it takes (bit j)
struct KvTile {
  int t;
  unsigned live, geo, data;
};

// the run bits of `G` pages of sequence b at q-block qi starting at slot s0:
// byte 0 / 1 / 2 bit j = page j runs / takes the geometric terms / takes
// the data terms. Slots past nk and dead slots (negative page) never run.
// The class and the page index are independent loads, issued together.
__device__ __forceinline__ unsigned page_bits(const MaskParams& mp, const int32_t* page_list,
                                              int b, int qi, int s0, int G, int nk) {
  constexpr int MAX_G = KV_TILE / 8;
  int cls[MAX_G], page[MAX_G];
#pragma unroll
  for (int j = 0; j < MAX_G; ++j) {
    const int s = s0 + j;
    const bool in = j < G && s < nk;
    cls[j] = in ? mp.block_class(b, qi, s) : BLOCK_SKIP;
    page[j] = in ? page_list[(long long)b * nk + s] : 0;
  }
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < MAX_G; ++j) {
    bool geo_on, data_on;
    if (!mp.tile_terms(cls[j], geo_on, data_on) || page[j] < 0) continue;
    bits |= (1u | ((unsigned)geo_on << 8) | ((unsigned)data_on << 16)) << j;
  }
  return bits;
}

// the same bits for contiguous tile (qi, ki): one layout block, bit 0
__device__ __forceinline__ unsigned block_bits(const MaskParams& mp, int b, int qi, int ki) {
  bool geo_on, data_on;
  if (!mp.tile_terms(mp.block_class(b, qi, ki), geo_on, data_on)) return 0u;
  return 1u | ((unsigned)geo_on << 8) | ((unsigned)data_on << 16);
}

// dynamic shared memory of dq_mma: Q' and dO (64 x D each), then per group
// two stages of K and of V (64 x D each), all bf16, swizzled; then per group
// and stage kv_pos, kv_seg, kv_mask of the tile's 64 columns as int32; then
// the table of tile classes (one per thread)
template <int D, bool Paged>
struct DqSmem {
  static constexpr int Split = kDqSplit<D, Paged>;
  static constexpr int threads = Split * GROUP_THREADS;
  static constexpr int kv = KV_TILE * D;     // bf16 elements of one K or V stage
  static constexpr int do_off = MAX_BQ * D;
  static constexpr int k_off = 2 * MAX_BQ * D;
  static constexpr int v_off = k_off + 2 * Split * kv;
  static constexpr int bf16_elems = v_off + 2 * Split * kv;
  static constexpr int meta = 3 * KV_TILE;   // int32 per stage
  static constexpr size_t bytes =
      2 * (size_t)bf16_elems + 4 * (2 * Split * (size_t)meta + threads);
  // the merge of the groups' dq partials reuses the K and V stages
  static_assert((Split - 1) * GROUP_THREADS * (D / 2) * 4 <= 2 * 2 * 2 * Split * kv,
                "merge buffer exceeds the K and V stages");
};

// dq, one CTA per (q-block, hq, b): Split groups of 4 warps, warp w of a
// group owns q rows 16w..16w+15; group i takes the i-th of every Split kv
// tiles that run. Per 16 keys of a tile: S = Q' K^T and dP = dO V^T, P from
// (m, l), dS = P o (dP o Z - D) rounded to bf16 as the A operand of
// dq += dS K (K through ldmatrix.trans). A paged tile is 64 keys of
// 64 / ps pages; a contiguous tile is the layout's block of block_k keys,
// rows past it (to a multiple of 16) zero and their columns dS = 0.
template <int D, bool Paged, bool Dropout>
__device__ __forceinline__ void dq_mma(const BwdParams& p) {
  using bf16 = __nv_bfloat16;
  using Smem = DqSmem<D, Paged>;
  constexpr int Split = Smem::Split;
  constexpr int THREADS_ALL = Smem::threads;
  constexpr int CPR = D / 8;                 // 16-byte chunks per row
  constexpr int KD = D / 16;                 // k16 steps over the head dim
  // dO's A fragments stay in registers below d = 64, and at d = 64 in the
  // one-group contiguous CTA; in the paged CTA from d = 64 on (3 groups:
  // 170 registers a thread; d = 128: a 64-register dq) holding them
  // spills, so they are read from shared memory at every k-step
  constexpr bool kHoldDo = D < 64 || (!Paged && D == 64);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + Smem::do_off;
  int* meta_base = reinterpret_cast<int*>(q_s + Smem::bf16_elems);
  unsigned* table_s = reinterpret_cast<unsigned*>(meta_base + 2 * Split * Smem::meta);

  const int bq = p.block_q;
  const int qi = Paged ? blockIdx.x : p.nq - 1 - (int)blockIdx.z;
  const int h = Paged ? blockIdx.y : blockIdx.x;
  const int b = Paged ? blockIdx.z : blockIdx.y;
  const int kvh = h / (p.hq / p.hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = warp / ROW_WARPS, gtid = tid % GROUP_THREADS;
  const int g = lane >> 2, t4 = lane & 3;
  const MaskParams mp = p.mask;             // by value: see flash_common.cuh
  const DropoutParams drop = p.drop;
  const float z_keep = Dropout ? 1.f / drop.keep : 1.f;   // Z of a kept element
  bf16* k_s = q_s + Smem::k_off + 2 * group * Smem::kv;
  bf16* v_s = q_s + Smem::v_off + 2 * group * Smem::kv;
  int* meta_s = meta_base + 2 * group * Smem::meta;

  // R rows per layout block (the page, or the contiguous block_k); G
  // blocks per kv tile; W columns per tile; kp rows the products run over
  const int R = p.block_k;
  const int lg_r = Paged ? __ffs(R) - 1 : 0;
  const int G = Paged ? KV_TILE >> lg_r : 1;
  const int W = Paged ? KV_TILE : R;
  const int kp = (W + 15) & ~15;
  const int ntiles = (p.nk + G - 1) / G;
  const unsigned all_live = (1u << G) - 1u;

  const long long q_row0 = ((long long)b * p.hq + h) * p.sq + (long long)qi * bq;
  const bf16* qg = static_cast<const bf16*>(p.q) + q_row0 * D;
  const bf16* dog = static_cast<const bf16*>(p.dout) + q_row0 * D;
  const bf16* kg = static_cast<const bf16*>(p.k);
  const bf16* vg = static_cast<const bf16*>(p.v);

  // the tiles' classes (and pages), read before any address is formed: one
  // tile per thread into a shared-memory table, scanned by every thread in
  // step
  int table0 = -THREADS_ALL;
  auto fill_table = [&](int w) {
    __syncthreads();                        // every thread is done reading it
    const int t = w + tid;
    if constexpr (Paged) {
      table_s[tid] = t < ntiles ? page_bits(mp, p.page_list, b, qi, t * G, G, p.nk) : 0u;
    } else {
      table_s[tid] = t < ntiles ? block_bits(mp, b, qi, t) : 0u;
    }
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
  // the next Split tiles that run, one per group in order
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
  // copies of tile kt into this group's stage st; rows of a page that does
  // not run, and contiguous rows past block_k, are zero-filled and never
  // addressed
  auto load = [&](const KvTile& kt, int st) {
    bf16* kd = k_s + st * Smem::kv;
    bf16* vd = v_s + st * Smem::kv;
#pragma unroll
    for (int it = 0; it < KV_TILE * CPR / GROUP_THREADS; ++it) {
      const int i = gtid + it * GROUP_THREADS;
      const int row = i / CPR, ch = i % CPR;
      if constexpr (Paged) {
        const int j = row >> lg_r;
        const int off = swizzle<D>(row, ch);
        if ((kt.live >> j) & 1u) {
          const int page = p.page_list[(long long)b * p.nk + kt.t * G + j];
          const long long src = (((long long)kvh * p.num_pages + page) * R + (row & (R - 1))) * D;
          cp_async16(kd + off, kg + src + ch * 8);
          cp_async16(vd + off, vg + src + ch * 8);
        } else {
          *reinterpret_cast<uint4*>(kd + off) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vd + off) = make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        if (row >= kp) break;
        const int off = swizzle<D>(row, ch);
        if (row < W) {
          const long long src =
              (((long long)b * p.hkv + kvh) * p.sk + (long long)kt.t * R + row) * D;
          cp_async16(kd + off, kg + src + ch * 8);
          cp_async16(vd + off, vg + src + ch * 8);
        } else {
          *reinterpret_cast<uint4*>(kd + off) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vd + off) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    const unsigned masked = kt.geo | kt.data;
    if (masked) {                           // what the element mask reads
      int* md = meta_s + st * Smem::meta;
      for (int c = gtid; c < W; c += GROUP_THREADS) {
        if (Paged && !((masked >> (c >> lg_r)) & 1u)) continue;
        const long long kv_row = (long long)b * p.sk + (long long)kt.t * W + c;
        if (mp.kv_pos != nullptr) cp_async4(md + c, mp.kv_pos + kv_row);
        if (mp.kv_seg != nullptr) cp_async4(md + KV_TILE + c, mp.kv_seg + kv_row);
        if (mp.kv_mask != nullptr) md[2 * KV_TILE + c] = mp.kv_mask[kv_row];
      }
    }
  };

  // Q' and dO once per CTA (rows past block_q zero), in their own copy group
#pragma unroll
  for (int it = 0; it < (MAX_BQ * CPR + THREADS_ALL - 1) / THREADS_ALL; ++it) {
    const int i = tid + it * THREADS_ALL;
    if (i >= MAX_BQ * CPR) break;
    const int row = i / CPR, ch = i % CPR;
    const int off = swizzle<D>(row, ch);
    if (row < bq) {
      cp_async16(q_s + off, qg + (long long)row * D + ch * 8);
      cp_async16(do_s + off, dog + (long long)row * D + ch * 8);
    } else {
      *reinterpret_cast<uint4*>(q_s + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(do_s + off) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();

  const int r0 = (warp % ROW_WARPS) * 16;   // this warp's q rows
  const bool has_rows = r0 < bq;            // warp-uniform
  // per q row: position, segment, log2_lse of (m, l), D = rowsum(dO o O)
  int qpos[2], qseg[2];
  float lse[2], ddr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    const int rr = r < bq ? r : 0;
    qpos[hh] = mp.q_position(b, p.sq, qi * bq + rr);
    qseg[hh] = mp.q_segment(b, p.sq, qi * bq + rr);
    lse[hh] = log2_lse(p.m[q_row0 + rr], p.l[q_row0 + rr]);
    ddr[hh] = p.dd[q_row0 + rr];
  }
  float acc[D / 8][4];
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
  cp_async_wait_prior();                    // Q' and dO landed
  __syncthreads();
  uint32_t qa[KD][4], da[KD][4];            // this warp's A fragments
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    ldsm_x4(qa[kd], q_s + swizzle<D>(r0 + (lane & 15), 2 * kd + (lane >> 4)));
    if constexpr (kHoldDo) {
      ldsm_x4(da[kd], do_s + swizzle<D>(r0 + (lane & 15), 2 * kd + (lane >> 4)));
    }
  }

  int st = 0;
  while (more) {
    KvTile nxt;
    const bool more_next = next_round(from, nxt);
    cp_async_wait_all();
    // every group's tile landed for every thread; stage st ^ 1 is free
    __syncthreads();
    if (nxt.t < ntiles) load(nxt, st ^ 1);
    cp_async_commit();
    if (has_rows && cur.t < ntiles) {
      const bf16* ks = k_s + st * Smem::kv;
      const bf16* vs = v_s + st * Smem::kv;
      const int* md = meta_s + st * Smem::meta;
      const unsigned masked = cur.geo | cur.data;
      bool check = cur.live != all_live || masked;
      if constexpr (!Paged) check = check || W != kp;   // columns past block_k
#pragma unroll
      for (int np = 0; np < KV_TILE / 16; ++np) {
        if constexpr (!Paged) {
          if (np * 16 >= kp) break;         // past block_k
        }
        // S and dP for keys 16np..16np+15 (two n8 tiles)
        float s[2][4], dp[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
        }
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          const int off = swizzle<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kd + ((lane >> 3) & 1));
          uint32_t bb[4];
          ldsm_x4(bb, ks + off);
          mma_bf16(s[0], qa[kd], bb[0], bb[1]);
          mma_bf16(s[1], qa[kd], bb[2], bb[3]);
          uint32_t a[4];
          if constexpr (kHoldDo) {
#pragma unroll
            for (int x = 0; x < 4; ++x) a[x] = da[kd][x];
          } else {
            ldsm_x4(a, do_s + swizzle<D>(r0 + (lane & 15), 2 * kd + (lane >> 4)));
          }
          ldsm_x4(bb, vs + off);
          mma_bf16(dp[0], a, bb[0], bb[1]);
          mma_bf16(dp[1], a, bb[2], bb[3]);
        }
        // P on the fragment's (row, column) coordinates, then dS in place
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1;
            const int c = np * 16 + n * 8 + 2 * t4 + (e & 1);
            const int j = Paged ? c >> lg_r : 0;
            bool ok = true;
            if (check) {
              ok = (cur.live >> j) & 1u;
              if constexpr (!Paged) ok = ok && c < W;
              if (ok && ((masked >> j) & 1u)) {
                const int col = cur.t * W + c;
                ok = mp.element_ok_staged((cur.geo >> j) & 1u, (cur.data >> j) & 1u, qpos[hh],
                                          qseg[hh], mp.kv_pos != nullptr ? md[c] : col,
                                          md[KV_TILE + c], md[2 * KV_TILE + c], col);
              }
            }
            const float pv = exp2f(fmaf(s[n][e], LOG2E, -lse[hh]));
            float dpz = dp[n][e];
            if constexpr (Dropout) {        // dP o Z, Z = keep / (1 - p)
              const int r = r0 + g + 8 * hh;
              dpz = drop.keeps(b, h, qi * bq + r, cur.t * W + c) ? dpz * z_keep : 0.f;
            }
            s[n][e] = ok ? pv * (dpz - ddr[hh]) : 0.f;
          }
        }
        // dq += dS K: the C fragments of the two n8 tiles are the A fragment
        const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                               pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, ks + swizzle<D>(np * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                            2 * dn + (lane >> 4)));
          mma_bf16(acc[2 * dn], a, bb[0], bb[1]);
          mma_bf16(acc[2 * dn + 1], a, bb[2], bb[3]);
        }
      }
    }
    st ^= 1;
    cur = nxt;
    more = more_next;
  }
  cp_async_wait_all();                      // no copy outlives the CTA

  // merge the groups in a fixed order: every group but 0 hands its partial
  // dq to group 0 through the K and V stages (lane l of a warp reads what
  // lane l wrote), and group 0 adds group 1, then group 2
  if constexpr (Split > 1) {
    float* mbuf = reinterpret_cast<float*>(q_s + Smem::k_off);
    const int wq = warp % ROW_WARPS;
    __syncthreads();                        // every group is done with its stages
    if (group > 0 && has_rows) {
      float* mb = mbuf + ((group - 1) * ROW_WARPS + wq) * (D / 2) * 32 + lane;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mb[(n * 4 + e) * 32] = acc[n][e];
      }
    }
    __syncthreads();
    if (group > 0) return;
    if (has_rows) {
      for (int gi = 1; gi < Split; ++gi) {
        const float* mb = mbuf + ((gi - 1) * ROW_WARPS + wq) * (D / 2) * 32 + lane;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += mb[(n * 4 + e) * 32];
        }
      }
    }
  }

  if (!has_rows) return;
  // chain rule for the folded scale: one multiply at the end
  bf16* dqg = static_cast<bf16*>(p.out0) + q_row0 * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r >= bq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dqg + (long long)r * D + n * 8 + 2 * t4) =
          pack_bf16(p.scale * acc[n][2 * hh], p.scale * acc[n][2 * hh + 1]);
    }
  }
}

// dynamic shared memory of dkv_mma: K and V of the CTA's 64 keys, then two
// stages each of Q' and of dO (64 x D), all bf16, swizzled; then per stage
// the q rows' m, l, D, position and segment (4 bytes each); then the table
// of layout classes per q-block (one per thread) and a 4-word reduction
template <int D>
struct DkvSmem {
  static constexpr int tile = MAX_BQ * D;    // bf16 elements of one 64-row tile
  static constexpr int v_off = tile;
  static constexpr int q_off = 2 * tile;
  static constexpr int do_off = 4 * tile;
  static constexpr int bf16_elems = 6 * tile;
  static constexpr int rows = 5 * MAX_BQ;    // 4-byte words per stage
  static constexpr size_t bytes =
      2 * (size_t)bf16_elems + 4 * (2 * (size_t)rows + GROUP_THREADS + ROW_WARPS);
};

// dkv, one CTA per (kv-block, hkv, b): the layout's block of block_k keys
// (contiguous; rows past it zero, to a multiple of 16) or a group of
// 64 / ps page slots (paged). 4 warps, warp w owns kv rows 16w..16w+15.
// The CTA walks the q-blocks of its layout column that run and, for each,
// the n_rep heads of its GQA group; Q' and dO tiles (with the rows' m, l,
// D, positions and segments) are double-buffered by cp.async, staged once
// per (q-block, head). Per 16 q rows: S^T = K Q'^T and dP^T = V dO^T (K
// and V A fragments held in registers at d <= 64), P^T from (m, l),
// dS^T = P^T o (dP^T o Z - D); P^T o (Z != 0) and dS^T go from C to A
// fragments in registers for dV += (P o Z)^T dO and dK += dS^T Q' (dO, Q'
// through ldmatrix.trans; dV takes Z's 1 / (1 - p) once, in fp32, at the
// end). The C fragments hold S^T: row = kv row, column = q row, so the
// dropout hash is read at (q row, kv column) with the roles swapped. q rows
// past block_q (to the next multiple of 16) are zero with P = 0. dk, dv sum
// the group's heads in fp32 registers; contiguous: written once in bf16;
// paged: as fp32 packed rows, rows of a dead slot zero.
template <int D, bool Paged, bool Dropout>
__device__ __forceinline__ void dkv_mma(const BwdParams& p) {
  using bf16 = __nv_bfloat16;
  using Smem = DkvSmem<D>;
  constexpr int CPR = D / 8;
  constexpr int KD = D / 16;
  constexpr bool kHoldKV = D <= 64;         // K, V fragments in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + Smem::v_off;
  float* rows_base = reinterpret_cast<float*>(k_s + Smem::bf16_elems);
  unsigned* table_s = reinterpret_cast<unsigned*>(rows_base + 2 * Smem::rows);
  unsigned* red_s = table_s + GROUP_THREADS;

  const int grp = Paged ? blockIdx.x : blockIdx.z;
  const int kvh = Paged ? blockIdx.y : blockIdx.x;
  const int b = Paged ? blockIdx.z : blockIdx.y;
  const int n_rep = p.hq / p.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const MaskParams mp = p.mask;             // by value: see flash_common.cuh
  const DropoutParams drop = p.drop;
  const float z_keep = Dropout ? 1.f / drop.keep : 1.f;   // Z of a kept element
  const int bq = p.block_q;
  const int qp = (bq + 15) & ~15;           // q rows the products run over
  // R rows per layout block (the page, or the contiguous block_k); G
  // blocks per CTA; W kv rows of the CTA; kvp rows the products run over
  const int R = p.block_k;
  const int lg_r = Paged ? __ffs(R) - 1 : 0;
  const int G = Paged ? KV_TILE >> lg_r : 1;
  const int W = Paged ? KV_TILE : R;
  const int kvp = (W + 15) & ~15;
  const int s0 = grp * G;                   // the CTA's first slot / its kv-block
  const bf16* kg = static_cast<const bf16*>(p.k);
  const bf16* vg = static_cast<const bf16*>(p.v);
  const bf16* qg = static_cast<const bf16*>(p.q);
  const bf16* dog = static_cast<const bf16*>(p.dout);

  // the CTA's column of the layout, read before any page address is
  // formed: a block runs for the CTA if it runs for some q-block
  unsigned col = 0u;
  for (int qi = tid; qi < p.nq; qi += GROUP_THREADS) {
    if constexpr (Paged) {
      col |= page_bits(mp, p.page_list, b, qi, s0, G, p.nk);
    } else {
      col |= block_bits(mp, b, qi, s0);
    }
  }
  col = __reduce_or_sync(0xffffffffu, col & 0xffu);
  if (lane == 0) red_s[warp] = col;
  __syncthreads();
  const unsigned colmask = red_s[0] | red_s[1] | red_s[2] | red_s[3];

  int table0 = -GROUP_THREADS;
  auto fill_table = [&](int w) {
    __syncthreads();
    const int qi = w + tid;
    if constexpr (Paged) {
      table_s[tid] = qi < p.nq ? page_bits(mp, p.page_list, b, qi, s0, G, p.nk) : 0u;
    } else {
      table_s[tid] = qi < p.nq ? block_bits(mp, b, qi, s0) : 0u;
    }
    table0 = w;
    __syncthreads();
  };
  // the next q-block from qi that runs (p.nq: none) and its page bits
  auto next_live = [&](int qi, unsigned& bits) {
    for (; qi < p.nq; ++qi) {
      if (qi >= table0 + GROUP_THREADS) fill_table(qi);
      bits = table_s[qi - table0];
      if (bits & 0xffu) return qi;
    }
    return p.nq;
  };
  // Q', dO and the row terms of (q-block qi, head kvh * n_rep + hr) into
  // stage st; rows block_q..qp - 1 are zero, rows past qp never read
  auto load_item = [&](int qi, int hr, int st) {
    const long long q_row0 =
        ((long long)b * p.hq + kvh * n_rep + hr) * p.sq + (long long)qi * bq;
    bf16* qd = k_s + Smem::q_off + st * Smem::tile;
    bf16* dd = k_s + Smem::do_off + st * Smem::tile;
#pragma unroll
    for (int it = 0; it < MAX_BQ * CPR / GROUP_THREADS; ++it) {
      const int i = tid + it * GROUP_THREADS;
      const int row = i / CPR, ch = i % CPR;
      const int off = swizzle<D>(row, ch);
      if (row < bq) {
        cp_async16(qd + off, qg + (q_row0 + row) * D + ch * 8);
        cp_async16(dd + off, dog + (q_row0 + row) * D + ch * 8);
      } else if (row < qp) {
        *reinterpret_cast<uint4*>(qd + off) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dd + off) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (tid < bq) {
      float* rs = rows_base + st * Smem::rows;
      int* ri = reinterpret_cast<int*>(rs + 3 * MAX_BQ);
      const int row = qi * bq + tid;
      cp_async4(rs + tid, p.m + q_row0 + tid);
      cp_async4(rs + MAX_BQ + tid, p.l + q_row0 + tid);
      cp_async4(rs + 2 * MAX_BQ + tid, p.dd + q_row0 + tid);
      if (mp.q_pos != nullptr) {
        cp_async4(ri + tid, mp.q_pos + (long long)b * p.sq + row);
      } else {
        ri[tid] = row + mp.q_offset;
      }
      if (mp.q_seg != nullptr) {
        cp_async4(ri + MAX_BQ + tid, mp.q_seg + (long long)b * p.sq + row);
      } else {
        ri[MAX_BQ + tid] = 0;
      }
    }
  };

  const int r0 = warp * 16;                 // this warp's kv rows
  // this lane's two kv rows (r0 + g, r0 + g + 8): block, position, segment
  int jr[2], kpos[2], kseg[2], kval[2];
  bool kin[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = r0 + g + 8 * hh;
    const int c = grp * W + rr;             // kv buffer column
    jr[hh] = Paged ? rr >> lg_r : 0;
    const bool in = Paged ? s0 + jr[hh] < p.nk : rr < W;
    kin[hh] = in;
    const long long kv_row = (long long)b * p.sk + c;
    kpos[hh] = (mp.kv_pos != nullptr && in) ? mp.kv_pos[kv_row] : c;
    kseg[hh] = (mp.kv_seg != nullptr && in) ? mp.kv_seg[kv_row] : 0;
    kval[hh] = (mp.kv_mask != nullptr && in) ? mp.kv_mask[kv_row] : 1;
  }
  // the blocks of this warp's 16 rows, as bits of the block index (a
  // contiguous warp past block_k has none)
  const unsigned wmask =
      Paged ? ((2u << ((r0 + 15) >> lg_r)) - 1u) & ~((1u << (r0 >> lg_r)) - 1u)
            : (r0 < W ? 1u : 0u);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }

  if (colmask) {
    // K and V of the blocks that run (others, and contiguous rows past
    // block_k, zero and never addressed)
#pragma unroll
    for (int it = 0; it < KV_TILE * CPR / GROUP_THREADS; ++it) {
      const int i = tid + it * GROUP_THREADS;
      const int row = i / CPR, ch = i % CPR;
      if constexpr (Paged) {
        const int j = row >> lg_r;
        const int off = swizzle<D>(row, ch);
        if ((colmask >> j) & 1u) {
          const int page = p.page_list[(long long)b * p.nk + s0 + j];
          const long long src = (((long long)kvh * p.num_pages + page) * R + (row & (R - 1))) * D;
          cp_async16(k_s + off, kg + src + ch * 8);
          cp_async16(v_s + off, vg + src + ch * 8);
        } else {
          *reinterpret_cast<uint4*>(k_s + off) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(v_s + off) = make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        if (row >= kvp) break;
        const int off = swizzle<D>(row, ch);
        if (row < W) {
          const long long src =
              (((long long)b * p.hkv + kvh) * p.sk + (long long)grp * R + row) * D;
          cp_async16(k_s + off, kg + src + ch * 8);
          cp_async16(v_s + off, vg + src + ch * 8);
        } else {
          *reinterpret_cast<uint4*>(k_s + off) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(v_s + off) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();
    unsigned cur_bits = 0u;
    int qi_cur = next_live(0, cur_bits), hr = 0;
    if (qi_cur < p.nq) load_item(qi_cur, 0, 0);
    cp_async_commit();
    cp_async_wait_prior();                  // K and V landed
    __syncthreads();
    uint32_t ka[KD][4], va[KD][4];
    if constexpr (kHoldKV) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        ldsm_x4(ka[kd], k_s + swizzle<D>(r0 + (lane & 15), 2 * kd + (lane >> 4)));
        ldsm_x4(va[kd], v_s + swizzle<D>(r0 + (lane & 15), 2 * kd + (lane >> 4)));
      }
    }

    int st = 0;
    while (qi_cur < p.nq) {
      int qi_n = qi_cur, hr_n = hr + 1;
      unsigned nxt_bits = cur_bits;
      if (hr_n == n_rep) {
        hr_n = 0;
        qi_n = next_live(qi_cur + 1, nxt_bits);
      }
      cp_async_wait_all();
      // this item landed for every thread; stage st ^ 1 is free
      __syncthreads();
      if (qi_n < p.nq) load_item(qi_n, hr_n, st ^ 1);
      cp_async_commit();

      const unsigned live = cur_bits & 0xffu;
      if (live & wmask) {                   // warp-uniform
        const unsigned geo = (cur_bits >> 8) & 0xffu, dat = (cur_bits >> 16) & 0xffu;
        const bf16* qs = k_s + Smem::q_off + st * Smem::tile;
        const bf16* dos = k_s + Smem::do_off + st * Smem::tile;
        const float* rs = rows_base + st * Smem::rows;
        const int* ri = reinterpret_cast<const int*>(rs + 3 * MAX_BQ);
        const int h = kvh * n_rep + hr;
        bool lr[2], mr[2], gr[2], dr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          lr[hh] = (live >> jr[hh]) & 1u;
          if constexpr (!Paged) lr[hh] = lr[hh] && kin[hh];
          gr[hh] = (geo >> jr[hh]) & 1u;
          dr[hh] = (dat >> jr[hh]) & 1u;
          mr[hh] = gr[hh] || dr[hh];
        }
#pragma unroll
        for (int kk = 0; kk < MAX_BQ / 16; ++kk) {
          if (kk * 16 >= qp) break;         // warp-uniform
          float s[2][4], dp[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
          }
#pragma unroll
          for (int kd = 0; kd < KD; ++kd) {
            const int off = swizzle<D>(kk * 16 + (lane & 7) + ((lane >> 4) << 3),
                                       2 * kd + ((lane >> 3) & 1));
            uint32_t a[4], bb[4];
            if constexpr (kHoldKV) {
#pragma unroll
              for (int x = 0; x < 4; ++x) a[x] = ka[kd][x];
            } else {
              ldsm_x4(a, k_s + swizzle<D>(r0 + (lane & 15), 2 * kd + (lane >> 4)));
            }
            ldsm_x4(bb, qs + off);
            mma_bf16(s[0], a, bb[0], bb[1]);
            mma_bf16(s[1], a, bb[2], bb[3]);
            if constexpr (kHoldKV) {
#pragma unroll
              for (int x = 0; x < 4; ++x) a[x] = va[kd][x];
            } else {
              ldsm_x4(a, v_s + swizzle<D>(r0 + (lane & 15), 2 * kd + (lane >> 4)));
            }
            ldsm_x4(bb, dos + off);
            mma_bf16(dp[0], a, bb[0], bb[1]);
            mma_bf16(dp[1], a, bb[2], bb[3]);
          }
          // P^T and dS^T on the fragment's (kv row, q row) coordinates; a
          // lane's four q rows (columns) each take their terms once
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int par = 0; par < 2; ++par) {
              const int c = kk * 16 + n * 8 + 2 * t4 + par;
              const float lse = log2_lse(rs[c], rs[MAX_BQ + c]);
              const float ddc = rs[2 * MAX_BQ + c];
              const bool in = c < bq;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int e = 2 * hh + par;
                bool ok = in && lr[hh];
                if (ok && mr[hh]) {
                  ok = mp.element_ok_staged(gr[hh], dr[hh], ri[c], ri[MAX_BQ + c], kpos[hh],
                                            kseg[hh], kval[hh], grp * W + r0 + g + 8 * hh);
                }
                const float pv = exp2f(fmaf(s[n][e], LOG2E, -lse));
                if constexpr (Dropout) {
                  // Z at (q row, kv column): dV takes the kept P (1 / (1 - p)
                  // at the end), dS the undropped P against dP o Z
                  const bool keep = drop.keeps(b, h, qi_cur * bq + c, grp * W + r0 + g + 8 * hh);
                  const float dpz = keep ? dp[n][e] * z_keep : 0.f;
                  s[n][e] = (ok && keep) ? pv : 0.f;
                  dp[n][e] = ok ? pv * (dpz - ddc) : 0.f;
                } else {
                  s[n][e] = ok ? pv : 0.f;
                  dp[n][e] = ok ? pv * (dp[n][e] - ddc) : 0.f;
                }
              }
            }
          }
          const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                  pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
          const uint32_t sa[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                                  pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
          for (int dn = 0; dn < D / 16; ++dn) {
            const int off = swizzle<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                       2 * dn + (lane >> 4));
            uint32_t bb[4];
            ldsm_x4_trans(bb, dos + off);
            mma_bf16(dv[2 * dn], pa, bb[0], bb[1]);
            mma_bf16(dv[2 * dn + 1], pa, bb[2], bb[3]);
            ldsm_x4_trans(bb, qs + off);
            mma_bf16(dk[2 * dn], sa, bb[0], bb[1]);
            mma_bf16(dk[2 * dn + 1], sa, bb[2], bb[3]);
          }
        }
      }
      st ^= 1;
      qi_cur = qi_n;
      hr = hr_n;
      cur_bits = nxt_bits;
    }
    cp_async_wait_all();                    // no copy outlives the CTA
  }

  const long long out0 = ((long long)b * p.hkv + kvh) * p.sk + (long long)grp * W;
  if constexpr (Paged) {
    // fp32 packed rows of the slots < nk (a dead slot's rows are zero)
    float* dkg = static_cast<float*>(p.out0) + out0 * D;
    float* dvg = static_cast<float*>(p.out1) + out0 * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = r0 + g + 8 * hh;
      if (s0 + jr[hh] >= p.nk) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const long long o = (long long)rr * D + n * 8 + 2 * t4;
        *reinterpret_cast<float2*>(dkg + o) = make_float2(dk[n][2 * hh], dk[n][2 * hh + 1]);
        *reinterpret_cast<float2*>(dvg + o) = make_float2(dv[n][2 * hh], dv[n][2 * hh + 1]);
      }
    }
  } else {
    // the block's rows in k's dtype; dV takes Z's 1 / (1 - p) here
    bf16* dkg = static_cast<bf16*>(p.out0) + out0 * D;
    bf16* dvg = static_cast<bf16*>(p.out1) + out0 * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = r0 + g + 8 * hh;
      if (!kin[hh]) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const long long o = (long long)rr * D + n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(dkg + o) = pack_bf16(dk[n][2 * hh], dk[n][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dvg + o) =
            pack_bf16(z_keep * dv[n][2 * hh], z_keep * dv[n][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the kernels: the bf16 instantiations run the tensor-core bodies, the fp32
// ones (the card's parity mode) the scalar body. Dropout is a template
// parameter of the tensor-core body only (contiguous K/V), so the
// instantiations without it carry none of the hash's code or registers;
// the scalar body reads it at run time.
// ---------------------------------------------------------------------------

template <typename T, int D, bool Paged, bool Dropout>
__global__ void __launch_bounds__(kDqThreads<T, D, Paged>) flash_bwd_dq_kernel(const BwdParams p) {
  if constexpr (kMma<T>) {
    dq_mma<D, Paged, Dropout>(p);
  } else {
    dq_scalar<T, D, Paged>(p);
  }
}

template <typename T, int D, bool Paged, bool Dropout>
__global__ void __launch_bounds__(kDkvThreads<T>) flash_bwd_dkv_kernel(const BwdParams p) {
  if constexpr (kMma<T>) {
    dkv_mma<D, Paged, Dropout>(p);
  } else {
    dkv_scalar<T, D, Paged>(p);
  }
}

// ---------------------------------------------------------------------------
// the fold of the packed dk, dv rows into pool shape (replaces the XLA
// scatter-add of flash_attention.py:924-933)
// ---------------------------------------------------------------------------

constexpr int FOLD_THREADS = 256;

// One CTA per (position in the sorted slot order, kv head). pages[i] and
// slots[i] are the flattened page list (slot = b * T + t), dead slots
// mapped to page num_pages, stably sorted by page: the slots naming one
// page are consecutive and in (b, t) order, dead slots last. The CTA
// holding a page's first slot sums that page's packed rows in that order,
// from 0.f in fp32, and writes the pool page once in the pools' dtype;
// every other CTA exits. No atomics: each pool page has one writer and a
// fixed sum order (fold_packed_to_pool's, bit for bit). Pages no slot
// names keep the zeros the caller allocated.
template <typename OutT>
__global__ void __launch_bounds__(FOLD_THREADS)
    flash_bwd_fold_kernel(const float* __restrict__ dk, const float* __restrict__ dv,
                          const int32_t* __restrict__ pages, const long long* __restrict__ slots,
                          OutT* dk_pool, OutT* dv_pool, int n, int T, int hkv, int page_elems,
                          int num_pages) {
  const int i0 = blockIdx.x, h = blockIdx.y;
  const int page = pages[i0];
  if (page >= num_pages || (i0 > 0 && pages[i0 - 1] == page)) return;
  const long long dst = ((long long)h * num_pages + page) * page_elems;
  for (int e = threadIdx.x * 4; e < page_elems; e += FOLD_THREADS * 4) {
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int i = i0; i < n && pages[i] == page; ++i) {
      const int slot = (int)slots[i];
      const int bi = slot / T, t = slot - bi * T;
      const long long src = (((long long)bi * hkv + h) * T + t) * page_elems + e;
      const float4 xk = *reinterpret_cast<const float4*>(dk + src);
      const float4 xv = *reinterpret_cast<const float4*>(dv + src);
      sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
      sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
    }
    store_out(dk_pool + dst + e, sk.x); store_out(dk_pool + dst + e + 1, sk.y);
    store_out(dk_pool + dst + e + 2, sk.z); store_out(dk_pool + dst + e + 3, sk.w);
    store_out(dv_pool + dst + e, sv.x); store_out(dv_pool + dst + e + 1, sv.y);
    store_out(dv_pool + dst + e + 2, sv.z); store_out(dv_pool + dst + e + 3, sv.w);
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
cudaError_t launch_kernel(K kern, dim3 grid, int threads, size_t smem, const BwdParams& p,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool Paged, bool Dropout>
cudaError_t launch(int which, const BwdParams& p, cudaStream_t stream) {
  if constexpr (kMma<T>) {
    if (which == 0) {
      return launch_kernel(flash_bwd_dq_kernel<T, D, Paged, Dropout>,
                           Paged ? dim3(p.nq, p.hq, p.b) : dim3(p.hq, p.b, p.nq),
                           kDqThreads<T, D, Paged>, DqSmem<D, Paged>::bytes, p, stream);
    }
    // dkv: one CTA per kv-block, or per 64-key group of 64 / ps page slots
    const dim3 grid = Paged ? dim3((p.nk * p.block_k + KV_TILE - 1) / KV_TILE, p.hkv, p.b)
                            : dim3(p.hkv, p.b, p.nk);
    return launch_kernel(flash_bwd_dkv_kernel<T, D, Paged, Dropout>, grid,
                         kDkvThreads<T>, DkvSmem<D>::bytes, p, stream);
  }
  if (which == 0) {
    return launch_kernel(flash_bwd_dq_kernel<T, D, Paged, Dropout>, dim3(p.nq, p.hq, p.b),
                         THREADS, dq_smem<D>(p), p, stream);
  }
  return launch_kernel(flash_bwd_dkv_kernel<T, D, Paged, Dropout>, dim3(p.nk, p.hkv, p.b),
                       THREADS, dkv_smem<D>(p), p, stream);
}

// dropout is compile-time in the tensor-core body (contiguous K/V only, as
// in the JAX package) and read at run time by the scalar body
template <typename T, int D, bool Paged>
cudaError_t launch_variant(int which, const BwdParams& p, cudaStream_t stream) {
  if constexpr (kMma<T> && !Paged) {
    if (p.drop.on) return launch<T, D, Paged, true>(which, p, stream);
  }
  return launch<T, D, Paged, false>(which, p, stream);
}

template <typename T, bool Paged>
cudaError_t dispatch_d(int which, const BwdParams& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch_variant<T, 16, Paged>(which, p, stream);
    case 32: return launch_variant<T, 32, Paged>(which, p, stream);
    case 64: return launch_variant<T, 64, Paged>(which, p, stream);
    case 96: return launch_variant<T, 96, Paged>(which, p, stream);
    case 128: return launch_variant<T, 128, Paged>(which, p, stream);
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
        int dropout_b0, int dropout_h0, int dropout_heads,
        float scale, void* stream, const int32_t* page_list, int num_pages) {
  const bool paged = page_list != nullptr;
  if (block_q <= 0 || block_q > MAX_BQ || block_k <= 0 || block_k > MAX_BK || hkv <= 0 ||
      hq % hkv != 0 || (paged && dropout_on)) {
    return (int)cudaErrorInvalidValue;
  }
  // a bf16 paged kv tile gathers MAX_BK / block_k whole pages: 8, 16, 32, 64
  if (paged && dtype == 1 && (block_k < 8 || MAX_BK % block_k != 0)) {
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
  p.drop = make_dropout(dropout_on, dropout_seed, dropout_threshold, dropout_keep,
                        dropout_heads, dropout_q_len, dropout_k_len, dropout_b0,
                        dropout_h0);
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
// layout block = one page (block_k = ps, sk = nk * ps), the page list (b, nk)
// and no dropout (bf16: ps 8, 16, 32 or 64); flash_bwd_dkv_paged writes fp32
// packed (b, hkv, sk, D).
#define FLASH_BWD_ARGS                                                                    \
  int dtype, int head_dim, const void *q, const void *k, const void *v, const void *dout, \
      const float *m, const float *l, const float *dd, void *out0, void *out1,            \
      const int32_t *layout, long long layout_b_stride, const uint8_t *kv_mask,           \
      const int32_t *q_seg, const int32_t *kv_seg, const int32_t *q_pos,                  \
      const int32_t *kv_pos, int b, int hq, int hkv, int sq, int sk, int nq, int nk,      \
      int block_q, int block_k, int causal, int window, int q_offset, int kv_valid_len,   \
      int dropout_on, unsigned dropout_seed, unsigned dropout_threshold,                  \
      float dropout_keep, int dropout_q_len, int dropout_k_len, int dropout_b0,           \
      int dropout_h0, int dropout_heads, float scale, void *stream
#define FLASH_BWD_PASS                                                                     \
  dtype, head_dim, q, k, v, dout, m, l, dd, out0, out1, layout, layout_b_stride, kv_mask,  \
      q_seg, kv_seg, q_pos, kv_pos, b, hq, hkv, sq, sk, nq, nk, block_q, block_k, causal,  \
      window, q_offset, kv_valid_len, dropout_on, dropout_seed, dropout_threshold,         \
      dropout_keep, dropout_q_len, dropout_k_len, dropout_b0, dropout_h0, dropout_heads,   \
      scale, stream

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

// The fold of the paged dkv kernel's fp32 packed rows (b, hkv, T*ps, D)
// into pool-shaped dk_pool, dv_pool (hkv, num_pages, ps, D) of `dtype`,
// which the caller zeroed: pages (int32) and slots (int64), n = b*T each,
// the page list stably sorted by page with dead slots mapped to num_pages.
// page_elems = ps * D.
int flash_bwd_fold_paged(int dtype, const float* dk, const float* dv, const int32_t* pages,
                         const long long* slots, void* dk_pool, void* dv_pool, int n, int T,
                         int hkv, int page_elems, int num_pages, void* stream) {
  if (n <= 0 || T <= 0 || n % T != 0 || hkv <= 0 || page_elems <= 0 || page_elems % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n, hkv);
  if (dtype == 0) {
    flash_bwd_fold_kernel<float><<<grid, FOLD_THREADS, 0, s>>>(
        dk, dv, pages, slots, static_cast<float*>(dk_pool), static_cast<float*>(dv_pool), n, T, hkv,
        page_elems, num_pages);
  } else if (dtype == 1) {
    flash_bwd_fold_kernel<__nv_bfloat16><<<grid, FOLD_THREADS, 0, s>>>(
        dk, dv, pages, slots, static_cast<__nv_bfloat16*>(dk_pool),
        static_cast<__nv_bfloat16*>(dv_pool), n, T, hkv, page_elems, num_pages);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
