// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV, bf16 in and
// out, f32 sums.
//
// Replaces: dtf_tpu/ops/flash_attention.py::_dq_kernel (B2) and
// ::_dkv_kernel (B3), reached through _bwd / _flash_bwd. Same function:
// S = Q K^T * sm_scale in f32, -inf on keys >= t_k, on causal q < k and on
// out-of-window q - k >= W, plus the per-batch key-padding bias row;
// P = exp(S - lse) from the forward's saved lse, forced to 0 where
// lse = -inf (a query row whose keys are all masked) and on query rows
// past t_q; dP = dO V^T; dS = P (dP - Delta) sm_scale with
// Delta = rowsum(dO * O) (computed in f32 by the caller, as the JAX
// package computes it in XLA outside its kernels). Then dQ = dS K,
// dK = dS^T Q, dV = P^T dO. P is cast to bf16 before P^T dO, and dS to
// bf16 before its two products, as the TPU kernels cast them; every sum
// is f32 and each output is written once, in bf16.
//
// Design. Two kernels, the JAX package's split, with nothing summed
// across CTAs (no atomics):
// - dQ: one CTA of 4 warps per (batch*head, 64-row q-block). A loop
//   inside the CTA runs over the LIVE k-blocks only (up to the diagonal
//   when causal, from the first in-window block under a window), which
//   replaces _block_live and _kv_sticky_map. Each warp owns 16 query
//   rows and keeps its dQ rows in WMMA accumulator fragments (registers)
//   across the loop.
// - dK/dV: one CTA of 4 warps per (batch*head, 64-key block), a loop over
//   the live q-blocks (from the block's own diagonal to the last q-block,
//   and only while within the window). Each warp owns 16 key rows; the
//   f32 dK and dV accumulators live in shared memory.
// Scores and dP are staged in shared memory because WMMA fragment
// layouts are opaque (two lanes then own one row's elementwise work),
// as in flash_fwd.cu. Inputs are read through their (batch, head, seq)
// strides: dO arrives from autograd as a transposed view. The ragged
// edges are masked here: rows past t_q / t_k load as zeros and are never
// written.
//
// Bounds on the H100 at the training slice's shape (q/k/v
// [8, 12, 1024, 64] bf16, causal; 989 TF/s bf16, 3.35 TB/s):
// - dQ (B2): three causal-halved T*T*D products, ~19.3 GFLOP (19.5 us);
//   q, k, v, dO, lse, Delta in and dq out, ~63.7 MB (19.0 us): ~19.5 us,
//   at the ridge.
// - dK/dV (B3): four products, ~25.8 GFLOP (26.1 us); ~76.3 MB (22.8 us):
//   ~26 us, compute.
//
// What this simple design leaves on the table: WMMA (mma.sync) instead of
// wgmma reaches a fraction of the tensor-core peak; Q/dO or K/V tiles are
// loaded synchronously by all threads (no TMA, no cp.async double
// buffering), so loads never overlap the products; S, dP, P and dS round
// trip through shared memory every block, and dK/dV accumulators too; the
// dQ and dK/dV kernels recompute S and dP twice between them (a fused
// kernel with atomic dQ would not); 64x64 tiles re-read K/V (dQ) and
// Q/dO (dK/dV) from L2 once per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;            // query rows per q-block
constexpr int BK = 64;            // keys per k-block
constexpr int WARPS = 4;          // each warp owns 16 rows of its CTA's block
constexpr int THREADS = WARPS * 32;

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Row strides in elements. The pads keep WMMA pointers 32-byte aligned and
// shift consecutive rows across shared-memory banks.
template <int D>
struct Strides {
  static constexpr int LDT = D + 8;    // bf16 q / k / v / dO tiles
  static constexpr int LDS = 64 + 4;   // f32 S and dP (64 columns)
  static constexpr int LDP = 64 + 8;   // bf16 P and dS (64 columns)
  static constexpr int LDA = D + 4;    // f32 accumulators / staging
};

template <int D>
struct DqLayout : Strides<D> {
  using S = Strides<D>;
  static constexpr size_t tile = align128(sizeof(bf16) * 64 * S::LDT);
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + tile;
  static constexpr size_t k_off = do_off + tile;
  static constexpr size_t v_off = k_off + tile;
  static constexpr size_t s_off = v_off + tile;
  static constexpr size_t dp_off = s_off + align128(sizeof(float) * BQ * S::LDS);
  static constexpr size_t ds_off = dp_off + align128(sizeof(float) * BQ * S::LDS);
  static constexpr size_t a_off = ds_off + align128(sizeof(bf16) * BQ * S::LDP);
  static constexpr size_t bytes = a_off + align128(sizeof(float) * BQ * S::LDA);
};

template <int D>
struct DkvLayout : Strides<D> {
  using S = Strides<D>;
  static constexpr size_t tile = align128(sizeof(bf16) * 64 * S::LDT);
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + tile;
  static constexpr size_t q_off = v_off + tile;
  static constexpr size_t do_off = q_off + tile;
  static constexpr size_t s_off = do_off + tile;
  static constexpr size_t dp_off = s_off + align128(sizeof(float) * BK * S::LDS);
  static constexpr size_t p_off = dp_off + align128(sizeof(float) * BK * S::LDS);
  static constexpr size_t ds_off = p_off + align128(sizeof(bf16) * BK * S::LDP);
  static constexpr size_t dk_off = ds_off + align128(sizeof(bf16) * BK * S::LDP);
  static constexpr size_t dv_off = dk_off + align128(sizeof(float) * BK * S::LDA);
  static constexpr size_t stat_off = dv_off + align128(sizeof(float) * BK * S::LDA);
  static constexpr size_t bytes = stat_off + align128(sizeof(float) * 2 * BQ);
};

// Rows [base, base + 64) of a [rows, D] bf16 matrix with row stride `st`
// (elements; D contiguous) into shared memory, 16 bytes per thread and
// step. Rows at or past `limit` are written as zeros, so a padded row
// contributes nothing to any product.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int base, int limit) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (base + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(base + r) * st + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Strides<D>::LDT + c) = val;
  }
}

// out[16 x 64] (f32, row stride ldo) = A[16 x D] B^T for one warp, where A
// is 16 rows of a bf16 tile and B is the 64 rows of another (row-major
// [64, D], read as a col-major D x 64 matrix).
template <int D>
__device__ __forceinline__ void warp_abt(float* out, int ldo, const bf16* a,
                                         const bf16* b) {
  constexpr int LDT = Strides<D>::LDT;
  FragA fa;
  FragBCol fb;
  FragC fc;
#pragma unroll
  for (int n = 0; n < 64 / 16; ++n) {
    wmma::fill_fragment(fc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(fa, a + kk * 16, LDT);
      wmma::load_matrix_sync(fb, b + n * 16 * LDT + kk * 16, LDT);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(out + n * 16, fc, ldo, wmma::mem_row_major);
  }
}

// acc[16 x D] (f32 in shared memory, row stride LDA) += A[16 x 64] B for
// one warp: A is 16 rows of a bf16 [., 64] matrix (row stride LDP), B a
// row-major bf16 [64, D] tile.
template <int D>
__device__ __forceinline__ void warp_acc_ab_smem(float* acc, const bf16* a,
                                                 const bf16* b) {
  constexpr int LDT = Strides<D>::LDT;
  constexpr int LDP = Strides<D>::LDP;
  constexpr int LDA = Strides<D>::LDA;
  FragA fa;
  FragBRow fb;
  FragC fc;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::load_matrix_sync(fc, acc + n * 16, LDA, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      wmma::load_matrix_sync(fa, a + kk * 16, LDP);
      wmma::load_matrix_sync(fb, b + kk * 16 * LDT + n * 16, LDT);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(acc + n * 16, fc, LDA, wmma::mem_row_major);
  }
}

// Whether (qpos, kpos) survives _score_mask (the key-range, causal and
// window rule; the bias row is added separately).
__device__ __forceinline__ bool score_ok(int qpos, int kpos, int Tk,
                                         int causal, int window) {
  bool ok = kpos < Tk;
  if (causal) {
    ok = ok && qpos >= kpos;
    if (window > 0) ok = ok && (qpos - kpos < window);
  }
  return ok;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, bf16* __restrict__ dq,
                    int H, int Tq, int Tk,
                    long long qsb, long long qsh, long long qst,
                    long long ksb, long long ksh, long long kst,
                    long long vsb, long long vsh, long long vst,
                    long long dsb, long long dsh, long long dst,
                    float scale, int causal, int window) {
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::do_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sdP = reinterpret_cast<float*>(smem + L::dp_off);
  bf16* sdS = reinterpret_cast<bf16*>(smem + L::ds_off);
  float* sA = reinterpret_cast<float*>(smem + L::a_off);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1);   // this thread's query row
  const int half = lane & 1;                 // ... and which half of it
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + row;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const bf16* qp = q + b * qsb + h * qsh;
  const bf16* kp = k + b * ksb + h * ksh;
  const bf16* vp = v + b * vsb + h * vsh;
  const bf16* dop = dout + b * dsb + h * dsh;
  const float* brow = bias ? bias + (long long)b * Tk : nullptr;

  // The live k-range of this q-block.
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int kb_begin = k_begin / BK;
  const int kb_end = (k_end + BK - 1) / BK;

  load_tile<D>(sQ, qp, qst, q0, Tq);
  load_tile<D>(sdO, dop, dst, q0, Tq);
  // A padded row takes lse -inf, so its P is 0 (_zero_padded_q_rows).
  const bool row_ok = qpos < Tq;
  const float lse_r = row_ok ? lse[(long long)bh * Tq + qpos] : -INFINITY;
  const float delta_r = row_ok ? delta[(long long)bh * Tq + qpos] : 0.f;
  const bool dead = lse_r == -INFINITY;

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const float* srow = sS + row * L::LDS + half * 32;
  const float* dprow = sdP + row * L::LDS + half * 32;
  bf16* dsrow = sdS + row * L::LDP + half * 32;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int kbase = kb * BK;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<D>(sK, kp, kst, kbase, Tk);
    load_tile<D>(sV, vp, vst, kbase, Tk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows.
    warp_abt<D>(sS + warp * 16 * L::LDS, L::LDS, sQ + warp * 16 * L::LDT, sK);
    warp_abt<D>(sdP + warp * 16 * L::LDS, L::LDS, sdO + warp * 16 * L::LDT, sV);
    __syncwarp();

    // dS over this thread's half row, cast to bf16 for dS K.
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int kpos = kbase + half * 32 + c;
      float s = score_ok(qpos, kpos, Tk, causal, window) ? srow[c] * scale
                                                         : -INFINITY;
      if (brow != nullptr && kpos < Tk) s += brow[kpos];
      const float p = dead ? 0.f : expf(s - lse_r);
      dsrow[c] = __float2bfloat16(p * (dprow[c] - delta_r) * scale);
    }
    __syncwarp();

    // dQ += dS K (K row-major [BK, D] is the B operand as it stands).
    {
      FragA fa;
      FragBRow fb;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::load_matrix_sync(fa, sdS + warp * 16 * L::LDP + kk * 16, L::LDP);
          wmma::load_matrix_sync(fb, sK + kk * 16 * L::LDT + n * 16, L::LDT);
          wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
      }
    }
    __syncwarp();
  }

  // Stage this warp's f32 rows, then write them once in bf16.
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(sA + warp * 16 * L::LDA + n * 16, acc[n], L::LDA,
                            wmma::mem_row_major);
  }
  __syncwarp();
  if (row_ok) {
    const float* arow = sA + row * L::LDA + half * (D / 2);
    bf16* orow = dq + ((long long)bh * Tq + qpos) * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] = __float2bfloat16(arow[c]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Tq, int Tk,
                     long long qsb, long long qsh, long long qst,
                     long long ksb, long long ksh, long long kst,
                     long long vsb, long long vsh, long long vst,
                     long long dsb, long long dsh, long long dst,
                     float scale, int causal, int window) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::do_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sdP = reinterpret_cast<float*>(smem + L::dp_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off);
  bf16* sdS = reinterpret_cast<bf16*>(smem + L::ds_off);
  float* sdK = reinterpret_cast<float*>(smem + L::dk_off);
  float* sdV = reinterpret_cast<float*>(smem + L::dv_off);
  float* sLse = reinterpret_cast<float*>(smem + L::stat_off);
  float* sDelta = sLse + BQ;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1);   // this thread's key row
  const int half = lane & 1;                 // ... and which half of it
  const int k0 = blockIdx.x * BK;
  const int kpos = k0 + row;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const bf16* qp = q + b * qsb + h * qsh;
  const bf16* kp = k + b * ksb + h * ksh;
  const bf16* vp = v + b * vsb + h * vsh;
  const bf16* dop = dout + b * dsb + h * dsh;
  const float* lse_bh = lse + (long long)bh * Tq;
  const float* delta_bh = delta + (long long)bh * Tq;
  const bool key_ok = kpos < Tk;
  const bool has_bias = bias != nullptr && key_ok;
  const float bias_k = has_bias ? bias[(long long)b * Tk + kpos] : 0.f;

  // The live q-range of this k-block: causal queries start at the block's
  // own diagonal; under a window they end W - 1 past its last key.
  const int q_begin = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(Tq, k0 + BK - 1 + window) : Tq;
  const int qb_begin = q_begin / BQ;
  const int qb_end = (q_end + BQ - 1) / BQ;

  load_tile<D>(sK, kp, kst, k0, Tk);
  load_tile<D>(sV, vp, vst, k0, Tk);
  float* dkrow = sdK + row * L::LDA + half * (D / 2);
  float* dvrow = sdV + row * L::LDA + half * (D / 2);
#pragma unroll
  for (int c = 0; c < D / 2; ++c) {
    dkrow[c] = 0.f;
    dvrow[c] = 0.f;
  }

  const float* srow = sS + row * L::LDS + half * 32;
  const float* dprow = sdP + row * L::LDS + half * 32;
  bf16* prow = sP + row * L::LDP + half * 32;
  bf16* dsrow = sdS + row * L::LDP + half * 32;

  for (int qb = qb_begin; qb < qb_end; ++qb) {
    const int qbase = qb * BQ;
    __syncthreads();  // every warp is done with the previous Q/dO/stats
    load_tile<D>(sQ, qp, qst, qbase, Tq);
    load_tile<D>(sdO, dop, dst, qbase, Tq);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const int qq = qbase + i;
      // padded query rows take lse -inf: their P is 0
      sLse[i] = qq < Tq ? lse_bh[qq] : -INFINITY;
      sDelta[i] = qq < Tq ? delta_bh[qq] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows.
    warp_abt<D>(sS + warp * 16 * L::LDS, L::LDS, sK + warp * 16 * L::LDT, sQ);
    warp_abt<D>(sdP + warp * 16 * L::LDS, L::LDS, sV + warp * 16 * L::LDT, sdO);
    __syncwarp();

    // P^T and dS^T over this thread's half row, both cast to bf16.
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const int qpos = qbase + col;
      float s = score_ok(qpos, kpos, Tk, causal, window) ? srow[c] * scale
                                                         : -INFINITY;
      if (has_bias) s += bias_k;
      const float l = sLse[col];
      const float p = (l == -INFINITY) ? 0.f : expf(s - l);
      prow[c] = __float2bfloat16(p);
      dsrow[c] = __float2bfloat16(p * (dprow[c] - sDelta[col]) * scale);
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q (dO and Q row-major [BQ, D]).
    warp_acc_ab_smem<D>(sdV + warp * 16 * L::LDA, sP + warp * 16 * L::LDP, sdO);
    warp_acc_ab_smem<D>(sdK + warp * 16 * L::LDA, sdS + warp * 16 * L::LDP, sQ);
    __syncwarp();
  }

  __syncwarp();
  if (key_ok) {
    bf16* krow = dk + ((long long)bh * Tk + kpos) * D + half * (D / 2);
    bf16* vrow = dv + ((long long)bh * Tk + kpos) * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) {
      krow[c] = __float2bfloat16(dkrow[c]);
      vrow[c] = __float2bfloat16(dvrow[c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *bias;
  int B, H, Tq, Tk;
  long long qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, dsb, dsh, dst;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <int D>
int launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = DqLayout<D>::bytes;
  // Above 48 KB a launch needs the opt-in, or it is refused and never runs.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (const float*)a.bias, (bf16*)dq, a.H, a.Tq, a.Tk, a.qsb, a.qsh, a.qst,
      a.ksb, a.ksh, a.kst, a.vsb, a.vsh, a.vst, a.dsb, a.dsh, a.dst, a.scale,
      a.causal, a.window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = DkvLayout<D>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.Tk + BK - 1) / BK, a.B * a.H);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (const float*)a.bias, (bf16*)dk, (bf16*)dv, a.H, a.Tq, a.Tk, a.qsb,
      a.qsh, a.qst, a.ksb, a.ksh, a.kst, a.vsb, a.vsh, a.vst, a.dsb, a.dsh,
      a.dst, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,H,Tq,D], k/v [B,H,Tk,D] and dout [B,H,Tq,D] bf16 read through the
// given strides (elements; the last dim contiguous, every stride a
// multiple of 8); lse and delta [B*H,Tq] f32 contiguous; bias [B,Tk] f32
// or null. dq [B*H,Tq,D] bf16 contiguous. Launches on `stream` and
// returns cudaGetLastError().
int dtf_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          const void* bias, void* dq, int B, int H, int Tq,
                          int Tk, int D,
                          long long qsb, long long qsh, long long qst,
                          long long ksb, long long ksh, long long kst,
                          long long vsb, long long vsh, long long vst,
                          long long dsb, long long dsh, long long dst,
                          float scale, int causal, int window, void* stream) {
  if (B * H == 0 || Tq == 0) return 0;
  const Args a{q, k, v, dout, lse, delta, bias, B, H, Tq, Tk,
               qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, dsb, dsh, dst,
               scale, causal, window, (cudaStream_t)stream};
  switch (D) {
    case 64: return launch_dq<64>(a, dq);
    case 128: return launch_dq<128>(a, dq);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same inputs; dk and dv [B*H,Tk,D] bf16 contiguous.
int dtf_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* bias, void* dk,
                           void* dv, int B, int H, int Tq, int Tk, int D,
                           long long qsb, long long qsh, long long qst,
                           long long ksb, long long ksh, long long kst,
                           long long vsb, long long vsh, long long vst,
                           long long dsb, long long dsh, long long dst,
                           float scale, int causal, int window, void* stream) {
  if (B * H == 0 || Tk == 0) return 0;
  const Args a{q, k, v, dout, lse, delta, bias, B, H, Tq, Tk,
               qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, dsb, dsh, dst,
               scale, causal, window, (cudaStream_t)stream};
  switch (D) {
    case 64: return launch_dkv<64>(a, dk, dv);
    case 128: return launch_dkv<128>(a, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dtf_flash_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes one CTA takes at head dim D (0 if D is not
// supported); which = 0 for dQ, 1 for dK/dV.
long long dtf_flash_bwd_smem_bytes(int which, int D) {
  switch (D) {
    case 64: return (long long)(which ? DkvLayout<64>::bytes : DqLayout<64>::bytes);
    case 128: return (long long)(which ? DkvLayout<128>::bytes : DqLayout<128>::bytes);
    default: return 0;
  }
}

}  // extern "C"
