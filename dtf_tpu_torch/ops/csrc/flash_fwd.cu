// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 statistics.
//
// Replaces: dtf_tpu/ops/flash_attention.py::_fwd_kernel (B1) and
// ::_fwd_kernel_hfold (B4). Same function: S = Q K^T * sm_scale in f32,
// -inf on keys >= t_k, on causal q < k and on out-of-window q - k >= W,
// plus a per-batch additive key-padding bias row; an online softmax with
// the -inf-safe running (m, l, acc); p is cast to bf16 before the P V
// product; out = acc / l in bf16 and lse = m + log(l) in f32. A row whose
// keys are all masked gives out 0 and lse -inf.
//
// Design. One CTA of 4 warps per (head group, 64-row q-block); the TPU's
// sequential k grid axis becomes a loop inside the CTA over the LIVE
// k-blocks only (up to the diagonal when causal, from the first in-window
// block under a window), which replaces _block_live and the Mosaic
// DMA-elision index maps. Each k-block's K and V tiles are staged in
// shared memory; each warp owns 16 query rows: it computes its scores
// with bf16 WMMA fragments (f32 accumulate), runs the softmax update on
// them (two lanes per row), rescales its rows of the f32 accumulator in
// shared memory and adds P V with WMMA again. block_h > 1 (B4) makes one
// CTA walk block_h heads in turn; the per-head math is unchanged, so the
// outputs equal block_h = 1. The ragged edge is masked here: rows past
// t_k load as zeros and score -inf, rows past t_q are never written.
// Inputs are read through their (batch, head, seq) strides, so the
// wrapper never copies a transposed q/k/v.
//
// Bound on the H100 at the slice's shape (B=4, H=12, T=1024, D=64,
// causal): q/k/v/out are ~25 MB (~7.5 us at 3.35 TB/s) and the causal
// matmuls ~6.4 GFLOP (~6.5 us at 989 TF/s): about at the ridge.
//
// What this simple design leaves on the table: WMMA (mma.sync) instead
// of wgmma reaches a fraction of the tensor-core peak; K/V tiles are
// loaded synchronously by all threads (no TMA, no cp.async double
// buffering), so loads do not overlap compute; the scores and the
// accumulator round-trip through shared memory every k-block because
// WMMA fragment layouts are opaque; 64x64 tiles re-read K/V once per
// q-block from L2. A later kernel: TMA + mbarrier ring, wgmma with the
// accumulator in registers, producer/consumer warpgroups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per k-block
constexpr int WARPS = 4;          // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D>
struct Layout {
  // Row strides in elements. The pads keep WMMA pointers 32-byte aligned
  // and shift consecutive rows across shared-memory banks.
  static constexpr int LDT = D + 8;    // bf16 q / k / v tiles
  static constexpr int LDS = BK + 4;   // f32 scores
  static constexpr int LDP = BK + 8;   // bf16 probabilities
  static constexpr int LDA = D + 4;    // f32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(sizeof(__nv_bfloat16) * BQ * LDT);
  static constexpr size_t v_off = k_off + align128(sizeof(__nv_bfloat16) * BK * LDT);
  static constexpr size_t s_off = v_off + align128(sizeof(__nv_bfloat16) * BK * LDT);
  static constexpr size_t p_off = s_off + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t a_off = p_off + align128(sizeof(__nv_bfloat16) * BQ * LDP);
  static constexpr size_t bytes = a_off + align128(sizeof(float) * BQ * LDA);
};

// Rows [base, base + 64) of a [rows, D] bf16 matrix with row stride `st`
// (elements; D contiguous) into shared memory, 16 bytes per thread and
// step. Rows at or past `limit` are written as zeros: they are masked
// out of the scores, and a zero V row keeps 0 * garbage out of P V.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int base, int limit) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < BQ * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (base + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(base + r) * st + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDT + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse,
                 int H, int Tq, int Tk,
                 long long qsb, long long qsh, long long qst,
                 long long ksb, long long ksh, long long kst,
                 long long vsb, long long vsh, long long vst,
                 float scale, int causal, int window, int block_h) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* sA = reinterpret_cast<float*>(smem + L::a_off);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 1);   // this thread's row in the tile
  const int half = lane & 1;                 // ... and which half of it
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + row;

  // The live k-range of this q-block.
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int kb_begin = k_begin / BK;
  const int kb_end = (k_end + BK - 1) / BK;

  float* srow = sS + row * L::LDS + half * (BK / 2);
  __nv_bfloat16* prow = sP + row * L::LDP + half * (BK / 2);
  float* arow = sA + row * L::LDA + half * (D / 2);

  for (int hh = 0; hh < block_h; ++hh) {
    const int bh = blockIdx.y * block_h + hh;
    const int b = bh / H;
    const int h = bh % H;
    const __nv_bfloat16* qp = q + b * qsb + h * qsh;
    const __nv_bfloat16* kp = k + b * ksb + h * ksh;
    const __nv_bfloat16* vp = v + b * vsb + h * vsh;
    const float* brow = bias ? bias + (long long)b * Tk : nullptr;

    __syncthreads();  // every warp is done with the previous head's tiles
    load_tile<D>(sQ, qp, qst, q0, Tq);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) arow[c] = 0.f;
    float m = -INFINITY;
    float l = 0.f;

    for (int kb = kb_begin; kb < kb_end; ++kb) {
      const int kbase = kb * BK;
      __syncthreads();  // every warp is done with the previous K/V tiles
      load_tile<D>(sK, kp, kst, kbase, Tk);
      load_tile<D>(sV, vp, vst, kbase, Tk);
      __syncthreads();

      // S = Q K^T for this warp's 16 rows (K row-major = K^T col-major).
      {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fill_fragment(fc, 0.f);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            wmma::load_matrix_sync(fa, sQ + warp * 16 * L::LDT + kk * 16, L::LDT);
            wmma::load_matrix_sync(fb, sK + n * 16 * L::LDT + kk * 16, L::LDT);
            wmma::mma_sync(fc, fa, fb, fc);
          }
          wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, fc, L::LDS,
                                  wmma::mem_row_major);
        }
      }
      __syncwarp();

      // Online softmax over this thread's half row (the _score_mask rule,
      // then the bias row, then the -inf-safe running max).
      float sv[BK / 2];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < BK / 2; ++c) {
        const int kpos = kbase + half * (BK / 2) + c;
        bool ok = kpos < Tk;
        if (causal) {
          ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && (qpos - kpos < window);
        }
        float s = ok ? srow[c] * scale : -INFINITY;
        if (brow != nullptr && kpos < Tk) s += brow[kpos];
        sv[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_next = fmaxf(m, mx);
      const float m_safe = (m_next == -INFINITY) ? 0.f : m_next;
      const float alpha = expf(m - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 2; ++c) {
        const float p = expf(sv[c] - m_safe);
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = alpha * l + sum;
      m = m_next;
#pragma unroll
      for (int c = 0; c < D / 2; ++c) arow[c] *= alpha;
      __syncwarp();

      // acc += P V for this warp's 16 rows.
      {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          float* ap = sA + warp * 16 * L::LDA + n * 16;
          wmma::load_matrix_sync(fc, ap, L::LDA, wmma::mem_row_major);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            wmma::load_matrix_sync(fa, sP + warp * 16 * L::LDP + kk * 16, L::LDP);
            wmma::load_matrix_sync(fb, sV + kk * 16 * L::LDT + n * 16, L::LDT);
            wmma::mma_sync(fc, fa, fb, fc);
          }
          wmma::store_matrix_sync(ap, fc, L::LDA, wmma::mem_row_major);
        }
      }
      __syncwarp();
    }

    // Finalize: l == 0 (every key masked) gives out 0 and lse -inf.
    if (qpos < Tq) {
      const float l_safe = (l == 0.f) ? 1.f : l;
      __nv_bfloat16* orow = out + ((long long)bh * Tq + qpos) * D + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) orow[c] = __float2bfloat16(arow[c] / l_safe);
      if (half == 0) {
        lse[(long long)bh * Tq + qpos] = (l == 0.f) ? -INFINITY : m + logf(l_safe);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, void* lse, int B, int H, int Tq, int Tk,
           long long qsb, long long qsh, long long qst,
           long long ksb, long long ksh, long long kst,
           long long vsb, long long vsh, long long vst,
           float scale, int causal, int window, int block_h, void* stream) {
  constexpr size_t smem = Layout<D>::bytes;
  // Above 48 KB a launch needs the opt-in, or it is refused and never runs.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Tq + BQ - 1) / BQ, (B * H) / block_h);
  flash_fwd_kernel<D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)bias, (__nv_bfloat16*)out, (float*)lse, H, Tq, Tk,
      qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, scale, causal, window, block_h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,H,Tq,D], k/v [B,H,Tk,D] bf16 read through the given strides
// (elements; the last dim contiguous, every stride a multiple of 8);
// bias [B,Tk] f32 or null; out [B*H,Tq,D] bf16 and lse [B*H,Tq] f32,
// contiguous. Launches on `stream` and returns cudaGetLastError().
int dtf_flash_fwd_bf16(const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* lse,
                       int B, int H, int Tq, int Tk, int D,
                       long long qsb, long long qsh, long long qst,
                       long long ksb, long long ksh, long long kst,
                       long long vsb, long long vsh, long long vst,
                       float scale, int causal, int window, int block_h,
                       void* stream) {
  if (B * H == 0 || Tq == 0) return 0;
  if (block_h < 1 || (B * H) % block_h) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, bias, out, lse, B, H, Tq, Tk, qsb, qsh, qst,
                        ksb, ksh, kst, vsb, vsh, vst, scale, causal, window,
                        block_h, stream);
    case 128:
      return launch<128>(q, k, v, bias, out, lse, B, H, Tq, Tk, qsb, qsh, qst,
                         ksb, ksh, kst, vsb, vsh, vst, scale, causal, window,
                         block_h, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* dtf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes one CTA of the kernel takes at head dim D (0 if D is
// not supported): lets the wrapper report what a refused launch asked for.
long long dtf_flash_fwd_smem_bytes(int D) {
  switch (D) {
    case 64: return (long long)Layout<64>::bytes;
    case 128: return (long long)Layout<128>::bytes;
    default: return 0;
  }
}

}  // extern "C"
