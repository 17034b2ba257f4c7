// Fused LM head + cross-entropy for Hopper (sm_90a): f32 operands, f32 sums.
//
// Replaces: dtf_tpu/ops/fused_ce.py::_fwd_kernel (B5), ::_dx_kernel (B6)
// and ::_dw_kernel (B7), with their shared ::_dlogits recompute. Same
// function: logits = x W^T tile by tile, never stored; B5 keeps an online
// logsumexp over the vocab and picks the target logit where the column IS
// the label (an out-of-range label picks 0); B6 and B7 rebuild
// dlogits = dce * (softmax - onehot) per tile from the saved lse and add
// dX += dlogits W (B6) or dW += dlogits^T x (B7). Columns >= V are -inf in
// the lse and 0 in every product; rows past N are never written.
//
// Layouts: x [N, D] and W [V, D] (nn.Linear.weight, the head's own
// layout, read through its row stride: no transposed copy), labels int32
// [N], lse / tgt / dce f32 [N]; dX [N, D] and dW [V, D] f32, contiguous.
//
// Precision. The reference head is an f32 Dense and the fused loss
// promises the monolithic path's numbers, so every product here is f32
// operands with f32 accumulation: SIMT FFMA register tiling, no TF32.
//
// Design. One tile routine serves all three kernels: a CTA of 8 warps
// OWNS R rows (B5: 64 tokens; B6: 32 tokens; B7: 32 vocab rows) and
// STREAMS 256-row tiles of the other operand (B5, B6: vocab rows of W;
// B7: token rows of x). The D axis is staged 16 deep through shared
// memory with cp.async, double buffered; warp w computes the logits of its
// R/8 owned rows against the 256 streamed rows, lane l holding the
// columns l, l+32, ..., l+224 (conflict-free float4 reads, and a row's
// reductions are warp shuffles). The TPU's sequential grid axis becomes
// the loop over streamed tiles inside the CTA, so every output is written
// once, with no atomics, as in the reference's dx / dW split:
//   B5  one CTA per 64 tokens, all vocab tiles; (m, l, tgt) per row in
//       registers; lse and tgt written once.
//   B6  one CTA per 32 tokens, all vocab tiles; the [32, D] dX
//       accumulator spread over the threads' registers (4 rows x D/32
//       columns each); written once.
//   B7  one CTA per 32 vocab rows, all token tiles; the [32, D] dW
//       accumulator likewise.
// In B6/B7 the tile's dlogits go through shared memory, transposed, and
// the accumulate product streams the same 256 rows again, 8 at a time.
//
// Bound on the H100 at GPT-2 small b8 s1024 (N 8192, D 768, V 50304): B5
// does one N x D x V product (0.63 TFLOP), B6 and B7 two each; their bytes
// (x, W, labels, stats, one output) are 0.2-0.3 GB. With f32-accurate
// products the floor is 3xTF32 on the tensor cores (3 x FLOPs at 495
// TF/s): 3.8 ms for B5, 7.7 ms for B6 and for B7. These SIMT kernels run
// on the 67 TF/s FFMA pipes instead, so they sit well above that floor;
// the later kernel is 3xTF32 wgmma with TMA-fed tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SB = 256;             // streamed rows per tile
constexpr int COLS = SB / 32;       // streamed rows per lane: l + 32 c
constexpr int BK = 16;              // depth of one staged slice of D
constexpr int LDK = BK + 4;         // padded staged row (floats)
constexpr int FWD_RPW = 8;          // B5: owned rows per warp (64 per CTA)
constexpr int BWD_RPW = 4;          // B6/B7: owned rows per warp (32 per CTA)
constexpr int BWD_R = WARPS * BWD_RPW;
constexpr int LDD = BWD_R + 4;      // padded row of the transposed dlogits
constexpr int KC = 8;               // streamed rows per staged chunk (B6/B7)
static_assert(BWD_RPW == 4, "B6/B7 move an owned-row quad as one float4");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // valid == false copies no bytes and zero-fills the 16 destination bytes
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  // every group but the one committed last has landed
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [base, base + rows) of a [*, D] f32 matrix (row stride ld), columns
// [k0, k0 + width), into shared memory with row stride ldst. Rows at or
// past `limit` are zero-filled.
__device__ __forceinline__ void stage_rows(float* dst, int ldst,
                                           const float* src, long long ld,
                                           int base, int limit, int rows,
                                           int k0, int width) {
  const int per_row = width / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row;
    const int c = (i % per_row) * 4;
    const bool ok = base + r < limit;
    const float* p = ok ? src + (long long)(base + r) * ld + k0 + c : src;
    cp_async16(dst + r * ldst + c, p, ok);
  }
}

// acc[r][c] = sum_d own[own0 + warp*RPW + r][d] * str[str0 + lane + 32c][d]
// over d < D (D a multiple of BK). `buf` holds two stages of
// (8*RPW + SB) * LDK floats. Ends with every warp done reading `buf`.
template <int RPW>
__device__ __forceinline__ void logits_tile(float (&acc)[RPW][COLS],
                                            float* buf, const float* own,
                                            long long ldo, int own0,
                                            int own_n, const float* str,
                                            long long lds, int str0,
                                            int str_n, int D) {
  constexpr int R = WARPS * RPW;
  constexpr int STAGE = (R + SB) * LDK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

  const int nk = D / BK;
  stage_rows(buf, LDK, own, ldo, own0, own_n, R, 0, BK);
  stage_rows(buf + R * LDK, LDK, str, lds, str0, str_n, SB, 0, BK);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      float* nxt = buf + ((kc + 1) & 1) * STAGE;
      stage_rows(nxt, LDK, own, ldo, own0, own_n, R, (kc + 1) * BK, BK);
      stage_rows(nxt + R * LDK, LDK, str, lds, str0, str_n, SB,
                 (kc + 1) * BK, BK);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* cur = buf + (kc & 1) * STAGE;
    const float* so = cur + warp * RPW * LDK;
    const float* ss = cur + R * LDK + lane * LDK;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 a[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        a[r] = *reinterpret_cast<const float4*>(so + r * LDK + k);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(ss + c * 32 * LDK + k);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          float s = acc[r][c];
          s = fmaf(a[r].x, b.x, s);
          s = fmaf(a[r].y, b.y, s);
          s = fmaf(a[r].z, b.z, s);
          s = fmaf(a[r].w, b.w, s);
          acc[r][c] = s;
        }
      }
    }
    __syncthreads();
  }
}

constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * 2 * (WARPS * FWD_RPW + SB) * LDK;
}

__global__ void __launch_bounds__(THREADS, 1)
fused_ce_fwd_kernel(const float* __restrict__ x, long long ldx,
                    const float* __restrict__ w, long long ldw,
                    const int* __restrict__ labels, float* __restrict__ lse,
                    float* __restrict__ tgt, int N, int V, int D) {
  constexpr int RPW = FWD_RPW;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * WARPS * RPW;

  int lab[RPW];
  float m[RPW], l[RPW], t[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int n = n0 + warp * RPW + r;
    lab[r] = n < N ? labels[n] : -1;
    m[r] = -INFINITY;
    l[r] = 0.f;
    t[r] = 0.f;
  }
  float acc[RPW][COLS];
  for (int v0 = 0; v0 < V; v0 += SB) {
    logits_tile<RPW>(acc, smem, x, ldx, n0, N, w, ldw, v0, V, D);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if (v0 + lane + 32 * c < V) mx = fmaxf(mx, acc[r][c]);
      mx = warp_max(mx);
      // the running max is -inf until the first live column: a 0
      // stand-in keeps exp(m - m_safe) at 0 instead of NaN
      const float m_next = fmaxf(m[r], mx);
      const float m_safe = (m_next == -INFINITY) ? 0.f : m_next;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int v = v0 + lane + 32 * c;
        if (v < V) {
          s += expf(acc[r][c] - m_safe);
          if (v == lab[r]) t[r] += acc[r][c];
        }
      }
      s = warp_sum(s);
      l[r] = expf(m[r] - m_safe) * l[r] + s;
      m[r] = m_next;
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const float picked = warp_sum(t[r]);
    const int n = n0 + warp * RPW + r;
    if (lane == 0 && n < N) {
      const float l_safe = (l[r] == 0.f) ? 1.f : l[r];
      lse[n] = m[r] + logf(l_safe);
      tgt[n] = picked;
    }
  }
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) *
         (2 * (BWD_R + SB) * LDK + SB * LDD + 2 * KC * D);
}

// B6 (OWN_TOKENS) and B7: out[own row] = sum over streamed rows of
// dlogits[token, vocab] * streamed row, where the owned rows are tokens
// (B6: out = dX, streamed = W) or vocab rows (B7: out = dW, streamed = x).
template <int D, bool OWN_TOKENS>
__device__ __forceinline__ void ce_bwd_body(
    float* smem, const float* __restrict__ x, long long ldx,
    const float* __restrict__ w, long long ldw,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ dce, float* __restrict__ out, int N, int V) {
  constexpr int RPW = BWD_RPW;
  constexpr int R = BWD_R;
  constexpr int G = D / 128;          // float4 groups per lane in a row
  float* s_logit = smem;
  float* s_dl = s_logit + 2 * (R + SB) * LDK;   // [SB][LDD]: dlogits^T
  float* s_str = s_dl + SB * LDD;               // 2 x [KC][D] streamed rows

  const float* own = OWN_TOKENS ? x : w;
  const long long ldo = OWN_TOKENS ? ldx : ldw;
  const int own_n = OWN_TOKENS ? N : V;
  const float* str = OWN_TOKENS ? w : x;
  const long long lds = OWN_TOKENS ? ldw : ldx;
  const int str_n = OWN_TOKENS ? V : N;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int own0 = blockIdx.x * R;

  // B6: the owned tokens' statistics, read once. A row past N reads
  // dce 0, so its dlogits are 0.
  float o_lse[RPW], o_dce[RPW];
  int o_lab[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int n = own0 + warp * RPW + r;
    const bool ok = OWN_TOKENS && n < N;
    o_lse[r] = ok ? lse[n] : 0.f;
    o_dce[r] = ok ? dce[n] : 0.f;
    o_lab[r] = ok ? labels[n] : -1;
  }

  float4 acc[RPW][G];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[r][g] = make_float4(0.f, 0.f, 0.f, 0.f);

  float lg[RPW][COLS];
  for (int s0 = 0; s0 < str_n; s0 += SB) {
    logits_tile<RPW>(lg, s_logit, own, ldo, own0, own_n, str, lds, s0, str_n,
                     D);

    // dlogits = dce * (exp(logit - lse) - onehot) on live columns, else 0
    // (the reference's _dlogits), stored transposed: s_dl[streamed][owned]
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int j = s0 + lane + 32 * c;             // streamed row
      float s_lse = 0.f, s_dce = 0.f;
      int s_lab = -1;
      if (!OWN_TOKENS && j < N) {
        s_lse = lse[j];
        s_dce = dce[j];
        s_lab = labels[j];
      }
      float d[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int vocab = OWN_TOKENS ? j : own0 + warp * RPW + r;
        const float t_lse = OWN_TOKENS ? o_lse[r] : s_lse;
        const float t_dce = OWN_TOKENS ? o_dce[r] : s_dce;
        const int t_lab = OWN_TOKENS ? o_lab[r] : s_lab;
        const bool live = vocab < V;
        const float p = live ? expf(lg[r][c] - t_lse) : 0.f;
        const float hot = (live && vocab == t_lab) ? 1.f : 0.f;
        d[r] = t_dce * (p - hot);
      }
      *reinterpret_cast<float4*>(s_dl + (lane + 32 * c) * LDD + warp * RPW) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();

    // acc[owned row] += sum_k dlogits^T[k][owned row] * streamed row k, the
    // live streamed rows of this tile, KC at a time (double buffered)
    const int live = min(SB, str_n - s0);
    const int nkc = (live + KC - 1) / KC;
    stage_rows(s_str, D, str, lds, s0, str_n, KC, 0, D);
    cp_async_commit();
    for (int kc = 0; kc < nkc; ++kc) {
      if (kc + 1 < nkc)
        stage_rows(s_str + ((kc + 1) & 1) * KC * D, D, str, lds,
                   s0 + (kc + 1) * KC, str_n, KC, 0, D);
      cp_async_commit();
      cp_async_wait_prev();
      __syncthreads();
      const float* cur = s_str + (kc & 1) * KC * D + lane * 4;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(
            s_dl + (kc * KC + k) * LDD + warp * RPW);
        const float av[RPW] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 b =
              *reinterpret_cast<const float4*>(cur + k * D + g * 128);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            acc[r][g].x = fmaf(av[r], b.x, acc[r][g].x);
            acc[r][g].y = fmaf(av[r], b.y, acc[r][g].y);
            acc[r][g].z = fmaf(av[r], b.z, acc[r][g].z);
            acc[r][g].w = fmaf(av[r], b.w, acc[r][g].w);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = own0 + warp * RPW + r;
    if (row < own_n) {
      float* o = out + (long long)row * D + lane * 4;
#pragma unroll
      for (int g = 0; g < G; ++g)
        *reinterpret_cast<float4*>(o + g * 128) = acc[r][g];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fused_ce_dx_kernel(const float* __restrict__ x, long long ldx,
                   const float* __restrict__ w, long long ldw,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse,
                   const float* __restrict__ dce, float* __restrict__ dx,
                   int N, int V) {
  extern __shared__ __align__(16) float smem[];
  ce_bwd_body<D, true>(smem, x, ldx, w, ldw, labels, lse, dce, dx, N, V);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fused_ce_dw_kernel(const float* __restrict__ x, long long ldx,
                   const float* __restrict__ w, long long ldw,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse,
                   const float* __restrict__ dce, float* __restrict__ dw,
                   int N, int V) {
  extern __shared__ __align__(16) float smem[];
  ce_bwd_body<D, false>(smem, x, ldx, w, ldw, labels, lse, dce, dw, N, V);
}

template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  // above 48 KB a launch needs the opt-in, or it is refused and never runs
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_bwd(bool dx, const void* x, long long ldx, const void* w,
               long long ldw, const void* labels, const void* lse,
               const void* dce, void* out, int N, int V, void* stream) {
  constexpr size_t smem = bwd_smem_bytes<D>();
  static const int attr_dx = opt_in(fused_ce_dx_kernel<D>, smem);
  static const int attr_dw = opt_in(fused_ce_dw_kernel<D>, smem);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dx) {
    if (attr_dx) return attr_dx;
    fused_ce_dx_kernel<D><<<(N + BWD_R - 1) / BWD_R, THREADS, smem, s>>>(
        (const float*)x, ldx, (const float*)w, ldw, (const int*)labels,
        (const float*)lse, (const float*)dce, (float*)out, N, V);
  } else {
    if (attr_dw) return attr_dw;
    fused_ce_dw_kernel<D><<<(V + BWD_R - 1) / BWD_R, THREADS, smem, s>>>(
        (const float*)x, ldx, (const float*)w, ldw, (const int*)labels,
        (const float*)lse, (const float*)dce, (float*)out, N, V);
  }
  return (int)cudaGetLastError();
}

int dispatch_bwd(bool dx, const void* x, long long ldx, const void* w,
                 long long ldw, const void* labels, const void* lse,
                 const void* dce, void* out, int N, int V, int D,
                 void* stream) {
  if (N == 0 || V == 0) return 0;
  switch (D) {
    case 768:
      return launch_bwd<768>(dx, x, ldx, w, ldw, labels, lse, dce, out, N, V,
                             stream);
    case 1024:
      return launch_bwd<1024>(dx, x, ldx, w, ldw, labels, lse, dce, out, N,
                              V, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [N, D] and w [V, D] f32 with row strides ldx, ldw (elements; the last
// dim contiguous, every stride a multiple of 4, 16-byte aligned bases);
// labels int32 [N]; lse and tgt f32 [N], contiguous. D a multiple of 16.
// Launches on `stream` and returns cudaGetLastError().
int dtf_fused_ce_fwd_f32(const void* x, long long ldx, const void* w,
                         long long ldw, const void* labels, void* lse,
                         void* tgt, int N, int V, int D, void* stream) {
  if (N == 0) return 0;
  if (V == 0 || D % BK) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = fwd_smem_bytes();
  static const int attr = opt_in(fused_ce_fwd_kernel, smem);
  if (attr) return attr;
  const int rows = WARPS * FWD_RPW;
  fused_ce_fwd_kernel<<<(N + rows - 1) / rows, THREADS, smem,
                        (cudaStream_t)stream>>>(
      (const float*)x, ldx, (const float*)w, ldw, (const int*)labels,
      (float*)lse, (float*)tgt, N, V, D);
  return (int)cudaGetLastError();
}

// The contract of dtf_fused_ce_fwd_f32 plus lse and dce f32 [N]; dx is
// [N, D] f32 contiguous. D is 768 or 1024.
int dtf_fused_ce_dx_f32(const void* x, long long ldx, const void* w,
                        long long ldw, const void* labels, const void* lse,
                        const void* dce, void* dx, int N, int V, int D,
                        void* stream) {
  return dispatch_bwd(true, x, ldx, w, ldw, labels, lse, dce, dx, N, V, D,
                      stream);
}

// As dtf_fused_ce_dx_f32; dw is [V, D] f32 contiguous.
int dtf_fused_ce_dw_f32(const void* x, long long ldx, const void* w,
                        long long ldw, const void* labels, const void* lse,
                        const void* dce, void* dw, int N, int V, int D,
                        void* stream) {
  return dispatch_bwd(false, x, ldx, w, ldw, labels, lse, dce, dw, N, V, D,
                      stream);
}

const char* dtf_fused_ce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes one CTA takes: which 0 = B5, 1 = B6, 2 = B7 (0 for
// a head width the backward kernels are not compiled for).
long long dtf_fused_ce_smem_bytes(int which, int D) {
  if (which == 0) return (long long)fwd_smem_bytes();
  switch (D) {
    case 768: return (long long)bwd_smem_bytes<768>();
    case 1024: return (long long)bwd_smem_bytes<1024>();
    default: return 0;
  }
}

}  // extern "C"
