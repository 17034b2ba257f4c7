// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 statistics.
//
// Replaces: dtf_tpu/ops/flash_attention.py::_fwd_kernel (B1) and
// ::_fwd_kernel_hfold (B4), reached through _fwd. Same function: S = Q K^T
// * sm_scale in f32, -inf on keys >= t_k, on causal q < k and on
// out-of-window q - k >= W, plus a per-batch additive key-padding bias row;
// an online softmax with the -inf-safe running (m, l, acc); p is cast to
// bf16 before the P V product; out = acc / l in bf16 and lse = m + log(l)
// in f32. A row whose keys are all masked gives out 0 and lse -inf.
//
// Design (Hopper: wgmma, TMA, mbarriers; inline PTX from hopper.cuh, no
// CUTLASS). The dQ kernel of flash_bwd.cu without dP, with an online
// softmax:
// - One CTA of one warpgroup (128 threads) per (head group, 64-row
//   q-block): batch*head / block_h in grid x, the q-blocks in grid y, the
//   heaviest causal ones launched first. The TPU's sequential k grid axis
//   is a loop inside the CTA over the LIVE k-blocks only (up to the
//   diagonal when causal, from the first in-window block under a window:
//   _block_live and the Mosaic DMA-elision index maps).
// - Q is loaded once per head by TMA; the K and V tiles of the live
//   k-blocks stream through a 2-stage mbarrier ring (4-D tensor maps over
//   (D, T, H, B) built per call from the operands' strides, 128-byte
//   swizzled, rows past T zero-filled). One thread issues the loads and
//   re-arms a stage once the warpgroup's barrier has freed it, so block
//   i + 2's tiles land while block i is computed.
// - Per k-block: S = Q K^T as wgmma m64n64k16 (A and B from shared memory,
//   both K-major); the scores scaled to log2 units with the bias row added
//   (masking only on the blocks that cross the diagonal, the window edge or
//   the ragged t_k); the online softmax in the accumulator registers, where
//   each thread holds 2 rows x 16 columns: the row max reduces over the
//   thread's values, then across its quad (__shfl_xor_sync 1 and 2), alpha
//   = exp2(m_old - m_new) rescales O's registers, and the row sum stays a
//   per-thread partial until the end; P packed in place into the bf16 A
//   fragments; O += P V as wgmma with A from registers and V's tile read
//   MN-major. O stays in registers (32 f32 a thread at D 64, 64 at D 128)
//   and is written once; rows past t_q are never stored. TMA's zero rows
//   score 0, not -inf, so the key-range mask stays on the ragged block.
// - block_h > 1 (B4): the CTA walks block_h heads of one batch in turn
//   through one flat sequence of (head, k-block) steps, so the ring's stage
//   and phase run on across heads and the next head's first K/V tiles are
//   in flight during this head's last blocks; Q is reloaded after the
//   barrier that ends a head's last block, when no warp still reads it.
//   The per-head code is block_h = 1's, so the outputs are bitwise equal.
// - Registers a thread (ptxas -v, nvcc 12.9, sm_90a; chip_smoke.py's build
//   phase prints them): 112 at D 64, 140 at D 128, 0 bytes of spill in
//   both. Shared memory a CTA: 42,520 bytes at D 64 (Q, two K/V stages,
//   the staged bias, the barriers, the 1 KB alignment pad) and 83,480 at
//   D 128. So 4 CTAs fit an SM at D 64 (registers bind; shared memory
//   would take 5) and 2 at D 128 (shared memory binds).
//
// Bounds on the H100 (989 TF/s bf16, 3.35 TB/s), causal, D 64: at the
// serving shape [4, 12, 1024, 64], q/k/v/out and lse are 25.4 MB (7.6 us)
// and the two causal-live products 6.45 GFLOP (6.5 us); at the training
// shape [8, 12, 1024, 64], 50.7 MB (15.1 us) and 12.9 GFLOP (13.0 us). Both
// are bound by bytes, with the products close behind: at the ridge.
//
// What the design still leaves on the table: no producer warp (one thread
// issues the loads between blocks); no ping-pong between two consumer
// warpgroups, and no overlap of block j's softmax with block j + 1's
// Q K^T, so the tensor cores idle while the exponentials run (the CTAs
// resident on an SM overlap one another instead); the out stores are
// 4-byte pairs from the accumulator layout, not staged through shared
// memory and stored by TMA.

#include "hopper.cuh"  // the shared Hopper helpers (TMA, mbarriers, wgmma)

namespace {

constexpr int BQ = 64;        // query rows per CTA (wgmma M)
constexpr int BK = 64;        // keys per streamed block
constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;     // ring depth of the K/V tiles
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct FwdSmem {
  static constexpr uint32_t tile = TileOf<D>::bytes;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t ring = q + tile;                  // stage s: K, then V
  static constexpr uint32_t bias = ring + STAGES * 2 * tile;  // f32 [STAGES][BK]
  static constexpr uint32_t bars = bias + STAGES * BK * 4;    // q, full[STAGES]
  static constexpr uint32_t bytes = bars + (1 + STAGES) * 8;
};

// S -> log2-unit scores in place: s * sm_scale * log2(e) plus the bias row
// (already in log2 units, per column, from shared memory); -inf where
// _score_mask drops the pair.
template <bool MASK>
__device__ __forceinline__ void log2_scores(float (&s)[32], const float* bias2,
                                            const int (&qpos)[2], int kcol0,
                                            int quad, float sl2, int Tk,
                                            int causal, int window) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(bias2 + 8 * j + 2 * quad);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * i + c];
        float v = fmaf(x, sl2, c ? bj.y : bj.x);
        if (MASK && !score_ok(qpos[i], kcol0 + 8 * j + c, Tk, causal, window)) {
          v = -INFINITY;
        }
        x = v;
      }
    }
  }
}

// One online-softmax step over a block's log2 scores, for this thread's two
// rows: the running max m (reduced across the quad that shares a row), the
// rescale alpha of everything summed so far, x -> p = exp2(x - m) in place,
// and l = alpha l + this thread's part of the row sum. m stays -inf while a
// row has seen only masked keys; exp2 then runs against 0, never -inf - -inf.
__device__ __forceinline__ void softmax_step(float (&x)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx = fmaxf(mx, fmaxf(x[4 * j + 2 * i], x[4 * j + 2 * i + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
    alpha[i] = exp2f(m[i] - m_safe);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& v = x[4 * j + 2 * i + c];
        v = exp2f(v - m_safe);
        sum += v;
      }
    }
    l[i] = alpha[i] * l[i] + sum;
    m[i] = m_new;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int Tq, int Tk, float scale,
                 int causal, int window, int block_h) {
  using L = FwdSmem<D>;
  constexpr int A = TileOf<D>::atoms;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  float* sBias = reinterpret_cast<float*>(smem_raw + (sbase - raw) + L::bias);
  const uint32_t sQ = sbase + L::q;
  const uint32_t bar_q = sbase + L::bars;
  const uint32_t bar_full = bar_q + 8;  // + 8 s

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int bh0 = blockIdx.x * block_h;  // the CTA's first batch*head
  const int b = bh0 / H;                 // block_h divides H: one batch
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const float* brow = bias ? bias + (long long)b * Tk : nullptr;

  // The live k-range of this q-block (empty when a window ends before t_k
  // begins: every row is then dead), and the CTA's flat (head, k-block)
  // steps.
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int kb_begin = k_begin / BK;
  const int n_blocks = max(0, (k_end + BK - 1) / BK - kb_begin);
  const int total = block_h * n_blocks;

  // This thread's two query rows.
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q0 + 16 * warp + (lane >> 2) + 8 * i;

  // The bias (log2 units) of key `tid` of step g's block; 0 without a row.
  auto bias_of = [&](int g) {
    const int kp = (kb_begin + g % n_blocks) * BK + tid;
    return (brow && kp < Tk) ? brow[kp] * LOG2E : 0.f;
  };
  auto issue_kv = [&](int g) {
    const int s = g % STAGES;
    const int hh = g / n_blocks;
    const uint32_t bar = bar_full + 8 * s;
    const uint32_t dst = sbase + L::ring + s * 2 * L::tile;
    const int row = (kb_begin + g - hh * n_blocks) * BK;
    const int h = (bh0 + hh) % H;
    mbar_expect_tx(bar, 2 * L::tile);
    tma_tile<D>(dst, &tm_k, bar, row, h, b);
    tma_tile<D>(dst + L::tile, &tm_v, bar, row, h, b);
  };
  auto issue_q = [&](int hh) {
    mbar_expect_tx(bar_q, L::tile);
    tma_tile<D>(sQ, &tm_q, bar_q, q0, (bh0 + hh) % H, b);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= STAGES; ++s) mbar_init(bar_q + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < BK && n_blocks > 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) sBias[s * BK + tid] = bias_of(s);
  }
  __syncthreads();
  if (tid == 0 && n_blocks > 0) {
    issue_q(0);
    for (int g = 0; g < STAGES && g < total; ++g) issue_kv(g);
  }

  const float sl2 = scale * LOG2E;
  float acc[A][32];
  for (int hh = 0; hh < block_h; ++hh) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[a][e] = 0.f;
    }
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    if (n_blocks > 0) mbar_wait(bar_q, hh & 1);

    for (int i = 0; i < n_blocks; ++i) {
      const int g = hh * n_blocks + i;
      const int s = g % STAGES;
      const int kbase = (kb_begin + i) * BK;
      const uint32_t sK = sbase + L::ring + s * 2 * L::tile;
      const uint32_t sV = sK + L::tile;
      // Next-but-one step's bias, read now, stored after the products.
      const bool next_bias = brow && tid < BK && g + STAGES < total;
      const float nb = next_bias ? bias_of(g + STAGES) : 0.f;
      mbar_wait(bar_full + 8 * s, (g / STAGES) & 1);
      __syncwarp();

      // S = Q K^T.
      float sacc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(sacc, kmajor<D>(sQ, kk), kmajor<D>(sK, kk), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(sacc);

      const bool mask = kbase + BK > Tk ||
                        (causal && kbase + BK - 1 > q0) ||
                        (causal && window > 0 && q0 + BQ - 1 - kbase >= window);
      const float* bias2 = sBias + s * BK;
      if (mask) {
        log2_scores<true>(sacc, bias2, qpos, kbase + 2 * quad, quad, sl2, Tk,
                          causal, window);
      } else {
        log2_scores<false>(sacc, bias2, qpos, kbase + 2 * quad, quad, sl2, Tk,
                           causal, window);
      }
      float alpha[2];
      softmax_step(sacc, m, l, alpha);
#pragma unroll
      for (int a = 0; a < A; ++a) {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[a][e] *= alpha[(e >> 1) & 1];
      }
      uint32_t pf[4][4];
      to_a_frags(sacc, pf);
      reg_fence(pf);
#pragma unroll
      for (int a = 0; a < A; ++a) reg_fence(acc[a]);

      // O += P V.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int a = 0; a < A; ++a) {
          wgmma_rs(acc[a], pf[kk], mnmajor<D>(sV, kk, a));
        }
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int a = 0; a < A; ++a) reg_fence(acc[a]);

      __syncthreads();  // every warp is done with stage s (and, last, Q)
      // Read in step g + STAGES, after the next step's barrier.
      if (next_bias) sBias[s * BK + tid] = nb;
      if (tid == 0 && g + STAGES < total) issue_kv(g + STAGES);
    }
    if (tid == 0 && n_blocks > 0 && hh + 1 < block_h) issue_q(hh + 1);

    // out [B*H, Tq, D] as bf16 pairs straight from the accumulator layout;
    // l == 0 (every key masked) gives out 0 and lse -inf.
    const long long bh = bh0 + hh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qpos[i] >= Tq) continue;
      const float l_safe = (l[i] == 0.f) ? 1.f : l[i];
      bf16* orow = out + (bh * Tq + qpos[i]) * D + 2 * quad;
#pragma unroll
      for (int a = 0; a < A; ++a) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(orow + 64 * a + 8 * j) =
              pack_bf16(acc[a][4 * j + 2 * i] / l_safe,
                        acc[a][4 * j + 2 * i + 1] / l_safe);
        }
      }
      if (quad == 0) {
        lse[bh * Tq + qpos[i]] =
            (l[i] == 0.f) ? -INFINITY : m[i] * LN2 + logf(l_safe);
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
  constexpr size_t smem = FwdSmem<D>::bytes + kAlignPad;
  // Above 48 KB a launch needs the opt-in, or it is refused and never runs.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, H, Tq, D, qsb, qsh, qst);
  if (!err) err = make_map(&tk, k, B, H, Tk, D, ksb, ksh, kst);
  if (!err) err = make_map(&tv, v, B, H, Tk, D, vsb, vsh, vst);
  if (err) return err;
  const dim3 grid((B * H) / block_h, (Tq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, (const float*)bias, (bf16*)out, (float*)lse, H, Tq, Tk,
      scale, causal, window, block_h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,H,Tq,D], k/v [B,H,Tk,D] bf16 read through the given strides
// (elements; the last dim contiguous, every stride a multiple of 8, the
// base 16-byte aligned); bias [B,Tk] f32 or null; out [B*H,Tq,D] bf16 and
// lse [B*H,Tq] f32, contiguous. Tk >= 1. Launches on `stream` and returns
// cudaGetLastError() (or the error of building the operands' TMA maps).
int dtf_flash_fwd_bf16(const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* lse,
                       int B, int H, int Tq, int Tk, int D,
                       long long qsb, long long qsh, long long qst,
                       long long ksb, long long ksh, long long kst,
                       long long vsb, long long vsh, long long vst,
                       float scale, int causal, int window, int block_h,
                       void* stream) {
  if (B * H == 0 || Tq == 0) return 0;
  if (Tk < 1 || block_h < 1 || H % block_h) return (int)cudaErrorInvalidValue;
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
    case 64: return (long long)(FwdSmem<64>::bytes + kAlignPad);
    case 128: return (long long)(FwdSmem<128>::bytes + kAlignPad);
    default: return 0;
  }
}

}  // extern "C"
