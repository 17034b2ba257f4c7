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
// Design (Hopper: wgmma, TMA, mbarriers; inline PTX, no CUTLASS). Two
// kernels, the JAX package's split, with nothing summed across CTAs (no
// atomics), so the result is bitwise deterministic:
// - dQ: one CTA of one warpgroup (128 threads) per (batch*head, 64-row
//   q-block). Q and dO are loaded once; the K and V tiles of the LIVE
//   k-blocks (up to the diagonal when causal, from the first in-window
//   block under a window: _block_live and _kv_sticky_map) stream through
//   a 2-stage ring. Per k-block: S = Q K^T and dP = dO V^T as
//   wgmma m64n64k16 (A and B from shared memory, both K-major), dS formed
//   in the accumulator registers and converted in place to the bf16 A
//   fragment of dQ += dS K (B = the K tile, MN-major). dQ stays in
//   registers and is written once.
// - dK/dV: one CTA of one warpgroup per (batch*head, 64-key block). K and
//   V are loaded once; the Q and dO tiles of the live q-blocks (from the
//   block's own diagonal, and only while within the window) stream
//   through the ring, lse and Delta beside them. Per q-block:
//   S^T = K Q^T and dP^T = V dO^T (shared-memory operands), P^T and dS^T
//   formed in registers (lse and Delta are per column here), then
//   dV += P^T dO and dK += dS^T Q with A from registers and B the dO / Q
//   tile read MN-major (the descriptor's transpose bit). dK and dV stay
//   in registers and are written once.
// - Tiles: 64 x 64 (wgmma M = 64, one warpgroup), 2 ring stages. Every
//   tile is moved by TMA (cp.async.bulk.tensor, 4-D maps over
//   (D, T, H, B) built on the host for each call from the operands'
//   strides, so dO's transposed view is read as it lies) into 128-byte
//   swizzled shared memory that the wgmma descriptors read directly
//   (D = 128: two 64-column swizzle atoms). Rows past T are zero-filled
//   by the hardware. One thread issues the loads; an mbarrier per stage
//   reports them; the next-but-one block's loads are issued as soon as
//   the warpgroup has released the stage, so they overlap this block's
//   products. No producer warp is split off: issuing costs one thread
//   a few instructions per block, and the consumer keeps every register.
// - The causal blocks are launched heaviest first (the last q-blocks in
//   dQ, the first k-blocks in dK/dV), batch*head in grid x, so the tail
//   of the grid is short. Masking runs only on the blocks that cross the
//   diagonal, the window edge or the ragged t_k; a dead or padded query
//   row takes lse = +inf inside the kernel, which makes its P exactly 0.
// - Registers a thread (ptxas -v, nvcc 12.9, sm_90a; chip_smoke.py's
//   build phase prints them): dQ 126 (D 64) / 156 (D 128), dK/dV 168 /
//   234; 0 bytes of spill in all four. Shared memory a CTA: 50,712 bytes
//   (dQ) and 51,224 (dK/dV) at D 64, so up to 4 and 3 CTAs fit on an SM.
//   This source builds in ~13 s (inline PTX only).
//
// Bounds on the H100 at the training slice's shape (q/k/v
// [8, 12, 1024, 64] bf16, causal; 989 TF/s bf16, 3.35 TB/s):
// - dQ (B2): three causal-halved T*T*D products, ~19.3 GFLOP (19.5 us);
//   q, k, v, dO, lse, Delta in and dq out, ~63.7 MB (19.0 us): ~19.5 us,
//   at the ridge.
// - dK/dV (B3): four products, ~25.8 GFLOP (26.1 us); ~76.3 MB (22.8 us):
//   ~26 us, compute.
//
// What the design still leaves on the table: the split does seven
// products where a fused kernel (dK/dV per CTA, dQ summed across CTAs by
// f32 atomics or TMA reduce-add) does five, at the price of determinism;
// Delta is a separate PyTorch pass over dO and O; one warpgroup per CTA
// serialises S/dP, the elementwise pass and the second products within a
// block (the CTAs resident on an SM overlap one another instead of two
// consumer warpgroups ping-ponging); the dQ stores are 4-byte pairs from
// the accumulator layout, not staged through shared memory.

#include "hopper.cuh"  // the shared Hopper helpers (TMA, mbarriers, wgmma)

namespace {

constexpr int BM = 64;        // rows of the CTA's own block (wgmma M)
constexpr int BN = 64;        // rows of each streamed block
constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;     // ring depth of the streamed tiles

template <int D>
struct DqSmem {
  static constexpr uint32_t tile = TileOf<D>::bytes;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + tile;
  static constexpr uint32_t ring = dout + tile;  // stage s: K, then V
  static constexpr uint32_t bias = ring + STAGES * 2 * tile;  // f32 [STAGES][BN]
  static constexpr uint32_t bars = bias + STAGES * BN * 4;    // qdo, full[STAGES]
  static constexpr uint32_t bytes = bars + (1 + STAGES) * 8;
};

template <int D>
struct DkvSmem {
  static constexpr uint32_t tile = TileOf<D>::bytes;
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + tile;
  static constexpr uint32_t ring = v + tile;  // stage s: Q, then dO
  static constexpr uint32_t stat = ring + STAGES * 2 * tile;  // f32 [STAGES][2][BN]
  static constexpr uint32_t bars = stat + STAGES * 2 * BN * 4;  // kv, full[STAGES]
  static constexpr uint32_t bytes = bars + (1 + STAGES) * 8;
};

// lse in log2 units for the exp2 of P; a dead or padded row takes +inf,
// so exp2(x - inf) = 0 and its P (and dS) is exactly 0 with no branch.
__device__ __forceinline__ float lse2_of(float l) {
  return l == -INFINITY ? INFINITY : l * LOG2E;
}

// S -> P in place for dQ (rows = queries, columns = keys): bias2 per
// column from shared memory, lse2 per row.
template <bool MASK>
__device__ __forceinline__ void dq_probs(float (&s)[32], const float* bias2,
                                         const float (&lse2)[2],
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
        float p = exp2f(fmaf(x, sl2, (c ? bj.y : bj.x) - lse2[i]));
        if (MASK && !score_ok(qpos[i], kcol0 + 8 * j + c, Tk, causal, window)) {
          p = 0.f;
        }
        x = p;
      }
    }
  }
}

// S^T -> P^T in place for dK/dV (rows = keys, columns = queries): lse2
// per column from shared memory, bias2 per row.
template <bool MASK>
__device__ __forceinline__ void dkv_probs(float (&s)[32], const float* lse2,
                                          const float (&bias2)[2],
                                          const int (&kpos)[2], int qcol0,
                                          int quad, float sl2, int Tk,
                                          int causal, int window) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lj = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * quad);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * i + c];
        float p = exp2f(fmaf(x, sl2, bias2[i] - (c ? lj.y : lj.x)));
        if (MASK && !score_ok(qcol0 + 8 * j + c, kpos[i], Tk, causal, window)) {
          p = 0.f;
        }
        x = p;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, bf16* __restrict__ dq,
                    int H, int Tq, int Tk, float scale, int causal,
                    int window) {
  using L = DqSmem<D>;
  constexpr int A = TileOf<D>::atoms;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  float* sBias = reinterpret_cast<float*>(smem_raw + (sbase - raw) + L::bias);
  const uint32_t bar_qdo = sbase + L::bars;
  const uint32_t bar_full = bar_qdo + 8;  // + 8 s

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const float* brow = bias ? bias + (long long)b * Tk : nullptr;

  // The live k-range of this q-block.
  const int k_end = causal ? min(Tk, q0 + BM) : Tk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int kb_begin = k_begin / BN;
  const int n_blocks = (k_end + BN - 1) / BN - kb_begin;

  // This thread's two query rows.
  int qpos[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + 16 * warp + (lane >> 2) + 8 * i;
    const bool ok = qpos[i] < Tq;
    lse2[i] = ok ? lse2_of(lse[(long long)bh * Tq + qpos[i]]) : INFINITY;
    dlt[i] = ok ? delta[(long long)bh * Tq + qpos[i]] : 0.f;
  }

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= STAGES; ++s) mbar_init(bar_qdo + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The bias row (in log2 units) of each stage's keys; zeros without one.
  if (tid < BN) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      const int kp = (kb_begin + s) * BN + tid;
      sBias[s * BN + tid] = (brow && kp < Tk) ? brow[kp] * LOG2E : 0.f;
    }
  }
  __syncthreads();

  auto issue_kv = [&](int i) {
    const int s = i % STAGES;
    const uint32_t bar = bar_full + 8 * s;
    const uint32_t dst = sbase + L::ring + s * 2 * L::tile;
    const int row = (kb_begin + i) * BN;
    mbar_expect_tx(bar, 2 * L::tile);
    tma_tile<D>(dst, &tm_k, bar, row, h, b);
    tma_tile<D>(dst + L::tile, &tm_v, bar, row, h, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_qdo, 2 * L::tile);
    tma_tile<D>(sbase + L::q, &tm_q, bar_qdo, q0, h, b);
    tma_tile<D>(sbase + L::dout, &tm_do, bar_qdo, q0, h, b);
    for (int i = 0; i < STAGES && i < n_blocks; ++i) issue_kv(i);
  }

  float acc[A][32];
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[a][e] = 0.f;
  }
  const float sl2 = scale * LOG2E;
  mbar_wait(bar_qdo, 0);

  for (int i = 0; i < n_blocks; ++i) {
    const int s = i % STAGES;
    const int kbase = (kb_begin + i) * BN;
    const uint32_t sK = sbase + L::ring + s * 2 * L::tile;
    const uint32_t sV = sK + L::tile;
    // Next-but-one stage's bias, read now, stored after the products.
    const bool next_bias = brow && tid < BN && i + STAGES < n_blocks;
    float nb = 0.f;
    if (next_bias) {
      const int kp = kbase + STAGES * BN + tid;
      nb = kp < Tk ? brow[kp] * LOG2E : 0.f;
    }
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
    __syncwarp();

    // S = Q K^T, dP = dO V^T.
    float sacc[32], dpacc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(sacc, kmajor<D>(sbase + L::q, kk), kmajor<D>(sK, kk), kk > 0);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(dpacc, kmajor<D>(sbase + L::dout, kk), kmajor<D>(sV, kk),
               kk > 0);
    }
    wg_commit();

    wg_wait<1>();
    reg_fence(sacc);
    const bool mask = kbase + BN > Tk ||
                      (causal && kbase + BN - 1 > q0) ||
                      (causal && window > 0 && q0 + BM - 1 - kbase >= window);
    const float* bias2 = sBias + s * BN;
    if (mask) {
      dq_probs<true>(sacc, bias2, lse2, qpos, kbase + 2 * quad, quad, sl2, Tk,
                     causal, window);
    } else {
      dq_probs<false>(sacc, bias2, lse2, qpos, kbase + 2 * quad, quad, sl2,
                      Tk, causal, window);
    }

    wg_wait<0>();
    reg_fence(dpacc);
    // dS = P (dP - Delta) sm_scale, as bf16 A fragments.
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sacc[e] = sacc[e] * (dpacc[e] - dlt[(e >> 1) & 1]) * scale;
    }
    uint32_t dsf[4][4];
    to_a_frags(sacc, dsf);
    reg_fence(dsf);
#pragma unroll
    for (int a = 0; a < A; ++a) reg_fence(acc[a]);

    // dQ += dS K.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        wgmma_rs(acc[a], dsf[kk], mnmajor<D>(sK, kk, a));
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int a = 0; a < A; ++a) reg_fence(acc[a]);

    __syncthreads();  // every warp is done with stage s
    // Read in iteration i + STAGES, after the next iteration's barrier.
    if (next_bias) sBias[s * BN + tid] = nb;
    if (tid == 0 && i + STAGES < n_blocks) issue_kv(i + STAGES);
  }

  // dq [B*H, Tq, D]: bf16 pairs straight from the accumulator layout.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= Tq) continue;
    bf16* orow = dq + ((long long)bh * Tq + qpos[i]) * D + 2 * quad;
#pragma unroll
    for (int a = 0; a < A; ++a) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 64 * a + 8 * j) =
            pack_bf16(acc[a][4 * j + 2 * i], acc[a][4 * j + 2 * i + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Tq, int Tk,
                     float scale, int causal, int window) {
  using L = DkvSmem<D>;
  constexpr int A = TileOf<D>::atoms;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  float* sStat = reinterpret_cast<float*>(smem_raw + (sbase - raw) + L::stat);
  const uint32_t bar_kv = sbase + L::bars;
  const uint32_t bar_full = bar_kv + 8;  // + 8 s

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * BM;  // causal: the first k-blocks are heaviest
  const float* lse_bh = lse + (long long)bh * Tq;
  const float* delta_bh = delta + (long long)bh * Tq;

  // The live q-range of this k-block: causal queries start at the block's
  // own diagonal; under a window they end W - 1 past its last key.
  const int q_begin = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(Tq, k0 + BM - 1 + window) : Tq;
  const int qb_begin = q_begin / BN;
  const int n_blocks = max(0, (q_end + BN - 1) / BN - qb_begin);

  // This thread's two key rows.
  int kpos[2];
  float bias2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = k0 + 16 * warp + (lane >> 2) + 8 * i;
    bias2[i] = (bias && kpos[i] < Tk)
                   ? bias[(long long)b * Tk + kpos[i]] * LOG2E : 0.f;
  }

  // Thread t < 64 stages lse (log2 units) of query t of a block, thread
  // 64 + t its Delta: stat[s][0][t], stat[s][1][t].
  const int srow = tid & (BN - 1);
  const bool is_lse = tid < BN;
  auto stat_of = [&](int qb) {
    const int qq = qb * BN + srow;
    if (qq >= Tq) return is_lse ? INFINITY : 0.f;
    return is_lse ? lse2_of(lse_bh[qq]) : delta_bh[qq];
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= STAGES; ++s) mbar_init(bar_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < n_blocks) sStat[s * 2 * BN + tid] = stat_of(qb_begin + s);
  }
  __syncthreads();

  auto issue_qdo = [&](int i) {
    const int s = i % STAGES;
    const uint32_t bar = bar_full + 8 * s;
    const uint32_t dst = sbase + L::ring + s * 2 * L::tile;
    const int row = (qb_begin + i) * BN;
    mbar_expect_tx(bar, 2 * L::tile);
    tma_tile<D>(dst, &tm_q, bar, row, h, b);
    tma_tile<D>(dst + L::tile, &tm_do, bar, row, h, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::tile);
    tma_tile<D>(sbase + L::k, &tm_k, bar_kv, k0, h, b);
    tma_tile<D>(sbase + L::v, &tm_v, bar_kv, k0, h, b);
    for (int i = 0; i < STAGES && i < n_blocks; ++i) issue_qdo(i);
  }

  float dka[A][32], dva[A][32];
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      dka[a][e] = 0.f;
      dva[a][e] = 0.f;
    }
  }
  const float sl2 = scale * LOG2E;
  mbar_wait(bar_kv, 0);

  for (int i = 0; i < n_blocks; ++i) {
    const int s = i % STAGES;
    const int qbase = (qb_begin + i) * BN;
    const uint32_t sQ = sbase + L::ring + s * 2 * L::tile;
    const uint32_t sdO = sQ + L::tile;
    const float* lse2 = sStat + s * 2 * BN;
    const float* dlt = lse2 + BN;
    // Next-but-one stage's lse / Delta, read now, stored after the products.
    const bool next_stat = i + STAGES < n_blocks;
    const float ns = next_stat ? stat_of(qb_begin + i + STAGES) : 0.f;
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
    __syncwarp();

    // S^T = K Q^T, dP^T = V dO^T.
    float sacc[32], dpacc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(sacc, kmajor<D>(sbase + L::k, kk), kmajor<D>(sQ, kk), kk > 0);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(dpacc, kmajor<D>(sbase + L::v, kk), kmajor<D>(sdO, kk), kk > 0);
    }
    wg_commit();

    wg_wait<1>();
    reg_fence(sacc);
    const bool mask = k0 + BM > Tk ||
                      (causal && k0 + BM - 1 > qbase) ||
                      (causal && window > 0 && qbase + BN - 1 - k0 >= window);
    if (mask) {
      dkv_probs<true>(sacc, lse2, bias2, kpos, qbase + 2 * quad, quad, sl2,
                      Tk, causal, window);
    } else {
      dkv_probs<false>(sacc, lse2, bias2, kpos, qbase + 2 * quad, quad, sl2,
                       Tk, causal, window);
    }
    uint32_t pf[4][4];
    to_a_frags(sacc, pf);
    reg_fence(pf);
#pragma unroll
    for (int a = 0; a < A; ++a) reg_fence(dva[a]);

    // dV += P^T dO (runs while dS^T is formed).
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        wgmma_rs(dva[a], pf[kk], mnmajor<D>(sdO, kk, a));
      }
    }
    wg_commit();

    wg_wait<1>();  // dP^T is done (dV may still run)
    reg_fence(dpacc);
    // dS^T = P^T (dP^T - Delta) sm_scale, Delta per column.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dj = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * quad);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * j + r;
        sacc[e] = sacc[e] * (dpacc[e] - ((r & 1) ? dj.y : dj.x)) * scale;
      }
    }
    uint32_t dsf[4][4];
    to_a_frags(sacc, dsf);
    reg_fence(dsf);
#pragma unroll
    for (int a = 0; a < A; ++a) reg_fence(dka[a]);

    // dK += dS^T Q.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        wgmma_rs(dka[a], dsf[kk], mnmajor<D>(sQ, kk, a));
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int a = 0; a < A; ++a) {
      reg_fence(dka[a]);
      reg_fence(dva[a]);
    }

    __syncthreads();  // every warp is done with stage s
    // Read in iteration i + STAGES, after the next iteration's barrier.
    if (next_stat) sStat[s * 2 * BN + tid] = ns;
    if (tid == 0 && i + STAGES < n_blocks) issue_qdo(i + STAGES);
  }

  // dk, dv [B*H, Tk, D]: bf16 pairs straight from the accumulator layout.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= Tk) continue;
    const long long off = ((long long)bh * Tk + kpos[i]) * D + 2 * quad;
#pragma unroll
    for (int a = 0; a < A; ++a) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * i;
        *reinterpret_cast<uint32_t*>(dk + off + 64 * a + 8 * j) =
            pack_bf16(dka[a][e], dka[a][e + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 64 * a + 8 * j) =
            pack_bf16(dva[a][e], dva[a][e + 1]);
      }
    }
  }
}

// ---- host ---------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *bias;
  int B, H, Tq, Tk, D;
  long long qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, dsb, dsh, dst;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

struct Maps {
  CUtensorMap q, k, v, dout;
};

int make_maps(const Args& a, Maps* m) {
  int err = make_map(&m->q, a.q, a.B, a.H, a.Tq, a.D, a.qsb, a.qsh, a.qst);
  if (!err) err = make_map(&m->k, a.k, a.B, a.H, a.Tk, a.D, a.ksb, a.ksh, a.kst);
  if (!err) err = make_map(&m->v, a.v, a.B, a.H, a.Tk, a.D, a.vsb, a.vsh, a.vst);
  if (!err) {
    err = make_map(&m->dout, a.dout, a.B, a.H, a.Tq, a.D, a.dsb, a.dsh, a.dst);
  }
  return err;
}

template <int D>
int launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = DqSmem<D>::bytes + kAlignPad;
  // Above 48 KB a launch needs the opt-in, or it is refused and never runs.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  Maps m;
  if (const int err = make_maps(a, &m)) return err;
  const dim3 grid(a.B * a.H, (a.Tq + BM - 1) / BM);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      m.q, m.k, m.v, m.dout, (const float*)a.lse, (const float*)a.delta,
      (const float*)a.bias, (bf16*)dq, a.H, a.Tq, a.Tk, a.scale, a.causal,
      a.window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = DkvSmem<D>::bytes + kAlignPad;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  Maps m;
  if (const int err = make_maps(a, &m)) return err;
  const dim3 grid(a.B * a.H, (a.Tk + BM - 1) / BM);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      m.q, m.k, m.v, m.dout, (const float*)a.lse, (const float*)a.delta,
      (const float*)a.bias, (bf16*)dk, (bf16*)dv, a.H, a.Tq, a.Tk, a.scale,
      a.causal, a.window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,H,Tq,D], k/v [B,H,Tk,D] and dout [B,H,Tq,D] bf16 read through the
// given strides (elements; the last dim contiguous, every stride a
// multiple of 8, the base 16-byte aligned); lse and delta [B*H,Tq] f32
// contiguous; bias [B,Tk] f32 or null. dq [B*H,Tq,D] bf16 contiguous.
// Launches on `stream` and returns cudaGetLastError() (or the error of
// building the operands' TMA maps).
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
  const Args a{q, k, v, dout, lse, delta, bias, B, H, Tq, Tk, D,
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
  const Args a{q, k, v, dout, lse, delta, bias, B, H, Tq, Tk, D,
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
    case 64:
      return (long long)(which ? DkvSmem<64>::bytes : DqSmem<64>::bytes) +
             (long long)kAlignPad;
    case 128:
      return (long long)(which ? DkvSmem<128>::bytes : DqSmem<128>::bytes) +
             (long long)kAlignPad;
    default: return 0;
  }
}

}  // extern "C"
