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
// layout, read through its row stride), labels int32 [N], lse / tgt / dce
// f32 [N]; dX [N, D] and dW [V, D] f32, contiguous.
//
// Precision. The reference head is an f32 Dense and the fused loss
// promises the monolithic path's numbers, so every product here is
// f32-accurate: 3xTF32 on the tensor cores. 3xTF32 splits each f32
// operand a into hi = tf32(a) (cvt.rna: 10 explicit mantissa bits, the
// low 13 bits 0) and lo = tf32(a - hi), and sums hi*hi' + hi*lo' + lo*hi'
// in f32: ~21 bits of each product, against ~11 for one TF32 pass, whose
// logit errors exp() would turn into relative errors of the
// probabilities.
//
// The split pass (fused_ce_split_kernel, one launch a forward) writes W's
// hi/lo as stored ([V, D]: B5's and B6's streamed B operand) and, when the
// backward will need them, W's and x's transposed hi/lo and x's stored
// hi/lo (below); the forward keeps them for the backward.
//
// B5 (wgmma, TMA, vocab parts). A CTA OWNS 128 tokens (two warpgroups of
// 64) and STREAMS blocks of BS = 192 vocab rows of one part of the vocab
// (PART_ROWS rows, grid y). Per block, S [128, BS] = x W^T runs as
// D / 32 chunks of tf32 wgmma m64n192k8: A = the owned x rows, raw f32
// from the slot, split in registers; B = W's stored hi and lo; every
// two chunks the tensor cores' partial sum (their f32 sums truncate) is
// added into the logits in IEEE f32. Warp 0
// keeps a 3-slot ring of 64 KB TMA tiles ([128 x | BS W hi | BS W lo] x
// 32 columns, 128-byte swizzled) in flight. The online logsumexp runs in
// the accumulator registers, as B1's softmax does: each thread holds two
// token rows and BS / 4 columns; the block max over the live columns is
// reduced across the quad that shares a row (m_safe = 0 while it is
// -inf), l = alpha l + sum exp(s - m_safe) stays per thread (summed over
// the quad once, at the end), and the target logit is added where the
// column IS the label. Columns >= V come back from TMA as zeros and are
// masked. Each part writes its (m, l, tgt) per token into a workspace
// [parts, 3, N]; fused_ce_merge_kernel combines the parts in part order:
// lse = M + log sum_p l_p exp(m_p - M), tgt = sum_p tgt_p. No atomics:
// two launches are bitwise equal. The parts fill the card: N / 128 = 64
// CTAs at the training shape, 33 parts of 1536 rows make 2112, 16 waves
// of one CTA an SM. The bound at GPT-2 small b8 s1024 (N 8192, D 768, V
// 50304) is one N x D x V product (0.63 TFLOP), 3 x that on the tensor
// cores: 3.84 ms at 495 TF/s. Its tile traffic from L2 is 64 x 262
// blocks x (128 x 768 x 4 bytes of x + BS x 768 x 8 of W) = 26.4 GB:
// W's split, read once per token block, is three quarters of it. The
// block width is what the registers allow: the accumulator and the
// logits are 2 x 96 registers at BS 192 (254 a thread, no spill); at 128
// B5 took 7.5 ms, at 256 (which spills) 5.8, at 192 5.9 (H100,
// profile_fused_ce.py).
//
// B6 / B7 (wgmma, TMA, a cluster across D). Both products of each kernel
// (the logits recompute, contracted over D, and the accumulate, over the
// vocab for B6 or the tokens for B7) run as tf32 wgmma m64nNk8. TF32
// wgmma reads only K-major operands from shared memory, so:
// - The split pass (one launch a forward, shared by B5, B6 and B7) has
//   written the STREAMED matrix's hi/lo as stored ([rows, D], the
//   recompute's B) and transposed ([D, rows_p], the accumulate's B), each
//   group of 8 transposed rows in the order 0, 2, 4, 6, 1, 3, 5, 7. B6
//   streams W's split, B7 x's.
// - The OWNED matrix is read raw (f32, through its row stride) and split
//   in registers as the recompute's A fragments.
// - dlogits are formed in the recompute's accumulator registers and split
//   there into the accumulate's A fragments. The f32 accumulator holds
//   columns 2q, 2q + 1 where the tf32 A fragment wants q, q + 4: the
//   permuted K order makes the registers line up with no shuffle.
// The output [own rows, D] is too large for one CTA's registers at
// D >= 384 (64 x 768 f32 is 75% of an SM's), so a cluster of C CTAs
// (D 384: 2 x 192 columns; 768: 3 x 256; 1024: 8 x 128) owns 128 rows:
// CTA r computes the partial logits over its DS columns of D, the C
// partials are summed in rank order through distributed shared memory
// (mapa / ld.shared::cluster, one cluster barrier a block), so every CTA
// holds the same S, and CTA r accumulates its DS columns of the output.
// No product is done twice, nothing is summed with atomics, and every
// output element is written once: two launches are bitwise equal.
// A CTA is two warpgroups (64 owned rows each, up to 255 registers a
// thread: the 128-register accumulator, S and the A fragments); warp 0
// also keeps a 4-slot ring of 32 KB TMA tiles (128-byte swizzled f32,
// 2-D tensor maps built on the host per call) in flight, refilling a slot
// as soon as all 8 warps have released it: per block of 64 streamed
// rows, DS / 32 chunks of [128 owned raw | 64 streamed hi | 64 streamed
// lo] x 32 columns for the recompute, then the transposed split's hi and
// lo for two chunks of 32 streamed rows. Rows past N or V come back from
// TMA as zeros; the streamed stats of B7 (lse, dce, label of 64 tokens)
// ride in a small ring beside the tiles.
// The tensor core's f32 sums truncate (round toward zero), so the error
// of one accumulator grows with the number of products summed into it:
// summed over V = 50304 vocab rows, B6's dX came out 1.5e-4 from the f32
// plain version (B7's dW over N = 8192 tokens 2.4e-5; H100, one run). A
// stream longer than PART_ROWS = 4096 rows is therefore cut into parts
// (grid y), each accumulated on its own into a workspace, and a second
// pass (fused_ce_sum_kernel) adds the parts in a fixed order. The parts
// also fill the card, which holds 39 of these clusters at once: at the
// training shape B6 has N / 128 = 64 clusters (1.6 waves), 13 parts make
// 832; B7 has 393 (10.1 waves), 2 parts make 786 (20.2).
//
// Bounds on the H100 at N 8192, D 768, V 50304 (495 TF/s TF32, 3.35
// TB/s): B6 and B7 do two N x D x V products each (1.27 TFLOP), 3 x that
// on the tensor cores: 7.68 ms each; their bytes (x, W, labels, stats,
// one output) are 0.2-0.3 GB. The split pass is bytes only: 0.9 GB
// (x and W read, four times that written), 0.27 ms; the merge of B5's
// parts too: 3.2 MB read, 0.001 ms.
//
// Registers a thread (cuobjdump -res-usage, sm_90a; the build phase of
// chip_smoke.py prints them): B6 248 / 214 / 210 and B7
// 254 / 242 / 254 at D 768 / 384 / 1024, no stack (no spill). Shared
// memory a CTA: 199,232 bytes, one CTA an SM.
//
// What the design still leaves on the table: the owned rows' raw chunks
// are streamed again for every block of 64 streamed rows (a third of the
// tile traffic; 128 rows x 256 columns of hi/lo would not fit beside the
// ring); the two warpgroups reach the cluster exchange and the dlogits at
// the same time, so the tensor cores idle there (a ping-pong of the two,
// or the next block's recompute issued before the exchange, needs
// registers this design spends on the 128-register accumulator).

#include "hopper.cuh"  // the shared Hopper helpers (TMA, mbarriers, wgmma, clusters)

namespace {

// ---- B5: 3xTF32 wgmma on TMA-fed tiles, the vocab cut into parts -------

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

namespace fwd {

constexpr int OWN = 128;      // owned tokens a CTA: two warpgroups of 64
#ifndef DTF_CE_FWD_BS         // (profile_fused_ce.py builds other widths)
#define DTF_CE_FWD_BS 192
#endif
constexpr int BS = DTF_CE_FWD_BS;  // streamed vocab rows a block
constexpr int KC = 32;        // f32 in one 128-byte swizzle row: a chunk
constexpr int THREADS = 256;  // two warpgroups; warp 0 also feeds the ring
constexpr uint32_t X_BYTES = OWN * KC * 4;  // owned raw chunk [128, 32]
constexpr uint32_t W_BYTES = BS * KC * 4;   // W hi (lo) chunk [BS, 32]
constexpr uint32_t SLOT = X_BYTES + 2 * W_BYTES;
// as many 1024-aligned slots as a CTA's 227 KB hold, at most 4 (3 at BS
// 192)
constexpr int STAGES = (232448 - 1024 - 64) / SLOT < 4
                           ? (232448 - 1024 - 64) / SLOT : 4;
// Vocab rows a part (a multiple of BS): at the training shape 33 parts of
// 64 token blocks are 2112 CTAs, 16 waves of 132.
constexpr int PART_ROWS = 1536;
// Chunks of D a tensor-core partial sum runs before it is added into the
// logits in IEEE f32: the tensor core's f32 sums truncate, and over all
// of D (288 truncating additions at D 768) the logits of W std 0.2 came
// out 2e-4 off (H100); the two warpgroups add theirs FLUSH / 2 chunks
// apart, so one keeps the tensor cores busy while the other drains.
#ifndef DTF_CE_FWD_FLUSH
#define DTF_CE_FWD_FLUSH 2
#endif
constexpr int FLUSH = DTF_CE_FWD_FLUSH;
static_assert(PART_ROWS % BS == 0 && BS % 64 == 0 && BS <= 256 &&
              STAGES >= 2, "B5 tiles");

struct Smem {
  static constexpr uint32_t ring = 0;                     // STAGES x SLOT
  static constexpr uint32_t bars = ring + STAGES * SLOT;  // full, empty
  static constexpr uint32_t bytes = bars + 2 * STAGES * 8;
};
constexpr size_t smem_bytes = Smem::bytes + kAlignPad;

// The operands' tensor maps, one kernel parameter (warp 0 alone reads
// them): x raw [N, D] in [128, 32] boxes, W's stored hi and lo [V, D] in
// [BS, 32] boxes.
struct Maps {
  CUtensorMap x, w_hi, w_lo;
};

inline int parts(int V) { return (V + PART_ROWS - 1) / PART_ROWS; }

}  // namespace fwd

// B5: for the CTA's 128 tokens and part blockIdx.y of the vocab, the
// running (max, sum of exp, target logit) over the part's live columns,
// into ws[part][0 / 1 / 2][token]. D a multiple of 32.
__global__ void __launch_bounds__(fwd::THREADS, 1)
fused_ce_fwd_kernel(const __grid_constant__ fwd::Maps maps,
                    const int* __restrict__ labels, float* __restrict__ ws,
                    int N, int V, int D) {
  using namespace fwd;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // full[s]: slot s landed (TMA bytes); empty[s]: the 8 warps are done
  // with it
  const uint32_t full = sbase + Smem::bars;
  const uint32_t empty = full + 8 * STAGES;

  const int nch = D / KC;  // chunks (ring slots) a block
  const int n0 = blockIdx.x * OWN;
  const int v_begin = blockIdx.y * PART_ROWS;
  const int v_end = min(V, v_begin + PART_ROWS);
  const int nblk = (v_end - v_begin + BS - 1) / BS;
  const int nseq = nblk * nch;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const bool issuer = tid < 32;  // warp 0 keeps the ring full

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Ring slot `seq` (block seq / nch, chunk seq % nch) into stage
  // seq % STAGES, once all 8 warps have released what it held; warp 0.
  auto issue = [&](int seq) {
    const int st = seq % STAGES;
    if (seq >= STAGES) mbar_wait(empty + 8 * st, (seq / STAGES - 1) & 1);
    if (lane == 0) {
      const uint32_t slot = sbase + Smem::ring + st * SLOT;
      const uint32_t bar = full + 8 * st;
      const int col = KC * (seq % nch);
      const int v0 = v_begin + (seq / nch) * BS;
      mbar_expect_tx(bar, SLOT);
      tma_box2d(slot, &maps.x, bar, col, n0);
      tma_box2d(slot + X_BYTES, &maps.w_hi, bar, col, v0);
      tma_box2d(slot + X_BYTES + W_BYTES, &maps.w_lo, bar, col, v0);
    }
    __syncwarp();
  };
  // Release stage seq % STAGES (this warp is done with it) and, on warp
  // 0, refill it with slot seq + STAGES.
  auto release = [&](int seq) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (seq % STAGES));
    if (issuer && seq + STAGES < nseq) issue(seq + STAGES);
  };
  if (issuer) {
    for (int seq = 0; seq < STAGES && seq < nseq; ++seq) issue(seq);
  }

  // This thread's token rows r0 and r0 + 8 of the CTA's 128; a label
  // outside [0, V) (or a row past N) matches no column.
  const int r0 = 64 * wg + 16 * warp + g;
  int lab[2];
  float m[2], l[2], t[2];  // l, t: this thread's columns only
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + r0 + 8 * h;
    const int y = n < N ? labels[n] : -1;
    lab[h] = (y >= 0 && y < V) ? y : -1;
    m[h] = -INFINITY;
    l[h] = 0.f;
    t[h] = 0.f;
  }

  float acc[BS / 2];  // the tensor cores' partial sum of FLUSH chunks
  float s[BS / 2];    // the logits: the partials added in IEEE f32
  for (int i = 0; i < nblk; ++i) {
    const int v0 = v_begin + i * BS;

    // 1. S [64 owned, BS streamed] over D: A = the owned rows, raw f32
    //    from the slot, split into tf32 hi/lo in registers; B = W's hi
    //    and lo. 3xTF32: hi*hi' + hi*lo' + lo*hi'. One k8 slice a group:
    //    each group's A fragments are read while the group before runs;
    //    a chunk's slot is released once its four groups are done. Every
    //    FLUSH chunks the partial is added into S and restarted.
    uint32_t ah[2][4], al[2][4];  // [group parity][reg]
#pragma unroll
    for (int e = 0; e < BS / 2; ++e) s[e] = 0.f;
    fence_regs(acc);
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      const int seq = i * nch + c;
      const uint32_t slot = sbase + Smem::ring + (seq % STAGES) * SLOT;
      const bool flush = c > 0 && (c + wg * (FLUSH / 2)) % FLUSH == 0;
      const bool fresh = c == 0 || flush;  // a new partial starts here
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t(&gh)[4] = ah[kk & 1];
        uint32_t(&gl)[4] = al[kk & 1];
        if (kk == 0 && flush) {
          wg_wait<0>();  // the partial is complete
          fence_regs(acc);
#pragma unroll
          for (int e = 0; e < BS / 2; ++e) s[e] += acc[e];
          fence_regs(acc);
        } else {
          wg_wait<1>();  // the group before last is done: its registers free
        }
        fence_regs(gh);
        fence_regs(gl);
        // the group before last was chunk c - 1's: that chunk is done
        if (kk == 1 && c > 0) release(seq - 1);
        if (kk == 0) mbar_wait(full + 8 * (seq % STAGES), (seq / STAGES) & 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // column 8 kk + q + 4 half: 16-byte chunk 2 kk + half of the
          // 128-byte row, swizzled by the row's low 3 bits (= g)
          const uint32_t at =
              slot + r0 * 128 + (((2 * kk + half) ^ g) << 4) + q * 4;
          split_tf32(lds(at), gh[2 * half], gl[2 * half]);
          split_tf32(lds(at + 8 * 128), gh[2 * half + 1], gl[2 * half + 1]);
        }
        const uint64_t bh = sw128_desc(slot + X_BYTES + 32 * kk);
        const uint64_t bl = sw128_desc(slot + X_BYTES + W_BYTES + 32 * kk);
        fence_regs(gh);
        fence_regs(gl);
        wg_fence();
        wgmma_tf32_rs(acc, gh, bh, kk != 0 || !fresh);
        wgmma_tf32_rs(acc, gh, bl, 1);
        wgmma_tf32_rs(acc, gl, bh, 1);
        wg_commit();
      }
    }
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(ah);
    fence_regs(al);
    release(i * nch + nch - 1);
#pragma unroll
    for (int e = 0; e < BS / 2; ++e) s[e] += acc[e];

    // 2. The online logsumexp over this block's live columns (vocab
    //    v0 + 8j + 2q + c holds element 4j + 2h + c of row r0 + 8h), in
    //    log2 units for exp2; the target logit where the column is the
    //    label.
    const bool all_live = v0 + BS <= V;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (all_live || v0 + 8 * j + 2 * q + c < V) {
            mx = fmaxf(mx, s[4 * j + 2 * h + c]);
          }
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      // -inf until the first live column: a 0 stand-in keeps
      // exp(m - m_safe) at 0 instead of NaN
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float ms2 = m_safe * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (all_live || v0 + 8 * j + 2 * q + c < V) {
            sum += exp2f(fmaf(s[4 * j + 2 * h + c], LOG2E, -ms2));
          }
        }
      }
      l[h] = exp2f(fmaf(m[h], LOG2E, -ms2)) * l[h] + sum;
      m[h] = m_new;
      const int col = lab[h] - v0 - 2 * q;  // = 8j + c where it is held
      if (col >= 0 && col < BS) {
#pragma unroll
        for (int j = 0; j < BS / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (col == 8 * j + c) t[h] += s[4 * j + 2 * h + c];
          }
        }
      }
    }
  }

  // This part's (m, l, tgt) per token: l and tgt summed over the quad that
  // shares the row, in lane order; each written once.
  float* part = ws + (long long)blockIdx.y * 3 * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
      t[h] += __shfl_xor_sync(0xffffffffu, t[h], o);
    }
    const int n = n0 + r0 + 8 * h;
    if (q == 0 && n < N) {
      part[n] = m[h];
      part[N + n] = l[h];
      part[2 * N + n] = t[h];
    }
  }
}

// The merge of B5's parts, per token in part order (the reference's
// _finalize): M = max_p m_p, lse = M + log(sum_p l_p exp(m_p - M_safe))
// with M_safe = 0 while M is -inf and the sum read as 1 when it is 0;
// tgt = sum_p tgt_p. A part with no live column has m = -inf, l = 0.
__global__ void __launch_bounds__(256)
fused_ce_merge_kernel(const float* __restrict__ ws, int nparts, int N,
                      float* __restrict__ lse, float* __restrict__ tgt) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  float M = -INFINITY;
  for (int p = 0; p < nparts; ++p) M = fmaxf(M, ws[3LL * p * N + n]);
  const float M_safe = (M == -INFINITY) ? 0.f : M;
  float L = 0.f, T = 0.f;
  for (int p = 0; p < nparts; ++p) {
    const float* part = ws + 3LL * p * N;
    L += part[N + n] * expf(part[n] - M_safe);
    T += part[2 * N + n];
  }
  lse[n] = M + logf(L == 0.f ? 1.f : L);
  tgt[n] = T;
}

// ---- B6 / B7: 3xTF32 wgmma on TMA-fed tiles, a cluster across D ---------

namespace bwd {

constexpr int OWN = 128;       // owned rows a cluster: two warpgroups of 64
constexpr int BS = 64;         // streamed rows a block
constexpr int KC = 32;         // f32 in one 128-byte swizzle row: a chunk
constexpr int THREADS = 256;   // two warpgroups: up to 255 registers each
constexpr int STAGES = 4;      // ring slots
constexpr uint32_t SLOT = 32768;
constexpr uint32_t OWN_BYTES = OWN * KC * 4;  // owned raw chunk [128, 32]
constexpr uint32_t STR_BYTES = BS * KC * 4;   // streamed hi (lo) chunk [64, 32]
constexpr uint32_t XCHG = OWN * BS * 4;       // one block's partial S
// Streamed rows a part: the tensor core's f32 sums truncate, so their
// error grows with the number of products summed into one accumulator;
// longer streams are cut into parts of at most this many rows, whose
// outputs a second pass adds in a fixed order.
constexpr int PART_ROWS = 4096;

// Byte offsets from the 1024-aligned base of the dynamic shared memory.
struct Smem {
  static constexpr uint32_t ring = 0;                       // STAGES x SLOT
  static constexpr uint32_t xchg = ring + STAGES * SLOT;    // 2 x XCHG
  static constexpr uint32_t stats = xchg + 2 * XCHG;  // B7 2 x [3][BS]; B6 [3][OWN]
  static constexpr uint32_t bars = stats + 2 * 3 * BS * 4;  // full, empty
  static constexpr uint32_t bytes = bars + 2 * STAGES * 8;
};
constexpr size_t smem_bytes = Smem::bytes + kAlignPad;

// The operands' tensor maps, one kernel parameter: warp 0 alone reads
// them, and one base address costs the other warps fewer registers than
// five.
struct Maps {
  CUtensorMap own, s_hi, s_lo, t_hi, t_lo;
};

// How a head width is cut across the cluster: C CTAs of DS columns each
// (384: 2 x 192; 768: 3 x 256; 1024: 8 x 128, since at 4 x 256 ptxas
// spills past 255 registers).
template <int D>
struct Cut {
  static constexpr int DS = D == 384 ? 192 : D == 768 ? 256 : 128;
  static constexpr int C = D / DS;
  static_assert(C * DS == D && C >= 1 && C <= 8, "head width");
};

inline int parts(int streamed) {
  return streamed <= PART_ROWS ? 1 : (streamed + PART_ROWS - 1) / PART_ROWS;
}

}  // namespace bwd

// B6 (OWN_TOKENS) and B7: out[own row, D] = sum over the streamed rows of
// dlogits[token, vocab] * streamed row. B6 owns tokens (out = dX) and
// streams vocab rows; B7 owns vocab rows (out = dW) and streams tokens.
// Operands (maps): own the owned matrix as stored (raw f32 [own_n, D]),
// s_hi / s_lo the streamed matrix split (tf32 hi / lo, [str_n, D]), t_hi /
// t_lo its transpose split ([D, str_np], K order permuted in groups of 8).
// Part blockIdx.y of the streamed rows; with more than one part, out is
// the [parts, own_n, D] workspace.
template <int D, bool OWN_TOKENS>
__device__ __forceinline__ void ce_bwd_body(
    const bwd::Maps* maps, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ dce,
    float* __restrict__ out, int N, int V) {
  using namespace bwd;
  constexpr int DS = Cut<D>::DS;
  constexpr int C = Cut<D>::C;
  constexpr int NCH = DS / KC;      // chunks of the partial-S product
  constexpr int SLOTS = NCH + 4;    // ring slots a block: NCH, then 2 x (hi, lo)
  constexpr uint32_t T_BYTES = DS * KC * 4;
  static_assert(OWN_BYTES + 2 * STR_BYTES == SLOT && T_BYTES <= SLOT, "slot");
  static_assert(OWN == 2 * BS, "B6's owned stats fill B7's two stats stages");
  static_assert(SLOTS > STAGES, "stats ring");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  const uint32_t sstat = sbase + Smem::stats;  // f32
  // full[s]: slot s landed (TMA bytes); empty[s]: the 8 warps are done
  // with it.
  const uint32_t full = sbase + Smem::bars;
  const uint32_t empty = full + 8 * STAGES;

  const int own_n = OWN_TOKENS ? N : V;
  const int str_n = OWN_TOKENS ? V : N;
  const int str0 = blockIdx.y * PART_ROWS;  // this part's streamed rows
  const int str_end = min(str_n, str0 + PART_ROWS);
  const uint32_t rank = cluster_rank();
  const int own0 = (blockIdx.x / C) * OWN;
  const int col0 = rank * DS;
  const int nblk = (str_end - str0 + BS - 1) / BS;
  const int nseq = nblk * SLOTS;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const bool issuer = tid < 32;  // warp 0 keeps the ring full

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, bwd::THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (OWN_TOKENS && tid < OWN) {
    // B6: the owned tokens' statistics, [3][OWN] in the stats area (B7
    // streams its own there); a row past N has dce 0, so dlogits 0.
    const int n = own0 + tid;
    const bool ok = n < N;
    sts(sstat + 4 * tid, ok ? lse[n] : 0.f);
    sts(sstat + 4 * (OWN + tid), ok ? dce[n] : 0.f);
    sts(sstat + 4 * (2 * OWN + tid), __int_as_float(ok ? labels[n] : -1));
  }
  __syncthreads();

  // Ring slot `seq` of this CTA's sequence (block seq / SLOTS, slot
  // seq % SLOTS) into stage seq % STAGES, once all 8 warps have released
  // what it held; warp 0, all lanes. B7's streamed tokens' statistics go
  // into the stats ring with a block's first slot: its wait (block i - 1's
  // first accumulate slot) is past block i - 2's dlogits.
  auto issue = [&](int seq) {
    const int t = seq % SLOTS;
    const int st = seq % STAGES;
    const int s0 = str0 + (seq / SLOTS) * BS;
    if (seq >= STAGES) mbar_wait(empty + 8 * st, (seq / STAGES - 1) & 1);
    if (!OWN_TOKENS && t == 0) {
      const uint32_t ss = sstat + ((seq / SLOTS) & 1) * 3 * BS * 4;
      for (int c = lane; c < BS; c += 32) {
        const int n = s0 + c;
        const bool ok = n < str_end;
        sts(ss + 4 * c, ok ? lse[n] : 0.f);
        sts(ss + 4 * (BS + c), ok ? dce[n] : 0.f);  // past the part: 0
        sts(ss + 4 * (2 * BS + c), __int_as_float(ok ? labels[n] : -1));
      }
      __syncwarp();
    }
    if (lane == 0) {
      const uint32_t slot = sbase + Smem::ring + st * SLOT;
      const uint32_t bar = full + 8 * st;
      if (t < NCH) {
        mbar_expect_tx(bar, SLOT);
        tma_box2d(slot, &maps->own, bar, col0 + KC * t, own0);
        tma_box2d(slot + OWN_BYTES, &maps->s_hi, bar, col0 + KC * t, s0);
        tma_box2d(slot + OWN_BYTES + STR_BYTES, &maps->s_lo, bar,
                  col0 + KC * t, s0);
      } else {
        const int u = t - NCH;  // streamed rows s0 + 32 (u / 2); hi, lo
        mbar_expect_tx(bar, T_BYTES);
        tma_box2d(slot, (u & 1) ? &maps->t_lo : &maps->t_hi, bar,
                  s0 + KC * (u >> 1), col0);
      }
    }
    __syncwarp();
  };
  // Release stage seq % STAGES (this warp is done with it) and, on warp
  // 0, refill it with slot seq + STAGES.
  auto release = [&](int seq) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (seq % STAGES));
    if (issuer && seq + STAGES < nseq) issue(seq + STAGES);
  };
  if (issuer) {
    for (int seq = 0; seq < STAGES && seq < nseq; ++seq) issue(seq);
  }

  const int r0 = 64 * wg + 16 * warp + g;  // owned rows r0 and r0 + 8

  float acc[DS / 2];
#pragma unroll
  for (int e = 0; e < DS / 2; ++e) acc[e] = 0.f;
  float s[32];
  // This thread's 32 partial-S values in the exchange buffer: float4 e4
  // at + e4 * 2048 (conflict-free: the warpgroup's 128 threads side by
  // side).
  const uint32_t my_x = Smem::xchg + wg * (XCHG / 2) + (tid & 127) * 16;

  for (int i = 0; i < nblk; ++i) {
    const int s0 = str0 + i * BS;

    // 1. Partial S [64 owned, 64 streamed] over this CTA's DS columns:
    //    A = the owned rows, raw f32 from the slot, split into tf32 hi/lo
    //    in registers; B = the streamed rows' hi and lo. 3xTF32:
    //    hi*hi' + hi*lo' + lo*hi'. One k8 slice a group: each group's A
    //    fragments are loaded while the group before runs; a chunk's slot
    //    is released once its four groups are done.
    uint32_t fh[2][4], fl[2][4];  // [group parity][reg]
    auto load_group = [&](int grp, uint32_t (&gh)[4], uint32_t (&gl)[4]) {
      const int seq = i * SLOTS + (grp >> 2);
      const int kk = grp & 3;
      const uint32_t slot = sbase + Smem::ring + (seq % STAGES) * SLOT;
      if (kk == 0) mbar_wait(full + 8 * (seq % STAGES), (seq / STAGES) & 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // column 8 kk + q + 4 half: 16-byte chunk 2 kk + half of the
        // 128-byte row, swizzled by the row's low 3 bits (= g)
        const uint32_t off =
            slot + r0 * 128 + (((2 * kk + half) ^ g) << 4) + q * 4;
        split_tf32(lds(off), gh[2 * half], gl[2 * half]);
        split_tf32(lds(off + 8 * 128), gh[2 * half + 1], gl[2 * half + 1]);
      }
    };
    auto issue_group = [&](int grp, uint32_t (&gh)[4], uint32_t (&gl)[4]) {
      const int kk = grp & 3;
      const uint32_t slot =
          sbase + Smem::ring + ((i * SLOTS + (grp >> 2)) % STAGES) * SLOT;
      const uint64_t bh = sw128_desc(slot + OWN_BYTES + 32 * kk);
      const uint64_t bl = sw128_desc(slot + OWN_BYTES + STR_BYTES + 32 * kk);
      fence_regs(gh);
      fence_regs(gl);
      wg_fence();
      wgmma_tf32_rs(s, gh, bh, grp != 0);
      wgmma_tf32_rs(s, gh, bl, 1);
      wgmma_tf32_rs(s, gl, bh, 1);
      wg_commit();
    };
    fence_regs(s);
    load_group(0, fh[0], fl[0]);
    issue_group(0, fh[0], fl[0]);
#pragma unroll
    for (int grp = 1; grp < 4 * NCH; ++grp) {
      wg_wait<1>();  // group grp - 2 is done: its fragments are free
      fence_regs(fh[grp & 1]);
      fence_regs(fl[grp & 1]);
      // group grp - 2 was a chunk's last: the chunk is done
      if (grp >= 5 && ((grp - 2) & 3) == 3) release(i * SLOTS + (grp - 2) / 4);
      load_group(grp, fh[grp & 1], fl[grp & 1]);
      issue_group(grp, fh[grp & 1], fl[grp & 1]);
    }
    wg_wait<0>();
    fence_regs(s);
    fence_regs(fh);
    fence_regs(fl);
    release(i * SLOTS + NCH - 1);

    // 2. S = the C partials summed in rank order, the same floats in
    //    every CTA of the cluster (distributed shared memory). One
    //    cluster barrier a block: after it, every CTA's partial of block i
    //    is visible; and a CTA writes the buffer of block i again (block
    //    i + 2) only after the barrier of block i + 1, which every CTA
    //    reaches after reading block i's.
    const uint32_t mine = sbase + my_x + (i & 1) * XCHG;
#pragma unroll
    for (int e4 = 0; e4 < 8; ++e4) {
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                       mine + e4 * 2048), "f"(s[4 * e4]), "f"(s[4 * e4 + 1]),
                   "f"(s[4 * e4 + 2]), "f"(s[4 * e4 + 3]) : "memory");
    }
    cluster_sync();
    // (at C = 8, in quarters: 64 float4 loads in flight would spill)
    constexpr int XG = C <= 3 ? 8 : 2;
#pragma unroll
    for (int e0 = 0; e0 < 8; e0 += XG) {
#pragma unroll
      for (int e4 = e0; e4 < e0 + XG; ++e4) {
        float4 v = ld_cluster_v4(mapa(mine + e4 * 2048, 0));
#pragma unroll
        for (int r = 1; r < C; ++r) {
          const float4 u = ld_cluster_v4(mapa(mine + e4 * 2048, r));
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        s[4 * e4] = v.x;
        s[4 * e4 + 1] = v.y;
        s[4 * e4 + 2] = v.z;
        s[4 * e4 + 3] = v.w;
      }
      fence_regs(s);
    }

    // 3. dlogits = dce (exp(S - lse) - onehot), 0 on vocab columns >= V
    //    (the reference's _dlogits), split into tf32 hi/lo as the A
    //    fragments of the accumulate product: k8 slice j is S's columns
    //    8j..8j+7 in the order 0, 2, 4, 6, 1, 3, 5, 7 (element 4j + 2h + c
    //    -> register 2c + h), which the split pass stored B's rows in.
    const uint32_t ss = sstat + (OWN_TOKENS ? 0 : (i & 1) * 3 * BS * 4);
    uint32_t dh[8][4], dlo[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * h + c;
          const int col = 8 * j + 2 * q + c;  // streamed row in the block
          float l_, d_;
          int lab, vocab;
          bool live;
          if (OWN_TOKENS) {
            vocab = s0 + col;
            live = vocab < V;
            l_ = lds(ss + 4 * (r0 + 8 * h));
            d_ = lds(ss + 4 * (OWN + r0 + 8 * h));
            lab = __float_as_int(lds(ss + 4 * (2 * OWN + r0 + 8 * h)));
          } else {
            vocab = own0 + r0 + 8 * h;
            live = true;  // owned rows past V are never written
            l_ = lds(ss + 4 * col);
            d_ = lds(ss + 4 * (BS + col));
            lab = __float_as_int(lds(ss + 4 * (2 * BS + col)));
          }
          // exp(S - lse) as one ex2.approx (~2^-22 relative, below the
          // products' 3xTF32 error) on S and lse in log2 units
          const float p = live ? exp2f(fmaf(s[e], LOG2E, -l_ * LOG2E)) : 0.f;
          const float hot = (live && vocab == lab) ? 1.f : 0.f;
          split_tf32(d_ * (p - hot), dh[j][2 * c + h], dlo[j][2 * c + h]);
        }
      }
    }

    // 4. out[64 owned, DS] += dlogits [64, 64] . streamed [64, DS]: B =
    //    the transposed split, two k-chunks of 32 streamed rows, each a
    //    hi slot and a lo slot.
    fence_regs(dh);
    fence_regs(dlo);
    fence_regs(acc);
    const int seq2 = i * SLOTS + NCH;
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      const int sh = seq2 + 2 * kc;
      mbar_wait(full + 8 * (sh % STAGES), (sh / STAGES) & 1);
      mbar_wait(full + 8 * ((sh + 1) % STAGES), ((sh + 1) / STAGES) & 1);
      const uint32_t th = sbase + Smem::ring + (sh % STAGES) * SLOT;
      const uint32_t tl = sbase + Smem::ring + ((sh + 1) % STAGES) * SLOT;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int j = 4 * kc + kk;
        wgmma_tf32_rs(acc, dh[j], sw128_desc(th + 32 * kk), 1);
        wgmma_tf32_rs(acc, dh[j], sw128_desc(tl + 32 * kk), 1);
        wgmma_tf32_rs(acc, dlo[j], sw128_desc(th + 32 * kk), 1);
      }
      wg_commit();
    }
    wg_wait<1>();
    release(seq2);
    release(seq2 + 1);
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(dh);
    fence_regs(dlo);
    release(seq2 + 2);
    release(seq2 + 3);
  }

  // out [own_n, D] (this part's slice of the workspace): f32 pairs
  // straight from the accumulator layout (row r0 + 8h, columns
  // col0 + 8j + 2q + {0, 1}), each written once.
  float* part = out + (long long)blockIdx.y * own_n * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = own0 + r0 + 8 * h;
    if (row >= own_n) continue;
    float* o = part + (long long)row * D + col0 + 2 * q;
#pragma unroll
    for (int j = 0; j < DS / 8; ++j) {
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  __syncwarp();
  cluster_sync();  // no CTA leaves while another may read its shared memory
}

template <int D>
__global__ void __launch_bounds__(bwd::THREADS, 1)
fused_ce_dx_kernel(const __grid_constant__ bwd::Maps maps,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse,
                   const float* __restrict__ dce, float* __restrict__ dx,
                   int N, int V) {
  ce_bwd_body<D, true>(&maps, labels, lse, dce, dx, N, V);
}

template <int D>
__global__ void __launch_bounds__(bwd::THREADS, 1)
fused_ce_dw_kernel(const __grid_constant__ bwd::Maps maps,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse,
                   const float* __restrict__ dce, float* __restrict__ dw,
                   int N, int V) {
  ce_bwd_body<D, false>(&maps, labels, lse, dce, dw, N, V);
}

// The second pass of a stream cut into parts: out = ws[0] + ws[1] + ...,
// in that order (float4s; count a multiple of 4).
__global__ void __launch_bounds__(256)
fused_ce_sum_kernel(const float4* __restrict__ ws, int nparts,
                    long long count4, float4* __restrict__ out) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < count4;
       i += (long long)gridDim.x * 256) {
    float4 v = ws[i];
    for (int k = 1; k < nparts; ++k) {
      const float4 u = ws[k * count4 + i];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    out[i] = v;
  }
}

// The split pass, shared by B5, B6 and B7: a [rows, D] f32 matrix (row
// stride ld) into hi = tf32(a), lo = tf32(a - hi) as [rows, D], and the
// same of its transpose as [D, rows_p] (rows_p = rows rounded up to 8,
// the pad zero) with every group of 8 rows stored in the order 0, 2, 4,
// 6, 1, 3, 5, 7: the K order of the accumulate product's register A
// operand. blockIdx.z = 0 splits x (skipped if x is null), 1 splits w;
// a null transposed hi skips that matrix's transpose (B5 reads W's
// stored pair only).
constexpr int SPLIT_T = 32;
__global__ void __launch_bounds__(256)
fused_ce_split_kernel(const float* __restrict__ x, long long ldx, int N,
                      int Np, float* x_hi, float* x_lo, float* xt_hi,
                      float* xt_lo, const float* __restrict__ w,
                      long long ldw, int V, int Vp, float* w_hi,
                      float* w_lo, float* wt_hi, float* wt_lo, int D) {
  __shared__ float tile[SPLIT_T][SPLIT_T + 1];
  const bool is_w = blockIdx.z == 1;
  const float* a = is_w ? w : x;
  const long long ld = is_w ? ldw : ldx;
  const int rows = is_w ? V : N;
  const int rows_p = is_w ? Vp : Np;
  float* hi = is_w ? w_hi : x_hi;
  float* lo = is_w ? w_lo : x_lo;
  float* thi = is_w ? wt_hi : xt_hi;
  float* tlo = is_w ? wt_lo : xt_lo;
  const int r0 = blockIdx.x * SPLIT_T;
  const int d0 = blockIdx.y * SPLIT_T;
  if (a == nullptr || r0 >= rows_p) return;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int k = ty; k < SPLIT_T; k += 8) {
    const int r = r0 + k;
    float v = 0.f;
    if (r < rows) {
      v = a[(long long)r * ld + d0 + tx];
      uint32_t h, l;
      split_tf32(v, h, l);
      hi[(long long)r * D + d0 + tx] = __uint_as_float(h);
      lo[(long long)r * D + d0 + tx] = __uint_as_float(l);
    }
    tile[k][tx] = v;
  }
  if (thi == nullptr) return;  // the whole block: no barrier is left
  __syncthreads();
  // position p of a group of 8 holds row 2p (p < 4) or 2(p - 4) + 1
  const int p7 = tx & 7;
  const int src = (tx & ~7) | (p7 < 4 ? 2 * p7 : 2 * (p7 - 4) + 1);
  if (r0 + tx < rows_p) {
    for (int k = ty; k < SPLIT_T; k += 8) {
      uint32_t h, l;
      split_tf32(tile[src][k], h, l);
      const long long o = (long long)(d0 + k) * rows_p + r0 + tx;
      thi[o] = __uint_as_float(h);
      tlo[o] = __uint_as_float(l);
    }
  }
}

template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  // above 48 KB a launch needs the opt-in, or it is refused and never runs
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, bool DX>
constexpr auto bwd_kernel() {
  if constexpr (DX) {
    return &fused_ce_dx_kernel<D>;
  } else {
    return &fused_ce_dw_kernel<D>;
  }
}

template <int D, bool DX>
cudaLaunchConfig_t bwd_config(int own_n, int nparts, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  using P = bwd::Cut<D>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P::C * ((own_n + bwd::OWN - 1) / bwd::OWN), nparts);
  cfg.blockDim = dim3(bwd::THREADS);
  cfg.dynamicSmemBytes = bwd::smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// own [own_n, D] raw (row stride ld_own), s_hi / s_lo [str_n, D], t_hi /
// t_lo [D, str_np]: the operands of ce_bwd_body; ws the workspace of a
// stream cut into parts (bwd::parts(str_n) x own_n x D floats; unused
// with one part).
template <int D, bool DX>
int launch_bwd(const void* own, long long ld_own, const void* s_hi,
               const void* s_lo, const void* t_hi, const void* t_lo,
               long long str_np, const void* labels, const void* lse,
               const void* dce, void* out, void* ws, int N, int V,
               cudaStream_t stream) {
  const int own_n = DX ? N : V;
  const int str_n = DX ? V : N;
  if (own_n == 0) return 0;
  if (str_n == 0) {  // nothing streams: the gradient is 0
    cudaMemsetAsync(out, 0, (size_t)own_n * D * sizeof(float), stream);
    return (int)cudaGetLastError();
  }
  static const int attr = opt_in(bwd_kernel<D, DX>(), bwd::smem_bytes);
  if (attr) return attr;
  const int nparts = bwd::parts(str_n);
  if (nparts > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  bwd::Maps m;
  int err = make_map_f32(&m.own, own, own_n, D, ld_own, bwd::OWN);
  if (!err) err = make_map_f32(&m.s_hi, s_hi, str_n, D, D, bwd::BS);
  if (!err) err = make_map_f32(&m.s_lo, s_lo, str_n, D, D, bwd::BS);
  if (!err) err = make_map_f32(&m.t_hi, t_hi, D, str_np, str_np, bwd::Cut<D>::DS);
  if (!err) err = make_map_f32(&m.t_lo, t_lo, D, str_np, str_np, bwd::Cut<D>::DS);
  if (err) return err;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg = bwd_config<D, DX>(own_n, nparts, stream, at);
  float* dst = (float*)(nparts > 1 ? ws : out);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, bwd_kernel<D, DX>(), m, (const int*)labels, (const float*)lse, (const float*)dce, dst, N, V);
  if (e != cudaSuccess) return (int)e;
  if (nparts > 1) {
    const long long count4 = (long long)own_n * D / 4;
    const int blocks = (int)((count4 + 255) / 256 < 132 * 16
                                 ? (count4 + 255) / 256 : 132 * 16);
    fused_ce_sum_kernel<<<blocks, 256, 0, stream>>>(
        (const float4*)ws, nparts, count4, (float4*)out);
  }
  return (int)cudaGetLastError();
}

template <bool DX>
int dispatch_bwd(int D, const void* own, long long ld_own, const void* s_hi,
                 const void* s_lo, const void* t_hi, const void* t_lo,
                 long long str_np, const void* labels, const void* lse,
                 const void* dce, void* out, void* ws, int N, int V,
                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 384:
      return launch_bwd<384, DX>(own, ld_own, s_hi, s_lo, t_hi, t_lo, str_np,
                                 labels, lse, dce, out, ws, N, V, s);
    case 768:
      return launch_bwd<768, DX>(own, ld_own, s_hi, s_lo, t_hi, t_lo, str_np,
                                 labels, lse, dce, out, ws, N, V, s);
    case 1024:
      return launch_bwd<1024, DX>(own, ld_own, s_hi, s_lo, t_hi, t_lo,
                                  str_np, labels, lse, dce, out, ws, N, V, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D, bool DX>
int max_clusters() {
  if (opt_in(bwd_kernel<D, DX>(), bwd::smem_bytes)) return -1;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg = bwd_config<D, DX>(bwd::OWN * 1024, 1, 0, at);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, bwd_kernel<D, DX>(), &cfg) !=
      cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace

extern "C" {

// B5: x [N, D] f32 (row stride ldx, a multiple of 4; 16-byte aligned
// base) and W's split w_hi, w_lo [V, D] (contiguous), labels int32 [N];
// ws [parts, 3, N] f32 (parts = V / dtf_fused_ce_fwd_part_rows(),
// rounded up) receives every part's (m, l, tgt) per token. D a multiple
// of 32.
// Launches on `stream` and returns the error of building the tensor maps
// or of the launch.
int dtf_fused_ce_fwd_f32(const void* x, long long ldx, const void* w_hi,
                         const void* w_lo, const void* labels, void* ws,
                         int N, int V, int D, void* stream) {
  if (N == 0) return 0;
  if (V == 0 || D % fwd::KC) return (int)cudaErrorInvalidValue;
  static const int attr = opt_in(fused_ce_fwd_kernel, fwd::smem_bytes);
  if (attr) return attr;
  fwd::Maps m;
  int err = make_map_f32(&m.x, x, N, D, ldx, fwd::OWN);
  if (!err) err = make_map_f32(&m.w_hi, w_hi, V, D, D, fwd::BS);
  if (!err) err = make_map_f32(&m.w_lo, w_lo, V, D, D, fwd::BS);
  if (err) return err;
  const dim3 grid((N + fwd::OWN - 1) / fwd::OWN, fwd::parts(V));
  fused_ce_fwd_kernel<<<grid, fwd::THREADS, fwd::smem_bytes,
                        (cudaStream_t)stream>>>(m, (const int*)labels,
                                                (float*)ws, N, V, D);
  return (int)cudaGetLastError();
}

// Vocab rows a part of B5 (the last part may be shorter).
int dtf_fused_ce_fwd_part_rows() { return fwd::PART_ROWS; }

// The merge: ws [nparts, 3, N] f32 (B5's workspace) into lse, tgt f32
// [N], contiguous.
int dtf_fused_ce_merge_f32(const void* ws, int nparts, int N, void* lse,
                           void* tgt, void* stream) {
  if (N == 0) return 0;
  if (nparts < 1) return (int)cudaErrorInvalidValue;
  fused_ce_merge_kernel<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)ws, nparts, N, (float*)lse, (float*)tgt);
  return (int)cudaGetLastError();
}

// The split pass: x [N, D] (row stride ldx) into x_hi, x_lo [N, D] and
// xt_hi, xt_lo [D, Np]; w [V, D] (ldw) into w_hi, w_lo [V, D] and wt_hi,
// wt_lo [D, Vp]; Np, Vp = N, V rounded up to 8; outputs contiguous. A
// null x (w) skips that matrix, a null xt_hi (wt_hi) its transpose. D a
// multiple of 32.
int dtf_fused_ce_split_f32(const void* x, long long ldx, int N, int Np,
                           void* x_hi, void* x_lo, void* xt_hi, void* xt_lo,
                           const void* w, long long ldw, int V, int Vp,
                           void* w_hi, void* w_lo, void* wt_hi, void* wt_lo,
                           int D, void* stream) {
  if (D % SPLIT_T || Np % 8 || Vp % 8) return (int)cudaErrorInvalidValue;
  const int rows_p = (x ? Np : 0) > (w ? Vp : 0) ? Np : (w ? Vp : 0);
  if (rows_p == 0 || D == 0) return 0;
  const dim3 grid((rows_p + SPLIT_T - 1) / SPLIT_T, D / SPLIT_T, 2);
  fused_ce_split_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, ldx, N, Np, (float*)x_hi, (float*)x_lo, (float*)xt_hi,
      (float*)xt_lo, (const float*)w, ldw, V, Vp, (float*)w_hi, (float*)w_lo,
      (float*)wt_hi, (float*)wt_lo, D);
  return (int)cudaGetLastError();
}

// B6: dx [N, D] f32 contiguous from x (row stride ldx) and w's split
// (w_hi, w_lo [V, D]; wt_hi, wt_lo [D, Vp]), labels int32, lse and dce
// f32 [N]; ws the workspace of dtf_fused_ce_workspace_floats(1, ...)
// floats (null when that is 0). D is 384, 768 or 1024. Launches on
// `stream` (the kernel, and the fixed-order sum of the parts when the
// vocab is cut) and returns the error of building the tensor maps or of a
// launch.
int dtf_fused_ce_dx_f32(const void* x, long long ldx, const void* w_hi,
                        const void* w_lo, const void* wt_hi,
                        const void* wt_lo, long long Vp, const void* labels,
                        const void* lse, const void* dce, void* dx, void* ws,
                        int N, int V, int D, void* stream) {
  return dispatch_bwd<true>(D, x, ldx, w_hi, w_lo, wt_hi, wt_lo, Vp, labels,
                            lse, dce, dx, ws, N, V, stream);
}

// B7: dw [V, D] f32 contiguous from w (row stride ldw) and x's split
// (x_hi, x_lo [N, D]; xt_hi, xt_lo [D, Np]); the rest as B6 (the tokens
// cut into parts past bwd::PART_ROWS).
int dtf_fused_ce_dw_f32(const void* w, long long ldw, const void* x_hi,
                        const void* x_lo, const void* xt_hi,
                        const void* xt_lo, long long Np, const void* labels,
                        const void* lse, const void* dce, void* dw, void* ws,
                        int N, int V, int D, void* stream) {
  return dispatch_bwd<false>(D, w, ldw, x_hi, x_lo, xt_hi, xt_lo, Np, labels,
                             lse, dce, dw, ws, N, V, stream);
}

// Floats of the workspace B6 (which = 1) or B7 (2) needs: 0 when its
// stream (V for B6, N for B7) is one part, else parts x own rows x D.
long long dtf_fused_ce_workspace_floats(int which, int N, int V, int D) {
  const int own_n = which == 1 ? N : V;
  const int nparts = bwd::parts(which == 1 ? V : N);
  return nparts > 1 ? (long long)nparts * own_n * D : 0;
}

const char* dtf_fused_ce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes one CTA takes: which 0 = B5, 1 = B6, 2 = B7, 3 =
// the split pass, 4 = the merge (0 for a head width the backward is not
// compiled for).
long long dtf_fused_ce_smem_bytes(int which, int D) {
  if (which == 0) return (long long)fwd::smem_bytes;
  if (which == 4) return 0;
  if (which == 3) return (long long)sizeof(float) * SPLIT_T * (SPLIT_T + 1);
  return (D == 384 || D == 768 || D == 1024) ? (long long)bwd::smem_bytes
                                             : 0;
}

// How many clusters of B6 (which = 1) or B7 (2) the card holds at once
// at head width D (cudaOccupancyMaxActiveClusters); -1 on an error.
int dtf_fused_ce_max_clusters(int which, int D) {
  const bool dx = which == 1;
  switch (D) {
    case 384: return dx ? max_clusters<384, true>() : max_clusters<384, false>();
    case 768: return dx ? max_clusters<768, true>() : max_clusters<768, false>();
    case 1024:
      return dx ? max_clusters<1024, true>() : max_clusters<1024, false>();
    default: return -1;
  }
}

}  // extern "C"
