// Embedding-row gather for Hopper (sm_90a): out_t[i] = table_t[ids[i]] for
// up to two tables that share the ids, one launch.
//
// Replaces: dtf_tpu/ops/embed_gather.py::_gather_kernel (B8), launched by
// ::_pallas_gather with the ids scalar-prefetched and one table row moved
// per grid step, and, around it, the per-shard body of
// dtf_tpu/parallel/embedding.py::masked_lookup (the shift by the shard's
// first row, the range test, the clip, the where) and the table's cast
// (RowShardedEmbed's table.astype(dtype)), which XLA fuses into its
// neighbours and PyTorch would launch one by one.
//
// Contract. ids int32 [n]; a row offset and a row count for the shard.
// For each table t (at most two): table [R, D_t] read through its row
// stride (the last dim contiguous) in its stored type, f32 or bf16; out_t
// [n, D_t] contiguous in the out type, the stored type or bf16 from f32.
// local = ids[i] - row_offset; a row with 0 <= local < n_rows gets table
// row `local`, rounded to bf16 (nearest even) as it is stored when the out
// type is bf16: bf16(table[ids]) equals table.to(bf16)[ids] bit for bit.
// Any other row reads nothing and gets the fill: NaN (gather_rows' plain
// contract, offset 0 and n_rows R: jnp.take fills NaN) or exactly 0
// (masked_lookup's, where the id belongs to another shard).
//
// Bound on the H100: a gather does no arithmetic, so it is bytes: the ids
// read once (4 n), each table's in-shard rows read once in the stored
// type, every row written once in the out type. At one rank of Wide&Deep
// over 2 ranks (512 x 26 ids, half of them in the shard, the 16-wide deep
// table f32 -> bf16 and the 1-wide wide table f32): 53,248 + 425,984 +
// 26,624 + 425,984 + 53,248 = 985,088 bytes, 0.294 us at 3.35 TB/s. The
// rows are random over a shard larger than the 50 MB L2, so each arrives
// cold: at this size the time is fixed costs and latency, not bandwidth.
//
// Design, against those fixed costs:
// - Both tables in one launch: the launch, the id round trip and the
//   shard's range test are paid once for the two tables.
// - A group of `lanes` threads (a power of two, at most a warp) owns one
//   id: lane 0 reads it and shuffles it to the group, and each lane moves
//   one piece of each table's row (the deep f32 row is four 16-byte
//   pieces, so 4 lanes; the wide row's one word goes with lane 0). A
//   lane issues its loads of both tables before it stores anything, so
//   the row latency is paid once for the two. Neighbouring lanes move
//   neighbouring pieces of one row: a warp's load covers whole rows, and
//   its store is contiguous. Rows of more than 32 pieces (D > 128 f32)
//   take several trips of the group.
// - CTAs of 32 to 256 threads, the largest that still gives every SM two
//   CTAs: at 13,312 ids and 4 lanes, 416 CTAs of 128 threads over the 132
//   SMs (256-thread CTAs of 2 lanes a row left 28 SMs idle at the old
//   104). One piece a thread keeps the registers low, so a large batch
//   keeps the SMs full of warps and their loads in flight.
// - Pieces of 16 bytes where the rows, the row stride and both base
//   pointers allow it, else 8, 4 or 2 (chosen per table on the host).
// - A plain launch. Programmatic dependent launch (the CTAs launched while
//   the kernel before them drains, griddepcontrol.wait holding every
//   global access until it is complete) is built only with
//   -DDTF_EMBED_PDL=1, by profile_embed_gather.py: after the ids' add, as
//   on the path, it cost time; after another B8 it saved some.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef DTF_EMBED_PDL       // (profile_embed_gather.py builds it with 1)
#define DTF_EMBED_PDL 0
#endif

namespace {

constexpr int MAX_THREADS = 256;

struct Table {
  const char* src;      // row r at src + r * stride
  long long stride;     // bytes
  char* dst;            // row i at dst + i * out_row_bytes
  long long out_row_bytes;
  int pieces;           // pieces of the load type V a row; 0: no table
  int cast;             // f32 in, bf16 out
  uint32_t fill;        // the fill, the out type repeated to 32 bits
};

struct Params {
  Table t[2];
  const int* ids;
  long long n, row_offset, n_rows;
  int lanes;
};

template <typename V> __device__ __forceinline__ V splat(uint32_t w);
template <> __device__ __forceinline__ uint4 splat<uint4>(uint32_t w) {
  return make_uint4(w, w, w, w);
}
template <> __device__ __forceinline__ uint2 splat<uint2>(uint32_t w) {
  return make_uint2(w, w);
}
template <> __device__ __forceinline__ uint32_t splat<uint32_t>(uint32_t w) {
  return w;
}
template <>
__device__ __forceinline__ uint16_t splat<uint16_t>(uint32_t w) {
  return (uint16_t)(w & 0xffffu);
}

// The bf16 piece that a piece V of f32 becomes (half its bytes).
template <typename V> struct Narrow { using T = V; };
template <> struct Narrow<uint4> { using T = uint2; };
template <> struct Narrow<uint2> { using T = uint32_t; };
template <> struct Narrow<uint32_t> { using T = uint16_t; };

__device__ __forceinline__ uint32_t bf16x2(uint32_t lo, uint32_t hi) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(__uint_as_float(lo), __uint_as_float(hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint2 narrow(uint4 v) {
  return make_uint2(bf16x2(v.x, v.y), bf16x2(v.z, v.w));
}
__device__ __forceinline__ uint32_t narrow(uint2 v) {
  return bf16x2(v.x, v.y);
}
__device__ __forceinline__ uint16_t narrow(uint32_t v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(v)));
}
// never called: no f32 piece is 2 bytes (the host picks 4 or more)
__device__ __forceinline__ uint16_t narrow(uint16_t v) { return v; }

// Store piece j of row i of table t: the loaded piece (rounded to bf16
// when t casts) or the fill.
template <typename V>
__device__ __forceinline__ void put(const Table& t, long long i, int j,
                                    const V& v, bool in) {
  char* row = t.dst + i * t.out_row_bytes;
  if (t.cast) {
    using H = typename Narrow<V>::T;
    reinterpret_cast<H*>(row)[j] = in ? narrow(v) : splat<H>(t.fill);
  } else {
    reinterpret_cast<V*>(row)[j] = in ? v : splat<V>(t.fill);
  }
}

template <typename V0, typename V1>
__global__ void __launch_bounds__(MAX_THREADS)
    embed_gather_kernel(const Params p) {
#if DTF_EMBED_PDL
  // the kernel before this one may still be writing the ids or a table
  // when a programmatic launch starts this grid
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
  const Table& a = p.t[0];
  const Table& b = p.t[1];
  const int lanes = p.lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const int slots = blockDim.x / lanes;
  const int slot = threadIdx.x / lanes;
  const int most = a.pieces > b.pieces ? a.pieces : b.pieces;
  // base is the same for every thread of the CTA, so every lane of a
  // group reaches the shuffle on every trip
  for (long long base = (long long)blockIdx.x * slots; base < p.n;
       base += (long long)gridDim.x * slots) {
    const long long i = base + slot;
    int id = 0;
    if (lane == 0 && i < p.n) id = p.ids[i];
    if (lanes > 1) id = __shfl_sync(0xffffffffu, id, 0, lanes);
    if (i >= p.n) continue;
    const long long local = (long long)id - p.row_offset;
    const bool in = local >= 0 && local < p.n_rows;
    const V0* ra = reinterpret_cast<const V0*>(a.src + local * a.stride);
    const V1* rb = reinterpret_cast<const V1*>(b.src + local * b.stride);
    // one trip unless a row has more than 32 pieces
    for (int j = lane; j < most; j += lanes) {
      V0 va;
      V1 vb;
      if (in) {
        if (j < a.pieces) va = __ldg(ra + j);
        if (j < b.pieces) vb = __ldg(rb + j);
      }
      if (j < a.pieces) put<V0>(a, i, j, va, in);
      if (j < b.pieces) put<V1>(b, i, j, vb, in);
    }
  }
}

template <typename V0, typename V1>
int launch(const Params& p, int grid, int threads, cudaStream_t stream) {
#if DTF_EMBED_PDL
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg,
                                             embed_gather_kernel<V0, V1>, p);
  if (err != cudaSuccess) {
    cudaGetLastError();          // clear it: the caller raises on err
    return (int)err;
  }
#else
  embed_gather_kernel<V0, V1><<<grid, threads, 0, stream>>>(p);
#endif
  return (int)cudaGetLastError();
}

template <typename V0>
int launch_second(int v1, const Params& p, int grid, int threads,
                  cudaStream_t s) {
  switch (v1) {
    case 16: return launch<V0, uint4>(p, grid, threads, s);
    case 8: return launch<V0, uint2>(p, grid, threads, s);
    case 4: return launch<V0, uint32_t>(p, grid, threads, s);
    default: return launch<V0, uint16_t>(p, grid, threads, s);
  }
}

int launch_both(int v0, int v1, const Params& p, int grid, int threads,
                cudaStream_t s) {
  switch (v0) {
    case 16: return launch_second<uint4>(v1, p, grid, threads, s);
    case 8: return launch_second<uint2>(v1, p, grid, threads, s);
    case 4: return launch_second<uint32_t>(v1, p, grid, threads, s);
    default: return launch_second<uint16_t>(v1, p, grid, threads, s);
  }
}

bool aligned(long long x, int v) { return x % v == 0; }

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev] &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return cached[dev];
}

}  // namespace

extern "C" {

// One table of a launch (the host's view).
struct DtfGatherTable {
  const void* src;        // row r at src + r * stride_bytes
  long long stride_bytes;
  void* dst;              // [n, d] contiguous, out_elt bytes an element
  int d;
  int in_elt;             // 4: f32, 2: bf16
  int out_elt;            // in_elt, or 2 from 4 (f32 rounded to bf16)
};

// tables[0..n_tables) (1 or 2) share the int32 ids [n]; local =
// ids[i] - row_offset, in the shard when 0 <= local < n_rows (the tables'
// rows). Rows outside get 0 when zero_outside, else NaN. Launches on
// `stream` and returns cudaGetLastError() (nothing is launched when n is
// 0).
int dtf_embed_gather(const DtfGatherTable* tables, int n_tables,
                     const void* ids, long long n, long long row_offset,
                     long long n_rows, int zero_outside, void* stream) {
  if (n_tables < 1 || n_tables > 2 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Params p = {};
  int vec[2] = {4, 4};
  for (int t = 0; t < n_tables; ++t) {
    const DtfGatherTable& g = tables[t];
    const int in = g.in_elt, out = g.out_elt;
    if (g.d <= 0 || (in != 2 && in != 4) || (out != in && !(in == 4 &&
        out == 2)) || g.stride_bytes % in)
      return (int)cudaErrorInvalidValue;
    const long long row = (long long)g.d * in;
    // the widest piece (at least one element) that divides the row and
    // the stride, with both bases aligned to it and to its bf16 half
    int v = 16;
    while (v > in && !(aligned(row, v) && aligned(g.stride_bytes, v) &&
                       aligned((long long)(uintptr_t)g.src, v) &&
                       aligned((long long)(uintptr_t)g.dst, v * out / in)))
      v /= 2;
    vec[t] = v;
    Table& d = p.t[t];
    d.src = (const char*)g.src;
    d.stride = g.stride_bytes;
    d.dst = (char*)g.dst;
    d.out_row_bytes = (long long)g.d * out;
    d.pieces = (int)(row / v);
    d.cast = out != in;
    d.fill = zero_outside ? 0u : (out == 4 ? 0x7fc00000u : 0x7fc07fc0u);
  }
  p.ids = (const int*)ids;
  p.n = n;
  p.row_offset = row_offset;
  p.n_rows = n_rows;
  const int most = p.t[0].pieces > p.t[1].pieces ? p.t[0].pieces
                                                 : p.t[1].pieces;
  int lanes = 1;
  while (lanes < 32 && lanes < most) lanes *= 2;
  p.lanes = lanes;
  // the largest CTA (a power of two, 32 to 256 threads) that still gives
  // every SM two CTAs
  const long long threads_needed = n * lanes;
  const long long want = 2LL * sm_count();
  int threads = MAX_THREADS;
  while (threads > 32 && (threads_needed + threads - 1) / threads < want)
    threads /= 2;
  const long long ctas = (threads_needed + threads - 1) / threads;
  const int grid = (int)(ctas < 0x7fffffffLL ? ctas : 0x7fffffffLL);
  return launch_both(vec[0], vec[1], p, grid, threads,
                     (cudaStream_t)stream);
}

const char* dtf_embed_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
