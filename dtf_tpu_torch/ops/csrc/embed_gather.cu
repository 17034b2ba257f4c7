// Embedding-row gather for Hopper (sm_90a): out[i] = table[ids[i]].
//
// Replaces: dtf_tpu/ops/embed_gather.py::_gather_kernel (B8), launched by
// ::_pallas_gather with the ids scalar-prefetched and one table row moved
// per grid step. Same function; an id outside [0, R) gives a row of NaN
// (the TPU kernel would DMA from outside the table; jnp.take fills NaN).
// The kernel never reads outside the table.
//
// Layouts: table [R, D] read through its row stride (the last dim
// contiguous), any element type of 2 or 4 bytes (the wrapper passes f32
// and bf16); ids int32 [n]; out [n, D] contiguous, the table's type.
//
// Bound on the H100: a gather does no arithmetic, so it is bytes: the ids
// read once (4 n), every gathered row read once and written once
// (2 n D elt). At Wide&Deep's batch (512 x 26 ids, the 16-wide f32 deep
// table) that is 1.76 MB, 0.52 us at 3.35 TB/s; the ids are random over a
// 166 MB table, larger than the 50 MB L2, so each row arrives cold and a
// small batch is bound by latency, not bandwidth.
//
// Design. The Pallas grid's one row per step becomes many rows per CTA:
// a group of lanes_per_row lanes (a power of two, at most a warp) owns one
// row, and the CTA's 256 threads take 256 / lanes_per_row rows at a time,
// striding over the ids. Lanes move pieces of type V: 16 bytes where the
// row's bytes, the table's row stride and both base pointers allow it,
// else 8, 4 or 2 (the wide table's 4-byte f32 rows move as one word, one
// row per lane). Lane 0 of a group reads the row's id once and shuffles
// it to the group. Neighbouring lanes read neighbouring 16-byte pieces of
// one row, and the output is written contiguously.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CTAS = 132 * 16;   // the rest is a grid-stride loop

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

// nan_word: the NaN bit pattern of the element type, repeated to 32 bits.
template <typename V>
__global__ void __launch_bounds__(THREADS) embed_gather_kernel(
    const char* __restrict__ table, long long stride_bytes,
    long long n_rows, const int* __restrict__ ids, long long n,
    V* __restrict__ out, int vecs_per_row, int lanes_per_row,
    uint32_t nan_word) {
  const int rows_per_cta = THREADS / lanes_per_row;
  const int slot = threadIdx.x / lanes_per_row;
  const int lane = threadIdx.x % lanes_per_row;
  // base is the same for every thread of the CTA, so every lane of a warp
  // reaches the shuffle on every trip
  for (long long base = (long long)blockIdx.x * rows_per_cta; base < n;
       base += (long long)gridDim.x * rows_per_cta) {
    const long long i = base + slot;
    int id = 0;
    if (lane == 0 && i < n) id = ids[i];
    id = __shfl_sync(0xffffffffu, id, 0, lanes_per_row);
    if (i >= n) continue;
    V* dst = out + i * (long long)vecs_per_row;
    if (id < 0 || (long long)id >= n_rows) {
      const V nan = splat<V>(nan_word);
      for (int j = lane; j < vecs_per_row; j += lanes_per_row) dst[j] = nan;
    } else {
      const V* src =
          reinterpret_cast<const V*>(table + (long long)id * stride_bytes);
      for (int j = lane; j < vecs_per_row; j += lanes_per_row)
        dst[j] = src[j];
    }
  }
}

template <typename V>
int launch(const void* table, long long stride_bytes, long long n_rows,
           const void* ids, long long n, void* out, int row_bytes,
           uint32_t nan_word, cudaStream_t stream) {
  const int vecs = row_bytes / (int)sizeof(V);
  int lanes = 1;
  while (lanes < vecs && lanes < 32) lanes *= 2;
  const int rows_per_cta = THREADS / lanes;
  const long long ctas = (n + rows_per_cta - 1) / rows_per_cta;
  const int grid = (int)(ctas < MAX_CTAS ? ctas : MAX_CTAS);
  embed_gather_kernel<V><<<grid, THREADS, 0, stream>>>(
      (const char*)table, stride_bytes, n_rows, (const int*)ids, n,
      (V*)out, vecs, lanes, nan_word);
  return (int)cudaGetLastError();
}

// The widest piece (16, 8, 4 or 2 bytes, at least one element) that
// divides the row's bytes and the row stride, with both bases aligned to it.
int vector_bytes(long long table_addr, long long stride_bytes,
                 long long out_addr, int row_bytes, int elt_bytes) {
  for (int v = 16; v > elt_bytes; v /= 2)
    if (row_bytes % v == 0 && stride_bytes % v == 0 &&
        table_addr % v == 0 && out_addr % v == 0)
      return v;
  return elt_bytes;
}

}  // namespace

extern "C" {

// table: R rows of row_bytes bytes (D elements of elt_bytes, 2 or 4), row
// r at table + r * stride_bytes; ids int32 [n]; out [n, D] contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 launches nothing
// when n is 0).
int dtf_embed_gather(const void* table, long long stride_bytes,
                     long long n_rows, const void* ids, long long n,
                     void* out, int row_bytes, int elt_bytes, void* stream) {
  if (n == 0) return 0;
  if ((elt_bytes != 2 && elt_bytes != 4) || row_bytes <= 0 ||
      row_bytes % elt_bytes || stride_bytes % elt_bytes)
    return (int)cudaErrorInvalidValue;
  const uint32_t nan_word = elt_bytes == 4 ? 0x7fc00000u : 0x7fc07fc0u;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vector_bytes((long long)(uintptr_t)table, stride_bytes,
                       (long long)(uintptr_t)out, row_bytes, elt_bytes)) {
    case 16:
      return launch<uint4>(table, stride_bytes, n_rows, ids, n, out,
                           row_bytes, nan_word, s);
    case 8:
      return launch<uint2>(table, stride_bytes, n_rows, ids, n, out,
                           row_bytes, nan_word, s);
    case 4:
      return launch<uint32_t>(table, stride_bytes, n_rows, ids, n, out,
                              row_bytes, nan_word, s);
    default:
      return launch<uint16_t>(table, stride_bytes, n_rows, ids, n, out,
                              row_bytes, nan_word, s);
  }
}

const char* dtf_embed_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
