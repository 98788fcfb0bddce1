// K2: row-wise cumulative sum, accumulated strictly left to right.
//
// Replaces the TPU kernel src/repro/kernels/seq_cumsum.py::seq_cumsum_pallas
// (delta-mode decode, paper Sec. V-B2).  The result is bitwise equal to
// np.cumsum(x, axis=1): column 0 is copied, not added to 0 (a leading -0.0
// survives), and every later column adds one value to the running sum in the
// row's own type.  f16 adds in float and rounds each partial sum to half, as
// numpy's half add does.  Adds only: there is nothing to contract, and the
// library is never built with --use_fast_math.
//
// Bound.  Bytes: each value is read once and written once, and the adds are
// few.  The walk inside a row stays serial (another order rounds
// differently), so the only speed is in moving the bytes.
//
// Design.  One warp a CTA, one tile of up to 32 consecutive rows a CTA, and
// as many CTAs as rows / 32, so several tiles are in flight on every SM.
//   * Load: a tile of whole rows is one contiguous span of memory.  It is
//     copied into shared memory with 16-byte cp.async; the tile's shared
//     image is shifted by the span's address modulo 16, so the body's
//     copies are aligned on both sides, and the head and tail before and
//     after the 16-byte boundaries (a view's storage offset, a ragged span)
//     are copied element by element.
//   * Walk: thread t walks row t of the tile in shared memory, left to
//     right, writing each partial sum over its input.  A row stride in
//     shared memory of an odd number of elements keeps the walk free of
//     bank conflicts (P = 111 is odd, so the tile needs no padding); an
//     even P is padded to P + 1, and its copies go element by element.
//   * Store: the sums go back coalesced, in 16-byte stores aligned to the
//     output, the head and tail element by element.
//   * Rows too long for a tile (more than 48 KB) are cut into column chunks
//     of 32 rows; each row's running sum carries from chunk to chunk.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 32;             // one warp; thread t walks row t
constexpr int kRows = kThreads;          // rows a tile, at most
constexpr size_t kTileBytes = 48 * 1024; // shared memory a tile, at most

template <typename T>
struct Acc {
  __device__ static T add(T a, T b) { return a + b; }
};

template <>
struct Acc<__half> {
  __device__ static __half add(__half a, __half b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
};

// count contiguous elements from s (aligned to T) to g: 16-byte stores
// aligned to g, each packed from shared memory element by element.
template <typename T>
__device__ void store_span(T* g, const T* s, size_t count) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t head = head_elems<T>(g, count);
  const size_t body = (count - head) / kVec * kVec;
  for (size_t e = threadIdx.x; e < head; e += kThreads) g[e] = s[e];
  for (size_t k = threadIdx.x; k < body / kVec; k += kThreads) {
    alignas(16) T v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = s[head + k * kVec + i];
    *reinterpret_cast<uint4*>(g + head + k * kVec) = *reinterpret_cast<const uint4*>(v);
  }
  for (size_t e = head + body + threadIdx.x; e < count; e += kThreads) g[e] = s[e];
}

// rows x width elements of a tile, row stride P in global memory and S in
// shared memory, element by element (coalesced along each row).
template <typename T>
__device__ void load_rows(T* s, const T* g, int rows, int width, int S, int P) {
  const int total = rows * width;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / width, k = e - r * width;
    cp_async_elem(s + r * S + k, g + static_cast<size_t>(r) * P + k);
  }
}

template <typename T>
__device__ void store_rows(T* g, const T* s, int rows, int width, int S, int P) {
  const int total = rows * width;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / width, k = e - r * width;
    g[static_cast<size_t>(r) * P + k] = s[r * S + k];
  }
}

// One CTA per tile of `rows_per_tile` rows, walked in column chunks of
// `width` (= P unless the rows are too long for a tile), row stride S in
// shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
seq_cumsum_kernel(const T* __restrict__ x, T* __restrict__ out, int R, int P, int rows_per_tile,
                  int width, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t row0 = static_cast<size_t>(blockIdx.x) * rows_per_tile;
  const int rows = static_cast<int>(min(static_cast<size_t>(rows_per_tile), R - row0));
  const T* xt = x + row0 * P;
  T* ot = out + row0 * P;
  const int t = threadIdx.x;
  T acc{};
  if (width == P && S == P) {
    // the tile is one contiguous span: shift its shared image so that the
    // span's 16-byte boundaries fall on shared 16-byte boundaries
    T* tile = reinterpret_cast<T*>(smem_raw + (reinterpret_cast<uintptr_t>(xt) & 15));
    const size_t count = static_cast<size_t>(rows) * P;
    load_span(tile, xt, count);
    cp_async_wait_all();
    __syncthreads();
    if (t < rows) {
      T* row = tile + static_cast<size_t>(t) * S;
      acc = row[0];
#pragma unroll 8
      for (int j = 1; j < P; ++j) {
        acc = Acc<T>::add(acc, row[j]);
        row[j] = acc;
      }
    }
    __syncthreads();
    store_span(ot, tile, count);
    return;
  }
  T* tile = reinterpret_cast<T*>(smem_raw);
  for (size_t col0 = 0; col0 < static_cast<size_t>(P); col0 += width) {
    const int w = static_cast<int>(min(static_cast<size_t>(width), P - col0));
    load_rows(tile, xt + col0, rows, w, S, P);
    cp_async_wait_all();
    __syncthreads();
    if (t < rows) {
      T* row = tile + t * S;
      int j = 0;
      if (col0 == 0) acc = row[j++];
#pragma unroll 8
      for (; j < w; ++j) {
        acc = Acc<T>::add(acc, row[j]);
        row[j] = acc;
      }
    }
    __syncthreads();
    store_rows(ot + col0, tile, rows, w, S, P);
    __syncthreads();  // the next chunk's copies overwrite the tile
  }
}

// The tile plan: rows a tile, the chunk width, the shared row stride (odd)
// and shared bytes.
template <typename T>
void plan(int R, int P, int* rows_per_tile, int* width, int* S, size_t* smem) {
  *width = P;
  *S = P | 1;
  size_t fit = kTileBytes / (static_cast<size_t>(*S) * sizeof(T));
  if (fit == 0) {  // rows longer than a tile: column chunks of kRows rows
    *width = static_cast<int>(kTileBytes / (kRows * sizeof(T))) - 1;
    *S = *width | 1;
    fit = kRows;
  }
  *rows_per_tile = static_cast<int>(fit < kRows ? fit : kRows);
  if (*rows_per_tile > R) *rows_per_tile = R;
  *smem = static_cast<size_t>(*rows_per_tile) * *S * sizeof(T) + 16;
}

template <typename T>
int launch(const void* x, void* out, int R, int P, void* stream) {
  if (R > 0 && P > 0) {
    int rows_per_tile, width, S;
    size_t smem;
    plan<T>(R, P, &rows_per_tile, &width, &S, &smem);
    const unsigned grid = static_cast<unsigned>((static_cast<long long>(R) + rows_per_tile - 1) /
                                                rows_per_tile);
    cudaError_t err = cudaFuncSetAttribute(
        seq_cumsum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    seq_cumsum_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(out), R, P, rows_per_tile, width, S);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int seq_cumsum_f64(const void* x, void* out, int R, int P, void* stream) {
  return launch<double>(x, out, R, P, stream);
}

extern "C" int seq_cumsum_f32(const void* x, void* out, int R, int P, void* stream) {
  return launch<float>(x, out, R, P, stream);
}

extern "C" int seq_cumsum_f16(const void* x, void* out, int R, int P, void* stream) {
  return launch<__half>(x, out, R, P, stream);
}
