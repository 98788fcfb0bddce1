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
// Design.  One thread per row.  Rows are independent and short (P = B-1,
// 111 at the paper's phase-angle block), so the serial walk inside a row
// costs little; the TPU's tile of 8 rows has no counterpart here.
//
// Bound.  Bytes: each value is read once and written once, and the adds are
// few, so the bound is memory.  A warp reads 32 rows at one column, so each
// load touches 32 sectors that later columns reuse from L1; staging rows
// through shared memory for coalesced loads is left to later work.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
seq_cumsum_kernel(const T* __restrict__ x, T* __restrict__ out, int R, int P) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const T* xr = x + static_cast<size_t>(r) * P;
  T* orow = out + static_cast<size_t>(r) * P;
  T acc = xr[0];
  orow[0] = acc;
  for (int j = 1; j < P; ++j) {
    acc = Acc<T>::add(acc, xr[j]);
    orow[j] = acc;
  }
}

template <typename T>
int launch(const void* x, void* out, int R, int P, void* stream) {
  if (R > 0 && P > 0) {
    const int grid = (R + kThreads - 1) / kThreads;
    seq_cumsum_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(out), R, P);
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
