// K3: KS distance and eq. 3 gate of one sorted candidate against D rows.
//
// Replaces the TPU kernel src/repro/kernels/dict_match.py::dict_match_pallas
// (body _dict_match_kernel), batched over channels: xs (C, n) sorted, rows
// (C, D, n) in any order, dmin/dmax (C, D) -> ks (C, D) float32 and
// mm (C, D) bool.  It is the encoder's "ops" matcher: one launch per block
// step for all C channels.
//
// Design.  One warp per (channel, row); a CTA holds 8 warps, i.e. 8 rows of
// one channel, and stages the channel's candidate once and each warp's row
// in shared memory.  Rows are in any order, so the counts are the TPU
// kernel's broadcast counts rather than K1's merge walk: lane l takes the
// points j = l, l + 32, ... and counts, by one loop over the n samples,
// #{d <= x_j} (d1 at the candidate's points), #{x <= d_j} and the row's own
// rank #{d <= d_j} (d2 at the row's points).  A shuffle max over the warp
// gives the row's distance; fmaxf of the non-NaN gaps is order-free, so the
// result does not depend on which lane saw which point.  NaNs compare false
// and count 0, as in the broadcast compares.
//
// Bound.  About 3 n^2 compares per row: at the encoder's shapes (D=255 rows,
// n=32 or 111, 64 channels) the operations outweigh the bytes (each row is
// read once), so the kernel is bound by operations; this simple version
// spends about ten instructions per compare triple and is latency-bound
// well above that.  Sorting rows on insert (binary-search counts) is later
// work.

#include <cstdint>
#include <cuda_runtime.h>

#include "ks_arith.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
dict_match_kernel(const float* __restrict__ xs, const float* __restrict__ rows,
                  const float* __restrict__ dmin, const float* __restrict__ dmax,
                  float* __restrict__ ks, uint8_t* __restrict__ mm, int D, int n,
                  float rel_tol, float inv_n) {
  extern __shared__ float smem[];
  float* s_x = smem;                       // n
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarps + warp;
  float* s_d = smem + n * (1 + warp);      // n, this warp's row

  const float* xg = xs + static_cast<size_t>(c) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) s_x[i] = xg[i];
  if (d < D) {
    const float* dg = rows + (static_cast<size_t>(c) * D + d) * n;
    for (int i = lane; i < n; i += 32) s_d[i] = dg[i];
  }
  __syncthreads();
  if (d >= D) return;

  float m = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float xj = s_x[j], dj = s_d[j];
    int cnt_d = 0, cnt_x = 0, rank_d = 0;
    for (int k = 0; k < n; ++k) {
      const float dk = s_d[k], xk = s_x[k];
      cnt_d += dk <= xj;
      cnt_x += xk <= dj;
      rank_d += dk <= dj;
    }
    m = fmaxf(m, fmaxf(gap_at_candidate(j, cnt_d, inv_n),
                       gap_at_row(cnt_x, rank_d, inv_n)));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) {
    const size_t o = static_cast<size_t>(c) * D + d;
    ks[o] = m;
    mm[o] = minmax_gate(s_x[0], s_x[n - 1], dmin[o], dmax[o], rel_tol);
  }
}

}  // namespace

extern "C" size_t dict_match_smem_bytes(int n) {
  return sizeof(float) * static_cast<size_t>(n) * (1 + kWarps);
}

extern "C" int dict_match_f32(const float* xs, const float* rows, const float* dmin,
                              const float* dmax, float* ks, uint8_t* mm, int C, int D,
                              int n, float rel_tol, float inv_n, void* stream) {
  const size_t smem = dict_match_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      dict_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((D + kWarps - 1) / kWarps, C);
  dict_match_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, rows, dmin, dmax, ks, mm, D, n, rel_tol, inv_n);
  return static_cast<int>(cudaGetLastError());
}
