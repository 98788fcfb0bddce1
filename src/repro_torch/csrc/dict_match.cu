// K3: KS distance and eq. 3 gate of one sorted candidate against D rows.
//
// Replaces the TPU kernel src/repro/kernels/dict_match.py::dict_match_pallas
// (body _dict_match_kernel), batched over channels: xs (C, n) sorted, rows
// (C, D, n) in any order, dmin/dmax (C, D) -> ks (C, D) float32 and
// mm (C, D) bool.  It is the encoder's "ops" matcher: one launch per block
// step for all C channels.
//
// Bound.  Each row is read once, so the bytes are few (0.69 us at the MAG
// step on an H100); the least work per row is a sort (n log2 n compares)
// and a merge.  The broadcast counts of the TPU kernel take 3 n^2 compares
// a row, so the design sorts and searches instead.
//
// Design.  One CTA per (channel, run of rows), W warps a CTA; warp w
// counts rows w, w + W, ... of the run.
//   * Staging: the run of rows is one contiguous span of the rows tensor.
//     The CTA copies it into shared memory with 16-byte cp.async (its
//     shared image shifted by the span's address modulo 16, 4-byte copies
//     for the head and tail), with the rows' extremes and the candidate,
//     then waits once.
//   * Candidate: every warp checks by a ballot over adjacent pairs that it
//     is sorted (NaNs last, as torch.sort leaves it); if it is not, warp 0
//     sorts a copy behind a barrier.  The searches for #{x <= d_k} run over
//     the sorted copy (the candidate itself when it is sorted); the d1 term
//     and the gate keep the candidate's own points, indices, xs[0] and
//     xs[n-1], so an unsorted candidate gives the broadcast formula's
//     result, as the TPU kernel does.
//   * Rows: a ballot checks that the row is sorted (the ops path passes the
//     dictionary's rows, which are); an unsorted row is sorted by a bitonic
//     network on keys that order every NaN last whatever its sign (-0.0 and
//     +0.0, and ties, land in any order: the <= counts do not see it).  The
//     d2 term is a maximum over the row's points, so sorting the row
//     changes no value.
//   * Counts, up to n = 128 (the encoder's n = 32 and 111): lane l holds
//     the points l + 32 e of the row and of the candidate in registers; the
//     ballot and the sort (shuffles across lanes) run there, the row goes
//     to the warp's shared row with a NaN tail, and ks_count.cuh's
//     ks_padded counts: every array is padded with NaNs to np2 words, so
//     each search is a branch-free binary search (count_le), a lane's
//     searches are stepped together, and #{d <= d_k} = k + 1 unless the
//     next point ties.  Above n = 128, or for an unsorted candidate (whose
//     d1 points are in no order), ks_warp, the routine K1 counts with
//     (three binary searches a point, stepped together), over the row
//     sorted in shared memory.
//   * Grid: rows a warp as few as let the whole grid run in one wave of
//     the card's CTA slots (dict_match_plan); shared memory admits n = 4096
//     (6 warps a CTA).
// Measured on an NVIDIA H100 80GB HBM3 (700 W): 8.2 / 17.9 us at the MAG /
// ANG step on sorted rows, held by the launch floor (3.3 us) and the
// staging at MAG and by the counts' instruction issue at ANG.  Points
// strided by 32 keep a search's loads in distinct banks (a run of
// consecutive points a lane put four lanes on a bank).
// Arithmetic: ks_arith.cuh's gaps and gate, the library built with
// -fmad=false, so every value equals the plain version's bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "ks_count.cuh"

namespace {

constexpr int kMaxWarps = 8;

// a before b in the sort order: non-decreasing, NaNs last (a <= b is false
// when either is a NaN).
__device__ __forceinline__ bool in_order(float a, float b) { return a <= b || isnan(b); }

__device__ __forceinline__ bool warp_sorted(const float* a, int n, int lane) {
  bool ok = true;
  for (int k = lane; k + 1 < n; k += 32) ok = ok && in_order(a[k], a[k + 1]);
  return __all_sync(0xffffffffu, ok);
}

// Sort key: the float order as unsigned integers, every NaN last.
__device__ __forceinline__ unsigned sort_key(float f) {
  const unsigned b = __float_as_uint(f);
  if (isnan(f)) return 0xffffffffu;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);  // NaN key -> NaN
}

// Bitonic sort of a[0, n) in place by a warp; a holds np2 >= n words (np2 a
// power of two >= 32), the tail padded with the NaN key.
__device__ void warp_sort(float* a, int n, int np2, int lane) {
  unsigned* u = reinterpret_cast<unsigned*>(a);
  for (int k = lane; k < np2; k += 32) u[k] = k < n ? sort_key(a[k]) : 0xffffffffu;
  __syncwarp();
  const int half = np2 >> 1;
  for (int k = 2; k <= np2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = lane; p < half; p += 32) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const unsigned lo = u[i], hi = u[i + j];
        const unsigned mn = min(lo, hi), mx = max(lo, hi);
        const bool up = (i & k) == 0;
        u[i] = up ? mn : mx;
        u[i + j] = up ? mx : mn;
      }
      __syncwarp();
    }
  }
  for (int k = lane; k < n; k += 32) a[k] = from_key(u[k]);
  __syncwarp();
}

// The same network in registers for np2 = 32 E: lane l holds the keys of
// positions l + 32 e.  Exchanges across lanes (j < 32) go by shuffle, the
// others within a lane.
template <int E>
__device__ __forceinline__ void warp_sort_regs(unsigned (&u)[E], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < 32) {
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const unsigned o = __shfl_xor_sync(0xffffffffu, u[e], j);
          const bool up = ((lane + 32 * e) & k) == 0;
          u[e] = (lower == up) ? min(u[e], o) : max(u[e], o);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int f = e ^ (j / 32);
          if (f > e) {
            const bool up = ((lane + 32 * e) & k) == 0;
            const unsigned mn = min(u[e], u[f]), mx = max(u[e], u[f]);
            u[e] = up ? mn : mx;
            u[f] = up ? mx : mn;
          }
        }
      }
    }
  }
}

// A warp's count of one row held in registers (E > 0, n <= 32 E <= 128):
// lane l holds the points l + 32 e of the row (dv, NaN past n) and their
// next points (dn).  The row is sorted by shuffles if the ballot finds it
// unsorted; then it is written, with its NaN tail already in place, to the
// warp's shared row, where ks_padded (a sorted candidate, its points in
// xv) or ks_warp (an unsorted one) counts it.
template <int E>
__device__ __forceinline__ float row_ks(float (&dv)[E], float (&dn)[E], float* row,
                                        const float* xsrt, const float* xo, const float (&xv)[E],
                                        const float (&fk)[E], bool cand_sorted, int n, int top,
                                        float inv_n, int lane) {
  const float kNaN = __uint_as_float(0x7fc00000u);
  bool ok = true;
#pragma unroll
  for (int e = 0; e < E; ++e) ok = ok && in_order(dv[e], dn[e]);
  const bool sorted = __all_sync(0xffffffffu, ok);
  if (!sorted) {
    unsigned u[E];
#pragma unroll
    for (int e = 0; e < E; ++e) u[e] = sort_key(dv[e]);
    warp_sort_regs<E>(u, lane);
#pragma unroll
    for (int e = 0; e < E; ++e) dv[e] = from_key(u[e]);
  }
  __syncwarp();  // the previous row's searches are done with the shared row
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = lane + 32 * e;
    if (k < n) row[k] = dv[e];
  }
  __syncwarp();
  if (!sorted) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = lane + 32 * e;
      dn[e] = k + 1 < 32 * E ? row[k + 1] : kNaN;
    }
  }
  constexpr int L = E == 1 ? 5 : (E == 2 ? 6 : 7);  // 32 E = 2^L words
  if (cand_sorted) return ks_padded<E, L>(row, xsrt, xv, dv, dn, fk, inv_n, lane);
  return ks_warp(row, xsrt, xo, n, top, inv_n, lane);
}

// The CTA stages its run of rows whole (one contiguous span of the rows
// tensor) and their extremes with the candidate, then each warp counts its
// rows.  Shared words: the candidate and its sorted copy (np2 each), a row
// a warp (np2), the extremes (2 x run), then the span, shifted to its
// source's address modulo 16.
template <int E>
__global__ void __launch_bounds__(32 * kMaxWarps)
dict_match_kernel(const float* __restrict__ xs, const float* __restrict__ rows,
                  const float* __restrict__ dmin, const float* __restrict__ dmax,
                  float* __restrict__ ks, uint8_t* __restrict__ mm, int D, int n, int np2,
                  int rows_per_warp, float rel_tol, float inv_n) {
  extern __shared__ __align__(16) float smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int run = W * rows_per_warp;
  const int c = blockIdx.y;
  const int d0 = blockIdx.x * run;
  const int count = min(run, D - d0);
  float* s_xo = smem;
  float* s_xs = s_xo + np2;
  float* s_row = s_xs + np2 + warp * np2;
  float* s_lo = s_xs + np2 + W * np2;
  float* s_hi = s_lo + run;
  const float* src = rows + (static_cast<size_t>(c) * D + d0) * n;
  float* stage = s_lo + ((2 * run + 3) & ~3) + ((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const size_t o0 = static_cast<size_t>(c) * D + d0;

  load_span(stage, src, static_cast<size_t>(count) * n);
  const float* xg = xs + static_cast<size_t>(c) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async_elem(s_xo + i, xg + i);
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    cp_async_elem(s_lo + i, dmin + o0 + i);
    cp_async_elem(s_hi + i, dmax + o0 + i);
  }
  // NaNs past n in every array the searches read: they never count
  const float kNaN = __uint_as_float(0x7fc00000u);
  for (int k = n + threadIdx.x; k < np2; k += blockDim.x) s_xo[k] = s_xs[k] = kNaN;
  for (int k = n + lane; k < np2; k += 32) s_row[k] = kNaN;
  cp_async_wait_all();
  __syncthreads();
  // every warp sees the same answer; only an unsorted candidate needs the
  // sorted copy, and a barrier
  const bool cand_sorted = warp_sorted(s_xo, n, lane);
  if (!cand_sorted) {
    if (warp == 0) {
      for (int k = lane; k < n; k += 32) s_xs[k] = s_xo[k];
      __syncwarp();
      warp_sort(s_xs, n, np2, lane);
    }
    __syncthreads();
  }
  const float* xsrt = cand_sorted ? s_xo : s_xs;
  const float xmin = s_xo[0], xmax = s_xo[n - 1];
  int top = 1;
  while (2 * top <= n) top *= 2;
  constexpr int kE = E > 0 ? E : 1;
  float xv[kE] = {}, fk[kE] = {};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = lane + 32 * e;
    xv[e] = s_xo[k];  // NaN past n
    fk[e] = k < n ? __fmul_rn(static_cast<float>(k + 1), inv_n) : 0.0f;
  }
  for (int i = warp; i < count; i += W) {
    const float* r = stage + static_cast<size_t>(i) * n;
    float m;
    if constexpr (E == 0) {  // n > 128: the row sorted and counted in shared memory
      __syncwarp();
      for (int k = lane; k < n; k += 32) s_row[k] = r[k];
      __syncwarp();
      if (!warp_sorted(s_row, n, lane)) warp_sort(s_row, n, np2, lane);
      m = ks_warp(s_row, xsrt, s_xo, n, top, inv_n, lane);
    } else {
      float dv[kE], dn[kE];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int k = lane + 32 * e;
        dv[e] = k < n ? r[k] : kNaN;
        dn[e] = k + 1 < n ? r[k + 1] : kNaN;
      }
      m = row_ks<E>(dv, dn, s_row, xsrt, s_xo, xv, fk, cand_sorted, n, top, inv_n, lane);
    }
    if (lane == 0) {
      ks[o0 + i] = m;
      mm[o0 + i] = minmax_gate(xmin, xmax, s_lo[i], s_hi[i], rel_tol);
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, float*,
                          uint8_t*, int, int, int, int, float, float);

// The kernel for n: E = np2 / 32 points a lane in registers up to
// n = 128, the row in shared memory above.
KernelFn kernel_for(int np2) {
  switch (np2) {
    case 32: return dict_match_kernel<1>;
    case 64: return dict_match_kernel<2>;
    case 128: return dict_match_kernel<4>;
    default: return dict_match_kernel<0>;
  }
}

// Rows a warp stages at most: their words (8 warps' worth) stay within
// 32 KB, or one row a warp.
constexpr int kStageFloats = 8192;

int pow2_at_least(int n) {
  int np2 = 32;
  while (np2 < n) np2 *= 2;
  return np2;
}

// Shared bytes of a CTA.
size_t smem_bytes(int np2, int n, int warps, int rpw) {
  const int run = warps * rpw;
  return sizeof(float) * (static_cast<size_t>(2 + warps) * np2 + ((2 * run + 3) & ~3) +
                          static_cast<size_t>(run) * n + 4);
}

}  // namespace

// The launch plan of a (C, D, n) call on the current device: out = {warps
// a CTA (8, or as many as shared memory admits: 6 at n = 4096), rows a warp
// (as few as let the whole grid run in one wave of the card's CTA slots),
// CTAs a channel, shared bytes a CTA, CTA slots of the card}.  It raises the
// kernel's shared-memory limit to the card's opt-in maximum, so that a
// launch asks the runtime nothing; the wrapper asks once per (device, C, D,
// n).
extern "C" int dict_match_plan(int C, int D, int n, int* out) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int np2 = pow2_at_least(n);
  const KernelFn fn = kernel_for(np2);
  int warps = kMaxWarps;
  while (warps > 1 && smem_bytes(np2, n, warps, 1) > static_cast<size_t>(optin)) --warps;
  if (smem_bytes(np2, n, warps, 1) > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  long long rpw_cap = (D + warps - 1) / warps;
  const long long fit = kStageFloats / (static_cast<long long>(warps) * n);
  if (fit < rpw_cap) rpw_cap = fit < 1 ? 1 : fit;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, 32 * warps, smem_bytes(np2, n, warps, static_cast<int>(rpw_cap)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long rpw = (static_cast<long long>(C) * D + slots * warps - 1) / (slots * warps);
  const int rows_per_warp = static_cast<int>(rpw < rpw_cap ? rpw : rpw_cap);
  const int run = warps * rows_per_warp;
  out[0] = warps;
  out[1] = rows_per_warp;
  out[2] = (D + run - 1) / run;
  out[3] = static_cast<int>(smem_bytes(np2, n, warps, rows_per_warp));
  out[4] = static_cast<int>(slots);
  return 0;
}

// One launch with a plan's warps and rows a warp (dict_match_plan must have
// been asked on this device first, for its shared-memory limit).
extern "C" int dict_match_f32(const float* xs, const float* rows, const float* dmin,
                              const float* dmax, float* ks, uint8_t* mm, int C, int D, int n,
                              int warps, int rows_per_warp, float rel_tol, float inv_n,
                              void* stream) {
  if (warps < 1 || warps > kMaxWarps || rows_per_warp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int np2 = pow2_at_least(n);
  const int run = warps * rows_per_warp;
  const dim3 grid((D + run - 1) / run, C);
  kernel_for(np2)<<<grid, 32 * warps, smem_bytes(np2, n, warps, rows_per_warp),
                    static_cast<cudaStream_t>(stream)>>>(xs, rows, dmin, dmax, ks, mm, D, n, np2,
                                                         rows_per_warp, rel_tol, inv_n);
  return static_cast<int>(cudaGetLastError());
}
