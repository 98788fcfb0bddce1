// K1: the fused IDEALEM encode step, scanned over a whole feed.
//
// Replaces the TPU kernel src/repro/kernels/encode_step.py::encode_step_pallas
// (body _encode_step_kernel) without its chan operand.  Per block: the
// min/max gate (eq. 3), in the error-bounded mode the pointwise error gate
// on the raw rows (on their running sum when err_cum), the two-sample KS
// distance (eq. 1) on the rows that pass both, the lowest passing
// dictionary row, the hit/slot/overwrite decision, and the FIFO insert of
// the sorted block (and its raw row) at count % D.
//
// Design.  Blocks of one channel depend on each other through the
// dictionary; channels do not.  The TPU walked dictionary tiles as a
// sequential grid and carried the arg-min in a revisited output block.
// Hopper runs CTAs in no order, so this kernel is scan-resident instead: one
// CTA per channel loops over the channel's blocks, and each thread owns one
// dictionary row (D <= 255 < 256 threads).  In each step the threads compute
// their row's gates and KS distance, a ballot per warp plus a pass over the
// 8 warp minima gives the lowest passing row, thread 0 writes the decision,
// and the CTA inserts the row on a miss.  __syncthreads separates the phases.
// The dictionary -- and in the error-bounded mode its raw rows -- lives in
// shared memory when it fits (D*n*4 bytes each: 113 KB at the paper's D=255,
// n=111, both together 226 KB of the 227 KB a CTA can opt in to), else in
// the carry-out buffers in global memory.
//
// Error gate.  A thread walks its raw row once: each difference x_k - r_k
// (or the running sum of them, added left to right) must be within the
// bound; a NaN fails, as a NaN maximum does.  As in the TPU kernel, a row
// the gate demotes skips the KS.
//
// KS counts.  Both samples are sorted, so each row's ECDF counts come from
// one merge walk (O(n) instead of the TPU kernel's O(n^2) broadcast
// compares).  The counts are integers and equal the broadcast counts; NaNs,
// which sort last and compare false, count 0 as they do there.
//
// Time.  The work per step is small (the gates for every valid row, the KS
// merge of the few rows that pass them), but the steps of a channel are a
// serial chain: each waits for the previous insert, and within a step the
// KS merge of one row runs on one thread between four barriers.  That chain,
// not bytes or operations, sets the kernel's time.  With 64 channels only 64
// of the 132 SMs have work; this simple version leaves that, and the
// per-step barriers, to later work.
//
// Arithmetic matches the plain version op for op (ks_arith.cuh: every
// product and difference rounded on its own, the library built with
// -fmad=false), so no FMA moves a gate comparison or a KS value by an ulp.

#include <cstdint>
#include <cuda_runtime.h>

#include "ks_arith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = 1 << 30;

__device__ __forceinline__ float ks_row(const float* __restrict__ d,
                                        const float* __restrict__ x, int n,
                                        float inv_n) {
  // d1: at the candidate's jump points, |(j+1)/n - #{d <= x_j}/n|
  float d1 = 0.0f;
  int p = 0;
  for (int j = 0; j < n; ++j) {
    const float xj = x[j];
    int cnt = 0;
    if (!isnan(xj)) {
      while (p < n && d[p] <= xj) ++p;
      cnt = p;
    }
    d1 = fmaxf(d1, gap_at_candidate(j, cnt, inv_n));
  }
  // d2: at the row's own points, |#{x <= d_k}/n - #{d <= d_k}/n|
  float d2 = 0.0f;
  int q = 0, r = 0;
  for (int k = 0; k < n; ++k) {
    const float dk = d[k];
    int cx = 0, rd = 0;
    if (!isnan(dk)) {
      while (q < n && x[q] <= dk) ++q;
      while (r < n && d[r] <= dk) ++r;
      cx = q;
      rd = r;
    }
    d2 = fmaxf(d2, gap_at_row(cx, rd, inv_n));
  }
  return fmaxf(d1, d2);
}

// Every |x_k - r_k| (or, cumulative, every |sum_{i<=k} (x_i - r_i)|) within
// the bound; a NaN fails.
__device__ __forceinline__ bool within_bound(const float* __restrict__ r,
                                             const float* __restrict__ x, int n,
                                             float bound, bool cumulative) {
  float acc = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float d = __fsub_rn(x[k], r[k]);
    acc = cumulative ? __fadd_rn(acc, d) : d;
    if (!(fabsf(acc) <= bound)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
encode_scan_kernel(const float* __restrict__ xs, const uint8_t* __restrict__ bvalid,
                   const float* __restrict__ dict_in, const float* __restrict__ dmin_in,
                   const float* __restrict__ dmax_in, const uint8_t* __restrict__ valid_in,
                   const int32_t* __restrict__ count_in, float* __restrict__ dict_out,
                   float* __restrict__ dmin_out, float* __restrict__ dmax_out,
                   uint8_t* __restrict__ valid_out, int32_t* __restrict__ count_out,
                   uint8_t* __restrict__ is_hit, int32_t* __restrict__ slot,
                   uint8_t* __restrict__ overwrite, const float* __restrict__ raw_x,
                   const float* __restrict__ raw_in, float* __restrict__ raw_out,
                   int nb, int n, int D, float d_crit, float rel_tol, float inv_n,
                   float error_bound, int use_minmax, int use_ks, int eb, int err_cum,
                   int dict_in_smem) {
  extern __shared__ float smem[];
  float* s_x = smem;                                         // n
  float* s_rx = s_x + n;                                     // n if eb
  float* s_dmin = s_rx + (eb ? n : 0);                       // D
  float* s_dmax = s_dmin + D;                                // D
  int* s_valid = reinterpret_cast<int*>(s_dmax + D);         // D
  int* s_warp = s_valid + D;                                 // kWarps
  int* s_dec = s_warp + kWarps;                              // do_ins, ins, count
  float* s_dict = reinterpret_cast<float*>(s_dec + 4);       // D * n, optional
  // s_dict + D * n: the raw rows, D * n, optional (eb)

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t dn = static_cast<size_t>(D) * n;
  float* dict = dict_in_smem ? s_dict : dict_out + c * dn;
  float* rdict = eb ? (dict_in_smem ? s_dict + dn : raw_out + c * dn) : nullptr;

  for (size_t i = t; i < dn; i += kThreads) dict[i] = dict_in[c * dn + i];
  if (eb)
    for (size_t i = t; i < dn; i += kThreads) rdict[i] = raw_in[c * dn + i];
  for (int i = t; i < D; i += kThreads) {
    s_dmin[i] = dmin_in[c * D + i];
    s_dmax[i] = dmax_in[c * D + i];
    s_valid[i] = valid_in[c * D + i] != 0;
  }
  if (t == 0) s_dec[2] = count_in[c];
  __syncthreads();

  for (int b = 0; b < nb; ++b) {
    const size_t row = static_cast<size_t>(c) * nb + b;
    for (int i = t; i < n; i += kThreads) s_x[i] = xs[row * n + i];
    if (eb)
      for (int i = t; i < n; i += kThreads) s_rx[i] = raw_x[row * n + i];
    __syncthreads();

    bool pass = false;
    if (t < D && s_valid[t]) {
      pass = !use_minmax ||
             minmax_gate(s_x[0], s_x[n - 1], s_dmin[t], s_dmax[t], rel_tol);
      if (pass && eb) pass = within_bound(rdict + t * n, s_rx, n, error_bound, err_cum);
      if (pass && use_ks) pass = ks_row(dict + t * n, s_x, n, inv_n) <= d_crit;
    }
    // thread index == row index: the lowest passing row is the lowest set
    // ballot bit of the lowest warp that has one
    const unsigned m = __ballot_sync(0xffffffffu, pass);
    if (lane == 0) s_warp[warp] = m ? warp * 32 + __ffs(m) - 1 : kSentinel;
    __syncthreads();

    if (t == 0) {
      int best = kSentinel;
      for (int w = 0; w < kWarps; ++w) best = min(best, s_warp[w]);
      const bool bv = bvalid[row] != 0;
      const int count = s_dec[2];
      const bool hit = (best < kSentinel) && bv;
      const int ins = count % D;
      const bool do_ins = !hit && bv;
      is_hit[row] = hit;
      slot[row] = bv ? (hit ? best : ins) : 0;
      overwrite[row] = do_ins && count >= D;
      s_dec[0] = do_ins;
      s_dec[1] = ins;
      s_dec[2] = count + (do_ins ? 1 : 0);
    }
    __syncthreads();

    if (s_dec[0]) {
      const int ins = s_dec[1];
      for (int i = t; i < n; i += kThreads) dict[ins * n + i] = s_x[i];
      if (eb)
        for (int i = t; i < n; i += kThreads) rdict[ins * n + i] = s_rx[i];
      if (t == 0) {
        s_dmin[ins] = s_x[0];
        s_dmax[ins] = s_x[n - 1];
        s_valid[ins] = 1;
      }
    }
    __syncthreads();
  }

  if (dict_in_smem) {
    for (size_t i = t; i < dn; i += kThreads) dict_out[c * dn + i] = dict[i];
    if (eb)
      for (size_t i = t; i < dn; i += kThreads) raw_out[c * dn + i] = rdict[i];
  }
  for (int i = t; i < D; i += kThreads) {
    dmin_out[c * D + i] = s_dmin[i];
    dmax_out[c * D + i] = s_dmax[i];
    valid_out[c * D + i] = static_cast<uint8_t>(s_valid[i]);
  }
  if (t == 0) count_out[c] = s_dec[2];
}

// Dynamic shared memory: per-step state, the candidate (and its raw row
// with eb), and -- when dict_in_smem -- the dictionary (and its raw rows).
size_t smem_bytes(int n, int D, bool eb, bool dict_in_smem) {
  const int rows = eb ? 2 : 1;
  const size_t base = sizeof(float) * (static_cast<size_t>(rows) * n + 2 * D) +
                      sizeof(int) * (D + kWarps + 4);
  return base + (dict_in_smem ? sizeof(float) * rows * static_cast<size_t>(D) * n : 0);
}

}  // namespace

extern "C" int encode_scan_f32(const float* xs, const uint8_t* bvalid, const float* dict_in,
                               const float* dmin_in, const float* dmax_in,
                               const uint8_t* valid_in, const int32_t* count_in,
                               float* dict_out, float* dmin_out, float* dmax_out,
                               uint8_t* valid_out, int32_t* count_out, uint8_t* is_hit,
                               int32_t* slot, uint8_t* overwrite, const float* raw_x,
                               const float* raw_in, float* raw_out, int C, int nb, int n,
                               int D, float d_crit, float rel_tol, float inv_n,
                               float error_bound, int use_minmax, int use_ks, int eb,
                               int err_cum, void* stream) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const bool in_smem = smem_bytes(n, D, eb, true) <= static_cast<size_t>(max_smem);
  const size_t smem = smem_bytes(n, D, eb, in_smem);
  cudaError_t err = cudaFuncSetAttribute(
      encode_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  encode_scan_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, bvalid, dict_in, dmin_in, dmax_in, valid_in, count_in, dict_out, dmin_out,
      dmax_out, valid_out, count_out, is_hit, slot, overwrite, raw_x, raw_in, raw_out, nb, n,
      D, d_crit, rel_tol, inv_n, error_bound, use_minmax, use_ks, eb, err_cum,
      in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// Whether a feed of this shape keeps its dictionary in shared memory (for
// the checks that exercise both layouts).
extern "C" int encode_scan_dict_in_smem(int n, int D, int eb) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return smem_bytes(n, D, eb != 0, true) <= static_cast<size_t>(max_smem);
}
