// K1: the fused IDEALEM encode step, scanned over a whole feed.
//
// Replaces the TPU kernel src/repro/kernels/encode_step.py::encode_step_pallas
// (body _encode_step_kernel), its chan operand included.  Per block: the
// min/max gate (eq. 3), in the error-bounded mode the pointwise error gate
// on the raw rows (on their running sum when err_cum), the two-sample KS
// distance (eq. 1) on the rows that pass both, the lowest passing
// dictionary row, the hit/slot/overwrite decision, and the FIFO insert of
// the sorted block (and its raw row) at count % D.
//
// Bound.  Blocks of one channel depend on each other through the
// dictionary; channels do not.  So the kernel is scan-resident: one CTA per
// channel walks the channel's blocks, and the feed's time is the length of
// one block step times the blocks of a channel, far above what its bytes or
// operations need.  The step's latency is what the design shortens.
// Measured on the previous design (one thread's serial merge walk per KS
// row, four barriers), the KS took 96 % of a step's clock on the paper's
// MAG traffic.
//
// Step.  Thread t owns dictionary row t (D <= 255 < 256 threads) for the
// gates; the KS is spread over warps.
//   * Prefetch: while step b runs, cp.async copies block b+1's sorted
//     candidate (and raw row) into the other of two shared buffers; the
//     block mask comes a batch of kBatch steps ahead, and the decisions are
//     staged in shared memory and stored a batch at a time, coalesced.
//   * Gate: each thread checks its row (eq. 3 and, with the bound, the error
//     gate: one thread walks the raw row left to right, so the running sum
//     adds in the contract's order); a ballot per warp gives the mask of
//     passing rows.
//   * KS: warp w takes the w-th passing row in ascending row order, its
//     lanes take the candidate's points, and each count (#{d <= x_j},
//     #{x <= d_j}, #{d <= d_j}) is a binary search with the <= predicate
//     over a sorted array: O(log n) per point where the merge walk took O(n)
//     steps of one thread.  Both arrays are sorted with NaNs last, so the
//     predicate holds on a prefix and each count is the integer the
//     broadcast compares give; a NaN point counts 0, as there.  The counts
//     are ks_count.cuh's ks_warp, which K3 shares; the gaps come from
//     ks_arith.cuh, so every KS value is the same float.  The first pass in warp order is the lowest
//     passing row; when more rows pass the gate than there are warps,
//     further rounds take the next rows in order until one passes.
//   * Decision: every thread folds the warps' results (eight shared words)
//     and keeps the count in a register, so no thread decides alone behind
//     a barrier.  Barriers per step: the candidate's arrival, the gate's
//     mask, and one per KS round.
// The dictionary -- and in the error-bounded mode its raw rows -- lives in
// shared memory when it fits (D*n*4 bytes each: 113 KB at the paper's D=255,
// n=111, both together 226 KB of the 227 KB a CTA can opt in to, beside the
// step's 4.8 KB), else in the carry-out buffers in global memory.
//
// Chan.  The per-channel parameters (points nf, inv_n, d_crit, the error
// gate's eb and err_cum) sit in one Chan value, filled from the launch's
// scalars.  The mixed-mode scan of adaptive sessions passes a chan operand,
// (C, 8) float32 rows laid out as the TPU kernel's (CHAN_NF, CHAN_INV_N,
// CHAN_DCRIT, CHAN_ERRCUM, CHAN_EBON), and a second instantiation of the
// kernel fills Chan from channel c's row.  There the candidates and rows
// hold n columns, the lane's nf real points and +inf pads after them: the
// eq. 3 gate and the stored maximum read x[nf - 1] (the masked maximum:
// NaNs sort after the pads), the error gate covers the first nf raw
// columns, and the KS counts run over all n columns with the gaps taken at
// the first nf points (ks_count.cuh's ks_warp_padded).  A row stored
// before the cohort grew reads [.., NaN, +inf pads], which is not sorted
// NaN-last, so each row's NaN count is kept beside it (counted at launch,
// set on insert) for the one query that needs it, +inf.  Raw rows are
// carried whenever the launch has a bound; the lane's flag arms its gate.
//
// Arithmetic matches the plain version op for op (ks_arith.cuh: every
// product and difference rounded on its own, the library built with
// -fmad=false), so no FMA moves a gate comparison or a KS value by an ulp.

#include <cstdint>
#include <cuda_runtime.h>

#include "ks_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = 1 << 30;
constexpr int kBatch = 128;  // steps whose masks and decisions move together
constexpr int kChanStride = 8;  // floats a channel in the chan operand
enum { kChanNf, kChanInvN, kChanDcrit, kChanErrCum, kChanEbOn };

struct Chan {
  int nf;        // points of a block (the row stride is n)
  float inv_n;   // f32(1 / nf)
  float d_crit;  // critical KS distance
  int eb;        // error gate on
  int err_cum;   // on the running sum of differences
};

// Every |x_k - r_k| (or, cumulative, every |sum_{i<=k} (x_i - r_i)|) within
// the bound; a NaN fails.  The sum adds left to right; four differences are
// loaded at a time, so their loads are in flight together.
__device__ __forceinline__ bool within_bound(const float* __restrict__ r,
                                             const float* __restrict__ x, int n,
                                             float bound, bool cumulative) {
  float acc = 0.0f;
  int k = 0;
  for (; k + 4 <= n; k += 4) {
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) d[u] = __fsub_rn(x[k + u], r[k + u]);
    bool ok = true;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc = cumulative ? __fadd_rn(acc, d[u]) : d[u];
      ok = ok && fabsf(acc) <= bound;
    }
    if (!ok) return false;
  }
  for (; k < n; ++k) {
    const float d = __fsub_rn(x[k], r[k]);
    acc = cumulative ? __fadd_rn(acc, d) : d;
    if (!(fabsf(acc) <= bound)) return false;
  }
  return true;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Block row's candidate (and raw row) into the shared buffers.
__device__ __forceinline__ void prefetch(float* s_x, float* s_rx, const float* __restrict__ xs,
                                         const float* __restrict__ raw_x, size_t row, int n,
                                         bool eb) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    cp_async4(s_x + i, xs + row * n + i);
    if (eb) cp_async4(s_rx + i, raw_x + row * n + i);
  }
  cp_async_commit();
}

template <bool kChan>
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
                   float error_bound, int use_minmax, int use_ks, int eb_in, int err_cum,
                   int dict_in_smem, const float* __restrict__ chan) {
  const int c = blockIdx.x;
  Chan ch{n, inv_n, d_crit, eb_in, err_cum};
  if (kChan) {
    const float* p = chan + static_cast<size_t>(c) * kChanStride;
    ch = Chan{static_cast<int>(p[kChanNf]), p[kChanInvN], p[kChanDcrit],
              eb_in && p[kChanEbOn] != 0.0f, p[kChanErrCum] != 0.0f};
  }
  const bool eb = eb_in != 0;  // raw rows carried (ch.eb: the gate armed)
  const size_t dn = static_cast<size_t>(D) * n;
  extern __shared__ float smem[];
  float* s_dict = smem;                                          // D * n, optional
  float* s_rdict = s_dict + (dict_in_smem ? dn : 0);             // D * n, optional (eb)
  float* s_x = s_rdict + (dict_in_smem && eb ? dn : 0);          // 2 * n
  float* s_rx = s_x + 2 * n;                                     // 2 * n if eb
  float* s_dmin = s_rx + (eb ? 2 * n : 0);                       // D
  float* s_dmax = s_dmin + D;                                    // D
  unsigned* s_gate = reinterpret_cast<unsigned*>(s_dmax + D);    // kWarps
  int* s_res = reinterpret_cast<int*>(s_gate + kWarps);          // 2 x kWarps
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_res + 2 * kWarps);  // D
  uint8_t* s_hit = s_valid + D;                                  // kBatch
  uint8_t* s_slot = s_hit + kBatch;                              // kBatch (slot < 256)
  uint8_t* s_ow = s_slot + kBatch;                               // kBatch
  uint8_t* s_bv = s_ow + kBatch;                                 // 2 x kBatch
  int* s_nanc = reinterpret_cast<int*>(s_valid + (D + 5 * kBatch + 3) / 4 * 4);  // D if kChan

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  float* dict = dict_in_smem ? s_dict : dict_out + c * dn;
  float* rdict = eb ? (dict_in_smem ? s_rdict : raw_out + c * dn) : nullptr;
  const size_t row0 = static_cast<size_t>(c) * nb;
  int top = 1;
  while (2 * top <= n) top *= 2;

  prefetch(s_x, s_rx, xs, raw_x, row0, n, eb);
  for (size_t i = t; i < dn; i += kThreads) dict[i] = dict_in[c * dn + i];
  if (eb)
    for (size_t i = t; i < dn; i += kThreads) rdict[i] = raw_in[c * dn + i];
  for (int i = t; i < D; i += kThreads) {
    s_dmin[i] = dmin_in[c * D + i];
    s_dmax[i] = dmax_in[c * D + i];
    s_valid[i] = valid_in[c * D + i] != 0;
  }
  // the masks of the first two batches; bv_next holds the third's
  uint8_t bv_next = 0;
  if (t < kBatch) {
    s_bv[t] = t < nb ? bvalid[row0 + t] : 0;
    s_bv[kBatch + t] = kBatch + t < nb ? bvalid[row0 + kBatch + t] : 0;
    bv_next = 2 * kBatch + t < nb ? bvalid[row0 + 2 * kBatch + t] : 0;
  }
  int count = count_in[c];
  if (kChan) {  // each row's NaN count, once the copies above have landed
    __syncthreads();
    for (int r = t; r < D; r += kThreads) {
      int k = 0;
      for (int i = 0; i < n; ++i) k += isnan(dict[r * n + i]) ? 1 : 0;
      s_nanc[r] = k;
    }
  }

  for (int b = 0; b < nb; ++b) {
    const int j = b % kBatch;
    const float* x = s_x + (b & 1) * n;
    const float* rx = s_rx + (b & 1) * n;
    // the candidate has landed; the last step's insert and reads are done
    cp_async_wait_all();
    __syncthreads();
    if (b + 1 < nb)
      prefetch(s_x + ((b + 1) & 1) * n, s_rx + ((b + 1) & 1) * n, xs, raw_x, row0 + b + 1, n,
               eb);
    if (j == 0 && b > 0) {
      // store the last batch's decisions; stage the mask of the next batch
      if (t < kBatch) {
        const size_t r = row0 + b - kBatch + t;
        is_hit[r] = s_hit[t];
        slot[r] = s_slot[t];
        overwrite[r] = s_ow[t];
        const int next = b / kBatch + 1;
        s_bv[(next & 1) * kBatch + t] = bv_next;
        const int ahead = (next + 1) * kBatch + t;
        bv_next = ahead < nb ? bvalid[row0 + ahead] : 0;
      }
    }
    const bool bv = s_bv[((b / kBatch) & 1) * kBatch + j] != 0;

    int best = kSentinel;
    if (bv) {
      bool pass = false;
      if (t < D && s_valid[t]) {
        pass = !use_minmax ||
               minmax_gate(x[0], x[ch.nf - 1], s_dmin[t], s_dmax[t], rel_tol);
        if (pass && ch.eb) pass = within_bound(rdict + t * n, rx, ch.nf, error_bound, ch.err_cum);
      }
      const unsigned m = __ballot_sync(0xffffffffu, pass);
      if (lane == 0) s_gate[warp] = m;
      __syncthreads();

      if (use_ks) {
        int total = 0;
        for (int w = 0; w < kWarps; ++w) total += __popc(s_gate[w]);
        for (int r = 0; r * kWarps < total; ++r) {
          // warp w takes the (r * kWarps + w)-th passing row
          const int k = r * kWarps + warp;
          int res = kSentinel;
          if (k < total) {
            int w = 0, before = 0;
            unsigned word = s_gate[0];
            while (before + __popc(word) <= k) {
              before += __popc(word);
              word = s_gate[++w];
            }
            for (int i = before; i < k; ++i) word &= word - 1;
            const int row = w * 32 + __ffs(word) - 1;
            const float ks =
                kChan ? ks_warp_padded(dict + row * n, x, n, ch.nf, top, ch.inv_n,
                                       n - s_nanc[row], lane)
                      : ks_warp(dict + row * n, x, x, n, top, ch.inv_n, lane);
            if (ks <= ch.d_crit) res = row;
          }
          if (lane == 0) s_res[(r & 1) * kWarps + warp] = res;
          __syncthreads();
          for (int w = 0; w < kWarps; ++w) best = min(best, s_res[(r & 1) * kWarps + w]);
          if (best < kSentinel) break;
        }
      } else {
        for (int w = kWarps - 1; w >= 0; --w)
          if (s_gate[w]) best = w * 32 + __ffs(s_gate[w]) - 1;
      }
    }

    // every thread decides alike
    const bool hit = best < kSentinel;  // implies bv
    const int ins = count % D;
    const bool do_ins = !hit && bv;
    if (t == 0) {
      s_hit[j] = hit;
      s_slot[j] = static_cast<uint8_t>(bv ? (hit ? best : ins) : 0);
      s_ow[j] = do_ins && count >= D;
    }
    if (do_ins) {
      for (int i = t; i < n; i += kThreads) dict[ins * n + i] = x[i];
      if (eb)
        for (int i = t; i < n; i += kThreads) rdict[ins * n + i] = rx[i];
      if (t == 0) {
        s_dmin[ins] = x[0];
        s_dmax[ins] = x[ch.nf - 1];
        s_valid[ins] = 1;
        if (kChan) {  // the candidate is sorted: its NaNs are its tail
          int k = n;
          while (k > 0 && isnan(x[k - 1])) --k;
          s_nanc[ins] = n - k;
        }
      }
      ++count;
    }
  }
  __syncthreads();

  // the last batch's decisions and the carry
  const int last = nb - 1 - (nb - 1) % kBatch;
  for (int i = t; last + i < nb; i += kThreads) {
    const size_t r = row0 + last + i;
    is_hit[r] = s_hit[i];
    slot[r] = s_slot[i];
    overwrite[r] = s_ow[i];
  }
  if (dict_in_smem) {
    for (size_t i = t; i < dn; i += kThreads) dict_out[c * dn + i] = dict[i];
    if (eb)
      for (size_t i = t; i < dn; i += kThreads) raw_out[c * dn + i] = rdict[i];
  }
  for (int i = t; i < D; i += kThreads) {
    dmin_out[c * D + i] = s_dmin[i];
    dmax_out[c * D + i] = s_dmax[i];
    valid_out[c * D + i] = s_valid[i];
  }
  if (t == 0) count_out[c] = count;
}

// Dynamic shared memory: the candidate buffers (and raw rows with eb), the
// row extremes, the gate and KS words, the valid flags, the staged
// decisions and masks, with chan the rows' NaN counts, and -- when
// dict_in_smem -- the dictionary (and its raw rows).
size_t smem_bytes(int n, int D, bool eb, bool chan, bool dict_in_smem) {
  const int rows = eb ? 2 : 1;
  const size_t bytes = static_cast<size_t>(D) + 5 * kBatch;
  const size_t base = sizeof(float) * (2 * static_cast<size_t>(rows) * n + 2 * D) +
                      sizeof(int) * 3 * kWarps + (bytes + 3) / 4 * 4 +
                      (chan ? sizeof(int) * D : 0);
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
                               int err_cum, const float* chan, void* stream) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const bool has_chan = chan != nullptr;
  const bool in_smem =
      smem_bytes(n, D, eb, has_chan, true) <= static_cast<size_t>(max_smem);
  const size_t smem = smem_bytes(n, D, eb, has_chan, in_smem);
  auto kernel = has_chan ? encode_scan_kernel<true> : encode_scan_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, bvalid, dict_in, dmin_in, dmax_in, valid_in, count_in, dict_out, dmin_out,
      dmax_out, valid_out, count_out, is_hit, slot, overwrite, raw_x, raw_in, raw_out, nb, n,
      D, d_crit, rel_tol, inv_n, error_bound, use_minmax, use_ks, eb, err_cum,
      in_smem ? 1 : 0, chan);
  return static_cast<int>(cudaGetLastError());
}

// Whether a feed of this shape keeps its dictionary in shared memory (for
// the checks that exercise both layouts).
extern "C" int encode_scan_dict_in_smem(int n, int D, int eb, int chan) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return smem_bytes(n, D, eb != 0, chan != 0, true) <= static_cast<size_t>(max_smem);
}
