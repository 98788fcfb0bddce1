// The KS distance of one candidate against one row, counted by a warp.
// Shared by K1 (encode_step.cu) and K3 (dict_match.cu), so both count with
// one routine.
#pragma once

#include "ks_arith.cuh"

// Lane l takes the points j = l, l + 32, ...  At point j the three counts
// #{d <= xp_j}, #{x <= d_j} and #{d <= d_j} are binary searches with the <=
// predicate, stepped together so their loads are in flight at once: from
// the largest power of two top <= n down to 1, a count moves up by the step
// when the element at count + step - 1 still holds the predicate.  d and xs
// are sorted with NaNs last, so the predicate holds on a prefix and each
// search ends on its length: the integer the broadcast compares give, 0 at
// a NaN point.  xp holds the candidate's points in its own order, for the
// d1 term at (j+1)/n (K1 passes its sorted candidate as both xs and xp).
// The d2 term is a maximum over the row's points, so the row's order does
// not matter.  The gaps come from ks_arith.cuh and a shuffle max ends the
// row, so every lane returns the same float.
__device__ __forceinline__ float ks_warp(const float* __restrict__ d,
                                         const float* __restrict__ xs,
                                         const float* __restrict__ xp, int n, int top,
                                         float inv_n, int lane) {
  float m = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float xj = xp[j], dj = d[j];
    int cnt_d = 0, cnt_x = 0, rank_d = 0;
    for (int s = top; s > 0; s >>= 1) {
      const int a = cnt_d + s, b = cnt_x + s, r = rank_d + s;
      if (a <= n && d[a - 1] <= xj) cnt_d = a;
      if (b <= n && xs[b - 1] <= dj) cnt_x = b;
      if (r <= n && d[r - 1] <= dj) rank_d = r;
    }
    m = fmaxf(m, fmaxf(gap_at_candidate(j, cnt_d, inv_n), gap_at_row(cnt_x, rank_d, inv_n)));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// ks_warp for the mixed-mode scan (K1's chan operand), whose candidate and
// rows hold n columns: the lane's nf real points and, past them, +inf pads.
// The counts run over all n columns (a pad counts where the query is +inf)
// and the gaps are taken at the first nf points only, each scaled by the
// lane's inv_n; top is the largest power of two <= n.  The candidate is
// sorted with NaNs last, so its count is a binary search for any query.  A
// row may not be: a row stored at a narrower width and grown since reads
// [.., NaN, +inf pads], so #{d <= +inf} holds on no prefix.  Every other
// query finds the row's predicate on a prefix (+inf and NaN both fail it),
// and a +inf query takes the row's count of non-NaN points, d_le_inf, as
// the broadcast compares of the TPU kernel count it.
__device__ __forceinline__ float ks_warp_padded(const float* __restrict__ d,
                                                const float* __restrict__ xs, int n, int nf,
                                                int top, float inv_n, int d_le_inf,
                                                int lane) {
  const float inf = __int_as_float(0x7f800000);
  float m = 0.0f;
  for (int j = lane; j < nf; j += 32) {
    const float xj = xs[j], dj = d[j];
    int cnt_d = 0, cnt_x = 0, rank_d = 0;
    for (int s = top; s > 0; s >>= 1) {
      const int a = cnt_d + s, b = cnt_x + s, r = rank_d + s;
      if (a <= n && d[a - 1] <= xj) cnt_d = a;
      if (b <= n && xs[b - 1] <= dj) cnt_x = b;
      if (r <= n && d[r - 1] <= dj) rank_d = r;
    }
    if (xj == inf) cnt_d = d_le_inf;
    if (dj == inf) rank_d = d_le_inf;
    m = fmaxf(m, fmaxf(gap_at_candidate(j, cnt_d, inv_n), gap_at_row(cnt_x, rank_d, inv_n)));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// #{a[0, 2^L) <= v} over a sorted with NaNs last, where the tail past the
// data holds NaNs (so it never counts): a branch-free binary search with
// the <= predicate, log2 steps and one last probe at the count.
// The search moves a pointer, so each step is a load at a constant offset,
// a compare and a conditional add.
template <int L>
__device__ __forceinline__ int count_le(const float* __restrict__ a, float v) {
  const float* p = a;
#pragma unroll
  for (int s = 1 << (L - 1); s > 0; s >>= 1) p += p[s - 1] <= v ? s : 0;
  return static_cast<int>(p - a) + (*p <= v ? 1 : 0);
}

// ks_warp's counts for a sorted candidate and rows of n <= 32 E points
// held in arrays of 32 E = 2^L words with NaNs past n: lane l holds the
// points k = l + 32 e of the sorted row (dv, and the next points dn) and of
// the sorted candidate (xv) in registers, NaN past n, and fk = f32((k+1) *
// inv_n), 0 past n.  #{d <= x_k} and #{x <= d_k} are count_le's searches,
// the lane's 2 E of them stepped together so their loads are in flight at
// once (neighbouring lanes probe neighbouring words, so the loads rarely
// meet in a bank); #{d <= d_k} is k + 1 unless the next point ties d_k
// (then a search too).  A NaN point counts 0.  The counts, and so the
// gaps, are the integers ks_warp gives; a gap's product at k + 1 is fk, the
// same float, and a point past n has every term 0.
template <int E, int L>
__device__ __forceinline__ float ks_padded(const float* __restrict__ d,
                                          const float* __restrict__ xs, const float (&xv)[E],
                                          const float (&dv)[E], const float (&dn)[E],
                                          const float (&fk)[E], float inv_n, int lane) {
  const float* pd[E];
  const float* px[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    pd[e] = d;
    px[e] = xs;
  }
#pragma unroll
  for (int s = 1 << (L - 1); s > 0; s >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      pd[e] += pd[e][s - 1] <= xv[e] ? s : 0;
      px[e] += px[e][s - 1] <= dv[e] ? s : 0;
    }
  }
  int cnt_d[E], cnt_x[E];
  bool tie = false;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cnt_d[e] = static_cast<int>(pd[e] - d) + (*pd[e] <= xv[e] ? 1 : 0);
    cnt_x[e] = static_cast<int>(px[e] - xs) + (*px[e] <= dv[e] ? 1 : 0);
    tie = tie || dn[e] <= dv[e];  // dn is NaN past n
  }
  float m = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float rank = isnan(dv[e]) ? 0.0f : fk[e];  // f32(#{d <= d_k} * inv_n)
    if (tie && dn[e] <= dv[e])
      rank = __fmul_rn(static_cast<float>(count_le<L>(d, dv[e])), inv_n);
    const float g1 = fabsf(__fsub_rn(fk[e], __fmul_rn(static_cast<float>(cnt_d[e]), inv_n)));
    const float g2 = fabsf(__fsub_rn(__fmul_rn(static_cast<float>(cnt_x[e]), inv_n), rank));
    m = fmaxf(m, fmaxf(g1, g2));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}
