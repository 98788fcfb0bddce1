// Matching arithmetic shared by K1 (encode_step.cu) and K3 (dict_match.cu).
//
// The TPU kernels compute the eq. 3 gate and the KS distance's ECDF gaps in
// float32, each product and difference rounded on its own.  These helpers
// spell every rounding (__fmul_rn/__fsub_rn/__fadd_rn) and both libraries
// are built with -fmad=false, so nvcc contracts nothing into an FMA and no
// comparison moves by an ulp.  inv_n and rel_tol arrive as the float32
// roundings of 1/n and of the relative tolerance.
#pragma once

// Eq. 3: both extremes of the candidate within +-(hi - lo) * rel_tol of the
// stored row's extremes.
__device__ __forceinline__ bool minmax_gate(float xmin, float xmax, float lo,
                                            float hi, float rel_tol) {
  const float tol = __fmul_rn(__fsub_rn(hi, lo), rel_tol);
  return (xmin >= __fsub_rn(lo, tol)) && (xmin <= __fadd_rn(lo, tol)) &&
         (xmax >= __fsub_rn(hi, tol)) && (xmax <= __fadd_rn(hi, tol));
}

// d1 term at the candidate's j-th point: |(j+1)/n - #{d <= x_j}/n|.
__device__ __forceinline__ float gap_at_candidate(int j, int cnt_d, float inv_n) {
  return fabsf(__fsub_rn(__fmul_rn(static_cast<float>(j) + 1.0f, inv_n),
                         __fmul_rn(static_cast<float>(cnt_d), inv_n)));
}

// d2 term at a row point d_k: |#{x <= d_k}/n - #{d <= d_k}/n|.
__device__ __forceinline__ float gap_at_row(int cnt_x, int rank_d, float inv_n) {
  return fabsf(__fsub_rn(__fmul_rn(static_cast<float>(cnt_x), inv_n),
                         __fmul_rn(static_cast<float>(rank_d), inv_n)));
}
