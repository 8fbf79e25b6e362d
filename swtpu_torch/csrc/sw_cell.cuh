// The Smith-Waterman cell update on Hopper's DPX instructions, shared by
// the register-blocked kernels (window_warp.cu K6, stripe_rb.cuh K1-K5).
//
// The rules are those of stripe_kernel.cuh's step (and of the JAX
// package's scan): the raw code compare aj == bi scores match or
// mismatch, so N matches N; in substitution mode a sentinel code (< 0)
// scores kNegSub without a table read; E and F start at kNeg; the row
// best is kept under a strict '>' while j ascends, so the first
// row-major occurrence wins.
//
// __viaddmax_s32(a, b, c) = max(a + b, c) and __viaddmax_s32_relu(a, b,
// c) = max(a + b, c, 0) fold a gap add into its max, and
// __vimax3_s32_relu(a, b, c) = max(a, b, c, 0) is the affine cell's
// final max: one instruction each on sm_90. Each form puts the value
// computed in this step by the row above (UP, or F) in the last
// instruction, so the dependent chain down a thread's rows is one DPX
// instruction a row (linear) or two (affine).

#pragma once

#include <cuda_runtime.h>

namespace swcell {

constexpr int kNeg = -(1 << 30);        // affine minus infinity
constexpr int kNegSub = -(1 << 20);     // a sentinel code's score

// H = max(DIAG + s, LEFT + gap, UP + gap, 0); diag_s = DIAG + s
__device__ __forceinline__ int linear(int diag_s, int left, int up,
                                      int gap) {
  return __viaddmax_s32_relu(up, gap, __viaddmax_s32(left, gap, diag_s));
}

// E(i, j) = max(H(i, j-1) + open, E(i, j-1) + extend)
__device__ __forceinline__ int affine_e(int e_left, int h_left, int open,
                                        int extend) {
  return __viaddmax_s32(e_left, extend, h_left + open);
}

// F(i, j) = max(H(i-1, j) + open, F(i-1, j) + extend)
__device__ __forceinline__ int affine_f(int f_up, int h_up, int open,
                                        int extend) {
  return __viaddmax_s32(f_up, extend, h_up + open);
}

// H = max(DIAG + s, E, F, 0)
__device__ __forceinline__ int affine(int diag_s, int e, int f) {
  return __vimax3_s32_relu(diag_s, e, f);
}

// the match/mismatch score: the raw code compare
__device__ __forceinline__ int compare(int aj, int bi, int match,
                                       int mismatch) {
  return aj == bi ? match : mismatch;
}

// the row's (best, first column holding it): a new column only on a
// strict '>' (keep = best >= h)
__device__ __forceinline__ void track(int h, int j, int& best, int& best_j) {
  bool keep;
  best = __vibmax_s32(best, h, &keep);
  best_j = keep ? best_j : j;
}

}  // namespace swcell
