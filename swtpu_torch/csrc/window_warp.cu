// The warp-per-read window scorer, K6 redesigned for Hopper: B reads of
// rlen rows each against one window of W reference columns that every
// read shares; each read's max, its first row-major row and its window
// column, (0, 0, 0) where no cell is positive.
//
// Replaces, for reads of at most 32 * kMaxRows rows, the Pallas kernel of
// the JAX package (swtpu/kernels/pallas_fill.py): `batch_fill_raw` and
// `batch_score_fn`, the reset-mask mode of `_stripe_call(greset)`, the
// database search's window scorer. Longer reads keep the stripe
// template's K6 (window_fill.cu).
//
// What bounds it on this card. The reads are independent: no read's cells
// wait on another's. The template's K6 packs them into stripes of T rows
// and pays a block barrier and a shared-memory hop between warps at every
// step, for T cells; a stripe of 608 threads holds two or three blocks on
// an SM, so 2048 reads of 152 rows run in two waves of W + T - 1 steps.
// Without a barrier the work is issue-bound: about 8 (linear) to 11
// (affine) instructions per cell, issued by 132 SMs x 4 schedulers.
//
// What the design does about it. One warp per read, R = ceil(rlen / 32)
// rows per lane (a template parameter, 1..kMaxRows, so a read pads by
// fewer than 32 rows). Lane l owns rows l*R + 1 .. l*R + R and visits
// column j = t - l + 1 at step t; it runs the R cells of its column top
// down in registers, then hands its last row's H (and, affine, F) to lane
// l + 1 with one __shfl_up_sync. Lane 0 takes the read's own zero row 0
// (UP = DIAG = 0, F = NEG); column 0 is H = 0, E = NEG. There is no
// __syncthreads() anywhere in the kernel: blocks of kWarps reads share
// nothing, so 2048 reads are 2048 resident warps, one wave. Rows past
// rlen are computed but never counted. Each lane keeps (best, first
// column) per row; at the end the warp takes the max with
// __reduce_max_sync and the lowest lane holding it with a ballot (rows
// ascend with the lane and within it), and writes the read's answer: no
// per-row buffer and no reduce after the launch.
//
// The window: every warp reads the columns of its step at about the same
// time, so each lane reads its byte with __ldg, one step ahead of its use;
// the 32-byte warp read is one L1 sector, and the window stays in L1. The
// shared-memory staging of the window was not tried: the load is one
// instruction a step against R cells of 8-11 each, and the kernel runs
// within 1.3x of its int32 operations bound at 2048 x 152 x 32768
// (PERF.md section 6).
//
// Substitution: each lane builds its own column of a lane-major profile
// in shared memory, prof[(q * R + r) * 32 + lane] = S[q, b_row], q < A,
// with the sentinel row q = A (and rows whose read code is a sentinel)
// holding kNegSub; a lane reads only its own bank whatever the window
// code, and needs no barrier. That is (A + 1) * R * 128 bytes a warp: 14 KB
// for BLOSUM62 at R = 5, 4 warps a block in 56 KB, 4 blocks an SM.
//
// Each C entry launches on the given stream, allocates nothing, and
// returns cudaGetLastError() after its launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "sw_cell.cuh"

namespace {

using swcell::kNeg;
using swcell::kNegSub;

constexpr int kWarps = 4;          // reads (warps) a block
constexpr int kMaxRows = 16;       // R_max, rows a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStaticSmemMax = 48 * 1024;

// match/mismatch, gap (linear) or open/extend (affine); sub: (A, A) int32
// row-major S[window code, read code], substitution mode only
struct Scores {
  int match, mismatch, gap, open, extend;
  const int* sub;
  int A;
};

// out: (3, B) int32, row 0 the reads' max, row 1 the 1-based row of the
// first row-major max, row 2 its 1-based window column
template <int R, bool kAffine, bool kSub>
__global__ void __launch_bounds__(kWarps * 32)
window_warp_kernel(const int8_t* __restrict__ window,
                   const int8_t* __restrict__ reads, int B, int W, int rlen,
                   Scores sc, int* __restrict__ out) {
  extern __shared__ int s_prof[];          // kSub: kWarps x (A + 1) x R x 32
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= B) return;                      // whole warps leave
  const int8_t* read = reads + (size_t)g * rlen;
  const int row0 = lane * R;               // rows row0 + 1 .. row0 + R
  int code[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    code[r] = row0 + r < rlen ? read[row0 + r] : -3;
  }
  // this lane's column of its warp's profile; only the lane reads it
  int* prof = s_prof + (size_t)warp * (sc.A + 1) * R * 32 + lane;
  if constexpr (kSub) {
    for (int q = 0; q < sc.A; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        prof[(q * R + r) * 32] =
            code[r] < 0 ? kNegSub : __ldg(&sc.sub[q * sc.A + code[r]]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) prof[(sc.A * R + r) * 32] = kNegSub;
  }

  int H[R], E[R], best[R], best_j[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    H[r] = 0;                // H(i, 0): the lane's column before it enters
    E[r] = kNeg;
    best[r] = best_j[r] = 0;
  }
  int f_last = kNeg;         // affine: F of the lane's last row, this step
  int up_prev = 0;           // H(row0, j - 1): the first row's DIAG
  const int steps = W + (rlen - 1) / R;    // the last lane holding rows
  int a_next = lane == 0 ? __ldg(&window[0]) : 0;

  for (int t = 0; t < steps; ++t) {
    const int j = t - lane + 1;
    const int aj = a_next;
    a_next = (j >= 0 && j < W) ? __ldg(&window[j]) : 0;   // column j + 1
    // UP: lane l - 1's last row in column j, computed at step t - 1
    int up = __shfl_up_sync(kFull, H[R - 1], 1);
    int f_up = kNeg;
    if constexpr (kAffine) f_up = __shfl_up_sync(kFull, f_last, 1);
    if (lane == 0) {         // the shuffle gave lane 0 its own: row 0
      up = 0;
      f_up = kNeg;
    }
    const int up_in = up;
    if (j >= 1 && j <= W) {
      int diag = up_prev;
      const int* p = prof;
      if constexpr (kSub) p += (aj < 0 ? sc.A : aj) * R * 32;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int left = H[r];
        int s;
        if constexpr (kSub) {
          s = p[r * 32];
        } else {
          s = swcell::compare(aj, code[r], sc.match, sc.mismatch);
        }
        int h;
        if constexpr (kAffine) {
          E[r] = swcell::affine_e(E[r], left, sc.open, sc.extend);
          f_up = swcell::affine_f(f_up, up, sc.open, sc.extend);
          h = swcell::affine(diag + s, E[r], f_up);
        } else {
          h = swcell::linear(diag + s, left, up, sc.gap);
        }
        swcell::track(h, j, best[r], best_j[r]);
        diag = left;
        up = h;
        H[r] = h;
      }
      if constexpr (kAffine) f_last = f_up;
    }
    up_prev = up_in;
  }

  // the lane's first max over its rows within the read, then the warp's:
  // the lowest lane holding the max holds its first row
  int lb = 0, li = 0, lj = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r < rlen && best[r] > lb) {
      lb = best[r];
      li = row0 + r + 1;
      lj = best_j[r];
    }
  }
  const int wmax = __reduce_max_sync(kFull, lb);
  const unsigned who = __ballot_sync(kFull, lb == wmax);
  if (lane == __ffs(who) - 1) {            // (0, 0, 0) when wmax is 0
    out[g] = wmax;
    out[B + g] = li;
    out[2 * (size_t)B + g] = lj;
  }
}

template <int R, bool kAffine, bool kSub>
int launch_rows(const int8_t* window, const int8_t* reads, int B, int W,
                int rlen, const Scores& sc, int* out, cudaStream_t stream) {
  const size_t smem =
      kSub ? (size_t)kWarps * (sc.A + 1) * R * 32 * sizeof(int) : 0;
  auto* kernel = window_warp_kernel<R, kAffine, kSub>;
  if (smem > (size_t)kStaticSmemMax) {
    // above 48 KB a block's dynamic shared memory needs an opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(
      window, reads, B, W, rlen, sc, out);
  return (int)cudaGetLastError();
}

// the instantiation of R = ceil(rlen / 32), found by recursion over R
template <bool kAffine, bool kSub, int R = 1>
int launch(const int8_t* window, const int8_t* reads, int B, int W,
           int rlen, const Scores& sc, int* out, cudaStream_t stream) {
  if constexpr (R > kMaxRows) {
    return (int)cudaErrorInvalidValue;
  } else {
    if ((rlen + 31) / 32 == R) {
      return launch_rows<R, kAffine, kSub>(window, reads, B, W, rlen, sc,
                                           out, stream);
    }
    return launch<kAffine, kSub, R + 1>(window, reads, B, W, rlen, sc, out,
                                        stream);
  }
}

template <bool kAffine, bool kSub>
int launch_checked(const int8_t* window, const int8_t* reads, int B, int W,
                   int rlen, const Scores& sc, int* out,
                   cudaStream_t stream) {
  if (B < 1 || W < 1 || rlen < 1 || rlen > 32 * kMaxRows ||
      (long long)B * rlen > INT_MAX || (kSub && (sc.sub == nullptr ||
                                                 sc.A < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<kAffine, kSub>(window, reads, B, W, rlen, sc, out, stream);
}

}  // namespace

// window: (W,) int8; reads: (B, rlen) int8, rlen <= 32 * kMaxRows;
// out: (3, B) int32 (see window_warp_kernel)
extern "C" int sw_window_warp_linear(const int8_t* window,
                                     const int8_t* reads, int B, int W,
                                     int rlen, int match, int mismatch,
                                     int gap, int* out, cudaStream_t stream) {
  const Scores sc{match, mismatch, gap, 0, 0, nullptr, 0};
  return launch_checked<false, false>(window, reads, B, W, rlen, sc, out,
                                      stream);
}

extern "C" int sw_window_warp_affine(const int8_t* window,
                                     const int8_t* reads, int B, int W,
                                     int rlen, int match, int mismatch,
                                     int gap_open, int gap_extend, int* out,
                                     cudaStream_t stream) {
  const Scores sc{match, mismatch, 0, gap_open, gap_extend, nullptr, 0};
  return launch_checked<true, false>(window, reads, B, W, rlen, sc, out,
                                     stream);
}

// sub: (A, A) int32 row-major on the device, S[window code, read code];
// affine != 0 takes gap_open/gap_extend, affine == 0 gap
extern "C" int sw_window_warp_sub(const int8_t* window, const int8_t* reads,
                                  int B, int W, int rlen, const int* sub,
                                  int A, int affine, int gap, int gap_open,
                                  int gap_extend, int* out,
                                  cudaStream_t stream) {
  const Scores sc{0, 0, gap, gap_open, gap_extend, sub, A};
  if (affine) {
    return launch_checked<true, true>(window, reads, B, W, rlen, sc, out,
                                      stream);
  }
  return launch_checked<false, true>(window, reads, B, W, rlen, sc, out,
                                     stream);
}
