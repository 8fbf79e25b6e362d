// The batch scoring entries, K8 (pair grid) and K7 (packed pairs), for B
// independent pairs of one shape: a (B, m) against b (B, n) int8 codes.
// Both compute each pair's max and its first row-major end cell; positions
// are 1-based in the pair's own matrix (design in stripe_kernel.cuh).
//
// Replaces the Pallas kernels of the JAX package
// (swtpu/kernels/pallas_fill.py):
//   * sw_pairs_score_{linear,affine,sub} - K8, `pairs_score_fn` (its own
//     pallas_call, a grid over (pair, stripe, chunk), `_kernel(pairs=True)`):
//     the kPairs instantiation, one launch of B x S stripe blocks, each
//     pair's stripes chained as in K1; a band argument picks its kBand
//     instantiation, as in the K1-K4 entries;
//   * sw_packed_score_{linear,affine,sub} - K7, `pairs_packed_score_fn`
//     (`_stripe_call(winject=...)`, reset rows `greset`): the kPacked
//     instantiation, the B*n target rows in one stripe chain, each row
//     reading its own pair's query, a reset row at each pair's start.
//
// What bounds them on this card. Each pair is a chain of m + n - 1
// dependent anti-diagonal steps, as in K1; the batch adds parallelism, not
// length. K8 runs the B chains side by side: B*S blocks, so at 64 pairs of
// 1056^2 and T = 256 all 320 blocks are resident at once and the launch
// takes about one pair's chain, (S-1)*T + m + T steps. The step cost (a
// block barrier and a shared-memory hop, ~0.4 us in K1) then bounds it,
// not the cells, as long as the blocks fit the card. K7 chains every
// stripe to the one above it unless the stripe's thread 0 starts a pair,
// so with stripes that do not start on pair boundaries its chain spans
// all B*n rows; the caller picks T to divide n (or a multiple of n) where
// one fits, which cuts the chain at every pair boundary.
//
// The TPU's reason for K7, one ramp bubble shared by the whole batch on a
// single core, does not exist here; it is kept for its measured time
// against K8 and as the form K6 (one window shared by many reads) takes.

#include "stripe_kernel.cuh"

namespace {

// K8: the band's instantiation when sc.band != kNoBand, else the plain one
template <bool kAffine, bool kSub>
int launch_pairs(const int8_t* a, const int8_t* b, int B, int m, int n,
                 const Model& sc, int T, int* sync, int* bnd, int* bnd_f,
                 int* best, int* right, cudaStream_t stream) {
  if (T < 32 || T > kMaxThreads || T % 32) {
    return (int)cudaErrorInvalidValue;
  }
  const Batch bt{B, (n + T - 1) / T, 0, nullptr};
  if (sc.band != kNoBand) {
    return launch<false, kAffine, kSub, true, false, true>(
        a, b, m, n, sc, Block{}, T, sync, bnd, bnd_f, best, right, nullptr,
        stream, bt);
  }
  return launch<false, kAffine, kSub, false, false, true>(
      a, b, m, n, sc, Block{}, T, sync, bnd, bnd_f, best, right, nullptr,
      stream, bt);
}

// K7: n rows per pair, B pairs packed into B*n rows
template <bool kAffine, bool kSub>
int launch_packed(const int8_t* a, const int8_t* b, int B, int m, int n,
                  const Model& sc, int T, int* sync, int* bnd, int* bnd_f,
                  int* row_best, int* right, cudaStream_t stream) {
  if (B < 1 || n < 1 || (long long)B * n > INT_MAX - kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const Batch bt{1, 0, n, row_best};
  return launch<false, kAffine, kSub, false, false, false, true>(
      a, b, m, B * n, sc, Block{}, T, sync, bnd, bnd_f, nullptr, right,
      nullptr, stream, bt);
}

}  // namespace

// K8. sync: 1 + B*S int32, zeroed; bnd (and bnd_f): B*(S-1) rows of m+1
// int32 (at least one row); best: (B, S, 4) int32, each pair's stripe
// bests; right: B*(n+1) int32 scratch.
extern "C" int sw_pairs_score_linear(const int8_t* a, const int8_t* b, int B,
                                     int m, int n, int match, int mismatch,
                                     int gap, int T, int* sync, int* bnd,
                                     int* best, int* right, int band,
                                     cudaStream_t stream) {
  const Model sc{match, mismatch, gap, 0, 0, nullptr, 0, band};
  return launch_pairs<false, false>(a, b, B, m, n, sc, T, sync, bnd, nullptr,
                                    best, right, stream);
}

extern "C" int sw_pairs_score_affine(const int8_t* a, const int8_t* b, int B,
                                     int m, int n, int match, int mismatch,
                                     int gap_open, int gap_extend, int T,
                                     int* sync, int* bnd, int* bnd_f,
                                     int* best, int* right, int band,
                                     cudaStream_t stream) {
  const Model sc{match, mismatch, 0, gap_open, gap_extend, nullptr, 0, band};
  return launch_pairs<true, false>(a, b, B, m, n, sc, T, sync, bnd, bnd_f,
                                   best, right, stream);
}

// sub: (A, A) int32 row-major on the device; affine != 0 takes
// gap_open/gap_extend and needs bnd_f, affine == 0 takes gap.
extern "C" int sw_pairs_score_sub(const int8_t* a, const int8_t* b, int B,
                                  int m, int n, const int* sub, int A,
                                  int affine, int gap, int gap_open,
                                  int gap_extend, int T, int* sync, int* bnd,
                                  int* bnd_f, int* best, int* right, int band,
                                  cudaStream_t stream) {
  const Model sc{0, 0, gap, gap_open, gap_extend, sub, A, band};
  if (affine) {
    return launch_pairs<true, true>(a, b, B, m, n, sc, T, sync, bnd, bnd_f,
                                    best, right, stream);
  }
  return launch_pairs<false, true>(a, b, B, m, n, sc, T, sync, bnd, nullptr,
                                   best, right, stream);
}

// K7. n: rows per pair. sync: 1 + S int32, zeroed, S = ceil(B*n / T);
// bnd (and bnd_f): S-1 rows of m+1 int32 (at least one row); row_best:
// (B*n, 2) int32; right: B*n+1 int32 scratch.
extern "C" int sw_packed_score_linear(const int8_t* a, const int8_t* b,
                                      int B, int m, int n, int match,
                                      int mismatch, int gap, int T,
                                      int* sync, int* bnd, int* row_best,
                                      int* right, cudaStream_t stream) {
  const Model sc{match, mismatch, gap, 0, 0, nullptr, 0, kNoBand};
  return launch_packed<false, false>(a, b, B, m, n, sc, T, sync, bnd,
                                     nullptr, row_best, right, stream);
}

extern "C" int sw_packed_score_affine(const int8_t* a, const int8_t* b,
                                      int B, int m, int n, int match,
                                      int mismatch, int gap_open,
                                      int gap_extend, int T, int* sync,
                                      int* bnd, int* bnd_f, int* row_best,
                                      int* right, cudaStream_t stream) {
  const Model sc{match, mismatch, 0, gap_open, gap_extend, nullptr, 0,
                 kNoBand};
  return launch_packed<true, false>(a, b, B, m, n, sc, T, sync, bnd, bnd_f,
                                    row_best, right, stream);
}

extern "C" int sw_packed_score_sub(const int8_t* a, const int8_t* b, int B,
                                   int m, int n, const int* sub, int A,
                                   int affine, int gap, int gap_open,
                                   int gap_extend, int T, int* sync,
                                   int* bnd, int* bnd_f, int* row_best,
                                   int* right, cudaStream_t stream) {
  const Model sc{0, 0, gap, gap_open, gap_extend, sub, A, kNoBand};
  if (affine) {
    return launch_packed<true, true>(a, b, B, m, n, sc, T, sync, bnd, bnd_f,
                                     row_best, right, stream);
  }
  return launch_packed<false, true>(a, b, B, m, n, sc, T, sync, bnd, nullptr,
                                    row_best, right, stream);
}
