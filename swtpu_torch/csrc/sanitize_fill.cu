// The sanitizer's capture entries, K9: the score-only single-pair fills
// (K1-K3) and the packed-pairs fill (K7) with every thread's H stored
// after every step and every boundary read's observed progress stored by
// the reading thread (the kDebugH instantiation; design in
// stripe_kernel.cuh).
//
// Replaces the Pallas kernel of the JAX package
// (swtpu/kernels/pallas_fill.py): `_kernel` in its `debug_h` mode, reached
// through `_stripe_call(debug_h=True)` -> pallas_call :1008, the capture
// `dbg_ref[0, tl, c, r] = hn` :597-598, called by
// swtpu/instrument/sanitize.py `sanitize_stripe` (one pair, linear or
// affine, with or without a table) and `sanitize_pairs_packed` (K7's
// `winject` mode). The JAX package runs it in interpret mode only; here it
// runs the very kernel the production entries run, so the checker holds
// the chained hand-off between stripes to account on the card:
//   * sw_sanitize_stripe_{linear,affine,sub} - the arguments of
//     sw_stripe_score_* without the band, then h, seen, skew, the stream;
//   * sw_sanitize_packed_{linear,affine,sub} - the arguments of
//     sw_packed_score_*, then h, seen, skew, the stream.
// The sub entries pick linear or affine gaps by a flag, as their twins do.
// Each launches exactly its production twin's geometry (stripes, T, ticket
// order), so the capture shows the schedule production runs.
//
// What bounds it on this card. The capture writes 4 bytes per slot, T per
// step per stripe: (m + T - 1) * T * stripes int32, about n * (m + T - 1) *
// 4 bytes, against the chain of m + T - 1 dependent steps per stripe that
// bounds its twin. Neighbouring threads store to neighbouring addresses,
// so each step's stores coalesce into T * 4 contiguous bytes; at debug
// shapes the store stream hides behind the chain. The wrapper caps the
// capture at 2^28 slots (1 GiB): the sanitizer is sized for debug shapes.

#include "stripe_kernel.cuh"

namespace {

template <bool kAffine, bool kSub>
int launch_stripe(const int8_t* a, const int8_t* b, int m, int n,
                  const Model& sc, int T, int* sync, int* bnd, int* bnd_f,
                  int* best, int* right, const Debug& dbg,
                  cudaStream_t stream) {
  return launch<false, kAffine, kSub, false, false, false, false, false,
                true>(a, b, m, n, sc, Block{}, T, sync, bnd, bnd_f, best,
                      right, nullptr, stream, Batch{}, dbg);
}

// n rows per pair, B pairs packed into B*n rows, as K7
template <bool kAffine, bool kSub>
int launch_packed(const int8_t* a, const int8_t* b, int B, int m, int n,
                  const Model& sc, int T, int* sync, int* bnd, int* bnd_f,
                  int* row_best, int* right, const Debug& dbg,
                  cudaStream_t stream) {
  if (B < 1 || n < 1 || (long long)B * n > INT_MAX - kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const Batch bt{1, 0, n, row_best};
  return launch<false, kAffine, kSub, false, false, false, true, false,
                true>(a, b, m, B * n, sc, Block{}, T, sync, bnd, bnd_f,
                      nullptr, right, nullptr, stream, bt, dbg);
}

}  // namespace

// h: (stripes, m + T - 1, T) int32, filled by the caller with a sentinel
// that no slot the kernel schedules keeps; seen: (stripes, m + 1) int32,
// filled with -1; skew: 0, or the test hook's shift.
extern "C" int sw_sanitize_stripe_linear(const int8_t* a, const int8_t* b,
                                         int m, int n, int match,
                                         int mismatch, int gap, int T,
                                         int* sync, int* bnd, int* best,
                                         int* right, int* h, int* seen,
                                         int skew, cudaStream_t stream) {
  const Model sc{match, mismatch, gap, 0, 0, nullptr, 0, kNoBand};
  return launch_stripe<false, false>(a, b, m, n, sc, T, sync, bnd, nullptr,
                                     best, right, Debug{h, seen, skew},
                                     stream);
}

extern "C" int sw_sanitize_stripe_affine(const int8_t* a, const int8_t* b,
                                         int m, int n, int match,
                                         int mismatch, int gap_open,
                                         int gap_extend, int T, int* sync,
                                         int* bnd, int* bnd_f, int* best,
                                         int* right, int* h, int* seen,
                                         int skew, cudaStream_t stream) {
  const Model sc{match, mismatch, 0, gap_open, gap_extend, nullptr, 0,
                 kNoBand};
  return launch_stripe<true, false>(a, b, m, n, sc, T, sync, bnd, bnd_f,
                                    best, right, Debug{h, seen, skew},
                                    stream);
}

// sub: (A, A) int32 row-major on the device; affine != 0 takes
// gap_open/gap_extend and needs bnd_f, affine == 0 takes gap.
extern "C" int sw_sanitize_stripe_sub(const int8_t* a, const int8_t* b,
                                      int m, int n, const int* sub, int A,
                                      int affine, int gap, int gap_open,
                                      int gap_extend, int T, int* sync,
                                      int* bnd, int* bnd_f, int* best,
                                      int* right, int* h, int* seen,
                                      int skew, cudaStream_t stream) {
  const Model sc{0, 0, gap, gap_open, gap_extend, sub, A, kNoBand};
  const Debug dbg{h, seen, skew};
  if (affine) {
    return launch_stripe<true, true>(a, b, m, n, sc, T, sync, bnd, bnd_f,
                                     best, right, dbg, stream);
  }
  return launch_stripe<false, true>(a, b, m, n, sc, T, sync, bnd, nullptr,
                                    best, right, dbg, stream);
}

// n: rows per pair; the scratch as sw_packed_score_*.
extern "C" int sw_sanitize_packed_linear(const int8_t* a, const int8_t* b,
                                         int B, int m, int n, int match,
                                         int mismatch, int gap, int T,
                                         int* sync, int* bnd, int* row_best,
                                         int* right, int* h, int* seen,
                                         int skew, cudaStream_t stream) {
  const Model sc{match, mismatch, gap, 0, 0, nullptr, 0, kNoBand};
  return launch_packed<false, false>(a, b, B, m, n, sc, T, sync, bnd,
                                     nullptr, row_best, right,
                                     Debug{h, seen, skew}, stream);
}

extern "C" int sw_sanitize_packed_affine(const int8_t* a, const int8_t* b,
                                         int B, int m, int n, int match,
                                         int mismatch, int gap_open,
                                         int gap_extend, int T, int* sync,
                                         int* bnd, int* bnd_f,
                                         int* row_best, int* right, int* h,
                                         int* seen, int skew,
                                         cudaStream_t stream) {
  const Model sc{match, mismatch, 0, gap_open, gap_extend, nullptr, 0,
                 kNoBand};
  return launch_packed<true, false>(a, b, B, m, n, sc, T, sync, bnd, bnd_f,
                                    row_best, right, Debug{h, seen, skew},
                                    stream);
}

extern "C" int sw_sanitize_packed_sub(const int8_t* a, const int8_t* b,
                                      int B, int m, int n, const int* sub,
                                      int A, int affine, int gap,
                                      int gap_open, int gap_extend, int T,
                                      int* sync, int* bnd, int* bnd_f,
                                      int* row_best, int* right, int* h,
                                      int* seen, int skew,
                                      cudaStream_t stream) {
  const Model sc{0, 0, gap, gap_open, gap_extend, sub, A, kNoBand};
  const Debug dbg{h, seen, skew};
  if (affine) {
    return launch_packed<true, true>(a, b, B, m, n, sc, T, sync, bnd, bnd_f,
                                     row_best, right, dbg, stream);
  }
  return launch_packed<false, true>(a, b, B, m, n, sc, T, sync, bnd,
                                    nullptr, row_best, right, dbg, stream);
}
