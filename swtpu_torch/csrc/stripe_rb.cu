// K1-K3 redesigned for Hopper: the register-blocked single-pair stripe's
// local score-only entries (design in stripe_rb.cuh). Each stripe's first
// row-major max (reduced by the caller), the right column H[:, m] and,
// through it, H[n, m], in three forms: linear match/mismatch (K1), affine
// match/mismatch (K2) and a substitution table with linear or affine gaps
// (K3).
//
// Replaces, with no band, the Pallas kernel of the JAX package in its
// local single-pair score-only mode (swtpu/kernels/pallas_fill.py
// `stripe_score_fn` :1249 and `stripe_fill_raw` :1072 -> `_stripe_call`
// -> pallas_call :1008), which the stripe template's K1-K3
// (stripe_fill.cu, `sw_stripe_score_{linear,affine,sub}`) served before.
// It serves `score()`, `align(traceback=False)` and the lean traceback's
// forward pass.

#include "stripe_rb.cuh"

// a: (m,) int8; b: (n,) int8; T threads a block (a multiple of 32 up to
// 512), R rows and C columns a thread a step, (R, C) one of the
// instantiated tiles below (stripe_fill.RB_TILES). sync: 1 + S int32,
// zeroed, S = ceil(n / (T * R)); bnd: S - 1 rows of m + 1 int32 (at least
// one); best: (S, 4) int32; right: n + 1 int32.
extern "C" int sw_stripe_rb_linear(const int8_t* a, const int8_t* b, int m,
                                   int n, int match, int mismatch, int gap,
                                   int T, int R, int C, int* sync, int* bnd,
                                   int* best, int* right,
                                   cudaStream_t stream) {
#define SW_RB_TILE(R_, C_)                                                   \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, false, false>(a, b, m, n, match, mismatch, gap, 0, \
                                        0, nullptr, 0, T, sync, bnd, nullptr, \
                                        best, right, stream);                \
  }
  // the default (8, 4) and its neighbours in R and in C: the points of
  // chip_smoke.py's sweep
  SW_RB_TILE(8, 4)
  SW_RB_TILE(4, 4)
  SW_RB_TILE(16, 4)
  SW_RB_TILE(8, 1)
  SW_RB_TILE(8, 2)
  SW_RB_TILE(8, 8)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// as sw_stripe_rb_linear, with gap_open/gap_extend for gap; bnd_f: as bnd
extern "C" int sw_stripe_rb_affine(const int8_t* a, const int8_t* b, int m,
                                   int n, int match, int mismatch,
                                   int gap_open, int gap_extend, int T, int R,
                                   int C, int* sync, int* bnd, int* bnd_f,
                                   int* best, int* right,
                                   cudaStream_t stream) {
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB>(a, b, m, n, match, mismatch, 0,          \
                                    gap_open, gap_extend, nullptr, 0, T,     \
                                    sync, bnd, bnd_f, best, right, stream);  \
  }
  SW_RB_GOTOH_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device, S[a code, b code], codes in
// [-3, A); affine != 0 takes gap_open/gap_extend and bnd_f (as bnd),
// affine == 0 gap (bnd_f unread)
extern "C" int sw_stripe_rb_sub(const int8_t* a, const int8_t* b, int m,
                                int n, const int* sub, int A, int affine,
                                int gap, int gap_open, int gap_extend, int T,
                                int R, int C, int* sync, int* bnd,
                                int* bnd_f, int* best, int* right,
                                cudaStream_t stream) {
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB>(a, b, m, n, 0, 0, gap, gap_open,         \
                                    gap_extend, sub, A, T, sync, bnd, bnd_f, \
                                    best, right, stream);                    \
  }
  if (affine) {
    SW_RB_GOTOH_TILES(true, true)
  } else {
    SW_RB_GOTOH_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
