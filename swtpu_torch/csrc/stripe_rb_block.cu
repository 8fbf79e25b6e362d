// K5 redesigned for Hopper: the register-blocked boundary-injected block
// fill, local or global (NW) (design in stripe_rb.cuh, its kBlock forms),
// in the three scorings.
//
// Replaces `stripe_block_fn` of the JAX package
// (swtpu/kernels/pallas_fill.py :1466 -> `_stripe_call` :856 ->
// pallas_call :1008 with `boundary`, `local` and `want_bottom`), which the
// stripe template's K5 (stripe_block.cu, `sw_stripe_block_*`) served
// before: the anchored reverse pass of the lean traceback's `locate` and
// the row passes of its Hirschberg / Myers-Miller recursion.
//
// In: top (m+1) and left (n+1) H boundaries, both holding the corner;
// affine also top_f (m+1) F of row 0 and left_e (n+1) E of column 0.
// local != 0 keeps the zero floor, 0 runs the global recurrence. Out: the
// per-stripe firsts of the positive max (best), right (n+1) H[:, m] and,
// affine, right_e (n+1) E[:, m]; [0] of each is left to the caller.
// bottom (m+1) H[n, :] and, affine, bottom_f (m+1) F[n, :] are written
// when bottom is not null ([0] left to the caller).
//
// What bounds it on the card: the step chain of K1-K3; the boundaries add
// a load per row and one per column of stripe 0, the exports a store per
// cell of column m and row n.

#define SW_RB_LAUNCH_BOUNDS ext_threads(R), 1
#include "stripe_rb.cuh"

// As the template's sw_stripe_block_linear (stripe_block.cu) with T
// threads (up to 512 at R = 4, 256 at R = 8) of R rows and C columns a
// step, (R, C) one of stripe_fill.RB_EXT_TILES, after T; sync, bnd, best
// as in stripe_rb.cu.
extern "C" int sw_stripe_rb_block_linear(const int8_t* a, const int8_t* b,
                                         int m, int n, int match,
                                         int mismatch, int gap, int T, int R,
                                         int C, int local, const int* top,
                                         const int* left, int* sync,
                                         int* bnd, int* best, int* right,
                                         int* bottom, cudaStream_t stream) {
  const Ext ext{nullptr, 0, top, left, nullptr, nullptr, nullptr, bottom,
                nullptr, local};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, 0, true>(                                \
        a, b, m, n, match, mismatch, gap, 0, 0, nullptr, 0, T, sync, bnd,    \
        nullptr, best, right, stream, ext);                                  \
  }
  SW_RB_GOTOH_TILES(false, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// as sw_stripe_rb_block_linear, with gap_open/gap_extend for gap, F and E
// boundaries and exports; bnd_f: as bnd
extern "C" int sw_stripe_rb_block_affine(
    const int8_t* a, const int8_t* b, int m, int n, int match, int mismatch,
    int gap_open, int gap_extend, int T, int R, int C, int local,
    const int* top, const int* left, const int* top_f, const int* left_e,
    int* sync, int* bnd, int* bnd_f, int* best, int* right, int* right_e,
    int* bottom, int* bottom_f, cudaStream_t stream) {
  const Ext ext{nullptr, 0, top, left, top_f, left_e, right_e, bottom,
                bottom_f, local};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, 0, true>(                                \
        a, b, m, n, match, mismatch, 0, gap_open, gap_extend, nullptr, 0, T, \
        sync, bnd, bnd_f, best, right, stream, ext);                         \
  }
  SW_RB_GOTOH_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device; affine != 0 takes
// gap_open/gap_extend and the affine buffers, affine == 0 takes gap and
// ignores them
extern "C" int sw_stripe_rb_block_sub(
    const int8_t* a, const int8_t* b, int m, int n, const int* sub, int A,
    int affine, int gap, int gap_open, int gap_extend, int T, int R, int C,
    int local, const int* top, const int* left, const int* top_f,
    const int* left_e, int* sync, int* bnd, int* bnd_f, int* best,
    int* right, int* right_e, int* bottom, int* bottom_f,
    cudaStream_t stream) {
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, 0, true>(                                \
        a, b, m, n, 0, 0, gap, gap_open, gap_extend, sub, A, T, sync, bnd,   \
        bnd_f, best, right, stream, ext);                                    \
  }
  if (affine) {
    const Ext ext{nullptr, 0, top, left, top_f, left_e, right_e, bottom,
                  bottom_f, local};
    SW_RB_GOTOH_TILES(true, true)
  } else {
    const Ext ext{nullptr, 0, top, left, nullptr, nullptr, nullptr, bottom,
                  nullptr, local};
    SW_RB_GOTOH_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
