// K5: the boundary-injected block fill entries, local or global (NW)
// (design in stripe_kernel.cuh).
//
// Replaces `stripe_block_fn` (swtpu/kernels/pallas_fill.py :1466 ->
// `_stripe_call` :856 -> pallas_call :1008 with `boundary`, `local` and
// `want_bottom`): the anchored reverse pass of the lean traceback's
// `locate` and the row passes of its Hirschberg / Myers-Miller recursion.
//
// In: top (m+1) and left (n+1) H boundaries, both holding the corner; affine
// also top_f (m+1) F of row 0 and left_e (n+1) E of column 0. local != 0
// keeps the zero floor, 0 runs the global recurrence. Out: the per-stripe
// firsts of the positive max (best), right (n+1) H[:, m] and, affine,
// right_e (n+1) E[:, m]; [0] of each is left to the caller. bottom (m+1)
// H[n, :] and, affine, bottom_f (m+1) F[n, :] are written when bottom is
// not null ([0] left to the caller): the last rows the Hirschberg passes
// need come from this export (the JAX `want_bottom` route), not from a
// transposed fill, so the table is never transposed and n needs no
// particular multiple.
//
// What bounds it on the card: the step chain of the local fill; the
// boundaries add one load per row and one per column of stripe 0, the
// exports one store per cell of column m and row n.

#include "stripe_kernel.cuh"

extern "C" int sw_stripe_block_linear(const int8_t* a, const int8_t* b,
                                      int m, int n, int match, int mismatch,
                                      int gap, int T, int local,
                                      const int* top, const int* left,
                                      int* sync, int* bnd, int* best,
                                      int* right, int* bottom,
                                      cudaStream_t stream) {
  const Model sc{match, mismatch, gap, 0, 0, nullptr, 0, 0};
  const Block blk{top, left, nullptr, nullptr, nullptr, bottom, nullptr,
                  local};
  return launch<false, false, false, false, true>(
      a, b, m, n, sc, blk, T, sync, bnd, nullptr, best, right, nullptr,
      stream);
}

extern "C" int sw_stripe_block_affine(const int8_t* a, const int8_t* b,
                                      int m, int n, int match, int mismatch,
                                      int gap_open, int gap_extend, int T,
                                      int local, const int* top,
                                      const int* left, const int* top_f,
                                      const int* left_e, int* sync, int* bnd,
                                      int* bnd_f, int* best, int* right,
                                      int* right_e, int* bottom,
                                      int* bottom_f, cudaStream_t stream) {
  const Model sc{match, mismatch, 0, gap_open, gap_extend, nullptr, 0, 0};
  const Block blk{top, left, top_f, left_e, right_e, bottom, bottom_f,
                  local};
  return launch<false, true, false, false, true>(
      a, b, m, n, sc, blk, T, sync, bnd, bnd_f, best, right, nullptr,
      stream);
}

// sub: (A, A) int32 row-major on the device; affine != 0 takes
// gap_open/gap_extend and the affine buffers, affine == 0 takes gap and
// ignores them.
extern "C" int sw_stripe_block_sub(const int8_t* a, const int8_t* b, int m,
                                   int n, const int* sub, int A, int affine,
                                   int gap, int gap_open, int gap_extend,
                                   int T, int local, const int* top,
                                   const int* left, const int* top_f,
                                   const int* left_e, int* sync, int* bnd,
                                   int* bnd_f, int* best, int* right,
                                   int* right_e, int* bottom, int* bottom_f,
                                   cudaStream_t stream) {
  const Model sc{0, 0, gap, gap_open, gap_extend, sub, A, 0};
  if (affine) {
    const Block blk{top, left, top_f, left_e, right_e, bottom, bottom_f,
                    local};
    return launch<false, true, true, false, true>(
        a, b, m, n, sc, blk, T, sync, bnd, bnd_f, best, right, nullptr,
        stream);
  }
  const Block blk{top, left, nullptr, nullptr, nullptr, bottom, nullptr,
                  local};
  return launch<false, false, true, false, true>(
      a, b, m, n, sc, blk, T, sync, bnd, nullptr, best, right, nullptr,
      stream);
}
