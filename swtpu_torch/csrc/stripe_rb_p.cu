// K4 redesigned for Hopper: the register-blocked single-pair stripe with
// the predecessor capture (design in stripe_rb.cuh, its kP forms). The
// local fill of K1-K3 (the stripes' first max, the right column) plus one
// int8 code a cell into a row-major (n+1) x (m+1) P, row 0 and column 0
// NONE, in the three scorings.
//
// Replaces, with no band, the `return_p` capture of the JAX package's
// Pallas kernel (swtpu/kernels/pallas_fill.py `stripe_fill` :1190 /
// `stripe_fill_raw` :1072 -> `_stripe_call` -> pallas_call :1008, the
// capture in `_kernel`'s P mode; affine :456-463, :529-536, :576-587; the
// table :364-379, :437-524), which the stripe template's K4
// (stripe_fill.cu, `sw_stripe_fill_p_{linear,affine,sub}`) served before;
// a band still runs those (K4b). It serves the full-P `align()`, the lean
// route's window refill, `walk_from_end` and each `align_hits` /
// `batch_align` record.
//
// What bounds it on the card: the step chain of K1-K3; the code is off it,
// and the stores, (n+1)(m+1) bytes of P, are the bytes bound.

#define SW_RB_LAUNCH_BOUNDS ext_threads(R), 1
#include "stripe_rb.cuh"

#define SW_RB_P(R_, C_, AFF, SUB, ...)                                       \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, true>(__VA_ARGS__);                      \
  }

// As sw_stripe_rb_linear (stripe_rb.cu) with (R, C) one of
// stripe_fill.RB_EXT_TILES and T up to 512 at R = 4, 256 at R = 8, plus P:
// (n + 1) rows of `pitch` >= m + 1 bytes, P(i, j) at P[i * pitch + j],
// every cell of rows 0..n and columns 0..m written and no other byte. A
// row's C codes of a tile are stored at once, which needs P + 1 and pitch
// 4-byte aligned.
extern "C" int sw_stripe_rb_fill_p_linear(const int8_t* a, const int8_t* b,
                                          int m, int n, int match,
                                          int mismatch, int gap, int T, int R,
                                          int C, int* sync, int* bnd,
                                          int* best, int* right, int8_t* P,
                                          int pitch, cudaStream_t stream) {
  const Ext ext{P, pitch};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_P(R_, C_, AFF, SUB, a, b, m, n, match, mismatch, gap, 0, 0, nullptr, \
          0, T, sync, bnd, nullptr, best, right, stream, ext)
  SW_RB_GOTOH_TILES(false, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// as sw_stripe_rb_fill_p_linear, with gap_open/gap_extend for gap; bnd_f:
// as bnd
extern "C" int sw_stripe_rb_fill_p_affine(const int8_t* a, const int8_t* b,
                                          int m, int n, int match,
                                          int mismatch, int gap_open,
                                          int gap_extend, int T, int R, int C,
                                          int* sync, int* bnd, int* bnd_f,
                                          int* best, int* right, int8_t* P,
                                          int pitch, cudaStream_t stream) {
  const Ext ext{P, pitch};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_P(R_, C_, AFF, SUB, a, b, m, n, match, mismatch, 0, gap_open,        \
          gap_extend, nullptr, 0, T, sync, bnd, bnd_f, best, right, stream,  \
          ext)
  SW_RB_GOTOH_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device, codes in [-3, A); affine != 0
// takes gap_open/gap_extend and bnd_f, affine == 0 gap (bnd_f unread)
extern "C" int sw_stripe_rb_fill_p_sub(const int8_t* a, const int8_t* b,
                                       int m, int n, const int* sub, int A,
                                       int affine, int gap, int gap_open,
                                       int gap_extend, int T, int R, int C,
                                       int* sync, int* bnd, int* bnd_f,
                                       int* best, int* right, int8_t* P,
                                       int pitch, cudaStream_t stream) {
  const Ext ext{P, pitch};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_P(R_, C_, AFF, SUB, a, b, m, n, 0, 0, gap, gap_open, gap_extend,     \
          sub, A, T, sync, bnd, bnd_f, best, right, stream, ext)
  if (affine) {
    SW_RB_GOTOH_TILES(true, true)
  } else {
    SW_RB_GOTOH_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
#undef SW_RB_P
