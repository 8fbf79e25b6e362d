// The packed K9 redesigned for Hopper: the sanitizer's capture on the
// packed form of the register-blocked stripe that K7 runs
// (stripe_rb_packed.cu; design in stripe_rb.cuh, its kPacked and kDebugH
// forms). K7's fill, the very `tile` and `tile_gotoh` cells at the same
// (T, R, C) and packing (pairs_fill.packed_rb_geometry), plus, after every
// step, each thread's R x C tile of H stored into h[s, t, k, r, c]: the
// cell of the thread's pair, row kk R + r + 1 of the stripe's rows of it
// (kk the thread's place among the pair's threads of the stripe), column
// (t - kk) C + c + 1, 0 in a pad row (past n), in an idle thread (past the
// stripe's last pair) and in a column outside 1 .. m; and, at every read of
// the boundary row (a stripe that continues a pair), the progress of the
// pair's stripe above that the reading lane of warp 0 had waited for, at
// seen[s, j] (-1, the caller's fill, in a stripe that starts a pair).
//
// Replaces the Pallas kernel of the JAX package in its `debug_h` mode on
// the packed pairs' packing (swtpu/kernels/pallas_fill.py `_kernel` :192,
// the capture :597-598, reached through `_stripe_call(debug_h=True)` ->
// pallas_call :1008 on `pairs_packed_score_fn`'s `prepare`; called by
// swtpu/instrument/sanitize.py `sanitize_pairs_packed` :168-215), which the
// stripe template's packed K9 (sanitize_fill.cu, `sw_sanitize_packed_*`)
// served before, capturing the template's K7 that no route runs since the
// packed form. (R, C) is one of stripe_fill.RB_DEBUG_TILES: K7's default
// (8, 4), or the small tile (4, 4).
//
// What bounds it on the card: K7's step chain and the capture's stores,
// (stripes * (ceil(m / C) + T - 1) * T * R * C) int32 at most, staged in
// shared memory and stored coalesced as the single-pair capture's
// (stripe_rb_debug.cu). Its R x C capture registers sit on top of the
// tile's, so the entries take ext_threads(R) threads at most, as that
// capture does.

#define SW_RB_LAUNCH_BOUNDS ext_threads(R), 1
#include "stripe_rb.cuh"

#define SW_RB_PACKED_DEBUG(R_, C_, AFF, SUB, ...)                            \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, false, false, false, true, false, false, \
                  true>(__VA_ARGS__);                                        \
  }

// As sw_packed_rb_linear (stripe_rb_packed.cu) with (R, C) one of
// stripe_fill.RB_DEBUG_TILES and T up to 512 at R = 4, 256 at R = 8, plus
// h: (stripes, ceil(m / C) + T - 1, T, R, C) int32, filled by the caller
// with a sentinel that no step the kernel runs keeps; seen: (stripes,
// m + 1) int32, filled with -1; skew: 0, or the test hook's shift.
extern "C" int sw_sanitize_packed_rb_linear(
    const int8_t* a, const int8_t* b, int B, int m, int n, int match,
    int mismatch, int gap, int T, int R, int C, int* sync, int* bnd,
    int* row_best, int* h, int* seen, int skew, cudaStream_t stream) {
  const Aux aux{h, seen, skew, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_PACKED_DEBUG(R_, C_, AFF, SUB, a, b, m, n, match, mismatch, gap, 0,  \
                     0, nullptr, 0, T, sync, bnd, nullptr, row_best,         \
                     nullptr, stream, Ext{}, 0, aux)
  SW_RB_DEBUG_TILES(false, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// as sw_sanitize_packed_rb_linear, with gap_open/gap_extend for gap;
// bnd_f: as bnd
extern "C" int sw_sanitize_packed_rb_affine(
    const int8_t* a, const int8_t* b, int B, int m, int n, int match,
    int mismatch, int gap_open, int gap_extend, int T, int R, int C,
    int* sync, int* bnd, int* bnd_f, int* row_best, int* h, int* seen,
    int skew, cudaStream_t stream) {
  const Aux aux{h, seen, skew, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_PACKED_DEBUG(R_, C_, AFF, SUB, a, b, m, n, match, mismatch, 0,       \
                     gap_open, gap_extend, nullptr, 0, T, sync, bnd, bnd_f,  \
                     row_best, nullptr, stream, Ext{}, 0, aux)
  SW_RB_DEBUG_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device, codes in [-3, A); affine != 0
// takes gap_open/gap_extend and bnd_f, affine == 0 gap (bnd_f unread)
extern "C" int sw_sanitize_packed_rb_sub(
    const int8_t* a, const int8_t* b, int B, int m, int n, const int* sub,
    int A, int affine, int gap, int gap_open, int gap_extend, int T, int R,
    int C, int* sync, int* bnd, int* bnd_f, int* row_best, int* h, int* seen,
    int skew, cudaStream_t stream) {
  const Aux aux{h, seen, skew, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_PACKED_DEBUG(R_, C_, AFF, SUB, a, b, m, n, 0, 0, gap, gap_open,      \
                     gap_extend, sub, A, T, sync, bnd, bnd_f, row_best,      \
                     nullptr, stream, Ext{}, 0, aux)
  if (affine) {
    SW_RB_DEBUG_TILES(true, true)
  } else {
    SW_RB_DEBUG_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
#undef SW_RB_PACKED_DEBUG
