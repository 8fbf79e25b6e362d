// K4b redesigned for Hopper: the band form of the register-blocked
// single-pair stripe (design in stripe_rb.cuh, its kBand forms), score-only
// (K1-K3's scorings) and with the predecessor capture (K4's), keeping only
// the cells with |i - j| <= band: H = 0, E = F = NEG and P = NONE outside.
//
// Replaces the band mode of the JAX package's Pallas kernel
// (swtpu/kernels/pallas_fill.py `_kernel` :358-363, :571-574, :594-596,
// reached through `stripe_fill_raw(band=)` :1084, :1127 -> `_stripe_call`
// -> pallas_call :1008), which the stripe template's K1-K4 in their band
// mode (stripe_fill.cu, `sw_stripe_score_*` and `sw_stripe_fill_p_*` with a
// band) served before; those stay, on no route, as the earlier design. It
// serves `score()` and `align()` with `EngineConfig(band=)`.
//
// What bounds it on the card: the step chain of the register-blocked
// stripe, over the band alone. The template visits every column of every
// stripe, n + m dependent steps whatever the band; here stripe s visits
// only its window, the columns max(1, r0 - band) .. min(m, r1 + band) of
// its rows r0 .. r1 (rounded to a chunk), so the launch runs about n / R +
// n / C steps plus each stripe's hand-off, O(n) where the template runs
// O(n + m), and does O(n (T R + 2 band)) cells. The cells of a window
// outside the band are masked in the cell (stripe_rb.cuh `tile_ext`).
// A stripe reads the row above only where the stripe above stored it
// (columns past its window are H = 0, F = NEG: outside its last row's
// band) and releases m at its end, so no stripe waits on a column nobody
// writes. With P, the caller clears P once and the kernel stores only its
// windows' tiles, a row's codes of a tile as words as K4 does; the cells
// it never visits stay NONE. The bytes bound is that clear of P.

#define SW_RB_LAUNCH_BOUNDS ext_threads(R), 1
#include "stripe_rb.cuh"

#define SW_RB_BAND(R_, C_, AFF, SUB, P_, ...)                                \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, P_, false, true>(__VA_ARGS__);           \
  }

// As sw_stripe_rb_linear (stripe_rb.cu) with (R, C) one of
// stripe_fill.RB_BAND_TILES and T up to 512 at R = 4, 256 at R = 8, plus
// band: the half-width, -1 .. m + n (-1 keeps no cell). right[i] is written
// only for rows whose band reaches column m: the caller zeroes right.
extern "C" int sw_stripe_rb_band_linear(const int8_t* a, const int8_t* b,
                                        int m, int n, int match,
                                        int mismatch, int gap, int T, int R,
                                        int C, int* sync, int* bnd, int* best,
                                        int* right, int band,
                                        cudaStream_t stream) {
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_BAND(R_, C_, AFF, SUB, false, a, b, m, n, match, mismatch, gap, 0,   \
             0, nullptr, 0, T, sync, bnd, nullptr, best, right, stream,      \
             Ext{}, band)
  SW_RB_GOTOH_TILES(false, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// as sw_stripe_rb_band_linear, with gap_open/gap_extend for gap; bnd_f:
// as bnd
extern "C" int sw_stripe_rb_band_affine(const int8_t* a, const int8_t* b,
                                        int m, int n, int match,
                                        int mismatch, int gap_open,
                                        int gap_extend, int T, int R, int C,
                                        int* sync, int* bnd, int* bnd_f,
                                        int* best, int* right, int band,
                                        cudaStream_t stream) {
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_BAND(R_, C_, AFF, SUB, false, a, b, m, n, match, mismatch, 0,        \
             gap_open, gap_extend, nullptr, 0, T, sync, bnd, bnd_f, best,    \
             right, stream, Ext{}, band)
  SW_RB_GOTOH_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device, codes in [-3, A); affine != 0
// takes gap_open/gap_extend and bnd_f, affine == 0 gap (bnd_f unread)
extern "C" int sw_stripe_rb_band_sub(const int8_t* a, const int8_t* b,
                                     int m, int n, const int* sub, int A,
                                     int affine, int gap, int gap_open,
                                     int gap_extend, int T, int R, int C,
                                     int* sync, int* bnd, int* bnd_f,
                                     int* best, int* right, int band,
                                     cudaStream_t stream) {
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_BAND(R_, C_, AFF, SUB, false, a, b, m, n, 0, 0, gap, gap_open,       \
             gap_extend, sub, A, T, sync, bnd, bnd_f, best, right, stream,   \
             Ext{}, band)
  if (affine) {
    SW_RB_GOTOH_TILES(true, true)
  } else {
    SW_RB_GOTOH_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// As sw_stripe_rb_band_linear plus P, as sw_stripe_rb_fill_p_linear
// (stripe_rb_p.cu) takes it: (n + 1) rows of `pitch` bytes, P + 1 and
// pitch 4-byte aligned; cleared to NONE by the caller, the kernel stores
// only the cells of its windows (every cell in the band among them) and
// no other byte.
extern "C" int sw_stripe_rb_fill_p_band_linear(
    const int8_t* a, const int8_t* b, int m, int n, int match, int mismatch,
    int gap, int T, int R, int C, int* sync, int* bnd, int* best, int* right,
    int8_t* P, int pitch, int band, cudaStream_t stream) {
  const Ext ext{P, pitch};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_BAND(R_, C_, AFF, SUB, true, a, b, m, n, match, mismatch, gap, 0, 0, \
             nullptr, 0, T, sync, bnd, nullptr, best, right, stream, ext,    \
             band)
  SW_RB_GOTOH_TILES(false, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

extern "C" int sw_stripe_rb_fill_p_band_affine(
    const int8_t* a, const int8_t* b, int m, int n, int match, int mismatch,
    int gap_open, int gap_extend, int T, int R, int C, int* sync, int* bnd,
    int* bnd_f, int* best, int* right, int8_t* P, int pitch, int band,
    cudaStream_t stream) {
  const Ext ext{P, pitch};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_BAND(R_, C_, AFF, SUB, true, a, b, m, n, match, mismatch, 0,         \
             gap_open, gap_extend, nullptr, 0, T, sync, bnd, bnd_f, best,    \
             right, stream, ext, band)
  SW_RB_GOTOH_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

extern "C" int sw_stripe_rb_fill_p_band_sub(
    const int8_t* a, const int8_t* b, int m, int n, const int* sub, int A,
    int affine, int gap, int gap_open, int gap_extend, int T, int R, int C,
    int* sync, int* bnd, int* bnd_f, int* best, int* right, int8_t* P,
    int pitch, int band, cudaStream_t stream) {
  const Ext ext{P, pitch};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_BAND(R_, C_, AFF, SUB, true, a, b, m, n, 0, 0, gap, gap_open,        \
             gap_extend, sub, A, T, sync, bnd, bnd_f, best, right, stream,   \
             ext, band)
  if (affine) {
    SW_RB_GOTOH_TILES(true, true)
  } else {
    SW_RB_GOTOH_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
#undef SW_RB_BAND
