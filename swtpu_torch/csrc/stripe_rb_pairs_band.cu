// K8[band] redesigned for Hopper: the batch form of the register-blocked
// stripe with the band (design in stripe_rb.cuh, its kPairs and kBand
// forms together). B independent pairs of one shape, a (B, m) against b
// (B, n) int8 codes, in one launch of B x S blocks, each pair cut into S
// stripes of T * R rows, keeping only the cells with |i - j| <= band (H =
// 0, E = F = NEG outside); each pair's per-stripe first max (score, row,
// column), reduced per pair by the caller (pairs_fill._reduce_stripes). In
// the three scorings of K1-K3; no right column.
//
// Replaces the stripe template's banded K8 (pairs_fill.cu,
// `sw_pairs_score_*` with a band, counted as `<entry>[band]`), which stays,
// on no route, as the earlier design. The JAX package has no banded batch
// kernel: it scores banded batches with its vmapped scan
// (swtpu/dist/batch.py), and its pair grid (swtpu/kernels/pallas_fill.py
// `pairs_score_fn` :1876 -> pallas_call :1962) runs `_kernel`'s band mode
// (:358-363) on one pair's stripes.
//
// What bounds it on the card: each pair is K4b's chain, about n / R + n /
// C dependent steps of one lone warp's tile plus each stripe's hand-off,
// where the template's K8[band] ran every anti-diagonal of the pair, n + m
// steps, whatever the band. Stripe s of a pair visits only its window, the
// columns its rows' band reaches (band_window); the row above is read only
// up to where the stripe above stored it, and each stripe releases m at its
// end, so no block waits on a column nobody writes. The batch adds blocks,
// not steps: a ticket names (pair, stripe) pair-major, so a block waits
// only on its own pair's stripe above, which took an earlier ticket.

#define SW_RB_LAUNCH_BOUNDS ext_threads(R), 1
#include "stripe_rb.cuh"

#define SW_RB_PAIRS_BAND(R_, C_, AFF, SUB, ...)                              \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, false, false, true, false, true>(        \
        __VA_ARGS__);                                                        \
  }

// As sw_pairs_rb_linear (stripe_rb_pairs.cu) with (R, C) one of the form's
// stripe_fill.RB_FORM_TILES and T up to 512 at R = 4, 256 at R = 8 or 16,
// plus band: the half-width, -1 .. m + n (-1 keeps no cell).
extern "C" int sw_pairs_rb_band_linear(const int8_t* a, const int8_t* b,
                                       int B, int m, int n, int match,
                                       int mismatch, int gap, int T, int R,
                                       int C, int* sync, int* bnd, int* best,
                                       int band, cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_)                                                   \
  SW_RB_PAIRS_BAND(R_, C_, false, false, a, b, m, n, match, mismatch, gap,   \
                   0, 0, nullptr, 0, T, sync, bnd, nullptr, best, nullptr,   \
                   stream, Ext{}, band, aux)
  SW_RB_TILE(8, 4)
  SW_RB_TILE(4, 4)
  SW_RB_TILE(16, 4)
  SW_RB_TILE(8, 1)
  SW_RB_TILE(8, 2)
  SW_RB_TILE(8, 8)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// as sw_pairs_rb_band_linear, with gap_open/gap_extend for gap; bnd_f: as
// bnd
extern "C" int sw_pairs_rb_band_affine(const int8_t* a, const int8_t* b,
                                       int B, int m, int n, int match,
                                       int mismatch, int gap_open,
                                       int gap_extend, int T, int R, int C,
                                       int* sync, int* bnd, int* bnd_f,
                                       int* best, int band,
                                       cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_PAIRS_BAND(R_, C_, AFF, SUB, a, b, m, n, match, mismatch, 0,         \
                   gap_open, gap_extend, nullptr, 0, T, sync, bnd, bnd_f,    \
                   best, nullptr, stream, Ext{}, band, aux)
  SW_RB_GOTOH_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device, codes in [-3, A); affine != 0
// takes gap_open/gap_extend and bnd_f, affine == 0 gap (bnd_f unread)
extern "C" int sw_pairs_rb_band_sub(const int8_t* a, const int8_t* b, int B,
                                    int m, int n, const int* sub, int A,
                                    int affine, int gap, int gap_open,
                                    int gap_extend, int T, int R, int C,
                                    int* sync, int* bnd, int* bnd_f,
                                    int* best, int band,
                                    cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_PAIRS_BAND(R_, C_, AFF, SUB, a, b, m, n, 0, 0, gap, gap_open,        \
                   gap_extend, sub, A, T, sync, bnd, bnd_f, best, nullptr,   \
                   stream, Ext{}, band, aux)
  if (affine) {
    SW_RB_GOTOH_TILES(true, true)
  } else {
    SW_RB_GOTOH_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
#undef SW_RB_PAIRS_BAND
