// K8 redesigned for Hopper: the batch form of the register-blocked stripe
// (design in stripe_rb.cuh, its kPairs forms). B independent pairs of one
// shape, a (B, m) against b (B, n) int8 codes, in one launch of B x S
// blocks, each pair cut into S stripes of T * R rows; each pair's
// per-stripe first max (score, row, column), reduced per pair by the
// caller (pairs_fill._reduce_stripes). In the three scorings of K1-K3,
// the table's per-thread profile and sentinel codes included; no right
// column.
//
// Replaces the pair grid of the JAX package (swtpu/kernels/pallas_fill.py
// `pairs_score_fn` :1876 -> pallas_call :1962, `_kernel(pairs=True)`),
// which the stripe template's K8 (pairs_fill.cu, `sw_pairs_score_*`, one
// row a thread) served before; a band still runs that template's kBand
// instantiation (K8[band]).
//
// What bounds it on the card: each pair is K1-K3's chain of about m / C +
// n / R + S x (hand-off lag) dependent steps of one lone warp's tile (the
// template's K8 ran about n + m); the batch adds blocks, not steps, as long
// as the B x S blocks are resident at once. A ticket names (pair, stripe)
// pair-major, so a block waits only on its own pair's stripe above, which
// took an earlier ticket and is resident.

#include "stripe_rb.cuh"

#define SW_RB_PAIRS(R_, C_, AFF, SUB, ...)                                   \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, false, false, false, false, true>(       \
        __VA_ARGS__);                                                        \
  }

// a: (B, m), b: (B, n) int8; T threads a block (a multiple of 32 up to
// 512), (R, C) one of the form's tiles (stripe_fill.RB_FORM_TILES). sync:
// 1 + B * S int32, zeroed, S = ceil(n / (T * R)); bnd: B * (S - 1) rows of
// m + 1 int32 (at least one row); best: (B, S, 4) int32.
extern "C" int sw_pairs_rb_linear(const int8_t* a, const int8_t* b, int B,
                                  int m, int n, int match, int mismatch,
                                  int gap, int T, int R, int C, int* sync,
                                  int* bnd, int* best, cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_)                                                   \
  SW_RB_PAIRS(R_, C_, false, false, a, b, m, n, match, mismatch, gap, 0, 0,  \
              nullptr, 0, T, sync, bnd, nullptr, best, nullptr, stream,      \
              Ext{}, 0, aux)
  SW_RB_TILE(8, 4)
  SW_RB_TILE(4, 4)
  SW_RB_TILE(16, 4)
  SW_RB_TILE(8, 1)
  SW_RB_TILE(8, 2)
  SW_RB_TILE(8, 8)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// as sw_pairs_rb_linear, with gap_open/gap_extend for gap; bnd_f: as bnd
extern "C" int sw_pairs_rb_affine(const int8_t* a, const int8_t* b, int B,
                                  int m, int n, int match, int mismatch,
                                  int gap_open, int gap_extend, int T, int R,
                                  int C, int* sync, int* bnd, int* bnd_f,
                                  int* best, cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_PAIRS(R_, C_, AFF, SUB, a, b, m, n, match, mismatch, 0, gap_open,    \
              gap_extend, nullptr, 0, T, sync, bnd, bnd_f, best, nullptr,    \
              stream, Ext{}, 0, aux)
  SW_RB_GOTOH_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device, codes in [-3, A); affine != 0
// takes gap_open/gap_extend and bnd_f, affine == 0 gap (bnd_f unread)
extern "C" int sw_pairs_rb_sub(const int8_t* a, const int8_t* b, int B,
                               int m, int n, const int* sub, int A,
                               int affine, int gap, int gap_open,
                               int gap_extend, int T, int R, int C,
                               int* sync, int* bnd, int* bnd_f, int* best,
                               cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_PAIRS(R_, C_, AFF, SUB, a, b, m, n, 0, 0, gap, gap_open, gap_extend, \
              sub, A, T, sync, bnd, bnd_f, best, nullptr, stream, Ext{}, 0,  \
              aux)
  if (affine) {
    SW_RB_GOTOH_TILES(true, true)
  } else {
    SW_RB_GOTOH_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
#undef SW_RB_PAIRS
