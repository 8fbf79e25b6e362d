// K7 redesigned for Hopper: the packed form of the register-blocked stripe
// (design in stripe_rb.cuh, its kPacked forms). B pairs of one shape, a
// (B, m) against b (B, n) int8 codes, in one launch: each pair's rows at a
// pitch of rlen = ceil(n / R) * R rows (whole threads), every stripe
// starting at a pair's row 1. Where rlen <= T * R a stripe holds T / (rlen
// / R) whole pairs and reads no boundary row; above, each pair takes
// ceil(n / (T * R)) stripes of its own, chained under pair-major tickets.
// Each thread stores its rows' (best, first j) into row_best (B, n, 2),
// reduced per pair by the caller (pairs_fill._reduce_rows): each pair's
// max and its first row-major end cell. In the three scorings of K1-K3.
//
// Replaces the JAX package's packed pairs (swtpu/kernels/pallas_fill.py
// `pairs_packed_score_fn` :1730 -> `_stripe_call(winject=)` :1835 ->
// pallas_call :1008: the B * rlen rows in one stripe chain, a reset row at
// each pair's start, each pair's query injected at its first row), which
// the stripe template's K7 (pairs_fill.cu, `sw_packed_score_*`, one row a
// thread) served before, and still serves on no route, as the earlier
// design. The geometry of a launch is pairs_fill.packed_rb_geometry's.
//
// What bounds it on the card: each stripe is K1-K3's chain of ceil(m / C)
// + rlen / R - 1 dependent steps of its warps' tiles (the skew restarts at
// each pair, so a stripe of several pairs runs no more steps than one),
// and a pair that spans stripes adds K8's hand-off lag a stripe. No chain
// crosses a pair: the template's K7 ran one chain through all B * n rows
// wherever no stripe height divided n (64 x 1000^2: 18-19 ms). Each thread
// loads its next tile's C codes of its own pair's query from L2 a step
// ahead, off the step's chain.

// kMaxThreads (T up to 512, for many pairs a stripe) and one block an SM,
// as K6's stripe_rb_window.cu: without the second bound ptxas may trade
// registers for an occupancy these launches never use
#define SW_RB_LAUNCH_BOUNDS kMaxThreads, 1
#include "stripe_rb.cuh"

#define SW_RB_PACKED(R_, C_, AFF, SUB, ...)                                  \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, false, false, false, false, false,       \
                  false, true>(__VA_ARGS__);                                 \
  }

// a: (B, m), b: (B, n) int8; T threads a block (a multiple of 32 up to
// 512; where one pair's rows fit a stripe, packed_rb_geometry's rounding
// to the warps of its pairs), (R, C) one of the form's tiles
// (stripe_fill.RB_FORM_TILES). sync: 1 + the stripes int32, zeroed; bnd:
// B * (S - 1) rows of m + 1 int32 (at least one row), S = ceil(n / (T *
// R)); row_best: (B, n, 2) int32.
extern "C" int sw_packed_rb_linear(const int8_t* a, const int8_t* b, int B,
                                   int m, int n, int match, int mismatch,
                                   int gap, int T, int R, int C, int* sync,
                                   int* bnd, int* row_best,
                                   cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_)                                                   \
  SW_RB_PACKED(R_, C_, false, false, a, b, m, n, match, mismatch, gap, 0, 0, \
               nullptr, 0, T, sync, bnd, nullptr, row_best, nullptr, stream, \
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

// as sw_packed_rb_linear, with gap_open/gap_extend for gap; bnd_f: as bnd
extern "C" int sw_packed_rb_affine(const int8_t* a, const int8_t* b, int B,
                                   int m, int n, int match, int mismatch,
                                   int gap_open, int gap_extend, int T,
                                   int R, int C, int* sync, int* bnd,
                                   int* bnd_f, int* row_best,
                                   cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_PACKED(R_, C_, AFF, SUB, a, b, m, n, match, mismatch, 0, gap_open,   \
               gap_extend, nullptr, 0, T, sync, bnd, bnd_f, row_best,        \
               nullptr, stream, Ext{}, 0, aux)
  SW_RB_GOTOH_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device, codes in [-3, A); affine != 0
// takes gap_open/gap_extend and bnd_f, affine == 0 gap (bnd_f unread)
extern "C" int sw_packed_rb_sub(const int8_t* a, const int8_t* b, int B,
                                int m, int n, const int* sub, int A,
                                int affine, int gap, int gap_open,
                                int gap_extend, int T, int R, int C,
                                int* sync, int* bnd, int* bnd_f,
                                int* row_best, cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_PACKED(R_, C_, AFF, SUB, a, b, m, n, 0, 0, gap, gap_open,            \
               gap_extend, sub, A, T, sync, bnd, bnd_f, row_best, nullptr,   \
               stream, Ext{}, 0, aux)
  if (affine) {
    SW_RB_GOTOH_TILES(true, true)
  } else {
    SW_RB_GOTOH_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
#undef SW_RB_PACKED
