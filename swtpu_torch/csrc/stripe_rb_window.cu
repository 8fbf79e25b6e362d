// K6 for reads longer than 512 rows, redesigned for Hopper: the batch form
// of the register-blocked stripe with one shared query (design in
// stripe_rb.cuh, its kPairs and kShared forms). B reads, (B, rlen) int8
// codes with the -3 sentinel after each read's end, are the rows of B
// pairs; one window of W reference codes, which every pair shares, is
// their columns, read in place (never copied B times). One launch of B x S
// blocks, each read cut into S stripes of T * R rows; each read's
// per-stripe first max (score, row, window column), reduced per read by
// the caller (pairs_fill._reduce_stripes): the max, then the first
// row-major end cell. In the three scorings of K1-K3.
//
// Replaces, for reads longer than 512 rows, the JAX package's window
// scorer (swtpu/kernels/pallas_fill.py `batch_fill_raw` :1328 and
// `batch_score_fn` :1608 -> `_stripe_call` -> pallas_call :1008, the reads
// packed into one stripe chain with a reset row at each read's start),
// which the stripe template's K6 (window_fill.cu, `sw_window_score_*`, the
// same packing, one row a thread) served before and still serves, on no
// route, as the earlier design. Reads of up to 512 rows take the
// warp-per-read K6 (window_warp.cu).
//
// What bounds it on the card: each read is K1-K3's chain of about W / C +
// rlen / R + S x (hand-off lag) dependent steps of one lone warp's tile,
// where the template ran its packed chain of B * rlen rows in stripes of
// the one height that cuts it at every read's first row (32 rows for
// 5000-row reads: a chain of 157 one-warp blocks a read). Here the reads
// are B independent chains of S blocks each, no read padded: a ticket names
// (read, stripe) read-major, so a block waits only on its own read's
// stripe above, which took an earlier ticket. The window's codes reach the
// query ring of each block from L2.

// kMaxThreads and one block an SM: without the second bound ptxas held the
// table form's linear (8, 2) tile to 64 registers and spilled 12 bytes
#define SW_RB_LAUNCH_BOUNDS kMaxThreads, 1
#include "stripe_rb.cuh"

#define SW_RB_WINDOW(R_, C_, AFF, SUB, ...)                                  \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, false, false, false, false, true, true>( \
        __VA_ARGS__);                                                        \
  }

// window: (W,), reads: (B, rlen) int8; T threads a block (a multiple of 32
// up to 512), (R, C) one of the form's tiles (stripe_fill.RB_FORM_TILES).
// sync: 1 + B * S int32, zeroed, S = ceil(rlen / (T * R)); bnd: B * (S -
// 1) rows of W + 1 int32 (at least one row); best: (B, S, 4) int32.
extern "C" int sw_window_rb_linear(const int8_t* window, const int8_t* reads,
                                   int B, int W, int rlen, int match,
                                   int mismatch, int gap, int T, int R,
                                   int C, int* sync, int* bnd, int* best,
                                   cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_)                                                   \
  SW_RB_WINDOW(R_, C_, false, false, window, reads, W, rlen, match,          \
               mismatch, gap, 0, 0, nullptr, 0, T, sync, bnd, nullptr, best, \
               nullptr, stream, Ext{}, 0, aux)
  SW_RB_TILE(8, 4)
  SW_RB_TILE(4, 4)
  SW_RB_TILE(16, 4)
  SW_RB_TILE(8, 1)
  SW_RB_TILE(8, 2)
  SW_RB_TILE(8, 8)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// as sw_window_rb_linear, with gap_open/gap_extend for gap; bnd_f: as bnd
extern "C" int sw_window_rb_affine(const int8_t* window, const int8_t* reads,
                                   int B, int W, int rlen, int match,
                                   int mismatch, int gap_open,
                                   int gap_extend, int T, int R, int C,
                                   int* sync, int* bnd, int* bnd_f,
                                   int* best, cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_WINDOW(R_, C_, AFF, SUB, window, reads, W, rlen, match, mismatch, 0, \
               gap_open, gap_extend, nullptr, 0, T, sync, bnd, bnd_f, best,  \
               nullptr, stream, Ext{}, 0, aux)
  SW_RB_GOTOH_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device, S[window code, read code],
// codes in [-3, A); affine != 0 takes gap_open/gap_extend and bnd_f,
// affine == 0 gap (bnd_f unread)
extern "C" int sw_window_rb_sub(const int8_t* window, const int8_t* reads,
                                int B, int W, int rlen, const int* sub,
                                int A, int affine, int gap, int gap_open,
                                int gap_extend, int T, int R, int C,
                                int* sync, int* bnd, int* bnd_f, int* best,
                                cudaStream_t stream) {
  const Aux aux{nullptr, nullptr, 0, B, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_WINDOW(R_, C_, AFF, SUB, window, reads, W, rlen, 0, 0, gap,          \
               gap_open, gap_extend, sub, A, T, sync, bnd, bnd_f, best,      \
               nullptr, stream, Ext{}, 0, aux)
  if (affine) {
    SW_RB_GOTOH_TILES(true, true)
  } else {
    SW_RB_GOTOH_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
#undef SW_RB_WINDOW
