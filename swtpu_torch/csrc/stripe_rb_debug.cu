// K9 redesigned for Hopper: the sanitizer's capture on the register-blocked
// single-pair stripe that `score()` runs (design in stripe_rb.cuh, its
// kDebugH forms). K1-K3's local score-only fill, the very `tile` and
// `tile_gotoh` cells, plus, after every step, each thread's R x C tile of H
// stored into h[s, t, k, r, c], the cell (s T R + k R + r + 1, (t - k) C +
// c + 1) (0 where that cell lies outside the matrix), and, at every read of
// the boundary row, the progress of the stripe above that the reading lane
// of warp 0 had waited for, at seen[s, j].
//
// Replaces the Pallas kernel of the JAX package in its `debug_h` mode
// (swtpu/kernels/pallas_fill.py `_kernel` :192, the capture
// `dbg_ref[0, tl, c, r] = hn` :597-598, reached through
// `_stripe_call(debug_h=True)` -> pallas_call :1008; called by
// swtpu/instrument/sanitize.py `sanitize_stripe`), which the stripe
// template's K9 (sanitize_fill.cu, `sw_sanitize_stripe_*`) served before,
// capturing the template's K1-K3 that no route runs since the
// register-blocked K1-K3. These entries launch exactly `_launch_rb`'s
// geometry: the stripes of T * R rows, the ticket order, the query ring, the
// boundary row by chunks of 32 columns, the partial tile at column m and,
// for a table, the per-thread profile. (R, C) is what score() runs, (8, 4)
// in every form (stripe_fill.RB_DEFAULTS), or the small tile (4, 4), which
// gives many hand-offs at small shapes.
//
// What bounds it on the card: K1-K3's step chain and the capture's stores,
// (stripes * (tiles + T - 1) * T * R * C) int32. A thread's R x C slots of
// a step are 128 bytes at (8, 4), so stored from registers a warp's store
// of a word touched 32 lines; each thread stages its slots in shared memory
// instead (R * C / 4 + 1 int4 a thread, after the profile), and the warp
// stores its 32 threads' slots, contiguous in h, with R * C / 4 fully
// coalesced int4 stores a lane (4096^2: 1.99-2.32 ms against 3.00-3.13
// stored from registers, PERF.md section 6). The capture's registers (R *
// C ints) sit on top of the tile's, so the entries take ext_threads(R)
// threads at most, as K4 and K5 do.

#define SW_RB_LAUNCH_BOUNDS ext_threads(R), 1
#include "stripe_rb.cuh"

#define SW_RB_DEBUG(R_, C_, AFF, SUB, ...)                                   \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB, false, false, false, true>(__VA_ARGS__); \
  }

// As sw_stripe_rb_linear (stripe_rb.cu) with (R, C) one of
// stripe_fill.RB_DEBUG_TILES and T up to 512 at R = 4, 256 at R = 8, plus
// h: (stripes, ceil(m / C) + T - 1, T, R, C) int32, filled by the caller
// with a sentinel that no step the kernel runs keeps; seen: (stripes,
// m + 1) int32, filled with -1; skew: 0, or the test hook's shift.
extern "C" int sw_sanitize_rb_linear(const int8_t* a, const int8_t* b,
                                     int m, int n, int match, int mismatch,
                                     int gap, int T, int R, int C, int* sync,
                                     int* bnd, int* best, int* right, int* h,
                                     int* seen, int skew,
                                     cudaStream_t stream) {
  const Aux aux{h, seen, skew, 0, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_DEBUG(R_, C_, AFF, SUB, a, b, m, n, match, mismatch, gap, 0, 0,      \
              nullptr, 0, T, sync, bnd, nullptr, best, right, stream, Ext{}, \
              0, aux)
  SW_RB_DEBUG_TILES(false, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// as sw_sanitize_rb_linear, with gap_open/gap_extend for gap; bnd_f: as
// bnd
extern "C" int sw_sanitize_rb_affine(const int8_t* a, const int8_t* b,
                                     int m, int n, int match, int mismatch,
                                     int gap_open, int gap_extend, int T,
                                     int R, int C, int* sync, int* bnd,
                                     int* bnd_f, int* best, int* right,
                                     int* h, int* seen, int skew,
                                     cudaStream_t stream) {
  const Aux aux{h, seen, skew, 0, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_DEBUG(R_, C_, AFF, SUB, a, b, m, n, match, mismatch, 0, gap_open,    \
              gap_extend, nullptr, 0, T, sync, bnd, bnd_f, best, right,      \
              stream, Ext{}, 0, aux)
  SW_RB_DEBUG_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device, codes in [-3, A); affine != 0
// takes gap_open/gap_extend and bnd_f, affine == 0 gap (bnd_f unread)
extern "C" int sw_sanitize_rb_sub(const int8_t* a, const int8_t* b, int m,
                                  int n, const int* sub, int A, int affine,
                                  int gap, int gap_open, int gap_extend,
                                  int T, int R, int C, int* sync, int* bnd,
                                  int* bnd_f, int* best, int* right, int* h,
                                  int* seen, int skew, cudaStream_t stream) {
  const Aux aux{h, seen, skew, 0, 0};
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  SW_RB_DEBUG(R_, C_, AFF, SUB, a, b, m, n, 0, 0, gap, gap_open, gap_extend, \
              sub, A, T, sync, bnd, bnd_f, best, right, stream, Ext{}, 0,    \
              aux)
  if (affine) {
    SW_RB_DEBUG_TILES(true, true)
  } else {
    SW_RB_DEBUG_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
#undef SW_RB_DEBUG
