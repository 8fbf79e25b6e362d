// The device walk of a predecessor matrix P.
//
// Replaces the jitted `lax.while_loop` walk of the JAX package's
// `_stripe_window_walk` (swtpu/engine/traceback.py :561-597), which keeps
// the window's P on the accelerator and brings back only the moves. It is
// XLA there, not Pallas.
//
// From (wn, wm) it follows the Gotoh state machine over the row-major int8
// P that the P-capture entries write: the move is the state when a gap run
// is open, else the code's low two bits; an UP (LEFT) move stays in its run
// while the cell's F_EXT (E_EXT) bit says the gap extends; a NONE move, or
// reaching row or column 0, ends the walk. Linear P has no state bits, so
// the same walk serves it. It writes the moves end-first and their count;
// only those O(path) bytes leave the card.
//
// What bounds it on the card: one dependent global load per step, so its
// time is the path length times the load latency, on one thread. A loop of
// tensor ops would instead sync the host once per step. Nothing here is
// parallel: the next cell depends on the code just read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNone = 0, kUp = 1, kLeft = 2;
constexpr int kEExt = 4, kFExt = 8;

__global__ void walk_p_kernel(const int8_t* __restrict__ P, int m1, int wn,
                              int wm, int8_t* __restrict__ moves,
                              int* __restrict__ count) {
  int i = wn, j = wm, state = 0, pos = 0;
  while (i > 0 && j > 0) {
    const int code = P[(size_t)i * m1 + j];
    const int move = state != 0 ? state : (code & 3);
    if (move == kNone) break;
    moves[pos++] = (int8_t)move;
    if (move == kUp) {
      state = (code & kFExt) ? kUp : 0;
      --i;
    } else if (move == kLeft) {
      state = (code & kEExt) ? kLeft : 0;
      --j;
    } else {
      state = 0;
      --i;
      --j;
    }
  }
  *count = pos;
}

}  // namespace

// P: rows x m1 int8 row-major with wn < rows and wm < m1 (the caller
// checks); moves: at least wn + wm int8; count: one int32.
extern "C" int sw_walk_p(const int8_t* P, int m1, int wn, int wm,
                         int8_t* moves, int* count, cudaStream_t stream) {
  if (wn < 0 || wm < 0 || m1 <= wm) return (int)cudaErrorInvalidValue;
  walk_p_kernel<<<1, 1, 0, stream>>>(P, m1, wn, wm, moves, count);
  return (int)cudaGetLastError();
}
