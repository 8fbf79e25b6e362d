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
// What bounds it on the card: the chain of moves, each reading the code
// of the cell the last one reached. Two designs:
//   * sw_walk_p, the earlier one: one thread, one dependent global load a
//     move, so the path length times a load's latency (~190 ns on an
//     H100, an L2 or HBM round trip);
//   * sw_walk_p_tiled, the route's: the chain stays, but its loads come
//     from shared memory, staged ahead of the walk.
//       - Tiles follow the path: an alignment's path runs near a diagonal,
//         so P is cut along d = j - i, into tiles of kTileRows rows by
//         kTileDiags diagonals (row i of tile (bi, bd) holds the columns i +
//         dlo .. i + dlo + kTileDiags - 1, dlo = bd kTileDiags - wn). A
//         DIAGONAL move keeps d, UP raises it, LEFT lowers it, so a path
//         leaves a tile into the one above, or beside it after a gap: one
//         new tile per kTileRows rows on a diagonal stretch, where square
//         tiles need two to three.
//       - Two warps: lane 0 of the walker warp walks the tile holding the
//         current cell; the loader warp stages, for each tile of the
//         walker's it sees, that tile and the two above it, and the two
//         beside them on the side the walker entered near, with cp.async,
//         16 bytes a lane. It issues a pass's copies as a group before it
//         waits for the groups before it and publishes their tiles, so a
//         pass waits out one memory latency, and the issue overlaps the
//         walk.
//       - Sixteen slots by (tile row % 4, tile diagonal % 4), so the tiles
//         of a pass never share one; a slot is refilled only after the
//         loader has marked it empty and, after a fence, seen that the
//         walker's tile (published, then fenced, before the walker reads a
//         slot's mark) is not the one it holds, so the walker never reads a
//         slot being refilled; and a slot whose copy is still in flight is
//         refilled only after the loader has waited for it.
//       - A move costs one shared load and the state machine, with no
//         branch between two moves: the offset in the tile, the bounds
//         and the end are updated with selects.
//   * P's rows need not be 16-byte aligned (K4's P starts 3 bytes into its
//     allocation, a contiguous P has any pitch), and TMA needs a 16-byte
//     aligned base and pitch, so the copies are cp.async: a row's 16-byte
//     chunk is copied whole only when it lies inside the row's columns 0 ..
//     wm (P's own bytes: the walk never reads past the corner), and the
//     ragged chunks at the row's two ends byte by byte. Row i of a staged
//     tile starts at the chunk holding its first column, i + dlo, so the
//     cell of diagonal d sits at (P + i pitch + i + dlo) % 16 + d - dlo.

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

constexpr int kTileRows = 64, kTileDiags = 64;
constexpr int kChunks = kTileDiags / 16 + 1;  // a row's chunks, any alignment
constexpr int kRowBytes = 16 * kChunks;
constexpr int kTileBytes = kTileRows * kRowBytes;
constexpr int kSlots = 16;                    // (row % 4, diagonal % 4)
constexpr size_t kWalkSmem = (size_t)kSlots * kTileBytes;
// the walker entering a tile within kEdge diagonals of a side asks for the
// tiles beside on that side too
constexpr int kEdge = 16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

// Stage tile (ti, td) into `slot`, by the 32 lanes of a warp: rows ti
// kTileRows .. (at most wn), row i from the 16-byte chunk holding column i
// + dlo at slot + (i - i0) kRowBytes; reads only the bytes of the row's
// columns 0 .. wm among its tile columns i + dlo .. i + dlo + kTileDiags -
// 1.
__device__ void stage(const int8_t* P, long long pitch, int ti, int td,
                      int wn, int wm, int8_t* slot, int lane) {
  const int i0 = ti * kTileRows, dlo = td * kTileDiags - wn;
  const int rows = min(wn, i0 + kTileRows - 1) - i0 + 1;
  for (int x = lane; x < rows * kChunks; x += 32) {
    const int r = x / kChunks, c = x - r * kChunks;
    const int i = i0 + r;
    const int lo = max(0, i + dlo), hi = min(wm, i + dlo + kTileDiags - 1);
    const int8_t* row = P + i * pitch;
    const int8_t* g =
        reinterpret_cast<const int8_t*>(
            reinterpret_cast<uintptr_t>(row + (i + dlo)) & ~(uintptr_t)15) +
        16 * c;
    if (lo > hi || g > row + hi || g + 15 < row + lo) continue;
    int8_t* d = slot + r * kRowBytes + 16 * c;
    if (g >= row && g + 15 <= row + wm) {
      cp_async16(d, g);
    } else {
#pragma unroll
      for (int y = 0; y < 16; ++y) {
        if (g + y >= row && g + y <= row + wm) d[y] = __ldg(g + y);
      }
    }
  }
}

__device__ __forceinline__ int slot_of(int ti, int td) {
  return (ti & 3) * 4 + (td & 3);
}

// the loader's lane 0: publish the slots whose copies, issued in passes
// up to `upto`, have landed (the caller waited), after a fence, so the
// walker that reads a slot's mark and then the tile sees the copies
__device__ __forceinline__ void publish(volatile int* ready, int* pend,
                                        const int* pgen, int upto) {
  __threadfence_block();
  for (int x = 0; x < kSlots; ++x) {
    if (pend[x] >= 0 && pgen[x] <= upto) {
      ready[x] = pend[x];
      pend[x] = -1;
    }
  }
}

__global__ void __launch_bounds__(64)
walk_p_tiled_kernel(const int8_t* __restrict__ P, int pitch, int wn,
                    int wm, int8_t* __restrict__ moves,
                    int* __restrict__ count) {
  extern __shared__ __align__(16) int8_t s_tile[];   // kSlots tiles
  __shared__ int s_ready[kSlots];   // the tile whose copy landed, or -1
  __shared__ int s_have[kSlots];    // the loader's: the tile a slot holds
  __shared__ int s_pend[kSlots];    // or awaits (-1: none), and the pass
  __shared__ int s_pgen[kSlots];    // that issued it
  __shared__ int s_cur, s_side, s_done;  // the walker's tile, the side it
                                         // entered near, the walk ended
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tds = (wn + wm) / kTileDiags + 1;    // tile (ti, td): ti tds + td
  if (threadIdx.x < kSlots) {
    s_ready[threadIdx.x] = s_have[threadIdx.x] = s_pend[threadIdx.x] = -1;
    s_pgen[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) {
    s_cur = -1;
    s_side = 0;
    s_done = 0;
  }
  __syncthreads();
  volatile int* ready = s_ready;
  volatile int* cur = &s_cur;
  volatile int* side = &s_side;
  volatile int* done = &s_done;

  if (warp == 0) {                     // the walker
    if (lane != 0) return;
    int i = wn, j = wm, state = 0, pos = 0;
    bool end = i <= 0 || j <= 0;
    // a row's misalignment moves by `step` a row up; its staged row keeps it
    const int step = (int)(((long long)pitch + 1) & 15);
    while (!end) {
      const int bi = i / kTileRows, bd = (j - i + wn) / kTileDiags;
      const int id = bi * tds + bd, sl = slot_of(bi, bd);
      const int i0 = bi * kTileRows, dlo = bd * kTileDiags - wn;
      int rd = j - i - dlo;            // the diagonal in the tile
      *side = rd < kEdge ? -1 : rd >= kTileDiags - kEdge ? 1 : 0;
      *cur = id;
      __threadfence_block();
      while (ready[sl] != id) {
      }
      __threadfence_block();
      // the move's cell at q; ri, rj and rd count down to the tile's
      // bounds (row and column 1 at the matrix's edge), so one test says
      // the walk left the tile; NONE is stored (pos does not move past it)
      // and ends the loop
      int ra = (int)(reinterpret_cast<uintptr_t>(P + (long long)i * pitch +
                                                 (i + dlo)) & 15);
      const int8_t* q = s_tile + sl * kTileBytes + (i - i0) * kRowBytes + ra +
                        rd;
      const int lo_i = max(i0, 1);
      int ri = i - lo_i, rj = j - 1, move;
      do {
        const int code = *q;
        move = state != 0 ? state : (code & 3);
        moves[pos] = (int8_t)move;
        pos += move != kNone;
        const bool left = move == kLeft, up = move == kUp;
        state = left ? ((code & kEExt) ? kLeft : 0)
                     : (up && (code & kFExt) ? kUp : 0);
        const int di = left ? 0 : 1, dj = up ? 0 : 1;
        const int ra_up = di ? (ra - step) & 15 : ra;
        q += (ra_up - ra) + (di - dj) - di * kRowBytes;
        ra = ra_up;
        ri -= di;
        rj -= dj;
        rd += di - dj;
      } while (move != kNone && (ri | rj | rd | (kTileDiags - 1 - rd)) >= 0);
      i = ri + lo_i;
      j = rj + 1;
      end = move == kNone || i == 0 || j == 0;
    }
    *count = pos;
    __threadfence_block();
    *done = 1;
    return;
  }

  // the loader: for each tile of the walker's it sees, a pass: issue the
  // copies of the tiles the walk may enter next that no slot holds or
  // awaits, as one group, then wait for every group but this one and
  // publish their tiles
  int last = -1, gen = 0;
  bool inflight = false;   // a pass's copies not yet published
  while (!*done) {
    const int c = *cur;
    if (c < 0 || c == last) {
      if (inflight) {           // no newer tile: publish the newest pass
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncwarp();
        if (lane == 0) publish(ready, s_pend, s_pgen, gen);
        __syncwarp();
        inflight = false;
      }
      __nanosleep(32);
      continue;
    }
    last = c;
    ++gen;
    inflight = true;
    const int bi = c / tds, bd = c - (c / tds) * tds, near = *side;
    // the tile, the two above it, then the two beside them on the near side
    for (int x = 0; x < 3 + 2 * (near != 0); ++x) {
      const int ti = bi - (x < 3 ? x : x - 3), td = bd + (x < 3 ? 0 : near);
      if (ti < 0 || td < 0 || td >= tds) continue;
      const int sl = slot_of(ti, td), id = ti * tds + td;
      // alike in every lane: only lane 0 writes these, between barriers
      if (s_have[sl] == id) continue;
      const bool busy = s_pend[sl] >= 0;
      __syncwarp();
      if (busy) {               // another tile's copy in flight: land it
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncwarp();
        if (lane == 0) publish(ready, s_pend, s_pgen, gen);
      }
      // mark the slot empty, then look at the walker's tile: if it is the
      // one the slot holds, leave the slot (the walker may be reading it)
      int take = 1;
      if (lane == 0) {
        const int was = ready[sl];
        ready[sl] = -1;
        __threadfence_block();
        if (*cur == s_have[sl] && s_have[sl] >= 0) {
          ready[sl] = was;
          take = 0;
        } else {
          s_have[sl] = s_pend[sl] = id;
          s_pgen[sl] = gen;
        }
      }
      take = __shfl_sync(0xffffffffu, take, 0);
      if (take) stage(P, pitch, ti, td, wn, wm, s_tile + sl * kTileBytes, lane);
      __syncwarp();
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();
    if (lane == 0) publish(ready, s_pend, s_pgen, gen - 1);
    __syncwarp();
  }
  asm volatile("cp.async.wait_all;" ::: "memory");   // none left in flight
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

// As sw_walk_p, by the tile-staged walk: P's rows at `pitch` bytes (any
// alignment, unit column stride), reading only rows 0 .. wn, columns 0 ..
// wm.
extern "C" int sw_walk_p_tiled(const int8_t* P, int pitch, int wn, int wm,
                               int8_t* moves, int* count,
                               cudaStream_t stream) {
  if (wn < 0 || wm < 0 || pitch <= wm) return (int)cudaErrorInvalidValue;
  // the slots pass the 48 KB a block has without an opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      walk_p_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWalkSmem);
  if (err != cudaSuccess) return (int)err;
  walk_p_tiled_kernel<<<1, 64, kWalkSmem, stream>>>(P, pitch, wn, wm, moves,
                                                     count);
  return (int)cudaGetLastError();
}
