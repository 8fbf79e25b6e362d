// The register-blocked single-pair stripe, K1-K5 redesigned for Hopper:
// one kernel template, included by three sources that each instantiate
// one family (one nvcc each, started together):
//   * stripe_rb.cu       - the local score-only fill (K1-K3): each stripe's
//     first row-major max (reduced by the caller), the right column H[:, m]
//     and, through it, H[n, m];
//   * stripe_rb_p.cu     - the same fill capturing P (K4, kP): one int8
//     predecessor code per cell into a row-major (n+1) x (m+1) P;
//   * stripe_rb_block.cu - the boundary-injected block fill (K5, kBlock):
//     row 0 and column 0 from the caller, local or global (NW), exporting
//     E of column m and, on request, H and F of row n;
//   * stripe_rb_band.cu  - the band form (K4b, kBand) of the score-only and
//     P-capture fills: only the cells with |i - j| <= band, each stripe
//     visiting only the columns its rows' band reaches;
//   * stripe_rb_debug.cu - the sanitizer's capture (K9, kDebugH) of the
//     score-only fill: every thread's R x C tile of H after every step and
//     the progress each boundary read observed;
//   * stripe_rb_pairs.cu - the batch form (K8, kPairs) of the score-only
//     fill: B pairs of one shape in one launch, each cut into its own
//     stripes, each pair's per-stripe firsts;
//   * stripe_rb_pairs_band.cu - the batch form with the band (K8[band],
//     kPairs and kBand): each pair's stripes visit only their band windows;
//   * stripe_rb_window.cu - the batch form with one shared query (K6 for
//     reads longer than 512 rows, kPairs and kShared): B reads (the rows)
//     against one window of the reference (the columns), which every pair
//     reads in place;
//   * stripe_rb_packed.cu - the packed form (K7, kPacked) of the score-only
//     fill: B pairs of one shape, each pair's rows at a pitch of whole
//     threads, every stripe starting at a pair's row 1, each row's (best,
//     first j) stored;
//   * stripe_rb_packed_debug.cu - the capture of the packed form (the
//     packed K9, kPacked and kDebugH).
// Three scorings, one template: linear match/mismatch (K1), affine
// match/mismatch (K2, Gotoh E and F) and a substitution table with linear
// or affine gaps (K3); K4, K5 and K4b take each of them.
//
// Replaces, with no band, the Pallas kernel of the JAX package
// (swtpu/kernels/pallas_fill.py, body `_kernel` :192 launched by
// `_stripe_call` :856 -> pallas_call :1008; affine :456-463, :529-536,
// :576-587; the table :364-379, :437-524 and `_profile_on_device` :1437)
// in its local single-pair score-only mode (`stripe_score_fn` :1249,
// `stripe_fill_raw` :1072), its P mode (`stripe_fill` :1190 with
// `return_p`) and its block mode (`stripe_block_fn` :1466 with `boundary`,
// `local` and `want_bottom`), which the stripe template's K1-K5
// (stripe_fill.cu, stripe_block.cu) served before. It serves `score()`,
// `align(traceback=False)`, the lean traceback's forward pass (K1-K3), the
// full-P `align()`, the lean window refill and each `align_hits` record
// (K4), the anchored reverse pass of `locate` and the Hirschberg /
// Myers-Miller row passes (K5).
//
// What bounds it on this card. The fill is a chain of dependent steps
// (every cell needs its left and upper neighbours). A 25632^2 pair cut
// into stripes keeps about a hundred warps busy, one per SM scheduler,
// so a step costs the latency of one warp's instructions, not their
// issue: the template's K1 (one row a thread) runs n + m = 51 k steps of
// about 790 clocks. With R rows a thread and one column a step, most of
// a step's cost is fixed (barrier, shuffles, shared hops, branches) and
// is paid once a column; chip_smoke.py times one stripe at C = 1 and
// C = 4 to show it (PERF.md section 6). The affine cell is about twice
// the linear cell's dependent work (E, F and a three-way max), and the
// table's score is a shared-memory load a cell. P capture adds a code a
// cell and its store (bytes of P: (n+1)(m+1)); the block form a load per
// row and per column of row 0, and stores of column m and row n.
//
// What the design does about it.
//   * A tile of R rows x C columns a thread a step (template parameters:
//     linear the default (8, 4), set by chip_smoke.py's sweep, and its
//     neighbours (4, 4), (16, 4), (8, 1), (8, 2) and (8, 8); affine and
//     table, and every K4 and K5 form, (8, 4), (8, 2) and (4, 4)); T * R
//     rows a stripe, T up to 512 threads (K4 and K5: 256 at R = 8). Thread k of stripe s owns rows s*T*R + k*R + 1 .. + R
//     and visits the tile of columns (t - k) * C + 1 .. + C at step t, in
//     registers. The barrier, the shuffles and the shared hops are paid
//     once per R x C cells, and the launch runs about m / C + n / R +
//     stripes x (hand-off lag) steps instead of n + m. Inside a tile cell
//     (r, c) needs (r - 1, c) and (r, c - 1) only, so the R + C - 1
//     anti-diagonals give the warp independent instructions to issue.
//   * Affine: E runs left to right along a thread's own row, one register
//     a row across tiles and steps; F runs down a column, row to row in
//     the tile, and from thread to thread beside H: a second shuffle, a
//     second edge slot across warps, a second boundary row across stripes
//     (bnd_f), loaded by warp 0 beside the H chunk under the same wait and
//     stored by the publishing warp beside it before the same release.
//     Row 0 is H = 0, F = NEG; column 0 is H = 0, E = NEG.
//   * Table: each thread's R row codes are fixed, so each thread builds its
//     own column of a profile in shared memory, (A + 1) x R / 4 x T int4,
//     prof[(q * R / 4 + r / 4) * T + k] holding S[q, b] of its rows
//     4 (r / 4) .. + 3; row q = A, and the rows whose code is a sentinel
//     (< 0) or past n, hold kNegSub. A tile's column reads R / 4 int4 at
//     the column code's row: eight threads cover 128 consecutive bytes, so
//     the reads hit no bank twice, and only thread k reads its column, so
//     the build needs no barrier. The query's codes come from the ring as
//     unsigned bytes: a sentinel (-1, -2, -3) reads as 255, 254, 253, so
//     min(code, A) sends it to row A (A is capped at 128, past every code
//     an int8 holds). 88 KB for BLOSUM62 (A = 21) at T = 128, R = 8.
//   * The boundary row is consumed by chunks of kPublish = 32 columns, the
//     producer's publication period (the producer's protocol is the
//     template's: H (and F) of the stripe's last row to a global row, a
//     release store of the progress every 32 columns and at m; here the
//     last warp stages its row in shared memory and stores each chunk
//     coalesced). At the step where thread 0 starts chunk c, warp 0 moves
//     chunk c, loaded a chunk earlier, from registers to shared memory,
//     waits for the progress to reach the end of chunk c + 1 (capped at m,
//     so it waits only for a column the producer publishes) and loads
//     chunk c + 1, one column a lane. No global load is on the per-step
//     chain.
//   * The query a is staged by warp 0 in a ring of kRing bytes of shared
//     memory, 32 columns a chunk, 64 columns ahead of thread 0, from a
//     register loaded a chunk before; a thread reads its tile's C codes
//     as one or two 32-bit words.
//   * The cell is the DPX form of sw_cell.cuh.
//   * The atomic stripe ticket stays: a block waits only on the stripe
//     before it, which took its ticket earlier and is resident.
//   * The argmax: each thread keeps (best, first j) per row under a strict
//     '>'; the block takes the smallest row holding its max; the caller
//     takes the first stripe holding the global max. right[i] is written
//     for each row from the tile holding column m, which stops at m.
//   * P capture (kP): the code follows the template's tie order
//     (stripe_kernel.cuh): from h = 0 and NONE a strictly greater DIAG,
//     then UP, then LEFT takes over; affine adds kEExt when E extends and
//     kFExt when F does (a tie counts as extension). The value H keeps
//     the score-only cell's one DPX instruction a row on the chain down
//     the tile; the code is read off it with compares and selects that
//     nothing waits on. A row's C codes are packed into one or two 32-bit
//     words (C = 2: a 16-bit half) and stored once a tile, which needs P + 1
//     and the row pitch 4-byte aligned (the wrapper pads the rows); the
//     tile holding column m stores bytes, so no store passes column m.
//     Rows past n store nothing. Row 0 and column 0 are written NONE here,
//     so the caller need not clear P.
//   * The block form (kBlock): each thread loads its R rows' H(i, 0) (and
//     E(i, 0)) once into the registers the row's LEFT chain starts from,
//     and the H of its last row into the last-row slots that the thread
//     below reads as its first DIAG; stripe 0's warp 0 loads row 0 from
//     `top` (and `top_f`) into the chunks the boundary row uses, with no
//     wait. `local == 0` drops the zero floor: the floor (0 or INT_MIN)
//     is folded into DIAG off the chain, so the cell keeps its DPX
//     instructions; NEG boundaries then propagate through the adds as in
//     the plain scan. The thread holding row n stores it (and F) column
//     by column when the caller asks for it; only its warp runs the copy
//     of the tile that keeps row n's values, so the other warps, and
//     every warp of a pass that asks for no row n, pay nothing for it.
//   * The band form (kBand): stripe s (rows r0 .. r1) visits only the
//     columns max(1, r0 - band) .. min(m, r1 + band), its window
//     (band_window), the first rounded down to a chunk so that a tile and
//     a chunk start where they do unbanded; thread k's tiles are the
//     window's, shifted by its first column. A cell of a window outside
//     the band is masked in the cell (tile_ext's kBand) to H = 0, E = F =
//     NEG, P = NONE, the template's band semantics. The row above is read
//     only where the stripe above stored it, up to its window's end (past
//     it, H = 0 and F = NEG: outside its last row's band), so no wait is on
//     a column nobody writes; thread 0's first DIAG, the row above's cell
//     left of the window, is read there too; a stripe releases m at its
//     end, and a stripe whose window is empty (band < 0, or rows below m +
//     band) stores no cell and still takes its ticket and releases. P is
//     cleared by the caller: only the windows' tiles are stored. The launch
//     runs about n / R + n / C steps whatever m, where unbanded it runs m /
//     C + n / R.
//   * The capture form (kDebugH, the sanitizer's K9): `tile` and
//     `tile_gotoh`, the very cells K1-K3 run, also hand each cell's H to a
//     register array; after every step each thread stages its R x C slots
//     in shared memory (after the affine arrays and the profile), the
//     cell's H where the cell lies in the matrix and 0 elsewhere (rows past
//     n, which the tile computes and nothing in the matrix reads, columns
//     past m, steps outside the thread's tiles, threads with no rows), and
//     each warp stores its 32 threads' slots, contiguous in aux.h, with
//     coalesced int4 stores. The lane of warp 0 that loads
//     boundary column j stores the progress it waited for in aux.seen;
//     aux.skew > 0, the checks' test hook, reads column j - skew instead
//     (0 and NEG left of column 1): a broken hand-off on purpose.
//   * The batch form (kPairs, K8): ticket t names pair t / S and its
//     stripe t % S, pair-major, so a block waits only on its own pair's
//     stripe above, which took an earlier ticket; the block then moves a,
//     b, the progress counters, the boundary rows and the stripe bests to
//     its pair's slice (the ring is staged once that is known) and runs
//     the score-only body, with no right column. With kBand (K8[band]) it
//     runs the band form's body on the pair's own stripes, counters and
//     rows, the ring staged once, from its window's first column; with
//     kShared (K6) a stays at the one query every pair shares, which each
//     block stages from global memory (from L2 after the first), so the
//     window is never copied B times.
//   * The packed form (kPacked, K7): a pair's rows sit at a pitch of
//     rlen = ceil(n / R) R, so all R rows of a thread are one pair's, and
//     every stripe starts at a pair's row 1. Where rlen <= T R a stripe
//     holds T / tpp whole pairs of tpp = rlen / R threads each (the
//     wrapper rounds T to the warps they need; threads past the last pair
//     idle), and no stripe reads a boundary row; above, each pair takes
//     aux.stripes stripes of its own, chained as K8's under pair-major
//     tickets. The skew restarts at each pair: the thread kk of a pair's
//     threads in the stripe visits the tile t - kk at step t, so a stripe
//     runs ceil(m / C) + tpp - 1 steps whatever its number of pairs, and
//     the thread kk = 0 of a pair starts from the pair's row 0 (H = 0, F =
//     NEG), not from the thread above, the JAX package's reset row. Each
//     thread reads its own pair's query: it loads its next tile's C codes
//     from global memory (L2 holds the B m codes) one step ahead into
//     registers, so no load is on the step's chain and no ring is shared
//     by threads of several pairs. The rows past n of a pair's last
//     thread are computed and discarded, as rows past n are; each thread
//     stores its rows' (best, first j) into row_best (B, n, 2), read by
//     the caller's per-pair reduce. With kDebugH the capture is of that
//     schedule: slot (s, t, k, r, c) the cell of pair gk, row kk R + r + 1
//     of the stripe's rows of it, column (t - kk) C + c + 1.
//   * The affine and table forms keep their extra arrays in dynamic shared
//     memory and their extra parameters last, and the K4 and K5 forms
//     their template parameters and their argument (Ext) last, and K4b its
//     template parameter and its argument (band) after those, and K9 and
//     K8 theirs (kDebugH, kPairs; aux) after K4b's, and K6 its kShared
//     after kPairs, and K7 its kPacked after kShared, so the earlier forms'
//     code is what it was before they were added
//     (scripts/torch_sass_diff.py).
//
// Each entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after its launch.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "sw_cell.cuh"

namespace {

using swcell::kNeg;
using swcell::kNegSub;

constexpr int kPublish = 32;       // columns between publications: a chunk
constexpr int kMaxThreads = 512;   // registers: R = 16 needs about 110
// the K4 and K5 forms' launch bound: a code (or a row-n capture) a cell on
// top of the affine cell's registers needs more than the 128 a 512-thread
// block allows at R = 8 (up to 203), so those tiles take kExtThreads; at
// R = 4 every form fits in 128 (at most 117), so that tile takes kMaxThreads
constexpr int kExtThreads = 256;
__host__ __device__ constexpr int ext_threads(int R) {
  return R <= 4 ? kMaxThreads : kExtThreads;
}
constexpr int kMaxCols = 8;
constexpr int kAhead = 64;         // columns of a staged ahead of thread 0
// the ring spans the columns of a step (T * C), the staged ones and a chunk
constexpr int kRing = 8192;
static_assert(kRing > kMaxThreads * kMaxCols + kAhead + kPublish, "ring");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSym = 128;       // profile rows: no int8 code reaches more
constexpr int kNone = 0, kUp = 1, kLeft = 2, kDiagonal = 3;
constexpr int kEExt = 4, kFExt = 8;     // Gotoh state bits of affine P

// ints of the affine form's dynamic shared arrays: F's edge slots
// [2][kMaxThreads / 32][C], the F chunk of the row above [2][kPublish] and
// the last row's F [kPublish]; a multiple of 4, so the profile after them
// is int4-aligned
template <int C>
__host__ __device__ constexpr int f_ints() {
  return 2 * (kMaxThreads / 32) * C + 3 * kPublish;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// kPacked: the codes of tile q (0-based columns q C .. q C + C - 1) of the
// thread's pair's query ak, as unsigned bytes (as ring_codes reads them),
// 0 outside 0 .. m - 1; loaded a step before the tile runs
template <int C>
__device__ __forceinline__ void packed_codes(const int8_t* ak, int m, int q,
                                             int (&ac)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = q * C + c;
    ac[c] = q >= 0 && col < m ? (uint8_t)__ldg(&ak[col]) : 0;
  }
}

// the codes of 0-based columns col0 .. col0 + C - 1 from the ring, as
// unsigned bytes (compared with the rows' codes read the same way); col0
// is a multiple of C, so they lie in one word or, C = 8, two
template <int C>
__device__ __forceinline__ void ring_codes(const uint32_t* ring, int col0,
                                           int (&ac)[C]) {
  constexpr int kWords = C > 4 ? C / 4 : 1;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const uint32_t v = ring[((col0 >> 2) + w) & (kRing / 4 - 1)];
#pragma unroll
    for (int c = 4 * w; c < 4 * w + 4 && c < C; ++c) {
      const int shift = 8 * (C >= 4 ? c - 4 * w : (col0 & 3) + c);
      ac[c] = (v >> shift) & 0xff;
    }
  }
}

// one tile: columns j0 .. j0 + nc - 1 of the thread's R rows. U: H of the
// row above in those columns; diag0: H of the row above in column j0 - 1.
// B gets the last row's H in each column computed.
// kCap (the capture form): each cell's H also into hc[r][c].
template <int R, int C, bool kPartial, bool kCap = false>
__device__ __forceinline__ void tile(int j0, int nc, const int (&ac)[C],
                                     const int (&code)[R], const int (&U)[C],
                                     int diag0, int match, int mismatch,
                                     int gap, int (&H)[R], int (&best)[R],
                                     int (&best_j)[R], int (&B)[C],
                                     int (*hc)[C] = nullptr) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (kPartial && c >= nc) break;
    int diag = c == 0 ? diag0 : U[c - 1];
    int up = U[c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int left = H[r];
      const int h = swcell::linear(
          diag + swcell::compare(ac[c], code[r], match, mismatch), left, up,
          gap);
      swcell::track(h, j0 + c, best[r], best_j[r]);
      if constexpr (kCap) hc[r][c] = h;
      diag = left;
      up = h;
      H[r] = h;
    }
    B[c] = H[R - 1];
  }
}

// The scoring of the affine and table forms.
struct Gotoh {
  int match, mismatch, gap, open, extend;
  const int4* prof;   // kSub: the thread's profile column
  int T;              // kSub: the profile's row stride, in int4
  int rows;           // kSub: the sentinel row, min(A, kMaxSym)
};

// the scores of column code aj against the thread's R rows: a column of
// the thread's profile (kSub) or the match/mismatch compare
template <int R, bool kSub>
__device__ __forceinline__ void column_scores(int aj, const int (&code)[R],
                                              const Gotoh& g, int (&s)[R]) {
  if constexpr (kSub) {
    const int4* p = g.prof + min(aj, g.rows) * (R / 4) * g.T;
#pragma unroll
    for (int r4 = 0; r4 < R / 4; ++r4) {
      const int4 v = p[r4 * g.T];
      s[4 * r4] = v.x;
      s[4 * r4 + 1] = v.y;
      s[4 * r4 + 2] = v.z;
      s[4 * r4 + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = swcell::compare(aj, code[r], g.match, g.mismatch);
    }
  }
}

// one tile of the affine or table form, as `tile`; affine, E[r] is
// E(row r, j0 - 1) in and E of the tile's last column out, UF F of the row
// above in the tile's columns, and BF gets the last row's F
template <int R, int C, bool kPartial, bool kAffine, bool kSub,
          bool kCap = false>
__device__ __forceinline__ void tile_gotoh(
    int j0, int nc, const int (&ac)[C], const int (&code)[R],
    const int (&U)[C], const int (&UF)[C], int diag0, const Gotoh& g,
    int (&H)[R], int (&E)[R], int (&best)[R], int (&best_j)[R],
    int (&B)[C], int (&BF)[C], int (*hc)[C] = nullptr) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (kPartial && c >= nc) break;
    int diag = c == 0 ? diag0 : U[c - 1];
    int up = U[c];
    int f = kNeg;
    if constexpr (kAffine) f = UF[c];
    int s[R];
    column_scores<R, kSub>(ac[c], code, g, s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int left = H[r];
      int h;
      if constexpr (kAffine) {
        E[r] = swcell::affine_e(E[r], left, g.open, g.extend);
        f = swcell::affine_f(f, up, g.open, g.extend);
        h = swcell::affine(diag + s[r], E[r], f);
      } else {
        h = swcell::linear(diag + s[r], left, up, g.gap);
      }
      swcell::track(h, j0 + c, best[r], best_j[r]);
      if constexpr (kCap) hc[r][c] = h;
      diag = left;
      up = h;
      H[r] = h;
    }
    B[c] = H[R - 1];
    if constexpr (kAffine) BF[c] = f;
  }
}

// The extra arguments of the K4 (kP) and K5 (kBlock) forms, one kernel
// parameter after the others.
struct Ext {
  int8_t* P;            // kP: P(i, j) at P[i * pitch + j], i <= n, j <= m
  int pitch;            // kP: bytes a row, at least m + 1
  const int* top;       // kBlock: H(0, :), m + 1, holding the corner
  const int* left;      // kBlock: H(:, 0), n + 1, holding the corner
  const int* top_f;     // kBlock, affine: F(0, :)
  const int* left_e;    // kBlock, affine: E(:, 0)
  int* right_e;         // kBlock, affine: E(:, m); [0] left to the caller
  int* bottom;          // kBlock: H(n, :) or null; [0] left to the caller
  int* bottom_f;        // kBlock, affine, with bottom: F(n, :)
  int local;            // kBlock: 0 runs the global recurrence
};

// a thread's share of Ext
struct Cap {
  int8_t* prow;         // kP: &P(first + 1, 0)
  int pitch;
  int rows;             // kP: rows of the thread inside the matrix (< R
                        // only for the thread holding row n)
  int floor;            // kBlock: 0 (local) or INT_MIN (global)
  int bottom_r;         // kBlock: the tile row that is row n, or -1
  bool bottom_warp;     // kBlock: the warp holding row n, when exported
  int* bottom;
  int* bottom_f;
  int bdiff;            // kBand: band - first - 1, so that cell (first + 1 +
  unsigned bw;          // r, j) is in the band iff bdiff + j - r <= bw,
                        // 2 band, compared unsigned
};

// kBand: whether row r of the thread's tile from column j0 holds a cell in
// the band (columns j0 .. j0 + C - 1; the cell test of tile_ext, bdiff +
// j - r in 0 .. bw)
template <int C>
__device__ __forceinline__ bool band_reaches(const Cap& x, int j0, int r) {
  const int lo = x.bdiff + j0 - r;
  return lo + C - 1 >= 0 && lo <= (int)x.bw;
}

// one tile of the K4 (kP) or K5 (kBlock) form, in every scoring, as
// `tile_gotoh` (a linear scoring takes g.gap): kP also stores the tile's
// codes into P, kBlock runs the cell with x.floor in place of the zero
// floor; kRowN (the warp holding row n) stores row n's H (and F) when
// this thread holds it; kBand masks the cells with |i - j| > band to H =
// 0, E = F = NEG and P = NONE: DIAG to NEG and, linear, the gap to NEG
// (UP and LEFT are at least 0, so UP + NEG and LEFT + NEG stay below 0
// without overflow), affine E and F selected to NEG, so the chain down the
// tile keeps its one DPX instruction a row (linear) and adds a select on F
// (affine)
template <int R, int C, bool kPartial, bool kAffine, bool kSub, bool kP,
          bool kBlock, bool kRowN = false, bool kBand = false>
__device__ __forceinline__ void tile_ext(
    int j0, int nc, const int (&ac)[C], const int (&code)[R],
    const int (&U)[C], const int (&UF)[C], int diag0, const Gotoh& g,
    const Cap& x, int (&H)[R], int (&E)[R], int (&best)[R],
    int (&best_j)[R], int (&B)[C], int (&BF)[C]) {
  // kP on a whole tile: the row's codes, a byte a column, stored once
  constexpr bool kPack = kP && !kPartial;
  constexpr int kWords = C > 4 ? C / 4 : 1;
  uint32_t pk[R][kWords];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) pk[r][w] = 0;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (kPartial && c >= nc) break;
    int diag = c == 0 ? diag0 : U[c - 1];
    int up = U[c];
    int f = kNeg;
    if constexpr (kAffine) f = UF[c];
    int s[R];
    column_scores<R, kSub>(ac[c], code, g, s);
    int hb = 0, fb = kNeg;  // kRowN: H and F of row n
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int left = H[r];
      int d = diag + s[r];
      [[maybe_unused]] bool in = true;    // kBand: the cell lies in the band
      [[maybe_unused]] int gap = g.gap;
      if constexpr (kBand) {
        in = (unsigned)(x.bdiff + j0 + c - r) <= x.bw;
        d = in ? d : kNeg;
        gap = in ? gap : kNeg;
      }
      int h;
      if constexpr (kP) {
        // H on the chain as in the score-only cell; the move off it: DIAG
        // if DIAG > 0, UP if UP > max(0, DIAG), LEFT if LEFT > max(0,
        // DIAG, UP), the template's order
        bool kd, ku;
        const int h1 = __vibmax_s32(0, d, &kd);   // kd: DIAG does not win
        int lv, hu;       // LEFT's value; max(0, DIAG, UP)
        int bits = 0;     // affine: the state bits
        if constexpr (kAffine) {
          const int e_ext = E[r] + g.extend;
          const int f_ext = f + g.extend;
          E[r] = swcell::affine_e(E[r], left, g.open, g.extend);
          f = swcell::affine_f(f, up, g.open, g.extend);
          if constexpr (kBand) {
            E[r] = in ? E[r] : kNeg;
            f = in ? f : kNeg;
          }
          h = __vimax3_s32(h1, E[r], f);
          hu = __vibmax_s32(h1, f, &ku);
          lv = E[r];
          bits = (E[r] == e_ext ? kEExt : 0) + (f == f_ext ? kFExt : 0);
        } else {
          lv = left + gap;
          h = __viaddmax_s32(up, gap, max(h1, lv));
          hu = __vibmax_s32(h1, up + gap, &ku);
        }
        int code_ =
            (lv > hu ? kLeft : !ku ? kUp : kd ? kNone : kDiagonal) + bits;
        // kBand: a masked linear cell reads NONE already (every move is
        // below 0); a masked affine cell's state bits are cleared here
        if constexpr (kBand && kAffine) code_ = in ? code_ : kNone;
        if constexpr (kPack) {
          pk[r][c / 4] |= (uint32_t)code_ << (8 * (c % 4));
        } else if (r < x.rows && (!kBand || in)) {
          x.prow[r * x.pitch + j0 + c] = (int8_t)code_;
        }
      } else {
        if constexpr (kAffine) {
          E[r] = swcell::affine_e(E[r], left, g.open, g.extend);
          f = swcell::affine_f(f, up, g.open, g.extend);
          if constexpr (kBand) {
            E[r] = in ? E[r] : kNeg;
            f = in ? f : kNeg;
          }
          h = __vimax3_s32(max(d, x.floor), E[r], f);
        } else {
          h = __viaddmax_s32(up, gap,
                             __viaddmax_s32(left, gap, max(d, x.floor)));
        }
        if constexpr (kRowN) {
          if (r == x.bottom_r) {
            hb = h;
            fb = f;
          }
        }
      }
      swcell::track(h, j0 + c, best[r], best_j[r]);
      diag = left;
      up = h;
      H[r] = h;
    }
    if constexpr (kRowN) {
      if (x.bottom_r >= 0) {              // this thread holds row n
        x.bottom[j0 + c] = hb;
        if constexpr (kAffine) x.bottom_f[j0 + c] = fb;
      }
    }
    B[c] = H[R - 1];
    if constexpr (kAffine) BF[c] = f;
  }
  if constexpr (kPack) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // kBand: a row of the tile wholly outside the band is NONE, which the
      // caller's clear of P left there: no store
      if (r < x.rows && (!kBand || band_reaches<C>(x, j0, r))) {
        int8_t* p = x.prow + r * x.pitch + j0;
        if constexpr (C == 1) {
          *p = (int8_t)pk[r][0];
        } else if constexpr (C == 2) {
          *reinterpret_cast<uint16_t*>(p) = (uint16_t)pk[r][0];
        } else {
#pragma unroll
          for (int w = 0; w < kWords; ++w) {
            reinterpret_cast<uint32_t*>(p)[w] = pk[r][w];
          }
        }
      }
    }
  }
}

// The arguments of the capture (kDebugH, K9) and batch (kPairs, K8) forms,
// one kernel parameter after band: a field added to Ext moved an earlier
// instantiation's registers, a parameter after the others moves nothing.
struct Aux {
  int* h;               // kDebugH: (stripes, tiles + T - 1, T, R, C) int32,
                        // slot (s, t, k, r, c) the cell (s T R + k R + r +
                        // 1, (t - k) C + c + 1); steps a stripe never runs
                        // keep the caller's fill
  int* seen;            // kDebugH: (stripes, m + 1) int32, -1 filled by the
                        // caller: the progress seen at each boundary read
  int skew;             // kDebugH: the test hook, 0 in a sanitizer run
  int pairs;            // kPairs, kPacked: B
  int stripes;          // kPairs, kPacked: S, stripes a pair (set by
                        // `launch`; kPacked: 1 where a stripe holds whole
                        // pairs)
};

// kDebugH: boundary column j (H and, affine, F of the row above) as the
// lane of warp 0 loading it reads it: from column j - skew, 0 and NEG left
// of column 1; the progress it waited for stored at seen[s, j]; nothing
// past m
template <bool kAffine>
__device__ __forceinline__ void debug_read(const Aux& aux, int s, int m,
                                           const int* up_row,
                                           const int* bnd_f, int j, int seen,
                                           int& h, int& f) {
  h = 0;
  f = kNeg;
  if (j > m) return;
  const size_t m1 = (size_t)m + 1;
  aux.seen[(size_t)s * m1 + j] = seen;
  const int jr = j - aux.skew;
  if (jr >= 1) {
    h = __ldcg(&up_row[jr]);
    if constexpr (kAffine) f = __ldcg(&bnd_f[(s - 1) * m1 + jr]);
  }
}

// The band form's window of stripe s (rows s * rows + 1 .. min(n, (s + 1) *
// rows)): the columns col0 + 1 .. end, in `tiles` tiles of C from column
// col0 + 1, where col0 rounds max(1, r0 - band) - 1 down to a chunk, so a
// tile starts at 1 + C q and a chunk at 1 + 32 c, and end is the last
// tile's last column (at most m); no tile when band < 0 or the band has
// left the matrix, and then end = col0.
__device__ __forceinline__ void band_window(int s, int rows, int C, int m,
                                            int n, int band, int& col0,
                                            int& tiles, int& end) {
  const int r0 = s * rows + 1;
  const int r1 = min(n, r0 - 1 + rows);
  const int lo = max(1, r0 - band);
  const int hi = min(m, r1 + band);
  if (band < 0 || lo > hi) {
    col0 = min(m, lo - 1) / kPublish * kPublish;
    tiles = 0;
    end = col0;
  } else {
    col0 = (lo - 1) / kPublish * kPublish;
    const int q1 = (hi - 1) / C;
    tiles = q1 - col0 / C + 1;
    end = min(m, (q1 + 1) * C);
  }
}

// sync:  [0] the stripe ticket, [1 + s] the last column stripe s published.
// bnd:   (stripes - 1) x (m + 1) int32, row s = H of stripe s's last row.
// best:  (stripes, 4) int32, row s = (score, i, j, 0) of the stripe's first
//        max, or zeros when the stripe holds no positive cell.
// right: (n + 1) int32, right[i] = H(i, m); right[0] is left to the caller.
// open, extend: affine only; sub, A: (A, A) int32 S[a_code, b_code], the
//        table form only; bnd_f: as bnd for F, affine only. Last, so that
//        the parameters before them keep their offsets.
// ext:   the K4 and K5 forms' arguments, after bnd_f for the same reason.
// band:  kBand's half-width, -1 .. m + n, last: a field added to Ext
//        changed an earlier instantiation's register allocation.
// aux:   the K9 (kDebugH) and K8 (kPairs) forms' arguments, after band for
//        the same reason. kPairs: sync holds the ticket, then B * S
//        progress counters, pair by pair; bnd (and bnd_f) B * (S - 1) rows,
//        best (B, S, 4); right is not written. kShared: a is one (m,)
//        query for every pair, b (B, n). kPacked: a (B, m), b (B, n);
//        sync the ticket, then a counter a ticket; bnd (and bnd_f) B * (S -
//        1) rows; best_out is row_best (B, n, 2); right is not written.
// the launch bound of the source's instantiations: K1-K3's kMaxThreads
// (stripe_rb.cu, and K8's stripe_rb_pairs.cu; K6's stripe_rb_window.cu
// adds one block an SM); stripe_rb_p.cu, stripe_rb_block.cu and the band
// forms' stripe_rb_band.cu and stripe_rb_pairs_band.cu define it as the
// tile's ext_threads(R) and one block an SM before including this header,
// which keeps ptxas from trading registers for occupancy these
// one-block-an-SM launches never use (it spilled 4-12 bytes at 64-128
// registers without); the packed form's stripe_rb_packed.cu as K6's,
// stripe_rb_packed_debug.cu as K9's
#ifndef SW_RB_LAUNCH_BOUNDS
#define SW_RB_LAUNCH_BOUNDS kMaxThreads
#endif

template <int R, int C, bool kAffine, bool kSub, bool kP = false,
          bool kBlock = false, bool kBand = false, bool kDebugH = false,
          bool kPairs = false, bool kShared = false, bool kPacked = false>
__global__ void __launch_bounds__(SW_RB_LAUNCH_BOUNDS)
stripe_rb_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int m, int n, int match, int mismatch, int gap,
                 int* __restrict__ sync, int* __restrict__ bnd,
                 int* __restrict__ best_out, int* __restrict__ right,
                 int open, int extend, const int* __restrict__ sub, int A,
                 int* __restrict__ bnd_f, Ext ext, int band, Aux aux) {
  static_assert(kPublish % C == 0 && C <= kMaxCols, "C divides a chunk");
  static_assert(!kSub || R % 4 == 0, "the profile holds 4 rows an int4");
  static_assert(!(kP && kBlock), "the block form captures no P");
  static_assert(!(kBand && kBlock), "the block form takes no band");
  static_assert(!(kDebugH && (kP || kBlock || kBand || kPairs)) &&
                    !(kPairs && (kP || kBlock)),
                "the capture form is score-only and unbanded, the batch "
                "form score-only");
  static_assert(!kShared || (kPairs && !kBand),
                "the shared query is the unbanded batch form's");
  static_assert(!kPacked || !(kP || kBlock || kBand || kPairs),
                "the packed form is score-only and unbanded, its own batch "
                "form");
  static_assert(!kDebugH || C % 4 == 0, "the capture stores int4 words");
  constexpr int kSteps = kPublish / C;         // steps a chunk
  __shared__ int s_stripe, s_best, s_k;
  __shared__ int s_edge[2][kMaxThreads / 32][C];  // each warp's last lane
  __shared__ uint32_t s_ring[kRing / 4];       // the query, 4 codes a word
  __shared__ int s_bnd[2][kPublish];           // the chunk of the row above
  __shared__ int s_pub[kPublish];              // the last row's H, a chunk
  // affine: s_fedge, s_bndf and s_pubf, F's twins of s_edge, s_bnd and
  // s_pub; then, table, the profile
  extern __shared__ int4 s_dyn[];
  int* const s_f = reinterpret_cast<int*>(s_dyn);
  auto s_fedge = reinterpret_cast<int (*)[kMaxThreads / 32][C]>(s_f);
  auto s_bndf = reinterpret_cast<int (*)[kPublish]>(
      s_f + 2 * (kMaxThreads / 32) * C);
  int* const s_pubf = s_f + 2 * (kMaxThreads / 32) * C + 2 * kPublish;
  int8_t* ring = reinterpret_cast<int8_t*>(s_ring);

  const int k = threadIdx.x;
  const int T = blockDim.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  if (k == 0) {
    s_stripe = atomicAdd(&sync[0], 1);
    s_best = 0;
    s_k = T;
  }
  for (int x = k; x < 2 * (kMaxThreads / 32) * C; x += T) {
    (&s_edge[0][0][0])[x] = 0;
  }
  if constexpr (kAffine) {
    for (int x = k; x < 2 * (kMaxThreads / 32) * C; x += T) s_f[x] = kNeg;
  }
  if constexpr (!kBand && !kPairs && !kPacked) {
    for (int c = k; c < kAhead && c < m; c += T) ring[c] = a[c];
  }
  __syncthreads();

  const int s = (kPairs || kPacked) ? s_stripe % aux.stripes : s_stripe;
  if constexpr (kPairs) {
    // pair-major tickets: stripe s of pair g waits only on stripe s - 1 of
    // pair g, which took the ticket before it
    const int g = s_stripe / aux.stripes;
    const size_t rows_above = (size_t)g * (aux.stripes - 1) * ((size_t)m + 1);
    if constexpr (!kShared) a += (size_t)g * m;
    b += (size_t)g * n;
    sync += (size_t)g * aux.stripes;
    bnd += rows_above;
    if constexpr (kAffine) bnd_f += rows_above;
    best_out += (size_t)g * aux.stripes * 4;
    if constexpr (!kBand) {     // kBand stages it from its window's start
      for (int c = k; c < kAhead && c < m; c += T) ring[c] = a[c];
      __syncthreads();
    }
  }
  // kPacked: the thread's pair gk and its place kk among the pair's threads
  // of the stripe (kk = T for a thread that holds no pair: its rows lie
  // past n, so it computes and stores nothing); else kk is k
  int kk = k;
  [[maybe_unused]] int gk = 0;
  [[maybe_unused]] const int8_t* ak = a;   // kPacked: the pair's query
  if constexpr (kPacked) {
    // ticket s_stripe: stripe s of pair g, pair-major (aux.stripes > 1),
    // or stripe g of T / tpp whole pairs, tpp threads each (aux.stripes ==
    // 1); the counters and boundary rows are the pair's own
    const int g = s_stripe / aux.stripes;
    const size_t rows_above = (size_t)g * (aux.stripes - 1) * ((size_t)m + 1);
    sync += (size_t)g * aux.stripes;
    bnd += rows_above;
    if constexpr (kAffine) bnd_f += rows_above;
    const int tpp = aux.stripes > 1 ? T : (n + R - 1) / R;
    const int per = T / tpp;
    const int slot = k / tpp;
    gk = aux.stripes > 1 ? g : g * per + slot;
    const bool live = slot < per && gk < aux.pairs;
    kk = live ? k - slot * tpp : T;
    gk = live ? gk : 0;
    b += (size_t)gk * n;
    ak = a + (size_t)gk * m;
    if constexpr (kDebugH) {
      // the capture's stripe is the ticket, s the pair's stripe
      aux.h += (size_t)(s_stripe - s) * ((m + C - 1) / C + T - 1) * T * R *
               C;
      aux.seen += (size_t)(s_stripe - s) * ((size_t)m + 1);
    }
  }
  const int first = s * T * R + kk * R;    // rows first + 1 .. first + R
  const int kt = (min(T * R, n - s * T * R) + R - 1) / R;  // threads with rows
  // the columns col0 + 1 .. end the stripe visits, in `tiles` tiles; the
  // stripe above stored its last row's pcol0 + 1 .. pend. Every column with
  // no band; kBand, the windows of band_window
  int tiles = (m + C - 1) / C;
  int col0 = 0, end = m, pcol0 = 0, pend = m;
  if constexpr (kBand) {
    band_window(s, T * R, C, m, n, band, col0, tiles, end);
    if (s > 0) {
      int ptiles;
      band_window(s - 1, T * R, C, m, n, band, pcol0, ptiles, pend);
    }
    for (int c = k; c < kAhead && col0 + c < m; c += T) {
      ring[(col0 + c) & (kRing - 1)] = a[col0 + c];
    }
    __syncthreads();
  }
  const int steps = kBand && tiles == 0 ? 0 : tiles + kt - 1;
  int code[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    code[r] = first + r < n ? (uint8_t)b[first + r] : 0x100;
  }
  Gotoh g{match, mismatch, gap, open, extend, nullptr, T, 0};
  if constexpr (kSub) {
    // the thread's column of the profile; only this thread reads it
    g.rows = min(A, kMaxSym);
    int4* col = s_dyn + (kAffine ? f_ints<C>() / 4 : 0) + k;
    g.prof = col;
    int cb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cb[r] = first + r < n ? b[first + r] : -1;
    for (int q = 0; q <= g.rows; ++q) {
#pragma unroll
      for (int r4 = 0; r4 < R / 4; ++r4) {
        int v[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int bc = cb[4 * r4 + x];
          v[x] = q < g.rows && bc >= 0 ? __ldg(&sub[q * A + bc]) : kNegSub;
        }
        col[(q * (R / 4) + r4) * T] = make_int4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  Cap cap{nullptr, 0, 0, 0, -1, false, nullptr, nullptr};
  if constexpr (kP) {
    // row 0 and column 0 of P are NONE (kBand: the caller clears P, and
    // only the windows' tiles are stored)
    cap.pitch = ext.pitch;
    cap.rows = n - first;
    if (first < n) cap.prow = ext.P + (size_t)(first + 1) * ext.pitch;
    if constexpr (!kBand) {
      if (s == 0) {
        for (int j = k; j <= m; j += T) ext.P[j] = kNone;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < cap.rows) cap.prow[r * cap.pitch] = kNone;
      }
    }
  }
  if constexpr (kBand) {
    cap.bdiff = band - first - 1;
    cap.bw = 2u * (unsigned)band;
  }
  if constexpr (kBlock) {
    cap.floor = ext.local ? 0 : INT_MIN;
    // only the warp holding row n runs the tile's capturing copy, so the
    // others pay nothing for the export
    const int row_n_warp = (n - 1 - s * T * R) / (32 * R);
    cap.bottom_warp = ext.bottom != nullptr &&
                      (long long)(s + 1) * T * R >= n && warp == row_n_warp;
    if (ext.bottom != nullptr && first < n && n <= first + R) {
      cap.bottom_r = n - 1 - first;
      cap.bottom = ext.bottom;
      cap.bottom_f = ext.bottom_f;
    }
  }
  const size_t m1 = (size_t)m + 1;
  const int* up_row = bnd + (s > 0 ? (size_t)(s - 1) * m1 : 0);
  int* down_row = bnd + (size_t)s * m1;
  int* progress = sync + 1 + s;
  const int* wait_on = sync + s;                       // stripe s-1's counter
  // the last warp of a stripe above the last publishes its last row
  const bool publish = warp == (T >> 5) - 1 &&
                       (long long)(s + 1) * T * R < n;

  // warp 0 of a stripe below the first: chunk c of the boundary row
  // (columns 32c + 1 .. 32c + 32, one a lane) in cur, chunk c + 1 in nxt;
  // affine, F's in cur_f and nxt_f
  int cur = 0, nxt = 0, seen = 0;
  int cur_f = kNeg, nxt_f = kNeg;
  if constexpr (kBand) {
    // the row above holds H = 0 and F = NEG past pend (outside its band):
    // read only up to pend, so no wait is on a column it never stores
    // (the wait covers column col0 too: thread 0's first DIAG)
    if (warp == 0 && s > 0 && tiles > 0 && col0 <= pend) {
      while (seen < min(col0 + kPublish, pend)) seen = load_acquire(wait_on);
      const int j = col0 + 1 + lane;
      cur = j <= pend ? __ldcg(&up_row[j]) : 0;
      if constexpr (kAffine) {
        cur_f = j <= pend ? __ldcg(&bnd_f[(s - 1) * m1 + j]) : kNeg;
      }
      if (col0 + kPublish < end && col0 + kPublish < pend) {
        while (seen < min(col0 + 2 * kPublish, pend)) {
          seen = load_acquire(wait_on);
        }
        const int jn = j + kPublish;
        nxt = jn <= pend ? __ldcg(&up_row[jn]) : 0;
        if constexpr (kAffine) {
          nxt_f = jn <= pend ? __ldcg(&bnd_f[(s - 1) * m1 + jn]) : kNeg;
        }
      }
    }
  } else if (warp == 0 && s > 0) {
    while (seen < min(kPublish, m)) seen = load_acquire(wait_on);
    if constexpr (kDebugH) {
      debug_read<kAffine>(aux, s, m, up_row, bnd_f, lane + 1, seen, cur,
                          cur_f);
    } else {
      cur = lane + 1 <= m ? __ldcg(&up_row[lane + 1]) : 0;
      if constexpr (kAffine) {
        cur_f =
            lane + 1 <= m ? __ldcg(&bnd_f[(s - 1) * m1 + lane + 1]) : kNeg;
      }
    }
    if (m > kPublish) {
      while (seen < min(2 * kPublish, m)) seen = load_acquire(wait_on);
      if constexpr (kDebugH) {
        debug_read<kAffine>(aux, s, m, up_row, bnd_f, kPublish + lane + 1,
                            seen, nxt, nxt_f);
      } else {
        nxt = kPublish + lane + 1 <= m
                  ? __ldcg(&up_row[kPublish + lane + 1])
                  : 0;
        if constexpr (kAffine) {
          nxt_f = kPublish + lane + 1 <= m
                      ? __ldcg(&bnd_f[(s - 1) * m1 + kPublish + lane + 1])
                      : kNeg;
        }
      }
    }
  }
  // kBlock: stripe 0's row above is the injected row 0, whole from the
  // start, so warp 0 reads it with no wait
  if constexpr (kBlock) {
    if (warp == 0 && s == 0) {
      cur = lane + 1 <= m ? __ldg(&ext.top[lane + 1]) : 0;
      if constexpr (kAffine) {
        cur_f = lane + 1 <= m ? __ldg(&ext.top_f[lane + 1]) : kNeg;
      }
      if (m > kPublish) {
        const int j = kPublish + lane + 1;
        nxt = j <= m ? __ldg(&ext.top[j]) : 0;
        if constexpr (kAffine) nxt_f = j <= m ? __ldg(&ext.top_f[j]) : kNeg;
      }
    }
  }
  // warp 0: the 32 columns of a that the ring takes next
  const int a0 = col0 + kAhead + lane;
  int a_next = (warp == 0 && a0 < m) ? __ldg(&a[a0]) : 0;

  int H[R], best[R], best_j[R];
#pragma unroll
  for (int r = 0; r < R; ++r) H[r] = best[r] = best_j[r] = 0;
  int E[R];                // affine: E(row, j0 - 1), the row's LEFT chain
#pragma unroll
  for (int r = 0; r < R; ++r) E[r] = kNeg;
  int B[C];                // the last row's H in the tile's columns
#pragma unroll
  for (int c = 0; c < C; ++c) B[c] = 0;
  int BF[C];               // affine: and its F
#pragma unroll
  for (int c = 0; c < C; ++c) BF[c] = kNeg;
  int u_last = 0;          // H(first, j0 - 1): the tile's first DIAG
  if constexpr (kBand) {
    // thread 0's, H(r0 - 1, col0), is the row above's when col0 lies in
    // pcol0 + 1 .. pend (warp 0 waited for it), else 0 (outside the band)
    if (k == 0 && s > 0 && tiles > 0 && pcol0 < col0 && col0 <= pend) {
      u_last = __ldcg(&up_row[col0]);
    }
  }
  if constexpr (kBlock) {
    // column 0: each row's H (and E) starts its LEFT chain; H(first, 0) is
    // the first tile's DIAG, which thread 0 keeps and every other thread
    // receives through the thread above's last-row slots (B), read at the
    // step before its first tile
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (first + r < n) {
        H[r] = __ldg(&ext.left[first + r + 1]);
        if constexpr (kAffine) E[r] = __ldg(&ext.left_e[first + r + 1]);
      }
    }
    if (first <= n) u_last = __ldg(&ext.left[first]);
    const int h_last = first + R <= n ? __ldg(&ext.left[first + R]) : 0;
#pragma unroll
    for (int c = 0; c < C; ++c) B[c] = h_last;
  }
  int flushed = 0;         // the publishing warp: the column stored last step
  [[maybe_unused]] int pa[C];   // kPacked: the codes of tile t - kk
  if constexpr (kPacked) packed_codes<C>(ak, m, -kk, pa);

  for (int t = 0; t < steps; ++t) {
    if (warp == 0 && t % kSteps == 0) {        // thread 0 starts a chunk
      const int c0 = col0 + t * C;             // its first 0-based column
      const int col = c0 + kAhead + lane;      // staged now
      if constexpr (!kPacked) {                // kPacked stages no ring
        if (col < m) ring[col & (kRing - 1)] = (int8_t)a_next;
        a_next = col + kPublish < m ? __ldg(&a[col + kPublish]) : 0;
      }
      if (s > 0 || kBlock) {
        if (t > 0) {
          cur = nxt;
          if constexpr (kAffine) cur_f = nxt_f;
          const int lo = c0 + kPublish + 1;    // the next chunk's first column
          if constexpr (kBand) {
            if (lo <= end) {
              nxt = 0;
              nxt_f = kNeg;
              if (lo <= pend) {
                while (seen < min(c0 + 2 * kPublish, pend)) {
                  seen = load_acquire(wait_on);
                }
                if (lo + lane <= pend) {
                  nxt = __ldcg(&up_row[lo + lane]);
                  if constexpr (kAffine) {
                    nxt_f = __ldcg(&bnd_f[(s - 1) * m1 + lo + lane]);
                  }
                }
              }
            }
          } else if (lo <= m) {
            const int want = min(c0 + 2 * kPublish, m);
            if constexpr (kBlock) {
              const int j = lo + lane;
              if (s > 0) {
                while (seen < want) seen = load_acquire(wait_on);
                nxt = j <= m ? __ldcg(&up_row[j]) : 0;
                if constexpr (kAffine) {
                  nxt_f = j <= m ? __ldcg(&bnd_f[(s - 1) * m1 + j]) : kNeg;
                }
              } else {
                nxt = j <= m ? __ldg(&ext.top[j]) : 0;
                if constexpr (kAffine) {
                  nxt_f = j <= m ? __ldg(&ext.top_f[j]) : kNeg;
                }
              }
            } else {
              while (seen < want) seen = load_acquire(wait_on);
              if constexpr (kDebugH) {
                debug_read<kAffine>(aux, s, m, up_row, bnd_f, lo + lane,
                                    seen, nxt, nxt_f);
              } else {
                nxt = lo + lane <= m ? __ldcg(&up_row[lo + lane]) : 0;
                if constexpr (kAffine) {
                  nxt_f = lo + lane <= m
                              ? __ldcg(&bnd_f[(s - 1) * m1 + lo + lane])
                              : kNeg;
                }
              }
            }
          }
        }
        s_bnd[(t / kSteps) & 1][lane] = cur;
        if constexpr (kAffine) s_bndf[(t / kSteps) & 1][lane] = cur_f;
        __syncwarp();
      }
    }
    // UP: H(first, columns of the tile), the last row of thread k-1 after
    // step t-1; thread 0 takes the row above the stripe (zeros when s == 0,
    // the injected row 0 in the block form); affine, UF: F likewise (NEG
    // when s == 0)
    int U[C];
#pragma unroll
    for (int c = 0; c < C; ++c) U[c] = __shfl_up_sync(kFull, B[c], 1);
    int UF[C];
    if constexpr (kAffine) {
#pragma unroll
      for (int c = 0; c < C; ++c) UF[c] = __shfl_up_sync(kFull, BF[c], 1);
    }
    if (kPacked && kk == 0) {
      // a pair's first thread of the stripe: the row above the stripe (the
      // pair's own, s > 0) or the pair's row 0, whatever thread is above
#pragma unroll
      for (int c = 0; c < C; ++c) {
        U[c] = s > 0 ? s_bnd[(t / kSteps) & 1][(t * C + c) & (kPublish - 1)]
                     : 0;
      }
      if constexpr (kAffine) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          UF[c] = s > 0 ? s_bndf[(t / kSteps) & 1]
                                [(t * C + c) & (kPublish - 1)]
                        : kNeg;
        }
      }
    } else if (lane == 0) {
      if (k > 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) U[c] = s_edge[(t + 1) & 1][warp - 1][c];
        if constexpr (kAffine) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            UF[c] = s_fedge[(t + 1) & 1][warp - 1][c];
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          U[c] = (kBlock || s > 0)
                     ? s_bnd[(t / kSteps) & 1][(t * C + c) & (kPublish - 1)]
                     : 0;
        }
        if constexpr (kAffine) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            UF[c] = (kBlock || s > 0) ? s_bndf[(t / kSteps) & 1]
                                              [(t * C + c) & (kPublish - 1)]
                                      : kNeg;
          }
        }
      }
    }
    const int q = col0 / C + t - kk;           // the tile
    const int j0 = q * C + 1;
    [[maybe_unused]] int hc[R][C];             // kDebugH: the tile's H
    if (kBand ? k < kt && t - k >= 0 && t - k < tiles
              : kk < kt && q >= 0 && j0 <= m) {
      int ac[C];
      if constexpr (kPacked) {
#pragma unroll
        for (int c = 0; c < C; ++c) ac[c] = pa[c];
      } else {
        ring_codes<C>(s_ring, q * C, ac);
      }
      if (j0 + C - 1 < m) {
        if constexpr (kBand) {
          tile_ext<R, C, false, kAffine, kSub, kP, false, false, true>(
              j0, C, ac, code, U, UF, u_last, g, cap, H, E, best, best_j, B,
              BF);
        } else if constexpr (kBlock) {
          if (cap.bottom_warp) {
            tile_ext<R, C, false, kAffine, kSub, kP, kBlock, true>(
                j0, C, ac, code, U, UF, u_last, g, cap, H, E, best, best_j,
                B, BF);
          } else {
            tile_ext<R, C, false, kAffine, kSub, kP, kBlock>(
                j0, C, ac, code, U, UF, u_last, g, cap, H, E, best, best_j,
                B, BF);
          }
        } else if constexpr (kP) {
          tile_ext<R, C, false, kAffine, kSub, kP, kBlock>(
              j0, C, ac, code, U, UF, u_last, g, cap, H, E, best, best_j, B,
              BF);
        } else if constexpr (kDebugH && !kAffine && !kSub) {
          tile<R, C, false, true>(j0, C, ac, code, U, u_last, match,
                                  mismatch, gap, H, best, best_j, B, hc);
        } else if constexpr (kDebugH) {
          tile_gotoh<R, C, false, kAffine, kSub, true>(
              j0, C, ac, code, U, UF, u_last, g, H, E, best, best_j, B, BF,
              hc);
        } else if constexpr (!kAffine && !kSub) {
          tile<R, C, false>(j0, C, ac, code, U, u_last, match, mismatch, gap,
                            H, best, best_j, B);
        } else {
          tile_gotoh<R, C, false, kAffine, kSub>(j0, C, ac, code, U, UF,
                                                 u_last, g, H, E, best,
                                                 best_j, B, BF);
        }
      } else {                                 // the tile holding column m
        const int nc = m - j0 + 1;
        if constexpr (kBand) {
          tile_ext<R, C, true, kAffine, kSub, kP, false, false, true>(
              j0, nc, ac, code, U, UF, u_last, g, cap, H, E, best, best_j, B,
              BF);
        } else if constexpr (kBlock) {
          if (cap.bottom_warp) {
            tile_ext<R, C, true, kAffine, kSub, kP, kBlock, true>(
                j0, nc, ac, code, U, UF, u_last, g, cap, H, E, best, best_j,
                B, BF);
          } else {
            tile_ext<R, C, true, kAffine, kSub, kP, kBlock>(
                j0, nc, ac, code, U, UF, u_last, g, cap, H, E, best, best_j,
                B, BF);
          }
        } else if constexpr (kP) {
          tile_ext<R, C, true, kAffine, kSub, kP, kBlock>(
              j0, nc, ac, code, U, UF, u_last, g, cap, H, E, best, best_j, B,
              BF);
        } else if constexpr (kDebugH && !kAffine && !kSub) {
          tile<R, C, true, true>(j0, nc, ac, code, U, u_last, match,
                                 mismatch, gap, H, best, best_j, B, hc);
        } else if constexpr (kDebugH) {
          tile_gotoh<R, C, true, kAffine, kSub, true>(
              j0, nc, ac, code, U, UF, u_last, g, H, E, best, best_j, B, BF,
              hc);
        } else if constexpr (!kAffine && !kSub) {
          tile<R, C, true>(j0, nc, ac, code, U, u_last, match, mismatch, gap,
                           H, best, best_j, B);
        } else {
          tile_gotoh<R, C, true, kAffine, kSub>(j0, nc, ac, code, U, UF,
                                                u_last, g, H, E, best,
                                                best_j, B, BF);
        }
        if constexpr (!kPairs && !kPacked) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (first + r < n) right[first + r + 1] = H[r];
          }
        }
        if constexpr (kBlock && kAffine) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (first + r < n) ext.right_e[first + r + 1] = E[r];
          }
        }
      }
      if (publish && lane == 31) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (j0 + c <= m) {
            s_pub[(j0 - 1 + c) & (kPublish - 1)] = B[c];
            if constexpr (kAffine) {
              s_pubf[(j0 - 1 + c) & (kPublish - 1)] = BF[c];
            }
          }
        }
      }
    }
    if constexpr (kDebugH) {
      // the step's R x C slots of this thread, a row's C columns a word:
      // the tile's H where the cell lies in the matrix, 0 elsewhere; staged
      // in shared memory (a thread's kQ words a word apart, so a quarter
      // warp's stores hit 8 distinct bank quads) and stored by the warp as
      // 32 * kQ contiguous words, kQ fully coalesced stores a lane
      constexpr int kQ = R * C / 4;
      // after the affine arrays and the profile: T x (kQ + 1) int4
      int4* const s_cap = s_dyn + (kAffine ? f_ints<C>() / 4 : 0) +
                          (kSub ? (g.rows + 1) * (R / 4) * T : 0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int w = 0; w < C / 4; ++w) {
          int v[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int c = 4 * w + x;
            v[x] = kk < kt && q >= 0 && j0 <= m && first + r < n &&
                           j0 + c <= m
                       ? hc[r][c]
                       : 0;
          }
          s_cap[k * (kQ + 1) + r * (C / 4) + w] =
              make_int4(v[0], v[1], v[2], v[3]);
        }
      }
      __syncwarp();
      int4* dst = reinterpret_cast<int4*>(aux.h) +
                  ((size_t)s * (tiles + T - 1) + t) * T * kQ +
                  (size_t)(warp * 32) * kQ;
      const int4* src = s_cap + warp * 32 * (kQ + 1);
#pragma unroll
      for (int x = 0; x < kQ; ++x) {
        const int i = x * 32 + lane;
        dst[i] = src[i / kQ * (kQ + 1) + i % kQ];
      }
    }
    if (publish) {
      // the stripe's last row is thread T - 1's: at the end of a chunk
      // (or at m) its warp stores the chunk, coalesced, and releases it a
      // step later, when the stores have landed and the release's fence
      // holds the block's barrier for no round trip
      if (flushed > 0 && lane == 31) store_release(progress, flushed);
      flushed = 0;
      const int ql = t - (T - 1);
      const int jl = min(col0 + ql * C + C, m);  // its tile's last column
      if (kBand ? ql >= 0 && ql < tiles && (jl % kPublish == 0 || jl == end)
                : ql >= 0 && ql * C < m && (jl % kPublish == 0 || jl == m)) {
        __syncwarp();
        const int col = ((jl - 1) & ~(kPublish - 1)) + 1 + lane;
        if (col <= jl) {
          down_row[col] = s_pub[lane];
          if constexpr (kAffine) bnd_f[s * m1 + col] = s_pubf[lane];
        }
        flushed = jl;
      }
    }
    // kPacked: the next tile's codes, in flight across the barrier
    if constexpr (kPacked) packed_codes<C>(ak, m, t + 1 - kk, pa);
    u_last = U[C - 1];
    if (lane == 31) {
#pragma unroll
      for (int c = 0; c < C; ++c) s_edge[t & 1][warp][c] = B[c];
      if constexpr (kAffine) {
#pragma unroll
        for (int c = 0; c < C; ++c) s_fedge[t & 1][warp][c] = BF[c];
      }
    }
    __syncthreads();
  }
  if constexpr (kBand) {
    // the window's end, or nothing, was stored: release m, past any column
    // the stripe below waits for
    if (publish && lane == 31) store_release(progress, m);
  } else if (flushed > 0 && lane == 31) {
    store_release(progress, flushed);                               // m
  }

  if constexpr (kPacked) {
    // each row's (best, first j), a pair's rows at row_best[gk, :n]; a
    // thread that holds no pair, or a row past n, stores nothing
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (first + r < n) {
        int* o = best_out + 2 * ((size_t)gk * n + first + r);
        o[0] = best[r];
        o[1] = best_j[r];
      }
    }
    return;
  }
  // stripe argmax: score desc, then row asc; j is already the row's first
  int tb = 0, ti = 0, tj = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (first + r < n && best[r] > tb) {
      tb = best[r];
      ti = first + r + 1;
      tj = best_j[r];
    }
  }
  if (tb > 0) atomicMax(&s_best, tb);
  __syncthreads();
  if (tb > 0 && tb == s_best) atomicMin(&s_k, k);
  __syncthreads();
  int* out = best_out + 4 * (size_t)s;
  if (k == s_k) {
    out[0] = tb; out[1] = ti; out[2] = tj; out[3] = 0;
  } else if (k == 0 && s_best == 0) {
    out[0] = out[1] = out[2] = out[3] = 0;
  }
}

// kPairs: n is one pair's rows and the grid aux.pairs x its stripes;
// kShared: a is the one (m,) query of every pair. kPacked: n is one pair's
// rows, T the threads a block (where a stripe holds whole pairs, the
// wrapper's rounding to the warps they need), best row_best (B, n, 2); the
// grid is B x S stripes (S = ceil(n / (T R)) > 1) or ceil(B / (T / tpp))
// (tpp = ceil(n / R), S = 1).
template <int R, int C, bool kAffine, bool kSub, bool kP = false,
          bool kBlock = false, bool kBand = false, bool kDebugH = false,
          bool kPairs = false, bool kShared = false, bool kPacked = false>
int launch(const int8_t* a, const int8_t* b, int m, int n, int match,
           int mismatch, int gap, int open, int extend, const int* sub,
           int A, int T, int* sync, int* bnd, int* bnd_f, int* best,
           int* right, cudaStream_t stream, const Ext& ext = Ext{},
           int band = 0, const Aux& aux_in = Aux{}) {
  constexpr int kTop =
      (kP || kBlock || kBand || kDebugH) ? ext_threads(R) : kMaxThreads;
  if (m < 1 || n < 1 || T < 32 || T > kTop || T % 32 ||
      (long long)n + (long long)T * R > INT_MAX ||
      (long long)m + (long long)T * C > INT_MAX ||
      (kAffine && bnd_f == nullptr) ||
      (kSub && (sub == nullptr || A < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  // kBand: the band's sums (r1 + band, the window's ends and the cell's
  // band test) stay in int
  if (kBand && (band < -1 || (long long)band > (long long)m + n ||
                2LL * ((long long)m + n) + (long long)T * R + kMaxCols >
                    INT_MAX)) {
    return (int)cudaErrorInvalidValue;
  }
  if (kP && (ext.P == nullptr || ext.pitch < m + 1 || ext.pitch % 4 ||
             (uintptr_t)(ext.P + 1) % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  if (kBlock &&
      (ext.top == nullptr || ext.left == nullptr ||
       (kAffine && (ext.top_f == nullptr || ext.left_e == nullptr ||
                    ext.right_e == nullptr ||
                    (ext.bottom != nullptr && ext.bottom_f == nullptr))))) {
    return (int)cudaErrorInvalidValue;
  }
  const int stripes = (n + T * R - 1) / (T * R);
  if (kDebugH && (aux_in.h == nullptr || aux_in.seen == nullptr ||
                  aux_in.skew < 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((kPairs || kPacked) &&
      (aux_in.pairs < 1 || (long long)aux_in.pairs * stripes > INT_MAX ||
       (long long)aux_in.pairs * n > INT_MAX ||
       (!kShared && (long long)aux_in.pairs * m > INT_MAX))) {
    return (int)cudaErrorInvalidValue;
  }
  Aux aux = aux_in;
  aux.stripes = stripes;
  int blocks = kPairs ? aux.pairs * stripes : stripes;
  if (kPacked) {
    // whole pairs a stripe where one pair's rows fit, else S stripes a pair
    const int per = T / ((n + R - 1) / R);
    blocks = stripes > 1 ? aux.pairs * stripes
                         : (per < 1 ? 0 : (aux.pairs + per - 1) / per);
    if (blocks < 1) return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      (kAffine ? f_ints<C>() * sizeof(int) : 0) +
      (kSub ? (size_t)((A < kMaxSym ? A : kMaxSym) + 1) * R * T * sizeof(int)
            : 0) +
      (kDebugH ? (size_t)T * (R * C / 4 + 1) * sizeof(int4) : 0);
  auto* kernel = stripe_rb_kernel<R, C, kAffine, kSub, kP, kBlock, kBand,
                                  kDebugH, kPairs, kShared, kPacked>;
  if (kSub || kDebugH) {
    // above 48 KB of static and dynamic shared memory a block needs an
    // opt-in; the profile alone may pass it
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, T, smem, stream>>>(a, b, m, n, match, mismatch, gap,
                                      sync, bnd, best, right, open, extend,
                                      sub, A, bnd_f, ext, band, aux);
  return (int)cudaGetLastError();
}

}  // namespace

// the tiles of the affine and table forms and of every K4 and K5 form
// (stripe_fill.RB_FORM_TILES, RB_EXT_TILES), the points of chip_smoke.py's
// sweeps; SW_RB_TILE is each source's own
#define SW_RB_GOTOH_TILES(...)                                               \
  SW_RB_TILE(8, 4, __VA_ARGS__)                                              \
  SW_RB_TILE(8, 2, __VA_ARGS__)                                              \
  SW_RB_TILE(4, 4, __VA_ARGS__)
// the capture form's tiles (stripe_fill.RB_DEBUG_TILES): what score() runs
// in every form, (8, 4), and the small tile that gives many hand-offs at
// small shapes
#define SW_RB_DEBUG_TILES(...)                                               \
  SW_RB_TILE(8, 4, __VA_ARGS__)                                              \
  SW_RB_TILE(4, 4, __VA_ARGS__)
