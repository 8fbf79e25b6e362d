// The register-blocked single-pair stripe, K1-K3 redesigned for Hopper: the
// local score-only fill of a (m,) against b (n,): each stripe's first
// row-major max (reduced by the caller), the right column H[:, m] and,
// through it, H[n, m]. Three forms, one template: linear match/mismatch
// (K1), affine match/mismatch (K2, Gotoh E and F) and a substitution table
// with linear or affine gaps (K3).
//
// Replaces, with no band, the Pallas kernel of the JAX package in its
// local single-pair score-only mode (swtpu/kernels/pallas_fill.py
// `stripe_score_fn` :1249 and `stripe_fill_raw` :1072 -> `_stripe_call`
// -> pallas_call :1008; affine :456-463, :529-536, :576-587; the table
// :364-379, :437-524 and `_profile_on_device` :1437), which the stripe
// template's K1-K3 (stripe_fill.cu, `sw_stripe_score_{linear,affine,sub}`)
// served before. It serves `score()`, `align(traceback=False)` and the
// lean traceback's forward pass.
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
// table's score is a shared-memory load a cell.
//
// What the design does about it.
//   * A tile of R rows x C columns a thread a step (template parameters:
//     linear the default (8, 4), set by chip_smoke.py's sweep, and its
//     neighbours (4, 4), (16, 4), (8, 1), (8, 2) and (8, 8); affine and
//     table (8, 4), (8, 2) and (4, 4)); T * R rows a stripe. Thread k of
//     stripe s owns rows s*T*R + k*R + 1 .. + R and visits the tile of
//     columns (t - k) * C + 1 .. + C at step t, in registers. The barrier,
//     the shuffles and the shared hops are paid once per R x C cells, and
//     the launch runs about m / C + n / R + stripes x (hand-off lag)
//     steps instead of n + m. Inside a tile cell (r, c) needs (r - 1, c)
//     and (r, c - 1) only, so the R + C - 1 anti-diagonals give the warp
//     independent instructions to issue.
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
//   * The affine and table forms keep their extra arrays in dynamic shared
//     memory and their extra parameters last, so the linear form's code
//     is what it was before they were added (scripts/torch_sass_diff.py).
//
// Each entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after its launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "sw_cell.cuh"

namespace {

using swcell::kNeg;
using swcell::kNegSub;

constexpr int kPublish = 32;       // columns between publications: a chunk
constexpr int kMaxThreads = 512;   // registers: R = 16 needs about 110
constexpr int kMaxCols = 8;
constexpr int kAhead = 64;         // columns of a staged ahead of thread 0
// the ring spans the columns of a step (T * C), the staged ones and a chunk
constexpr int kRing = 8192;
static_assert(kRing > kMaxThreads * kMaxCols + kAhead + kPublish, "ring");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSym = 128;       // profile rows: no int8 code reaches more

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
template <int R, int C, bool kPartial>
__device__ __forceinline__ void tile(int j0, int nc, const int (&ac)[C],
                                     const int (&code)[R], const int (&U)[C],
                                     int diag0, int match, int mismatch,
                                     int gap, int (&H)[R], int (&best)[R],
                                     int (&best_j)[R], int (&B)[C]) {
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

// one tile of the affine or table form, as `tile`; affine, E[r] is
// E(row r, j0 - 1) in and E of the tile's last column out, UF F of the row
// above in the tile's columns, and BF gets the last row's F
template <int R, int C, bool kPartial, bool kAffine, bool kSub>
__device__ __forceinline__ void tile_gotoh(
    int j0, int nc, const int (&ac)[C], const int (&code)[R],
    const int (&U)[C], const int (&UF)[C], int diag0, const Gotoh& g,
    int (&H)[R], int (&E)[R], int (&best)[R], int (&best_j)[R],
    int (&B)[C], int (&BF)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (kPartial && c >= nc) break;
    int diag = c == 0 ? diag0 : U[c - 1];
    int up = U[c];
    int f = kNeg;
    if constexpr (kAffine) f = UF[c];
    int s[R];
    if constexpr (kSub) {
      const int4* p = g.prof + min(ac[c], g.rows) * (R / 4) * g.T;
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
        s[r] = swcell::compare(ac[c], code[r], g.match, g.mismatch);
      }
    }
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
      diag = left;
      up = h;
      H[r] = h;
    }
    B[c] = H[R - 1];
    if constexpr (kAffine) BF[c] = f;
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
template <int R, int C, bool kAffine, bool kSub>
__global__ void __launch_bounds__(kMaxThreads)
stripe_rb_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int m, int n, int match, int mismatch, int gap,
                 int* __restrict__ sync, int* __restrict__ bnd,
                 int* __restrict__ best_out, int* __restrict__ right,
                 int open, int extend, const int* __restrict__ sub, int A,
                 int* __restrict__ bnd_f) {
  static_assert(kPublish % C == 0 && C <= kMaxCols, "C divides a chunk");
  static_assert(!kSub || R % 4 == 0, "the profile holds 4 rows an int4");
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
  for (int c = k; c < kAhead && c < m; c += T) ring[c] = a[c];
  __syncthreads();

  const int s = s_stripe;
  const int first = s * T * R + k * R;     // rows first + 1 .. first + R
  const int kt = (min(T * R, n - s * T * R) + R - 1) / R;  // threads with rows
  const int tiles = (m + C - 1) / C;
  const int steps = tiles + kt - 1;
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
  if (warp == 0 && s > 0) {
    while (seen < min(kPublish, m)) seen = load_acquire(wait_on);
    cur = lane + 1 <= m ? __ldcg(&up_row[lane + 1]) : 0;
    if constexpr (kAffine) {
      cur_f = lane + 1 <= m ? __ldcg(&bnd_f[(s - 1) * m1 + lane + 1]) : kNeg;
    }
    if (m > kPublish) {
      while (seen < min(2 * kPublish, m)) seen = load_acquire(wait_on);
      nxt = kPublish + lane + 1 <= m ? __ldcg(&up_row[kPublish + lane + 1])
                                     : 0;
      if constexpr (kAffine) {
        nxt_f = kPublish + lane + 1 <= m
                    ? __ldcg(&bnd_f[(s - 1) * m1 + kPublish + lane + 1])
                    : kNeg;
      }
    }
  }
  // warp 0: the 32 columns of a that the ring takes next
  int a_next = (warp == 0 && kAhead + lane < m) ? __ldg(&a[kAhead + lane]) : 0;

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
  int flushed = 0;         // the publishing warp: the column stored last step

  for (int t = 0; t < steps; ++t) {
    if (warp == 0 && t % kSteps == 0) {        // thread 0 starts a chunk
      const int c0 = t * C;                    // its first 0-based column
      const int col = c0 + kAhead + lane;      // staged now
      if (col < m) ring[col & (kRing - 1)] = (int8_t)a_next;
      a_next = col + kPublish < m ? __ldg(&a[col + kPublish]) : 0;
      if (s > 0) {
        if (t > 0) {
          cur = nxt;
          if constexpr (kAffine) cur_f = nxt_f;
          const int lo = c0 + kPublish + 1;    // the next chunk's first column
          if (lo <= m) {
            const int want = min(c0 + 2 * kPublish, m);
            while (seen < want) seen = load_acquire(wait_on);
            nxt = lo + lane <= m ? __ldcg(&up_row[lo + lane]) : 0;
            if constexpr (kAffine) {
              nxt_f = lo + lane <= m ? __ldcg(&bnd_f[(s - 1) * m1 + lo + lane])
                                     : kNeg;
            }
          }
        }
        s_bnd[(t / kSteps) & 1][lane] = cur;
        if constexpr (kAffine) s_bndf[(t / kSteps) & 1][lane] = cur_f;
        __syncwarp();
      }
    }
    // UP: H(first, columns of the tile), the last row of thread k-1 after
    // step t-1; thread 0 takes the row above the stripe (zeros when s == 0);
    // affine, UF: F likewise (NEG when s == 0)
    int U[C];
#pragma unroll
    for (int c = 0; c < C; ++c) U[c] = __shfl_up_sync(kFull, B[c], 1);
    int UF[C];
    if constexpr (kAffine) {
#pragma unroll
      for (int c = 0; c < C; ++c) UF[c] = __shfl_up_sync(kFull, BF[c], 1);
    }
    if (lane == 0) {
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
      }
    }
    const int q = t - k;                       // the tile
    const int j0 = q * C + 1;
    if (k < kt && q >= 0 && j0 <= m) {
      int ac[C];
      ring_codes<C>(s_ring, q * C, ac);
      if (j0 + C - 1 < m) {
        if constexpr (!kAffine && !kSub) {
          tile<R, C, false>(j0, C, ac, code, U, u_last, match, mismatch, gap,
                            H, best, best_j, B);
        } else {
          tile_gotoh<R, C, false, kAffine, kSub>(j0, C, ac, code, U, UF,
                                                 u_last, g, H, E, best,
                                                 best_j, B, BF);
        }
      } else {                                 // the tile holding column m
        const int nc = m - j0 + 1;
        if constexpr (!kAffine && !kSub) {
          tile<R, C, true>(j0, nc, ac, code, U, u_last, match, mismatch, gap,
                           H, best, best_j, B);
        } else {
          tile_gotoh<R, C, true, kAffine, kSub>(j0, nc, ac, code, U, UF,
                                                u_last, g, H, E, best,
                                                best_j, B, BF);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (first + r < n) right[first + r + 1] = H[r];
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
    if (publish) {
      // the stripe's last row is thread T - 1's: at the end of a chunk
      // (or at m) its warp stores the chunk, coalesced, and releases it a
      // step later, when the stores have landed and the release's fence
      // holds the block's barrier for no round trip
      if (flushed > 0 && lane == 31) store_release(progress, flushed);
      flushed = 0;
      const int ql = t - (T - 1);
      const int jl = min(ql * C + C, m);       // its tile's last column
      if (ql >= 0 && ql * C < m && (jl % kPublish == 0 || jl == m)) {
        __syncwarp();
        const int col = ((jl - 1) & ~(kPublish - 1)) + 1 + lane;
        if (col <= jl) {
          down_row[col] = s_pub[lane];
          if constexpr (kAffine) bnd_f[s * m1 + col] = s_pubf[lane];
        }
        flushed = jl;
      }
    }
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
  if (flushed > 0 && lane == 31) store_release(progress, flushed);   // m

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

template <int R, int C, bool kAffine, bool kSub>
int launch(const int8_t* a, const int8_t* b, int m, int n, int match,
           int mismatch, int gap, int open, int extend, const int* sub,
           int A, int T, int* sync, int* bnd, int* bnd_f, int* best,
           int* right, cudaStream_t stream) {
  if (m < 1 || n < 1 || T < 32 || T > kMaxThreads || T % 32 ||
      (long long)n + (long long)T * R > INT_MAX ||
      (long long)m + (long long)T * C > INT_MAX ||
      (kAffine && bnd_f == nullptr) ||
      (kSub && (sub == nullptr || A < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const int stripes = (n + T * R - 1) / (T * R);
  const size_t smem =
      (kAffine ? f_ints<C>() * sizeof(int) : 0) +
      (kSub ? (size_t)((A < kMaxSym ? A : kMaxSym) + 1) * R * T * sizeof(int)
            : 0);
  auto* kernel = stripe_rb_kernel<R, C, kAffine, kSub>;
  if (kSub) {
    // above 48 KB of static and dynamic shared memory a block needs an
    // opt-in; the profile alone may pass it
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<stripes, T, smem, stream>>>(a, b, m, n, match, mismatch, gap,
                                       sync, bnd, best, right, open, extend,
                                       sub, A, bnd_f);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (m,) int8; b: (n,) int8; T threads a block (a multiple of 32 up to
// 512), R rows and C columns a thread a step, (R, C) one of the
// instantiated tiles below (stripe_fill.RB_TILES). sync: 1 + S int32,
// zeroed, S = ceil(n / (T * R)); bnd: S - 1 rows of m + 1 int32 (at least
// one); best: (S, 4) int32; right: n + 1 int32.
extern "C" int sw_stripe_rb_linear(const int8_t* a, const int8_t* b, int m,
                                   int n, int match, int mismatch, int gap,
                                   int T, int R, int C, int* sync, int* bnd,
                                   int* best, int* right,
                                   cudaStream_t stream) {
#define SW_RB_TILE(R_, C_)                                                   \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, false, false>(a, b, m, n, match, mismatch, gap, 0, \
                                        0, nullptr, 0, T, sync, bnd, nullptr, \
                                        best, right, stream);                \
  }
  // the default (8, 4) and its neighbours in R and in C: the points of
  // chip_smoke.py's sweep
  SW_RB_TILE(8, 4)
  SW_RB_TILE(4, 4)
  SW_RB_TILE(16, 4)
  SW_RB_TILE(8, 1)
  SW_RB_TILE(8, 2)
  SW_RB_TILE(8, 8)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// the tiles of the affine and table forms (stripe_fill.RB_FORM_TILES),
// the points of chip_smoke.py's sweep
#define SW_RB_GOTOH_TILES(AFF, SUB)                                          \
  SW_RB_TILE(8, 4, AFF, SUB)                                                 \
  SW_RB_TILE(8, 2, AFF, SUB)                                                 \
  SW_RB_TILE(4, 4, AFF, SUB)

// as sw_stripe_rb_linear, with gap_open/gap_extend for gap; bnd_f: as bnd
extern "C" int sw_stripe_rb_affine(const int8_t* a, const int8_t* b, int m,
                                   int n, int match, int mismatch,
                                   int gap_open, int gap_extend, int T, int R,
                                   int C, int* sync, int* bnd, int* bnd_f,
                                   int* best, int* right,
                                   cudaStream_t stream) {
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB>(a, b, m, n, match, mismatch, 0,          \
                                    gap_open, gap_extend, nullptr, 0, T,     \
                                    sync, bnd, bnd_f, best, right, stream);  \
  }
  SW_RB_GOTOH_TILES(true, false)
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}

// sub: (A, A) int32 row-major on the device, S[a code, b code], codes in
// [-3, A); affine != 0 takes gap_open/gap_extend and bnd_f (as bnd),
// affine == 0 gap (bnd_f unread)
extern "C" int sw_stripe_rb_sub(const int8_t* a, const int8_t* b, int m,
                                int n, const int* sub, int A, int affine,
                                int gap, int gap_open, int gap_extend, int T,
                                int R, int C, int* sync, int* bnd,
                                int* bnd_f, int* best, int* right,
                                cudaStream_t stream) {
#define SW_RB_TILE(R_, C_, AFF, SUB)                                         \
  if (R == R_ && C == C_) {                                                  \
    return launch<R_, C_, AFF, SUB>(a, b, m, n, 0, 0, gap, gap_open,         \
                                    gap_extend, sub, A, T, sync, bnd, bnd_f, \
                                    best, right, stream);                    \
  }
  if (affine) {
    SW_RB_GOTOH_TILES(true, true)
  } else {
    SW_RB_GOTOH_TILES(false, true)
  }
#undef SW_RB_TILE
  return (int)cudaErrorInvalidValue;
}
#undef SW_RB_GOTOH_TILES
