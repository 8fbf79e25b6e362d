// Smith-Waterman stripe fill on Hopper (sm_90a): the kernel template shared
// by the C entries of stripe_fill.cu (K1-K4 and their band mode K4b),
// stripe_block.cu (K5), pairs_fill.cu (the batch modes K8 and K7),
// window_fill.cu (the window mode K6) and sanitize_fill.cu (the debug
// capture K9).
//
// Replaces the Pallas stripe kernel of the JAX package
// (swtpu/kernels/pallas_fill.py, body `_kernel`, launched by `_stripe_call`)
// in these of its modes, one template flag each:
//   * kCaptureP - the `return_p` predecessor capture: one int8 code per cell
//     written straight into a row-major (n+1) x (m+1) P with row 0 and
//     column 0 left NONE;
//   * kAffine - Gotoh affine gaps: E(i,j) = max(H(i,j-1)+open, E(i,j-1)+ext),
//     F(i,j) = max(H(i-1,j)+open, F(i-1,j)+ext), with the E_EXT/F_EXT state
//     bits in P (a tie counts as extension);
//   * kSub - a substitution matrix S[a_code, b_code] in place of the
//     match/mismatch compare;
//   * kBand - cells with |i-j| > band are forced to H = 0 and P = NONE, with
//     E = F = NEG there (the JAX scan's band semantics);
//   * kBlock - boundary injection and the global (Needleman-Wunsch) mode of
//     `stripe_block_fn`: row 0 and column 0 (and affine F of row 0, E of
//     column 0) come from the caller, `local == 0` drops the zero floor, and
//     the block exports E of column m and, on request, H and F of row n;
//   * kPairs - the pair grid of `pairs_score_fn` (K8): B independent pairs
//     of one shape in one launch, each cut into its own stripes (below);
//   * kPacked - the packed pairs of `pairs_packed_score_fn` (K7): the B*n
//     target rows of B pairs back to back in one stripe chain (below);
//   * kWindow - with kPacked, the window mode of `batch_score_fn` (K6): B
//     reads packed in rows against one window that every read shares, so
//     the query stride is 0 (below);
//   * kDebugH - the `debug_h` capture of the sanitizer (K9), on the
//     score-only single-pair and packed-pairs modes (below).
// A flag left off adds nothing to the step loop, so K1's instantiation runs
// the loop it always ran; the flags added after it go last, with defaults.
//
// What bounds it on the card. The fill is a chain of dependent steps: every
// cell needs its left and upper neighbours, so a stripe advances one
// anti-diagonal per step, and each step pays a block barrier and a shared
// memory round trip between warps. P capture adds one byte store per cell;
// stores from neighbouring threads land m+1 bytes apart, so it is bound by
// the bytes of P it writes (about (n+1)(m+1)) as much as by the chain.
//
// What the design does about it. Rows are cut into stripes of T = blockDim.x
// rows, one thread block per stripe and one row per thread (register
// blocking R > 1 is later work). Thread k of stripe s owns row
// i = s*T + k + 1 and visits column j = t - k + 1 at step t. UP and DIAG
// (and, affine, F) come from thread k-1 by a warp shuffle inside a warp and
// through two-slot shared arrays between warps, one __syncthreads() per
// step; E is the thread's own LEFT chain, in a register. Many stripes run
// at once as a wavefront of blocks: stripe s writes its last row's H (and
// F) to global boundary rows and publishes its progress every kPublish
// columns with a release store; stripe s+1's thread 0 waits on that counter
// with acquire loads before it reads H(s*T, j) and F(s*T, j).
//
// Boundary injection follows the JAX scan, not the TPU kernel's layout: a
// thread carries H(i, 0) = left[i] (and E(i, 0) = left_e[i]) until it enters
// the matrix, so its first LEFT read and, through the shuffle, the next
// row's first DIAG read see the injected column; stripe 0's thread 0 reads
// H(0, j) and F(0, j) from top / top_f where it would read the zero row. The
// TPU kernel's -2^24 clamp of top_f / left_e is not carried over: NEG =
// -2^30 plus any penalty cannot wrap int32 at the widths the caller admits.
//
// Substitution mode builds a per-block query profile in shared memory at
// the start, s_prof[q*T + k] = S[q, b_i] for the block's rows (the GPU
// counterpart of `_build_profile`): thread k then reads s_prof[a_j*T + k],
// so a warp's reads hit 32 consecutive banks whatever the codes. Sentinel
// codes (< 0) score NEG_SUB without a table read. The caller refuses codes
// outside [-3, A) and keeps A*T*4 bytes within the opt-in shared memory.
//
// Blocks are scheduled in no order, so a block waiting on one that is not
// resident would hang the card. A block therefore takes its stripe index
// from an atomic ticket (zeroed by the caller for each launch), not from
// blockIdx: the block it waits on took its ticket earlier, is resident,
// and never waits on a later one.
//
// kPairs: the launch holds B pairs x S stripes of blocks. A ticket names a
// (pair, stripe) in pair-major order, so stripe s of a pair takes its
// ticket after stripe s-1 of the same pair and the ticket argument above
// still holds. (Stripe-major order was measured no faster: PERF.md.) The block then moves a, b,
// the progress counters, the boundary rows, the stripe bests and the right
// column to its pair's slice and runs the single-pair body unchanged.
//
// kPacked: n is the B*rows packed target rows; thread k owns global row
// i = s*T + k + 1, which is local row (i-1) % rows + 1 of pair
// g = (i-1) / rows, and reads its query from a + g*m (the GPU form of the
// TPU kernel's per-pair stream injection: the column at step t is still
// t - k + 1). A pair's first row is a reset row: UP = DIAG = 0 and
// F = NEG, the pair's own zero row 0, so a stripe whose thread 0 sits on
// one waits on no earlier stripe. Each thread exports its row's
// (best, first column) and the caller reduces per pair.
//
// kWindow: kPacked with a = the window (m columns) shared by every row:
// no row moves its query pointer. A read's first row is a reset row as a
// pair's is, and the caller reduces the row bests per read.
//
// kDebugH: after every step each thread stores its H (h_new: the cell's H
// in the matrix, the carried 0 outside it) to slot (s, t, k) of a
// (stripes, m + T - 1, T) int32 buffer; slot (s, t, k) is cell
// (s*T + k + 1, t - k + 1), and the last stripe's steps past its own
// m + rows - 1 are never scheduled, so they keep the caller's sentinel.
// At every read of the boundary row thread 0 of stripe s stores the
// progress it saw to seen[s, j], so a checker can prove that each read
// followed the producer's release of column j. dbg.skew > 0 is the
// checker's test hook: the consumer then waits for and reads column
// j - skew (0, and F = NEG, for j <= skew), published but wrong.
// Production instantiations carry none of this code.
//
// Edges are masked explicitly (rows > n, columns outside 1..m); nothing
// relies on the penalties decaying garbage cells. The argmax keeps the
// reference's first row-major occurrence of a positive max: each thread
// keeps (best, j) for its row under a strict '>' while j ascends, the block
// takes the smallest row among the threads holding its max, and the caller
// reduces the stripes, the first stripe holding the global max winning. In
// global mode only positive cells count, as in the scan; the caller uses
// the max only when it is positive (the anchored-reverse contract).
//
// Each C entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after its launch.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// an unnamed namespace: each source that includes this header keeps its
// own instantiations, so nothing clashes when the objects are linked
namespace {

constexpr int kNone = 0, kUp = 1, kLeft = 2, kDiagonal = 3;
constexpr int kEExt = 4, kFExt = 8;     // Gotoh state bits of affine P
constexpr int kNeg = -(1 << 30);        // affine minus infinity
constexpr int kNegSub = -(1 << 20);     // a sentinel code's score
constexpr int kNoBand = INT_MIN;        // the band argument of "no band"
constexpr int kPublish = 32;     // columns between progress publications
constexpr int kMaxThreads = 1024;
constexpr int kStaticSmemMax = 48 * 1024;

// The scoring model. Linear: match/mismatch and gap. Affine: open/extend
// replace gap. Substitution: sub (A x A, row-major S[a_code, b_code])
// replaces match/mismatch. band: the half-width, read only when kBand.
struct Model {
  int match, mismatch, gap, open, extend;
  const int* sub;
  int A;
  int band;
};

// The injected boundaries and extra exports of kBlock mode.
// top: (m+1) H(0, :); left: (n+1) H(:, 0), both holding the corner H(0, 0).
// top_f: (m+1) F(0, :), left_e: (n+1) E(:, 0), affine only.
// right_e: (n+1) E(:, m), affine only; right_e[0] is left to the caller.
// bottom / bottom_f: (m+1) H(n, :) and F(n, :), or null; [0] left to the
// caller. local: 0 runs the global recurrence.
struct Block {
  const int* top;
  const int* left;
  const int* top_f;
  const int* left_e;
  int* right_e;
  int* bottom;
  int* bottom_f;
  int local;
};

// The batch modes' geometry. kPairs: pairs B and stripes S per pair,
// tickets handed out pair by pair. kPacked: rows, the target rows of one
// pair (n is then B * rows), and row_best, (n, 2) int32, each row's (best,
// first column holding it).
struct Batch {
  int pairs;
  int stripes;
  int rows;
  int* row_best;
};

// The kDebugH capture: h, (stripes, m + T - 1, T) int32 H of every slot;
// seen, (stripes, m + 1) int32 progress seen at each boundary read; skew,
// the hand-off test hook (0 in a sanitizer run).
struct Debug {
  int* h;
  int* seen;
  int skew;
};

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

// sync:  [0] the stripe ticket, [1 + s] the last column stripe s published.
// bnd:   (stripes - 1) x (m + 1) int32, row s = H(s*T + T, :).
// bnd_f: the same for F, only when kAffine.
// best:  (stripes, 4) int32, row s = (score, i, j, 0) of the stripe's first
//        max, or zeros when the stripe holds no positive cell.
// right: (n + 1) int32, right[i] = H(i, m); right[0] is left to the caller.
// P:     (n + 1) x (m + 1) int8 row-major, only when kCaptureP.
// blk:   kBlock's boundaries and exports; last, so that the other
//        parameters keep the offsets (and K1 the code) they had before
//        the block mode was added.
// bt:    the batch modes' geometry, after blk for the same reason.
// kPairs: sync, bnd, bnd_f, best and right hold one slice per pair, in
//        pair order: 1 + B*S counters after the ticket, B*(S-1) boundary
//        rows, B*S bests, B*(n+1) right columns.
// kPacked: the per-stripe bests are not written; bt.row_best is.
// dbg:   the kDebugH capture, after bt for the same reason.
template <bool kCaptureP, bool kAffine, bool kSub, bool kBand, bool kBlock,
          bool kPairs = false, bool kPacked = false, bool kWindow = false,
          bool kDebugH = false>
__global__ void __launch_bounds__(kMaxThreads)
stripe_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
              int m, int n, Model sc, int* __restrict__ sync,
              int* __restrict__ bnd, int* __restrict__ bnd_f,
              int* __restrict__ best_out, int* __restrict__ right,
              int8_t* __restrict__ P, Block blk, Batch bt, Debug dbg) {
  static_assert(!(kCaptureP && kBlock), "block mode captures no P");
  static_assert(!(kBand && kBlock), "block mode takes no band");
  static_assert(!((kPairs || kPacked) && (kCaptureP || kBlock)),
                "the batch modes capture no P and inject no boundary");
  static_assert(!(kPairs && kPacked), "one batch mode at a time");
  static_assert(!(kPacked && kBand), "packed pairs take no band");
  static_assert(!kWindow || kPacked, "the window mode is a packed mode");
  static_assert(!kDebugH || !(kCaptureP || kBand || kBlock || kPairs ||
                              kWindow),
                "the debug capture serves the score-only single-pair and "
                "packed-pairs modes only");
  __shared__ int s_stripe, s_best, s_k;
  __shared__ int s_edge[2][kMaxThreads / 32];  // last lane of each warp: H
  __shared__ int s_fedge[2][kAffine ? kMaxThreads / 32 : 1];   // and F
  extern __shared__ int s_prof[];              // kSub: A x T query profile

  const int k = threadIdx.x;
  const int T = blockDim.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  if (k == 0) {
    s_stripe = atomicAdd(&sync[0], 1);
    s_best = 0;
    s_k = T;
  }
  if (k < kMaxThreads / 32) s_edge[0][k] = s_edge[1][k] = 0;
  if constexpr (kAffine) {
    if (k < kMaxThreads / 32) s_fedge[0][k] = s_fedge[1][k] = kNeg;
  }
  __syncthreads();

  int s = s_stripe;
  if constexpr (kPairs) {
    const int S = bt.stripes;
    const int g = s / S;   // pair-major: a pair's stripes take consecutive
    s -= g * S;            // tickets, so a block waits only on earlier ones
    a += (size_t)g * m;
    b += (size_t)g * n;
    sync += (size_t)g * S;
    bnd += (size_t)g * (S - 1) * ((size_t)m + 1);
    if constexpr (kAffine) bnd_f += (size_t)g * (S - 1) * ((size_t)m + 1);
    best_out += (size_t)g * S * 4;
    right += (size_t)g * ((size_t)n + 1);
  }
  const int i = s * T + k + 1;
  const bool row_ok = i <= n;
  bool reset = false;   // kPacked: row i is its pair's first
  if constexpr (kPacked) {
    if (row_ok) {
      const int g = (i - 1) / bt.rows;
      if constexpr (!kWindow) a += (size_t)g * m;   // its pair's query
      reset = i - 1 == g * bt.rows;
    }
  }
  const int bi = row_ok ? b[i - 1] : -1;
  if constexpr (kSub) {
    // only thread k reads column k of the profile, so no barrier is needed
    if (bi >= 0) {
      for (int q = 0; q < sc.A; ++q) {
        s_prof[q * T + k] = __ldg(&sc.sub[q * sc.A + bi]);
      }
    }
  }
  const int rows = min(T, n - s * T);
  const int steps = m + rows - 1;
  const size_t m1 = (size_t)m + 1;
  const size_t up_off = s > 0 ? (size_t)(s - 1) * m1 : 0;
  const size_t down_off = (size_t)s * m1;           // written if publish
  int* progress = sync + 1 + s;
  const int* wait_on = sync + s;                    // stripe s-1's counter
  const bool publish = k == T - 1 && (size_t)(s + 1) * T < (size_t)n;

  // the row's H and E in column 0, carried until the thread enters the
  // matrix and again outside the band
  int h_out = 0, e_out = kNeg;
  bool local = true;
  if constexpr (kBlock) {
    local = blk.local != 0;
    if (row_ok) {
      h_out = __ldg(&blk.left[i]);
      if constexpr (kAffine) e_out = __ldg(&blk.left_e[i]);
    }
  }
  // declared in the order the loop was first written in: a change of order
  // changes K1's register allocation and, measurably, its time
  int h = h_out;    // H(i, j) after this step: the next step's LEFT
  int up_prev = 0;  // this step's UP: the next step's DIAG; first H(i-1, 0)
  if constexpr (kBlock) {
    if (i - 1 <= n) up_prev = __ldg(i == 1 ? &blk.top[0] : &blk.left[i - 1]);
  }
  int e = e_out;    // affine: E(i, j) after this step, the LEFT chain
  int f = kNeg;     // affine: F(i, j) after this step, read by thread k+1
  int best = 0, best_j = 0;
  int seen = 0;     // thread 0: stripe s-1's progress seen so far

  for (int t = 0; t < steps; ++t) {
    const int j = t - k + 1;
    // UP: H(i-1, j) is thread k-1's H after step t-1 (F likewise)
    int up_in = __shfl_up_sync(0xffffffffu, h, 1);
    int f_up = kNeg;
    if constexpr (kAffine) f_up = __shfl_up_sync(0xffffffffu, f, 1);
    if (lane == 0) {
      if (k == 0) {
        up_in = 0;                          // stripe 0 reads the zero row
        f_up = kNeg;                        // and F(0, j) = NEG
        if constexpr (kBlock) {
          if (s == 0 && j <= m) {           // or the injected row 0
            up_in = __ldg(&blk.top[j]);
            if constexpr (kAffine) f_up = __ldg(&blk.top_f[j]);
          }
        }
        if (s > 0 && j <= m && !(kPacked && reset)) {
          int jr = j;                       // jr == j but in the test hook
          if constexpr (kDebugH) jr -= dbg.skew;
          while (seen < jr) seen = load_acquire(wait_on);
          if constexpr (kDebugH) dbg.seen[(size_t)s * m1 + j] = seen;
          up_in = (!kDebugH || jr >= 1) ? __ldcg(&bnd[up_off + jr]) : 0;
          if constexpr (kAffine) {
            f_up = (!kDebugH || jr >= 1) ? __ldcg(&bnd_f[up_off + jr]) : kNeg;
          }
        }
      } else {
        up_in = s_edge[(t + 1) & 1][warp - 1];   // written at step t-1
        if constexpr (kAffine) f_up = s_fedge[(t + 1) & 1][warp - 1];
      }
    }
    if constexpr (kPacked) {
      if (reset) {                          // the pair's zero row 0
        up_in = 0;
        f_up = kNeg;
      }
    }

    int h_new = h_out;
    int f_new = kNeg;
    if (row_ok && j >= 1 && j <= m) {
      bool in_band = true;
      if constexpr (kBand) in_band = abs(i - j) <= sc.band;
      if (in_band) {
        const int aj = __ldg(&a[j - 1]);
        int sub;
        if constexpr (kSub) {
          sub = (aj < 0 || bi < 0) ? kNegSub : s_prof[aj * T + k];
        } else {
          sub = aj == bi ? sc.match : sc.mismatch;
        }
        const int diag = up_prev + sub;
        int up, left;
        int e_new = kNeg;
        if constexpr (kAffine) {
          e_new = max(h + sc.open, e + sc.extend);
          f_new = max(up_in + sc.open, f_up + sc.extend);
          up = f_new;
          left = e_new;
        } else {
          up = up_in + sc.gap;
          left = h + sc.gap;
        }
        if constexpr (kCaptureP) {
          // reference tie order: DIAG > UP > LEFT > staying at 0/NONE
          int code = kNone;
          h_new = 0;
          if (diag > h_new) { h_new = diag; code = kDiagonal; }
          if (up > h_new) { h_new = up; code = kUp; }
          if (left > h_new) { h_new = left; code = kLeft; }
          if constexpr (kAffine) {
            if (e_new == e + sc.extend) code += kEExt;
            if (f_new == f_up + sc.extend) code += kFExt;
          }
          P[(size_t)i * m1 + j] = (int8_t)code;
        } else if (local) {
          h_new = max(max(diag, up), max(left, 0));
        } else {
          h_new = max(max(diag, up), left);
        }
        if constexpr (kAffine) e = e_new;
      } else if constexpr (kAffine) {
        e = e_out;                          // outside the band: E = NEG
      }
      if (h_new > best) { best = h_new; best_j = j; }
      if (j == m) {
        right[i] = h_new;
        if constexpr (kBlock && kAffine) blk.right_e[i] = e;
      }
      if constexpr (kBlock) {
        if (blk.bottom != nullptr && i == n) {
          blk.bottom[j] = h_new;
          if constexpr (kAffine) blk.bottom_f[j] = f_new;
        }
      }
      if (publish) {
        bnd[down_off + j] = h_new;
        if constexpr (kAffine) bnd_f[down_off + j] = f_new;
        if (j % kPublish == 0 || j == m) store_release(progress, j);
      }
    }
    h = h_new;
    if constexpr (kDebugH) {
      dbg.h[((size_t)s * (m + T - 1) + t) * T + k] = h_new;
    }
    up_prev = up_in;
    if constexpr (kAffine) f = f_new;
    if (lane == 31) {
      s_edge[t & 1][warp] = h;
      if constexpr (kAffine) s_fedge[t & 1][warp] = f;
    }
    __syncthreads();
  }

  if constexpr (kPacked) {
    if (row_ok) {
      bt.row_best[2 * (size_t)(i - 1)] = best;
      bt.row_best[2 * (size_t)(i - 1) + 1] = best_j;
    }
    return;
  }
  // stripe argmax: score desc, then row asc; j is already the row's first
  if (best > 0) atomicMax(&s_best, best);
  __syncthreads();
  if (best > 0 && best == s_best) atomicMin(&s_k, k);
  __syncthreads();
  int* out = best_out + 4 * (size_t)s;
  if (k == s_k) {
    out[0] = best; out[1] = i; out[2] = best_j; out[3] = 0;
  } else if (k == 0 && s_best == 0) {
    out[0] = out[1] = out[2] = out[3] = 0;
  }
}

// kPairs: n is one pair's rows and the grid is bt.pairs x the pair's
// stripes; kPacked: n is all B * bt.rows rows.
template <bool kCaptureP, bool kAffine, bool kSub, bool kBand = false,
          bool kBlock = false, bool kPairs = false, bool kPacked = false,
          bool kWindow = false, bool kDebugH = false>
int launch(const int8_t* a, const int8_t* b, int m, int n, const Model& sc,
           const Block& blk, int T, int* sync, int* bnd, int* bnd_f,
           int* best, int* right, int8_t* P, cudaStream_t stream,
           const Batch& bt = Batch{}, const Debug& dbg = Debug{}) {
  if (m < 1 || n < 1 || T < 32 || T > kMaxThreads || T % 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (kDebugH && (dbg.h == nullptr || dbg.seen == nullptr || dbg.skew < 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int stripes = (n + T - 1) / T;
  if (kPairs && (bt.pairs < 1 || bt.stripes != stripes ||
                 (long long)bt.pairs * stripes > INT_MAX)) {
    return (int)cudaErrorInvalidValue;
  }
  if (kPacked && (bt.rows < 1 || n % bt.rows || bt.row_best == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (kSub && (sc.sub == nullptr || sc.A < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (kBlock && (blk.top == nullptr || blk.left == nullptr ||
                 (kAffine && (blk.top_f == nullptr || blk.left_e == nullptr ||
                              blk.right_e == nullptr ||
                              (blk.bottom != nullptr &&
                               blk.bottom_f == nullptr))))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = kSub ? (size_t)sc.A * T * sizeof(int) : 0;
  auto* kernel = stripe_kernel<kCaptureP, kAffine, kSub, kBand, kBlock,
                               kPairs, kPacked, kWindow, kDebugH>;
  if (smem > (size_t)kStaticSmemMax) {
    // above 48 KB a block's dynamic shared memory needs an opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = kPairs ? bt.pairs * stripes : stripes;
  kernel<<<blocks, T, smem, stream>>>(a, b, m, n, sc, sync, bnd, bnd_f,
                                      best, right, P, blk, bt, dbg);
  return (int)cudaGetLastError();
}

}  // namespace
