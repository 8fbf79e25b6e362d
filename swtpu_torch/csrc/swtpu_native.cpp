// Native host tiers of swtpu_torch: the serial fill, the walk of P and the
// striped SIMD score-only fills, built with g++ for the host CPU at first
// use (kernels/_native.py) and bound with ctypes (runtime_native.py).
//
// The port's own copy of what these tiers need from the JAX package's
// csrc/swtpu_native.cpp: sw_traceback, sw_fill, the striped scorer
// sw_score_striped behind sw_score_simd and sw_score_simd_pos,
// sw_score_simd_batch, the inter-sequence group sw_swipe_group and
// sw_score_simd_batch1. Left out: sw_alignment (it renders code -1 as a
// gap; the port renders strings with core/oracle.alignment_strings), the
// encoders and the FASTA/FASTQ readers (core/seqfile.py).
//
// Every fill compares raw codes in match/mismatch mode, so an unknown base
// (-1) matches another unknown base, as the oracle and the CUDA kernels
// score it; with a table, the serial fill needs codes in [0, nsym) and the
// SIMD fills score any code outside [0, nsym) as a strong mismatch.
//
// A plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>
#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// The threads an OpenMP region of the batch scorers would use here: 1 in a
// build without OpenMP.
int sw_omp_max_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Walk the predecessor matrix from max_pos; path indices written end-first.
// Mirrors the do-while semantics: the start cell (whose own predecessor is
// NONE) terminates the walk and is included. Returns path length, or ~steps
// on a malformed matrix (cycle guard).
long sw_traceback(const int8_t* P, long n1, long m1, long max_pos,
                  long* path, long cap) {
  const long total = n1 * m1;
  long pos = max_pos;
  long len = 0;
  while (len < cap) {
    if (pos < 0 || pos >= total) return ~len;
    path[len++] = pos;
    int8_t code = P[pos];
    long pred;
    if (code == 3) pred = pos - m1 - 1;        // DIAGONAL
    else if (code == 1) pred = pos - m1;       // UP
    else if (code == 2) pred = pos - 1;        // LEFT
    else break;                                 // NONE at the start cell
    if (pred < 0 || pred >= total) return ~len;
    if (P[pred] == 0) break;
    pos = pred;
  }
  return len;
}

// Serial DP fill, the host tier of align() for small pairs, where a card's
// launch, sync and fetch cost more than the whole fill. Exact oracle
// semantics: tie order
// DIAGONAL(3) > UP(1) > LEFT(2) > NONE(0) via strict '>' chains, zero
// floor, maxpos = FIRST row-major occurrence of the max (strict '>').
// affine != 0 adds Gotoh E/F lanes (gap_open/gap_extend; linear mode reads
// the gap penalty from gap_open) and ORs the E_EXT(4)/F_EXT(8)
// tie-prefers-extension state bits into P, matching the oracle's affine
// traceback contract (core/oracle.py). sub: optional nsym x nsym
// row-major table s(a_code, b_code) replacing the match/mismatch compare;
// caller guarantees codes in [0, nsym). H: (n+1)*(m+1) int32, P same in int8,
// both fully written here. Returns the max score; *out_maxpos gets the
// padded row-major index.
int32_t sw_fill(const int8_t* a, const int8_t* b, long m, long n,
                int affine, int match, int mismatch,
                int gap_open, int gap_extend,
                const int32_t* sub, int nsym,
                int32_t* H, int8_t* P, long* out_maxpos) {
  const long m1 = m + 1;
  const int32_t NEG = -(1 << 30);
  std::memset(H, 0, sizeof(int32_t) * m1 * (n + 1));
  std::memset(P, 0, sizeof(int8_t) * m1 * (n + 1));
  long maxpos = 0;
  int32_t maxscore = 0;
  if (!affine) {
    const int32_t gap = gap_open;
    for (long i = 1; i <= n; ++i) {
      const int32_t* Hup = H + (i - 1) * m1;
      int32_t* Hrow = H + i * m1;
      int8_t* Prow = P + i * m1;
      const int8_t bi = b[i - 1];
      for (long j = 1; j <= m; ++j) {
        const int32_t s =
            sub ? sub[static_cast<long>(a[j - 1]) * nsym + bi]
                : (a[j - 1] == bi ? match : mismatch);
        const int32_t diag = Hup[j - 1] + s;
        const int32_t up = Hup[j] + gap;
        const int32_t left = Hrow[j - 1] + gap;
        int32_t best = 0;
        int8_t pred = 0;
        if (diag > best) { best = diag; pred = 3; }
        if (up > best) { best = up; pred = 1; }
        if (left > best) { best = left; pred = 2; }
        Hrow[j] = best;
        Prow[j] = pred;
        if (best > maxscore) { maxscore = best; maxpos = i * m1 + j; }
      }
    }
  } else {
    // Rolling F row: Frow[j] holds F[i-1][j] entering row i. Boundary
    // per the oracle: F[0][j>=1] = NEG, F[*][0] = 0 (never read),
    // E[0][*] = 0 (never read), E[i>=1][0] = NEG.
    std::vector<int32_t> Frow(m1, NEG);
    for (long i = 1; i <= n; ++i) {
      const int32_t* Hup = H + (i - 1) * m1;
      int32_t* Hrow = H + i * m1;
      int8_t* Prow = P + i * m1;
      const int8_t bi = b[i - 1];
      int32_t e_prev = NEG;                    // E[i][j-1], starts at E[i][0]
      for (long j = 1; j <= m; ++j) {
        const int32_t s =
            sub ? sub[static_cast<long>(a[j - 1]) * nsym + bi]
                : (a[j - 1] == bi ? match : mismatch);
        const int32_t e_open = Hrow[j - 1] + gap_open;
        const int32_t e_ext = e_prev + gap_extend;
        const int32_t e = e_open > e_ext ? e_open : e_ext;
        const int32_t f_open = Hup[j] + gap_open;
        const int32_t f_ext = Frow[j] + gap_extend;
        const int32_t f = f_open > f_ext ? f_open : f_ext;
        const int32_t diag = Hup[j - 1] + s;
        int32_t best = 0;
        int8_t pred = 0;
        if (diag > best) { best = diag; pred = 3; }
        if (f > best) { best = f; pred = 1; }
        if (e > best) { best = e; pred = 2; }
        Hrow[j] = best;
        Prow[j] = static_cast<int8_t>(
            pred | (e == e_ext ? 4 : 0) | (f == f_ext ? 8 : 0));
        e_prev = e;
        Frow[j] = f;
        if (best > maxscore) { maxscore = best; maxpos = i * m1 + j; }
      }
    }
  }
  *out_maxpos = maxpos;
  return maxscore;
}

// Reconstruct the aligned code strings (kGap = -1 for gaps) from P.
// Returns alignment length; out arrays are written END-FIRST (caller
}  // extern "C"

// ---------------------------------------------------------------------------
// Striped SIMD score-only fill, the host tier of score-only calls below the
// card's per-call floor. Farrar's striped layout (Bioinformatics 2007) for
// 16-bit lanes (16 with AVX2, 32 with AVX-512BW): the query (b, the row
// sequence) is striped across the register — element (seg, lane) is query
// position lane*V + seg with V = ceil(n/LANES) segments — so the F
// (vertical-gap) dependency is resolved lazily per column instead of
// serializing every cell.
//
// Exact Gotoh semantics, held bit-equal to the oracle and to the JAX
// package's copy by tests/test_torch_native.py. Caller guarantees: a-codes
// in [-3, A) (the sentinels score as the profile below says), negative gap
// costs with gap_extend >= gap_open, and max score * min(m, n) within the
// int16 headroom (runtime_native.simd_shape_ok). Without AVX2 the entries
// return INT32_MIN, which the wrapper's ISA probe reads.

#if defined(__AVX2__)
#include <immintrin.h>

namespace {

// ---- ISA traits: the striped algorithm is width-agnostic; AVX2 gives
// 16 int16 lanes, AVX-512BW gives 32. ----

struct IsaAvx2 {
  using v = __m256i;
  static constexpr int LANES = 16;
  static v zero() { return _mm256_setzero_si256(); }
  static v set1(int16_t x) { return _mm256_set1_epi16(x); }
  static v load(const int16_t* p) {
    // unaligned: same speed as vmovdqa on every AVX2 core, and the
    // swipe kernel's std::vector<int16_t> buffers are only 16B-aligned
    return _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p));
  }
  static v adds(v a, v b) { return _mm256_adds_epi16(a, b); }
  static v subs(v a, v b) { return _mm256_subs_epi16(a, b); }
  static v max(v a, v b) { return _mm256_max_epi16(a, b); }
  // shift the 16 int16 elements one lane up (el k <- el k-1), insert at 0
  static v shl1_ins(v x, int16_t ins) {
    const v lo_to_hi = _mm256_permute2x128_si256(x, x, 0x08);
    v s = _mm256_alignr_epi8(x, lo_to_hi, 14);
    return _mm256_insert_epi16(s, ins, 0);
  }
  static bool any_gt(v a, v b) {
    return _mm256_movemask_epi8(_mm256_cmpgt_epi16(a, b)) != 0;
  }
  using msk = __m256i;
  static msk gt(v a, v b) { return _mm256_cmpgt_epi16(a, b); }
  static msk eq(v a, v b) { return _mm256_cmpeq_epi16(a, b); }
  static msk m_and(msk a, msk b) { return _mm256_and_si256(a, b); }
  static msk m_or(msk a, msk b) { return _mm256_or_si256(a, b); }
  static v sel(msk k, v x, v y) { return _mm256_blendv_epi8(y, x, k); }
  static void store(int16_t* p, v x) {
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(p), x);
  }
  static int16_t hmax(v x) {
    __m128i t = _mm_max_epi16(_mm256_castsi256_si128(x),
                              _mm256_extracti128_si256(x, 1));
    t = _mm_max_epi16(t, _mm_srli_si128(t, 8));
    t = _mm_max_epi16(t, _mm_srli_si128(t, 4));
    t = _mm_max_epi16(t, _mm_srli_si128(t, 2));
    return static_cast<int16_t>(_mm_cvtsi128_si32(t));
  }
};

#if defined(__AVX512BW__)
struct IsaAvx512 {
  using v = __m512i;
  static constexpr int LANES = 32;
  static v zero() { return _mm512_setzero_si512(); }
  static v set1(int16_t x) { return _mm512_set1_epi16(x); }
  static v load(const int16_t* p) { return _mm512_loadu_si512(p); }
  static v adds(v a, v b) { return _mm512_adds_epi16(a, b); }
  static v subs(v a, v b) { return _mm512_subs_epi16(a, b); }
  static v max(v a, v b) { return _mm512_max_epi16(a, b); }
  static v shl1_ins(v x, int16_t ins) {
    // permutexvar: out[i] = x[idx[i]]; idx = [_, 0, 1, ..., 30], then
    // masked-set element 0 to the inserted boundary value
    const v idx = _mm512_set_epi16(
        30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17, 16, 15,
        14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 0);
    v s = _mm512_permutexvar_epi16(idx, x);
    return _mm512_mask_set1_epi16(s, 1, ins);
  }
  static bool any_gt(v a, v b) {
    return _mm512_cmpgt_epi16_mask(a, b) != 0;
  }
  using msk = __mmask32;
  static msk gt(v a, v b) { return _mm512_cmpgt_epi16_mask(a, b); }
  static msk eq(v a, v b) { return _mm512_cmpeq_epi16_mask(a, b); }
  static msk m_and(msk a, msk b) { return a & b; }
  static msk m_or(msk a, msk b) { return a | b; }
  static v sel(msk k, v x, v y) { return _mm512_mask_mov_epi16(y, k, x); }
  static void store(int16_t* p, v x) { _mm512_storeu_si512(p, x); }
  static int16_t hmax(v x) {
    __m256i h = _mm256_max_epi16(_mm512_castsi512_si256(x),
                                 _mm512_extracti64x4_epi64(x, 1));
    return IsaAvx2::hmax(h);
  }
};
#endif  // __AVX512BW__

// Core striped fill, parameterized by lane width. See the block comment
// above for the algorithm; PADMIN keeps query-padding cells at the zero
// floor / strictly below any real value (with negative gaps a padding
// cell never rises above the zero floor).
// TRACK adds exact first-occurrence argmax: per striped element (= one
// query row i), strict > keeps the FIRST column j reaching that row's
// best; the host resolution then scans rows ascending (max score, then
// min i, then that row's first j) — bit-compatible with the oracle's
// row-major maxPos rule. Needs m, n <= 32767 so
// coordinates fit the int16 lanes (the wrapper gates this).
template <class I, bool TRACK>
int32_t sw_score_striped(const int8_t* a, const int8_t* b, long m, long n,
                         int affine, int match, int mismatch,
                         int gap_open, int gap_extend,
                         const int32_t* sub, int nsym,
                         int32_t* out_i = nullptr,
                         int32_t* out_j = nullptr,
                         int32_t* out_last = nullptr) {
  using V = typename I::v;
  constexpr int16_t PADMIN = -30000;   // query-padding profile score
  const long Vn = (n + I::LANES - 1) / I::LANES;
  const int A = sub ? nsym : 4;        // DNA codes 0..3 in m/m mode
  const int16_t go = static_cast<int16_t>(-gap_open);
  const int16_t ge = static_cast<int16_t>(affine ? -gap_extend : -gap_open);
  if (go < 0 || ge < 0) return INT32_MIN;

  // Striped query profile with SENTINEL parity: rows cover a-codes
  // -3..-1 (the padding/unknown sentinels) plus 0..A-1, so
  // prof[(code+3)][seg][lane] = score(code, b[lane*Vn + seg]). In
  // match/mismatch mode sentinels score by the raw code compare — N(-1)
  // vs N(-1) MATCHES, exactly like the oracle and the CUDA kernels;
  // in substitution mode any code outside [0, A) on either side scores
  // PADMIN (the strongly negative sentinel score of the kernels'
  // profiles). Query positions >= n stay PADMIN.
  // Caller guarantees a-codes in [-3, A).
  const int AR = A + 3;                // profile rows incl. sentinels
  std::vector<int16_t> prof_store(static_cast<size_t>(AR) * Vn * I::LANES +
                                  I::LANES);
  // align the flat store to the vector width
  int16_t* prof0 = prof_store.data();
  while (reinterpret_cast<uintptr_t>(prof0) % (I::LANES * 2)) ++prof0;
  for (int sr = 0; sr < AR; ++sr) {
    const int s = sr - 3;              // the a-code this row serves
    for (long seg = 0; seg < Vn; ++seg) {
      int16_t* row = prof0 + (static_cast<size_t>(sr) * Vn + seg) * I::LANES;
      for (int lane = 0; lane < I::LANES; ++lane) {
        const long pos = static_cast<long>(lane) * Vn + seg;
        int16_t val = PADMIN;
        if (pos < n) {
          const int bc = b[pos];
          if (sub) {
            val = (s >= 0 && bc >= 0 && bc < A)
                ? static_cast<int16_t>(
                      sub[static_cast<long>(s) * nsym + bc])
                : PADMIN;
          } else {
            val = static_cast<int16_t>(s == bc ? match : mismatch);
          }
        }
        row[lane] = val;
      }
    }
  }

  const V vZero = I::zero();
  const V vMin = I::set1(INT16_MIN);
  const V vGo = I::set1(go);
  const V vGe = I::set1(ge);
  std::vector<V> hbuf(2 * Vn, vZero);            // H ping-pong
  std::vector<V> ebuf(Vn, vMin);                 // E per segment
  V* vHStore = hbuf.data();
  V* vHLoad = hbuf.data() + Vn;
  V* vE = ebuf.data();
  V vMax = vZero;
  std::vector<V> tbuf(TRACK ? 2 * Vn : 0, vZero);  // best, bestj per seg
  V* vBest = tbuf.data();
  V* vBestJ = tbuf.data() + Vn;

  for (long j = 0; j < m; ++j) {
    const int16_t* vP =
        prof0 + (static_cast<size_t>(a[j]) + 3) * Vn * I::LANES;
    // diag operand for segment 0 = previous column's last segment,
    // shifted one lane up; lane 0 sees the zero boundary H(., 0)
    V vH = I::shl1_ins(vHStore[Vn - 1], 0);
    std::swap(vHStore, vHLoad);
    V vF = vMin;
    V vJ = I::zero();
    if (TRACK) vJ = I::set1(static_cast<int16_t>(j + 1));
    for (long seg = 0; seg < Vn; ++seg) {
      vH = I::adds(vH, I::load(vP + seg * I::LANES));  // diag + s(a, b)
      vH = I::max(vH, vE[seg]);
      vH = I::max(vH, vF);
      vH = I::max(vH, vZero);                    // local zero floor
      vMax = I::max(vMax, vH);
      if (TRACK) {
        const typename I::msk k = I::gt(vH, vBest[seg]);
        vBest[seg] = I::sel(k, vH, vBest[seg]);
        vBestJ[seg] = I::sel(k, vJ, vBestJ[seg]);
      }
      vHStore[seg] = vH;
      const V vHgo = I::subs(vH, vGo);
      vE[seg] = I::max(I::subs(vE[seg], vGe), vHgo);
      vF = I::max(I::subs(vF, vGe), vHgo);
      vH = vHLoad[seg];                          // next segment's diag
    }
    // lazy F: propagate the vertical gap across stripe wrap-arounds until
    // it can no longer beat gap-open from the (corrected) H anywhere.
    // Corrections also refresh E (next column's horizontal opens) and the
    // running max — a corrected cell can be the global max.
    vF = I::shl1_ins(vF, INT16_MIN);
    long seg = 0;
    while (I::any_gt(vF, I::subs(vHStore[seg], vGo))) {
      const V vHn = I::max(vHStore[seg], vF);
      vHStore[seg] = vHn;
      vMax = I::max(vMax, vHn);
      if (TRACK) {
        const typename I::msk k = I::gt(vHn, vBest[seg]);
        vBest[seg] = I::sel(k, vHn, vBest[seg]);
        vBestJ[seg] = I::sel(k, vJ, vBestJ[seg]);
      }
      vE[seg] = I::max(vE[seg], I::subs(vHn, vGo));
      vF = I::subs(vF, vGe);
      if (++seg == Vn) {
        seg = 0;
        vF = I::shl1_ins(vF, INT16_MIN);
      }
    }
  }
  const int32_t best = static_cast<int32_t>(I::hmax(vMax));
  if (TRACK && out_last) {
    // H(n, m): after the final column, vHStore holds H(., m); row n-1
    // lives at striped element (seg = (n-1) % Vn, lane = (n-1) / Vn)
    alignas(64) int16_t lastcol[I::LANES];
    I::store(lastcol, vHStore[(n - 1) % Vn]);
    *out_last = static_cast<int32_t>(lastcol[(n - 1) / Vn]);
  }
  if (TRACK && out_i && out_j) {
    *out_i = 0;
    *out_j = 0;
    if (best > 0) {
      std::vector<int16_t> bs(Vn * I::LANES), bj(Vn * I::LANES);
      for (long seg = 0; seg < Vn; ++seg) {
        I::store(bs.data() + seg * I::LANES, vBest[seg]);
        I::store(bj.data() + seg * I::LANES, vBestJ[seg]);
      }
      for (long i = 0; i < n; ++i) {        // ascending row: first wins
        const long lane = i / Vn, seg = i % Vn;
        if (bs[seg * I::LANES + lane] == best) {
          *out_i = static_cast<int32_t>(i + 1);
          *out_j = static_cast<int32_t>(bj[seg * I::LANES + lane]);
          break;
        }
      }
    }
  }
  return best;
}

}  // namespace
#endif  // __AVX2__

extern "C" int32_t sw_score_simd(const int8_t* a, const int8_t* b,
                                 long m, long n, int affine,
                                 int match, int mismatch,
                                 int gap_open, int gap_extend,
                                 const int32_t* sub, int nsym) {
#if defined(__AVX512BW__)
  return sw_score_striped<IsaAvx512, false>(
      a, b, m, n, affine, match, mismatch, gap_open, gap_extend, sub, nsym);
#elif defined(__AVX2__)
  return sw_score_striped<IsaAvx2, false>(
      a, b, m, n, affine, match, mismatch, gap_open, gap_extend, sub, nsym);
#else
  (void)a; (void)b; (void)m; (void)n; (void)affine; (void)match;
  (void)mismatch; (void)gap_open; (void)gap_extend; (void)sub; (void)nsym;
  return INT32_MIN;  // unsupported build; caller falls back
#endif
}

// Score + exact first-occurrence argmax (1-based padded (i, j); 0/0 when
// the best is <= 0) + the bottom-right cell H(n, m) (Alignment.last_cell).
// Caller additionally guarantees
// m, n <= 32767. out_last may be null.
extern "C" int32_t sw_score_simd_pos(const int8_t* a, const int8_t* b,
                                     long m, long n, int affine,
                                     int match, int mismatch,
                                     int gap_open, int gap_extend,
                                     const int32_t* sub, int nsym,
                                     int32_t* out_i, int32_t* out_j,
                                     int32_t* out_last) {
#if defined(__AVX512BW__)
  return sw_score_striped<IsaAvx512, true>(
      a, b, m, n, affine, match, mismatch, gap_open, gap_extend, sub,
      nsym, out_i, out_j, out_last);
#elif defined(__AVX2__)
  return sw_score_striped<IsaAvx2, true>(
      a, b, m, n, affine, match, mismatch, gap_open, gap_extend, sub,
      nsym, out_i, out_j, out_last);
#else
  (void)a; (void)b; (void)m; (void)n; (void)affine; (void)match;
  (void)mismatch; (void)gap_open; (void)gap_extend; (void)sub; (void)nsym;
  (void)out_i; (void)out_j; (void)out_last;
  return INT32_MIN;
#endif
}

// Batched form with positions: B same-shape pairs, rows packed
// contiguously (a_batch: B*m, b_batch: B*n). OpenMP-parallel across
// pairs when built with -fopenmp — the per-pair DP stays the striped
// SIMD fill, so this scales as cores x single-pair rate.
extern "C" void sw_score_simd_batch(const int8_t* a_batch,
                                    const int8_t* b_batch,
                                    long B, long m, long n, int affine,
                                    int match, int mismatch,
                                    int gap_open, int gap_extend,
                                    const int32_t* sub, int nsym,
                                    int32_t* out_scores, int32_t* out_i,
                                    int32_t* out_j) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (long g = 0; g < B; ++g) {
    out_scores[g] = sw_score_simd_pos(
        a_batch + g * m, b_batch + g * n, m, n, affine, match, mismatch,
        gap_open, gap_extend, sub, nsym, out_i + g, out_j + g, nullptr);
  }
}

#if defined(__AVX2__)
namespace {

// Inter-sequence SIMD fill (the SWIPE layout, Rognes 2011): one READ per
// 16-bit lane, so a group of I::LANES reads advances through the same
// (i, j) cell of their independent DP matrices in lock-step — no striping,
// no lazy-F loop. This is the right kernel for the database-search shape
// (many short reads vs one window): the striped Farrar layout thrashes
// its lazy-F correction loop when the query spans only a handful of
// segments (measured 0.7 GCUPS at qlen=100 vs 7 at qlen=2048). Rows are
// processed i-outer / j-inner, so strict-> best tracking lands on the
// row-major FIRST occurrence per lane, matching the oracle exactly.
// Columns are chunked so the per-chunk H/F rows stay cache-resident; H,
// E carries at chunk edges ride per-row arrays.
template <class I>
void sw_swipe_group(const int8_t* a, const int8_t* b_batch,
                    long g0, long G, long B, long m, long n,
                    int affine, int match, int mismatch,
                    int gap_open, int gap_extend,
                    const int32_t* sub, int nsym,
                    int32_t* out_scores, int32_t* out_i, int32_t* out_j) {
  using V = typename I::v;
  constexpr long JCHUNK = 2048;
  const int A = sub ? nsym : 4;
  const int AR = A + 3;
  const int16_t go = static_cast<int16_t>(-gap_open);
  const int16_t ge = static_cast<int16_t>(affine ? -gap_extend : -gap_open);
  constexpr int16_t PADMIN = -30000;

  // per-row lane tables: tab[i][code+3][lane] = score(code, read_lane[i])
  std::vector<int16_t> tabs(static_cast<size_t>(n) * AR * I::LANES);
  for (long i = 0; i < n; ++i) {
    for (int sr = 0; sr < AR; ++sr) {
      const int s = sr - 3;
      int16_t* row = tabs.data() + (i * AR + sr) * I::LANES;
      for (int lane = 0; lane < I::LANES; ++lane) {
        int16_t val = PADMIN;
        if (lane < G) {
          const int bc = b_batch[(g0 + lane) * n + i];
          val = sub ? ((s >= 0 && bc >= 0 && bc < A)
                       ? static_cast<int16_t>(
                             sub[static_cast<long>(s) * nsym + bc])
                       : PADMIN)
                    : static_cast<int16_t>(s == bc ? match : mismatch);
        }
        row[lane] = val;
      }
    }
  }

  const V vZero = I::zero();
  const V vMin = I::set1(INT16_MIN);
  const V vGo = I::set1(go);
  const V vGe = I::set1(ge);
  std::vector<int16_t> hrow(JCHUNK * I::LANES);
  std::vector<int16_t> frow(JCHUNK * I::LANES);
  std::vector<int16_t> hcol(static_cast<size_t>(n) * I::LANES, 0);
  std::vector<int16_t> ecol(static_cast<size_t>(n) * I::LANES);
  for (auto& x : ecol) x = INT16_MIN;
  alignas(64) int16_t carry0[I::LANES] = {0};

  V vBest = vZero, vBestI = vZero, vBestJ = vZero;
  for (long jc = 0; jc < m; jc += JCHUNK) {
    const long mc = jc + JCHUNK < m ? JCHUNK : m - jc;
    std::fill(hrow.begin(), hrow.begin() + mc * I::LANES, 0);
    std::fill(frow.begin(), frow.begin() + mc * I::LANES, INT16_MIN);
    // prevHcol = H[i-1][jc-1] entering each row (row -1 -> boundary 0)
    V prevDiag = I::load(carry0);         // always 0: H[., 0-boundary]
    for (long i = 0; i < n; ++i) {
      const int16_t* tab = tabs.data() + i * AR * I::LANES;
      V vHdiag = jc == 0 ? vZero : prevDiag;
      V vE = jc == 0 ? vMin : I::load(ecol.data() + i * I::LANES);
      const V vI = I::set1(static_cast<int16_t>(i + 1));
      V vH = vZero;
      // per-(row, chunk) argmax in the hot loop (strict > = first j for
      // this row); the row-major tie logic runs once per row below
      V vRowBest = vZero, vRowJ = vZero;
      for (long j = 0; j < mc; ++j) {
        const V vSub = I::load(tab + (a[jc + j] + 3) * I::LANES);
        vH = I::adds(vHdiag, vSub);
        const V vHup = I::load(hrow.data() + j * I::LANES);
        const V vF = I::max(I::subs(vHup, vGo),
                            I::subs(I::load(frow.data() + j * I::LANES),
                                    vGe));
        vH = I::max(vH, vE);
        vH = I::max(vH, vF);
        vH = I::max(vH, vZero);
        const typename I::msk k = I::gt(vH, vRowBest);
        vRowBest = I::sel(k, vH, vRowBest);
        vRowJ = I::sel(k, I::set1(static_cast<int16_t>(jc + j + 1)),
                       vRowJ);
        I::store(hrow.data() + j * I::LANES, vH);
        I::store(frow.data() + j * I::LANES, vF);
        vE = I::max(I::subs(vH, vGo), I::subs(vE, vGe));
        vHdiag = vHup;
      }
      // row-major first occurrence ACROSS rows and column chunks:
      // strictly better wins; an EQUAL score wins only when the row
      // improves (a later chunk can reach an equal score at a smaller
      // row; same-row equal scores in a later chunk have larger j and
      // are correctly rejected)
      const typename I::msk k = I::m_or(
          I::gt(vRowBest, vBest),
          I::m_and(I::eq(vRowBest, vBest), I::gt(vBestI, vI)));
      vBest = I::sel(k, vRowBest, vBest);
      vBestI = I::sel(k, vI, vBestI);
      vBestJ = I::sel(k, vRowJ, vBestJ);
      // chunk-edge carries: this row's H and E at column jc+mc; next
      // chunk's row i+1 uses THIS chunk's old H[i][edge] as its diag
      prevDiag = I::load(hcol.data() + i * I::LANES);
      I::store(hcol.data() + i * I::LANES, vH);
      I::store(ecol.data() + i * I::LANES, vE);
    }
  }
  alignas(64) int16_t bs[I::LANES], bi[I::LANES], bj[I::LANES];
  I::store(bs, vBest);
  I::store(bi, vBestI);
  I::store(bj, vBestJ);
  for (int lane = 0; lane < G; ++lane) {
    const int32_t s = bs[lane];
    out_scores[g0 + lane] = s > 0 ? s : 0;
    out_i[g0 + lane] = s > 0 ? bi[lane] : 0;
    out_j[g0 + lane] = s > 0 ? bj[lane] : 0;
  }
}

}  // namespace
#endif  // __AVX2__

// One shared database sequence vs B striped queries (the window-sweep
// shape of the database searcher: every read scored against the same
// reference window). OpenMP across reads.
extern "C" void sw_score_simd_batch1(const int8_t* a,
                                     const int8_t* b_batch,
                                     long B, long m, long n, int affine,
                                     int match, int mismatch,
                                     int gap_open, int gap_extend,
                                     const int32_t* sub, int nsym,
                                     int32_t* out_scores, int32_t* out_i,
                                     int32_t* out_j) {
#if defined(__AVX2__)
  // inter-sequence groups: one read per lane (see sw_swipe_group) —
  // uniformly fast for short reads where the striped layout thrashes
  // its lazy-F loop; long queries in small batches keep Farrar
#if defined(__AVX512BW__)
  using ISA = IsaAvx512;
#else
  using ISA = IsaAvx2;
#endif
  if (B >= 4 && n <= 8192) {
    const long groups = (B + ISA::LANES - 1) / ISA::LANES;
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
    for (long g = 0; g < groups; ++g) {
      const long g0 = g * ISA::LANES;
      const long G = B - g0 < ISA::LANES ? B - g0 : ISA::LANES;
      sw_swipe_group<ISA>(a, b_batch, g0, G, B, m, n, affine, match,
                          mismatch, gap_open, gap_extend, sub, nsym,
                          out_scores, out_i, out_j);
    }
    return;
  }
#endif  // __AVX2__
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (long g = 0; g < B; ++g) {
    out_scores[g] = sw_score_simd_pos(
        a, b_batch + g * n, m, n, affine, match, mismatch,
        gap_open, gap_extend, sub, nsym, out_i + g, out_j + g, nullptr);
  }
}
