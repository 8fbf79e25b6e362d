// The single-pair stripe fill entries, K1-K4 and their band mode K4b
// (design in stripe_kernel.cuh).
//
// Replaces the Pallas stripe kernel of the JAX package
// (swtpu/kernels/pallas_fill.py `_kernel`, `_stripe_call` -> pallas_call
// :1008) in its local single-pair modes:
//   * sw_stripe_score_linear  - K1, local linear score-only: max score, its
//     first row-major end cell, the right column H[:, m] and H[n, m];
//   * sw_stripe_fill_p_linear - K4, the same walk plus the `return_p`
//     predecessor capture into a row-major (n+1) x (m+1) int8 P;
//   * sw_stripe_score_affine / sw_stripe_fill_p_affine - K2 (and K4 on it),
//     Gotoh affine gaps with the E_EXT/F_EXT state bits in P;
//   * sw_stripe_score_sub / sw_stripe_fill_p_sub - K3 (and K4 on it), a
//     substitution matrix S[a_code, b_code] with linear or affine gaps (a
//     flag picks the instantiation).
//
// K4b, the band mode (pallas_fill.py `_kernel` :358-363, :571-574,
// :594-596, reached through `stripe_fill_raw(band=)` :1084, :1127): each
// entry takes a band half-width last before the stream. kNoBand picks the
// unbanded instantiation, so K1-K4 run the code they ran before the band
// was added; any other value picks the kBand instantiation, where a cell
// with |i - j| > band gets H = 0 and P = NONE, and E = F = NEG, as the JAX
// scan does (a negative band keeps no cell). The TPU kernel leaves E and F
// of such cells unmasked, which gives the same H and P for the negative
// penalties the entries take. The banded fill is bound like the unbanded
// one, since every step still walks the whole anti-diagonal; skipping the
// stripes and steps outside the band is later work.

#include "stripe_kernel.cuh"

namespace {

// the band's instantiation when sc.band != kNoBand, else the plain one
template <bool kCaptureP, bool kAffine, bool kSub>
int launch_fill(const int8_t* a, const int8_t* b, int m, int n,
                const Model& sc, int T, int* sync, int* bnd, int* bnd_f,
                int* best, int* right, int8_t* P, cudaStream_t stream) {
  if (sc.band != kNoBand) {
    return launch<kCaptureP, kAffine, kSub, true>(
        a, b, m, n, sc, Block{}, T, sync, bnd, bnd_f, best, right, P, stream);
  }
  return launch<kCaptureP, kAffine, kSub>(a, b, m, n, sc, Block{}, T, sync,
                                          bnd, bnd_f, best, right, P, stream);
}

}  // namespace

extern "C" const char* sw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int sw_stripe_score_linear(const int8_t* a, const int8_t* b,
                                      int m, int n, int match, int mismatch,
                                      int gap, int T, int* sync, int* bnd,
                                      int* best, int* right, int band,
                                      cudaStream_t stream) {
  const Model sc{match, mismatch, gap, 0, 0, nullptr, 0, band};
  return launch_fill<false, false, false>(a, b, m, n, sc, T, sync, bnd,
                                          nullptr, best, right, nullptr,
                                          stream);
}

extern "C" int sw_stripe_fill_p_linear(const int8_t* a, const int8_t* b,
                                       int m, int n, int match, int mismatch,
                                       int gap, int T, int* sync, int* bnd,
                                       int* best, int* right, int8_t* P,
                                       int band, cudaStream_t stream) {
  const Model sc{match, mismatch, gap, 0, 0, nullptr, 0, band};
  return launch_fill<true, false, false>(a, b, m, n, sc, T, sync, bnd,
                                         nullptr, best, right, P, stream);
}

extern "C" int sw_stripe_score_affine(const int8_t* a, const int8_t* b,
                                      int m, int n, int match, int mismatch,
                                      int gap_open, int gap_extend, int T,
                                      int* sync, int* bnd, int* bnd_f,
                                      int* best, int* right, int band,
                                      cudaStream_t stream) {
  const Model sc{match, mismatch, 0, gap_open, gap_extend, nullptr, 0, band};
  return launch_fill<false, true, false>(a, b, m, n, sc, T, sync, bnd, bnd_f,
                                         best, right, nullptr, stream);
}

extern "C" int sw_stripe_fill_p_affine(const int8_t* a, const int8_t* b,
                                       int m, int n, int match, int mismatch,
                                       int gap_open, int gap_extend, int T,
                                       int* sync, int* bnd, int* bnd_f,
                                       int* best, int* right, int8_t* P,
                                       int band, cudaStream_t stream) {
  const Model sc{match, mismatch, 0, gap_open, gap_extend, nullptr, 0, band};
  return launch_fill<true, true, false>(a, b, m, n, sc, T, sync, bnd, bnd_f,
                                        best, right, P, stream);
}

// sub: (A, A) int32 row-major on the device; affine != 0 takes
// gap_open/gap_extend and needs bnd_f, affine == 0 takes gap.
extern "C" int sw_stripe_score_sub(const int8_t* a, const int8_t* b, int m,
                                   int n, const int* sub, int A, int affine,
                                   int gap, int gap_open, int gap_extend,
                                   int T, int* sync, int* bnd, int* bnd_f,
                                   int* best, int* right, int band,
                                   cudaStream_t stream) {
  const Model sc{0, 0, gap, gap_open, gap_extend, sub, A, band};
  if (affine) {
    return launch_fill<false, true, true>(a, b, m, n, sc, T, sync, bnd,
                                          bnd_f, best, right, nullptr,
                                          stream);
  }
  return launch_fill<false, false, true>(a, b, m, n, sc, T, sync, bnd,
                                         nullptr, best, right, nullptr,
                                         stream);
}

extern "C" int sw_stripe_fill_p_sub(const int8_t* a, const int8_t* b, int m,
                                    int n, const int* sub, int A, int affine,
                                    int gap, int gap_open, int gap_extend,
                                    int T, int* sync, int* bnd, int* bnd_f,
                                    int* best, int* right, int8_t* P,
                                    int band, cudaStream_t stream) {
  const Model sc{0, 0, gap, gap_open, gap_extend, sub, A, band};
  if (affine) {
    return launch_fill<true, true, true>(a, b, m, n, sc, T, sync, bnd, bnd_f,
                                         best, right, P, stream);
  }
  return launch_fill<true, false, true>(a, b, m, n, sc, T, sync, bnd,
                                        nullptr, best, right, P, stream);
}
