// sw_pack_rows: one side of a score_many bucket, its padded rows written on
// the card.
//
// Replaces no TPU kernel: the JAX package pads each bucket on the host
// (`swtpu/dist/batch.py`'s score_many) and uploads it whole. The port
// uploads each distinct sequence once, concatenated into one flat int8
// buffer, with each row's offset into it and its length, and this kernel
// writes the bucket's (rows, width) codes from them:
//
//     out[r, c] = flat[off[r] + c]   where c < len[r]
//     out[r, c] = fill               otherwise (the side's sentinel).
//
// What bounds it: the bytes it stores, rows x width (the reads are at most
// the sequences' bytes, and a sequence repeated over the rows, the query of
// a database search, is read from L1/L2). Each thread stores one aligned
// 16-byte chunk of a row, its bytes read one by one; rows are width bytes
// apart, width a multiple of 16, so the stores of a warp are 512
// contiguous bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(const int8_t* __restrict__ flat, const int* __restrict__ off,
                 const int* __restrict__ len, int rows, int width, int fill,
                 int8_t* __restrict__ out) {
  const int chunks = width >> 4;
  const long long total = (long long)rows * chunks;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += (long long)gridDim.x * kThreads) {
    const int r = (int)(t / chunks);
    const int c0 = (int)(t - (long long)r * chunks) << 4;
    const int n = len[r] - c0;          // the chunk's real bytes, if > 0
    const int8_t* p = flat + off[r] + c0;
    uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      v[b >> 2] |= (uint32_t)(uint8_t)(b < n ? p[b] : fill) << 8 * (b & 3);
    *reinterpret_cast<uint4*>(out + (size_t)r * width + c0) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

// flat: the sequences' bytes; off, len: rows int32 each (each row inside
// flat); out: rows x width bytes, 16-byte aligned, width a positive
// multiple of 16.
extern "C" int sw_pack_rows(const int8_t* flat, const int* off,
                            const int* len, int rows, int width, int fill,
                            int8_t* out, cudaStream_t stream) {
  if (rows < 0 || width <= 0 || width % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long total = (long long)rows * (width / 16);
  const long long blocks = (total + kThreads - 1) / kThreads;
  pack_rows_kernel<<<(unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks),
                     kThreads, 0, stream>>>(flat, off, len, rows, width,
                                            fill, out);
  return (int)cudaGetLastError();
}
