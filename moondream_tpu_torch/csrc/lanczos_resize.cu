// PIL-exact Lanczos resize and overlap-crop extraction for Hopper (sm_90a):
// uint8 (B, H, W, 3) images -> their uint8 (B * (rows * cols + 1), 378,
// 378, 3) crop stack, equal byte for byte to PIL.Image.resize(LANCZOS) and
// to the host crop path (native/preprocess.cpp).
//
// Replaces the JAX package's device resize (moondream_tpu/ops/
// device_preprocess.py:202-229), which XLA computes as two einsums over
// three signed 8-bit digit planes of the tap matrix, recombined in int32
// and clipped (no Pallas kernel). That design exists to put integer
// products on the TPU's bf16 matrix unit. Here the card's integer units do
// Pillow's arithmetic as it is:
//   acc = 1 << 21;  acc += in[...] * tap[k] over the output's band;
//   out = acc <= 0 ? 0 : acc >= 1 << 30 ? 255 : acc >> 22   (clip8)
// in int32. |acc| <= 255 * sum|tap| < 2^31 for Lanczos-3 (sum|tap| is
// under 2^23), so nothing overflows and the result is exact by
// construction: no digit planes, no floating point, no library GEMM.
//
// The taps come from the host (ops/device_preprocess.py, Pillow's float64
// precompute_coeffs rounded to 22 bits) as a band per output: start (out,)
// int32 and taps (out, K) int32, so that output o reads inputs
// [start[o], start[o] + K); a band never passes the last input.
//
// Two kernels, one thread per output pixel and its 3 channels:
// - lanczos_h: the horizontal pass, (B, H, W, 3) -> (B, H, OW, 3).
// - lanczos_v_crops: the vertical pass, written straight into the crop
//   stack: a thread maps its crop pixel (image b, crop j, y, x) to row
//   r * window + y and column c * window + x of the pass's output
//   (r, c = j's place in the tiling) and writes crop crop0 + j of image b.
//   Where the height does not change (taps == null) it copies the pixel:
//   Pillow skips that pass, and so does this one. Pixels in the overlap of
//   two tiles are computed once for each.
// A 13-crop image takes four launches (the global crop's and the grid's
// horizontal passes, then their vertical passes); a pass whose width does
// not change is skipped by the caller.
//
// Bound by bytes: the raw image read once and the crop stack written once
// (756x1008: 2.29 MB in, 13 crops 5.57 MB out, 2.35 us at 3.35 TB/s). The
// work is ~150 M integer multiply-adds for such an image, which this
// simple kernel runs on the CUDA cores; each thread reads its taps from L1
// and its pixels as single bytes. Shared-memory staging of the source rows
// and the taps is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRound = 1 << 21;

__device__ __forceinline__ uint8_t clip8(int acc) {
  if (acc <= 0) return 0;
  if (acc >= (1 << 30)) return 255;
  return static_cast<uint8_t>(acc >> 22);
}

__global__ void lanczos_h_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                 const int* __restrict__ start, const int* __restrict__ taps,
                                 long long rows, int W, int OW, int K) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= rows * OW) return;
  const int ox = static_cast<int>(i % OW);
  const long long row = i / OW;
  const uint8_t* p = in + (row * W + __ldg(start + ox)) * 3;
  const int* t = taps + static_cast<long long>(ox) * K;
  int a0 = kRound, a1 = kRound, a2 = kRound;
  for (int k = 0; k < K; ++k, p += 3) {
    const int w = __ldg(t + k);
    a0 += static_cast<int>(p[0]) * w;
    a1 += static_cast<int>(p[1]) * w;
    a2 += static_cast<int>(p[2]) * w;
  }
  uint8_t* o = out + i * 3;
  o[0] = clip8(a0);
  o[1] = clip8(a1);
  o[2] = clip8(a2);
}

__global__ void lanczos_v_crops_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
                                       const int* __restrict__ start,
                                       const int* __restrict__ taps, int B, int H, int W, int K,
                                       int ch, int cw, int window, int n_rows, int n_cols,
                                       int crop0, int per_image) {
  const int tiles = n_rows * n_cols;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<long long>(B) * tiles * ch * cw) return;
  const int x = static_cast<int>(i % cw);
  long long q = i / cw;
  const int y = static_cast<int>(q % ch);
  q /= ch;
  const int j = static_cast<int>(q % tiles);
  const long long b = q / tiles;
  const int gy = (j / n_cols) * window + y;
  const int gx = (j % n_cols) * window + x;
  const uint8_t* col = src + (b * H * W + gx) * 3;  // column gx of image b
  const long long row_bytes = static_cast<long long>(W) * 3;
  uint8_t* o = out + (((b * per_image + crop0 + j) * ch + y) * cw + x) * 3;
  if (taps == nullptr) {
    const uint8_t* p = col + gy * row_bytes;
    o[0] = p[0];
    o[1] = p[1];
    o[2] = p[2];
    return;
  }
  const uint8_t* p = col + __ldg(start + gy) * row_bytes;
  const int* t = taps + static_cast<long long>(gy) * K;
  int a0 = kRound, a1 = kRound, a2 = kRound;
  for (int k = 0; k < K; ++k, p += row_bytes) {
    const int w = __ldg(t + k);
    a0 += static_cast<int>(p[0]) * w;
    a1 += static_cast<int>(p[1]) * w;
    a2 += static_cast<int>(p[2]) * w;
  }
  o[0] = clip8(a0);
  o[1] = clip8(a1);
  o[2] = clip8(a2);
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// Horizontal pass: in (rows, W, 3) uint8 (rows = B * H), out (rows, OW, 3)
// uint8, start (OW,) and taps (OW, K) int32 with start[o] + K <= W.
extern "C" int lanczos_h_u8(const void* in, void* out, const void* start, const void* taps,
                            long long rows, int W, int OW, int K, void* stream) {
  if (rows <= 0 || W <= 0 || OW <= 0 || K <= 0 || K > W) return (int)cudaErrorInvalidValue;
  lanczos_h_kernel<<<blocks_for(rows * OW), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const int*>(start), static_cast<const int*>(taps), rows, W, OW, K);
  return (int)cudaGetLastError();
}

// Vertical pass into a crop stack: src (B, H, W, 3) uint8; out (B *
// per_image, ch, cw, 3) uint8, of which crops crop0 .. crop0 + n_rows *
// n_cols - 1 of each image are written; start (OH,) and taps (OH, K) int32
// over H (start[o] + K <= H), or both null for a copy (OH = H). The tile at
// (r, c) covers rows r * window .. + ch and columns c * window .. + cw of
// the pass's (OH, W) output, which must hold them.
extern "C" int lanczos_v_crops_u8(const void* src, void* out, const void* start,
                                  const void* taps, int B, int H, int W, int OH, int K, int ch,
                                  int cw, int window, int n_rows, int n_cols, int crop0,
                                  int per_image, void* stream) {
  const bool copy = taps == nullptr;
  if (B <= 0 || H <= 0 || W <= 0 || ch <= 0 || cw <= 0 || n_rows <= 0 || n_cols <= 0 ||
      window < 0 || crop0 < 0 || crop0 + n_rows * n_cols > per_image ||
      (n_rows - 1) * window + ch > OH || (n_cols - 1) * window + cw > W ||
      (copy ? (OH != H || start != nullptr) : (start == nullptr || K <= 0 || K > H)))
    return (int)cudaErrorInvalidValue;
  const long long n = static_cast<long long>(B) * n_rows * n_cols * ch * cw;
  lanczos_v_crops_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out),
      static_cast<const int*>(start), static_cast<const int*>(taps), B, H, W, K, ch, cw, window,
      n_rows, n_cols, crop0, per_image);
  return (int)cudaGetLastError();
}
