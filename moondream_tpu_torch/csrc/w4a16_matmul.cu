// W4A16 matmul for Hopper (sm_90a): out (M, N) bf16 = x (M, K) bf16 times a
// weight held as int4 codes, straight from the packed bytes. The dense
// weight is never written.
//
// Replaces the Pallas kernels `_q_matmul_kernel_gd` and `_q_matmul_kernel`
// (moondream_tpu/ops/quant.py, called from `quantized_matmul`), which
// compute the same product. Packing (moondream_tpu/ops/quant.py:18-22):
// byte (r, n) of `packed` (K/2, N) holds the code of input row r in its high
// nibble and of row r + K/2 in its low nibble; scale/zero are (G, N) fp32
// with G = K / glen groups along K, and w = code * scale + zero. So byte row
// r feeds group g = r / glen through its high nibble and group g + G/2
// through its low one. The kernel computes the group-dot form
//
//     out = sum_g (x_g . code_g) * scale[g]  +  sum_g (sum_k x_g) * zero[g]
//
// with every product and sum in fp32, rounded to bf16 once at the end.
//
// What bounds it on the H100: at M = 1 or 8 (decode, the 8-row prompt
// span) a step reads K/2 * N bytes of codes for 2 * M * K * N flops, 4 * M
// flops per byte, far below the ~295 flop/byte ridge: it is bound by the
// bytes it reads, 1/4 of a bf16 weight's. The design reads each packed byte
// exactly once: one block per 32 output columns, eight adjacent threads on
// 32 adjacent columns of a byte row (one 4-byte load each, whole 32-byte
// sectors), 32 byte rows in flight per block. One byte load feeds two fp32
// partials (group g and g + G/2), each scaled once per group; the zero
// points act on per-group sums of x. x for up to 8 rows is staged in shared
// memory as [K][8] bf16, so one 16-byte load gives a row's 8 activations.
// Partials over the 32 row lanes are summed through shared memory at the
// end. wgmma, TMA and split-K across blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;                   // threads per block
constexpr int TN = 32;                    // output columns per block
constexpr int CPT = 4;                    // columns per thread
constexpr int LANES_PER_ROW = TN / CPT;   // threads on one byte row
constexpr int ROW_LANES = NT / LANES_PER_ROW;  // byte rows in flight
constexpr int MT_MAX = 8;                 // rows of x per block

template <int MT>
__device__ __forceinline__ void load_x(const bf16* xs, int r, float (&v)[MT]) {
  if constexpr (MT == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xs + r * 8);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p2[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m) v[m] = __bfloat162float(xs[r * MT + m]);
  }
}

__host__ __device__ constexpr size_t xsum_floats(int groups, int mt) {
  return ((size_t)groups * mt + 3) / 4 * 4;  // keeps xs 16-byte aligned
}

template <int MT>
__global__ void __launch_bounds__(NT) w4a16_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale, const float* __restrict__ zero,
    bf16* __restrict__ out, int M, int K, int N, int glen) {
  extern __shared__ __align__(16) float smem[];
  const int G = K / glen;
  const int half_g = G / 2;
  float* xsum = smem;  // [G][MT]
  bf16* xs = reinterpret_cast<bf16*>(smem + xsum_floats(G, MT));  // [K][MT]
  float* red = reinterpret_cast<float*>(xs);  // [ROW_LANES][MT][TN], later

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);

  // Stage x rows m0.. as [K][MT] (coalesced reads, rows past M are zero).
  for (int i = tid; i < MT * K; i += NT) {
    const int m = i / K, k = i % K;
    xs[k * MT + m] = m < mrows ? x[(size_t)(m0 + m) * K + k] : __float2bfloat16(0.f);
  }
  __syncthreads();
  for (int i = tid; i < G * MT; i += NT) {
    const int g = i / MT, m = i % MT;
    float s = 0.f;
    for (int k = g * glen; k < (g + 1) * glen; ++k) s += __bfloat162float(xs[k * MT + m]);
    xsum[i] = s;
  }
  __syncthreads();

  const int cl = tid % LANES_PER_ROW;
  const int rl = tid / LANES_PER_ROW;
  const int col = blockIdx.x * TN + cl * CPT;
  const uint8_t* pcol = packed + col;
  const int half_rows = K / 2;

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

  for (int g = 0; g < half_g; ++g) {
    float ph[MT][CPT], pl[MT][CPT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) ph[m][c] = pl[m][c] = 0.f;
    const int rend = (g + 1) * glen;
#pragma unroll 4
    for (int r = g * glen + rl; r < rend; r += ROW_LANES) {
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(pcol + (size_t)r * N));
      float xh[MT], xl[MT];
      load_x<MT>(xs, r, xh);
      load_x<MT>(xs, r + half_rows, xl);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float ch = (float)((w >> (8 * c + 4)) & 0xFu);
        const float cv = (float)((w >> (8 * c)) & 0xFu);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          ph[m][c] = fmaf(xh[m], ch, ph[m][c]);
          pl[m][c] = fmaf(xl[m], cv, pl[m][c]);
        }
      }
    }
    const float4 sh = __ldg(reinterpret_cast<const float4*>(scale + (size_t)g * N + col));
    const float4 sl =
        __ldg(reinterpret_cast<const float4*>(scale + (size_t)(g + half_g) * N + col));
    const float shv[4] = {sh.x, sh.y, sh.z, sh.w};
    const float slv[4] = {sl.x, sl.y, sl.z, sl.w};
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        acc[m][c] += ph[m][c] * shv[c] + pl[m][c] * slv[c];
  }

  // Zero points: sum_g xsum[m][g] * zero[g][col], groups split over row lanes.
  for (int g = rl; g < G; g += ROW_LANES) {
    const float4 z = __ldg(reinterpret_cast<const float4*>(zero + (size_t)g * N + col));
    const float zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[m][c] = fmaf(xsum[g * MT + m], zv[c], acc[m][c]);
  }
  __syncthreads();  // xs is dead: reuse it for the row-lane reduction

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) red[(rl * MT + m) * TN + cl * CPT + c] = acc[m][c];
  __syncthreads();

  for (int i = tid; i < MT * TN; i += NT) {
    const int m = i / TN, c = i % TN;
    if (m >= mrows) continue;
    float s = 0.f;
#pragma unroll 8
    for (int l = 0; l < ROW_LANES; ++l) s += red[(l * MT + m) * TN + c];
    out[(size_t)(m0 + m) * N + blockIdx.x * TN + c] = __float2bfloat16(s);
  }
}

template <int MT>
int launch(const void* x, const void* packed, const void* scale, const void* zero,
           void* out, int M, int K, int N, int glen, cudaStream_t stream) {
  const int G = K / glen;
  const size_t xs_bytes = (size_t)2 * K * MT;
  const size_t red_bytes = sizeof(float) * (size_t)ROW_LANES * MT * TN;
  const size_t bytes = sizeof(float) * xsum_floats(G, MT) +
                       (xs_bytes > red_bytes ? xs_bytes : red_bytes);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      w4a16_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / TN, (M + MT - 1) / MT);
  w4a16_kernel<MT><<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<bf16*>(out), M, K, N, glen);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, packed (K/2, N) uint8, scale/zero (K/glen, N) fp32, out
// (M, N) bf16, all contiguous. N % 32 == 0, K % (2 * glen) == 0, 16-byte
// aligned scale/zero, 4-byte aligned packed.
extern "C" int w4a16_matmul_bf16(const void* x, const void* packed,
                                 const void* scale, const void* zero, void* out,
                                 int M, int K, int N, int glen, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || glen <= 0 || N % TN || K % (2 * glen) ||
      M > 65535 * MT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return M == 1 ? launch<1>(x, packed, scale, zero, out, M, K, N, glen, s)
                : launch<MT_MAX>(x, packed, scale, zero, out, M, K, N, glen, s);
}
