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
// What bounds it on the H100: for M up to 64 (decode, a pool step, the
// 16-row query span, lockstep steps) a call reads K/2 * N bytes of codes for
// 2 * M * K * N flops, at most 256 flops per byte, under the ~295 flop/byte
// ridge: it is bound by the bytes it reads, 1/4 of a bf16 weight's. At the
// 2B shapes that is 2.4-9.4 MB, 0.7-2.8 us at 3.35 TB/s, so a launch's
// fixed chain of latencies weighs as much as the bytes. The design:
// - Split-K over whole group pairs. Block (split, tile) owns 64 output
//   columns (32 for M tiles past 16 rows) and S = K / (2 * n_split) byte
//   rows, a whole number of glen-row groups, so it feeds two K slices of x
//   (high and low nibbles). The host plans n_split
//   (`kernels/quant.plan_w4a16_splits`) from (K, N, glen, SMs) alone: one
//   wave of two blocks per SM, clusters of at most 4.
// - The n_split blocks of a tile are one thread-block cluster. Each leaves
//   its fp32 partial in its shared memory; after a cluster barrier every
//   block sums a share of the tile over distributed shared memory, in split
//   order, and writes bf16 once. No workspace, tickets or atomics.
// - Bytes in flight: warp w of 8 takes the 32-row chunks w, w + 8, ... of
//   the split and loads its first two straight into registers with 8-byte
//   loads (whole 32-byte sectors), before anything else: the whole split at
//   the 2B shapes, 64 KB per SM. x's two K slices and the block's scales
//   and zeros go to shared memory by cp.async meanwhile.
// - Tensor cores with the operands swapped: the weight tile is mma.sync
//   m16n8k16's A (16 output columns x 16 k; codes 0..15 are exact in bf16)
//   and x^T is B (16 k x 8 rows of x), so M 1-8 fill one n8 fragment. Two
//   byte permutes of a lane's words from two adjacent rows give the A
//   registers of a column pair; a nibble pair becomes bf16x2 with one mask,
//   one OR with 128.0's bits and one subtraction of 128.
// - Per chunk and nibble (a chunk lies in one group): the product starts
//   from zero and is scaled into the warp's sum with one fma; a product
//   with A all ones gives the chunk's sums of x in the accumulator's layout,
//   and one more fma adds the zero point. The 8 warps' sums are added in
//   warp order in shared memory.
// - One M tile of up to 64 rows where x's slices fit in shared memory (at
//   S 1024 up to 32): the weight is read once per M tile.
// Row invariance: the split plan, the chunk-to-warp map, the order of
// every fp32 operation (explicit fma / add, no contraction left to the
// compiler) and the merge orders are the same for every M, and a
// tensor-core product computes each element from its own row and column,
// so a row's output bits depend only on that row of x and on the weight.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
namespace cg = cooperative_groups;

namespace {

constexpr int WR = 8;              // warps per block, each along every WR-th chunk
constexpr int NT = 32 * WR;        // threads per block
constexpr int CH = 32;             // byte rows per chunk
constexpr int MAX_SPLITS = 8;      // the portable cluster size
constexpr int XPAD = 8;            // bf16 padding per staged x row (bank spread)
constexpr int MT_MAX = 64;         // rows of x per block
constexpr size_t SMEM_LIMIT = 227 * 1024;
constexpr uint32_t ONES = 0x3F803F80u;  // bf16x2 (1, 1)

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// d (16 x 8, fp32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The nibbles at bits 0-3 and 16-19 of v as bf16x2 (exact: 128 + c - 128).
__device__ __forceinline__ uint32_t codes(uint32_t v) {
  uint32_t w = (v & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                                   __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct Layout {
  int xs_row, groups;
  size_t sc, zr, bytes;
};

// Shared memory of one block (TN output columns): x's two K slices
// [2][MT][S + XPAD], later
// reused for the warps' partials [WR][MT][TN] (the block's sum lands in
// warp 0's); scales and zeros [groups][TN].
__host__ __device__ inline Layout layout(int S, int glen, int mt, int TN) {
  Layout l;
  l.xs_row = S + XPAD;
  l.groups = 2 * S / glen;
  const size_t xs = (size_t)2 * mt * l.xs_row * sizeof(bf16);
  const size_t red = (size_t)WR * mt * TN * sizeof(float);
  l.sc = xs > red ? xs : red;
  l.zr = l.sc + (size_t)l.groups * TN * sizeof(float);
  l.bytes = l.zr + (size_t)l.groups * TN * sizeof(float);
  return l;
}

// MF fragments of 8 rows of x; P column pairs (mma tiles) per lane: 2P
// columns per lane, 16P per warp and per block.
template <int MF, int P>
__global__ void __launch_bounds__(NT, MF <= 2 ? 2 : 1) w4a16_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale, const float* __restrict__ zero,
    bf16* __restrict__ out, int M, int K, int N, int glen, int S) {
  constexpr int MT = 8 * MF, TN = 16 * P, WPR = P / 2;  // 32-bit words per lane and row
  constexpr int CPW = 2;  // chunks whose weight words a warp holds at once
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(S, glen, MT, TN);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem);  // after the products
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* zr = reinterpret_cast<float*>(smem + L.zr);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int split = blockIdx.x, n0 = blockIdx.y * TN, m0 = blockIdx.z * MT;
  const int r0 = split * S;  // first byte row of this split
  const int half = K / 2, XS = L.xs_row, nG = L.groups, npairs = S / glen;
  const int nch = S / CH;
  const int mrows = min(MT, M - m0);
  const bool cols = n0 + 2 * P * g8 < N;  // N % 64 == 32: a half-full last tile

  // The warp's first CPW chunks (w, w + WR, ...) straight into registers:
  // lane (g, t) loads 2P bytes (columns 2Pg..2Pg+2P-1) of rows 2t, 2t+1,
  // 2t+8, 2t+9 and the same + 16 of each chunk: whole 32-byte sectors.
  const uint8_t* wcol = packed + (size_t)r0 * N + n0 + 2 * P * g8;
  auto load = [&](uint32_t (&w)[CPW][8][WPR], int c0) {
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      const int c = c0 + j * WR;
      if (c < nch && cols) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint8_t* rp = wcol + (size_t)(c * CH + 2 * t4 + (i & 1) + 8 * (i >> 1)) * N;
          if constexpr (WPR == 2) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(rp));
            w[j][i][0] = v.x;
            w[j][i][WPR - 1] = v.y;
          } else {
            w[j][i][0] = __ldg(reinterpret_cast<const uint32_t*>(rp));
          }
        }
      }
    }
  };
  uint32_t w[CPW][8][WPR];
  load(w, warp);

  // x's two K slices (only rows < M; later rows read as zero) and the
  // scales and zeros (columns past N skipped) to shared memory.
  const int vec = S / 8;
  for (int i = tid; i < 2 * mrows * vec; i += NT) {
    const int hl = i / (mrows * vec), m = i / vec % mrows, v = i % vec;
    cp_async16(xs + (hl * MT + m) * XS + 8 * v, x + (size_t)(m0 + m) * K + hl * half + r0 + 8 * v);
  }
  for (int i = tid; i < 2 * nG * TN / 4; i += NT) {
    const int sz = i / (nG * TN / 4), gi = i / (TN / 4) % nG, c = 4 * (i % (TN / 4));
    const int g = (gi < npairs ? 0 : K / glen / 2 - npairs) + r0 / glen + gi;
    if (n0 + c < N)
      cp_async16((sz ? zr : sc) + gi * TN + c, (sz ? zero : scale) + (size_t)g * N + n0 + c);
  }
  cp_async_wait_all();
  __syncthreads();

  // Per chunk and nibble, mma p (0..P-1) takes columns 2Pg + 2p (its row g)
  // and 2Pg + 2p + 1 (row g + 8): its A registers are byte permutes of the
  // two rows' words. A product with A all ones gives the chunk's sum of x
  // per row, in the accumulator's layout. d0/d1: column 2Pg + 2p, rows 2t,
  // 2t + 1 of the fragment; d2/d3: column 2Pg + 2p + 1.
  float acc[MF][P][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][p][e] = 0.f;
  const uint32_t ones[4] = {ONES, ONES, ONES, ONES};

  for (int c0 = warp; c0 < nch; c0 += CPW * WR) {
    if (c0 != warp) load(w, c0);
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      const int c = c0 + j * WR;
      if (c >= nch) break;
#pragma unroll
      for (int nib = 0; nib < 2; ++nib) {  // high nibbles, then low
        const bf16* xb = xs + nib * MT * XS;
        const int gi = nib * npairs + c * CH / glen;
        float sv[2 * P], zv[2 * P];
#pragma unroll
        for (int h = 0; h < P / 2; ++h) {
          *reinterpret_cast<float4*>(sv + 4 * h) =
              *reinterpret_cast<const float4*>(sc + gi * TN + 2 * P * g8 + 4 * h);
          *reinterpret_cast<float4*>(zv + 4 * h) =
              *reinterpret_cast<const float4*>(zr + gi * TN + 2 * P * g8 + 4 * h);
        }
        uint32_t b[MF][2][2];
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          const bool row = 8 * f + g8 < mrows;
          const int xo = (8 * f + g8) * XS + c * CH + 2 * t4;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            b[f][kk][0] = row ? lds32(xb + xo + 16 * kk) : 0u;
            b[f][kk][1] = row ? lds32(xb + xo + 16 * kk + 8) : 0u;
          }
        }
        float xsum[MF][4];
#pragma unroll
        for (int f = 0; f < MF; ++f) {
#pragma unroll
          for (int e = 0; e < 4; ++e) xsum[f][e] = 0.f;
          mma_bf16(xsum[f], ones, b[f][0][0], b[f][0][1]);
          mma_bf16(xsum[f], ones, b[f][1][0], b[f][1][1]);
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          // rows 16kk + 2t, +1 (u) and 16kk + 8 + 2t, +1 (v) of the pair's
          // columns; bytes (row, col A), (row, col B), (row + 1, A), (row + 1, B)
          uint32_t a[2][4];
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint32_t sel = p % 2 ? 0x7632 : 0x5410;
            const uint32_t u = prmt(w[j][4 * kk][p / 2], w[j][4 * kk + 1][p / 2], sel);
            const uint32_t v = prmt(w[j][4 * kk + 2][p / 2], w[j][4 * kk + 3][p / 2], sel);
            a[kk][0] = codes(nib ? u : u >> 4);
            a[kk][1] = codes(nib ? u >> 8 : u >> 12);
            a[kk][2] = codes(nib ? v : v >> 4);
            a[kk][3] = codes(nib ? v >> 8 : v >> 12);
          }
#pragma unroll
          for (int f = 0; f < MF; ++f) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(d, a[0], b[f][0][0], b[f][0][1]);
            mma_bf16(d, a[1], b[f][1][0], b[f][1][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 2 * p + (e >> 1);
              const float t = __fmaf_rn(d[e], sv[col], acc[f][p][e]);
              acc[f][p][e] = __fmaf_rn(xsum[f][e & 1], zv[col], t);
            }
          }
        }
      }
    }
  }

  // The warps' partials, summed element by element in warp order into
  // warp 0's slot: red[w][m][col] over x's slices, then the cluster's merge
  // reads red[0].
  __syncthreads();  // x is dead
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * MT + 8 * f + 2 * t4 + (e & 1)) * TN + 2 * P * g8 + 2 * p + (e >> 1)] =
            acc[f][p][e];
  __syncthreads();
  for (int i = tid; i < mrows * TN; i += NT) {
    float v = red[i];
#pragma unroll
    for (int ww = 1; ww < WR; ++ww) v = __fadd_rn(v, red[ww * MT * TN + i]);
    red[i] = v;
  }

  // Merge over the cluster (the tile's splits): block `split` sums every
  // n_split-th group of 4 columns of the valid rows and columns, all
  // partials loaded at once, then added in split order.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ns = (int)cluster.num_blocks();
  const int c4n = min(TN, N - n0) / 4;
  for (int i = split * NT + tid; i < mrows * c4n; i += ns * NT) {
    const int m = i / c4n, c = 4 * (i % c4n);
    float4 q[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < ns)
        q[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r) + m * TN + c);
    float4 v = q[0];
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r) {
      if (r < ns) {
        v.x = __fadd_rn(v.x, q[r].x);
        v.y = __fadd_rn(v.y, q[r].y);
        v.z = __fadd_rn(v.z, q[r].z);
        v.w = __fadd_rn(v.w, q[r].w);
      }
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 o;
    o.x = *reinterpret_cast<const uint32_t*>(&lo);
    o.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + (size_t)(m0 + m) * N + n0 + c) = o;
  }
  cluster.sync();  // keep every partial alive until the last remote read
}

// Column pairs per lane for an M tile of MF fragments: 4 (64 columns per
// block) up to 16 rows of x, 2 (32 columns) for the accumulators of more.
__host__ __device__ constexpr int pairs_for(int mf) { return mf <= 2 ? 4 : 2; }

template <int MF>
int launch(const void* x, const void* packed, const void* scale, const void* zero, void* out,
           int M, int K, int N, int glen, int n_split, cudaStream_t stream) {
  constexpr int P = pairs_for(MF), TN = 16 * P;
  const int S = K / 2 / n_split;
  const Layout L = layout(S, glen, 8 * MF, TN);
  cudaError_t err = cudaFuncSetAttribute(
      w4a16_kernel<MF, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, (N + TN - 1) / TN, (M + 8 * MF - 1) / (8 * MF));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, w4a16_kernel<MF, P>, static_cast<const bf16*>(x),
                           static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
                           static_cast<const float*>(zero), static_cast<bf16*>(out), M, K, N,
                           glen, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, packed (K/2, N) uint8, scale/zero (K/glen, N) fp32, out
// (M, N) bf16, all contiguous and 16-byte aligned. N % 32 == 0, glen a
// multiple of 32, K % (2 * glen) == 0, and n_split (at most 8) divides the
// K / (2 * glen) group pairs. The M tile is the fewest fragments of 8 rows
// that hold M, at most 64 rows, halved while the block's shared memory
// would not fit (a function of K, N and glen only).
extern "C" int w4a16_matmul_bf16(const void* x, const void* packed, const void* scale,
                                 const void* zero, void* out, int M, int K, int N, int glen,
                                 int n_split, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || glen <= 0 || glen % CH || N % 32 || K % (2 * glen) ||
      n_split < 1 || n_split > MAX_SPLITS || (K / (2 * glen)) % n_split ||
      N / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const int S = K / 2 / n_split;
  auto bytes = [&](int mt) { return layout(S, glen, mt, 16 * pairs_for(mt / 8)).bytes; };
  int mt = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : MT_MAX;
  while (mt > 8 && bytes(mt) > SMEM_LIMIT) mt /= 2;
  if (bytes(mt) > SMEM_LIMIT || (M + mt - 1) / mt > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 8: return launch<1>(x, packed, scale, zero, out, M, K, N, glen, n_split, s);
    case 16: return launch<2>(x, packed, scale, zero, out, M, K, N, glen, n_split, s);
    case 32: return launch<4>(x, packed, scale, zero, out, M, K, N, glen, n_split, s);
    default: return launch<8>(x, packed, scale, zero, out, M, K, N, glen, n_split, s);
  }
}
