// w8a8 linear for Hopper (sm_90a): out (M, N) bf16 = the int8 product of
// x (M, K) bf16, quantized to int8 inside the kernel, with per-output-channel
// int8 weight codes, and its fp32 epilogue, in one launch.
//
// Replaces the JAX package's int8 branch of `linear`
// (moondream_tpu/ops/layers.py:38-71), which XLA computes as separate
// operations (no Pallas kernel): the activation codes, an int8 x int8 ->
// int32 dot_general and an fp32 epilogue. It computes, bit for bit as the
// jitted JAX function does:
//   dynamic codes: a[m] = max(amax_k |x[m, k]|, 1e-6) * fp32(1/127),
//                  q = rint(x / a[m]) (IEEE division, ties to even, no clip);
//   static codes:  q = clamp(rint(x * inv_a[k]), -127, 127);
//   acc[m, n] = sum_k q[m, k] * wq[n, k] in int32 (exact: K * 127^2 < 2^31
//               up to K 133 000);
//   dynamic epilogue: y = fma(float(acc) * scale[n], a[m], b[n]);
//   static epilogue:  y = fma(float(acc), scale[n], b[n]);
//   out = bf16(y), rounded to nearest even.
// XLA on the CPU contracts the epilogue's tail to one fused multiply-add;
// __fmaf_rn is that operation. Build without --use_fast_math: the division
// must be IEEE.
//
// Layout: wq is JAX's (K, N) codes transposed to (N, Kp), K zero-padded to
// a multiple of 64 (models' `pack_int8_weight`), so that both operands of
// mma.sync.m16n8k32.row.col are K-contiguous. scale (N,) fp32, b (N,) bf16
// or null, inv_a (Kp,) fp32 (zero past K) or null for dynamic codes.
//
// What bounds it on the H100: at decode sizes (M 1 to 64) a call reads the
// N * K weight bytes for 2 * M * K * N operations, under the card's ~590
// int8 operations per byte: bound by bytes (2B text qkv at M 1: 12.6 MB,
// 3.76 us at 3.35 TB/s). At the ViT's 9984 rows it is bound by operations
// (qkv 79.5 GOP, 40.2 us at 1979 TOPS). This first version is simple:
// - M <= 64 (kernel S): a thread-block cluster of 1, 2 or 4 blocks owns 16
//   or 32 output columns and every row; its warps split K into 64-byte
//   chunks (up to 4 in flight each), load their weight chunks straight
//   into registers with 16-byte loads and quantize their own x chunks in
//   registers, so a weight byte is read once per call and there is no
//   shared-memory staging. The int32
//   sums meet in the cluster's first block by integer atomics over
//   distributed shared memory (exact, so the order does not matter). Each
//   block takes the rows' amax itself, a row shared by several warps when
//   M < 8.
// - M > 64 (kernel L): 128 x 128 output tiles, 8 warps of 64 rows x 32
//   columns, 64-byte K chunks through a 4-stage cp.async ring in shared
//   memory (weight bytes, bf16 x and, static, inv_a): three chunks are in
//   flight while one is quantized into a shared code tile and multiplied.
//   Every column block quantizes its rows again (N / 128 times in all).
//   The output tile leaves through shared memory in 16-byte stores.
// - The codes are rounded with a float add (see ROUND_MAGIC), not the
//   quarter-rate float-to-int unit; a dynamic code takes a product with the
//   row's reciprocal scale, and the IEEE quotient only next to a tie.
// wgmma, TMA and a split of K across blocks at M 1 are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 8;           // warps per block
constexpr int NT = 32 * NW;     // threads per block
constexpr int BK = 64;          // bytes of K per chunk
constexpr int S_MAX_M = 64;     // kernel S takes M up to this
constexpr int L_BM = 128;       // kernel L's tile
constexpr int L_BN = 128;
constexpr int OUT_LD = L_BN + 8;  // staged output row, in bf16 (bank spread)

__device__ __forceinline__ float inv127() { return __int_as_float(0x3c010204); }  // fp32(1/127)
__device__ __forceinline__ float amax_floor() { return __int_as_float(0x358637bd); }  // fp32(1e-6)

__device__ __forceinline__ float bf16_bits_to_float(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));  // nearest, ties to even
}

// 8 bf16 of a row from k0 (zeros past K). vec: K % 8 == 0 and the rows are
// 16-byte aligned, so a group of 8 lies wholly inside or wholly past K.
__device__ __forceinline__ uint4 load_x8(const uint16_t* row, int k0, int K, bool vec) {
  if (vec) {
    if (k0 < K) return __ldg(reinterpret_cast<const uint4*>(row + k0));
    return make_uint4(0, 0, 0, 0);
  }
  uint32_t h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = (k0 + j < K) ? (uint32_t)__ldg(row + k0 + j) : 0u;
  return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                    h[6] | (h[7] << 16));
}

__device__ __forceinline__ float amax8(uint4 u, float m) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m = fmaxf(m, fabsf(bf16_bits_to_float(w[j] & 0xffffu)));
    m = fmaxf(m, fabsf(bf16_bits_to_float(w[j] >> 16)));
  }
  return m;
}

// the dynamic scales a of R rows at once (a null row gives 1), reduced over
// the warp; 8 16-byte loads per lane and row in flight (one round trip for
// K up to 2048)
template <int R>
__device__ __forceinline__ void row_scales(const uint16_t* const (&rows)[R], int K, bool vec,
                                           int lane, float (&a)[R]) {
  constexpr int U = 8, STEP = 32 * 8;
  float m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = 0.f;
  for (int k0 = lane * 8; k0 < K; k0 += U * STEP) {
    uint4 u[R][U];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < U; ++i)
        u[r][i] = rows[r] ? load_x8(rows[r], k0 + i * STEP, K, vec) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < U; ++i) m[r] = amax8(u[r][i], m[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
    a[r] = rows[r] ? __fmul_rn(fmaxf(m[r], amax_floor()), inv127()) : 1.f;
  }
}

// Rounding to an integer without the quarter-rate float-to-int unit:
// v + 1.5 * 2^23 rounds v (|v| <= 2^22) to the nearest integer, ties to
// even, into the low mantissa bits, whose low byte is then the int8 code
// in two's complement (the constant's low byte is 0).
constexpr float ROUND_MAGIC = 12582912.0f;

// static: clip(rint(v * ia), -127, 127), the clip taken first (the bounds
// are integers, so the order does not change the code)
__device__ __forceinline__ uint32_t code_static(float v, float ia) {
  const float t = fminf(fmaxf(__fmul_rn(v, ia), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(t, ROUND_MAGIC)) & 0xffu;
}

// dynamic: rint(v / a) with IEEE division. v * r, r = 1/a rounded, lies
// within 2.3e-5 of the rounded quotient (|v / a| <= 127.0001: two
// roundings of 2^-24 relative each, and the quotient's own half ulp), so
// where it is more than 1e-4 from a half-integer both round alike; nearer
// one, the quotient itself is taken.
__device__ __forceinline__ uint32_t code_dyn(float v, float a, float r) {
  const float d = __fmul_rn(v, r);
  float m = __fadd_rn(d, ROUND_MAGIC);
  if (fabsf(__fsub_rn(d, __fsub_rn(m, ROUND_MAGIC))) > 0.5f - 1e-4f)
    m = __fadd_rn(__fdiv_rn(v, a), ROUND_MAGIC);
  return __float_as_uint(m) & 0xffu;
}

// 8 bf16 (bits in u) -> 8 int8 codes packed little-endian in 2 words; a
// and r = 1/a: the row's dynamic scale; ia: inv_a[k0 .. k0 + 8) for static
// codes
template <bool STATIC>
__device__ __forceinline__ uint2 quant8(uint4 u, float a, float r, const float* ia) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float v = bf16_bits_to_float(j & 1 ? w[j >> 1] >> 16 : w[j >> 1] & 0xffffu);
    q[j] = STATIC ? code_static(v, ia[j]) : code_dyn(v, a, r);
  }
  // byte 0 of each of four words into one word, in order
  const auto pack = [](uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
    return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
  };
  return make_uint2(pack(q[0], q[1], q[2], q[3]), pack(q[4], q[5], q[6], q[7]));
}

template <bool STATIC>
__device__ __forceinline__ void load_inv_a8(const float* inv_a, int k0, float (&ia)[8]) {
  if (STATIC) {
    const float4 p = __ldg(reinterpret_cast<const float4*>(inv_a + k0));
    const float4 q = __ldg(reinterpret_cast<const float4*>(inv_a + k0 + 4));
    ia[0] = p.x; ia[1] = p.y; ia[2] = p.z; ia[3] = p.w;
    ia[4] = q.x; ia[5] = q.y; ia[6] = q.z; ia[7] = q.w;
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The two k32 products of one 64-byte chunk: w0 / w1 are bytes [16t, 16t+16)
// of output columns g and g + 8 of a 16-column fragment, xq those bytes of
// x row g of an 8-row fragment (A = weight, B = x^T, D[n][m]).
__device__ __forceinline__ void mma_chunk(int (&d)[4], const uint4& w0, const uint4& w1,
                                          const uint4& xq) {
  mma_s8(d, w0.x, w1.x, w0.y, w1.y, xq.x, xq.y);
  mma_s8(d, w0.z, w1.z, w0.w, w1.w, xq.z, xq.w);
}

template <bool STATIC>
__device__ __forceinline__ float epilogue(int acc, float scale, float a, const uint16_t* bias,
                                          int n) {
  const float f = __int2float_rn(acc);
  if (STATIC) {
    return bias ? __fmaf_rn(f, scale, bf16_bits_to_float(bias[n])) : __fmul_rn(f, scale);
  }
  const float p = __fmul_rn(f, scale);
  return bias ? __fmaf_rn(p, a, bf16_bits_to_float(bias[n])) : __fmul_rn(p, a);
}

struct Args {
  const uint16_t* x;
  const int8_t* wq;
  const float* scale;
  const uint16_t* bias;  // null: no bias
  const float* inv_a;    // null: dynamic codes
  uint16_t* out;
  int8_t* codes_out;     // null, or (M, Kp): the activation codes, for checks
  float* a_out;          // null, or (M,): the dynamic row scales, for checks
  int M, K, Kp, N;
  bool vec;
};

// ---------------------------------------------------------------- kernel S
// FM 8-row fragments (M <= 8 * FM), FN 16-column fragments per block. With
// CLUSTER, the blocks of a thread-block cluster share a column tile and
// split its K chunks, and their int32 sums meet in the first block's
// shared memory; without, a block owns its tile (a cluster's barrier and
// remote atomics cost ~1.3 us even for one block).
template <int FM, int FN, bool STATIC, bool CLUSTER>
__global__ void __launch_bounds__(NT) w8a8_small(Args p) {
  constexpr int BN = 16 * FN;
  constexpr int U = FM == 1 ? 4 : FM == 2 ? 2 : 1;  // chunks in flight per warp
  __shared__ float a_s[S_MAX_M], r_s[S_MAX_M], part_s[NW][S_MAX_M];
  __shared__ int acc_s[BN][8 * FM];
  const int cs = CLUSTER ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const auto sync = [] {
    if constexpr (CLUSTER) cg::this_cluster().sync(); else __syncthreads();
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / cs, n0 = tile * BN;
  const bool first = tile == 0;
  const int nch = p.Kp / BK, gw = rank * NW + warp, step = cs * NW;

  for (int i = threadIdx.x; i < BN * 8 * FM; i += NT) (&acc_s[0][0])[i] = 0;
  if (!STATIC) {
    // rows' amax: with fewer rows than warps, wpr warps share a row, each
    // over a slice of K (one round trip of loads for a decode token's row)
    const int wpr = p.M >= NW ? 1 : NW / p.M, rpp = NW / wpr, sl = warp % wpr;
    const int groups = (p.K + 7) >> 3, per = (groups + wpr - 1) / wpr;
    const int g0 = sl * per, g1 = min(groups, g0 + per);
    for (int m = warp / wpr; m < p.M; m += rpp) {
      const uint16_t* row = p.x + (size_t)m * p.K;
      float v = 0.f;
#pragma unroll 4
      for (int gi = g0 + lane; gi < g1; gi += 32) v = amax8(load_x8(row, gi * 8, p.K, p.vec), v);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) part_s[sl][m] = v;
    }
    __syncthreads();
    for (int m = threadIdx.x; m < p.M; m += NT) {
      float v = part_s[0][m];
      for (int j = 1; j < wpr; ++j) v = fmaxf(v, part_s[j][m]);
      const float a = __fmul_rn(fmaxf(v, amax_floor()), inv127());
      a_s[m] = a;
      r_s[m] = __frcp_rn(a);
      if (blockIdx.x == 0 && p.a_out) p.a_out[m] = a;
    }
  }
  sync();  // the row scales are in, and so are the first block's zeros

  int acc[FN][FM][4];
#pragma unroll
  for (int f = 0; f < FN; ++f)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[f][i][j] = 0;

  // this warp's chunks c0, c0 + step, ..., U at a time
  for (int c0 = gw; c0 < nch; c0 += step * U) {
    uint4 w[U][FN][2];
    uint4 xq[U][FM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * step;
      const int k0 = c * BK + 16 * t;
#pragma unroll
      for (int f = 0; f < FN; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 16 * f + 8 * h + g;
          w[u][f][h] = (c < nch && n < p.N)
              ? __ldg(reinterpret_cast<const uint4*>(p.wq + (size_t)n * p.Kp + k0))
              : make_uint4(0, 0, 0, 0);
        }
      float ia[16];
      if (STATIC && c < nch) {
        float lo[8], hi[8];
        load_inv_a8<STATIC>(p.inv_a, k0, lo);
        load_inv_a8<STATIC>(p.inv_a, k0 + 8, hi);
#pragma unroll
        for (int j = 0; j < 8; ++j) { ia[j] = lo[j]; ia[8 + j] = hi[j]; }
      }
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int m = 8 * i + g;
        xq[u][i] = make_uint4(0, 0, 0, 0);
        if (c < nch && m < p.M) {
          const uint16_t* row = p.x + (size_t)m * p.K;
          const float a = STATIC ? 0.f : a_s[m], r = STATIC ? 0.f : r_s[m];
          const uint2 q0 = quant8<STATIC>(load_x8(row, k0, p.K, p.vec), a, r, ia);
          const uint2 q1 = quant8<STATIC>(load_x8(row, k0 + 8, p.K, p.vec), a, r, ia + 8);
          xq[u][i] = make_uint4(q0.x, q0.y, q1.x, q1.y);
          if (first && p.codes_out)
            *reinterpret_cast<uint4*>(p.codes_out + (size_t)m * p.Kp + k0) = xq[u][i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int f = 0; f < FN; ++f)
#pragma unroll
        for (int i = 0; i < FM; ++i) mma_chunk(acc[f][i], w[u][f][0], w[u][f][1], xq[u][i]);
  }

  // D[n][m]: d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1),
  // added into the first block's sums over distributed shared memory
  int* sums = &acc_s[0][0];
  if constexpr (CLUSTER) sums = cg::this_cluster().map_shared_rank(sums, 0);
#pragma unroll
  for (int f = 0; f < FN; ++f)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = 8 * i + 2 * t + (j & 1);
        if (m < p.M) atomicAdd(sums + (16 * f + g + 8 * (j >> 1)) * (8 * FM) + m, acc[f][i][j]);
      }
  sync();  // every block's sums are in
  if (rank != 0) return;
  for (int i = threadIdx.x; i < BN * p.M; i += NT) {
    const int m = i / BN, nl = i % BN, n = n0 + nl;
    if (n < p.N) {
      const float y = epilogue<STATIC>(acc_s[nl][m], p.scale[n], STATIC ? 0.f : a_s[m],
                                       p.bias, n);
      p.out[(size_t)m * p.N + n] = float_to_bf16_bits(y);
    }
  }
}

// ---------------------------------------------------------------- kernel L
// Shared memory: L_STAGES stages of [weight chunk | bf16 x chunk | inv_a
// chunk], then one chunk of activation codes; the epilogue's bf16 tile
// reuses the stages.
constexpr int L_STAGES = 4;
constexpr int L_W_BYTES = L_BN * BK;          // 128 columns x 64 code bytes
constexpr int L_X_BYTES = L_BM * BK * 2;      // 128 rows x 64 bf16
constexpr int L_IA_BYTES = BK * 4;            // 64 fp32
constexpr int L_STAGE_BYTES = L_W_BYTES + L_X_BYTES + L_IA_BYTES;
constexpr int L_CODES_BYTES = L_BM * BK;
constexpr int L_SMEM = L_STAGES * L_STAGE_BYTES + L_CODES_BYTES;
static_assert(L_BM * OUT_LD * 2 <= L_STAGES * L_STAGE_BYTES, "epilogue tile");

__device__ __forceinline__ uint32_t saddr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

template <bool STATIC>
__global__ void __launch_bounds__(NT, 2) w8a8_large(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float a_s[L_BM], r_s[L_BM];
  int8_t* sc = reinterpret_cast<int8_t*>(smem + L_STAGES * L_STAGE_BYTES);  // [BM][BK] codes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // warp tile: rows 64 wm.., columns 32 wn..
  const int n0 = blockIdx.x * L_BN, m0 = blockIdx.y * L_BM;
  const bool first = blockIdx.x == 0;
  const int nch = p.Kp / BK;

  // chunk c into stage c % L_STAGES: 2 x 16 weight bytes, 4 x 8 bf16 of x
  // (by cp.async when rows are 16-byte aligned, else by plain loads) and,
  // static, 16 of the 64 inv_a values' bytes per thread of the first 16
  auto issue = [&](int c) {
    if (c >= nch) return;
    unsigned char* st = smem + (c % L_STAGES) * L_STAGE_BYTES;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = threadIdx.x + NT * q, row = j >> 2, n = n0 + row;
      const int8_t* src = p.wq + (size_t)(n < p.N ? n : 0) * p.Kp + c * BK + (j & 3) * 16;
      cp_async16(st + j * 16, src, n < p.N ? 16 : 0);
    }
    uint16_t* sx = reinterpret_cast<uint16_t*>(st + L_W_BYTES);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = threadIdx.x + NT * q, row = j >> 3, m = m0 + row, k0 = c * BK + (j & 7) * 8;
      if (p.vec) {
        const bool in = m < p.M && k0 < p.K;
        cp_async16(sx + j * 8, p.x + (in ? (size_t)m * p.K + k0 : 0), in ? 16 : 0);
      } else {
        const uint4 v = m < p.M ? load_x8(p.x + (size_t)m * p.K, k0, p.K, false)
                                : make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(sx + j * 8) = v;
      }
    }
    if (STATIC && threadIdx.x < L_IA_BYTES / 16)
      cp_async16(st + L_W_BYTES + L_X_BYTES + threadIdx.x * 16,
                 p.inv_a + c * BK + threadIdx.x * 4, 16);
  };

  // the first stages' loads fly while the rows' amax is taken
#pragma unroll
  for (int c = 0; c < L_STAGES - 1; ++c) {
    issue(c);
    cp_async_commit();
  }
  if (!STATIC) {
    // two rows per warp at a time: rows r and r + NW
    for (int r = warp; r < L_BM; r += 2 * NW) {
      const uint16_t* rows[2];
      float a[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = m0 + r + j * NW;
        rows[j] = m < p.M ? p.x + (size_t)m * p.K : nullptr;
      }
      row_scales<2>(rows, p.K, p.vec, lane, a);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int rr = r + j * NW, m = m0 + rr;
        if (lane == 0) {
          a_s[rr] = a[j];
          r_s[rr] = __frcp_rn(a[j]);
          if (first && p.a_out && m < p.M) p.a_out[m] = a[j];
        }
      }
    }
  }

  int acc[2][8][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[f][i][j] = 0;

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<L_STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();  // everyone's have, and chunk c - 1's products are done
    issue(c + L_STAGES - 1);  // into chunk c - 1's stage
    cp_async_commit();
    const unsigned char* st = smem + (c % L_STAGES) * L_STAGE_BYTES;
    const uint16_t* sx = reinterpret_cast<const uint16_t*>(st + L_W_BYTES);
    const float* sia = reinterpret_cast<const float*>(st + L_W_BYTES + L_X_BYTES);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = threadIdx.x + NT * q, row = j >> 3, m = m0 + row, kk = (j & 7) * 8;
      float ia[8];
      if (STATIC) {
        const float4 lo = *reinterpret_cast<const float4*>(sia + kk);
        const float4 hi = *reinterpret_cast<const float4*>(sia + kk + 4);
        ia[0] = lo.x; ia[1] = lo.y; ia[2] = lo.z; ia[3] = lo.w;
        ia[4] = hi.x; ia[5] = hi.y; ia[6] = hi.z; ia[7] = hi.w;
      }
      const uint2 v = quant8<STATIC>(*reinterpret_cast<const uint4*>(sx + j * 8),
                                     STATIC ? 0.f : a_s[row], STATIC ? 0.f : r_s[row], ia);
      *reinterpret_cast<uint2*>(sc + j * 8) = v;
      if (first && p.codes_out && m < p.M)
        *reinterpret_cast<uint2*>(p.codes_out + (size_t)m * p.Kp + c * BK + kk) = v;
    }
    __syncthreads();  // the codes are in
    const int8_t* bw = reinterpret_cast<const int8_t*>(st);
    uint4 w[2][2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[f][h] = *reinterpret_cast<const uint4*>(bw + (32 * wn + 16 * f + 8 * h + g) * BK +
                                                  16 * t);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint4 xq = *reinterpret_cast<const uint4*>(sc + (64 * wm + 8 * i + g) * BK + 16 * t);
#pragma unroll
      for (int f = 0; f < 2; ++f) mma_chunk(acc[f][i], w[f][0], w[f][1], xq);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: bf16 tile [BM][OUT_LD] in shared memory, then 16-byte rows
  uint16_t* so = reinterpret_cast<uint16_t*>(smem);
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 64 * wm + 8 * i + 2 * t + (j & 1);
        const int nl = 32 * wn + 16 * f + g + 8 * (j >> 1), n = n0 + nl;
        const float y = n < p.N ? epilogue<STATIC>(acc[f][i][j], p.scale[n],
                                                   STATIC ? 0.f : a_s[r], p.bias, n)
                                : 0.f;
        so[r * OUT_LD + nl] = float_to_bf16_bits(y);
      }
  __syncthreads();
  const bool vec_out = (p.N % 8) == 0;
  for (int j = threadIdx.x; j < L_BM * L_BN / 8; j += NT) {
    const int r = j >> 4, nl = (j & 15) * 8, m = m0 + r, n = n0 + nl;
    if (m >= p.M || n >= p.N) continue;
    const uint16_t* src = so + r * OUT_LD + nl;
    uint16_t* dst = p.out + (size_t)m * p.N + n;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < p.N; ++e) dst[e] = src[e];
    }
  }
}

// kernel S, in clusters of `cs` blocks along K where cs > 1 (only the
// narrow tiles split: a wide tile's N gives a wave of blocks already)
template <int FM, int FN, bool STATIC>
cudaError_t launch_small(const Args& a, int cs, cudaStream_t s) {
  const int tiles = (a.N + 16 * FN - 1) / (16 * FN);
  if constexpr (FN == 1) {
    if (cs > 1) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(tiles * cs);
      cfg.blockDim = dim3(NT);
      cfg.stream = s;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cs;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t err = cudaLaunchKernelEx(&cfg, w8a8_small<FM, 1, STATIC, true>, a);
      return err != cudaSuccess ? err : cudaGetLastError();
    }
  }
  w8a8_small<FM, FN, STATIC, false><<<tiles, NT, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool STATIC>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.M > S_MAX_M) {
    // above 48 KB, dynamic shared memory must be asked for
    const cudaError_t attr = cudaFuncSetAttribute(
        w8a8_large<STATIC>, cudaFuncAttributeMaxDynamicSharedMemorySize, L_SMEM);
    if (attr != cudaSuccess) return attr;
    dim3 grid((a.N + L_BN - 1) / L_BN, (a.M + L_BM - 1) / L_BM);
    w8a8_large<STATIC><<<grid, NT, L_SMEM, s>>>(a);
    return cudaGetLastError();
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // two 16-column fragments per block where that still gives a wave of
  // blocks; then up to 4 blocks per tile along K, enough that each warp
  // takes one round of U chunks, while the blocks fit two per SM
  const bool wide = a.N >= 32 * sms;
  const int fm = a.M <= 8 ? 1 : a.M <= 16 ? 2 : a.M <= 32 ? 4 : 8;
  const int u = fm == 1 ? 4 : fm == 2 ? 2 : 1;
  const int tiles = (a.N + (wide ? 32 : 16) - 1) / (wide ? 32 : 16);
  const int rounds = (a.Kp / BK + NW * u - 1) / (NW * u);
  int cs = 1;
  while (cs < 4 && cs < rounds && tiles * cs * 2 <= 2 * sms) cs *= 2;
  switch (fm * 2 + wide) {
    case 2: return launch_small<1, 1, STATIC>(a, cs, s);
    case 3: return launch_small<1, 2, STATIC>(a, cs, s);
    case 4: return launch_small<2, 1, STATIC>(a, cs, s);
    case 5: return launch_small<2, 2, STATIC>(a, cs, s);
    case 8: return launch_small<4, 1, STATIC>(a, cs, s);
    case 9: return launch_small<4, 2, STATIC>(a, cs, s);
    case 16: return launch_small<8, 1, STATIC>(a, cs, s);
    default: return launch_small<8, 2, STATIC>(a, cs, s);
  }
}

}  // namespace

// x (M, K) bf16 row-major; wq (N, Kp) int8; scale (N,) fp32; bias (N,) bf16
// or null; inv_a (Kp,) fp32 or null (dynamic codes); out (M, N) bf16;
// codes_out (M, Kp) int8 and a_out (M,) fp32 or null. Returns the launch's
// cudaError_t (0 on success).
extern "C" int w8a8_matmul_bf16(const void* x, const void* wq, const void* scale,
                                const void* bias, const void* inv_a, void* out,
                                void* codes_out, void* a_out, int M, int K, int Kp, int N,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || Kp < K || Kp % BK || Kp - K >= BK ||
      (M + L_BM - 1) / L_BM > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const uint16_t*>(x);
  a.wq = static_cast<const int8_t*>(wq);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const uint16_t*>(bias);
  a.inv_a = static_cast<const float*>(inv_a);
  a.out = static_cast<uint16_t*>(out);
  a.codes_out = static_cast<int8_t*>(codes_out);
  a.a_out = static_cast<float*>(a_out);
  a.M = M; a.K = K; a.Kp = Kp; a.N = N;
  a.vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(inv_a ? dispatch<true>(a, s) : dispatch<false>(a, s));
}
