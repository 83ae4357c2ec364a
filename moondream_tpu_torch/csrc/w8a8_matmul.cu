// w8a8 linear for Hopper (sm_90a): out (M, N) bf16 = the int8 product of
// x (M, K) bf16, quantized to int8 codes, with per-output-channel int8
// weight codes, and its fp32 epilogue.
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
//               up to K 133 000, so any order and any split of K gives the
//               same bits);
//   dynamic epilogue: y = fma(float(acc) * scale[n], a[m], b[n]);
//   static epilogue:  y = fma(float(acc), scale[n], b[n]);
//   out = bf16(y), rounded to nearest even.
// XLA on the CPU contracts the epilogue's tail to one fused multiply-add;
// __fmaf_rn is that operation. Build without --use_fast_math: the division
// must be IEEE. A row's bits depend on that row and the weight alone, on
// every route and at every M.
//
// Layout: wq is JAX's (K, N) codes transposed to (N, Kp), K zero-padded to
// a multiple of 64 (models' `pack_int8_weight`), so that both operands of
// the tensor-core products are K-contiguous. scale (N,) fp32, b (N,) bf16
// or null, inv_a (Kp,) fp32 (zero past K) or null for dynamic codes.
//
// Every call runs two kernels: the quantize pass, then one of two product
// kernels. The host plans the product kernel, its tile and its split
// (`kernels/quant.plan_w8a8`) and passes the plan in.
// - The quantize pass (`w8a8_quantize`): 1, 2, 4 or 8 warps per row of x
//   (as Kp needs) hold the row in registers from 16-byte loads, take its
//   amax (dynamic codes), and write its codes (M, Kp), zero past K, and
//   its scale a[m]. Each row is quantized once per call, whatever N is.
//   Bound by bytes: 2 K + Kp a row (ViT M 9984, K 1152: 34.5 MB, 10.3 us at
//   3.35 TB/s); at decode sizes by its launch and one round trip (~3 us).
// - Kernel L (`w8a8_large`, M > 32): int8 `wgmma` (m64nNk32, s32) over the
//   pass's codes. One producer warp keeps TMA loads of 128-byte K stages of
//   the codes (128 rows) and the weight (BN rows), 128-byte swizzled, in
//   flight in a ring of 3 or 4 stages (96 KB) completed on mbarriers; two
//   consumer warpgroups own 64 rows each and hold the int32 sums in
//   registers; two blocks share an SM, so that one's epilogue runs beside
//   the other's products. Tiles are 128 x 128 where they give a wave of
//   blocks, else 128 x 64; where those leave SMs idle, K is split across
//   the blocks of a thread-block cluster (the splits' int32 partials summed
//   in the first block from distributed shared memory, 16 bytes a load:
//   exact). The epilogue stages the bf16 tile in shared memory and leaves
//   in 16-byte stores (element by element where N % 8 != 0, as the 0.5B
//   ViT's N 2690). Bound by int8 operations at the ViT's M 9984 (qkv 79.5
//   GOP: 40.2 us at 1979 TOPS) and the image prefill's M 730 (qkv 9.3 us);
//   by the weight's bytes from M 33 to a few hundred. What holds it back
//   (PERF.md): the two blocks of an SM start together, so their first
//   stage's latency and their epilogues coincide; each 128 x 64 tile reads
//   its codes again from L2 (32 times at the prefill's proj and fc2); and
//   the last wave of a 2.7-wave grid (the ViT's proj) runs a third full. A
//   persistent or stream-K schedule and TMA multicast of the codes across a
//   cluster are later work.
// - Kernel S (`w8a8_small`, M <= 32): a thread-block cluster of 1, 2 or 4
//   blocks owns 16 or 32 output columns and every row; its warps split K
//   into 64-byte chunks (up to 4 in flight each), load their weight chunks
//   and the rows' codes straight into registers with 16-byte loads and
//   multiply with mma.sync.m16n8k32; the int32 sums meet in the cluster's
//   first block by integer atomics over distributed shared memory. Bound by
//   the weight's bytes (2B text qkv: 12.6 MB, 3.76 us at 3.35 TB/s).
// The product kernels are launched as programmatic dependents of the pass:
// they issue their first weight loads (kernel S: its warps' first round of
// chunks; kernel L: a ring of weight stages by TMA) before they wait for
// the pass's codes (griddepcontrol.wait), so the weight stream overlaps the
// pass. Measured on the H100 (PERF.md): at M 1 to 8 the pass and kernel S
// beat a single launch that quantizes inside every block (2B fc2 at M 1,
// weights cold in L2: 12.6 against 17.5 us), so every M takes the pass;
// kernel S beats kernel L up to M 32, kernel L from M 64.
// The codes are rounded with a float add (see ROUND_MAGIC), not the
// quarter-rate float-to-int unit; a dynamic code takes a product with the
// row's reciprocal scale, and the IEEE quotient only next to a tie. Host
// work per call: the plan is cached in Python, the SM count read once per
// device, each kernel instance's shared-memory attribute set once per
// device, and kernel L's two tensor maps encoded on the host.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and the encoder's types; libcuda is reached by dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 8;           // warps per block (the pass, kernel S)
constexpr int NT = 32 * NW;     // threads per block
constexpr int BK = 64;          // bytes of K per chunk (kernel S; Kp's multiple)
constexpr int S_MAX_M = 32;     // kernel S takes M up to this

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

// y before its bf16 rounding; b: the bias, as fp32, where has_b
template <bool STATIC>
__device__ __forceinline__ float epilogue(int acc, float scale, float a, float b, bool has_b) {
  const float f = __int2float_rn(acc);
  if (STATIC) return has_b ? __fmaf_rn(f, scale, b) : __fmul_rn(f, scale);
  const float p = __fmul_rn(f, scale);
  return has_b ? __fmaf_rn(p, a, b) : __fmul_rn(p, a);
}

// Programmatic dependent launch: the product kernels are launched while the
// quantize pass runs (cudaLaunchAttributeProgrammaticStreamSerialization),
// read the weight, which does not depend on it, and wait for the pass's
// codes with pdl_wait(); the pass lets them launch as soon as each of its
// blocks has started. Without the attribute pdl_wait() returns at once.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------- quantize pass
// W warps per row (1, 2, 4 or 8), NW / W rows per block: lane l of warp w
// of a row holds the groups of 8 values from (32 w + l) * 8, W * 256 apart,
// PASS_U of them, in registers, so a row of Kp <= W * 1024 values is read
// once (the host picks W so; a longer row is read again for its codes).
// Writes the row's codes (M, Kp), zero past K, and, dynamic, its scale.
constexpr int PASS_U = 4;

template <bool STATIC, int W>
__global__ void __launch_bounds__(NT) w8a8_quantize(const uint16_t* __restrict__ x,
                                                    const float* __restrict__ inv_a,
                                                    int8_t* __restrict__ codes,
                                                    float* __restrict__ a_out, int M, int K,
                                                    int Kp, bool vec) {
  constexpr int R = NW / W, STEP = W * 32 * 8, SPAN = PASS_U * STEP;
  __shared__ float part_s[NW];
  pdl_launch_dependents();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rl = warp / W, wr = warp % W;  // row of the block, warp of the row
  const int m = blockIdx.x * R + rl;
  const bool live = m < M;
  const uint16_t* row = x + (size_t)(live ? m : 0) * K;
  const int k0 = (wr * 32 + lane) * 8;
  uint4 u[PASS_U];
  const auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < PASS_U; ++i)
      u[i] = live ? load_x8(row, base + k0 + i * STEP, K, vec) : make_uint4(0, 0, 0, 0);
  };
  load(0);
  float a = 0.f, r = 0.f;
  if (!STATIC) {
    float v = 0.f;
    for (int base = 0;;) {
#pragma unroll
      for (int i = 0; i < PASS_U; ++i) v = amax8(u[i], v);
      base += SPAN;
      if (base >= Kp) break;
      load(base);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if constexpr (W > 1) {
      if (lane == 0) part_s[warp] = v;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < W; ++j) v = fmaxf(v, part_s[rl * W + j]);
    }
    a = __fmul_rn(fmaxf(v, amax_floor()), inv127());
    r = __frcp_rn(a);
    if (live && wr == 0 && lane == 0) a_out[m] = a;
  }
  if (!live) return;
  int8_t* crow = codes + (size_t)m * Kp;
  for (int base = 0; base < Kp; base += SPAN) {
    if (base > 0 || (!STATIC && Kp > SPAN)) load(base);
#pragma unroll
    for (int i = 0; i < PASS_U; ++i) {
      const int k = base + k0 + i * STEP;
      if (k < Kp) {
        float ia[8];
        load_inv_a8<STATIC>(inv_a, k, ia);
        *reinterpret_cast<uint2*>(crow + k) = quant8<STATIC>(u[i], a, r, ia);
      }
    }
  }
}

// ---------------------------------------------------------------- kernel S
struct SmallArgs {
  const int8_t* codes;   // the pass's codes (M, Kp)
  const float* a;        // dynamic: the pass's row scales (M,); static: null
  const int8_t* wq;
  const float* scale;
  const uint16_t* bias;  // null: no bias
  uint16_t* out;
  int M, Kp, N;
};

// chunks in flight per warp, by 8-row fragments
__host__ __device__ constexpr int small_chunks(int fm) { return fm == 1 ? 4 : fm == 2 ? 2 : 1; }

// FM 8-row fragments (M <= 8 * FM), FN 16-column fragments per block. With
// CLUSTER, the blocks of a thread-block cluster share a column tile and
// split its K chunks, and their int32 sums meet in the first block's
// shared memory; without, a block owns its tile (a cluster's barrier and
// remote atomics cost ~1.3 us even for one block).
template <int FM, int FN, bool STATIC, bool CLUSTER>
__global__ void __launch_bounds__(NT) w8a8_small(SmallArgs p) {
  constexpr int BN = 16 * FN;
  constexpr int U = small_chunks(FM);
  __shared__ float a_s[S_MAX_M];
  __shared__ int acc_s[BN][8 * FM];
  const int cs = CLUSTER ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const auto sync = [] {
    if constexpr (CLUSTER) cg::this_cluster().sync(); else __syncthreads();
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / cs, n0 = tile * BN;
  const int nch = p.Kp / BK, gw = rank * NW + warp, step = cs * NW;

  // this warp's chunks c0, c0 + step, ..., U at a time: bytes [16t, 16t +
  // 16) of weight columns g and g + 8 of each fragment and of code row g
  uint4 w[U][FN][2];
  const auto load_w = [&](int c0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * step;
#pragma unroll
      for (int f = 0; f < FN; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 16 * f + 8 * h + g;
          w[u][f][h] = (c < nch && n < p.N)
              ? __ldg(reinterpret_cast<const uint4*>(p.wq + (size_t)n * p.Kp + c * BK + 16 * t))
              : make_uint4(0, 0, 0, 0);
        }
    }
  };
  load_w(gw);  // the first round's weights fly while the pass finishes
  for (int i = threadIdx.x; i < BN * 8 * FM; i += NT) (&acc_s[0][0])[i] = 0;
  pdl_wait();  // the pass's codes and row scales are in
  if (!STATIC)
    for (int m = threadIdx.x; m < p.M; m += NT) a_s[m] = p.a[m];
  sync();  // the first block's zeros are in

  int acc[FN][FM][4];
#pragma unroll
  for (int f = 0; f < FN; ++f)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[f][i][j] = 0;

  for (int c0 = gw; c0 < nch; c0 += step * U) {
    if (c0 != gw) load_w(c0);
    uint4 xq[U][FM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * step;
      const int k0 = c * BK + 16 * t;
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int m = 8 * i + g;
        xq[u][i] = (c < nch && m < p.M)
            ? __ldg(reinterpret_cast<const uint4*>(p.codes + (size_t)m * p.Kp + k0))
            : make_uint4(0, 0, 0, 0);
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
      const float b = p.bias ? bf16_bits_to_float(p.bias[n]) : 0.f;
      const float y = epilogue<STATIC>(acc_s[nl][m], p.scale[n], STATIC ? 0.f : a_s[m], b,
                                       p.bias != nullptr);
      p.out[(size_t)m * p.N + n] = float_to_bf16_bits(y);
    }
  }
}

// ---------------------------------------------------------------- kernel L
constexpr int L_BM = 128;             // rows per block: two consumer warpgroups of 64
constexpr int L_BK = 128;             // bytes of K per stage: one 128-byte swizzle row
constexpr int L_NT = 288;             // warpgroups 0-1 consume, warp 8 produces
constexpr int L_CONSUMER_WARPS = 8;
constexpr int L_BLOCKS_PER_SM = 2;    // one block's epilogue runs beside the other's products
constexpr int L_RING = 96 * 1024;     // bytes of stages

template <int BN>
struct LTile {
  static constexpr int A_BYTES = L_BM * L_BK;
  static constexpr int STAGE = A_BYTES + BN * L_BK;
  static constexpr int STAGES = L_RING / STAGE;  // 3 (BN 128) or 4 (BN 64)
  static constexpr int OUT_LD = BN + 8;           // staged output row, bf16 (bank spread)
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + slack for 1024-byte alignment
  static_assert(L_BM * OUT_LD * 2 <= STAGES * STAGE, "output tile");
  static_assert(BN / 2 * 4 * 256 <= STAGES * STAGE, "split partials");
};

struct LargeArgs {
  const float* a;        // dynamic: the pass's row scales (M,); static: null
  const float* scale;
  const uint16_t* bias;  // null: no bias
  uint16_t* out;
  int M, N;
  int nst;               // 128-byte K stages of Kp
  int split_st;          // stages per split of K (the last may hold fewer)
};

__device__ __forceinline__ uint32_t saddr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 2-D (K bytes, rows) map into shared memory, completing
// on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(k), "r"(row)
      : "memory");
}

// A `wgmma` shared-memory descriptor of a K-major tile of 128-byte rows,
// 128-byte swizzled as TMA wrote it: 8-row groups 1024 bytes apart (the
// tile's base 1024-byte aligned; a K step of 32 bytes adds 32 to the
// start address, inside the swizzle atom).
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  return static_cast<uint64_t>((saddr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tell the compiler these registers may change here: keeps reads of an
// accumulator after the wait that completes it.
template <int N>
__device__ __forceinline__ void reg_fence(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, s32) += A (64 x 32 s8, shared, K-major) B (64 x 32 s8, shared, K-major)
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, s32) += A (64 x 32 s8, shared, K-major) B (128 x 32 s8, shared, K-major)
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_s8_n64(d, da, db);
  else wgmma_s8_n128(d, da, db);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {  // the two consumer warpgroups alone
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Grid (N / BN, M / 128, splits), clusters of (1, 1, splits) when K is
// split. Block (x, y, z) owns output tile (y, x) and the K stages [z *
// split_st, (z + 1) * split_st) of it; the cluster's first block sums the
// others' int32 partials and writes the tile.
template <int BN, bool STATIC>
__global__ void __launch_bounds__(L_NT, L_BLOCKS_PER_SM) w8a8_large(const __grid_constant__ CUtensorMap x_map,
                                                       const __grid_constant__ CUtensorMap w_map,
                                                       LargeArgs p) {
  using T = LTile<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES];
  // the epilogue's scale[n], b[n] and a[m] of this tile
  __shared__ float scale_s[BN], bias_s[BN], a_s[L_BM];
  // 128-byte swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * L_BM;
  const bool split = gridDim.z > 1;
  const int st0 = blockIdx.z * p.split_st;
  const int nk = min(p.nst - st0, p.split_st);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x == 256) {
      // the first ring-full of weight stages flies while the pass finishes
      const int pre = min(nk, T::STAGES);
      for (int i = 0; i < pre; ++i) {
        mbar_expect_tx(&full[i], T::STAGE);
        tma_load(smem + i * T::STAGE + T::A_BYTES, &w_map, &full[i], (st0 + i) * L_BK, n0);
      }
      pdl_wait();  // the pass's codes are in
      for (int i = 0; i < nk; ++i) {
        const int s = i % T::STAGES, round = i / T::STAGES;
        unsigned char* st = smem + s * T::STAGE;
        const int k = (st0 + i) * L_BK;
        if (i >= pre) {
          mbar_wait(&empty[s], (round - 1) & 1);
          mbar_expect_tx(&full[s], T::STAGE);
          tma_load(st + T::A_BYTES, &w_map, &full[s], k, n0);
        }
        tma_load(st, &x_map, &full[s], k, m0);
      }
    }
    if (split) {  // the consumers' two cluster barriers
      __syncwarp();
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int ct = threadIdx.x;  // 0..255
  // the epilogue's parameters, while the first stages load
  pdl_wait();  // the pass's row scales are in
  for (int j = ct; j < BN; j += 256) {
    const int n = n0 + j;
    scale_s[j] = n < p.N ? p.scale[n] : 0.f;
    bias_s[j] = n < p.N && p.bias ? bf16_bits_to_float(p.bias[n]) : 0.f;
  }
  if (!STATIC)
    for (int j = ct; j < L_BM; j += 256) a_s[j] = m0 + j < p.M ? p.a[m0 + j] : 0.f;
  const int lane = threadIdx.x & 31;
  int acc[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) acc[r] = 0;

  for (int i = 0; i < nk; ++i) {
    const int s = i % T::STAGES;
    mbar_wait(&full[s], (i / T::STAGES) & 1);
    const unsigned char* sa = smem + s * T::STAGE + wg * 64 * L_BK;
    const unsigned char* sb = smem + s * T::STAGE + T::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L_BK / 32; ++kk)
      wgmma_s8<BN>(acc, smem_desc_sw128(sa + 32 * kk), smem_desc_sw128(sb + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free its slot
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % T::STAGES]);
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);
  consumers_sync();  // both warpgroups are done with the ring; the parameters are in

  if (split) {
    // partial sums [register / 4][thread] as int4, so that a warp's 16-byte
    // reads and writes are contiguous
    int4* part = reinterpret_cast<int4*>(smem);
    uint32_t rank;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
    if (rank != 0) {
#pragma unroll
      for (int q = 0; q < BN / 8; ++q)
        part[q * 256 + ct] = make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    cluster_sync();  // every partial is in
    if (rank == 0) {
      for (int src = 1; src < (int)gridDim.z; ++src) {
        const int4* rp = cg::this_cluster().map_shared_rank(part, src);
        int4 v[BN / 8];
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) v[q] = rp[q * 256 + ct];
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          acc[4 * q] += v[q].x;
          acc[4 * q + 1] += v[q].y;
          acc[4 * q + 2] += v[q].z;
          acc[4 * q + 3] += v[q].w;
        }
      }
    }
    cluster_sync();  // the first block has read them all
    if (rank != 0) return;
  }

  // Epilogue: this thread holds rows r0 and r0 + 8 of its warpgroup's 64
  // (warp w of the warpgroup owns rows 16w..16w+15, lane l rows l/4 and
  // l/4 + 8), columns 8i + 2(l%4) and the next of each n8 block i; the bf16
  // tile is staged [128][OUT_LD] in shared memory, then leaves by rows.
  uint16_t* so = reinterpret_cast<uint16_t*>(smem);
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + g;
  const bool has_b = p.bias != nullptr;
  const float a_r[2] = {a_s[r0], a_s[r0 + 8]};
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint16_t v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = float_to_bf16_bits(epilogue<STATIC>(acc[4 * i + 2 * h + e], scale_s[col + e],
                                                   a_r[h], bias_s[col + e], has_b));
      *reinterpret_cast<uint32_t*>(so + (r0 + 8 * h) * T::OUT_LD + col) =
          v[0] | ((uint32_t)v[1] << 16);
    }
  }
  consumers_sync();
  constexpr int CPR = BN / 8;  // 16-byte chunks per row
  const bool vec_out = (p.N % 8) == 0;
  for (int j = ct; j < L_BM * CPR; j += 256) {
    const int r = j / CPR, c = (j % CPR) * 8, m = m0 + r, n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    const uint16_t* src = so + r * T::OUT_LD + c;
    uint16_t* dst = p.out + (size_t)m * p.N + n;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < p.N; ++e) dst[e] = src[e];
    }
  }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the process (PyTorch) has
// loaded, so that the library links against the runtime alone.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A (rows, Kp) int8 matrix, read in boxes of 128 bytes x `box_rows`,
// 128-byte swizzled; rows and bytes past the matrix read as zeros.
bool encode(CUtensorMap* map, const void* base, int rows, int Kp, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint32_t box[2] = {(cuuint32_t)L_BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// a launch after the quantize pass on stream s: it may start while the
// pass runs (programmatic dependent launch), in clusters of `cluster`
// blocks along dimension `axis` (0 = x, 2 = z) where cluster > 1
struct DependentLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  DependentLaunch(dim3 grid, int threads, size_t smem, cudaStream_t s, int cluster, int axis) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = axis == 0 ? cluster : 1;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = axis == 2 ? cluster : 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 2 : 1;
  }
};

template <int BN, bool STATIC>
cudaError_t launch_large(const CUtensorMap& xm, const CUtensorMap& wm, const LargeArgs& a,
                         int splits, int dev, cudaStream_t s) {
  // above 48 KB, dynamic shared memory must be asked for: once per device
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_large<BN, STATIC>, cudaFuncAttributeMaxDynamicSharedMemorySize, LTile<BN>::SMEM);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_acq_rel);
  }
  DependentLaunch l(dim3((a.N + BN - 1) / BN, (a.M + L_BM - 1) / L_BM, splits), L_NT,
                    LTile<BN>::SMEM, s, splits, 2);
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, w8a8_large<BN, STATIC>, xm, wm, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// kernel S, in clusters of `cs` blocks along K where cs > 1 (only the
// narrow tiles split: a wide tile's N gives a wave of blocks already)
template <int FM, int FN, bool STATIC>
cudaError_t launch_small(const SmallArgs& a, int cs, cudaStream_t s) {
  const int tiles = (a.N + 16 * FN - 1) / (16 * FN);
  cudaError_t err;
  if constexpr (FN == 1) {
    if (cs > 1) {
      DependentLaunch l(dim3(tiles * cs), NT, 0, s, cs, 0);
      err = cudaLaunchKernelEx(&l.cfg, w8a8_small<FM, 1, STATIC, true>, a);
      return err != cudaSuccess ? err : cudaGetLastError();
    }
  }
  DependentLaunch l(dim3(tiles), NT, 0, s, 1, 0);
  err = cudaLaunchKernelEx(&l.cfg, w8a8_small<FM, FN, STATIC, false>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int FM, bool STATIC>
cudaError_t launch_small_fn(const SmallArgs& a, int fn, int cs, cudaStream_t s) {
  return fn == 1 ? launch_small<FM, 1, STATIC>(a, cs, s) : launch_small<FM, 2, STATIC>(a, cs, s);
}

template <bool STATIC>
cudaError_t dispatch_small(const SmallArgs& a, int fm, int fn, int cs, cudaStream_t s) {
  switch (fm) {
    case 1: return launch_small_fn<1, STATIC>(a, fn, cs, s);
    case 2: return launch_small_fn<2, STATIC>(a, fn, cs, s);
    case 4: return launch_small_fn<4, STATIC>(a, fn, cs, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The quantize pass: x (M, K) bf16 row-major -> codes (M, Kp) int8 (zero
// past K) and, for dynamic codes (inv_a null), the row scales a (M,) fp32;
// static codes take inv_a (Kp,) fp32. Returns the launch's cudaError_t.
extern "C" int w8a8_quantize_bf16(const void* x, const void* inv_a, void* codes, void* a,
                                  int M, int K, int Kp, void* stream) {
  if (M <= 0 || K <= 0 || Kp < K || Kp % BK || Kp - K >= BK || (!inv_a && !a) ||
      !aligned16(codes) || (inv_a && !aligned16(inv_a)))
    return (int)cudaErrorInvalidValue;
  const bool vec = (K % 8 == 0) && aligned16(x);
  const int w = Kp <= 1024 ? 1 : Kp <= 2048 ? 2 : Kp <= 4096 ? 4 : 8;  // warps per row
  const int grid = (M + NW / w - 1) / (NW / w);
  const uint16_t* xp = static_cast<const uint16_t*>(x);
  const float* ia = static_cast<const float*>(inv_a);
  int8_t* cp = static_cast<int8_t*>(codes);
  float* ap = static_cast<float*>(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel) { kernel<<<grid, NT, 0, s>>>(xp, ia, cp, ap, M, K, Kp, vec); };
  switch (w * 2 + (inv_a != nullptr)) {
    case 2: go(w8a8_quantize<false, 1>); break;
    case 3: go(w8a8_quantize<true, 1>); break;
    case 4: go(w8a8_quantize<false, 2>); break;
    case 5: go(w8a8_quantize<true, 2>); break;
    case 8: go(w8a8_quantize<false, 4>); break;
    case 9: go(w8a8_quantize<true, 4>); break;
    case 16: go(w8a8_quantize<false, 8>); break;
    default: go(w8a8_quantize<true, 8>); break;
  }
  return (int)cudaGetLastError();
}

// Kernel S (M <= 32) over the pass's codes (M, Kp) int8 and, dynamic, its
// row scales a (M,) fp32 (static: null); wq (N, Kp) int8; scale (N,)
// fp32; bias (N,) bf16 or null; out (M, N) bf16. The plan: fm 8-row
// fragments (1, 2 or 4; M <= 8 fm), fn 16-column fragments per block (1
// or 2), cs blocks per cluster along K (1, 2 or 4; fn 1 only).
extern "C" int w8a8_small_bf16(const void* codes, const void* a, const void* wq,
                               const void* scale, const void* bias, void* out, int M, int Kp,
                               int N, int is_static, int fm, int fn, int cs, void* stream) {
  if (M <= 0 || M > S_MAX_M || M > 8 * fm || N <= 0 || Kp <= 0 || Kp % BK ||
      (fn != 1 && fn != 2) || (cs != 1 && cs != 2 && cs != 4) || (cs > 1 && fn != 1) ||
      (!is_static && !a) || !aligned16(codes) || !aligned16(wq))
    return (int)cudaErrorInvalidValue;
  SmallArgs p;
  p.codes = static_cast<const int8_t*>(codes);
  p.a = is_static ? nullptr : static_cast<const float*>(a);
  p.wq = static_cast<const int8_t*>(wq);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const uint16_t*>(bias);
  p.out = static_cast<uint16_t*>(out);
  p.M = M; p.Kp = Kp; p.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_static ? dispatch_small<true>(p, fm, fn, cs, s)
                         : dispatch_small<false>(p, fm, fn, cs, s));
}

// Kernel L (M > 32) over the pass's codes (M, Kp) int8 and, dynamic, its
// row scales a (M,) fp32 (static: null); wq (N, Kp) int8; scale (N,) fp32;
// bias (N,) bf16 or null; out (M, N) bf16. The plan: tile width bn (64 or
// 128), `splits` blocks per cluster along K (1 to 8) of `split_st`
// 128-byte stages each (the last may hold fewer, none empty). `dev`: the
// CUDA device's index, for the once-per-device shared-memory attribute.
extern "C" int w8a8_large_bf16(const void* codes, const void* a, const void* wq,
                               const void* scale, const void* bias, void* out, int M, int Kp,
                               int N, int is_static, int bn, int splits, int split_st, int dev,
                               void* stream) {
  const int nst = (Kp + L_BK - 1) / L_BK;
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % BK || splits < 1 || splits > 8 || split_st < 1 ||
      (splits - 1) * split_st >= nst || splits * split_st < nst ||
      (M + L_BM - 1) / L_BM > 65535 || (!is_static && !a) || !aligned16(codes) ||
      !aligned16(wq) || !aligned16(out) || dev < 0 || (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  if (!encode(&xm, codes, M, Kp, L_BM) || !encode(&wm, wq, N, Kp, bn))
    return (int)cudaErrorInvalidValue;
  LargeArgs p;
  p.a = is_static ? nullptr : static_cast<const float*>(a);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const uint16_t*>(bias);
  p.out = static_cast<uint16_t*>(out);
  p.M = M; p.N = N;
  p.nst = nst;
  p.split_st = split_st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bn * 2 + (is_static != 0)) {
    case 128: err = launch_large<64, false>(xm, wm, p, splits, dev, s); break;
    case 129: err = launch_large<64, true>(xm, wm, p, splits, dev, s); break;
    case 256: err = launch_large<128, false>(xm, wm, p, splits, dev, s); break;
    case 257: err = launch_large<128, true>(xm, wm, p, splits, dev, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
