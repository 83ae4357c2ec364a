// Decode / short-span attention over ONE layer of the stacked KV cache, for
// Hopper (sm_90a), bf16 queries and output, over a bf16 cache or an int8
// cache with fp32 per-token scales.
//
// Replaces the Pallas kernel `_decode_kernel_stacked`
// (moondream_tpu/ops/attention.py, called from `decode_attention_cached`),
// and computes the non-ragged, unshared function of `_decode_kernel_paired`
// (the TPU's default decode kernel), bf16 and int8, on the plain
// (L, B, H, T, D) cache layout. Query row i (i < Tq <= 16) sits at position
// pos + i and attends column c under the unified mask
//     c <= pos + i  OR  (pos + i < prefix AND c < prefix).
// The layer is chosen by a runtime int and addressed from strides: the cache
// is never sliced or copied (attention.py:510-518). Reads are bounded by
// `tk` (kv_bound rounded up to 128, capped at T), and further by the last
// column any row may attend, so stale slots past pos (earlier sessions,
// prompt padding) are neither read nor able to move the row max.
//
// bf16 numerics follow `_decode_kernel_stacked`: fp32 scores scaled after
// the dot, max over masked scores, p = exp(s - m) / sum in fp32, rounded to
// bf16, then PV accumulated in fp32.
//
// int8 numerics follow `_decode_kernel_paired`'s int8 branch
// (attention.py:677-692, 756-767): the cache holds codes with x ~ code *
// scale, one fp32 scale per token per group of `g` adjacent heads, stored
// (L, B, H/g, T); head h reads scale row h / g. Attention is linear in each
// token row's scale, so the k-scale folds into the score,
// s = (q . code_k) * (k_scale * 1/sqrt(D)); max, exp and the denominator
// are taken over the unscaled probabilities; p * v_scale is rounded to bf16
// and multiplied by code_v in fp32; the sum is divided by the denominator.
//
// What bounds it on the H100: one decode step reads ncols * D * 2 * e bytes
// of K and V per (batch, head) (e = 2 for bf16, 1 for int8, plus 8 bytes of
// scales per column and scale row) for 4 * Tq * ncols * D flops, ~Tq flops
// per byte, far below the ~295 flop/byte ridge, so it is bound by memory
// and, at batch 1 with 32 heads (32 blocks on 132 SMs), by the latency of
// those reads. The design reads each K and V row exactly once with 16-byte
// (K) and 4- or 2-byte coalesced (V) loads, keeps scores and probabilities
// in shared memory (no device-memory round trip, one launch per layer), and
// skips every column past the last attendable one. Split-K across blocks
// for more SMs per head is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int MAXQ = 16;
constexpr float NEG = -1e30f;

__device__ __forceinline__ bool attends(int c, int qp, int prefix) {
  return c <= qp || (qp < prefix && c < prefix);
}

// 16 bytes of a cache row as floats: 8 bf16 or 16 int8 values.
template <typename T>
struct Row16 {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float (&f)[N]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = __bfloat1622float2(p2[j]);
        f[2 * j] = v.x;
        f[2 * j + 1] = v.y;
      }
    } else {
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 16; ++j) f[j] = (float)b[j];
    }
  }
};

// Two adjacent values of a cache row as floats.
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

// head_dim D <= 64 (the text model's in both configs): in the PV phase
// each lane owns one pair of D. T is bf16 (ks/vs unused) or int8_t.
template <typename T>
__global__ void __launch_bounds__(NT) decode_attn_stacked_kernel(
    const bf16* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, bf16* __restrict__ o, int B, int H, int T_,
    int D, int Tq, int layer, int ncols, int g, long long q_sb, long long q_sh,
    long long q_st, long long o_sb, long long o_sh, long long o_st, int pos,
    int prefix, float scale) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int CH = Row16<T>::N;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                  // [Tq][D] query rows in fp32
  float* sden = smem + Tq * D;       // [MAXQ] softmax denominators (int8)
  float* sS = sden + MAXQ;           // [Tq][ncols] scores, then probabilities

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const long long head = (((long long)layer * B + b) * H + h) * (long long)T_ * D;
  const T* kb = kc + head;
  const T* vb = vc + head;
  const bf16* qb = q + b * q_sb + h * q_sh;
  // int8: this head's scale rows, (L, B, H/g, T)
  const long long srow = (((long long)layer * B + b) * (H / g) + h / g) * (long long)T_;
  const float* ksr = INT8 ? ks + srow : nullptr;
  const float* vsr = INT8 ? vs + srow : nullptr;

  for (int i = tid; i < Tq * D; i += NT)
    sq[i] = __bfloat162float(qb[(long long)(i / D) * q_st + i % D]);
  __syncthreads();

  // Phase 1: one column per thread, the whole K row in 16-byte loads.
  for (int c = tid; c < ncols; c += NT) {
    float acc[MAXQ];
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) acc[r] = 0.f;
    const T* kr = kb + (long long)c * D;
    for (int d0 = 0; d0 < D; d0 += CH) {
      float kf[CH];
      Row16<T>::load(kr + d0, kf);
#pragma unroll
      for (int r = 0; r < MAXQ; ++r) {
        if (r < Tq) {
          const float* qr = sq + r * D + d0;
#pragma unroll
          for (int j = 0; j < CH; ++j) acc[r] += qr[j] * kf[j];
        }
      }
    }
    const float cs = INT8 ? ksr[c] * scale : scale;
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) {
      if (r < Tq)
        sS[r * ncols + c] = attends(c, pos + r, prefix) ? acc[r] * cs : NEG;
    }
  }
  __syncthreads();

  // Phase 2: masked softmax, one warp per row.
  for (int r = warp; r < Tq; r += NWARP) {
    float* row = sS + r * ncols;
    const int qp = pos + r;
    float mx = NEG;
    for (int c = lane; c < ncols; c += 32)
      if (attends(c, qp, prefix)) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float p = attends(c, qp, prefix) ? expf(row[c] - mx) : 0.f;
      row[c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if constexpr (INT8) {
      // fold the v-scales into the unnormalised weights; divide at the end
      for (int c = lane; c < ncols; c += 32)
        row[c] = __bfloat162float(__float2bfloat16(row[c] * vsr[c]));
      if (lane == 0) sden[r] = sum;
    } else {
      const float inv = sum == 0.f ? 0.f : 1.f / sum;
      for (int c = lane; c < ncols; c += 32)
        row[c] = __bfloat162float(__float2bfloat16(row[c] * inv));
    }
  }
  __syncthreads();

  // Phase 3: O = P V. Warps split the columns, lanes split D in pairs.
  const int d = 2 * lane;
  float acc[MAXQ][2];
#pragma unroll
  for (int r = 0; r < MAXQ; ++r) acc[r][0] = acc[r][1] = 0.f;
  if (d < D) {
    for (int c = warp; c < ncols; c += NWARP) {
      const float2 f = load_pair(vb + (long long)c * D + d);
#pragma unroll
      for (int r = 0; r < MAXQ; ++r) {
        if (r < Tq) {
          const float p = sS[r * ncols + c];
          acc[r][0] += p * f.x;
          acc[r][1] += p * f.y;
        }
      }
    }
  }
  __syncthreads();  // everyone is done reading sS: reuse it for the reduction

  float* red = sS;  // [NWARP][Tq][D]
  if (d < D) {
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) {
      if (r < Tq) {
        red[(warp * Tq + r) * D + d] = acc[r][0];
        red[(warp * Tq + r) * D + d + 1] = acc[r][1];
      }
    }
  }
  __syncthreads();

  bf16* ob = o + b * o_sb + h * o_sh;
  for (int i = tid; i < Tq * D; i += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += red[w * Tq * D + i];
    if constexpr (INT8) {
      const float den = sden[i / D];
      s = den == 0.f ? 0.f : s / den;
    }
    ob[(long long)(i / D) * o_st + i % D] = __float2bfloat16(s);
  }
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scale, const void* v_scale, void* o, int L, int B,
           int H, int T_, int D, int Tq, int layer, int tk, int g,
           long long q_sb, long long q_sh, long long q_st, long long o_sb,
           long long o_sh, long long o_st, int pos, int prefix, float scale,
           void* stream) {
  constexpr int CH = Row16<T>::N;
  if (L <= 0 || B <= 0 || H <= 0 || T_ <= 0 || D <= 0 || D > 64 || (D % CH) ||
      Tq <= 0 || Tq > MAXQ || layer < 0 || layer >= L || tk <= 0 || tk > T_ ||
      pos < 0 || g <= 0 || H % g)
    return (int)cudaErrorInvalidValue;
  int last = pos + Tq - 1;
  if (prefix - 1 > last) last = prefix - 1;
  const int ncols = last + 1 < tk ? last + 1 : tk;
  const size_t scores = (size_t)Tq * ncols;
  const size_t reduce = (size_t)NWARP * Tq * D;
  const size_t bytes = sizeof(float) * ((size_t)Tq * D + MAXQ +
                                        (scores > reduce ? scores : reduce));
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_stacked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  decode_attn_stacked_kernel<T><<<B * H, NT, bytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<bf16*>(o), B, H, T_, D,
      Tq, layer, ncols, g, q_sb, q_sh, q_st, o_sb, o_sh, o_st, pos, prefix,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// tk: the read bound (kv_bound rounded up to 128, capped at T).
extern "C" int decode_attn_stacked_bf16(
    const void* q, const void* k_cache, const void* v_cache, void* o, int L,
    int B, int H, int T, int D, int Tq, int layer, int tk, long long q_sb,
    long long q_sh, long long q_st, long long o_sb, long long o_sh,
    long long o_st, int pos, int prefix, float scale, void* stream) {
  return launch<bf16>(q, k_cache, v_cache, nullptr, nullptr, o, L, B, H, T, D,
                      Tq, layer, tk, 1, q_sb, q_sh, q_st, o_sb, o_sh, o_st, pos,
                      prefix, scale, stream);
}

// int8 codes (L, B, H, T, D) with fp32 scales (L, B, H/g, T).
extern "C" int decode_attn_stacked_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, void* o, int L, int B, int H,
    int T, int D, int Tq, int layer, int tk, int g, long long q_sb,
    long long q_sh, long long q_st, long long o_sb, long long o_sh,
    long long o_st, int pos, int prefix, float scale, void* stream) {
  return launch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, o, L, B, H, T,
                        D, Tq, layer, tk, g, q_sb, q_sh, q_st, o_sb, o_sh, o_st,
                        pos, prefix, scale, stream);
}
