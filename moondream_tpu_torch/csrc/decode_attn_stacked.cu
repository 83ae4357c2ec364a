// Decode / short-span attention over ONE layer of the stacked KV cache, for
// Hopper (sm_90a), bf16 queries and output, over a bf16 cache or an int8
// cache with fp32 per-token scales. One kernel, two families of entry
// points:
//
// Kernel B, `decode_attn_stacked_*`: one position for the whole batch.
// Replaces the Pallas kernel `_decode_kernel_stacked` (moondream_tpu/ops/
// attention.py, called from `decode_attention_cached`), and computes the
// non-ragged, unshared function of `_decode_kernel_paired` (the TPU's
// default decode kernel), bf16 and int8, on the plain (L, B, H, T, D)
// cache layout. Query row i (i < Tq <= 16) sits at position pos + i and
// attends column c under the unified mask
//     c <= pos + i  OR  (pos + i < prefix AND c < prefix).
//
// Kernel B's GQA entry, `decode_attn_stacked_gqa_bf16`: grouped-query
// attention (Hq = rep * Hkv query heads, query head h reading KV head
// h / rep), one token. It replaces `_decode_kernel_stacked_gqa` (one layer
// of the stacked cache) and `_decode_kernel` / `_decode_kernel_gqa`
// (through `decode_attention`, a single (B, Hkv, T, D) layer, taken as
// L = 1). As on the TPU, whose block is q
// (rep, D) against one (T, D) slab, one block holds the rep query heads of
// one KV head as its rows: every K and V row is read once for all of them.
// The rows all sit at position pos (row_step 0), where a span's row i sits
// at pos + i (row_step 1).
//
// Kernel C, `decode_attn_ragged_*`: the serving pool's per-row positions.
// Replaces `_decode_kernel_stacked_ragged` and the ragged (b) and
// prefix-shared (c) branches of `_decode_kernel_paired`. Slot b's rows sit
// at pos[b] + i, with pos an int32 tensor on the device that each block
// reads itself (nothing goes back to the host). With a shared prefix
// segment (L, P, H, Tp, D), the cache is a SUFFIX whose column j sits at
// position prefix_len + j, and slot b also reads prefix entry pids[b],
// addressed by offset (nothing is gathered or copied): prefix column c
// attends iff c <= pos[b] + i (c < prefix_len), suffix column j iff
// prefix_len + j <= pos[b] + i, under one max and one denominator. Prefix
// columns come first in the block's score row, so each column has one
// global position and one mask rule.
//
// The layer is chosen by a runtime int and addressed from strides: the cache
// is never sliced or copied (attention.py:510-518). Reads are bounded by
// `tk` (kv_bound rounded up to 128, capped at T) and `tp` (the prefix
// segment's), and further by the last column any row of the block may
// attend, so stale slots past pos (earlier requests, prompt padding, idle
// slots) and the prefix segment's padding past prefix_len are never read
// and cannot move the row max.
//
// bf16 numerics follow `_decode_kernel_stacked(_ragged)`: fp32 scores
// scaled after the dot, max over masked scores, p = exp(s - m) / sum in
// fp32, rounded to bf16, then PV accumulated in fp32.
//
// int8 numerics follow `_decode_kernel_paired`'s int8 branches
// (attention.py:677-692, 739-767): the cache holds codes with x ~ code *
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
// and, with one block per (slot, head) (32 blocks at batch 1, 256 at a
// pool of 8, on 132 SMs; under GQA one per (batch row, KV head), 8 at batch
// 1 for 8 KV heads), by the latency of those reads. The design reads
// each K and V row exactly once with 16-byte (K) and 4- or 2-byte
// coalesced (V) loads, keeps scores and probabilities in shared memory (no
// device-memory round trip, one launch per layer), and skips every column
// past the last attendable one. Split-K across blocks for more SMs per head
// is later work.

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
// each lane owns one pair of D. T is bf16 (scales unused) or int8_t. With
// pos_arr null, every block sits at `pos` (kernel B); otherwise block
// (b, h) reads pos_arr[b] (kernel C), and with pk non-null also pids[b].
// Block row r sits at position p + r * ROW_STEP: 1 for a span of Tq query
// positions, 0 for GQA's rep query heads of KV head h (their q and o rows
// are then heads, the strides q_st / o_st a head's). ROW_STEP is a template
// argument: as a runtime value it cost kernels B and C 20-30% of their time.
template <typename T, int ROW_STEP>
__global__ void __launch_bounds__(NT) decode_attn_kernel(
    const bf16* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, const T* __restrict__ pk,
    const T* __restrict__ pv, const float* __restrict__ pks,
    const float* __restrict__ pvs, bf16* __restrict__ o,
    const int* __restrict__ pos_arr, const int* __restrict__ pids, int B,
    int H, int T_, int D, int Tq, int layer, int tk, int g, int P, int Tp,
    int tp, long long q_sb, long long q_sh, long long q_st, long long o_sb,
    long long o_sh, long long o_st, int pos, int prefix, int prefix_len,
    float scale) {
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
  bf16* ob = o + b * o_sb + h * o_sh;

  const bool shared = pk != nullptr;
  const int p = pos_arr != nullptr ? pos_arr[b] : pos;
  const int pid = shared ? pids[b] : 0;
  if (p < 0 || pid < 0 || (shared && pid >= P)) {
    // a position or prefix id the host could not check: NaN, not a stray read
    for (int i = tid; i < Tq * D; i += NT)
      ob[(long long)(i / D) * o_st + i % D] = __float2bfloat16(nanf(""));
    return;
  }
  // Columns [0, npre) are prefix entry pid's, [npre, ncols) the slot's own
  // cache from column 0; column c sits at global position gpos(c). The last
  // row sits at p + span - 1.
  const int span = (Tq - 1) * ROW_STEP + 1;
  int npre = 0, nsuf, base = 0, pfx = prefix;
  if (shared) {
    npre = min(min(prefix_len, p + span), tp);
    nsuf = max(0, min(tk, p + span - prefix_len));
    base = prefix_len;
    pfx = 0;  // decode rows sit past the image: no bidirectional clause
  } else {
    nsuf = min(max(p + span, prefix), tk);
  }
  const int ncols = npre + nsuf;
  auto gpos = [&](int c) { return c < npre ? c : base + c - npre; };

  const long long head = (((long long)layer * B + b) * H + h) * (long long)T_ * D;
  const T* kb = kc + head;
  const T* vb = vc + head;
  const long long phead = (((long long)layer * P + pid) * H + h) * (long long)Tp * D;
  const T* pkb = shared ? pk + phead : kb;
  const T* pvb = shared ? pv + phead : vb;
  auto krow = [&](int c) { return c < npre ? pkb + (long long)c * D : kb + (long long)(c - npre) * D; };
  auto vrow = [&](int c) { return c < npre ? pvb + (long long)c * D : vb + (long long)(c - npre) * D; };
  // int8: this head's scale rows, (L, B, H/g, T) and (L, P, H/g, Tp)
  const long long srow = (((long long)layer * B + b) * (H / g) + h / g) * (long long)T_;
  const long long psrow = (((long long)layer * P + pid) * (H / g) + h / g) * (long long)Tp;
  auto kscale = [&](int c) { return c < npre ? pks[psrow + c] : ks[srow + c - npre]; };
  auto vscale = [&](int c) { return c < npre ? pvs[psrow + c] : vs[srow + c - npre]; };

  const bf16* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < Tq * D; i += NT)
    sq[i] = __bfloat162float(qb[(long long)(i / D) * q_st + i % D]);
  __syncthreads();

  // Phase 1: one column per thread, the whole K row in 16-byte loads.
  for (int c = tid; c < ncols; c += NT) {
    float acc[MAXQ];
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) acc[r] = 0.f;
    const T* kr = krow(c);
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
    float cs = scale;
    if constexpr (INT8) cs *= kscale(c);
    const int gc = gpos(c);
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) {
      if (r < Tq)
        sS[r * ncols + c] = attends(gc, p + r * ROW_STEP, pfx) ? acc[r] * cs : NEG;
    }
  }
  __syncthreads();

  // Phase 2: masked softmax, one warp per row.
  for (int r = warp; r < Tq; r += NWARP) {
    float* row = sS + r * ncols;
    const int qp = p + r * ROW_STEP;
    float mx = NEG;
    for (int c = lane; c < ncols; c += 32)
      if (attends(gpos(c), qp, pfx)) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float e = attends(gpos(c), qp, pfx) ? expf(row[c] - mx) : 0.f;
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if constexpr (INT8) {
      // fold the v-scales into the unnormalised weights; divide at the end
      for (int c = lane; c < ncols; c += 32)
        row[c] = __bfloat162float(__float2bfloat16(row[c] * vscale(c)));
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
      const float2 f = load_pair(vrow(c) + d);
#pragma unroll
      for (int r = 0; r < MAXQ; ++r) {
        if (r < Tq) {
          const float w = sS[r * ncols + c];
          acc[r][0] += w * f.x;
          acc[r][1] += w * f.y;
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

// pos_arr null: kernel B at `pos`; else kernel C, with a prefix segment
// when pk is non-null. The score buffer holds the most columns a block can
// read: kernel B's exact count, kernel C's read bounds tk (+ the prefix's
// min(prefix_len, tp)), whatever the positions on the device hold.
template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scale, const void* v_scale, const void* pref_k,
           const void* pref_v, const void* pref_ks, const void* pref_vs,
           void* o, const int* pos_arr, const int* pids, int L, int B, int H,
           int T_, int D, int Tq, int layer, int tk, int g, int P, int Tp,
           int tp, long long q_sb, long long q_sh, long long q_st,
           long long o_sb, long long o_sh, long long o_st, int pos,
           int prefix, int prefix_len, int row_step, float scale,
           void* stream) {
  constexpr int CH = Row16<T>::N;
  const bool shared = pref_k != nullptr;
  if (L <= 0 || B <= 0 || H <= 0 || T_ <= 0 || D <= 0 || D > 64 || (D % CH) ||
      Tq <= 0 || Tq > MAXQ || layer < 0 || layer >= L || tk <= 0 || tk > T_ ||
      g <= 0 || H % g || (pos_arr == nullptr && (pos < 0 || shared)) ||
      (row_step != 0 && row_step != 1) ||
      (shared && (pids == nullptr || P <= 0 || tp <= 0 || tp > Tp ||
                  prefix_len <= 0)))
    return (int)cudaErrorInvalidValue;
  int cols;
  if (pos_arr == nullptr) {
    const int end = pos + (Tq - 1) * row_step + 1;
    cols = end > prefix ? end : prefix;
    if (cols > tk) cols = tk;
  } else {
    cols = tk + (shared ? (prefix_len < tp ? prefix_len : tp) : 0);
  }
  const size_t scores = (size_t)Tq * cols;
  const size_t reduce = (size_t)NWARP * Tq * D;
  const size_t bytes = sizeof(float) * ((size_t)Tq * D + MAXQ +
                                        (scores > reduce ? scores : reduce));
  auto kernel = row_step ? decode_attn_kernel<T, 1> : decode_attn_kernel<T, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const T*>(pref_k),
      static_cast<const T*>(pref_v), static_cast<const float*>(pref_ks),
      static_cast<const float*>(pref_vs), static_cast<bf16*>(o), pos_arr, pids,
      B, H, T_, D, Tq, layer, tk, g, P, Tp, tp, q_sb, q_sh, q_st, o_sb, o_sh,
      o_st, pos, prefix, prefix_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel B. tk: the read bound (kv_bound rounded up to 128, capped at T).
extern "C" int decode_attn_stacked_bf16(
    const void* q, const void* k_cache, const void* v_cache, void* o, int L,
    int B, int H, int T, int D, int Tq, int layer, int tk, long long q_sb,
    long long q_sh, long long q_st, long long o_sb, long long o_sh,
    long long o_st, int pos, int prefix, float scale, void* stream) {
  return launch<bf16>(q, k_cache, v_cache, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, o, nullptr, nullptr, L, B, H, T, D, Tq,
                      layer, tk, 1, 0, 0, 0, q_sb, q_sh, q_st, o_sb, o_sh,
                      o_st, pos, prefix, 0, 1, scale, stream);
}

// Kernel B on int8 codes (L, B, H, T, D) with fp32 scales (L, B, H/g, T).
extern "C" int decode_attn_stacked_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, void* o, int L, int B, int H,
    int T, int D, int Tq, int layer, int tk, int g, long long q_sb,
    long long q_sh, long long q_st, long long o_sb, long long o_sh,
    long long o_st, int pos, int prefix, float scale, void* stream) {
  return launch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, nullptr,
                        nullptr, nullptr, nullptr, o, nullptr, nullptr, L, B,
                        H, T, D, Tq, layer, tk, g, 0, 0, 0, q_sb, q_sh, q_st,
                        o_sb, o_sh, o_st, pos, prefix, 0, 1, scale, stream);
}

// Kernel B's GQA entry: q (B, Hkv * rep, 1, D) bf16 with batch and head
// strides q_sb, q_sh (o likewise), over layer `layer` of the stacked bf16
// (L, B, Hkv, T, D) caches. Block (b, h) takes query heads h * rep .. h *
// rep + rep - 1 as its rows, all at `pos`. A single (B, Hkv, T, D) layer
// (the single-layer `decode_attention`; rep 1 is its MHA case) is L = 1,
// layer 0, tk = T.
extern "C" int decode_attn_stacked_gqa_bf16(
    const void* q, const void* k_cache, const void* v_cache, void* o, int L,
    int B, int Hkv, int T, int D, int rep, int layer, int tk, long long q_sb,
    long long q_sh, long long o_sb, long long o_sh, int pos, int prefix,
    float scale, void* stream) {
  return launch<bf16>(q, k_cache, v_cache, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, o, nullptr, nullptr, L, B, Hkv, T, D,
                      rep, layer, tk, 1, 0, 0, 0, q_sb, rep * q_sh, q_sh,
                      o_sb, rep * o_sh, o_sh, pos, prefix, 0, 0, scale,
                      stream);
}

// Kernel C. pos (S,) int32 on the device; pref_k/pref_v (L, P, H, Tp, D)
// and pids (S,) int32, or all three null for no prefix segment; tp: the
// prefix's read bound (<= Tp).
extern "C" int decode_attn_ragged_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* pref_k, const void* pref_v, void* o, const int* pos,
    const int* pids, int L, int S, int H, int T, int D, int Tq, int layer,
    int tk, int P, int Tp, int tp, long long q_sb, long long q_sh,
    long long q_st, long long o_sb, long long o_sh, long long o_st,
    int prefix, int prefix_len, float scale, void* stream) {
  return launch<bf16>(q, k_cache, v_cache, nullptr, nullptr, pref_k, pref_v,
                      nullptr, nullptr, o, pos, pids, L, S, H, T, D, Tq, layer,
                      tk, 1, P, Tp, tp, q_sb, q_sh, q_st, o_sb, o_sh, o_st, 0,
                      prefix, prefix_len, 1, scale, stream);
}

// Kernel C on int8 codes; scales (L, S, H/g, T) and (L, P, H/g, Tp).
extern "C" int decode_attn_ragged_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* pref_k,
    const void* pref_v, const void* pref_ks, const void* pref_vs, void* o,
    const int* pos, const int* pids, int L, int S, int H, int T, int D,
    int Tq, int layer, int tk, int g, int P, int Tp, int tp, long long q_sb,
    long long q_sh, long long q_st, long long o_sb, long long o_sh,
    long long o_st, int prefix, int prefix_len, float scale, void* stream) {
  return launch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, pref_k, pref_v,
                        pref_ks, pref_vs, o, pos, pids, L, S, H, T, D, Tq,
                        layer, tk, g, P, Tp, tp, q_sb, q_sh, q_st, o_sb, o_sh,
                        o_st, 0, prefix, prefix_len, 1, scale, stream);
}
