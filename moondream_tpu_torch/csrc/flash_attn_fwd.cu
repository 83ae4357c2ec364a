// Fused masked attention forward for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the Pallas kernels `_flash_kernel` (moondream_tpu/ops/attention.py,
// called from `flash_attention`) and `_flash_kernel_kvtiled` (called from
// `_flash_attention_kvtiled`): QK^T * scale, the unified mask
//     attend(r, c) = c <= pos + r  OR  (pos + r < prefix AND c < prefix)
// with `pos` and `prefix` as runtime ints, softmax with the max taken over
// MASKED scores, then PV. One kernel covers both Pallas variants because it
// is online-softmax tiled over KV whatever Tk is.
//
// Numerics: scores accumulate in fp32 on the tensor cores and are scaled in
// fp32 after the dot (as `_flash_kernel_kvtiled` and the XLA sdpa path do;
// `_flash_kernel` instead folds the scale into q in bf16). Probabilities are
// rounded to bf16 for the PV product, the running denominator sums the fp32
// probabilities, and a zero denominator yields a zero row (attention.py:104).
// Columns at or past Tk are masked, so callers need not pad K/V.
//
// What bounds it on the H100: at the ViT shape (13 crops x 16 heads, 768
// tokens, head_dim 72) and the image prefill (32 heads, 730 x 768, head_dim
// 64) the work is ~2*2*Tq*Tk*D flops per head against ~(Tq+2Tk)*D*2 bytes,
// far above the card's ~295 flop/byte ridge, so the limit is on-chip work:
// tensor-core issue plus the scalar softmax pass over each 64 x 64 score tile.
// The design keeps the (Tq, Tk) score matrix out of device memory (one
// 64 x 64 fp32 tile in shared memory per block at a time), runs both
// products on bf16 tensor cores through WMMA (mma.sync m16n16k16, fp32
// accumulate), keeps the output accumulator in shared memory so it can be
// rescaled row by row, and skips KV tiles past the last column any row of
// the q tile may attend (attention.py:139-142). wgmma/TMA pipelining is
// later work.
//
// Layout: q (B, H, Tq, D), k/v (B, H, Tk, D), o (B, H, Tq, D), each given by
// its batch/head/token strides in elements with a unit stride on D, so the
// ViT's fused-QKV views and the stacked cache's layer views need no copy.
// head_dim D must be even and <= 80 (both configs: 72 in the ViT, 64 in the
// text model); it is zero-padded in shared memory to DP, a multiple of 16
// (72 -> 80).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv columns per tile
constexpr int NWARP = 4;      // each warp owns 16 query rows
constexpr int NT = NWARP * 32;
constexpr float NEG = -1e30f;

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (BQ * DP + 2 * BK * DP + BQ * BK) +
         sizeof(float) * (BQ * BK + BQ * DP + 3 * BQ);
}

// Copy `rows` x D bf16 values (row stride `st`) into a zero-padded
// [nrows][DP] shared tile, two values per 32-bit load.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int row0, int nvalid,
                                          int nrows, int D) {
  constexpr int PAIRS = DP / 2;
  for (int i = threadIdx.x; i < nrows * PAIRS; i += NT) {
    const int r = i / PAIRS;
    const int c = 2 * (i % PAIRS);
    uint32_t val = 0u;
    if (row0 + r < nvalid && c < D) {
      val = *reinterpret_cast<const uint32_t*>(src + (long long)(row0 + r) * st + c);
    }
    *reinterpret_cast<uint32_t*>(dst + r * DP + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(NT) flash_attn_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Tq, int Tk,
    int D, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long o_sb, long long o_sh, long long o_st, int pos,
    int prefix, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [BQ][DP]
  bf16* sK = sQ + BQ * DP;                    // [BK][DP]
  bf16* sV = sK + BK * DP;                    // [BK][DP]
  bf16* sP = sV + BK * DP;                    // [BQ][BK] bf16 probabilities
  float* sS = reinterpret_cast<float*>(sP + BQ * BK);  // [BQ][BK] scores
  float* sO = sS + BQ * BK;                   // [BQ][DP] output accumulator
  float* sM = sO + BQ * DP;                   // running max per row
  float* sL = sM + BQ;                        // running denominator per row
  float* sA = sL + BQ;                        // per-tile rescale factor

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  load_tile<DP>(sQ, qb, q_st, q0, Tq, BQ, D);
  for (int i = threadIdx.x; i < BQ * DP; i += NT) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    sM[i] = NEG;
    sL[i] = 0.f;
  }

  // Skip KV tiles past the last column any row of this q tile may attend.
  const int last_row = min(q0 + BQ, Tq) - 1;
  const int last_col = min(max(pos + last_row, prefix - 1), Tk - 1);
  const int n_kt = last_col / BK + 1;

  const int wr = warp * 16;  // this warp's first row inside the tile

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DP>(sK, kb, k_st, k0, Tk, BK, D);
    load_tile<DP>(sV, vb, v_st, k0, Tk, BK, D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 columns.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + wr * DP + kk * 16, DP);
        wmma::load_matrix_sync(fb, sK + (j * 16) * DP + kk * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + wr * BK + j * 16, acc, BK, wmma::mem_row_major);
    }
    __syncwarp();

    // Masked online softmax, one row at a time; lane owns columns lane and
    // lane + 32 of the tile.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = wr + rr;
      const int qp = pos + q0 + r;
      const bool in_prefix = qp < prefix;
      const int c0 = k0 + lane;
      const int c1 = c0 + 32;
      const bool a0 = c0 < Tk && (c0 <= qp || (in_prefix && c0 < prefix));
      const bool a1 = c1 < Tk && (c1 <= qp || (in_prefix && c1 < prefix));
      const float s0 = a0 ? sS[r * BK + lane] * scale : NEG;
      const float s1 = a1 ? sS[r * BK + lane + 32] * scale : NEG;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = a0 ? expf(s0 - m_new) : 0.f;
      const float p1 = a1 ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sP[r * BK + lane] = __float2bfloat16(p0);
      sP[r * BK + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
        sA[r] = alpha;
      }
    }
    __syncwarp();

    // Rescale this warp's accumulator rows, then O += P V on tensor cores.
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = wr + i / DP;
      sO[r * DP + i % DP] *= sA[r];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + wr * DP + j * 16, DP, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + wr * BK + kk * 16, BK);
        wmma::load_matrix_sync(fb, sV + (kk * 16) * DP + j * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + wr * DP + j * 16, acc, DP, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Normalise and write this warp's real rows.
  bf16* ob = o + b * o_sb + h * o_sh;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = wr + i / D;
    const int c = i % D;
    const int row = q0 + r;
    if (row < Tq) {
      const float l = sL[r];
      const float inv = l == 0.f ? 1.f : 1.f / l;
      ob[(long long)row * o_st + c] = __float2bfloat16(sO[r * DP + c] * inv);
    }
  }
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                   int H, int Tq, int Tk, int D, const long long* s, int pos,
                   int prefix, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attn_fwd_kernel<DP><<<grid, NT, bytes, stream>>>(
      q, k, v, o, H, Tq, Tk, D, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
      s[8], s[9], s[10], s[11], pos, prefix, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Tq,
    int Tk, int D, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh,
    long long o_st, int pos, int prefix, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 80 || (D & 1) ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long s[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                           v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 32)
    err = launch<32>(qp, kp, vp, op, B, H, Tq, Tk, D, s, pos, prefix, scale, st);
  else if (D <= 64)
    err = launch<64>(qp, kp, vp, op, B, H, Tq, Tk, D, s, pos, prefix, scale, st);
  else
    err = launch<80>(qp, kp, vp, op, B, H, Tq, Tk, D, s, pos, prefix, scale, st);
  return (int)err;
}
