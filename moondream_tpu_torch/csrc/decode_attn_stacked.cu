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
// Every B entry takes pos as a host int (prompt spans) or as per-row int32
// positions on the device that each block reads (a decode step captured in
// a CUDA graph: the JAX package's fused decode loop keeps its position on
// the device too); the device form plans its splits from the read bound.
//
// Kernel B's GQA entry, `decode_attn_stacked_gqa_bf16`: grouped-query
// attention (Hq = rep * Hkv query heads, query head h reading KV head
// h / rep), one token. It replaces `_decode_kernel_stacked_gqa` (one layer
// of the stacked cache) and `_decode_kernel` / `_decode_kernel_gqa`
// (through `decode_attention`, a single (B, Hkv, T, D) layer, taken as
// L = 1). As on the TPU, whose block is q (rep, D) against one (T, D) slab,
// one block holds the rep query heads of one KV head as its rows: every K
// and V row is read once for all of them. The rows all sit at position pos
// (row_step 0), where a span's row i sits at pos + i (row_step 1).
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
// columns come first in a (slot, head)'s column order, so each column has
// one global position and one mask rule, whichever block reads it.
//
// The layer is chosen by a runtime int and addressed from strides: the cache
// is never sliced or copied (attention.py:510-518). Reads are bounded by
// `tk` (kv_bound rounded up to 128, capped at T) and `tp` (the prefix
// segment's), and further by the last column any row of the (slot, head)
// may attend, so stale slots past pos (earlier requests, prompt padding, idle
// slots) and the prefix segment's padding past prefix_len are never read
// and cannot move the row max.
//
// bf16 numerics follow `_decode_kernel_stacked(_ragged)`: fp32 scores
// scaled after the dot, max over masked scores, exp in fp32, probabilities
// rounded to bf16, PV accumulated in fp32. One change of rounding order: a
// block sees only its split of the columns, so it rounds the UNNORMALISED
// p = exp(s - m_split) to bf16 and the division by the global denominator
// comes after the splits are merged (the TPU kernel normalises p first).
// Both round p once to bf16's 8 bits; the results differ within that.
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
// per byte, far below the ~295 flop/byte ridge: it is bound by memory, and
// at a few (slot, head) pairs (32 at batch 1, 8 under GQA) by how many
// reads are in flight. So the columns of each pair are split across blocks
// (split-K, FlashDecoding): grid (split, pair), the split count planned on
// the host from its read bounds (kernels/attention.py:plan_decode_splits)
// to give about three blocks per SM, in splits of whole 16-column multiples
// with no sliver of a split at the end. A block streams its columns in tiles
// of 64 rows of K and V with 16-byte cp.async loads, neighbouring threads on
// neighbouring bytes of a row, double-buffered so the next tile is in
// flight while this one is used. Blocks of one or two rows (decode tokens,
// GQA rep <= 2) and int8 blocks compute both products in fp32 on the CUDA
// cores; bf16 blocks of 3 to 16 rows (prompt spans, kernel C's verify
// spans, GQA rep 4-16) run them on tensor cores (mma.sync m16n8k16, fp32
// sums, rows padded to 16 with zeros). The block keeps its split's max,
// denominator and unnormalised fp32 PV sum and writes them to a workspace;
// the last block of the pair to finish (an atomicAdd ticket after
// __threadfence()) merges every split, with all splits' loads of a row in
// flight at once, writes the bf16 output and resets the ticket to 0: one
// launch per call. A split that lies past the pair's attendable columns
// (kernel C's positions live on the device) reports (max -inf, denominator
// 0) and weighs 0 in the merge.
//
// The workspace (fp32 partials, then int32 tickets) belongs to the wrapper,
// one per (device, stream): launches that may run at once on different
// streams must not share one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 128;
constexpr int NWARP = NT / 32;
constexpr int TC = 64;            // columns per tile
// Tiles of K and V in shared memory: 2 (one in flight while one is used)
// beat 3 and 4 on the H100, where the larger blocks fit fewer to an SM.
constexpr int STAGES = 2;
constexpr int MAXQ = 16;          // query rows per block
constexpr int MAX_SPLITS = 128;   // column splits per (slot, head)

struct Params {
  const bf16* q;
  const void* kc;
  const void* vc;
  const float* ks;
  const float* vs;
  const void* pk;     // prefix segment, or null
  const void* pv;
  const float* pks;
  const float* pvs;
  bf16* o;
  const int* pos_arr;  // per-row positions on the device (B's device form, C), or null
  const int* pids;
  float* ws;           // [pairs][n_split][Tq][D] partial sums, then [pairs][n_split][Tq][2] (m, l)
  int* tickets;        // [pairs]
  int B, H, T, D, Tq, layer, tk, g, P, Tp, tp;
  long long q_sb, q_sh, q_st, o_sb, o_sh, o_st;
  int pos, prefix, prefix_len;
  int n_split, split_cols;
  float scale;
};

__device__ __forceinline__ bool attends(int c, int qp, int prefix) {
  return c <= qp || (qp < prefix && c < prefix);
}

// 16 bytes of a cache row as floats: 8 bf16 or 16 int8 values.
template <typename T>
struct Row16 {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const void* p, float (&f)[N]) {
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tensor-core tiles for blocks of 4 or more bf16 rows: four 8 x 8 bf16
// matrices from shared memory (lanes 8m..8m+7 give matrix m's row
// addresses), and D (16 x 8, fp32) += A (16 x 16) B (16 x 8).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory: q rows and the tile's weights in bf16 (the tensor-core
// path's operands), q rows and the tile's scores in fp32, per-row running
// max / denominator / rescale, then a region that holds the two stages of
// K and V tiles (rows padded by 16 bytes: conflict-free 16-byte reads down
// a column of rows, and 16-byte aligned ldmatrix rows) while the columns
// stream, and the cross-warp reduction and the merge's split weights after.
// Every part is a multiple of 16 bytes (D a multiple of 8).
__host__ __device__ inline int row_bytes(int D, int e) { return D * e + 16; }
// mq: the bf16 operands' rows, 16 (one m16 tile) on the tensor-core path, else 0.
__host__ __device__ inline size_t head_bytes(int nq, int mq, int D) {
  return sizeof(bf16) * mq * ((D + 8) + (TC + 8)) + sizeof(float) * nq * (D + TC + 4);
}
__host__ __device__ inline size_t smem_bytes(int nq, int mq, int D, int e) {
  const size_t stages = (size_t)2 * STAGES * TC * row_bytes(D, e);
  const size_t tail = sizeof(float) * ((size_t)NWARP * nq * D + (size_t)nq * MAX_SPLITS);
  return head_bytes(nq, mq, D) + (stages > tail ? stages : tail);
}

// T is bf16 (scales unused) or int8_t. With pos_arr null, every block sits
// at `pos` (kernel B); otherwise pair (b, h) reads pos_arr[b] (kernel B's
// device form, kernel C), and with pk non-null also pids[b]. Block row r sits at position
// p + r * ROW_STEP: 1 for a span of Tq query positions, 0 for GQA's rep
// query heads of KV head h (their q and o rows are then heads, the strides
// q_st / o_st a head's). ROW_STEP and NQ (Tq rounded up to a power of two)
// are template arguments: a runtime row step cost kernels B and C 20-30%.
// bf16 blocks of NQ 4 or more rows run both products on tensor cores
// (mma.sync m16n8k16, fp32 accumulate, rows padded to 16 with zeros; the
// operands are the bf16 values the scalar path converts); fewer rows and
// int8 codes take the scalar path.
template <typename T, int NQ>
__host__ __device__ constexpr bool uses_mma() {
  return sizeof(T) == 2 && NQ >= 4;
}

template <typename T, int ROW_STEP, int NQ>
__global__ void __launch_bounds__(NT) decode_attn_kernel(const Params a) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr bool MMA = uses_mma<T, NQ>();
  constexpr int MQ = MMA ? 16 : 0;
  constexpr int CH = Row16<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_block;
  const int D = a.D, Tq = a.Tq;
  const int RB = row_bytes(D, sizeof(T));
  const int QP = D + 8, PP = TC + 8;  // bf16 row pitches (16-byte padded)
  bf16* sQh = reinterpret_cast<bf16*>(smem_raw);  // [MQ][QP] q rows (MMA)
  bf16* sPh = sQh + MQ * QP;                      // [MQ][PP] weights (MMA)
  float* sq = reinterpret_cast<float*>(sPh + MQ * PP);  // [NQ][D]
  float* sS = sq + NQ * D;            // [NQ][TC] scores, then weights
  float* sm = sS + NQ * TC;           // [NQ] running max
  float* sl = sm + NQ;                // [NQ] running denominator
  float* sa = sl + NQ;                // [NQ] this tile's rescale
  unsigned char* big = smem_raw + head_bytes(NQ, MQ, D);
  unsigned char* sK = big;                          // [STAGES][TC][RB]
  unsigned char* sV = big + STAGES * TC * RB;       // [STAGES][TC][RB]
  float* red = reinterpret_cast<float*>(big);       // [NWARP][Tq][D], after the columns
  float* sW = red + NWARP * NQ * D;                 // [NQ][MAX_SPLITS], in the merge

  const int split = blockIdx.x;
  const int pair = blockIdx.y;
  const int b = pair / a.H;
  const int h = pair % a.H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_split = a.n_split;
  bf16* ob = a.o + b * a.o_sb + h * a.o_sh;

  const bool shared = a.pk != nullptr;
  const int p = a.pos_arr != nullptr ? a.pos_arr[b] : a.pos;
  const int pid = shared ? a.pids[b] : 0;
  // a position or prefix id the host could not check: NaN, not a stray read
  const bool valid = p >= 0 && pid >= 0 && (!shared || pid < a.P);

  // The pair's columns: [0, npre) are prefix entry pid's, [npre, ncols)
  // the slot's own cache from column 0; column c sits at global position
  // gpos(c). The last row sits at p + span - 1.
  const int span = (Tq - 1) * ROW_STEP + 1;
  int npre = 0, nsuf = 0, base = 0, pfx = a.prefix;
  if (valid) {
    if (shared) {
      npre = min(min(a.prefix_len, p + span), a.tp);
      nsuf = max(0, min(a.tk, p + span - a.prefix_len));
      base = a.prefix_len;
      pfx = 0;  // decode rows sit past the image: no bidirectional clause
    } else {
      nsuf = min(max(p + span, a.prefix), a.tk);
    }
  }
  const int ncols = npre + nsuf;
  auto gpos = [&](int c) { return c < npre ? c : base + c - npre; };

  const long long head = (((long long)a.layer * a.B + b) * a.H + h) * (long long)a.T * D;
  const T* kb = static_cast<const T*>(a.kc) + head;
  const T* vb = static_cast<const T*>(a.vc) + head;
  const long long phead = (((long long)a.layer * a.P + pid) * a.H + h) * (long long)a.Tp * D;
  const T* pkb = shared ? static_cast<const T*>(a.pk) + phead : kb;
  const T* pvb = shared ? static_cast<const T*>(a.pv) + phead : vb;
  auto krow = [&](int c) { return c < npre ? pkb + (long long)c * D : kb + (long long)(c - npre) * D; };
  auto vrow = [&](int c) { return c < npre ? pvb + (long long)c * D : vb + (long long)(c - npre) * D; };
  // int8: this head's scale rows, (L, B, H/g, T) and (L, P, H/g, Tp)
  const int hg = a.H / a.g;
  const long long srow = (((long long)a.layer * a.B + b) * hg + h / a.g) * (long long)a.T;
  const long long psrow = (((long long)a.layer * a.P + pid) * hg + h / a.g) * (long long)a.Tp;
  auto kscale = [&](int c) { return c < npre ? a.pks[psrow + c] : a.ks[srow + c - npre]; };
  auto vscale = [&](int c) { return c < npre ? a.pvs[psrow + c] : a.vs[srow + c - npre]; };

  const size_t slot = (size_t)pair * n_split + split;
  float* part_o = a.ws + slot * Tq * D;
  float* part_ml = a.ws + (size_t)gridDim.y * n_split * Tq * D + slot * Tq * 2;

  const int c_begin = split * a.split_cols;
  const int c_end = min(c_begin + a.split_cols, ncols);
  if (valid && c_begin >= c_end) {
    // a split past the pair's last attendable column
    for (int r = tid; r < Tq; r += NT) {
      part_ml[2 * r] = -INFINITY;
      part_ml[2 * r + 1] = 0.f;
    }
  } else if (valid) {
    const int chunks = D * (int)sizeof(T) / 16;  // 16-byte loads per row
    auto load_tile = [&](int t) {
      const int c0 = c_begin + t * TC;
      const int n = min(TC, c_end - c0);
      unsigned char* dk = sK + (t % STAGES) * TC * RB;
      unsigned char* dv = sV + (t % STAGES) * TC * RB;
      for (int i = tid; i < n * chunks; i += NT) {
        const int c = i / chunks, j = i % chunks;
        cp_async16(dk + c * RB + 16 * j,
                   reinterpret_cast<const unsigned char*>(krow(c0 + c)) + 16 * j);
        cp_async16(dv + c * RB + 16 * j,
                   reinterpret_cast<const unsigned char*>(vrow(c0 + c)) + 16 * j);
      }
      if constexpr (MMA) {
        // the tensor cores read whole 16-row blocks: rows past n are zeros,
        // never stale bits (0 x NaN would reach the sum)
        for (int i = n * chunks + tid; i < TC * chunks; i += NT) {
          const int c = i / chunks, j = i % chunks;
          *reinterpret_cast<uint4*>(dk + c * RB + 16 * j) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(dv + c * RB + 16 * j) = make_uint4(0, 0, 0, 0);
        }
      }
      cp_async_commit();
    };

    const int n_tiles = (c_end - c_begin + TC - 1) / TC;
    // the first STAGES - 1 tiles are in flight while q is read; one
    // commit group per tile, empty past the last, keeps the waits uniform
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < n_tiles) load_tile(t);
      else cp_async_commit();
    }
    const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
    for (int i = tid; i < Tq * D; i += NT) {
      const bf16 x = qb[(long long)(i / D) * a.q_st + i % D];
      sq[i] = __bfloat162float(x);
      if constexpr (MMA) sQh[(i / D) * QP + i % D] = x;
    }
    if constexpr (MMA) {  // rows past Tq: zeros in both operands
      for (int i = Tq * D + tid; i < MQ * D; i += NT) sQh[(i / D) * QP + i % D] = bf16(0.f);
      for (int i = Tq * TC + tid; i < MQ * TC; i += NT) sPh[(i / TC) * PP + i % TC] = bf16(0.f);
    }
    for (int r = tid; r < NQ; r += NT) {
      sm[r] = -INFINITY;
      sl[r] = 0.f;
      sa[r] = 1.f;
    }

    const int d = 2 * lane;  // PV: lanes split D in pairs, warps the columns
    float acc[NQ][2];
#pragma unroll
    for (int r = 0; r < NQ; ++r) acc[r][0] = acc[r][1] = 0.f;
    // MMA: warp w owns output columns 16w..16w+15 of D (rows g and g + 8,
    // columns 2t and 2t + 1 of each 8-column half, g = lane / 4, t = lane % 4)
    const int g = lane / 4, t4 = lane % 4;
    float o4[2][4] = {};
    for (int t = 0; t < n_tiles; ++t) {
      // tile t + STAGES - 1 goes to the stage tile t - 1 freed
      if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
      else cp_async_commit();
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      const int c0 = c_begin + t * TC;
      const int n = min(TC, c_end - c0);
      const unsigned char* tk_ = sK + (t % STAGES) * TC * RB;
      const unsigned char* tv_ = sV + (t % STAGES) * TC * RB;

      if constexpr (MMA) {
        // S (16 rows x this warp's 16 columns) = Q K^T on tensor cores
        float s4[2][4] = {};
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[4], kb4[4];
          ldsm_x4(qa, sQh + (lane % 16) * QP + kk * 16 + (lane / 16) * 8);
          ldsm_x4(kb4, tk_ + (16 * warp + lane % 8 + (lane / 16) * 8) * RB +
                           (kk * 16 + ((lane / 8) % 2) * 8) * 2);
          mma_bf16(s4[0], qa, kb4[0], kb4[1]);
          mma_bf16(s4[1], qa, kb4[2], kb4[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + 8 * (e >> 1);
            const int c = 16 * warp + 8 * j + 2 * t4 + (e & 1);
            if (r < Tq && c < n)
              sS[r * TC + c] =
                  attends(gpos(c0 + c), p + r * ROW_STEP, pfx) ? s4[j][e] * a.scale : -INFINITY;
          }
        }
      } else {
      // Scores: thread (column c, row group rg) over rows rg, rg + 2, ...
        constexpr int RPT = (NQ + 1) / 2;
        const int c = tid % TC;
        const int rg = tid / TC;
        if (c < n) {
          float dot[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) dot[i] = 0.f;
          const unsigned char* kr = tk_ + c * RB;
          for (int j = 0; j < chunks; ++j) {
            float kf[CH];
            Row16<T>::load(kr + 16 * j, kf);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const int r = rg + 2 * i;
              if (r < Tq) {
                const float4* qr = reinterpret_cast<const float4*>(sq + r * D + j * CH);
#pragma unroll
                for (int e = 0; e < CH / 4; ++e) {
                  const float4 qv = qr[e];
                  dot[i] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] + qv.z * kf[4 * e + 2] +
                            qv.w * kf[4 * e + 3];
                }
              }
            }
          }
          float cs = a.scale;
          if constexpr (INT8) cs *= kscale(c0 + c);
          const int gc = gpos(c0 + c);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = rg + 2 * i;
            if (r < Tq)
              sS[r * TC + c] = attends(gc, p + r * ROW_STEP, pfx) ? dot[i] * cs : -INFINITY;
          }
        }
      }
      __syncthreads();

      // Online softmax over the tile, one warp per row.
      for (int r = warp; r < Tq; r += NWARP) {
        float* row = sS + r * TC;
        const float s0 = lane < n ? row[lane] : -INFINITY;
        const float s1 = lane + 32 < n ? row[lane + 32] : -INFINITY;
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = sm[r];
        const float m_new = fmaxf(m_old, mx);
        // nothing attended yet: subtract 0, every p is exp(-inf) = 0
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        const float e0 = expf(s0 - mu);
        const float e1 = expf(s1 - mu);
        float sum = e0 + e1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        float w0 = e0, w1 = e1;
        if constexpr (INT8) {
          // fold the v-scales into the unnormalised weights
          if (lane < n) w0 *= vscale(c0 + lane);
          if (lane + 32 < n) w1 *= vscale(c0 + lane + 32);
        }
        row[lane] = __bfloat162float(__float2bfloat16(w0));
        row[lane + 32] = __bfloat162float(__float2bfloat16(w1));
        if constexpr (MMA) {
          sPh[r * PP + lane] = __float2bfloat16(w0);
          sPh[r * PP + lane + 32] = __float2bfloat16(w1);
        }
        if (lane == 0) {
          const float alpha = expf(m_old - mu);
          sm[r] = m_new;
          sl[r] = sl[r] * alpha + sum;
          sa[r] = alpha;
        }
      }
      __syncthreads();

      // O += P V over this warp's columns of the tile.
      if constexpr (MMA) {
        if (16 * warp < D) {
          // rows past Tq hold zeros; their rescale is never read
          const float a0 = g < Tq ? sa[g] : 1.f, a1 = g + 8 < Tq ? sa[g + 8] : 1.f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            o4[j][0] *= a0;
            o4[j][1] *= a0;
            o4[j][2] *= a1;
            o4[j][3] *= a1;
          }
#pragma unroll
          for (int kk = 0; kk < TC / 16; ++kk) {
            uint32_t pa[4], vb4[4];
            ldsm_x4(pa, sPh + (lane % 16) * PP + kk * 16 + (lane / 16) * 8);
            ldsm_x4_trans(vb4, tv_ + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RB +
                                   (16 * warp + (lane / 16) * 8) * 2);
            mma_bf16(o4[0], pa, vb4[0], vb4[1]);
            mma_bf16(o4[1], pa, vb4[2], vb4[3]);
          }
        }
      } else if (d < D) {
#pragma unroll
        for (int r = 0; r < NQ; ++r) {
          if (r < Tq) {
            const float al = sa[r];
            acc[r][0] *= al;
            acc[r][1] *= al;
          }
        }
        // four columns at a time: one 16-byte read of each row's weights
        // (past n the weights are 0 and the stale V rows are not read)
        for (int c = 4 * warp; c < n; c += 4 * NWARP) {
          float2 f[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            f[u] = c + u < n ? load_pair(reinterpret_cast<const T*>(tv_ + (c + u) * RB) + d)
                             : make_float2(0.f, 0.f);
#pragma unroll
          for (int r = 0; r < NQ; ++r) {
            if (r < Tq) {
              const float4 w = *reinterpret_cast<const float4*>(sS + r * TC + c);
              acc[r][0] += w.x * f[0].x + w.y * f[1].x + w.z * f[2].x + w.w * f[3].x;
              acc[r][1] += w.x * f[0].y + w.y * f[1].y + w.z * f[2].y + w.w * f[3].y;
            }
          }
        }
      }
      __syncthreads();  // the stage and the scores are free again
    }

    // This split's unnormalised sum, its max and its denominator.
    if constexpr (MMA) {
      if (16 * warp < D) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * warp + 8 * j + 2 * t4;
          if (g < Tq) *reinterpret_cast<float2*>(part_o + g * D + col) =
              make_float2(o4[j][0], o4[j][1]);
          if (g + 8 < Tq) *reinterpret_cast<float2*>(part_o + (g + 8) * D + col) =
              make_float2(o4[j][2], o4[j][3]);
        }
      }
    } else if (d < D) {
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        if (r < Tq) {
          red[(warp * Tq + r) * D + d] = acc[r][0];
          red[(warp * Tq + r) * D + d + 1] = acc[r][1];
        }
      }
    }
    __syncthreads();
    if constexpr (!MMA) {
      for (int i = tid; i < Tq * D; i += NT) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NWARP; ++w) s += red[w * Tq * D + i];
        part_o[i] = s;
      }
    }
    for (int r = tid; r < Tq; r += NT) {
      part_ml[2 * r] = sm[r];
      part_ml[2 * r + 1] = sl[r];
    }
  }

  // The last block of the pair to finish merges every split.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(a.tickets + pair, 1) == n_split - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if (!valid) {
    for (int i = tid; i < Tq * D; i += NT)
      ob[(long long)(i / D) * a.o_st + i % D] = __float2bfloat16(nanf(""));
  } else {
    const float* all_o = a.ws + (size_t)pair * n_split * Tq * D;
    const float* all_ml = a.ws + (size_t)gridDim.y * n_split * Tq * D + (size_t)pair * n_split * Tq * 2;
    // every split's (max, denominator) of a row in one round of loads
    for (int r = warp; r < Tq; r += NWARP) {
      constexpr int PER_LANE = MAX_SPLITS / 32;
      float2 ml[PER_LANE];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        const int s = lane + 32 * u;
        ml[u] = s < n_split ? __ldcg(reinterpret_cast<const float2*>(all_ml) + s * Tq + r)
                            : make_float2(-INFINITY, 0.f);
        mx = fmaxf(mx, ml[u].x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float den = 0.f;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        const int s = lane + 32 * u;
        // an empty split (max -inf) weighs 0: never -inf - (-inf)
        const float w = ml[u].x == -INFINITY ? 0.f : expf(ml[u].x - mx);
        if (s < n_split) sW[r * MAX_SPLITS + s] = w;
        den += w * ml[u].y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        den += __shfl_xor_sync(0xffffffffu, den, off);
      if (lane == 0) sl[r] = den;
    }
    __syncthreads();
    constexpr int BATCH = 16;
    for (int i = tid; i < Tq * D; i += NT) {
      const int r = i / D;
      float s = 0.f;
      // BATCH splits' loads in flight at once; an empty split's slot holds
      // whatever was there and is selected away, never multiplied in
      for (int s0 = 0; s0 < n_split; s0 += BATCH) {
        float po[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          po[u] = s0 + u < n_split ? __ldcg(all_o + (size_t)(s0 + u) * Tq * D + i) : 0.f;
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const float w = s0 + u < n_split ? sW[r * MAX_SPLITS + s0 + u] : 0.f;
          s += w != 0.f ? w * po[u] : 0.f;
        }
      }
      const float den = sl[r];
      ob[(long long)r * a.o_st + i % D] = __float2bfloat16(den == 0.f ? 0.f : s / den);
    }
  }
  if (tid == 0) a.tickets[pair] = 0;
}

template <typename T, int ROW_STEP, int NQ>
cudaError_t run(const Params& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(NQ, uses_mma<T, NQ>() ? 16 : 0, a.D, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<T, ROW_STEP, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  decode_attn_kernel<T, ROW_STEP, NQ><<<dim3(a.n_split, a.B * a.H), NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int ROW_STEP>
cudaError_t run_rows(const Params& a, cudaStream_t stream) {
  if (a.Tq <= 1) return run<T, ROW_STEP, 1>(a, stream);
  if (a.Tq <= 2) return run<T, ROW_STEP, 2>(a, stream);
  if (a.Tq <= 4) return run<T, ROW_STEP, 4>(a, stream);
  if (a.Tq <= 8) return run<T, ROW_STEP, 8>(a, stream);
  return run<T, ROW_STEP, MAXQ>(a, stream);
}

// pos_arr null: kernel B at `pos`; else positions on the device (kernel
// B's device form, or kernel C), with a prefix segment when pk is non-null.
// The splits must cover the most columns a pair can read: kernel B's exact
// count at a host `pos`, else the read bounds tk (+ the prefix's
// min(prefix_len, tp)), whatever the positions on the device hold.
template <typename T>
int launch(Params a, int L, int row_step, void* stream) {
  constexpr int CH = Row16<T>::N;
  const bool shared = a.pk != nullptr;
  if (L <= 0 || a.B <= 0 || a.H <= 0 || a.T <= 0 || a.D <= 0 || a.D > 64 || (a.D % CH) ||
      a.Tq <= 0 || a.Tq > MAXQ || a.layer < 0 || a.layer >= L || a.tk <= 0 || a.tk > a.T ||
      a.g <= 0 || a.H % a.g || (a.pos_arr == nullptr && (a.pos < 0 || shared)) ||
      (row_step != 0 && row_step != 1) || (sizeof(T) == 1 && row_step == 0) ||
      (shared && (a.pids == nullptr || a.P <= 0 || a.tp <= 0 || a.tp > a.Tp ||
                  a.prefix_len <= 0)) ||
      a.n_split <= 0 || a.n_split > MAX_SPLITS || a.split_cols <= 0 || a.split_cols % 16 ||
      a.ws == nullptr || a.tickets == nullptr || a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  int cols;
  if (a.pos_arr == nullptr) {
    const int end = a.pos + (a.Tq - 1) * row_step + 1;
    cols = end > a.prefix ? end : a.prefix;
    if (cols > a.tk) cols = a.tk;
  } else {
    cols = a.tk + (shared ? (a.prefix_len < a.tp ? a.prefix_len : a.tp) : 0);
  }
  if ((long long)a.n_split * a.split_cols < cols) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = row_step ? run_rows<T, 1>(a, st) : run_rows<T, 0>(a, st);
  return (int)err;
}

Params params(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
              const void* v_scale, const void* pref_k, const void* pref_v,
              const void* pref_ks, const void* pref_vs, void* o, const int* pos_arr,
              const int* pids, int B, int H, int T, int D, int Tq, int layer, int tk, int g,
              int P, int Tp, int tp, long long q_sb, long long q_sh, long long q_st,
              long long o_sb, long long o_sh, long long o_st, int pos, int prefix,
              int prefix_len, float scale, int n_split, int split_cols, void* ws,
              void* tickets) {
  Params a;
  a.q = static_cast<const bf16*>(q);
  a.kc = k_cache;
  a.vc = v_cache;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.pk = pref_k;
  a.pv = pref_v;
  a.pks = static_cast<const float*>(pref_ks);
  a.pvs = static_cast<const float*>(pref_vs);
  a.o = static_cast<bf16*>(o);
  a.pos_arr = pos_arr;
  a.pids = pids;
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.B = B; a.H = H; a.T = T; a.D = D; a.Tq = Tq; a.layer = layer; a.tk = tk; a.g = g;
  a.P = P; a.Tp = Tp; a.tp = tp;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_st = q_st; a.o_sb = o_sb; a.o_sh = o_sh; a.o_st = o_st;
  a.pos = pos; a.prefix = prefix; a.prefix_len = prefix_len;
  a.n_split = n_split; a.split_cols = split_cols;
  a.scale = scale;
  return a;
}

}  // namespace

// Every entry ends with the split plan (n_split blocks of split_cols
// columns per (batch row, head), split_cols a multiple of 16) and the
// workspace: ws, >= B * H * n_split * Tq * (D + 2) floats, and tickets,
// B * H int32 that are 0 before the launch and are 0 again after it.

// Kernel B. tk: the read bound (kv_bound rounded up to 128, capped at T).
// Every B entry takes the position in one of two forms: pos_arr null, the
// host int `pos` (prompt spans); or pos_arr, B int32 positions on the device
// that the blocks read (a decode step inside a CUDA graph, whose replays
// must not freeze the position; the lockstep rows hold one value). With
// pos_arr the splits must cover tk columns, as kernel C's.
extern "C" int decode_attn_stacked_bf16(
    const void* q, const void* k_cache, const void* v_cache, void* o, int L,
    int B, int H, int T, int D, int Tq, int layer, int tk, long long q_sb,
    long long q_sh, long long q_st, long long o_sb, long long o_sh,
    long long o_st, int pos, const int* pos_arr, int prefix, float scale, int n_split,
    int split_cols, void* ws, void* tickets, void* stream) {
  return launch<bf16>(
      params(q, k_cache, v_cache, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, o,
             pos_arr, nullptr, B, H, T, D, Tq, layer, tk, 1, 0, 0, 0, q_sb, q_sh, q_st,
             o_sb, o_sh, o_st, pos, prefix, 0, scale, n_split, split_cols, ws, tickets),
      L, 1, stream);
}

// Kernel B on int8 codes (L, B, H, T, D) with fp32 scales (L, B, H/g, T).
extern "C" int decode_attn_stacked_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, void* o, int L, int B, int H,
    int T, int D, int Tq, int layer, int tk, int g, long long q_sb,
    long long q_sh, long long q_st, long long o_sb, long long o_sh,
    long long o_st, int pos, const int* pos_arr, int prefix, float scale, int n_split,
    int split_cols, void* ws, void* tickets, void* stream) {
  return launch<int8_t>(
      params(q, k_cache, v_cache, k_scale, v_scale, nullptr, nullptr, nullptr, nullptr, o,
             pos_arr, nullptr, B, H, T, D, Tq, layer, tk, g, 0, 0, 0, q_sb, q_sh, q_st,
             o_sb, o_sh, o_st, pos, prefix, 0, scale, n_split, split_cols, ws, tickets),
      L, 1, stream);
}

// Kernel B's GQA entry: q (B, Hkv * rep, 1, D) bf16 with batch and head
// strides q_sb, q_sh (o likewise), over layer `layer` of the stacked bf16
// (L, B, Hkv, T, D) caches. Pair (b, h) takes query heads h * rep .. h *
// rep + rep - 1 as its rows, all at `pos`. A single (B, Hkv, T, D) layer
// (the single-layer `decode_attention`; rep 1 is its MHA case) is L = 1,
// layer 0, tk = T.
extern "C" int decode_attn_stacked_gqa_bf16(
    const void* q, const void* k_cache, const void* v_cache, void* o, int L,
    int B, int Hkv, int T, int D, int rep, int layer, int tk, long long q_sb,
    long long q_sh, long long o_sb, long long o_sh, int pos, const int* pos_arr,
    int prefix, float scale, int n_split, int split_cols, void* ws, void* tickets,
    void* stream) {
  return launch<bf16>(
      params(q, k_cache, v_cache, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, o,
             pos_arr, nullptr, B, Hkv, T, D, rep, layer, tk, 1, 0, 0, 0, q_sb, rep * q_sh,
             q_sh, o_sb, rep * o_sh, o_sh, pos, prefix, 0, scale, n_split, split_cols, ws,
             tickets),
      L, 0, stream);
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
    int prefix, int prefix_len, float scale, int n_split, int split_cols, void* ws,
    void* tickets, void* stream) {
  return launch<bf16>(
      params(q, k_cache, v_cache, nullptr, nullptr, pref_k, pref_v, nullptr, nullptr, o, pos,
             pids, S, H, T, D, Tq, layer, tk, 1, P, Tp, tp, q_sb, q_sh, q_st, o_sb, o_sh,
             o_st, 0, prefix, prefix_len, scale, n_split, split_cols, ws, tickets),
      L, 1, stream);
}

// Kernel C on int8 codes; scales (L, S, H/g, T) and (L, P, H/g, Tp).
extern "C" int decode_attn_ragged_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* pref_k,
    const void* pref_v, const void* pref_ks, const void* pref_vs, void* o,
    const int* pos, const int* pids, int L, int S, int H, int T, int D,
    int Tq, int layer, int tk, int g, int P, int Tp, int tp, long long q_sb,
    long long q_sh, long long q_st, long long o_sb, long long o_sh,
    long long o_st, int prefix, int prefix_len, float scale, int n_split,
    int split_cols, void* ws, void* tickets, void* stream) {
  return launch<int8_t>(
      params(q, k_cache, v_cache, k_scale, v_scale, pref_k, pref_v, pref_ks, pref_vs, o, pos,
             pids, S, H, T, D, Tq, layer, tk, g, P, Tp, tp, q_sb, q_sh, q_st, o_sb, o_sh,
             o_st, 0, prefix, prefix_len, scale, n_split, split_cols, ws, tickets),
      L, 1, stream);
}
