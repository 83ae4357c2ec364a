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
// The position comes in two forms, as the Pallas kernels take it by scalar
// prefetch (a traced value inside the JAX package's decode loops): a host
// int `pos`, or `pos_dev`, a (B,) int32 array on the device holding batch
// row b's position at pos_dev[b] (kernel B's device form), which a CUDA
// graph's replays advance without a host read. Each block reads its row's
// position once, before the warpgroups split, so that the producer issues
// exactly the KV tiles the consumers wait on. Tk stays the static read
// bound; tiles past the row's last attendable column are still skipped. At
// equal positions both forms run the same tile plan and give the same bits.
//
// Numerics: scores accumulate in fp32 on the tensor cores and are scaled in
// fp32 after the dot (as `_flash_kernel_kvtiled` and the XLA sdpa path do;
// `_flash_kernel` instead folds the scale into q in bf16). Probabilities are
// rounded to bf16 for the PV product, the running denominator sums the fp32
// probabilities, and a zero denominator yields a zero row (attention.py:104).
// Columns at or past Tk are masked, so callers need not pad K/V.
//
// What bounds it on the H100: at the ViT shape (13 crops x 16 heads, 768
// tokens, head_dim 72), the image prefill (32 heads, 730 x 768, head_dim 64)
// and a 2048-token span, the work is ~4 * Tq * Tk * D flops per head against
// ~(Tq + 2 Tk) * D * 2 bytes, far above the card's ~295 flop/byte ridge, so
// the bound is the bf16 tensor-core rate (989 TFLOP/s). The design, after
// FlashAttention-3: one block per (batch * head, 128 query rows) with three
// warpgroups. Warpgroup 2 is the producer: one thread issues TMA loads of the
// Q tile (once) and of K and V tiles of 128 columns into a two-stage ring,
// completed on mbarriers, and gives most of its registers to the consumers
// (setmaxnreg). Warpgroups 0 and 1 own 64 query rows each: S = Q K^T by
// `wgmma` from shared memory into registers, the masked online softmax on
// that register fragment (a row's max and sum reduced across the four lanes
// that share it), P rounded to bf16 in registers as `wgmma`'s A operand,
// and O += P V with V's tile as the shared B operand read MN-major; O stays
// in registers and is rescaled there. No score, probability or output tile
// goes through shared memory. KV tiles past the last column any row of the
// block may attend are never loaded, and the per-element mask runs only on
// tiles that cross the diagonal, the `prefix` edge or Tk (the ViT: one tile
// per block). The two consumer warpgroups interleave on the SM, one in its
// softmax while the other's products run; overlapping the two inside one
// warpgroup (FlashAttention-3's ping-pong) is later work.
//
// Layout: q (B, H, Tq, D), k/v (B, H, Tk, D), o (B, H, Tq, D), each given by
// its batch/head/token strides in elements with a unit stride on D, so the
// ViT's fused-QKV views and the stacked cache's layer views need no copy.
// TMA reads each as a 4-D (D, T, H, B) tensor with byte strides, which must
// be multiples of 16 (and the base 16-byte aligned). A tile lands in shared
// memory as D/8 column blocks of [rows][8] bf16 (16 bytes a row), which is
// `wgmma`'s unswizzled "interleave" layout: 8 x 16-byte core matrices, K-major
// for Q and K, MN-major for V. head_dim D must be a multiple of 8 and <= 80
// (72 in the ViT, 64 in the text model, 16 and 32 in the tiny test config);
// it is padded to DP, a multiple of 16 (72 -> 80): the padding column block
// lies past the tensor's declared extent D, so TMA fills it with zeros.

#include <cuda.h>  // CUtensorMap and the encoder's types; libcuda is reached by dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 128;     // query rows per block: two consumer warpgroups of 64
constexpr int BK = 128;     // kv columns per tile
constexpr int STAGES = 2;   // K/V ring depth
constexpr int NT = 384;     // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Smem {
  bf16 q[BQ * DP];           // [DP / 8][BQ][8]
  bf16 k[STAGES][BK * DP];   // [DP / 8][BK][8] per stage
  bf16 v[STAGES][BK * DP];
  uint64_t q_full;
  uint64_t k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES];
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// One TMA box of a 4-D (D, T, H, B) map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int d, int t, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(d), "r"(t), "r"(h), "r"(b)
      : "memory");
}

// A `wgmma` shared-memory descriptor, unswizzled: `lbo` bytes between core
// matrices along K, `sbo` bytes between core matrices along M or N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Tell the compiler these registers may change here: keeps reads of an
// accumulator after the wait that completes it, and an A operand alive
// until then.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- wgmma shapes the kernel issues (operand lists written out in full) ----
// d (64 x 128, fp32) = (scale_d ? d : 0) + A (64 x 16 bf16, shared, K-major)
// B (16 x 128 bf16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16, fp32) += A (64 x 16 bf16, registers) B (16 x 16 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16 bf16, registers) B (16 x 32 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16 bf16, registers) B (16 x 64 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80, fp32) += A (64 x 16 bf16, registers) B (16 x 80 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (DP == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (DP == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n80(d, a, db);
}

template <int DP>
__global__ void __launch_bounds__(NT, 1) flash_attn_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, int H, int Tq, int Tk,
    int D, long long o_sb, long long o_sh, long long o_st, int pos_host,
    const int* __restrict__ pos_dev, int prefix, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(smem_raw);
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x / 128;
  // One read per thread of one address, before the split: every warpgroup
  // plans the same tiles from it.
  const int pos = pos_dev != nullptr ? pos_dev[b] : pos_host;
  // Skip KV tiles past the last column any row of this q tile may attend.
  const int last_row = min(q0 + BQ, Tq) - 1;
  const int last_col = min(max(pos + last_row, prefix - 1), Tk - 1);
  const int n_kt = last_col / BK + 1;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], CONSUMER_WARPS);
      mbar_init(&sm.v_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the ring full; the warpgroup's registers
    // go to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      constexpr uint32_t TILE_BYTES = BK * DP * sizeof(bf16);
      mbar_expect_tx(&sm.q_full, BQ * DP * sizeof(bf16));
      for (int j = 0; j < DP / 8; ++j)
        tma_load(sm.q + j * BQ * 8, &q_map, &sm.q_full, 8 * j, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        const int round = kt / STAGES;
        if (round > 0) mbar_wait(&sm.k_empty[s], (round - 1) & 1);
        mbar_expect_tx(&sm.k_full[s], TILE_BYTES);
        for (int j = 0; j < DP / 8; ++j)
          tma_load(sm.k[s] + j * BK * 8, &k_map, &sm.k_full[s], 8 * j, kt * BK, h, b);
        if (round > 0) mbar_wait(&sm.v_empty[s], (round - 1) & 1);
        mbar_expect_tx(&sm.v_full[s], TILE_BYTES);
        for (int j = 0; j < DP / 8; ++j)
          tma_load(sm.v[s] + j * BK * 8, &v_map, &sm.v_full[s], 8 * j, kt * BK, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    // This thread holds rows r0 and r0 + 8 of the accumulators (wgmma's
    // fragment: warp w of the warpgroup owns rows 16w..16w+15, lane l rows
    // l/4 and l/4 + 8, columns 8i + 2(l%4) and the next of each n8 block i).
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const bf16* q_wg = sm.q + wg * 64 * 8;
    float oacc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(&sm.q_full, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const int parity = (kt / STAGES) & 1;
      const int k0 = kt * BK;

      // S = Q K^T (64 x BK per warpgroup), fp32 in registers.
      float sacc[BK / 2];
      mbar_wait(&sm.k_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n128(sacc, smem_desc(q_wg + 2 * kk * BQ * 8, BQ * 16, 128),
                      smem_desc(sm.k[s] + 2 * kk * BK * 8, BK * 16, 128), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.k_empty[s]);

      // Scale (into log2 units), and mask unless every row of the block
      // attends every column of the tile.
      const bool full = k0 + BK <= Tk && (k0 + BK - 1 <= pos + q0 ||
                                          (pos + last_row < prefix && k0 + BK <= prefix));
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[4 * i + e] * scale_log2;
          if (!full) {
            const int c = k0 + 8 * i + 2 * t4 + (e & 1);
            const int qp = pos + r0 + 8 * (e >> 1);
            if (!(c < Tk && (c <= qp || (qp < prefix && c < prefix)))) x = -INFINITY;
          }
          sacc[4 * i + e] = x;
        }
      }

      // Online softmax on the fragment: max over masked scores.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with nothing attended yet subtracts 0: its p are all exp2(-inf) = 0
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float alpha0 = exp2f(m0 - mu0), alpha1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pa[BK / 16][4];  // P in bf16 as wgmma's register A operand
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* sc = sacc + 4 * (2 * kk + j);
          p[4 * j] = exp2f(sc[0] - mu0);
          p[4 * j + 1] = exp2f(sc[1] - mu0);
          p[4 * j + 2] = exp2f(sc[2] - mu1);
          p[4 * j + 3] = exp2f(sc[3] - mu1);
          sum0 += p[4 * j] + p[4 * j + 1];
          sum1 += p[4 * j + 2] + p[4 * j + 3];
        }
        pa[kk][0] = pack_bf16(p[0], p[1]);  // row r0,     columns 2t, 2t+1
        pa[kk][1] = pack_bf16(p[2], p[3]);  // row r0 + 8, columns 2t, 2t+1
        pa[kk][2] = pack_bf16(p[4], p[5]);  // row r0,     columns 2t+8, 2t+9
        pa[kk][3] = pack_bf16(p[6], p[7]);  // row r0 + 8, columns 2t+8, 2t+9
      }
      // per-thread partial sums; the four lanes of a row are summed at the end
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        oacc[4 * i] *= alpha0;
        oacc[4 * i + 1] *= alpha0;
        oacc[4 * i + 2] *= alpha1;
        oacc[4 * i + 3] *= alpha1;
      }

      // O += P V: V's tile is B, MN-major (head_dim contiguous per row).
      mbar_wait(&sm.v_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<DP>(oacc, pa[kk], smem_desc(sm.v[s] + kk * 16 * 8, 128, BK * 16));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(oacc);
      reg_fence(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.v_empty[s]);
    }

    // Normalise in registers and write this thread's real rows.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + 2 * t4;
      if (c < D) {
        if (r0 < Tq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_st + c) =
              __floats2bfloat162_rn(oacc[4 * i] * inv0, oacc[4 * i + 1] * inv0);
        if (r0 + 8 < Tq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + 8) * o_st + c) =
              __floats2bfloat162_rn(oacc[4 * i + 2] * inv1, oacc[4 * i + 3] * inv1);
      }
    }
  }
}

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

// A (D, T, H, B) view with element strides st, sh, sb, read in boxes of
// 8 x `rows`. A dimension of size 1 is never stepped; its stride is
// replaced by a harmless one.
bool encode(CUtensorMap* map, const void* base, int D, int T, int H, int B, long long st,
            long long sh, long long sb, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const long long packed = (long long)D * T * H;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(T > 1 ? st : D) * 2,
                                 (cuuint64_t)(H > 1 ? sh : (long long)D * T) * 2,
                                 (cuuint64_t)(B > 1 ? sb : packed) * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Tq,
                   int Tk, int D, const long long* s, int pos, const int* pos_dev, int prefix,
                   float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!encode(&qm, q, D, Tq, H, B, s[2], s[1], s[0], BQ) ||
      !encode(&km, k, D, Tk, H, B, s[5], s[4], s[3], BK) ||
      !encode(&vm, v, D, Tk, H, B, s[8], s[7], s[6], BK))
    return cudaErrorInvalidValue;
  const size_t bytes = sizeof(Smem<DP>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attn_fwd_kernel<DP><<<grid, NT, bytes, stream>>>(qm, km, vm, o, H, Tq, Tk, D, s[9],
                                                         s[10], s[11], pos, pos_dev, prefix,
                                                         scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Tq,
    int Tk, int D, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh,
    long long o_st, int pos, const int* pos_dev, int prefix, float scale, void* stream) {
  const long long s[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                           v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  bool strided = true;  // TMA: 16-byte aligned bases and strides
  for (int i = 0; i < 9; ++i) strided = strided && s[i] % 8 == 0;
  strided = strided && (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
            (uintptr_t)v % 16 == 0;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 80 || D % 8 ||
      B * H > 65535 || !strided || (o_sb | o_sh | o_st) % 2 || (uintptr_t)o % 4)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 16)
    err = launch<16>(qp, kp, vp, op, B, H, Tq, Tk, D, s, pos, pos_dev, prefix, scale, st);
  else if (D <= 32)
    err = launch<32>(qp, kp, vp, op, B, H, Tq, Tk, D, s, pos, pos_dev, prefix, scale, st);
  else if (D <= 64)
    err = launch<64>(qp, kp, vp, op, B, H, Tq, Tk, D, s, pos, pos_dev, prefix, scale, st);
  else
    err = launch<80>(qp, kp, vp, op, B, H, Tq, Tk, D, s, pos, pos_dev, prefix, scale, st);
  return (int)err;
}
