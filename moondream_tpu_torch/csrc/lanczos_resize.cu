// PIL-exact Lanczos resize and overlap-crop extraction for Hopper (sm_90a):
// uint8 (B, H, W, 3) images -> their uint8 crop stack (B * per_image, ch,
// cw, 3), equal byte for byte to PIL.Image.resize(LANCZOS) and to the host
// crop path (native/preprocess.cpp), in ONE launch per crop call.
//
// Replaces the JAX package's device resize (moondream_tpu/ops/
// device_preprocess.py:202-229, `_resize_dev_planar`), which XLA computes
// as two einsums over three signed 8-bit digit planes of the tap matrix,
// recombined in int32 and clipped (no Pallas kernel). That design exists to
// put integer products on the TPU's bf16 matrix unit. Here the card's
// integer units do Pillow's arithmetic as it is:
//   acc = 1 << 21;  acc += in[...] * tap[k] over the output's band;
//   out = acc <= 0 ? 0 : acc >= 1 << 30 ? 255 : acc >> 22   (clip8)
// in int32, a horizontal pass first into a uint8-clipped intermediate, then
// the vertical pass over it, as Pillow orders them. |acc| <= 255 * sum|tap|
// < 2^31 for Lanczos-3 (sum|tap| is under 2^23), so nothing overflows and
// the result is exact by construction.
//
// The taps come from the host (ops/device_preprocess.py, Pillow's float64
// precompute_coeffs rounded to 22 bits) as a band per output: start (out,)
// and taps (out, K) int32, output o reading inputs [start[o], start[o] + K);
// a null band is a pass whose size does not change (Pillow skips it), run
// here as one tap of 1 << 22 at start o, which gives the input byte back.
//
// One launch covers up to two crop sets of every image of the batch. A set
// is one resize (OH, OW) of the image and the rows x cols crops of (ch, cw)
// cut from it at (r * window, c * window), written to crops crop0 + r *
// cols + c of the image's per_image: the global crop (one crop, the whole
// 378x378 resize) and the grid (its tiles). A CTA of 256 threads owns one
// TH x TW tile of one set's resized image of one image (blockIdx.y), so a
// pixel in the overlap of two grid crops is computed once and written to
// every crop that holds it. Per tile:
//  1. stage the tile's TW horizontal and TH vertical starts, the crop rows
//     holding each tile row, and the tap rows in shared memory (coalesced;
//     odd row strides keep 32 columns' taps on 32 banks), and reduce the
//     source window: rows [min vstart, max vstart + Kv) and columns
//     [min hstart, max hstart + Kh), whatever the starts' order;
//  2. the horizontal pass streams the window's rows in chunks of the set's
//     ring_rows: chunk i + 1's raw row segments land in one of two shared
//     buffers by 16-byte cp.async copies (from each segment's 16-byte-
//     aligned start) while chunk i is computed; a landed chunk becomes RGBX
//     words in the ring (rows at an odd word stride), and each of its rows'
//     TW outputs,
//     clip8'd, go into a uint8 intermediate tile of window rows x TW x 3
//     bytes (rows at an odd word stride too) that never leaves shared
//     memory; a thread owns two (row, column) outputs at a time, and a
//     warp's rows sit on distinct banks;
//  3. the vertical pass reads the intermediate a 4-byte word at a time
//     (four channel outputs, two rows per thread), clip8s, and stores the
//     tile's row segments to each crop holding them: 4-byte stores where
//     the address allows (a 378-wide crop row is 1134 bytes, so every other
//     row), else 2-byte or single-byte ones.
// The plan (kernels/preprocess.plan_crops, from the host bands) sizes each
// set's TH x TW and chunk rows (a 32-row upscale window in one chunk, the
// global crop's 74-row downscale window in four at 756x1008) and the
// dynamic shared memory, so that the largest tile's taps, ring, raw
// buffers and intermediate fit, with the same layout as below, and four
// CTAs an SM where they can.
//
// Bound by bytes: the raw image read once and the crop stack written once
// (756x1008: 2.29 MB in, 13 crops 5.57 MB out, 2.35 us at 3.35 TB/s). It
// runs far above that: the multiply-adds this design issues (the plan
// counts them: every tap of every band, the window rows that neighbouring
// tiles both compute, the one-tap identity passes; 59.2 M at 756x1008) run
// on the CUDA cores at ~3 instructions each (two shared loads, the byte
// extraction, the IMAD) plus each output's clip8, stores and indexing,
// which sets the figure a CUDA-core design cannot beat: 3.5 us at 64
// multiply-adds per SM per clock on 132 SMs at 1.98 GHz. An int8 mma.sync
// over the taps' digit planes is the route past it.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

// The launch's parameters, as kernels/preprocess.py's ctypes structures lay
// them out (outside the unnamed namespace: the C entry takes them).
struct CropSet {
  const int* hstart;  // (ow,) or null: identity (ow == W)
  const int* htaps;   // (ow, kh) or null
  const int* vstart;  // (oh,) or null: identity (oh == H)
  const int* vtaps;   // (oh, kv) or null
  int kh, kv;         // taps per output (1 for an identity pass)
  int oh, ow;         // the resized image
  int n_rows, n_cols, window, crop0;
  int th, tw;            // the set's CTA tile: TH rows x TW columns of (oh, ow)
  int tiles_y, tiles_x;  // CTA tiles over (oh, ow)
  int ring_rows;         // source rows a chunk of the horizontal pass stages
};

struct CropLaunch {
  CropSet set[2];
  int n_sets;
  int B, H, W;
  int ch, cw, per_image;
  int smem;
};

namespace {

constexpr int kThreads = 256;
constexpr int kRound = 1 << 21;
constexpr int kOne = 1 << 22;       // the identity tap
constexpr int kMaxSmem = 232448;    // what a CTA may use on sm_90
constexpr int kStage = 8;           // tap loads in flight a thread while staging

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t clip8(int acc) {
  if (acc <= 0) return 0;
  if (acc >= (1 << 30)) return 255;
  return static_cast<uint32_t>(acc >> 22);
}

// Bytes lo .. hi - 1 of v to dst[lo .. hi - 1], as one 4-byte or two
// 2-byte stores when the whole word goes to an address that allows it.
__device__ __forceinline__ void put(uint8_t* dst, uint32_t v, int lo, int hi) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (lo == 0 && hi == 4 && (a & 3) == 0) {
    *reinterpret_cast<uint32_t*>(dst) = v;
  } else if (lo == 0 && hi == 4 && (a & 1) == 0) {
    reinterpret_cast<uint16_t*>(dst)[0] = static_cast<uint16_t>(v);
    reinterpret_cast<uint16_t*>(dst)[1] = static_cast<uint16_t>(v >> 16);
  } else {
    for (int e = lo; e < hi; ++e) dst[e] = static_cast<uint8_t>(v >> (8 * e));
  }
}

// n taps, k per output, from src + off (null: the identity tap) to dst at
// a row stride of ks words, kStage loads in flight a thread.
__device__ __forceinline__ void stage_taps(int* dst, const int* src, long long off, int n, int k,
                                           int ks, int tid) {
  for (int base = tid; base < n; base += kThreads * kStage) {
    int v[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = base + j * kThreads;
      v[j] = i < n ? (src ? __ldg(src + off + i) : kOne) : 0;
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = base + j * kThreads, o = i / k;
      if (i < n) dst[o * ks + i - o * k] = v[j];
    }
  }
}

// Where a thread's word column goes: in at most two crop columns (a tile
// is never wider than the window), bytes lo .. hi - 1 of the word, at off
// from the crop row's start in the first crop of the row.
struct WordCols {
  int off[2], lo[2], hi[2];
};

// A word v of the vertical pass's output, the resized image's row gy, to
// every crop of set s holding it: crop rows rr & 0xffff .. rr >> 16, the
// columns of wc.
__device__ __forceinline__ void store_word(uint8_t* img_out, const CropSet& s,
                                           const CropLaunch& p, uint32_t v, int gy, int rr,
                                           const WordCols& wc, long long crop_bytes) {
  for (int r = rr & 0xffff; r <= rr >> 16; ++r) {
    uint8_t* row = img_out + (r * s.n_cols * crop_bytes +
                              static_cast<long long>(gy - r * s.window) * p.cw * 3);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (wc.lo[j] < wc.hi[j]) put(row + wc.off[j], v, wc.lo[j], wc.hi[j]);
  }
}

__global__ void __launch_bounds__(kThreads, 4)
lanczos_crops_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     const CropLaunch p) {
  extern __shared__ __align__(16) int smem[];
  const int tid = threadIdx.x;
  int tile = blockIdx.x;
  const int first = p.set[0].tiles_y * p.set[0].tiles_x;
  const CropSet s = tile < first ? p.set[0] : p.set[1];
  if (tile >= first) tile -= first;
  const long long b = blockIdx.y;
  const int gy0 = (tile / s.tiles_x) * s.th, gx0 = (tile % s.tiles_x) * s.tw;
  const int th = min(s.th, s.oh - gy0), tw = min(s.tw, s.ow - gx0);
  const int khs = s.kh | 1, kvs = s.kv | 1;

  // The layout kernels/preprocess.plan_crops sizes: limits, starts, crop
  // rows, taps, then the ring and the intermediate once the window is known.
  int* lim = smem;                 // column min, column end, row min, row end
  int* hs = lim + 4;               // (tw,) horizontal starts
  int* vs = hs + s.tw;             // (th,) vertical starts
  int* crop_rows = vs + s.th;      // (th,) the crop rows holding each: first | last << 16
  int* ht = crop_rows + s.th;      // (tw, khs) horizontal taps
  int* vt = ht + s.tw * khs;       // (th, kvs) vertical taps
  uint32_t* ring = reinterpret_cast<uint32_t*>(vt + s.th * kvs);

  if (tid == 0) {
    lim[0] = INT_MAX;
    lim[1] = INT_MIN;
    lim[2] = INT_MAX;
    lim[3] = INT_MIN;
  }
  __syncthreads();
  if (tid >= 2 * s.tw && tid < 2 * s.tw + th) {  // crop rows r with 0 <= gy - r * window < ch
    const int gy = gy0 + tid - 2 * s.tw;
    const int hi = s.window > 0 ? min(s.n_rows - 1, gy / s.window) : 0;
    const int lo = s.window > 0 && gy >= p.ch ? (gy - p.ch) / s.window + 1 : 0;
    crop_rows[tid - 2 * s.tw] = lo | (hi << 16);
  }
  if (tid < tw || (tid >= s.tw && tid < s.tw + th)) {  // one start per thread
    const bool h = tid < tw;
    const int o = h ? gx0 + tid : gy0 + tid - s.tw;
    const int* start = h ? s.hstart : s.vstart;
    const int st = start ? __ldg(start + o) : o;
    hs[tid] = st;  // vs follows hs at s.tw
    atomicMin(lim + (h ? 0 : 2), st);
    atomicMax(lim + (h ? 1 : 3), st + (h ? s.kh : s.kv));
  }
  __syncthreads();
  const int c0 = lim[0], segw = lim[1] - c0, r0 = lim[2], rows = lim[3] - r0;
  const int rstride = segw | 1;
  const int n_ring = min(s.ring_rows, rows);
  // the raw rows' two buffers, 16-byte aligned, then the intermediate,
  // (rows, s.tw * 3) bytes at a row stride of an odd number of words: a
  // warp's 32 rows write to 32 banks
  const int raw_row = ((segw * 3 + 15 + 15) / 16) * 16;
  uint8_t* raw = reinterpret_cast<uint8_t*>(smem) +
                 ((reinterpret_cast<uint8_t*>(ring + n_ring * rstride) -
                   reinterpret_cast<uint8_t*>(smem) + 15) / 16) * 16;
  uint8_t* mid = raw + 2 * n_ring * raw_row;
  const int mid_row = s.tw * 3 + 4;

  // 2. the horizontal pass, n_ring source rows at a time: chunk i's rows
  // land in raw buffer i % 2 by 16-byte asynchronous copies while chunk
  // i - 1 is computed, then become RGBX words in the ring
  const long long w3 = static_cast<long long>(p.W) * 3;  // an image row's bytes
  const long long total = static_cast<long long>(p.B) * p.H * w3;
  const long long seg0 = (b * p.H + r0) * w3 + c0 * 3;  // window row 0's first byte
  const int chunks16 = raw_row / 16, step_q = kThreads % chunks16, step_j = kThreads / chunks16;
  auto issue = [&](int rb, uint8_t* buf) {  // rows r0 + rb .. of the window, raw
    const int n = min(n_ring, rows - rb);
    for (int j = tid / chunks16, q = tid % chunks16; j < n;) {
      const long long o = seg0 + (rb + j) * w3;  // the row segment's first byte
      const long long g = (o & ~15LL) + 16 * q;
      uint8_t* dst = buf + j * raw_row + 16 * q;
      if (g + 16 <= total) {
        if (g < o + segw * 3) cp_async16(dst, in + g);
      } else {  // the batch's last bytes: no read past its end
        for (long long e = g; e < total; ++e) dst[e - g] = in[e];
      }
      j += step_j;
      q += step_q;
      if (q >= chunks16) {
        q -= chunks16;
        ++j;
      }
    }
  };
  issue(0, raw);
  cp_async_commit();
  stage_taps(ht, s.htaps, static_cast<long long>(gx0) * s.kh, tw * s.kh, s.kh, khs, tid);
  stage_taps(vt, s.vtaps, static_cast<long long>(gy0) * s.kv, th * s.kv, s.kv, kvs, tid);
  for (int rb = 0, i = 0; rb < rows; rb += n_ring, ++i) {
    const int n = min(n_ring, rows - rb);
    if (rb + n_ring < rows) issue(rb + n_ring, raw + ((i + 1) & 1) * n_ring * raw_row);
    cp_async_commit();
    cp_async_wait1();  // chunk i has landed (the next may be in flight)
    __syncthreads();
    {  // raw rows -> RGBX words, at each row's own offset in its buffer
      const uint8_t* buf = raw + (i & 1) * n_ring * raw_row;
      const int lead0 = static_cast<int>((seg0 + rb * w3) & 15), w3_16 = static_cast<int>(w3 & 15);
      const int drow = kThreads / segw, dcol = kThreads - drow * segw;
      int row = tid / segw, col = tid - row * segw;
      while (row < n) {
        const uint8_t* px = buf + row * raw_row + ((lead0 + row * w3_16) & 15) + 3 * col;
        ring[row * rstride + col] = static_cast<uint32_t>(px[0]) |
                                    (static_cast<uint32_t>(px[1]) << 8) |
                                    (static_cast<uint32_t>(px[2]) << 16);
        row += drow;
        col += dcol;
        if (col >= segw) {
          col -= segw;
          ++row;
        }
      }
    }
    __syncthreads();
    {  // outputs (row, x), row fastest (a warp's rows on distinct banks),
       // two a thread at a time: items i and i + kThreads
      int row = tid % n, x = tid / n;
      const int dx = kThreads / n, drow = kThreads - dx * n;
      while (x < tw) {
        int row2 = row + drow, x2 = x + dx;
        if (row2 >= n) {
          row2 -= n;
          ++x2;
        }
        const bool two = x2 < tw;
        if (!two) x2 = x, row2 = row;
        const uint32_t* pa = ring + row * rstride + (hs[x] - c0);
        const uint32_t* pb = ring + row2 * rstride + (hs[x2] - c0);
        const int* ta = ht + x * khs;
        const int* tb = ht + x2 * khs;
        int a0 = kRound, a1 = kRound, a2 = kRound, b0 = kRound, b1 = kRound, b2 = kRound;
#pragma unroll 4
        for (int k = 0; k < s.kh; ++k) {
          const int wa = ta[k], wb = tb[k];
          const uint32_t u = pa[k], v = pb[k];
          a0 += static_cast<int>(u & 0xff) * wa;
          a1 += static_cast<int>(__byte_perm(u, 0, 0x4441)) * wa;
          a2 += static_cast<int>(u >> 16) * wa;
          b0 += static_cast<int>(v & 0xff) * wb;
          b1 += static_cast<int>(__byte_perm(v, 0, 0x4441)) * wb;
          b2 += static_cast<int>(v >> 16) * wb;
        }
        uint8_t* m = mid + (rb + row) * mid_row + x * 3;
        m[0] = static_cast<uint8_t>(clip8(a0));
        m[1] = static_cast<uint8_t>(clip8(a1));
        m[2] = static_cast<uint8_t>(clip8(a2));
        if (two) {
          m = mid + (rb + row2) * mid_row + x2 * 3;
          m[0] = static_cast<uint8_t>(clip8(b0));
          m[1] = static_cast<uint8_t>(clip8(b1));
          m[2] = static_cast<uint8_t>(clip8(b2));
        }
        row = row2 + drow;  // item i + 2 * kThreads
        x = x2 + dx;
        if (row >= n) {
          row -= n;
          ++x;
        }
      }
    }
  }
  __syncthreads();

  // 3. the vertical pass: a thread owns one 4-byte word column of the tile
  // (four channel outputs a row) for every ystep-th row, and writes each
  // word to every crop that holds it
  const int mstride = mid_row / 4, wpr = s.tw * 3 / 4, ystep = kThreads / wpr;
  const int wi = tid % wpr, bytes = tw * 3;
  if (tid >= ystep * wpr || 4 * wi >= bytes) return;
  const uint32_t* midw = reinterpret_cast<const uint32_t*>(mid) + wi;
  const int xb = gx0 * 3 + 4 * wi;  // the word's first byte in the resized row
  const int c_lo = s.window > 0 && gx0 >= p.cw ? (gx0 - p.cw) / s.window + 1 : 0;
  const int c_hi = s.window > 0 ? min(s.n_cols - 1, (gx0 + tw - 1) / s.window) : 0;
  const long long crop_bytes = static_cast<long long>(p.ch) * p.cw * 3;
  uint8_t* img_out = out + (b * p.per_image + s.crop0) * crop_bytes + xb;
  WordCols wc;
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // crop columns c_lo, c_lo + 1 (<= c_hi)
    const int c = c_lo + j, cb = c * s.window * 3;  // crop c's first byte in the resized row
    wc.off[j] = static_cast<int>(c * crop_bytes - cb);
    wc.lo[j] = max(cb - xb, 0);
    wc.hi[j] = c > c_hi ? 0 : min(min(cb + p.cw * 3 - xb, 4), bytes - 4 * wi);
  }
  for (int y = tid / wpr; y < th; y += 2 * ystep) {
    const int y2 = min(y + ystep, th - 1);  // the second row (a repeat where there is none)
    const uint32_t* ma = midw + (vs[y] - r0) * mstride;
    const uint32_t* mb = midw + (vs[y2] - r0) * mstride;
    const int* ta = vt + y * kvs;
    const int* tb = vt + y2 * kvs;
    int a0 = kRound, a1 = kRound, a2 = kRound, a3 = kRound;
    int b0 = kRound, b1 = kRound, b2 = kRound, b3 = kRound;
#pragma unroll 4
    for (int k = 0; k < s.kv; ++k) {
      const int wa = ta[k], wb = tb[k];
      const uint32_t u = ma[k * mstride], v = mb[k * mstride];
      a0 += static_cast<int>(u & 0xff) * wa;
      a1 += static_cast<int>(__byte_perm(u, 0, 0x4441)) * wa;
      a2 += static_cast<int>(__byte_perm(u, 0, 0x4442)) * wa;
      a3 += static_cast<int>(u >> 24) * wa;
      b0 += static_cast<int>(v & 0xff) * wb;
      b1 += static_cast<int>(__byte_perm(v, 0, 0x4441)) * wb;
      b2 += static_cast<int>(__byte_perm(v, 0, 0x4442)) * wb;
      b3 += static_cast<int>(v >> 24) * wb;
    }
    store_word(img_out, s, p, clip8(a0) | (clip8(a1) << 8) | (clip8(a2) << 16) |
               (clip8(a3) << 24), gy0 + y, crop_rows[y], wc, crop_bytes);
    if (y + ystep < th)
      store_word(img_out, s, p, clip8(b0) | (clip8(b1) << 8) | (clip8(b2) << 16) |
                 (clip8(b3) << 24), gy0 + y2, crop_rows[y2], wc, crop_bytes);
  }
}

}  // namespace

// Lets the kernel use up to 227 KB of dynamic shared memory on the current
// device. Call once per device, before the first launch there and outside
// any stream capture.
extern "C" int lanczos_crops_prepare() {
  const cudaError_t e = cudaFuncSetAttribute(
      lanczos_crops_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(lanczos_crops_kernel,
                                   cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

// One launch: in (B, H, W, 3) uint8, out (B * per_image, ch, cw, 3) uint8,
// the sets and the plan in *p (kernels/preprocess.py fills it and checks
// the tensors; this checks the geometry again and refuses what the kernel
// does not take). Launches on `stream` without synchronising.
extern "C" int lanczos_crops_u8(const void* in, void* out, const CropLaunch* p, void* stream) {
  if (p == nullptr || p->B <= 0 || p->B > 65535 || p->H <= 0 || p->W <= 0 || p->ch <= 0 ||
      p->cw <= 0 || p->per_image <= 0 || p->n_sets < 1 || p->n_sets > 2 || p->smem <= 0 ||
      p->smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  long long tiles = 0;
  for (int i = 0; i < p->n_sets; ++i) {
    const CropSet& s = p->set[i];
    const bool h_id = s.hstart == nullptr, v_id = s.vstart == nullptr;
    if ((h_id != (s.htaps == nullptr)) || (v_id != (s.vtaps == nullptr)) ||
        (h_id ? (s.ow != p->W || s.kh != 1) : (s.kh <= 0 || s.kh > p->W || s.ow <= 0)) ||
        (v_id ? (s.oh != p->H || s.kv != 1) : (s.kv <= 0 || s.kv > p->H || s.oh <= 0)) ||
        s.n_rows <= 0 || s.n_cols <= 0 || s.window < 0 ||
        (s.window == 0 && (s.n_rows > 1 || s.n_cols > 1)) ||
        (s.n_rows - 1) * s.window + p->ch > s.oh || (s.n_cols - 1) * s.window + p->cw > s.ow ||
        s.crop0 < 0 || s.crop0 + s.n_rows * s.n_cols > p->per_image || s.th <= 0 ||
        s.tw < 8 || s.tw % 8 != 0 || 2 * s.tw + s.th > kThreads || s.n_rows > 0xffff ||
        s.ring_rows <= 0 || (s.n_cols > 1 && s.tw > s.window) ||
        static_cast<long long>(s.n_cols) * p->ch * p->cw * 3 > INT_MAX ||
        s.tiles_y != (s.oh + s.th - 1) / s.th || s.tiles_x != (s.ow + s.tw - 1) / s.tw)
      return (int)cudaErrorInvalidValue;
    tiles += static_cast<long long>(s.tiles_y) * s.tiles_x;
  }
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  CropLaunch q = *p;
  if (q.n_sets == 1) {
    q.set[1] = q.set[0];
    q.set[1].tiles_y = q.set[1].tiles_x = 0;
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(q.B));
  lanczos_crops_kernel<<<grid, kThreads, q.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), q);
  return (int)cudaGetLastError();
}
