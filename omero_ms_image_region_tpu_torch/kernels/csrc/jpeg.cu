// JPEG front end and sparse wire for Hopper (sm_90a): packed RGBA ->
// quantized zigzag coefficients -> the sparse wire -> compacted rows.
//
// Counterparts of the JAX package's XLA device program
// render_to_jpeg_sparse_compact (omero_ms_image_region_tpu/ops/jpegenc.py
// :443-465), stage by stage:
//
//   jpeg_coefficients (K3) replaces packed_to_jpeg_coefficients (:110, with
//       _dct_quant_zigzag :99).  u32 RGBA -> BT.601 YCbCr (luma - 128),
//       2x2 mean chroma, 8x8 DCT-II D.X.D^T, / quant table, round half to
//       even, clip +-2047, i16, zigzag.  One warp per 16x16 MCU.  The warp
//       reads the packed tile at clamped and mirrored coordinates, so the
//       edge replication of pad_planes_to_mcu (:1632) and the request's
//       flips never materialise.  Bound: bytes, 4 B/px in and 3 B/px out
//       (1024^2, B=1: ~7.3 MB, ~2.2 us at 3.35 TB/s); the DCT is ~32 f32
//       operations per coefficient, far below the card's rate.
//   sparse_pack (K4a) replaces sparse_pack (:191).  Per tile the wire
//       [total i32 LE | counts u8[nb] | 18-bit MSB-first entries
//       pos << 12 | val & 0xFFF], entries past `cap` dropped, the unused
//       stream bytes zero.  A scan-and-scatter in four launches: a warp
//       per 64-coefficient block counts its nonzeros with __ballot_sync /
//       __popc; one block per tile scans the counts into offsets and the
//       total; a warp per block scatters its entries by in-block rank into
//       an i32[cap] scratch; a byte pass assembles the stream exactly as
//       :246-257 does.  Bound: bytes, the coefficients read and the wire
//       written.
//   compact_rows (K4b) replaces _compact_rows (:400) with the row lengths
//       of :457-464 (n_valid masking).  One thread reads each row's header
//       on the card and scans the B lengths; then one grid row per wire row
//       copies its used prefix behind the lengths header, and one more zero
//       fills the tail.  Bound: bytes, twice the used prefix.
//
// Numerics of K3 follow one fixed order: the order in which XLA's CPU
// backend evaluates the JAX function, found by matching its float32 results
// bit for bit.  Every operation is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, and the file is built with -fmad=false)
// except the fused multiply-adds that XLA makes, written out as __fmaf_rn:
//   Y  = fma(0.114, b, fma(0.299, r, 0.587 g)) - 128
//   Cb = fma(0.5, b, fma(-0.168736, r, -(0.331264 g)))
//   Cr = fma(-0.081312, b, fma(0.5, r, -(0.418688 g)))
//   the chroma mean ((a00 + a01) + (a10 + a11)) / 4;
//   each 8-term DCT sum as four lanes, lane s = fma(a[s+4], b[s+4],
//   a[s] b[s]), added (l0 + l1) + (l2 + l3); first T[u][y] = sum_x
//   D[u][x] X[x][y], then C[u][v] = sum_y T[u][y] D[v][y];
//   then / the quant table and rintf (half to even).
// The plain PyTorch version (ops/jpegenc.py
// packed_to_jpeg_coefficients_plain) repeats the same operations with a
// correctly rounded fused multiply-add, so the kernel agrees with it
// exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // K3: MCUs (warps) per block
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;     // K4a scan: one block per tile
constexpr int kEntryBits = 18;

// K3's tables, f32[256] on the card: D[u][x] (64), the luma and chroma
// quant tables in natural order (64 each), and each natural index's zigzag
// position (64, as exact small floats).  Staged in shared memory, because
// the lanes of a warp index them at different places.
constexpr int kTabD = 0, kTabQy = 64, kTabQc = 128, kTabZpos = 192;
constexpr int kTabSize = 256;

// BT.601 full-range weights (ops/jpegenc.py:129-131), as float32.
constexpr float kYr = 0.299f, kYg = 0.587f, kYb = 0.114f;
constexpr float kCbr = -0.168736f, kCbg = 0.331264f, kCbb = 0.5f;
constexpr float kCrr = 0.5f, kCrg = 0.418688f, kCrb = 0.081312f;

__device__ __forceinline__ void ycbcr(int32_t px, float* y, float* cb,
                                      float* cr) {
  const float r = static_cast<float>(px & 0xFF);
  const float g = static_cast<float>((px >> 8) & 0xFF);
  const float b = static_cast<float>((px >> 16) & 0xFF);
  *y = __fsub_rn(__fmaf_rn(kYb, b, __fmaf_rn(kYr, r, __fmul_rn(kYg, g))),
                 128.f);
  *cb = __fmaf_rn(kCbb, b, __fmaf_rn(kCbr, r, -__fmul_rn(kCbg, g)));
  *cr = __fmaf_rn(-kCrb, b, __fmaf_rn(kCrr, r, -__fmul_rn(kCrg, g)));
}

// sum_k a[k * as] * b[k * bs] over k = 0..7 in XLA's order: four lanes,
// each a product and one fused multiply-add, then a pairwise sum.
__device__ __forceinline__ float dot8(const float* a, int as, const float* b,
                                     int bs) {
  float l[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    l[s] = __fmaf_rn(a[(s + 4) * as], b[(s + 4) * bs],
                     __fmul_rn(a[s * as], b[s * bs]));
  return __fadd_rn(__fadd_rn(l[0], l[1]), __fadd_rn(l[2], l[3]));
}

// K3.  Warp w of the grid-stride walk takes MCU m of tile b.  Shared, per
// warp: X[6][64] (four luma blocks, Cb, Cr; natural order) and T[6][64].
__global__ void __launch_bounds__(kThreads)
jpeg_coefficients_kernel(const int32_t* __restrict__ packed, int B, int h,
                         int w, int mh, int mw, int flip_h, int flip_v,
                         const float* __restrict__ tables,
                         int16_t* __restrict__ out_y,
                         int16_t* __restrict__ out_cb,
                         int16_t* __restrict__ out_cr) {
  __shared__ float xs[kWarps][6 * 64];
  __shared__ float ts[kWarps][6 * 64];
  __shared__ float tab[kTabSize];
  for (int i = threadIdx.x; i < kTabSize; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const float* D = tab + kTabD;
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  float* X = xs[wib];
  float* T = ts[wib];
  const long long mcus = static_cast<long long>(mh) * mw;
  const long long all = mcus * B;
  const long long hw = static_cast<long long>(h) * w;

  for (long long m = static_cast<long long>(blockIdx.x) * kWarps + wib;
       m < all; m += static_cast<long long>(gridDim.x) * kWarps) {
    const int b = static_cast<int>(m / mcus);
    const int mi = static_cast<int>(m - static_cast<long long>(b) * mcus);
    const int my = mi / mw, mx = mi - (mi / mw) * mw;
    const int32_t* tile = packed + static_cast<long long>(b) * hw;

    // Colour and subsample: lane handles chroma pixels lane and lane + 32,
    // each the mean of a 2x2 luma quad.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = lane + 32 * half;
      const int cy = ci >> 3, cx = ci & 7;
      float cbs[4], crs[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ly = 2 * cy + (q >> 1), lx = 2 * cx + (q & 1);
        int sy = min(my * 16 + ly, h - 1);
        int sx = min(mx * 16 + lx, w - 1);
        if (flip_v) sy = h - 1 - sy;
        if (flip_h) sx = w - 1 - sx;
        float yv;
        ycbcr(__ldg(tile + static_cast<long long>(sy) * w + sx), &yv, &cbs[q],
              &crs[q]);
        X[((ly >> 3) * 2 + (lx >> 3)) * 64 + (ly & 7) * 8 + (lx & 7)] = yv;
      }
      X[4 * 64 + ci] = __fdiv_rn(
          __fadd_rn(__fadd_rn(cbs[0], cbs[1]), __fadd_rn(cbs[2], cbs[3])),
          4.f);
      X[5 * 64 + ci] = __fdiv_rn(
          __fadd_rn(__fadd_rn(crs[0], crs[1]), __fadd_rn(crs[2], crs[3])),
          4.f);
    }
    __syncwarp();

    // Pass 1: T[k][u][y] = sum_x D[u][x] X[k][x][y].
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const int o = lane + 32 * i;
      const int k = o >> 6, u = (o >> 3) & 7, yy = o & 7;
      T[o] = dot8(D + u * 8, 1, X + k * 64 + yy, 8);
    }
    __syncwarp();

    // Pass 2: C[k][u][v] = sum_y T[k][u][y] D[v][y]; quantize, zigzag.
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const int o = lane + 32 * i;
      const int k = o >> 6, n = o & 63, u = n >> 3, v = n & 7;
      const float acc = dot8(T + k * 64 + u * 8, 1, D + v * 8, 1);
      const float qt = tab[(k < 4 ? kTabQy : kTabQc) + n];
      const float q = fminf(fmaxf(rintf(__fdiv_rn(acc, qt)), -2047.f), 2047.f);
      int16_t* dst;
      if (k < 4) {
        const long long blk =
            static_cast<long long>(2 * my + (k >> 1)) * (2 * mw) + 2 * mx +
            (k & 1);
        dst = out_y + (static_cast<long long>(b) * 4 * mcus + blk) * 64;
      } else {
        dst = (k == 4 ? out_cb : out_cr) +
              (static_cast<long long>(b) * mcus + mi) * 64;
      }
      dst[static_cast<int>(tab[kTabZpos + n])] = static_cast<int16_t>(q);
    }
    __syncwarp();
  }
}

// The i16 coefficient pair (2 * lane, 2 * lane + 1) of flat block `blk` of
// tile b, blocks ordered luma, Cb, Cr.
__device__ __forceinline__ uint32_t coeff_pair(
    const int16_t* y, const int16_t* cb, const int16_t* cr, int b,
    long long blk, long long nby, long long nbc, int lane) {
  const int16_t* base;
  if (blk < nby) {
    base = y + (static_cast<long long>(b) * nby + blk) * 64;
  } else if (blk < nby + nbc) {
    base = cb + (static_cast<long long>(b) * nbc + blk - nby) * 64;
  } else {
    base = cr + (static_cast<long long>(b) * nbc + blk - nby - nbc) * 64;
  }
  return __ldg(reinterpret_cast<const uint32_t*>(base) + lane);
}

// K4a, launch 1: nonzero count per block -> wire counts (u8) and an i32
// copy for the scan.
__global__ void __launch_bounds__(kThreads)
sparse_count_kernel(const int16_t* __restrict__ y,
                    const int16_t* __restrict__ cb,
                    const int16_t* __restrict__ cr, int B, long long nby,
                    long long nbc, long long width,
                    uint8_t* __restrict__ wire,
                    int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long nb = nby + 2 * nbc;
  const long long all = nb * B;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long i = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                     (threadIdx.x >> 5);
       i < all; i += warps) {
    const int b = static_cast<int>(i / nb);
    const long long blk = i - static_cast<long long>(b) * nb;
    const uint32_t pair = coeff_pair(y, cb, cr, b, blk, nby, nbc, lane);
    const unsigned lo = __ballot_sync(0xFFFFFFFFu, (pair & 0xFFFFu) != 0);
    const unsigned hi = __ballot_sync(0xFFFFFFFFu, (pair >> 16) != 0);
    if (lane == 0) {
      const int n = __popc(lo) + __popc(hi);
      counts[i] = n;
      wire[b * width + 4 + blk] = static_cast<uint8_t>(n);
    }
  }
}

// K4a, launch 2: exclusive scan of one tile's block counts (in place ->
// offsets); the total goes to the wire header and to totals[b].
__global__ void __launch_bounds__(kScanThreads)
sparse_scan_kernel(int32_t* __restrict__ counts, long long nb,
                   long long width, uint8_t* __restrict__ wire,
                   int32_t* __restrict__ totals) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int b = blockIdx.x;
  int32_t* c = counts + static_cast<long long>(b) * nb;
  const long long chunk = (nb + kScanThreads - 1) / kScanThreads;
  const long long lo = threadIdx.x * chunk;
  const long long hi = lo + chunk < nb ? lo + chunk : nb;
  int sum = 0;
  for (long long i = lo; i < hi; ++i) sum += c[i];

  // Block exclusive scan of the per-thread sums.
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += v;
    }
    warp_sums[lane] = s;                 // inclusive over warps
  }
  __syncthreads();
  int run = incl - sum + (wid > 0 ? warp_sums[wid - 1] : 0);
  for (long long i = lo; i < hi; ++i) {
    const int n = c[i];
    c[i] = run;
    run += n;
  }
  if (threadIdx.x == kScanThreads - 1) {
    const int total = warp_sums[31];
    totals[b] = total;
    uint8_t* hdr = wire + static_cast<long long>(b) * width;
    hdr[0] = static_cast<uint8_t>(total & 0xFF);
    hdr[1] = static_cast<uint8_t>((total >> 8) & 0xFF);
    hdr[2] = static_cast<uint8_t>((total >> 16) & 0xFF);
    hdr[3] = static_cast<uint8_t>((total >> 24) & 0xFF);
  }
}

// K4a, launch 3: each nonzero's 18-bit field to comp[b][offset + rank]
// when that index is below cap.
__global__ void __launch_bounds__(kThreads)
sparse_scatter_kernel(const int16_t* __restrict__ y,
                      const int16_t* __restrict__ cb,
                      const int16_t* __restrict__ cr, int B, long long nby,
                      long long nbc, const int32_t* __restrict__ offsets,
                      int cap, int32_t* __restrict__ comp) {
  const int lane = threadIdx.x & 31;
  const long long nb = nby + 2 * nbc;
  const long long all = nb * B;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const unsigned below = (1u << lane) - 1u;
  for (long long i = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                     (threadIdx.x >> 5);
       i < all; i += warps) {
    const int b = static_cast<int>(i / nb);
    const long long blk = i - static_cast<long long>(b) * nb;
    const uint32_t pair = coeff_pair(y, cb, cr, b, blk, nby, nbc, lane);
    const int v0 = static_cast<int16_t>(pair & 0xFFFFu);
    const int v1 = static_cast<int16_t>(pair >> 16);
    const unsigned lo = __ballot_sync(0xFFFFFFFFu, v0 != 0);
    const unsigned hi = __ballot_sync(0xFFFFFFFFu, v1 != 0);
    const int rank = __popc(lo & below) + __popc(hi & below);
    const long long base = offsets[i];
    int32_t* dst = comp + static_cast<long long>(b) * cap;
    if (v0 != 0) {
      const long long e = base + rank;
      if (e < cap) dst[e] = ((2 * lane) << 12) | (v0 & 0xFFF);
    }
    if (v1 != 0) {
      const long long e = base + rank + (v0 != 0);
      if (e < cap) dst[e] = ((2 * lane + 1) << 12) | (v1 & 0xFFF);
    }
  }
}

// K4a, launch 4: stream byte j covers bits [8j, 8j + 8), which meet entry
// e0 = 8j / 18 and possibly e0 + 1; entries at or past min(total, cap) read
// as zero.
__global__ void __launch_bounds__(kThreads)
sparse_bytes_kernel(const int32_t* __restrict__ comp,
                    const int32_t* __restrict__ totals, int B, int cap,
                    long long nbytes, long long head, long long width,
                    uint8_t* __restrict__ wire) {
  const long long all = nbytes * B;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < all; i += stride) {
    const int b = static_cast<int>(i / nbytes);
    const long long j = i - static_cast<long long>(b) * nbytes;
    const int total = totals[b];
    const long long used = total < cap ? total : cap;
    const long long bit = j * 8;
    const long long e0 = bit / kEntryBits;
    const int off = static_cast<int>(bit - e0 * kEntryBits);
    const int32_t* c = comp + static_cast<long long>(b) * cap;
    const uint32_t f0 = e0 < used ? static_cast<uint32_t>(c[e0]) : 0u;
    const uint32_t f1 = e0 + 1 < used ? static_cast<uint32_t>(c[e0 + 1]) : 0u;
    const uint32_t part0 = ((f0 << off) & 0x3FFFFu) >> 10;
    const uint32_t part1 = off > 10 ? f1 >> (28 - off) : 0u;
    wire[static_cast<long long>(b) * width + head + j] =
        static_cast<uint8_t>((part0 | part1) & 0xFFu);
  }
}

// K4b, launch 1 (one thread): row lengths from the wire headers, written
// as the i32 LE lengths header; offs[0..B] their exclusive scan.
__global__ void compact_lengths_kernel(const uint8_t* __restrict__ wire,
                                       int B, long long width, int n_valid,
                                       int cap, long long nb,
                                       uint8_t* __restrict__ out,
                                       long long* __restrict__ offs) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  long long run = 0;
  for (int b = 0; b < B; ++b) {
    const uint8_t* hdr = wire + static_cast<long long>(b) * width;
    const int32_t total = static_cast<int32_t>(
        static_cast<uint32_t>(hdr[0]) | (static_cast<uint32_t>(hdr[1]) << 8) |
        (static_cast<uint32_t>(hdr[2]) << 16) |
        (static_cast<uint32_t>(hdr[3]) << 24));
    const long long kept = total < cap ? total : cap;
    int32_t len = static_cast<int32_t>(
        total <= cap ? 4 + nb + (kEntryBits * kept + 7) / 8 : 4 + nb);
    if (b >= n_valid) len = 0;
    out[4 * b] = static_cast<uint8_t>(len & 0xFF);
    out[4 * b + 1] = static_cast<uint8_t>((len >> 8) & 0xFF);
    out[4 * b + 2] = static_cast<uint8_t>((len >> 16) & 0xFF);
    out[4 * b + 3] = static_cast<uint8_t>((len >> 24) & 0xFF);
    offs[b] = run;
    run += len;
  }
  offs[B] = run;
}

// K4b, launch 2: grid row r < B copies row r's prefix to 4B + offs[r];
// grid row B zero-fills everything after the last row.
__global__ void __launch_bounds__(kThreads)
compact_copy_kernel(const uint8_t* __restrict__ wire, int B,
                    long long width, const long long* __restrict__ offs,
                    uint8_t* __restrict__ out) {
  const int r = blockIdx.y;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  uint8_t* dst = out + 4LL * B + offs[r];
  if (r < B) {
    const long long len = offs[r + 1] - offs[r];
    const uint8_t* src = wire + static_cast<long long>(r) * width;
    for (long long i = start; i < len; i += stride) dst[i] = src[i];
  } else {
    const long long len = static_cast<long long>(B) * width - offs[B];
    for (long long i = start; i < len; i += stride) dst[i] = 0;
  }
}

int resident_blocks(const void* kernel, int threads, int fallback) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess ||
      per_sm < 1)
    return fallback;
  return sms * per_sm;
}

unsigned grid_for(long long work, int per_block, int resident) {
  const long long need = (work + per_block - 1) / per_block;
  return static_cast<unsigned>(need < resident ? (need > 0 ? need : 1)
                                               : resident);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each returns cudaGetLastError()
// after its launches (0 = launched).

// K3.  packed i32[B, h, w]; tables f32[256] on the card (layout above);
// out_y i16[B, 4*mh*mw, 64], out_cb / out_cr i16[B, mh*mw, 64] for an
// mh x mw grid of 16x16 MCUs (mh*16 >= h, mw*16 >= w).
extern "C" int jpeg_coefficients_launch(const void* packed, int B, int h,
                                        int w, int mh, int mw, int flip_h,
                                        int flip_v, const void* tables,
                                        void* out_y, void* out_cb,
                                        void* out_cr, void* stream) {
  const long long all = static_cast<long long>(mh) * mw * B;
  const int resident = resident_blocks(
      reinterpret_cast<const void*>(jpeg_coefficients_kernel), kThreads, 132);
  jpeg_coefficients_kernel<<<grid_for(all, kWarps, resident), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), B, h, w, mh, mw, flip_h, flip_v,
      static_cast<const float*>(tables), static_cast<int16_t*>(out_y),
      static_cast<int16_t*>(out_cb), static_cast<int16_t*>(out_cr));
  return cudaGetLastError();
}

// K4a.  y i16[B, nby, 64], cb / cr i16[B, nbc, 64]; wire u8[B, width]
// with width = 4 + nb + ceil(18 cap / 8); scratch counts i32[B, nb],
// totals i32[B], comp i32[B, cap].
extern "C" int sparse_pack_launch(const void* y, const void* cb,
                                  const void* cr, int B, long long nby,
                                  long long nbc, int cap, void* wire,
                                  long long width, void* counts,
                                  void* totals, void* comp, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* iy = static_cast<const int16_t*>(y);
  const auto* icb = static_cast<const int16_t*>(cb);
  const auto* icr = static_cast<const int16_t*>(cr);
  auto* w8 = static_cast<uint8_t*>(wire);
  auto* c32 = static_cast<int32_t*>(counts);
  auto* t32 = static_cast<int32_t*>(totals);
  auto* comp32 = static_cast<int32_t*>(comp);
  const long long nb = nby + 2 * nbc;
  const long long nbytes = (static_cast<long long>(kEntryBits) * cap + 7) / 8;
  const int warps_per_block = kThreads / 32;

  int res = resident_blocks(reinterpret_cast<const void*>(sparse_count_kernel),
                            kThreads, 132);
  sparse_count_kernel<<<grid_for(nb * B, warps_per_block, res), kThreads, 0,
                        s>>>(iy, icb, icr, B, nby, nbc, width, w8, c32);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sparse_scan_kernel<<<B, kScanThreads, 0, s>>>(c32, nb, width, w8, t32);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  res = resident_blocks(reinterpret_cast<const void*>(sparse_scatter_kernel),
                        kThreads, 132);
  sparse_scatter_kernel<<<grid_for(nb * B, warps_per_block, res), kThreads, 0,
                          s>>>(iy, icb, icr, B, nby, nbc, c32, cap, comp32);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  res = resident_blocks(reinterpret_cast<const void*>(sparse_bytes_kernel),
                        kThreads, 132);
  sparse_bytes_kernel<<<grid_for(nbytes * B, kThreads, res), kThreads, 0,
                        s>>>(comp32, t32, B, cap, nbytes, 4 + nb, width, w8);
  return cudaGetLastError();
}

// K4b.  wire u8[B, width] -> out u8[4B + B * width]; scratch offs
// i64[B + 1].
extern "C" int compact_rows_launch(const void* wire, int B, long long width,
                                   int n_valid, int cap, long long nb,
                                   void* out, void* offs, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w8 = static_cast<const uint8_t*>(wire);
  auto* o8 = static_cast<uint8_t*>(out);
  auto* offs64 = static_cast<long long*>(offs);
  compact_lengths_kernel<<<1, 32, 0, s>>>(w8, B, width, n_valid, cap, nb, o8,
                                          offs64);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int res = resident_blocks(
      reinterpret_cast<const void*>(compact_copy_kernel), kThreads, 132);
  const int per_row = res / (B + 1) > 0 ? res / (B + 1) : 1;
  const dim3 grid(grid_for(width, kThreads, per_row), B + 1);
  compact_copy_kernel<<<grid, kThreads, 0, s>>>(w8, B, width, offs64, o8);
  return cudaGetLastError();
}
