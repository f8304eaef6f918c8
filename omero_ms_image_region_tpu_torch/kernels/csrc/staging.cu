// K10: the device inverse of the packed host->device staging.
//
// Replaces the JAX package's io/staging.py::unpack16_device (:53), the
// XLA program that decodes native/wirepack.cpp's layout on the device:
//
//   blocks of 32 samples along each row, widths[r*bpr + b] in 0..17 bits
//   a sample; block b of row r starts at bit 32 * (sum of the widths of
//   every block before it, rows before r included); sample j of a block
//   sits LSB-first at offset + j*w; a sample is zigzag(row delta), the
//   first of a row absolute.  Decode: gather, mask, un-zigzag, then an
//   inclusive scan along the row, wrapped to 16 bits.
//
// Three launches on the caller's stream:
//   1. row_bits_kernel     one warp a row: the row's packed bits;
//   2. row_offsets_kernel  one CTA: the exclusive scan of (1) over all
//                          rows, in 64 bits (JAX computes the offsets in
//                          int32, whence its _MAX_STAGE_SAMPLES gate; the
//                          gate stays in io/staging.py so both packages
//                          pack the same planes);
//   3. unpack16_kernel     one CTA a row, a thread a sample: warp k of a
//                          chunk of blockDim samples decodes block k
//                          (a warp scan of the chunk's 32 widths gives
//                          each block's bit offset), then a CTA scan of
//                          the deltas, carried from chunk to chunk.
//
// Bound: bytes.  It reads the words and widths once and writes 2 bytes a
// sample (4 x 1024^2 uint16: ~6.1 MB of words at the flagship content,
// 0.13 MB of widths, 8.4 MB out, ~4.4 us at 3.35 TB/s).  A sample's two
// word reads hit the same or the next word as its neighbours', so a warp
// reads ~w+1 consecutive words: the gathers coalesce.  The output row is
// written as one coalesced run of 2-byte stores; a row may be a strided
// view (a band written straight into its rows of a [C, H, W] plane stack,
// with no concatenation afterwards).  Never reads past n_words: a width-0
// block reads nothing, and a sample's second word is read only when the
// sample crosses into it and it exists (JAX clamps that index, :80-83).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowBitsWarps = 8;     // rows per CTA of row_bits_kernel
constexpr int kScanThreads = 1024;   // row_offsets_kernel's one CTA
constexpr int kScanItems = 4;        // rows per thread per pass

__device__ __forceinline__ unsigned int warp_incl_u32(unsigned int v,
                                                      int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__device__ __forceinline__ long long warp_incl_i64(long long v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// 32 * sum(widths) of each row.
__global__ void row_bits_kernel(const uint8_t* __restrict__ widths,
                                long long n_rows, int bpr,
                                long long* __restrict__ row_bits) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowBitsWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;               // the whole warp leaves
  const uint8_t* w = widths + row * bpr;
  long long sum = 0;
  for (int b = lane; b < bpr; b += 32) sum += w[b];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, o);
  if (lane == 0) row_bits[row] = sum * 32;
}

// In place: row_bits -> the exclusive prefix sums (each row's first bit).
__global__ void __launch_bounds__(kScanThreads)
row_offsets_kernel(long long* __restrict__ bits, long long n_rows) {
  __shared__ long long warp_sums[kScanThreads / 32];
  __shared__ long long chunk_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long carry = 0;
  for (long long base = 0; base < n_rows;
       base += (long long)kScanThreads * kScanItems) {
    const long long first = base + (long long)tid * kScanItems;
    long long v[kScanItems];
    long long local = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      v[i] = first + i < n_rows ? bits[first + i] : 0;
      local += v[i];
    }
    const long long incl = warp_incl_i64(local, lane);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const long long s = warp_sums[lane];
      const long long si = warp_incl_i64(s, lane);
      warp_sums[lane] = si - s;
      if (lane == 31) chunk_total = si;
    }
    __syncthreads();
    long long run = carry + warp_sums[warp] + incl - local;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (first + i < n_rows) bits[first + i] = run;
      run += v[i];
    }
    carry += chunk_total;
    __syncthreads();
  }
}

// One CTA a row; blockDim.x a multiple of 32, at most 1024.
__global__ void __launch_bounds__(1024)
unpack16_kernel(const uint32_t* __restrict__ words, long long n_words,
                const uint8_t* __restrict__ widths,
                const long long* __restrict__ row_off, int width, int bpr,
                int rows_per_plane, long long plane_stride,
                long long row_stride, uint16_t* __restrict__ out) {
  __shared__ unsigned int block_off[32];   // a chunk's blocks, from its start
  __shared__ unsigned int warp_tot[32];
  __shared__ unsigned int chunk_bits;
  __shared__ unsigned int last;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint8_t* wrow = widths + row * bpr;
  const long long plane = row / rows_per_plane;
  uint16_t* orow = out + plane * plane_stride +
                   (row - plane * rows_per_plane) * row_stride;
  long long bit_base = row_off[row];
  unsigned int value = 0;                  // the last sample decoded
  for (int c0 = 0; c0 < width; c0 += blockDim.x) {
    const int b0 = c0 >> 5;                // warp k decodes block b0 + k
    if (warp == 0) {
      const int b = b0 + lane;
      const unsigned int bits =
          (lane < nwarps && b < bpr) ? 32u * wrow[b] : 0u;
      const unsigned int incl = warp_incl_u32(bits, lane);
      block_off[lane] = incl - bits;
      if (lane == 31) chunk_bits = incl;
    }
    __syncthreads();
    const int col = c0 + tid;
    unsigned int d = 0;
    if (col < width) {
      const unsigned int w = wrow[b0 + warp];
      if (w != 0) {
        const long long pos = bit_base + block_off[warp] +
                              (long long)lane * w;
        const long long wi = pos >> 5;
        const unsigned int sh = (unsigned int)(pos & 31);
        const unsigned int lo = wi < n_words ? __ldg(words + wi) >> sh : 0u;
        const unsigned int hi = (sh != 0 && wi + 1 < n_words)
                                    ? __ldg(words + wi + 1) << (32u - sh)
                                    : 0u;
        const unsigned int mask = w >= 32 ? 0xffffffffu : (1u << w) - 1u;
        const unsigned int z = (lo | hi) & mask;
        d = (z >> 1) ^ (0u - (z & 1u));    // un-zigzag
      }
    }
    const unsigned int incl = warp_incl_u32(d, lane);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const unsigned int t = lane < nwarps ? warp_tot[lane] : 0u;
      warp_tot[lane] = warp_incl_u32(t, lane) - t;
    }
    __syncthreads();
    const unsigned int x = value + warp_tot[warp] + incl;
    if (col < width) orow[col] = (uint16_t)x;
    if (tid == (int)blockDim.x - 1) last = x;
    bit_base += chunk_bits;
    __syncthreads();
    value = last;
  }
}

}  // namespace

extern "C" {

// Decode n_rows rows of `width` samples into `out`: row i is plane
// i / rows_per_plane, row i % rows_per_plane, at out + plane *
// plane_stride + row * row_stride (in samples).  `row_off` is scratch of
// n_rows int64.  Returns cudaGetLastError() after the launches.
int unpack16_launch(const void* words, long long n_words, const void* widths,
                    long long n_rows, int width, int rows_per_plane,
                    long long plane_stride, long long row_stride, void* out,
                    void* row_off, void* stream) {
  if (n_rows <= 0 || width <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bpr = (width + 31) / 32;
  long long* off = static_cast<long long*>(row_off);
  const long long bits_grid = (n_rows + kRowBitsWarps - 1) / kRowBitsWarps;
  row_bits_kernel<<<(unsigned int)bits_grid, kRowBitsWarps * 32, 0, s>>>(
      static_cast<const uint8_t*>(widths), n_rows, bpr, off);
  row_offsets_kernel<<<1, kScanThreads, 0, s>>>(off, n_rows);
  int threads = ((width + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  unpack16_kernel<<<(unsigned int)n_rows, threads, 0, s>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const uint8_t*>(widths), off, width, bpr, rows_per_plane,
      plane_stride, row_stride, static_cast<uint16_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
