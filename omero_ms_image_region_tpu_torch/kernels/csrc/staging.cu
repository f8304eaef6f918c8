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
// The packer writes a block of 32 samples as exactly 32*w bits, w whole
// words, so every block starts on a word boundary, a block's first word is
// the sum of the widths before it, and a sample never reads a word of
// another block.  One launch on the caller's stream, no memset:
//
//   1. widths   each CTA takes kTileRows rows, one warp a row; a warp sums
//               its row's widths (its words).  Byte loads: a warp reads
//               32 neighbouring width bytes, one sector, at any alignment
//               (`widths` follows the words in one upload, 4-byte aligned).
//   2. look-back  the CTA publishes its tile's words as an aggregate; warp
//               0 reads the status words of the tiles before it, 32 at a
//               time, nearest first, until an inclusive one (decoupled
//               look-back), and publishes the tile's inclusive prefix: the
//               tile's first word.  A status word is epoch << 34 | flag <<
//               32 | words: the wrapper gives every call on a stream a new
//               epoch over a scratch that persists per device and stream,
//               so a word of an earlier call never reads as ready and no
//               memset runs (a new scratch is zeroed once; epoch 0 is never
//               given).  Offsets count words in 32 bits (the wrapper refuses
//               2^32 words or more).
//   3. decode   a warp stages a chunk of its row (32 blocks, at most 544
//               words) into shared memory with 4-byte cp.async, all in
//               flight at once, then decodes 128 samples a step: lane j
//               takes 4 neighbouring samples of one block, reads the at
//               most 4 words that hold their bits from shared memory,
//               un-zigzags them and sums them; a warp scan of the lanes'
//               sums, carried from step to step, undoes the row delta; the
//               warp stores 256 contiguous bytes (8 a lane where the row's
//               address allows, else 2-byte stores).
//
// Why shared memory and 4 samples a lane, not a lane a sample with a
// block's words in registers: a lane a sample pays each block of 32
// samples a broadcast of its width and offset, a word load that waits on
// the last block's, two shuffles for the words and a 5-step warp scan plus
// a carry; here a step of 128 samples takes one broadcast read, at most 4
// reads and 5 shuffles, and a chunk's loads are all in flight at once.  On
// the H100 the lane-a-sample decode took 0.0281 ms on the 4 x 1024^2 tile
// against 0.0154 ms for this one, in one run (scripts/k10_redesign.py
// --sweep, its `shfl` variant).
//
// Bound: bytes.  It reads the words and widths once and writes 2 bytes a
// sample (4 x 1024^2 uint16: ~6.1 MB of words at the flagship content,
// 0.13 MB of widths, 8.4 MB out, ~4.4 us at 3.35 TB/s).  Exact wrap to
// 16 bits; width 0 reads no word; a partial last block (its pad samples
// are zero deltas); strided output rows (a band written straight into its
// rows of a [C, H, W] stack); never reads past n_words.  Widths above 17,
// which the packer never writes, are read as 17, so no input reaches past
// shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 8;                  // rows (warps) per CTA
constexpr int kThreads = kTileRows * 32;
constexpr int kMaxWidth = 17;                 // bits of a zigzag 16-bit delta
constexpr int kChunkBlocks = 32;              // blocks a warp stages at once
constexpr int kChunkWords = kChunkBlocks * kMaxWidth;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long v) {
  atomicExch(word, v);
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

__device__ __forceinline__ unsigned warp_incl(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__device__ __forceinline__ unsigned width_at(const uint8_t* w, int b) {
  return min(static_cast<unsigned>(__ldg(w + b)),
             static_cast<unsigned>(kMaxWidth));
}

// 4 bytes from global to shared memory, zero-filled when !valid.
__device__ __forceinline__ void copy_word(uint32_t* dst, const uint32_t* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned unzigzag(unsigned z) {
  return (z >> 1) ^ (0u - (z & 1u));
}

__global__ void __launch_bounds__(kThreads)
unpack16_kernel(const uint32_t* __restrict__ words,
                unsigned long long n_words,
                const uint8_t* __restrict__ widths, long long n_rows,
                int width, int bpr, int rows_per_plane,
                long long plane_stride, long long row_stride,
                uint16_t* __restrict__ out,
                unsigned long long* __restrict__ status,
                unsigned long long epoch) {
  __shared__ uint32_t s_words[kTileRows][kChunkWords];
  __shared__ unsigned s_meta[kTileRows][kChunkBlocks];  // offset << 8 | w
  __shared__ unsigned s_row_words[kTileRows];
  __shared__ unsigned s_first;                        // the tile's first word
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = blockIdx.x;
  const long long row = tile * kTileRows + warp;
  const bool live = row < n_rows;
  const uint8_t* wrow = widths + (live ? row : 0) * bpr;

  // 1. The row's words; the first chunk's widths stay in w.
  const int first_nb = min(kChunkBlocks, bpr);
  unsigned w = live && lane < first_nb ? width_at(wrow, lane) : 0u;
  unsigned sum = w;
  if (live)
    for (int b = lane + kChunkBlocks; b < bpr; b += 32)
      sum += width_at(wrow, b);
  sum = __reduce_add_sync(kFull, sum);
  if (lane == 0) s_row_words[warp] = sum;
  __syncthreads();
  unsigned row_first = 0u, agg = 0u;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    if (r < warp) row_first += s_row_words[r];
    agg += s_row_words[r];
  }

  // 2. Look-back.
  const unsigned long long tag = epoch << 34;
  if (warp == 0) {
    unsigned excl = 0u;
    if (tile == 0) {
      if (lane == 0) publish(status, tag | kInclusive | agg);
    } else {
      if (lane == 0) publish(status + tile, tag | kAggregate | agg);
      for (long long i = tile - 1;; i -= 32) {
        const long long idx = i - lane;
        unsigned long long s =
            idx >= 0 ? peek(status + idx) : tag | kInclusive;
        while (__any_sync(kFull, (s >> 34) != epoch))
          if ((s >> 34) != epoch) s = peek(status + idx);
        const unsigned done = __ballot_sync(kFull, (s & kInclusive) != 0ull);
        const int stop = done ? __ffs(done) - 1 : 31;
        excl += __reduce_add_sync(
            kFull, lane <= stop ? static_cast<unsigned>(s) : 0u);
        if (done) break;
      }
      if (lane == 0) publish(status + tile, tag | kInclusive | (excl + agg));
    }
    if (lane == 0) s_first = excl;
  }
  __syncthreads();
  if (!live) return;

  // 3. Decode, a chunk of 32 blocks at a time.
  const long long plane = row / rows_per_plane;
  uint16_t* orow = out + plane * plane_stride +
                   (row - plane * rows_per_plane) * row_stride;
  const bool vec = (reinterpret_cast<uintptr_t>(orow) & 7u) == 0;
  uint32_t* sw = s_words[warp];
  unsigned* meta = s_meta[warp];
  unsigned base = s_first + row_first;   // the chunk's first word
  unsigned carry = 0u;                   // the last sample decoded
  for (int b0 = 0; b0 < bpr; b0 += kChunkBlocks) {
    const int nb = min(kChunkBlocks, bpr - b0);
    if (b0 > 0) w = lane < nb ? width_at(wrow, b0 + lane) : 0u;
    const unsigned incl = warp_incl(w, lane);
    const unsigned chunk_words = __shfl_sync(kFull, incl, 31);
    meta[lane] = (incl - w) << 8 | w;
    const int col0 = b0 * 32;
    // decode: begin (scripts/k10_redesign.py swaps this part for a variant)
    for (unsigned k = lane; k < chunk_words; k += 32) {
      const unsigned long long i = static_cast<unsigned long long>(base) + k;
      copy_word(sw + k, words + (i < n_words ? i : 0), i < n_words);
    }
    copies_done();
    __syncwarp();
    for (int q = 0; q < nb; q += 4) {
      // Lane j: samples 4*(j & 7) .. +3 of block q + (j >> 3).
      const unsigned m = meta[q + (lane >> 3)];
      const unsigned bw = m & 0xFFu, boff = m >> 8;
      unsigned d[4] = {0u, 0u, 0u, 0u};
      if (bw != 0u) {                    // blocks past nb have w 0
        const unsigned bit = (lane & 7u) * 4u * bw;
        const unsigned wi = boff + (bit >> 5), sh = bit & 31u;
        const unsigned need = (sh + 4u * bw + 31u) >> 5;  // 1..4 words
        const uint32_t a0 = sw[wi];
        const uint32_t a1 = need > 1u ? sw[wi + 1] : 0u;
        const uint32_t a2 = need > 2u ? sw[wi + 2] : 0u;
        const uint32_t a3 = need > 3u ? sw[wi + 3] : 0u;
        const uint64_t lo = static_cast<uint64_t>(a1) << 32 | a0;
        const uint64_t mid = static_cast<uint64_t>(a2) << 32 | a1;
        const uint64_t hi = static_cast<uint64_t>(a3) << 32 | a2;
        const unsigned mask = (1u << bw) - 1u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned o = sh + i * bw;                  // < 83
          const uint64_t v = (o >> 5) == 0u ? lo : (o >> 5) == 1u ? mid : hi;
          d[i] = unzigzag(static_cast<unsigned>(v >> (o & 31u)) & mask);
        }
      }
      d[1] += d[0];
      d[2] += d[1];
      d[3] += d[2];
      const unsigned lane_incl = warp_incl(d[3], lane);
      const unsigned x0 = carry + lane_incl - d[3];
      carry += __reduce_add_sync(kFull, d[3]);
      const int col = col0 + q * 32 + lane * 4;
      const unsigned v0 = x0 + d[0], v1 = x0 + d[1], v2 = x0 + d[2],
                     v3 = x0 + d[3];
      if (vec && col + 3 < width) {
        *reinterpret_cast<uint2*>(orow + col) =
            make_uint2((v0 & 0xFFFFu) | v1 << 16, (v2 & 0xFFFFu) | v3 << 16);
      } else {
        if (col < width) orow[col] = static_cast<uint16_t>(v0);
        if (col + 1 < width) orow[col + 1] = static_cast<uint16_t>(v1);
        if (col + 2 < width) orow[col + 2] = static_cast<uint16_t>(v2);
        if (col + 3 < width) orow[col + 3] = static_cast<uint16_t>(v3);
      }
    }
    // decode: end
    base += chunk_words;
    __syncwarp();                        // before the next chunk's copies
  }
}

}  // namespace

extern "C" {

// Rows a CTA decodes (the wrapper's tile count and scratch size).
int unpack16_tile_rows() { return kTileRows; }

// Decode n_rows rows of `width` samples into `out`: row i is plane
// i / rows_per_plane, row i % rows_per_plane, at out + plane *
// plane_stride + row * row_stride (in samples).  `status` is scratch of
// at least ceil(n_rows / kTileRows) uint64 that no call in flight on
// another stream uses, holding no word tagged `epoch` (1 <= epoch <
// 2^30).  n_words < 2^32.  Returns cudaGetLastError() after the launch.
int unpack16_launch(const void* words, long long n_words, const void* widths,
                    long long n_rows, int width, int rows_per_plane,
                    long long plane_stride, long long row_stride, void* out,
                    void* status, unsigned long long epoch, void* stream) {
  if (n_rows <= 0 || width <= 0) return (int)cudaGetLastError();
  const long long tiles = (n_rows + kTileRows - 1) / kTileRows;
  unpack16_kernel<<<(unsigned int)tiles, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<unsigned long long>(n_words),
      static_cast<const uint8_t*>(widths), n_rows, width, (width + 31) / 32,
      rows_per_plane, plane_stride, row_stride, static_cast<uint16_t*>(out),
      static_cast<unsigned long long*>(status), epoch);
  return (int)cudaGetLastError();
}

}  // extern "C"
