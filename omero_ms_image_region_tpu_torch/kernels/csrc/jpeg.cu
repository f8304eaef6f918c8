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
//       stream bytes zero.  One memset of the wire and a few KB of
//       status words, then one launch that counts, scans and writes in a
//       single pass: block x takes partition x of 128 coefficient blocks
//       (blocks start in index order, as CUB's single-pass scan assumes,
//       so every partition a block waits on is running or done), reads
//       them with 16-byte loads, writes their u8 counts, scans them,
//       publishes their count and last entry, and expands their nonzeros
//       into the partition's entries in shared memory (a rank by popcount
//       over the 8 lanes of a block).  A single-pass chained scan with
//       decoupled lookback gives it the entries before it in the tile and
//       the field of the last of them; then it writes the stream bytes
//       whose last bit lies in its kept entries, by 16-byte runs with one
//       16-byte store where the row's alignment allows.  The stream past the kept entries keeps
//       the memset's zeros; the tile's last partition writes the total.
//       Bound: bytes, the coefficients read and the wire written.
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
constexpr int kEntryBits = 18;
constexpr int kPackThreads = 256;      // K4a
constexpr int kPartBlocks = 128;       // K4a: coefficient blocks a partition
// K4a status words (status_word below), 0 until published.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kHasField = 1ull << 61;

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

// Coefficients 8 * part .. 8 * part + 7 of flat block `blk` of tile b,
// blocks ordered luma, Cb, Cr; one 16-byte load when `vec` (16-byte
// aligned bases).
__device__ __forceinline__ uint4 coeff8(const int16_t* y, const int16_t* cb,
                                        const int16_t* cr, int b,
                                        long long blk, long long nby,
                                        long long nbc, int part, int vec) {
  const int16_t* base;
  if (blk < nby) {
    base = y + (static_cast<long long>(b) * nby + blk) * 64;
  } else if (blk < nby + nbc) {
    base = cb + (static_cast<long long>(b) * nbc + blk - nby) * 64;
  } else {
    base = cr + (static_cast<long long>(b) * nbc + blk - nby - nbc) * 64;
  }
  base += 8 * part;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(base));
  uint4 v;
  uint32_t* w = &v.x;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint16_t>(__ldg(base + 2 * i)) |
           (static_cast<uint32_t>(static_cast<uint16_t>(
                __ldg(base + 2 * i + 1))) << 16);
  return v;
}

// Coefficient q of the eight (selects, so that a q known only at run time
// keeps v in registers).
__device__ __forceinline__ uint32_t coeff_at(const uint4& v, int q) {
  const uint32_t w = (q & 4) ? ((q & 2) ? v.w : v.z) : ((q & 2) ? v.y : v.x);
  return (q & 1) ? (w >> 16) : (w & 0xFFFFu);
}

// Bit q set where coefficient q of the eight is nonzero.
__device__ __forceinline__ unsigned nonzero8(const uint4& v) {
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) m |= (coeff_at(v, q) != 0u ? 1u : 0u) << q;
  return m;
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long v) {
  atomicExch(word, v);
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

// A status word: flag << 62 | has << 61 | field << 32 | count.  `count`
// is the partition's entries (aggregate) or the tile's up to and including
// it (inclusive); `field` the 18-bit field of the last of those entries,
// `has` whether there is one.
__device__ __forceinline__ unsigned long long status_word(
    unsigned long long flag, unsigned count, bool has, uint32_t field) {
  return flag | (has ? kHasField : 0ull) |
         (static_cast<unsigned long long>(field) << 32) | count;
}

// The stream byte whose first bit lies lb bits past the start of entry 0
// (lb >= -18): it meets entry e0 = floor(lb / 18) and possibly e0 + 1,
// each entry(e) an 18-bit field written MSB first.
template <typename Entry>
__device__ __forceinline__ uint32_t stream_byte(int lb, Entry entry) {
  const int e0 = static_cast<int>(static_cast<unsigned>(lb + kEntryBits) /
                                  kEntryBits) - 1;
  const int off = lb - e0 * kEntryBits;
  const uint32_t part0 = ((entry(e0) << off) & 0x3FFFFu) >> 10;
  const uint32_t part1 = off > 10 ? entry(e0 + 1) >> (28 - off) : 0u;
  return (part0 | part1) & 0xFFu;
}

// The block writes stream bytes [jlo, jhi) as byte(j - jlo), by 16-byte
// aligned runs of addresses: four lanes a run, each with one 32-bit word of
// it; the first lane stores the run with one 16-byte store where it lies
// inside [jlo, jhi), and each lane stores its bytes at the ends.
template <typename Byte>
__device__ __forceinline__ void write_stream(uint8_t* stream, long long jlo,
                                             long long jhi, Byte byte) {
  const long long lead = static_cast<long long>(
      reinterpret_cast<uintptr_t>(stream) & 15u);
  const long long runs = (jhi - 1 + lead) / 16 + 1;   // past the last run
  const int w = threadIdx.x & 3;
  const int n = static_cast<int>(jhi - jlo);
  // c0: the warp's first run, so that the loop is uniform over the warp.
  for (long long c0 = (jlo + lead) / 16 + (threadIdx.x & ~31u) / 4;
       c0 < runs; c0 += blockDim.x / 4) {
    const long long c = c0 + ((threadIdx.x & 31) >> 2);
    const int l0 = static_cast<int>(16 * c - lead - jlo);   // run start
    uint32_t word = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = l0 + 4 * w + q;
      if (c < runs && l >= 0 && l < n) word |= byte(l) << (8 * q);
    }
    const uint32_t w1 = __shfl_down_sync(0xFFFFFFFFu, word, 1);
    const uint32_t w2 = __shfl_down_sync(0xFFFFFFFFu, word, 2);
    const uint32_t w3 = __shfl_down_sync(0xFFFFFFFFu, word, 3);
    if (c >= runs) continue;
    if (l0 >= 0 && l0 + 16 <= n) {
      if (w == 0)
        *reinterpret_cast<uint4*>(stream + jlo + l0) =
            make_uint4(word, w1, w2, w3);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = l0 + 4 * w + q;
        if (l >= 0 && l < n)
          stream[jlo + l] = static_cast<uint8_t>(word >> (8 * q));
      }
    }
  }
}

// The least threadIdx.x whose pred holds, or kPackThreads; every thread
// of the block calls it (red: kPackThreads / 32 ints of shared memory).
__device__ __forceinline__ int block_first(int* red, bool pred) {
  const unsigned m = __ballot_sync(0xFFFFFFFFu, pred);
  const int wid = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[wid] = m ? wid * 32 + __ffs(m) - 1
                                            : kPackThreads;
  __syncthreads();
  int first = kPackThreads;
#pragma unroll
  for (int w = 0; w < kPackThreads / 32; ++w)
    first = red[w] < first ? red[w] : first;
  __syncthreads();
  return first;
}

// The sum of v over the block; every thread calls it.
__device__ __forceinline__ unsigned block_sum(int* red, unsigned v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = static_cast<int>(v);
  __syncthreads();
  unsigned sum = 0;
#pragma unroll
  for (int w = 0; w < kPackThreads / 32; ++w)
    sum += static_cast<unsigned>(red[w]);
  __syncthreads();
  return sum;
}

// K4a.  The wire is zero before the launch, and so is status, u64[B *
// parts].  Block x takes partition i = x % parts of tile b = x / parts:
// its 128 coefficient blocks, entries [o_start, o_end).  It writes their
// u8 counts, publishes their count and last entry, expands their nonzeros
// into their entries in shared memory, gets o_start and the field of entry
// o_start - 1 by a block-wide lookback, and writes the stream bytes whose
// last bit lies in its kept entries (those below cap).  The byte that ends
// the kept entries when its last bit lies past them is written by the
// partition that holds entry cap - 1 when total >= cap, else by the tile's
// last partition, which also writes the header; the rest of the stream
// stays zero.
__global__ void __launch_bounds__(kPackThreads)
sparse_pack_kernel(const int16_t* __restrict__ y,
                   const int16_t* __restrict__ cb,
                   const int16_t* __restrict__ cr, long long nby,
                   long long nbc, int B, int parts, int cap, long long width,
                   int vec, uint8_t* __restrict__ wire,
                   unsigned long long* status) {
  constexpr int kRounds = kPartBlocks / (kPackThreads / 8);
  __shared__ uint32_t ent[kPartBlocks * 64];
  __shared__ int s_cnt[kPartBlocks];   // counts, then exclusive offsets
  __shared__ int s_warp[kPartBlocks / 32];
  __shared__ int s_red[kPackThreads / 32];
  __shared__ int s_last_blk;
  __shared__ uint32_t s_own, s_prev;
  const int b = blockIdx.x / parts, i = blockIdx.x - b * parts;
  const long long nb = nby + 2 * nbc;
  const long long blk0 = static_cast<long long>(i) * kPartBlocks;
  const int n = static_cast<int>(
      nb - blk0 < kPartBlocks ? (nb > blk0 ? nb - blk0 : 0) : kPartBlocks);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int g = threadIdx.x >> 3, part = threadIdx.x & 7;

  // Counts: 8 lanes per coefficient block, each with 16 bytes of it.
  uint4 v[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = r * (kPackThreads / 8) + g;
    v[r] = k < n ? coeff8(y, cb, cr, b, blk0 + k, nby, nbc, part, vec)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  uint8_t* row = wire + static_cast<long long>(b) * width;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = r * (kPackThreads / 8) + g;
    int c = __popc(nonzero8(v[r]));
    c += __shfl_xor_sync(0xFFFFFFFFu, c, 1);
    c += __shfl_xor_sync(0xFFFFFFFFu, c, 2);
    c += __shfl_xor_sync(0xFFFFFFFFu, c, 4);
    if (part == 0 && k < n) {
      s_cnt[k] = c;
      row[4 + blk0 + k] = static_cast<uint8_t>(c);
    }
  }
  __syncthreads();

  // The partition's scan (warps 0 .. kPartBlocks / 32 - 1), in place.
  int cnt = 0, incl = 0;
  if (threadIdx.x < kPartBlocks) {
    cnt = threadIdx.x < n ? s_cnt[threadIdx.x] : 0;
    incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) s_warp[wid] = incl;
  }
  __syncthreads();
  int agg = 0;
#pragma unroll
  for (int w = 0; w < kPartBlocks / 32; ++w) {
    if (w < wid) incl += s_warp[w];
    agg += s_warp[w];
  }
  if (threadIdx.x < n) s_cnt[threadIdx.x] = incl - cnt;
  // The partition's last nonzero block, whose last nonzero is its last
  // entry: published with the count before the entries are expanded.
  if (threadIdx.x < n && cnt > 0 && incl == agg) s_last_blk = threadIdx.x;
  __syncthreads();
  const bool own = agg > 0;
  unsigned long long* st = status + static_cast<long long>(b) * parts;
  if (own) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const unsigned m = nonzero8(v[r]);
      const unsigned lanes =
          (__ballot_sync(0xFFFFFFFFu, m != 0) >> (lane & ~7)) & 0xFFu;
      if (r * (kPackThreads / 8) + g == s_last_blk &&
          part == 31 - __clz(lanes)) {
        const int q = 31 - __clz(m);
        s_own = (static_cast<uint32_t>(8 * part + q) << 12) |
                (coeff_at(v[r], q) & 0xFFFu);
      }
    }
  }
  __syncthreads();
  const uint32_t own_field = own ? s_own : 0u;
  if (i > 0 && threadIdx.x == 0)
    publish(st + i, status_word(kAggregate, agg, own, own_field));

  // Each nonzero to its entry, at its block's offset plus its rank.
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = r * (kPackThreads / 8) + g;
    const unsigned m = nonzero8(v[r]);
    int rank = __popc(m);   // then the rank of this lane's first nonzero
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, rank, d, 8);
      if (part >= d) rank += t;
    }
    if (k >= n || m == 0) continue;
    int e = s_cnt[k] + rank - __popc(m);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (m & (1u << q))
        ent[e++] = (static_cast<uint32_t>(8 * part + q) << 12) |
                   (coeff_at(v[r], q) & 0xFFFu);
  }
  __syncthreads();

  // The entries of the tile's earlier partitions and the field of the
  // last of them, by decoupled lookback: the whole block reads
  // kPackThreads predecessors at a time, nearest first.
  unsigned excl = 0;
  bool has = false;
  uint32_t prev = 0u;
  if (i > 0) {
    for (int j = i - 1;; j -= kPackThreads) {
      const int idx = j - static_cast<int>(threadIdx.x);
      unsigned long long s = idx >= 0 ? peek(st + idx) : kInclusive;
      while (__syncthreads_or((s >> 62) == 0))
        if ((s >> 62) == 0) s = peek(st + idx);
      const int done = block_first(s_red, (s >> 62) == 2);
      const int stop = done < kPackThreads ? done : kPackThreads - 1;
      const bool mine = static_cast<int>(threadIdx.x) <= stop;
      excl += block_sum(s_red, mine ? static_cast<unsigned>(s) : 0u);
      const int near = block_first(s_red, mine && (s & kHasField) != 0);
      if (!has && near < kPackThreads) {
        if (static_cast<int>(threadIdx.x) == near)
          s_prev = static_cast<uint32_t>(s >> 32) & 0x3FFFFu;
        __syncthreads();
        has = true;
        prev = s_prev;
      }
      if (done < kPackThreads) break;
    }
  }
  const uint32_t last = own ? own_field : prev;
  if (threadIdx.x == 0)
    publish(st + i, status_word(kInclusive, excl + agg, own || has, last));

  const long long o_start = excl, o_end = o_start + agg;
  const long long kept = o_end < cap ? o_end : cap;
  uint8_t* stream = row + 4 + nb;
  if (o_start < kept) {
    // Bytes from the one that holds entry o_start's first bit; bit
    // offsets and entries counted from that entry.
    const long long jlo = kEntryBits * o_start / 8;
    const long long jhi = o_end >= cap ? (kEntryBits * kept + 7) / 8
                                       : kEntryBits * kept / 8;
    const int c0 = static_cast<int>(8 * jlo - kEntryBits * o_start);
    const int n_kept = static_cast<int>(kept - o_start);
    write_stream(stream, jlo, jhi, [&](int l) {
      return stream_byte(8 * l + c0, [&](int e) {
        return e < 0 ? prev : (e < n_kept ? ent[e] : 0u);
      });
    });
  }
  if (i == parts - 1 && threadIdx.x == 0) {
    const long long total = o_end;
    row[0] = static_cast<uint8_t>(total & 0xFF);
    row[1] = static_cast<uint8_t>((total >> 8) & 0xFF);
    row[2] = static_cast<uint8_t>((total >> 16) & 0xFF);
    row[3] = static_cast<uint8_t>((total >> 24) & 0xFF);
    if (total > 0 && total < cap && (kEntryBits * total) % 8 != 0) {
      // The byte that holds the last entry's last bit, zero after it.
      const long long j = kEntryBits * total / 8;
      stream[j] = static_cast<uint8_t>(stream_byte(
          static_cast<int>(8 * j - kEntryBits * (total - 1)),
          [&](int e) { return e == 0 ? last : 0u; }));
    }
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

// K4a.  y i16[B, nby, 64], cb / cr i16[B, nbc, 64]; buf holds the wire
// u8[B, width], width = 4 + nb + ceil(18 cap / 8), then at the next
// multiple of 8 bytes the status words u64[status_words], status_words at
// least sparse_pack_status_words(B, nb), one per partition of 128 blocks.
// One memset of buf, one launch.
extern "C" long long sparse_pack_status_words(int B, long long nb) {
  const long long parts = nb > 0 ? (nb + kPartBlocks - 1) / kPartBlocks : 1;
  return static_cast<long long>(B) * parts;
}

extern "C" int sparse_pack_launch(const void* y, const void* cb,
                                  const void* cr, int B, long long nby,
                                  long long nbc, int cap, void* buf,
                                  long long width, long long status_words,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const long long nb = nby + 2 * nbc;
  const long long words = sparse_pack_status_words(B, nb);
  if (B < 1 || cap < 1 || status_words < words) return cudaErrorInvalidValue;
  if (words > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  const int parts = static_cast<int>(words / B);
  const long long wire_bytes = (static_cast<long long>(B) * width + 7) / 8 * 8;
  auto* w8 = static_cast<uint8_t*>(buf);
  auto* st = reinterpret_cast<unsigned long long*>(w8 + wire_bytes);
  const int vec = ((reinterpret_cast<uintptr_t>(y) |
                    reinterpret_cast<uintptr_t>(cb) |
                    reinterpret_cast<uintptr_t>(cr)) & 15u) == 0;
  cudaError_t err = cudaMemsetAsync(buf, 0, wire_bytes + 8 * words, s);
  if (err != cudaSuccess) return err;
  sparse_pack_kernel<<<static_cast<unsigned>(words), kPackThreads, 0,
                       s>>>(static_cast<const int16_t*>(y),
                            static_cast<const int16_t*>(cb),
                            static_cast<const int16_t*>(cr), nby, nbc, B,
                            parts, cap, width, vec, w8, st);
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
