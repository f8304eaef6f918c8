// JPEG front end and device wires for Hopper (sm_90a): packed RGBA ->
// quantized zigzag coefficients -> the sparse wire or the Huffman wire ->
// compacted rows, or the full-grid Huffman stream of the bitpack engine.
//
// Counterparts of the JAX package's XLA device programs
// render_to_jpeg_sparse_compact and render_to_jpeg_huffman_compact
// (omero_ms_image_region_tpu/ops/jpegenc.py :443-465, :470-492), stage by
// stage:
//
//   jpeg_coefficients (K3) replaces packed_to_jpeg_coefficients (:110, with
//       _dct_quant_zigzag :99).  u32 RGBA -> BT.601 YCbCr (luma - 128),
//       2x2 mean chroma, 8x8 DCT-II D.X.D^T, / quant table, round half to
//       even, clip +-2047, i16, zigzag.  Persistent 128-thread blocks walk
//       the batch's MCUs two at a time (twelve 8x8 blocks).  Warps 0-2 run
//       the DCT: each of their 96 threads owns one 8-vector, column y of a
//       block in pass 1 (T[.][y] from X[.][y]) and row u of T in pass 2
//       (C[u][.]), so each X and T value is one shared load, and D is a
//       compile-time literal, an immediate operand.  Warp 3 moves bytes: it
//       copies the next pair's pixels into a double-buffered shared strip
//       with cp.async (16 bytes a row quad) during pass 1 and stores the
//       last pair's coefficients during pass 2, so neither waits on
//       memory.  All four warps convert colour from the strip, one quad a
//       thread, the 2x2 chroma sums meeting by a shuffle between the two
//       rows' lanes.  Pass 2 reads its row's quant values and reciprocals
//       once a pair, divides by a multiply and two FMAs, rounds by an add,
//       and scatters its 8 coefficients to their zigzag slots in shared
//       memory; a block's 128 bytes then leave as eight 16-byte stores.
//       Reads at clamped and mirrored coordinates give the edge
//       replication of pad_planes_to_mcu (:1632) and the request's flips;
//       a quad past the tile's right edge or of an unaligned tile is read
//       pixel by pixel.  Bound: bytes, 4 B/px in and 3 B/px out (1024^2,
//       B=1: ~7.3 MB, ~2.2 us at 3.35 TB/s); the fixed evaluation order
//       below leaves ~29 f32 instructions a coefficient and ~17 a pixel,
//       about as long at the card's instruction rate, and the integer and
//       shared-memory work around them makes instruction issue, not
//       memory, what sets its time.
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
//       of :457-464 (n_valid masking).  One launch: every block reads the
//       B row headers and scans their lengths (a warp scan, 32 rows at a
//       time), then its threads write the output in 16-byte aligned runs:
//       a run inside one row's prefix from aligned source words by funnel
//       shifts, a run of the zero tail as zeros, and the few runs that
//       straddle the lengths header, a row boundary or an end of the
//       output byte by byte.  Bound: bytes, the used prefixes read and
//       the whole output written.  The same launch compacts the Huffman
//       wire's rows with the row lengths of :486-492 (mode 1): 8 + 4
//       ceil(bits / 32) bytes, or the 8-byte header alone for a row over
//       cap entries or 32 cap_words bits.
//   huffman_pack (K5) replaces huffman_pack (:991-1207), the engine of
//       render_to_jpeg_huffman_compact (:470).  Per tile the row [total
//       nonzeros i32 | total bits i32 | words u32[cap_words]]: the JPEG
//       entropy stream of the tile's blocks in MCU scan order (Y0..Y3, Cb,
//       Cr; raster Y block (2my+dy, 2mx+dx) into scan slot (my, mx, dy,
//       dx)) with one shared DC and one AC table given as runtime data
//       (the fixed spec or a tuned one, no rebuild): each block's DC
//       difference against its component's predecessor, each nonzero AC
//       coefficient's ZRL codes (up to three) and run/size code with its
//       amplitude, the EOB, every field MSB first from bit
//       0 of word 0 (field at bit rb of word w sits at 32 - rb - len, the
//       u32 values of :1169-1185, which _entropy_bytes byte-swaps).  One
//       memset (the rows and a status word a chunk) and one launch: a
//       block of 128 threads takes a chunk of 128 coefficient blocks in
//       scan order (1536 chunks for B=8 1024^2 tiles, 192 for B=1), stages
//       them in shared memory with 16-byte loads, and each thread codes
//       its block once, walking the set bits of its nonzero mask, into
//       its own words in shared memory; a scan of the block lengths in
//       the chunk and a decoupled lookback over the tile's earlier chunks
//       (as K4a does) give every block its stream bit, and the thread of
//       the block where a word begins gathers the word from the blocks'
//       words and stores it, coalesced; only the chunk's first and last
//       words, which it can share with its neighbours, go through a
//       global atomicOr.  Index math is 32-bit (a fast division a CTA and
//       a load).  Words at or past cap_words are dropped, never written.
//       On a row within its budgets (total <= cap, bits <= 32 cap_words)
//       the header and words equal the JAX function's.  On a row over
//       cap entries JAX drops the entries past cap, so its total bits
//       count a cut stream; here they count the whole stream: total and
//       the overflow decision agree, and K4b keeps only the 8-byte header
//       of such a row, which the host codes from dense coefficients.
//       Bound: bytes, the coefficients read and the used words written;
//       a thread's work is its block's nonzeros (about five a block at
//       the flagship's q 85), so the integer work per nonzero and the
//       load latency, not the bytes, set the time.
//   bitpack_fixed (K6) replaces _bitpack_fixed (:833-945), the engine of
//       render_to_jpeg_bits (:948) and TpuJpegEncoder (:1307), the direct
//       renderer's bitpack engine.  Per tile the words u32[cap_words] of
//       the same full-grid stream as K5's (every block in MCU scan order,
//       the order given as the scan map _mcu_scan_index, :807), with no
//       compaction, no row header and no budget retry, zero past the
//       stream, and its whole length in bits.  The JAX function deposits
//       every field by a scatter-add of int32 values into the one or two
//       words it touches.  Here one launch and no memset: a block of 128
//       threads takes a chunk of 128 coefficient blocks, copies them in
//       with cp.async, and each thread codes its block once, MSB first,
//       into its own words; a block scan and a decoupled look-back over a
//       window of 128 earlier chunks (status words tagged with the call's
//       epoch, in a scratch kept per device and stream, kernels/scratch.py)
//       give each block its stream bit; the words are packed into the
//       chunk's shared memory, and every word is stored once, whole and
//       plainly, by the chunk in which it begins: the word where a chunk
//       ends takes the next chunk's first bits, which a warp codes from
//       the staged next blocks, a lane a block.  Adds, not ors, where
//       JAX's adds differ: a clamped category-11 field of a value below
//       -2047 carries sign bits past its length into its word; a chunk
//       holding one sums its words with JAX's int32 shifts (global
//       atomicAdd on the words it owns, which no other chunk stores to;
//       its blocks are walked a second time).  Zeroing blocks at the end
//       of the grid store the words past each tile's stream once the
//       tile's last chunk has published its total.  Words at or past
//       cap_words are dropped.  Bound: bytes, the coefficients read and
//       the used words written; as K5, a thread's work is its block's
//       nonzeros, and the loads' and the look-back's latency set the time
//       of one tile.
//
// Numerics of K3 follow one fixed order: the order in which XLA's CPU
// backend evaluates the JAX function, found by matching its float32 results
// bit for bit.  Every operation is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, and the file is built with -fmad=false)
// except the fused multiply-adds that XLA makes, written out as __fmaf_rn:
//   Y  = fma(0.114, b, fma(0.299, r, 0.587 g)) - 128
//   Cb = fma(0.5, b, fma(-0.168736, r, -(0.331264 g)))
//   Cr = fma(-0.081312, b, fma(0.5, r, -(0.418688 g)))
//   the chroma mean ((a00 + a01) + (a10 + a11)) / 4 (as * 0.25, the same
//   float: see colour_quad);
//   each 8-term DCT sum as four lanes, lane s = fma(a[s+4], b[s+4],
//   a[s] b[s]), added (l0 + l1) + (l2 + l3); first T[u][y] = sum_x
//   D[u][x] X[x][y], then C[u][v] = sum_y T[u][y] D[v][y];
//   then / the quant table (correctly rounded, see divide_q) and rintf
//   (half to even, see quantize).
// The plain PyTorch version (ops/jpegenc.py
// packed_to_jpeg_coefficients_plain) repeats the same operations with a
// correctly rounded fused multiply-add, so the kernel agrees with it
// exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEntryBits = 18;
constexpr int kPackThreads = 256;      // K4a
constexpr int kPartBlocks = 128;       // K4a: coefficient blocks a partition
// K4a status words (status_word below), 0 until published.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kHasField = 1ull << 61;

// K3: a block takes two MCUs at a time, twelve 8x8 blocks (Y0..Y3, Cb, Cr
// of each); one thread per row quad of 4 pixels (2 x 16 x 4) in the colour
// phase, and one per 8-vector of a block in the DCT (warps 0-2).
constexpr int kMcuThreads = 128;
constexpr int kPairBlocks = 12;
constexpr int kVecThreads = kPairBlocks * 8;
// Floats (and i16) a staged 8x8 block: 64 and a pad that puts the blocks
// of a warp's 8-vectors on distinct banks.
constexpr int kBlockStride = 72;
constexpr int kQuantRow = 10;

// K3's table block, f32[192] on the card (ops/jpegenc.py device_tables):
// the luma and chroma quant tables in natural order, and each natural
// index's zigzag position.  D is not in it: it is dct_coef() below.
constexpr int kTabQy = 0;
constexpr int kTabQc = 64;
constexpr int kTabZpos = 128;
constexpr int kTabSize = 192;

// D[u][x] of ops/jpegenc.py dct_matrix(), in float32, bit for bit.  The
// DCT loops are unrolled, so every index is known at compile time and
// each term takes its coefficient as an immediate operand.
__device__ __forceinline__ float dct_coef(int i) {
  constexpr float kDct[64] = {
      0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
      0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
      0x1.f6297cp-2f, 0x1.a9b662p-2f, 0x1.1c73b4p-2f, 0x1.8f8b84p-4f,
      -0x1.8f8b84p-4f, -0x1.1c73b4p-2f, -0x1.a9b662p-2f, -0x1.f6297cp-2f,
      0x1.d906bcp-2f, 0x1.87de2ap-3f, -0x1.87de2ap-3f, -0x1.d906bcp-2f,
      -0x1.d906bcp-2f, -0x1.87de2ap-3f, 0x1.87de2ap-3f, 0x1.d906bcp-2f,
      0x1.a9b662p-2f, -0x1.8f8b84p-4f, -0x1.f6297cp-2f, -0x1.1c73b4p-2f,
      0x1.1c73b4p-2f, 0x1.f6297cp-2f, 0x1.8f8b84p-4f, -0x1.a9b662p-2f,
      0x1.6a09e6p-2f, -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
      0x1.6a09e6p-2f, -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
      0x1.1c73b4p-2f, -0x1.f6297cp-2f, 0x1.8f8b84p-4f, 0x1.a9b662p-2f,
      -0x1.a9b662p-2f, -0x1.8f8b84p-4f, 0x1.f6297cp-2f, -0x1.1c73b4p-2f,
      0x1.87de2ap-3f, -0x1.d906bcp-2f, 0x1.d906bcp-2f, -0x1.87de2ap-3f,
      -0x1.87de2ap-3f, 0x1.d906bcp-2f, -0x1.d906bcp-2f, 0x1.87de2ap-3f,
      0x1.8f8b84p-4f, -0x1.1c73b4p-2f, 0x1.a9b662p-2f, -0x1.f6297cp-2f,
      0x1.f6297cp-2f, -0x1.a9b662p-2f, 0x1.1c73b4p-2f, -0x1.8f8b84p-4f,
  };
  return kDct[i];
}

// BT.601 full-range weights (ops/jpegenc.py:129-131), as float32.
constexpr float kYr = 0.299f, kYg = 0.587f, kYb = 0.114f;
constexpr float kCbr = -0.168736f, kCbg = 0.331264f, kCbb = 0.5f;
constexpr float kCrr = 0.5f, kCrg = 0.418688f, kCrb = 0.081312f;

// Byte k of px as a float, exactly and without a conversion instruction:
// the bits 0x4B0000bb are the float 2^23 + bb.
__device__ __forceinline__ float byte_f(int32_t px, int k) {
  return __fsub_rn(__int_as_float(static_cast<int>(
                       __byte_perm(px, 0x4B000000, 0x7540 | k))),
                   8388608.f);
}

__device__ __forceinline__ void ycbcr(int32_t px, float* y, float* cb,
                                      float* cr) {
  const float r = byte_f(px, 0);
  const float g = byte_f(px, 1);
  const float b = byte_f(px, 2);
  *y = __fsub_rn(__fmaf_rn(kYb, b, __fmaf_rn(kYr, r, __fmul_rn(kYg, g))),
                 128.f);
  *cb = __fmaf_rn(kCbb, b, __fmaf_rn(kCbr, r, -__fmul_rn(kCbg, g)));
  *cr = __fmaf_rn(-kCrb, b, __fmaf_rn(kCrr, r, -__fmul_rn(kCrg, g)));
}

// rintf(x) clipped to +-2047, as i16, without a conversion instruction:
// for |x| < 2^22, x + 1.5 * 2^23 rounds x to an integer n half to even, as
// rintf does, and its bits are 0x4B400000 + n, whose low 16 bits are n as
// an i16.  The clip never binds: |X| <= 128 (YCbCr of bytes, luma - 128),
// and sum_x |D[u][x]| <= 8 * 0.35356 for every u, so |C| <= 128 * 2.8285^2
// < 1025 and |C / q| < 1025 for q >= 1.
__device__ __forceinline__ int16_t quantize(float x) {
  return static_cast<int16_t>(__float_as_int(__fadd_rn(x, 12582912.f)));
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift: mul =
// ceil(2^(31 + l) / d), l = ceil(log2 d), shr = l - 1 (Granlund and
// Montgomery; the magic numbers of CUTLASS's FastDivmod).
struct FastDiv {
  int d;
  unsigned mul, shr;
};

FastDiv fast_div(int d) {
  int l = 0;
  while ((1ll << l) < d) ++l;
  if (d == 1) return {1, 0u, 0u};
  return {d, static_cast<unsigned>(((1ull << (31 + l)) + d - 1) / d),
          static_cast<unsigned>(l - 1)};
}

__device__ __forceinline__ int divide_by(int n, FastDiv f) {
  return f.d == 1 ? n
                  : static_cast<int>(__umulhi(static_cast<unsigned>(n),
                                              f.mul) >> f.shr);
}

// sum_k a(k) * b(k) over k = 0..7 in XLA's order: four lanes, each a
// product and one fused multiply-add, then a pairwise sum.
template <typename A, typename Bv>
__device__ __forceinline__ float dot8(A a, Bv b) {
  float l[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    l[s] = __fmaf_rn(a(s + 4), b(s + 4), __fmul_rn(a(s), b(s)));
  return __fadd_rn(__fadd_rn(l[0], l[1]), __fadd_rn(l[2], l[3]));
}

// acc / q rounded to nearest even, as __fdiv_rn gives it, with inv =
// RN(1 / q) (render.cu divide(), Markstein's theorem).  Its conditions
// hold here: q is an integer 1..255, and every nonzero acc is at least
// 2^-83 in magnitude (pixels are integers and D's entries multiples of
// 2^-27, so X is made of multiples of 2^-29, T of 2^-56 and acc of
// 2^-83), which keeps the residual acc - RN(acc inv) q a normal float,
// computed exactly by the inner fused multiply-add.
__device__ __forceinline__ float divide_q(float acc, float q, float inv) {
  const float r = __fmul_rn(acc, inv);
  return __fmaf_rn(__fmaf_rn(-r, q, acc), inv, r);
}

// 16 bytes from global to shared memory without a register (cp.async,
// L2 only); complete after cp_async_wait() in the issuing thread.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}

// 4 bytes from global to shared memory without a register (cp.async).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Where MCU m's pixels and coefficients are: its tile b and MCU row and
// column.
struct Mcu {
  int b, mi, my, mx;
};

__device__ __forceinline__ Mcu mcu_at(int m, FastDiv mcus, FastDiv mw) {
  Mcu c;
  c.b = divide_by(m, mcus);
  c.mi = m - c.b * mcus.d;
  c.my = divide_by(c.mi, mw);
  c.mx = c.mi - c.my * mw.d;
  return c;
}

// K3.  Block x takes MCU pairs x, x + gridDim.x, ...: MCUs 2p and 2p + 1
// of the batch in flat (tile, MCU row, MCU column) order.  Warps 0-2 run
// the DCT; warp 3 moves bytes: it copies the next pair's pixels into the
// other half of a double-buffered strip with cp.async while the DCT warps
// run pass 1, and stores the previous pair's coefficients while they run
// pass 2.  All four warps convert colour.  Shared: the strip (128 row
// quads a pair), X and T of the pair's twelve blocks (T transposed,
// Tt[k][y][u]) and Z, their zigzagged i16 (double-buffered).
__global__ void __launch_bounds__(kMcuThreads)
jpeg_coefficients_kernel(const int32_t* __restrict__ packed, int all, int h,
                         int w, FastDiv mcus, FastDiv mw, int flip_h,
                         int flip_v, int vec,
                         const float* __restrict__ tables,
                         int16_t* __restrict__ out_y,
                         int16_t* __restrict__ out_cb,
                         int16_t* __restrict__ out_cr) {
  __shared__ __align__(16) int4 strip[2][kMcuThreads];
  __shared__ __align__(16) float xs[kPairBlocks * kBlockStride];
  __shared__ __align__(16) float ts[kPairBlocks * kBlockStride];
  __shared__ __align__(16) int16_t zs[2][kPairBlocks * kBlockStride];
  // The quant tables as (q, RN(1 / q)) in rows of kQuantRow float2 (a pad
  // that keeps a quarter warp's 16-byte loads of 8 rows on distinct
  // banks); read by pass 2 once a pair.
  __shared__ __align__(16) float2 quant[2 * 8 * kQuantRow];
  const int t = threadIdx.x;
  const int pairs = (all + 1) / 2;
  const long long hw = static_cast<long long>(h) * w;
  if (t < 64) {
    const int row = (t >> 3) * kQuantRow + (t & 7);
    const float qy = tables[kTabQy + t], qc = tables[kTabQc + t];
    quant[row] = make_float2(qy, __frcp_rn(qy));
    quant[8 * kQuantRow + row] = make_float2(qc, __frcp_rn(qc));
  }

  // Warp 3: pair p's 128 row quads into strip[buf], four a lane.  Quad i
  // is MCU 2p + (i >> 6), frame row (i >> 2) & 15, columns 4 (i & 3) ..
  // + 3; a quad past the tile's right edge, or of an unaligned tile, is
  // read pixel by pixel.  Under flip_h every quad is stored mirrored (its
  // last pixel first), and the colour phase reverses it.
  auto fetch = [&](int p, int buf) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = 2 * p + half;
      if (m >= all) continue;
      const Mcu c = mcu_at(m, mcus, mw);
      const int32_t* tile = packed + c.b * hw;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int i = 64 * half + 32 * s + (t & 31);
        const int fy = c.my * 16 + ((i >> 2) & 15);
        const int fx0 = c.mx * 16 + 4 * (i & 3);
        int sy = min(fy, h - 1);
        if (flip_v) sy = h - 1 - sy;
        const int32_t* row = tile + static_cast<long long>(sy) * w;
        if (vec && fx0 + 3 < w) {
          cp_async16(&strip[buf][i], row + (flip_h ? w - 4 - fx0 : fx0));
        } else {
          int px[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            int sx = min(fx0 + q, w - 1);
            if (flip_h) sx = w - 1 - sx;
            px[q] = __ldg(row + sx);
          }
          strip[buf][i] = flip_h ? make_int4(px[3], px[2], px[1], px[0])
                                 : make_int4(px[0], px[1], px[2], px[3]);
        }
      }
    }
  };
  // Warp 3: the coefficients of pair p from zs[buf], three 16-byte chunks
  // a lane, chunk l & 7 of blocks (l >> 3) + 4s; 8 lanes write a block's
  // 128 bytes.  Each MCU's Y0 and chroma offsets are found once.
  auto store = [&](int p, int buf) {
    const int lane = t & 31;
    long long ybase[2], cbase[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const Mcu c = mcu_at(min(2 * p + h2, all - 1), mcus, mw);
      ybase[h2] = (static_cast<long long>(c.b) * 4 * mcus.d +
                   2LL * c.my * (2 * mw.d) + 2 * c.mx) * 64;
      cbase[h2] = (static_cast<long long>(c.b) * mcus.d + c.mi) * 64;
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int k = (lane >> 3) + 4 * s;
      const bool second = k >= 6;
      const int kind = second ? k - 6 : k;
      if (2 * p + second >= all) continue;
      int16_t* dst =
          kind < 4 ? out_y + (second ? ybase[1] : ybase[0]) +
                         ((kind >> 1) * 2 * mw.d + (kind & 1)) * 64
                   : (kind == 4 ? out_cb : out_cr) +
                         (second ? cbase[1] : cbase[0]);
      reinterpret_cast<uint4*>(dst)[lane & 7] =
          *reinterpret_cast<const uint4*>(zs[buf] + k * kBlockStride +
                                          (lane & 7) * 8);
    }
  };

  // The DCT: block k of the pair (0..5 the first MCU's Y0..Y3, Cb, Cr;
  // 6..11 the second's), vector e of it (column y in pass 1, row u in
  // pass 2).  Colour: quad t of the strip, MCU 2p + half, frame row r,
  // columns 4j .. 4j + 3; the row's partner (r ^ 1) is lane ^ 4.
  const int k = t >> 3, e = t & 7;
  const bool dct = t < kVecThreads;
  const int kind = k % 6;
  const int half = t >> 6, r = (t >> 2) & 15, j = t & 3;
  // Where row e's 8 coefficients go in Z: block k's zigzag positions.
  int zoff[8];
#pragma unroll
  for (int v = 0; v < 8; ++v)
    zoff[v] = k * kBlockStride +
              (dct ? static_cast<int>(tables[kTabZpos + e * 8 + v]) : 0);

  int p = blockIdx.x, buf = 0;
  if (!dct && p < pairs) fetch(p, 0);
  for (; p < pairs; p += gridDim.x, buf ^= 1) {
    if (!dct) cp_async_wait();
    __syncthreads();

    // Colour: luma as one 16-byte store; the 2x2 chroma sums, the top row
    // forming Cb and the bottom row Cr of two chroma columns.  x / 4 and
    // x * 0.25 are the same float while x / 4 is normal, and every
    // nonzero sum here is at least 2^-27 (a multiple of the weights'
    // ulps).
    {
      int4 cur = strip[buf][t];
      if (flip_h) cur = make_int4(cur.w, cur.z, cur.y, cur.x);
      float yv[4], cbv[4], crv[4];
      ycbcr(cur.x, &yv[0], &cbv[0], &crv[0]);
      ycbcr(cur.y, &yv[1], &cbv[1], &crv[1]);
      ycbcr(cur.z, &yv[2], &cbv[2], &crv[2]);
      ycbcr(cur.w, &yv[3], &cbv[3], &crv[3]);
      *reinterpret_cast<float4*>(
          xs + (half * 6 + (r >> 3) * 2 + (j >> 1)) * kBlockStride +
          (r & 7) * 8 + 4 * (j & 1)) = make_float4(yv[0], yv[1], yv[2],
                                                   yv[3]);
      const bool top = (r & 1) == 0;
      const float cb0 = __fadd_rn(cbv[0], cbv[1]);
      const float cb1 = __fadd_rn(cbv[2], cbv[3]);
      const float cr0 = __fadd_rn(crv[0], crv[1]);
      const float cr1 = __fadd_rn(crv[2], crv[3]);
      const float o0 = __shfl_xor_sync(0xFFFFFFFFu, top ? cr0 : cb0, 4);
      const float o1 = __shfl_xor_sync(0xFFFFFFFFu, top ? cr1 : cb1, 4);
      const float c0 = top ? __fadd_rn(cb0, o0) : __fadd_rn(o0, cr0);
      const float c1 = top ? __fadd_rn(cb1, o1) : __fadd_rn(o1, cr1);
      *reinterpret_cast<float2*>(
          xs + (half * 6 + (top ? 4 : 5)) * kBlockStride + (r >> 1) * 8 +
          2 * j) = make_float2(__fmul_rn(c0, 0.25f), __fmul_rn(c1, 0.25f));
    }
    __syncthreads();

    if (dct) {
      // Pass 1: T[u][y] = sum_x D[u][x] X[x][y] for y = e.
      float x[8], col[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = xs[k * kBlockStride + i * 8 + e];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        col[u] = dot8([&](int i) { return dct_coef(u * 8 + i); },
                      [&](int i) { return x[i]; });
      float4* tt = reinterpret_cast<float4*>(ts + k * kBlockStride + e * 8);
      tt[0] = make_float4(col[0], col[1], col[2], col[3]);
      tt[1] = make_float4(col[4], col[5], col[6], col[7]);
    } else if (p + static_cast<int>(gridDim.x) < pairs) {
      fetch(p + gridDim.x, buf ^ 1);
    }
    __syncthreads();

    if (dct) {
      // Pass 2: C[u][v] = sum_y T[u][y] D[v][y] for u = e; quantize,
      // zigzag.
      float row[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) row[i] = ts[k * kBlockStride + i * 8 + e];
      float2 qrow[8];
      const float4* qsrc = reinterpret_cast<const float4*>(
          quant + (kind < 4 ? 0 : 8 * kQuantRow) + e * kQuantRow);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 q2 = qsrc[i];
        qrow[2 * i] = make_float2(q2.x, q2.y);
        qrow[2 * i + 1] = make_float2(q2.z, q2.w);
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float acc = dot8([&](int i) { return row[i]; },
                               [&](int i) { return dct_coef(v * 8 + i); });
        zs[buf][zoff[v]] = quantize(divide_q(acc, qrow[v].x, qrow[v].y));
      }
    } else if (p != static_cast<int>(blockIdx.x)) {
      store(p - gridDim.x, buf ^ 1);
    }
  }
  // The last pair's coefficients.
  __syncthreads();
  if (!dct && p != static_cast<int>(blockIdx.x))
    store(p - gridDim.x, buf ^ 1);
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

// K4b row modes: the sparse wire's rows (:457-464) or the Huffman wire's
// (:486-492).
constexpr int kSparseRows = 0;
constexpr int kHuffmanRows = 1;

__device__ __forceinline__ int32_t load_i32_le(const uint8_t* p) {
  return static_cast<int32_t>(
      static_cast<uint32_t>(__ldg(p)) |
      (static_cast<uint32_t>(__ldg(p + 1)) << 8) |
      (static_cast<uint32_t>(__ldg(p + 2)) << 16) |
      (static_cast<uint32_t>(__ldg(p + 3)) << 24));
}

// K4b.  The used bytes of row b; none at or past n_valid.  Sparse rows:
// header, counts and kept entries, or header and counts alone for a row
// that overflowed cap.  Huffman rows: the 8-byte header and the stream's
// ceil(bits / 32) words, or the header alone for a row over cap entries or
// 32 cap_words bits.
__device__ __forceinline__ long long row_length(const uint8_t* wire, int b,
                                                long long width, int n_valid,
                                                int cap, long long nb,
                                                int mode,
                                                long long cap_words) {
  if (b >= n_valid) return 0;
  const uint8_t* hdr = wire + static_cast<long long>(b) * width;
  const int32_t total = load_i32_le(hdr);
  if (mode == kHuffmanRows) {
    const long long bits = load_i32_le(hdr + 4);
    const bool ok = total <= cap && bits <= 32 * cap_words;
    return 8 + 4 * (ok ? (bits + 31) / 32 : 0);
  }
  const long long kept = total < cap ? total : cap;
  return total <= cap ? 4 + nb + (kEntryBits * kept + 7) / 8 : 4 + nb;
}

// The row whose prefix holds byte d of the data (d < offs[B]): the last r
// with offs[r] <= d (rows of length 0 share their successor's offset).
__device__ __forceinline__ int row_of(const long long* offs, int B,
                                      long long d) {
  int lo = 0, hi = B;   // offs[lo] <= d < offs[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid] <= d) lo = mid; else hi = mid;
  }
  return lo;
}

// K4b, one launch.  out = [lengths i32 LE x B | row prefixes | zeros], n
// bytes, written by 16-byte runs of aligned addresses: run c holds bytes
// 16c - lead .. 16c - lead + 15 (lead = out's address mod 16).  Each block
// first scans the row lengths into offs (dynamic shared memory, B + 1).
__global__ void __launch_bounds__(kThreads)
compact_rows_kernel(const uint8_t* __restrict__ wire, int B, long long width,
                    int n_valid, int cap, long long nb, int mode,
                    long long cap_words, uint8_t* __restrict__ out) {
  extern __shared__ long long offs[];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long carry = 0;
    for (int c = 0; c < B; c += 32) {
      const int r = c + lane;
      const long long len =
          r < B ? row_length(wire, r, width, n_valid, cap, nb, mode,
                             cap_words)
                : 0;
      long long incl = len;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += v;
      }
      if (r < B) offs[r] = carry + incl - len;
      carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
    }
    if (lane == 0) offs[B] = carry;
  }
  __syncthreads();
  const long long head = 4LL * B, data = offs[B];
  const long long n = head + static_cast<long long>(B) * width;
  const long long lead =
      static_cast<long long>(reinterpret_cast<uintptr_t>(out) & 15u);
  const long long runs = (n + lead + 15) / 16;
  // Output byte o, one at a time.
  auto byte_at = [&](long long o) -> uint32_t {
    if (o < head) {
      const int r = static_cast<int>(o >> 2);
      return static_cast<uint32_t>((offs[r + 1] - offs[r]) >> (8 * (o & 3))) &
             0xFFu;
    }
    const long long d = o - head;
    if (d >= data) return 0u;
    const int r = row_of(offs, B, d);
    return __ldg(wire + static_cast<long long>(r) * width + d - offs[r]);
  };
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < runs; c += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long o0 = 16 * c - lead;
    uint4* dst = reinterpret_cast<uint4*>(out + o0);
    const bool whole = o0 >= 0 && o0 + 16 <= n;
    if (whole && o0 >= head + data) {          // the zero tail
      *dst = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    if (whole && o0 >= head) {
      const long long d0 = o0 - head;
      const int r = row_of(offs, B, d0);
      if (d0 + 16 <= offs[r + 1]) {            // inside row r's prefix
        const uint8_t* src =
            wire + static_cast<long long>(r) * width + d0 - offs[r];
        const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3u);
        const uint32_t* ws = reinterpret_cast<const uint32_t*>(src - sh);
        uint32_t wd[5];
#pragma unroll
        for (int i = 0; i < 4; ++i) wd[i] = __ldg(ws + i);
        wd[4] = sh ? __ldg(ws + 4) : 0u;
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[i] = __funnelshift_r(wd[i], wd[i + 1], 8 * sh);
        *dst = make_uint4(o[0], o[1], o[2], o[3]);
        continue;
      }
    }
    // A run across the lengths header, a row boundary or the data's end,
    // or at an end of the output.
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const long long oi = o0 + i;
      if (oi >= 0 && oi < n) o[i >> 2] |= byte_at(oi) << (8 * (i & 3));
    }
    if (whole) {
      *dst = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      for (int i = 0; i < 16; ++i) {
        const long long oi = o0 + i;
        if (oi >= 0 && oi < n)
          out[oi] = static_cast<uint8_t>(o[i >> 2] >> (8 * (i & 3)));
      }
    }
  }
}

// K5.  One tile's Huffman wire in one pass: the rows and the status words
// are zeroed by one memset, then CTA x takes chunk c = x % parts of tile
// b = x / parts: the kHuffBlocks coefficient blocks from c * kHuffBlocks
// in scan order (fewer in a tile's ragged last chunk), one thread a block.
constexpr int kHuffThreads = 128;
constexpr int kHuffBlocks = kHuffThreads;
constexpr int kHuffWarps = kHuffThreads / 32;
// A staged block: 64 i16 and 8 of pad (144 bytes: the 16-byte rows of
// eight neighbouring blocks fall on distinct banks).
constexpr int kHuffStride = 72;
// The most bits a block codes: 64 fields of at most 16 + 11 bits (every
// coefficient nonzero: no ZRL and no EOB), 54 words.
constexpr int kHuffBlockWords = 64 * 27 / 32;
// The spec block, i32[1024] on the card (ops/jpegenc.py spec_tensor).
constexpr int kSpecDcCode = 0;
constexpr int kSpecDcLen = 256;
constexpr int kSpecAcCode = 512;
constexpr int kSpecAcLen = 768;

// JPEG magnitude category, held to 11 as _category (:822) holds it.
__device__ __forceinline__ int huff_category(int v) {
  const int a = v < 0 ? -v : v;
  const int s = 32 - __clz(a);
  return s < 11 ? s : 11;
}

// Amplitude bits (_amplitude, :828): the value, or for a negative one its
// ones' complement in s bits.
__device__ __forceinline__ uint32_t huff_amplitude(int v, int s) {
  return static_cast<uint32_t>(v >= 0 ? v : v + (1 << s) - 1) &
         ((1u << s) - 1u);
}

// The coefficient block at slot `slot` of MCU m of tile b: Y raster block
// (2 my + dy, 2 mx + dx) for slots 0-3, then Cb, then Cr (32-bit index
// math; the launch keeps a tile's blocks below 2^20).
__device__ __forceinline__ const int16_t* huff_block(
    const int16_t* y, const int16_t* cb, const int16_t* cr, int b, int m,
    int slot, int w16, FastDiv div_w16, int nmcu) {
  if (slot < 4) {
    const int my = divide_by(m, div_w16), mx = m - my * w16;
    const int yb = (2 * my + (slot >> 1)) * (2 * w16) + 2 * mx + (slot & 1);
    return y + (static_cast<long long>(b) * 4 * nmcu + yb) * 64;
  }
  return (slot == 4 ? cb : cr) + (static_cast<long long>(b) * nmcu + m) * 64;
}

// K5's status word: flag << 62 | nonzeros << 32 | bits, for the chunk
// (aggregate) or the tile up to and including it (inclusive).
__device__ __forceinline__ unsigned long long huff_status(
    unsigned long long flag, unsigned nz, unsigned bits) {
  return flag | (static_cast<unsigned long long>(nz) << 32) | bits;
}

// A thread's bit writer: fields of at most 30 bits appended MSB first to
// its block's words in shared memory, each word stored once it is full.
struct HuffWriter {
  uint32_t* dst;
  unsigned long long acc;
  int held, bits, words;

  __device__ __forceinline__ void put(uint32_t v, int len) {
    acc = (acc << len) | (v & ((1u << len) - 1u));
    held += len;
    bits += len;
    if (held >= 32) {
      held -= 32;
      dst[words++] = static_cast<uint32_t>(acc >> held);
    }
  }

  __device__ __forceinline__ void flush() {
    if (held > 0) dst[words++] = static_cast<uint32_t>(acc << (32 - held));
  }
};

// Chunk c of tile b in four phases, each block's fields computed once:
//  1. loads: the chunk's coefficients to shared memory in 16-byte pieces,
//     eight neighbouring threads a block (all eight pieces of a thread in
//     flight at once), and the spec's codes.
//  2. fields: thread j takes block j: its nonzero mask from its staged
//     rows, then its fields in stream order (the DC difference against
//     its component's predecessor, which a block of the previous chunk
//     may hold; each nonzero AC coefficient's ZRL codes and run/size code
//     with its amplitude, walking the mask's set bits; the EOB unless
//     position 63 is nonzero), written MSB first into its own words in
//     shared memory.  A block scan of the bit lengths and nonzero counts
//     gives each block's chunk-local bit start; the chunk's aggregate is
//     published.
//  3. lookback: warp 0 reads the tile's earlier chunks' status words, 32
//     at a time, nearest first, until an inclusive one, and publishes the
//     chunk's inclusive prefix: the chunk's first stream bit s0.
//  4. output: the thread of the block that holds a word's first chunk
//     bit gathers the word's 32 bits from that block and the next ones
//     and stores it; words in the chunk are plain coalesced stores, and
//     only its first and last words, which it can share with its
//     neighbours, go through a global atomicOr.  Words at or past
//     cap_words are dropped.  The tile's last chunk writes the header
//     from its inclusive prefix.
__global__ void __launch_bounds__(kHuffThreads)
huffman_pack_kernel(const int16_t* __restrict__ y,
                    const int16_t* __restrict__ cb,
                    const int16_t* __restrict__ cr, int nmcu, int w16,
                    FastDiv div_w16, int parts, FastDiv div_parts, int vec,
                    const int32_t* __restrict__ spec,
                    uint8_t* __restrict__ out, long long width,
                    long long cap_words, unsigned long long* status) {
  __shared__ __align__(16) int16_t s_coef[kHuffBlocks * kHuffStride];
  __shared__ uint32_t s_bits[kHuffBlocks * kHuffBlockWords];
  __shared__ uint32_t s_ac[256];          // ac_len << 16 | ac_code
  __shared__ uint32_t s_dcs[12];          // dc_len << 16 | dc_code
  __shared__ int s_len[kHuffBlocks];
  __shared__ int s_start[kHuffBlocks];
  __shared__ unsigned s_warp[kHuffWarps][2];
  __shared__ unsigned s_agg[2], s_excl[2];   // {bits, nonzeros}
  const int b = divide_by(static_cast<int>(blockIdx.x), div_parts);
  const int c = static_cast<int>(blockIdx.x) - b * parts;
  const int nb = 6 * nmcu;
  const int g0 = c * kHuffBlocks;
  const int n = min(kHuffBlocks, nb - g0);
  const int j = threadIdx.x, lane = j & 31, wid = j >> 5;

  // 1. Loads.
  uint4 piece[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = r * kHuffThreads + j, jj = p >> 3, part = p & 7;
    piece[r] = make_uint4(0u, 0u, 0u, 0u);
    if (jj < n) {
      const int g = g0 + jj, m = g / 6;
      const int16_t* src =
          huff_block(y, cb, cr, b, m, g - 6 * m, w16, div_w16, nmcu) +
          8 * part;
      if (vec) {
        piece[r] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t* w = &piece[r].x;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = static_cast<uint16_t>(__ldg(src + 2 * i)) |
                 static_cast<uint32_t>(static_cast<uint16_t>(
                     __ldg(src + 2 * i + 1))) << 16;
      }
    }
  }
  for (int i = j; i < 256; i += kHuffThreads)
    s_ac[i] = static_cast<uint32_t>(__ldg(spec + kSpecAcLen + i)) << 16 |
              static_cast<uint32_t>(__ldg(spec + kSpecAcCode + i));
  if (j < 12)
    s_dcs[j] = static_cast<uint32_t>(__ldg(spec + kSpecDcLen + j)) << 16 |
               static_cast<uint32_t>(__ldg(spec + kSpecDcCode + j));
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = r * kHuffThreads + j, jj = p >> 3, part = p & 7;
    if (jj < n)
      *reinterpret_cast<uint4*>(s_coef + jj * kHuffStride + 8 * part) =
          piece[r];
  }
  __syncthreads();

  // 2. Fields.
  int len = 0, nz = 0;
  if (j < n) {
    const int16_t* blk = s_coef + j * kHuffStride;
    unsigned long long mask = 0ull;     // bit k: position k is nonzero
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(blk)[i];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const unsigned two = ((w[h] & 0xFFFFu) != 0u ? 1u : 0u) |
                             ((w[h] >> 16) != 0u ? 2u : 0u);
        mask |= static_cast<unsigned long long>(two) << (8 * i + 2 * h);
      }
    }
    nz = __popcll(mask);
    // The DC difference: Y1..Y3 from the Y before them in the MCU, Y0
    // from the previous MCU's Y3, Cb and Cr from their own block one MCU
    // back; 0 before the tile's first MCU.
    const int g = g0 + j, m = g / 6, slot = g - 6 * m;
    int pred = 0;
    if ((slot >= 1 && slot <= 3) || m > 0) {
      const int pg = slot >= 1 && slot <= 3 ? g - 1 : g - (slot ? 6 : 3);
      if (pg >= g0) {
        pred = s_coef[(pg - g0) * kHuffStride];
      } else {
        const int pm = pg / 6;
        pred = __ldg(huff_block(y, cb, cr, b, pm, pg - 6 * pm, w16,
                                div_w16, nmcu));
      }
    }
    HuffWriter out_bits{s_bits + j * kHuffBlockWords, 0ull, 0, 0, 0};
    const int diff = blk[0] - pred;
    int sc = huff_category(diff);
    uint32_t code = s_dcs[sc];
    out_bits.put(((code & 0xFFFFu) << sc) | huff_amplitude(diff, sc),
                 static_cast<int>(code >> 16) + sc);
    const uint32_t zrl = s_ac[0xF0];
    unsigned long long rest = mask & ~1ull;
    int prev = 0;
    while (rest != 0ull) {
      const int k = __ffsll(static_cast<long long>(rest)) - 1;
      rest &= rest - 1ull;
      const int v = blk[k];
      const int run = k - prev - 1;
      prev = k;
      for (int z = run >> 4; z > 0; --z)
        out_bits.put(zrl & 0xFFFFu, static_cast<int>(zrl >> 16));
      sc = huff_category(v);
      code = s_ac[((run & 15) << 4) | sc];
      out_bits.put(((code & 0xFFFFu) << sc) | huff_amplitude(v, sc),
                   static_cast<int>(code >> 16) + sc);
    }
    if ((mask >> 63) == 0ull) {          // EOB: position 63 is zero
      code = s_ac[0];
      out_bits.put(code & 0xFFFFu, static_cast<int>(code >> 16));
    }
    out_bits.flush();
    len = out_bits.bits;
  }
  // The chunk scan: each block's chunk-local bit start.
  int incl = len, nsum = nz;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += t;
    nsum += __shfl_xor_sync(0xFFFFFFFFu, nsum, d);
  }
  if (lane == 31) {
    s_warp[wid][0] = incl;
    s_warp[wid][1] = nsum;
  }
  __syncthreads();
  unsigned agg_bits = 0u, agg_nz = 0u;
#pragma unroll
  for (int w = 0; w < kHuffWarps; ++w) {
    if (w < wid) incl += s_warp[w][0];
    agg_bits += s_warp[w][0];
    agg_nz += s_warp[w][1];
  }
  s_len[j] = len;
  s_start[j] = incl - len;
  if (j == 0)
    publish(status + static_cast<long long>(b) * parts + c,
            huff_status(c == 0 ? kInclusive : kAggregate, agg_nz,
                        agg_bits));

  // 3. Lookback.
  if (wid == 0) {
    unsigned excl_bits = 0u, excl_nz = 0u;
    if (c > 0) {
      unsigned long long* st = status + static_cast<long long>(b) * parts;
      for (int i = c - 1;; i -= 32) {
        const int idx = i - lane;
        unsigned long long s = idx >= 0 ? peek(st + idx) : kInclusive;
        while (__any_sync(0xFFFFFFFFu, (s >> 62) == 0))
          if ((s >> 62) == 0) s = peek(st + idx);
        const unsigned done = __ballot_sync(0xFFFFFFFFu, (s >> 62) == 2);
        const int stop = done ? __ffs(done) - 1 : 31;
        unsigned bits = lane <= stop ? static_cast<unsigned>(s) : 0u;
        unsigned nzs = lane <= stop
                           ? static_cast<unsigned>(s >> 32) & 0x3FFFFFFFu
                           : 0u;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          bits += __shfl_xor_sync(0xFFFFFFFFu, bits, d);
          nzs += __shfl_xor_sync(0xFFFFFFFFu, nzs, d);
        }
        excl_bits += bits;
        excl_nz += nzs;
        if (done) break;
      }
      if (lane == 0)
        publish(st + c, huff_status(kInclusive, excl_nz + agg_nz,
                                    excl_bits + agg_bits));
    }
    if (lane == 0) {
      s_excl[0] = excl_bits;
      s_excl[1] = excl_nz;
    }
  }
  __syncthreads();

  // 4. Output: the words whose first chunk bit lies in block j.
  const long long s0 = s_excl[0];
  uint8_t* row = out + static_cast<long long>(b) * width;
  uint32_t* words = reinterpret_cast<uint32_t*>(row + 8);
  if (j < n && len > 0) {
    const long long lo = s0 + s_start[j], hi = lo + len;
    const long long m_last = min((hi - 1) >> 5, cap_words - 1);
    for (long long m = j == 0 ? s0 >> 5 : (lo + 31) >> 5; m <= m_last;
         ++m) {
      const int x = static_cast<int>(32 * m - s0);   // chunk-local bit
      int filled = x < 0 ? -x : 0;
      int i = j, o = max(x, 0) - s_start[j];
      uint32_t v = 0u;
      while (filled < 32 && i < n) {
        const int take = min(32 - filled, s_len[i] - o);
        if (take > 0) {
          const uint32_t* src = s_bits + i * kHuffBlockWords + (o >> 5);
          const int r = o & 31;
          const unsigned long long two =
              static_cast<unsigned long long>(src[0]) << 32 |
              (r + take > 32 ? src[1] : 0u);
          v |= static_cast<uint32_t>((two << r) >> (64 - take))
               << (32 - filled - take);
          filled += take;
        }
        ++i;
        o = 0;
      }
      if (x < 0 || x + 32 > static_cast<int>(agg_bits)) {
        if (v != 0u) atomicOr(words + m, v);
      } else {
        words[m] = v;
      }
    }
  }
  if (c == parts - 1 && j == 0) {
    int32_t* hdr = reinterpret_cast<int32_t*>(row);
    hdr[0] = static_cast<int32_t>(s_excl[1] + agg_nz);
    hdr[1] = static_cast<int32_t>(s0 + agg_bits);
  }
}

// K6.  One tile's full-grid fixed-table stream in one launch, no memset.
// CTA x < B * parts takes chunk c = x % parts of tile b = x / parts: the
// kBitBlocks coefficient blocks from c * kBitBlocks in scan order (fewer
// in a tile's ragged last chunk), one thread a block; the block at scan
// position g is blocks[b][scan[g]].  The grid's last B * zero_ctas CTAs
// (at most kBitZeroCtas a tile) zero each tile's words past its stream.
// On the H100 chunks of 64 blocks were slower than 128 (a build with
// -DK6_BIT_THREADS=64: scripts/k6_redesign.py --sweep, PERF.md), and so
// was one zeroing CTA a tile.
#ifndef K6_BIT_THREADS
#define K6_BIT_THREADS 128
#endif
constexpr int kBitThreads = K6_BIT_THREADS;
constexpr int kBitBlocks = kBitThreads;
constexpr int kBitZeroCtas = 16;
constexpr int kBitWarps = kBitThreads / 32;
// Blocks of the next chunk staged beside a chunk, for its last word: the
// fixed tables code a block in at least 2 bits (a 1-bit DC category 0 and
// a 1-bit EOB), so 16 cover the 31 bits that word can lack (with shorter
// codes the rest come from global memory).
constexpr int kBitAhead = 16;
constexpr int kBitRows = kBitBlocks + kBitAhead;
constexpr int kBitLoads = (kBitRows * 8 + kBitThreads - 1) / kBitThreads;
// Status words a lane of the look-back reads at once (a window of
// 32 kBitLook chunks: a 1024^2 tile has 192).
constexpr int kBitLook = 4;
// After the blocks are coded, their words are packed into the chunk's
// coefficient rows (the next chunk's rows stay): a chunk whose blocks
// code more words than that (over 1152 bits a block on average) takes the
// exact path.
constexpr int kBitCapWords = kBitBlocks * kHuffStride / 2;
// A block's length and word count scan as one int: len | words << 18 (a
// chunk codes fewer than 2^18 bits, 1728 a block at most).
constexpr int kBitLenBits = 18;
constexpr int kBitLenMask = (1 << kBitLenBits) - 1;
// Words past the stream a zeroing CTA is given at least.
constexpr long long kBitZeroWords = 4096;
// K6's status word: epoch << 34 | flag << 32 | bits, for the chunk
// (aggregate) or the tile up to and including it (inclusive).  A word of
// another epoch (an earlier call, or 0: never written) is not ready.
constexpr unsigned long long kBitAggregate = 1ull << 32;
constexpr unsigned long long kBitInclusive = 2ull << 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Amplitude bits as _amplitude (:828) gives them in int32: the value, or
// for a negative one v + 2^s - 1, not cut to s bits (a clamped category
// 11 keeps its high bits, as in the JAX stream).
__device__ __forceinline__ int32_t bit_amplitude(int v, int s) {
  return v >= 0 ? v : v + (1 << s) - 1;
}

// Whether a field's value has bits above its length: a clamped category
// 11 of a value below -2047 (its amplitude is negative), or a code longer
// than its length.  Such a field is not its bits alone: JAX adds its high
// bits into the bits before it, carrying within the word.
__device__ __forceinline__ bool bit_spills(int32_t val, int len) {
  return val < 0 || (val >> len) != 0;
}

// What a field of `len` bits at bit r of its word adds to that word (c0)
// and to the next (c1), with JAX's int32 shifts (:918-935; arithmetic
// right shifts).
__device__ __forceinline__ uint32_t bit_c0(int32_t val, int len, int r) {
  const int sh0 = 32 - r - len;
  return sh0 >= 0 ? static_cast<uint32_t>(val) << sh0
                  : static_cast<uint32_t>(val >> min(-sh0, 31));
}

__device__ __forceinline__ uint32_t bit_c1(int32_t val, int len, int r) {
  const int sh1 = 64 - r - len;
  return sh1 < 32 ? static_cast<uint32_t>(val) << sh1 : 0u;
}

// Bit k set where coefficient k of a block is nonzero: a staged block by
// 16-byte loads, a block in global memory (the look-ahead past the staged
// rows) by 2-byte ones.
__device__ __forceinline__ unsigned long long staged_mask(
    const int16_t* blk) {
  unsigned long long mask = 0ull;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(blk)[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const unsigned two = ((w[h] & 0xFFFFu) != 0u ? 1u : 0u) |
                           ((w[h] >> 16) != 0u ? 2u : 0u);
      mask |= static_cast<unsigned long long>(two) << (8 * i + 2 * h);
    }
  }
  return mask;
}

__device__ unsigned long long global_mask(const int16_t* blk) {
  unsigned long long mask = 0ull;
  for (int k = 0; k < 64; ++k)
    mask |= static_cast<unsigned long long>(__ldg(blk + k) != 0) << k;
  return mask;
}

// The scan position whose DC the block at scan position g is coded
// against: Y1..Y3 the Y before them in the MCU, Y0 the previous MCU's Y3,
// Cb and Cr their own block one MCU back; -1 in the tile's first MCU.
__device__ __forceinline__ int dc_pred_pos(int g) {
  const int m = g / 6, slot = g - 6 * m;
  if (slot >= 1 && slot <= 3) return g - 1;
  return m > 0 ? g - (slot ? 6 : 3) : -1;
}

// A block's fields in stream order, as JAX's int32 values (:852-895): the
// DC difference's code and amplitude; per nonzero AC coefficient the ZRL
// pair f0 (two codes as one field), the third ZRL f1, and the run/size
// code with the amplitude f2; the EOB unless position 63 is nonzero.
// f(val, len) runs for each field of positive length (JAX's `live`) until
// it returns false.
template <typename F>
__device__ __forceinline__ void bit_fields(const int16_t* blk,
                                           unsigned long long mask,
                                           int diff, const uint32_t* s_ac,
                                           const uint32_t* s_dcs, F&& f) {
  int sc = huff_category(diff);
  uint32_t code = s_dcs[sc];
  int len = static_cast<int>(code >> 16) + sc;
  if (len > 0 &&
      !f(static_cast<int32_t>((code & 0xFFFFu) << sc) |
             bit_amplitude(diff, sc), len))
    return;
  const uint32_t zrl = s_ac[0xF0];
  const int32_t zc = static_cast<int32_t>(zrl & 0xFFFFu);
  const int zl = static_cast<int>(zrl >> 16);
  // The next nonzero coefficient is read while this one is coded.
  unsigned long long rest = mask & ~1ull;
  int prev = 0;
  int k = __ffsll(static_cast<long long>(rest)) - 1;
  int v = blk[k & 63];
  while (rest != 0ull) {
    rest &= rest - 1ull;
    const int k_next = __ffsll(static_cast<long long>(rest)) - 1;
    const int v_next = blk[k_next & 63];
    const int run = k - prev - 1;
    prev = k;
    const int z = run >> 4;
    if (zl > 0) {
      if (z >= 2 &&
          !f(static_cast<int32_t>(static_cast<uint32_t>(zc) << zl) | zc,
             2 * zl))
        return;
      if (z == 1 && !f(zc, zl)) return;
      if (z >= 3 && !f(zc, zl)) return;
    }
    sc = huff_category(v);
    code = s_ac[((run & 15) << 4) | sc];
    len = static_cast<int>(code >> 16) + sc;
    if (len > 0 &&
        !f(static_cast<int32_t>((code & 0xFFFFu) << sc) |
               bit_amplitude(v, sc), len))
      return;
    k = k_next;
    v = v_next;
  }
  if ((mask >> 63) == 0ull && (s_ac[0] >> 16) != 0u)   // EOB: 63 is zero
    f(static_cast<int32_t>(s_ac[0] & 0xFFFFu),
      static_cast<int>(s_ac[0] >> 16));
}

// A thread's writer of its block's fields, MSB first, into its own words
// (at most 27 bits a field and 1728 a block, with codes of at most 16
// bits); `spill` records a field that bit_spills.
struct BitWriter {
  uint32_t* dst;
  unsigned long long acc;
  int held, bits, words;
  bool spill;

  __device__ __forceinline__ void put(int32_t val, int len) {
    spill |= bit_spills(val, len);
    acc = (acc << len) | static_cast<uint32_t>(val);
    held += len;
    bits += len;
    if (held >= 32) {
      held -= 32;
      dst[words++] = static_cast<uint32_t>(acc >> held);
    }
  }

  __device__ __forceinline__ void flush() {
    if (held > 0) dst[words++] = static_cast<uint32_t>(acc << (32 - held));
  }
};

// The blocks from scan position g on, for the word in which a chunk's
// stream ends (the next chunks' first fields): rows below `staged` are in
// shared memory with their DCs in s_dc, later blocks are read from the
// tile.  f(val, len) gets their fields in order until it returns false.
template <typename F>
__device__ __forceinline__ void bit_next_fields(
    int g, int g0, int staged, int nb, const int16_t* s_coef,
    const int* s_dc, const int16_t* __restrict__ tile,
    const int32_t* __restrict__ scan, const uint32_t* s_ac,
    const uint32_t* s_dcs, F&& f) {
  bool more = true;
  for (; g < nb && more; ++g) {
    const bool staged_row = g - g0 < staged;
    const int16_t* blk =
        staged_row ? s_coef + (g - g0) * kHuffStride
                   : tile + static_cast<long long>(__ldg(scan + g)) * 64;
    const unsigned long long mask =
        staged_row ? staged_mask(blk) : global_mask(blk);
    const int pg = dc_pred_pos(g);     // >= g - 6 >= g0: not before it
    const int pred =
        pg < 0 ? 0
        : pg - g0 < staged
            ? s_dc[pg - g0]
            : __ldg(tile + static_cast<long long>(__ldg(scan + pg)) * 64);
    bit_fields(blk, mask, (staged_row ? s_dc[g - g0] : blk[0]) - pred,
               s_ac, s_dcs, [&](int32_t val, int len) {
                 return more = f(val, len);
               });
  }
}

// Zero words [lo, hi) of a row with 16-byte stores where aligned.
__device__ __forceinline__ void bit_zero(uint32_t* row, long long lo,
                                         long long hi) {
  const int j = threadIdx.x;
  const long long skew =
      (4 - static_cast<long long>(
               (reinterpret_cast<uintptr_t>(row + lo) >> 2) & 3)) & 3;
  const long long al = min(hi, lo + skew);
  const long long nv = (hi - al) >> 2;
  for (long long i = lo + j; i < al; i += kBitThreads) row[i] = 0u;
  uint4* v = reinterpret_cast<uint4*>(row + al);
  for (long long i = j; i < nv; i += kBitThreads)
    v[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = al + 4 * nv + j; i < hi; i += kBitThreads) row[i] = 0u;
}

// A chunk in four phases, each block coded once:
//  1. loads: the chunk's coefficient blocks and the next chunk's first
//     kBitAhead, gathered through the scan map, to shared memory by
//     cp.async in 16-byte pieces, eight neighbouring threads a block, all
//     in flight at once; the DCs of the previous chunk's last 6 blocks
//     (4-byte cp.async) and the spec's codes.
//  2. fields: thread j takes block j: its nonzero mask, its DC difference
//     along its component's chain, and its fields (bit_fields), written
//     MSB first into its own words, thread-local (BitWriter).  A block scan of the
//     lengths and word counts gives each block's chunk-local bit start
//     and word offset and the chunk's aggregate, published;
//     __syncthreads_or tells whether any field of the chunk spills above
//     its length.
//  3. lookback and packing, at once: warp 0 reads the tile's earlier
//     chunks' status words, 32 kBitLook at once, until an inclusive one,
//     and publishes the chunk's inclusive prefix: s0, the chunk's first
//     stream bit, and s1 = s0 + aggregate.  Meanwhile each thread packs
//     its block's words at its word offset into the chunk's coefficient
//     rows (all read by now), and warp 1 codes the first 32 bits after the
//     chunk (the next chunk's first blocks, staged, a lane a block: on
//     the H100 one thread walking them in turn held an all-zero tile's
//     look-back phase ~10 us) into 64 bits of a chunk-local frame.
//  4. output: a chunk owns the words that begin in it, [ceil(s0/32),
//     ceil(s1/32)), and stores each whole, once, plainly; the word in
//     which s0 falls belongs to the chunk before.  Without a spill the
//     thread of the block where a word begins gathers its bits from the
//     packed words of that block and the next (fields of disjoint bits:
//     their sum is their bits), and the word in which s1 falls takes the
//     first bits after the chunk.  With a spill (the exact path; also a
//     chunk whose words do not fit its rows) the chunk zeroes its owned
//     words, every thread walks its block again and adds each field's c0
//     and c1 to the owned words with a global atomicAdd, as JAX adds them
//     (the spilled bits carry within the word), and the last word takes
//     what the next chunk's first fields add (bit_next_fields, exact; so
//     does a chunk without a spill whose next fields spill).  Words at or
//     past cap_words are dropped.  The tile's last chunk writes its total
//     bits.
// A zeroing CTA (x >= B * parts) waits for its tile's last chunk to
// publish the tile's total and zeroes its share of the words from
// ceil(total / 32) to cap_words, which no chunk stores.  Every word below
// the cap is stored once, so the launch needs no memset.
__global__ void __launch_bounds__(kBitThreads, 1024 / kBitThreads)
bitpack_fixed_kernel(const int16_t* __restrict__ blocks, int B, int nb,
                     const int32_t* __restrict__ scan, int parts,
                     FastDiv div_parts, int zero_ctas, FastDiv div_zero,
                     int vec, const int32_t* __restrict__ spec,
                     uint32_t* __restrict__ words, long long cap_words,
                     int32_t* __restrict__ total_bits,
                     unsigned long long* __restrict__ status,
                     unsigned long long epoch) {
  __shared__ __align__(16) int16_t s_coef[kBitRows * kHuffStride];
  __shared__ uint32_t s_ac[256];          // ac_len << 16 | ac_code
  __shared__ uint32_t s_dcs[12];          // dc_len << 16 | dc_code
  // The DCs of the previous chunk's last 6 blocks (their first two
  // coefficients, copied by cp.async) and of the staged rows.
  __shared__ int s_dc_all[6 + kBitRows];
  __shared__ int s_pre[kBitBlocks + 1];   // start | word offset << 18
  __shared__ unsigned s_warp[kBitWarps];
  __shared__ unsigned s_excl;
  __shared__ unsigned long long s_head;   // the bits after the chunk
  __shared__ int s_head_spills;
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_coef);
  int* s_dc = s_dc_all + 6;               // s_dc[g - g0], g >= g0 - 6
  const unsigned long long tag = epoch << 34;
  const int x = static_cast<int>(blockIdx.x);
  const int j = threadIdx.x, lane = j & 31, wid = j >> 5;

  if (x >= B * parts) {                   // a zeroing CTA
    const int zx = x - B * parts;
    const int b = divide_by(zx, div_zero), z = zx - b * zero_ctas;
    if (j == 0) {
      const unsigned long long* st =
          status + static_cast<long long>(b) * parts + parts - 1;
      unsigned long long s = peek(st);
      while ((s >> 34) != epoch || (s & kBitInclusive) == 0ull) {
        __nanosleep(256);
        s = peek(st);
      }
      s_excl = static_cast<unsigned>(s);
    }
    __syncthreads();
    const long long z0 = (static_cast<long long>(s_excl) + 31) >> 5;
    if (z0 >= cap_words) return;
    const long long span = cap_words - z0;
    bit_zero(words + static_cast<long long>(b) * cap_words,
             z0 + span * z / zero_ctas, z0 + span * (z + 1) / zero_ctas);
    return;
  }

  const int b = divide_by(x, div_parts);
  const int c = x - b * parts;
  const int g0 = c * kBitBlocks;
  const int n = min(kBitBlocks, nb - g0);
  const int staged = n + (c + 1 < parts ? min(kBitAhead, nb - g0 - n) : 0);
  const int16_t* tile = blocks + static_cast<long long>(b) * nb * 64;

  // 1. Loads.
  int rast[kBitLoads];
#pragma unroll
  for (int r = 0; r < kBitLoads; ++r) {
    const int jj = (r * kBitThreads + j) >> 3;
    rast[r] = jj < staged ? __ldg(scan + g0 + jj) : 0;
  }
  // The DC predecessors in the previous chunk, read beside the blocks.
  const int prev_rast = j < 6 && c > 0 ? __ldg(scan + g0 - 6 + j) : 0;
  uint32_t ac[256 / kBitThreads + 1], dcs = 0u;
#pragma unroll
  for (int q = 0; q * kBitThreads < 256; ++q) {
    const int i = q * kBitThreads + j;
    ac[q] = i < 256 ? static_cast<uint32_t>(__ldg(spec + kSpecAcLen + i))
                              << 16 |
                          (static_cast<uint32_t>(
                               __ldg(spec + kSpecAcCode + i)) & 0xFFFFu)
                    : 0u;
  }
  if (j < 12)
    dcs = static_cast<uint32_t>(__ldg(spec + kSpecDcLen + j)) << 16 |
          (static_cast<uint32_t>(__ldg(spec + kSpecDcCode + j)) & 0xFFFFu);
#pragma unroll
  for (int r = 0; r < kBitLoads; ++r) {
    const int p = r * kBitThreads + j, jj = p >> 3, part = p & 7;
    if (jj < staged) {
      const int16_t* src = tile + static_cast<long long>(rast[r]) * 64 +
                           8 * part;
      int16_t* dst = s_coef + jj * kHuffStride + 8 * part;
      if (vec) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[i] = __ldg(src + i);
      }
    }
  }
#pragma unroll
  for (int q = 0; q * kBitThreads < 256; ++q)
    if (q * kBitThreads + j < 256) s_ac[q * kBitThreads + j] = ac[q];
  if (j < 12) s_dcs[j] = dcs;
  const int16_t* prev_dc = tile + static_cast<long long>(prev_rast) * 64;
  if (j < 6 && c > 0 && vec) cp_async4(s_dc + j - 6, prev_dc);
  cp_async_wait();
  if (j < 6 && c > 0)
    s_dc[j - 6] = vec ? static_cast<int16_t>(s_dc[j - 6] & 0xFFFF)
                      : __ldg(prev_dc);
  __syncthreads();

  // 2. Fields.
  for (int r = j; r < staged; r += kBitThreads)
    s_dc[r] = s_coef[r * kHuffStride];
  uint32_t own[kHuffBlockWords];          // the block's words
  int len = 0, nw = 0, diff = 0;
  bool spill = false;
  unsigned long long mask = 0ull;
  const int16_t* blk = s_coef + j * kHuffStride;
  if (j < n) {
    mask = staged_mask(blk);
    const int pg = dc_pred_pos(g0 + j);
    const int pred = pg < 0     ? 0
                     : pg >= g0 ? s_coef[(pg - g0) * kHuffStride]
                                : s_dc[pg - g0];
    diff = blk[0] - pred;
    BitWriter out{own, 0ull, 0, 0, 0, false};
    bit_fields(blk, mask, diff, s_ac, s_dcs, [&](int32_t val, int l) {
      out.put(val, l);
      return true;
    });
    out.flush();
    len = out.bits;
    nw = out.words;
    spill = out.spill;
  }
  // The chunk scan of len | words << 18: each block's chunk-local bit
  // start and word offset.
  const int mine = len | nw << kBitLenBits;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[wid] = incl;
  const bool any_spill = __syncthreads_or(spill) != 0;
  unsigned agg_all = 0u;
#pragma unroll
  for (int w = 0; w < kBitWarps; ++w) {
    if (w < wid) incl += s_warp[w];
    agg_all += s_warp[w];
  }
  const unsigned agg = agg_all & kBitLenMask;
  const bool packed = !any_spill &&
                      static_cast<int>(agg_all >> kBitLenBits) <= kBitCapWords;
  if (j == 0)
    publish(status + static_cast<long long>(b) * parts + c,
            tag | (c == 0 ? kBitInclusive : kBitAggregate) | agg);
  const bool ahead = c + 1 < parts;

  // 3. Lookback; meanwhile the packing and the bits after the chunk.
  if (wid == 0) {
    unsigned excl = 0u;
    if (c > 0) {
      unsigned long long* st = status + static_cast<long long>(b) * parts;
      // kBitLook words a lane, position p = 32 q + lane at chunk i - p,
      // all read at once; each round waits until every word of its
      // window is this call's, then sums back to the nearest inclusive.
      for (int i = c - 1;; i -= 32 * kBitLook) {
        unsigned long long s[kBitLook];
#pragma unroll
        for (int q = 0; q < kBitLook; ++q) {
          const int idx = i - 32 * q - lane;
          s[q] = idx >= 0 ? peek(st + idx) : tag | kBitInclusive;
        }
        bool ready;
        do {
          ready = true;
#pragma unroll
          for (int q = 0; q < kBitLook; ++q)
            if ((s[q] >> 34) != epoch) {
              s[q] = peek(st + i - 32 * q - lane);
              ready = false;
            }
        } while (!__all_sync(kFullMask, ready));
        int stop = 32 * kBitLook;          // the nearest inclusive's p
#pragma unroll
        for (int q = kBitLook - 1; q >= 0; --q) {
          const unsigned inc =
              __ballot_sync(kFullMask, (s[q] & kBitInclusive) != 0ull);
          if (inc) stop = 32 * q + __ffs(inc) - 1;
        }
        unsigned part = 0u;
#pragma unroll
        for (int q = 0; q < kBitLook; ++q)
          if (32 * q + lane <= stop) part += static_cast<unsigned>(s[q]);
        excl += __reduce_add_sync(kFullMask, part);
        if (stop < 32 * kBitLook) break;
      }
      if (lane == 0) publish(st + c, tag | kBitInclusive | (excl + agg));
    }
    if (lane == 0) s_excl = excl;
  }
  if (packed) {
    if (j == kBitBlocks - 1) s_pre[kBitBlocks] = static_cast<int>(agg_all);
    s_pre[j] = incl - mine;
    const int wofs = (incl - mine) >> kBitLenBits;
    for (int k = 0; k < nw; ++k) s_words[wofs + k] = own[k];
    if (ahead && wid == (kBitWarps > 1 ? 1 : 0)) {
      // The bits after the chunk: lane l codes the fields of the staged
      // block n + l that start in its first 32 bits, a warp scan places
      // them, and past the staged rows (a spec with codes shorter than the
      // fixed ones) lane 0 goes on alone.
      unsigned long long bits = 0ull;
      int lpos = 0, first_spill = 64;
      if (lane < staged - n) {
        const int r = n + lane;
        const int16_t* nblk = s_coef + r * kHuffStride;
        const unsigned long long nmask = staged_mask(nblk);
        bit_fields(nblk, nmask, s_dc[r] - s_dc[dc_pred_pos(g0 + r) - g0],
                   s_ac, s_dcs, [&](int32_t val, int l) {
                     if (first_spill == 64 && bit_spills(val, l))
                       first_spill = lpos;
                     const int sh = 64 - lpos - l;
                     const unsigned long long u = static_cast<uint32_t>(val);
                     bits |= sh >= 0 ? u << sh : u >> -sh;
                     lpos += l;
                     return lpos < 32;
                   });
      }
      int start = lpos;                  // the warp's exclusive scan
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFullMask, start, d);
        if (lane >= d) start += t;
      }
      const int covered = __shfl_sync(kFullMask, start, 31);
      start -= lpos;
      unsigned long long head = start < 64 ? bits >> start : 0ull;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        head |= __shfl_xor_sync(kFullMask, head, d);
      bool spills =
          __any_sync(kFullMask, start < 32 && start + first_spill < 32);
      if (lane == 0) {
        int pos = covered;
        if (pos < 32)
          bit_next_fields(g0 + staged, g0, staged, nb, s_coef, s_dc, tile,
                          scan, s_ac, s_dcs, [&](int32_t val, int l) {
                            spills |= bit_spills(val, l);
                            head |= static_cast<unsigned long long>(
                                        static_cast<uint32_t>(val))
                                    << (64 - pos - l);
                            pos += l;
                            return pos < 32;
                          });
        s_head = head;
        s_head_spills = spills;
      }
    }
  } else {
    s_pre[j] = incl - mine;
  }
  __syncthreads();

  // 4. Output.
  const long long s0 = s_excl, s1 = s0 + agg;
  uint32_t* row = words + static_cast<long long>(b) * cap_words;
  // The exact sum of what the fields after the chunk add to word s1 >> 5.
  auto next_c0 = [&]() {
    const long long end = (s1 | 31) + 1;
    long long pos = s1;
    uint32_t sum = 0u;
    bit_next_fields(g0 + n, g0, staged, nb, s_coef, s_dc, tile, scan, s_ac,
                    s_dcs, [&](int32_t val, int l) {
                      sum += bit_c0(val, l, static_cast<int>(pos & 31));
                      pos += l;
                      return pos < end;
                    });
    return sum;
  };
  if (packed) {
    if (j < n && len > 0) {
      const int st = s_pre[j] & kBitLenMask;
      const long long lo = s0 + st;
      const long long m_end = min((lo + len + 31) >> 5, cap_words);
      for (long long m = (lo + 31) >> 5; m < m_end; ++m) {
        const int xb = static_cast<int>(32 * m - s0);   // chunk-local bit
        int filled = 0, i = j, o = xb - st;
        uint32_t v = 0u;
        while (filled < 32 && i < n) {
          const int pre = s_pre[i];
          const int take = min(32 - filled, ((s_pre[i + 1] - pre) &
                                             kBitLenMask) - o);
          if (take > 0) {
            const uint32_t* src =
                s_words + (pre >> kBitLenBits) + (o >> 5);
            const int r = o & 31;
            const unsigned long long two =
                static_cast<unsigned long long>(src[0]) << 32 |
                (r + take > 32 ? src[1] : 0u);
            v |= static_cast<uint32_t>((two << r) >> (64 - take))
                 << (32 - filled - take);
            filled += take;
          }
          ++i;
          o = 0;
        }
        if (ahead && xb + 32 > static_cast<int>(agg)) {
          if (s_head_spills)
            v += next_c0();
          else
            v |= static_cast<uint32_t>(s_head >> (32 + (s1 & 31)));
        }
        row[m] = v;
      }
    }
  } else {
    // The exact path: zero the owned words, then add every field.
    const long long m_own = (s0 + 31) >> 5;
    const long long m_end = min((s1 + 31) >> 5, cap_words);
    for (long long m = m_own + j; m < m_end; m += kBitThreads) row[m] = 0u;
    __syncthreads();
    if (j < n) {
      long long pos = s0 + (s_pre[j] & kBitLenMask);
      bit_fields(blk, mask, diff, s_ac, s_dcs, [&](int32_t val, int l) {
        const long long w = pos >> 5;
        const int r = static_cast<int>(pos & 31);
        if (w >= m_own && w < m_end) atomicAdd(row + w, bit_c0(val, l, r));
        if (r + l > 32 && w + 1 >= m_own && w + 1 < m_end)
          atomicAdd(row + w + 1, bit_c1(val, l, r));
        pos += l;
        return true;
      });
    }
    if (j == 0 && ahead && (s1 & 31) != 0 && (s1 >> 5) >= m_own &&
        (s1 >> 5) < m_end)
      atomicAdd(row + (s1 >> 5), next_c0());
  }
  if (c == parts - 1 && j == 0)
    total_bits[b] = static_cast<int32_t>(s1);
}

int resident_blocks(const void* kernel, int threads, int fallback,
                    size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
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

// K3.  packed i32[B, h, w]; tables f32[192] on the card (layout above);
// out_y i16[B, 4*mh*mw, 64], out_cb / out_cr i16[B, mh*mw, 64] for an
// mh x mw grid of 16x16 MCUs (mh*16 >= h, mw*16 >= w); the outputs 16-byte
// aligned.
extern "C" int jpeg_coefficients_launch(const void* packed, int B, int h,
                                        int w, int mh, int mw, int flip_h,
                                        int flip_v, const void* tables,
                                        void* out_y, void* out_cb,
                                        void* out_cr, void* stream) {
  const long long all = static_cast<long long>(mh) * mw * B;
  if (all > 0x7FFFFFFELL) return cudaErrorInvalidConfiguration;
  if (((reinterpret_cast<uintptr_t>(out_y) |
        reinterpret_cast<uintptr_t>(out_cb) |
        reinterpret_cast<uintptr_t>(out_cr)) & 15u) != 0)
    return cudaErrorMisalignedAddress;
  const int vec =
      (reinterpret_cast<uintptr_t>(packed) & 15u) == 0 && w % 4 == 0;
  const int resident = resident_blocks(
      reinterpret_cast<const void*>(jpeg_coefficients_kernel), kMcuThreads,
      132);
  jpeg_coefficients_kernel<<<grid_for((all + 1) / 2, 1, resident),
                             kMcuThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), static_cast<int>(all), h, w,
      fast_div(mh * mw), fast_div(mw), flip_h, flip_v, vec,
      static_cast<const float*>(tables),
      static_cast<int16_t*>(out_y), static_cast<int16_t*>(out_cb),
      static_cast<int16_t*>(out_cr));
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

// K4b.  wire u8[B, width] -> out u8[4B + B * width]; one launch, no
// scratch (the row offsets live in each block's shared memory).  mode 0:
// sparse rows (nb blocks a tile); mode 1: Huffman rows (cap_words words).
extern "C" int compact_rows_launch(const void* wire, int B, long long width,
                                   int n_valid, int cap, long long nb,
                                   int mode, long long cap_words, void* out,
                                   void* stream) {
  const size_t smem = (static_cast<size_t>(B) + 1) * sizeof(long long);
  if (B < 1 || (mode != kSparseRows && mode != kHuffmanRows))
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        compact_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long n = 4LL * B + static_cast<long long>(B) * width;
  const int resident = resident_blocks(
      reinterpret_cast<const void*>(compact_rows_kernel), kThreads, 132,
      smem);
  compact_rows_kernel<<<grid_for(n / 16 + 2, kThreads, resident),
                        kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wire), B, width, n_valid, cap, nb, mode,
      cap_words, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

// K5.  y i16[B, 4*h16*w16, 64], cb / cr i16[B, h16*w16, 64] (raster block
// order, zigzagged); spec i32[1024] (dc_code, dc_len, ac_code, ac_len, 256
// each); buf holds the rows u8[B, 8 + 4 cap_words], each [total i32 |
// total bits i32 | words u32[cap_words]], then at the next multiple of 8
// bytes the status words u64[status_words], at least
// huffman_pack_status_words(B, h16 * w16), one per chunk of kHuffBlocks
// coefficient blocks.  One memset of buf, one launch.
extern "C" long long huffman_pack_status_words(int B, long long nmcu) {
  return static_cast<long long>(B) *
         ((6 * nmcu + kHuffBlocks - 1) / kHuffBlocks);
}

extern "C" int huffman_pack_launch(const void* y, const void* cb,
                                   const void* cr, int B, int h16, int w16,
                                   const void* spec, long long cap_words,
                                   void* buf, long long status_words,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (B < 1 || h16 < 1 || w16 < 1 || cap_words < 0)
    return cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(cb) |
        reinterpret_cast<uintptr_t>(cr)) & 1u) != 0 ||
      (reinterpret_cast<uintptr_t>(buf) & 7u) != 0)
    return cudaErrorMisalignedAddress;
  const long long nmcu = static_cast<long long>(h16) * w16;
  const long long words = huffman_pack_status_words(B, nmcu);
  // Bit counts are u32 in the status words and i32 in the header: at most
  // 1728 bits a block, 2^20 blocks a tile.
  if (6 * nmcu > (1LL << 20) || words > 0x7FFFFFFFLL)
    return cudaErrorInvalidConfiguration;
  if (status_words < words) return cudaErrorInvalidValue;
  const int parts = static_cast<int>(words / B);
  const long long width = 8 + 4 * cap_words;
  const long long rows = (static_cast<long long>(B) * width + 7) / 8 * 8;
  auto* o8 = static_cast<uint8_t*>(buf);
  auto* st = reinterpret_cast<unsigned long long*>(o8 + rows);
  const int vec = ((reinterpret_cast<uintptr_t>(y) |
                    reinterpret_cast<uintptr_t>(cb) |
                    reinterpret_cast<uintptr_t>(cr)) & 15u) == 0;
  cudaError_t err = cudaMemsetAsync(buf, 0, rows + 8 * words, s);
  if (err != cudaSuccess) return err;
  huffman_pack_kernel<<<static_cast<unsigned>(words), kHuffThreads, 0, s>>>(
      static_cast<const int16_t*>(y), static_cast<const int16_t*>(cb),
      static_cast<const int16_t*>(cr), static_cast<int>(nmcu), w16,
      fast_div(w16), parts, fast_div(parts), vec,
      static_cast<const int32_t*>(spec), o8, width, cap_words, st);
  return cudaGetLastError();
}

// K6.  blocks i16[B, nb, 64] ([Y|Cb|Cr] raster blocks, zigzagged); scan
// i32[nb], the raster index of each scan position (ops/jpegenc.py
// _mcu_scan_index, nb = 6 n_mcu); spec i32[1024] as K5's, codes of at
// most 16 bits (ops/jpegenc.py spec_tensor refuses longer ones); words
// i32[B, cap_words]; total_bits i32[B]; status a scratch of at least
// bitpack_fixed_status_words(B, nb) uint64, one a chunk of kBitBlocks
// blocks, that no call in flight on another stream uses and that holds no
// word tagged `epoch` (1 <= epoch < 2^30; kernels/scratch.py gives each
// call on a stream a new one).  One launch and no memset: every word
// below the cap is stored once, by the chunk where it begins or, past the
// stream, by a zeroing CTA.
extern "C" long long bitpack_fixed_status_words(int B, long long nb) {
  return static_cast<long long>(B) * ((nb + kBitBlocks - 1) / kBitBlocks);
}

extern "C" int bitpack_fixed_launch(const void* blocks, int B, long long nb,
                                    const void* scan, const void* spec,
                                    long long cap_words, void* words,
                                    void* total_bits, void* status,
                                    long long status_words,
                                    unsigned long long epoch, void* stream) {
  if (B < 1 || nb < 6 || nb % 6 != 0 || cap_words < 0 || epoch < 1 ||
      epoch >= (1ull << 30))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(blocks) & 1u) != 0 ||
      (reinterpret_cast<uintptr_t>(words) & 3u) != 0 ||
      (reinterpret_cast<uintptr_t>(status) & 7u) != 0)
    return cudaErrorMisalignedAddress;
  const long long chunks = bitpack_fixed_status_words(B, nb);
  // Bit counts are u32 in the status words and i32 in total_bits: at most
  // 1728 bits a block, 2^20 blocks a tile.
  const long long want = cap_words / kBitZeroWords;
  const long long zero = want < 1 ? 1 : want > kBitZeroCtas ? kBitZeroCtas
                                                             : want;
  if (nb > (1LL << 20) || chunks + B * zero > 0x7FFFFFFFLL)
    return cudaErrorInvalidConfiguration;
  if (status_words < chunks) return cudaErrorInvalidValue;
  const int parts = static_cast<int>(chunks / B);
  const int vec = (reinterpret_cast<uintptr_t>(blocks) & 15u) == 0;
  bitpack_fixed_kernel<<<static_cast<unsigned>(chunks + B * zero),
                         kBitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(blocks), B, static_cast<int>(nb),
      static_cast<const int32_t*>(scan), parts, fast_div(parts),
      static_cast<int>(zero), fast_div(static_cast<int>(zero)), vec,
      static_cast<const int32_t*>(spec), static_cast<uint32_t*>(words),
      cap_words, static_cast<int32_t*>(total_bits),
      static_cast<unsigned long long*>(status), epoch);
  return cudaGetLastError();
}
