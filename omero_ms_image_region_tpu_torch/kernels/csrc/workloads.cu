// Hand-written Hopper kernels of the projection, mask and pyramid
// workloads.
//
// K7  project_fold_kernel    replaces the JAX package's projection folds
//                            (ops/projection.py: _fold_max, _fold_sum,
//                            _fold_chunk, _stitch, _finalize)
// K8a mask_rasterize_kernel  replaces ops/maskops.py::_rasterize_batch_jit
// K8b mask_overlay_kernel    replaces ops/maskops.py::_overlay_batch_jit
// K9  mean2_int_kernel       replaces ops/pyramid.py::_mean2_int_jit
//
// All four are byte passes, bound by device memory.  K7 and K9 handle a
// short vector of consecutive elements a thread with 16-byte loads (and
// 16- or 8-byte stores) where the sizes and the alignment allow (their
// *_launch function picks the path), and one element a thread otherwise.
// K8a and K8b (redesigned for Hopper) have one kernel each that takes
// every shape: K8a makes 32 output bytes a thread from 32-bit windows of
// the packed bits, K8b blends 8 pixels a thread from loads it issues all
// at once; the few bytes or pixels around a row end, a mask's or tile's
// start off alignment and its ragged end take a narrower path inside the
// same launch (the notes above each say which).  Built with -fmad=false
// and without fast math: K7 rounds every conversion, add and divide as
// numpy does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ------------------------------------------------------------------- K7

// Pixel types, in the codes of kernels/workloads.py.
enum PixelCode { I8 = 0, U8 = 1, I16 = 2, U16 = 3, I32 = 4, U32 = 5,
                 F32 = 6, F64 = 7 };

// numpy's astype(float32): round to nearest even.
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(int16_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(uint16_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(int32_t v) {
  return __int2float_rn(v);
}
__device__ __forceinline__ float to_f32(uint32_t v) {
  return __uint2float_rn(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) {
  return __double2float_rn(v);
}

// np.maximum / np.minimum: a NaN on either side wins (fmaxf and fminf
// would drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

struct FoldArgs {
  long long n;        // pixels of one plane of the chunk (h * W)
  int zc;             // planes in the chunk
  int alg;            // 0 max, 1 mean, 2 sum (models.rendering.Projection)
  int first;          // the accumulator starts from plane 0
  int finalize;       // apply the floor, the mean divide and the clamp
  float count;        // max(window planes, 1), for the mean
  float type_max;     // the pixel type's max as f32, for mean and sum
};

// One pixel: fold the chunk's planes in z order into ``acc`` (one max or
// one add at a time), then finalize.
template <typename T>
__device__ __forceinline__ float fold_pixel(const T* __restrict__ chunk,
                                            long long i, float acc,
                                            const FoldArgs& a) {
  int z = 0;
  if (a.first) {
    acc = to_f32(chunk[i]);
    z = 1;
  }
  if (a.alg == 0) {
    for (; z < a.zc; ++z) acc = max_nan(acc, to_f32(chunk[z * a.n + i]));
  } else {
    for (; z < a.zc; ++z) acc = __fadd_rn(acc, to_f32(chunk[z * a.n + i]));
  }
  if (a.finalize) {
    if (a.alg == 0) {
      acc = max_nan(acc, 0.0f);
    } else {
      if (a.alg == 1) acc = __fdiv_rn(acc, a.count);
      acc = min_nan(acc, a.type_max);
    }
  }
  return acc;
}

// Eight consecutive elements of T, read as 16-byte words where T is at
// least two bytes wide (one 8-byte word for bytes).
template <typename T>
struct Vec8 {
  T v[8];
};

template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* __restrict__ p) {
  Vec8<T> out;
  constexpr int kBytes = 8 * sizeof(T);
  if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(out.v) = *reinterpret_cast<const uint2*>(p);
  } else {
    #pragma unroll
    for (int k = 0; k < kBytes / 16; ++k)
      reinterpret_cast<uint4*>(out.v)[k] =
          reinterpret_cast<const uint4*>(p)[k];
  }
  return out;
}

// Vector path: n % 8 == 0, the chunk and ``out`` 16-byte aligned.
template <typename T>
__global__ void project_fold_kernel_vec(const T* __restrict__ chunk,
                                        float* __restrict__ out,
                                        FoldArgs a) {
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long i0 = v * 8;
  if (i0 >= a.n) return;
  float acc[8];
  if (a.first) {
    Vec8<T> x = load8(chunk + i0);
    #pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = to_f32(x.v[k]);
  } else {
    float4 lo = reinterpret_cast<const float4*>(out + i0)[0];
    float4 hi = reinterpret_cast<const float4*>(out + i0)[1];
    acc[0] = lo.x; acc[1] = lo.y; acc[2] = lo.z; acc[3] = lo.w;
    acc[4] = hi.x; acc[5] = hi.y; acc[6] = hi.z; acc[7] = hi.w;
  }
  for (int z = a.first ? 1 : 0; z < a.zc; ++z) {
    Vec8<T> x = load8(chunk + z * a.n + i0);
    if (a.alg == 0) {
      #pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = max_nan(acc[k], to_f32(x.v[k]));
    } else {
      #pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[k] = __fadd_rn(acc[k], to_f32(x.v[k]));
    }
  }
  if (a.finalize) {
    #pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (a.alg == 0) {
        acc[k] = max_nan(acc[k], 0.0f);
      } else {
        if (a.alg == 1) acc[k] = __fdiv_rn(acc[k], a.count);
        acc[k] = min_nan(acc[k], a.type_max);
      }
    }
  }
  reinterpret_cast<float4*>(out + i0)[0] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  reinterpret_cast<float4*>(out + i0)[1] =
      make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// Scalar path: one pixel a thread, any size or alignment.
template <typename T>
__global__ void project_fold_kernel(const T* __restrict__ chunk,
                                    float* __restrict__ out, FoldArgs a) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  out[i] = fold_pixel(chunk, i, a.first ? 0.0f : out[i], a);
}

template <typename T>
int launch_fold(const void* chunk, float* out, const FoldArgs& a, bool vec,
                cudaStream_t stream) {
  const int threads = 256;
  const T* c = static_cast<const T*>(chunk);
  if (vec) {
    long long vecs = a.n / 8;
    unsigned blocks = (unsigned)((vecs + threads - 1) / threads);
    project_fold_kernel_vec<T><<<blocks, threads, 0, stream>>>(c, out, a);
  } else {
    unsigned blocks = (unsigned)((a.n + threads - 1) / threads);
    project_fold_kernel<T><<<blocks, threads, 0, stream>>>(c, out, a);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K8a
//
// What bounds it: every packed byte becomes eight output bytes (1 MiB of
// bits to 8 MiB of 0/1 bytes at B=8 1024^2), so its bytes are the output's
// stores.  The first design made each output byte from its own byte load,
// flip and index arithmetic (16 rounds of it per 16-byte store, a 64-bit
// divide a thread), and was bound by instruction issue, not by bytes.
//
// Design: one thread makes one group of 32 output bytes, 32-byte aligned
// in memory, from 32-bit windows of the packed bits.  A window is two
// aligned 32-bit words, byte-swapped into MSB-first order
// (``__byte_perm``) and joined with ``__funnelshift_l``; it is reversed
// with ``__brev`` unless the row is flipped horizontally (the window then
// starts at the mirrored column and its order is already the output's).
// The 32 bits become 32 bytes of 0/1 four at a time by a multiply and a
// mask, and leave as two 16-byte streaming stores.  Indices inside a mask
// are 32-bit.
//
// Which path each group takes, all in the one kernel: a group inside one
// output row reads one window (all of them when W is a multiple of 32 and
// the mask's base is 32-byte aligned, as at 1024^2); a group that crosses
// a row end reads one window per row piece (two when W >= 32, one per row
// when W < 32); the group holding a mask's first byte (its head, when the
// mask does not start on a 32-byte boundary: member b > 0 of a batch whose
// H * W is no multiple of 32) and the one holding its last (its tail)
// store the bytes they own one at a time.  The packed words are read from
// the buffer's 4-byte aligned base, so a row stride ``nbytes`` that is no
// multiple of 4 costs nothing; a word that reaches past either end of the
// buffer is read byte by byte, its bytes outside it as 0.

// Word ``w`` of ``words`` in MSB-first order (its first byte in bits
// 31-24).  Bytes outside [lo, hi) of ``words`` read as 0 and are not
// loaded.
__device__ __forceinline__ uint32_t be_word(
    const uint32_t* __restrict__ words, long long w, long long lo,
    long long hi) {
  const long long b0 = w * 4;
  if (b0 >= lo && b0 + 4 <= hi)
    return __byte_perm(__ldg(words + w), 0, 0x0123);
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(words);
  uint32_t v = 0;
  #pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = b0 + k;
    v = (v << 8) | ((i >= lo && i < hi) ? (uint32_t)__ldg(bytes + i) : 0u);
  }
  return v;
}

// The 32 bits from bit ``bit`` of ``words`` on (MSB first): the first in
// bit 31.
__device__ __forceinline__ uint32_t bit_window(
    const uint32_t* __restrict__ words, long long bit, long long lo,
    long long hi) {
  const long long w = bit >> 5;
  return __funnelshift_l(be_word(words, w + 1, lo, hi),
                         be_word(words, w, lo, hi), (unsigned)(bit & 31));
}

// Output columns x .. x+len-1 (1 <= len <= 32) of the source row whose
// first bit is ``row0``, as bits 0 .. len-1.
__device__ __forceinline__ uint32_t row_bits(
    const uint32_t* __restrict__ words, long long row0, uint32_t x, int len,
    uint32_t W, int fh, long long lo, long long hi) {
  if (fh)   // source columns W-x-len .. W-1-x, read backwards
    return bit_window(words, row0 + (W - x - len), lo, hi) >> (32 - len);
  const uint32_t v = __brev(bit_window(words, row0 + x, lo, hi));
  return len == 32 ? v : v & ((1u << len) - 1u);
}

constexpr int kMaskGroup = 32;   // output bytes a thread

// A 16-byte streaming store (evict first: K8a and K8b write each output
// byte once and do not read it back).
__device__ __forceinline__ void store16(uint4* p, uint4 v) { __stcs(p, v); }

// Bits 0-3 of ``nib`` as four bytes of 0/1, bit 0 in the lowest byte.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// ``words``: the packed buffer's 4-byte aligned base; mask b's bits start
// at byte lo + b * nbytes of it, and [lo, hi) is the buffer.  n = H * W <
// 2^32.
__global__ void mask_rasterize_kernel(const uint32_t* __restrict__ words,
                                      long long lo, long long hi,
                                      long long nbytes, uint32_t W,
                                      uint32_t H, int fh, int fv,
                                      uint8_t* __restrict__ out) {
  const uint32_t n = H * W;
  const int b = (int)blockIdx.y;
  uint8_t* dst = out + (long long)b * n;
  // The group's first byte, from the 32-byte boundary at or before the
  // mask's start; it owns bytes k0 .. k1-1 of its 32.
  const long long start =
      (long long)(blockIdx.x * blockDim.x + threadIdx.x) * kMaskGroup -
      (long long)(reinterpret_cast<uintptr_t>(dst) & (kMaskGroup - 1));
  if (start >= (long long)n) return;
  const int k0 = start < 0 ? (int)-start : 0;
  const int k1 = (long long)n - start < kMaskGroup
                     ? (int)((long long)n - start) : kMaskGroup;
  const long long bits0 = (lo + (long long)b * nbytes) * 8;
  const uint32_t o = (uint32_t)(start + k0);
  uint32_t y = o / W;
  uint32_t x = o - y * W;
  uint32_t r = 0;   // bit k: output byte k of the group
  for (int k = k0; k < k1;) {
    const int len = min(k1 - k, (int)min(W - x, (uint32_t)kMaskGroup));
    const uint32_t sy = fv ? H - 1 - y : y;
    r |= row_bits(words, bits0 + (long long)sy * W, x, len, W, fh, lo, hi)
         << k;
    k += len;
    x = 0;
    ++y;
  }
  if (k0 == 0 && k1 == kMaskGroup) {
    uint4* d = reinterpret_cast<uint4*>(dst + start);
    #pragma unroll
    for (int i = 0; i < kMaskGroup / 16; ++i, r >>= 16)
      store16(d + i, make_uint4(spread4(r & 15u), spread4((r >> 4) & 15u),
                                spread4((r >> 8) & 15u),
                                spread4((r >> 12) & 15u)));
  } else {
    for (int k = k0; k < k1; ++k) dst[start + k] = (r >> k) & 1u;
  }
}

// ------------------------------------------------------------------ K8b
//
// What bounds it: bytes, 9 a pixel (4 read from the base, 1 from the grid,
// 4 written), with some 15-25 integer operations a pixel.  The first
// design had each thread blend 4 pixels from one 16-byte and one 4-byte
// load: at B=1 1024^2 one wave of CTAs with one load pair in flight a
// thread, then a wait on device memory, then the stores; and any pixel
// count that is no multiple of 4, or a base off 16-byte alignment, sent
// the whole tile to a kernel of one pixel a thread and byte loads.
//
// Design: a thread blends ``kOverlayPx`` consecutive pixels of one tile
// and issues all its loads (32 bytes of base, 8 of grid) before it uses
// any, through the read-only path (``__ldg``); its stores are streaming
// (``__stcs``: each byte is written once).  Chunks are 16-byte aligned in
// ``out`` (which the wrapper allocates); the few pixels of a tile before
// its first aligned chunk (its head: tile b > 0 when H * W is no multiple
// of 4) and after its last whole chunk (its tail) take one thread each in
// the same launch.  The base is read in 16-byte loads where it is 16-byte
// aligned at the tile's first chunk, the grid in 8-byte ones where it is
// 8-byte aligned there; either takes 4-byte loads where it is 4-byte
// aligned (a base 4 bytes off a 16-byte boundary) and byte loads else.  A masked
// pixel's blend is about 15 integer operations, an unmasked one a select;
// ``/ 255u`` compiles to a multiply by a constant and a shift.
// (``scripts/k8_masks.py --sweep`` times the alternatives on the card: 16
// or 4 pixels a thread, CTAs of 256, other load and store hints.)

constexpr int kOverlayPx = 8;   // pixels a thread

// (base * (255 - a) + fill * a + 127) // 255 in u32, a = (grid != 0) *
// fill alpha; the base's alpha is copied.  Where the grid is 0 that is the
// base itself ((c * 255 + 127) // 255 == c), so only the masked blend is
// computed, from a tile's constants: red and blue together in the two
// 16-bit halves of one word (each at most 255 * 255 + 127, and x // 255 ==
// (x + 1 + (x >> 8)) >> 8 for every such x), green alone.
struct Blend {
  uint32_t ia;     // 255 - fill alpha
  uint32_t k_rb;   // red * alpha + 127, (blue * alpha + 127) << 16
  uint32_t k_g;    // green * alpha + 127
};

__device__ __forceinline__ Blend blend_of(const uint8_t* fills, int b) {
  const uint8_t* f = fills + 4 * b;
  const uint32_t a = __ldg(f + 3);
  return {255u - a, ((uint32_t)__ldg(f) * a + 127u) |
                        (((uint32_t)__ldg(f + 2) * a + 127u) << 16),
          (uint32_t)__ldg(f + 1) * a + 127u};
}

__device__ __forceinline__ uint32_t blend_px(uint32_t px, uint32_t g,
                                             const Blend& f) {
  uint32_t rb = (px & 0x00FF00FFu) * f.ia + f.k_rb;
  rb = ((rb + 0x00010001u + ((rb >> 8) & 0x00FF00FFu)) >> 8) & 0x00FF00FFu;
  const uint32_t gg = (((px >> 8) & 0xFFu) * f.ia + f.k_g) / 255u;
  return g ? rb | (gg << 8) | (px & 0xFF000000u) : px;
}

// An input load through the read-only path (each input byte is read once;
// evict-first loads, ``__ldcs``, measured slower here).
template <typename T>
__device__ __forceinline__ T ld_stream(const T* p) { return __ldg(p); }

// 4 * N bytes from ``p`` (``A``-byte aligned) into ``w``, in loads of
// min(A, 4 * N) bytes, all issued before any is used.
template <int A, int N>
__device__ __forceinline__ void load_stream(const uint8_t* __restrict__ p,
                                            uint32_t (&w)[N]) {
  constexpr int kA = A < 4 * N ? A : 4 * N;
  if constexpr (kA == 16) {
    #pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = ld_stream(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (kA == 8) {
    #pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint2 v = ld_stream(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = v.x; w[2 * i + 1] = v.y;
    }
  } else if constexpr (kA == 4) {
    #pragma unroll
    for (int i = 0; i < N; ++i)
      w[i] = ld_stream(reinterpret_cast<const unsigned int*>(p) + i);
  } else {
    #pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned char* q = p + 4 * i;
      w[i] = (uint32_t)ld_stream(q) | ((uint32_t)ld_stream(q + 1) << 8) |
             ((uint32_t)ld_stream(q + 2) << 16) |
             ((uint32_t)ld_stream(q + 3) << 24);
    }
  }
}

// One chunk of kOverlayPx pixels: base and grid ``BA``- and ``GA``-byte
// aligned, ``out`` 16-byte aligned.
template <int BA, int GA>
__device__ __forceinline__ void overlay_chunk(
    const uint8_t* __restrict__ base, const uint8_t* __restrict__ grid,
    uint8_t* __restrict__ out, const Blend& fill) {
  uint32_t px[kOverlayPx], g[kOverlayPx / 4];
  load_stream<BA>(base, px);
  load_stream<GA>(grid, g);
  #pragma unroll
  for (int i = 0; i < kOverlayPx / 4; ++i)
    store16(reinterpret_cast<uint4*>(out) + i,
           make_uint4(blend_px(px[4 * i], g[i] & 0xFFu, fill),
                      blend_px(px[4 * i + 1], (g[i] >> 8) & 0xFFu, fill),
                      blend_px(px[4 * i + 2], (g[i] >> 16) & 0xFFu, fill),
                      blend_px(px[4 * i + 3], g[i] >> 24, fill)));
}

// ``widest`` (16 or 8) if ``p`` is aligned to it, else 4 if it is 4-byte
// aligned, else 1: the loads a chunk's bytes from ``p`` are made of.
__device__ __forceinline__ int load_width(const void* p, int widest) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return a % widest == 0 ? widest : a % 4 == 0 ? 4 : 1;
}

template <int BA>
__device__ __forceinline__ void overlay_chunk_g(
    int ga, const uint8_t* __restrict__ base,
    const uint8_t* __restrict__ grid, uint8_t* __restrict__ out,
    const Blend& fill) {
  switch (ga) {
    case 8: overlay_chunk<BA, 8>(base, grid, out, fill); break;
    case 4: overlay_chunk<BA, 4>(base, grid, out, fill); break;
    default: overlay_chunk<BA, 1>(base, grid, out, fill); break;
  }
}

// Tile blockIdx.y: threads 0 .. chunks-1 blend a whole chunk each, the
// next ``head + tail`` threads one head or tail pixel each.  ``out`` is
// 16-byte aligned.
__global__ void mask_overlay_kernel(const uint8_t* __restrict__ base,
                                    const uint8_t* __restrict__ grid,
                                    const uint8_t* __restrict__ fills,
                                    uint8_t* __restrict__ out,
                                    long long px) {
  const int b = (int)blockIdx.y;
  const long long p0 = (long long)b * px;   // the tile's first pixel
  const long long head = min((long long)((4 - (p0 & 3)) & 3), px);
  const long long body = p0 + head;          // its first aligned chunk
  const long long chunks = (px - head) / kOverlayPx;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const Blend fill = blend_of(fills, b);
  if (t < chunks) {
    const long long i = body + t * kOverlayPx;
    const int ga = load_width(grid + body, 8);
    switch (load_width(base + 4 * body, 16)) {
      case 16: overlay_chunk_g<16>(ga, base + 4 * i, grid + i, out + 4 * i,
                                   fill); break;
      case 4: overlay_chunk_g<4>(ga, base + 4 * i, grid + i, out + 4 * i,
                                 fill); break;
      default: overlay_chunk_g<1>(ga, base + 4 * i, grid + i, out + 4 * i,
                                  fill); break;
    }
    return;
  }
  const long long j = t - chunks;
  const long long tail = px - head - chunks * kOverlayPx;
  if (j >= head + tail) return;
  const long long i =
      j < head ? p0 + j : body + chunks * kOverlayPx + (j - head);
  uint32_t v[1];
  load_stream<1>(base + 4 * i, v);
  const uint32_t o = blend_px(v[0], ld_stream(grid + i), fill);
  uint8_t* d = out + 4 * i;
  d[0] = o & 0xFFu;
  d[1] = (o >> 8) & 0xFFu;
  d[2] = (o >> 16) & 0xFFu;
  d[3] = o >> 24;
}

// ------------------------------------------------------------------- K9

// The rounded mean of a 2x2 block of integer samples, as the JAX package's
// _mean2_int_jit computes it: the int32 sum s (exact, |s| <= 4 * 65535),
// times 0.25 in f32 (exact: a power of two and |s| < 2^24), rounded half
// to even (rintf, as jnp.round), back to the storage type (in range).
template <typename T>
__device__ __forceinline__ T mean4(T a, T b, T c, T d) {
  int s = (int)a + (int)b + (int)c + (int)d;
  return (T)(int)rintf(__fmul_rn((float)s, 0.25f));
}

template <typename T, int N>
union Lanes {
  T e[N];
  typename std::conditional<sizeof(T) * N == 16, uint4, uint2>::type v;
};

// Vector path: the input row pitch W holds a whole number of 16-byte
// vectors and both bases are aligned.  A thread reads 16 bytes of each of
// the two input rows (2K samples each) and writes the K = 8 / sizeof(T)
// output samples they reduce to as one 8-byte store.  ``in`` is
// [N, H, W]; an odd last row (H odd) is never read.
template <typename T>
__global__ void mean2_int_kernel_vec(const T* __restrict__ in,
                                     T* __restrict__ out, long long H,
                                     long long W, long long h, long long w,
                                     long long vecs_per_row,
                                     long long total) {
  constexpr int K = 8 / sizeof(T);
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long row = i / vecs_per_row;          // n * h + oy
  long long v = i - row * vecs_per_row;
  long long n = row / h;
  long long oy = row - n * h;
  const T* r0 = in + (n * H + 2 * oy) * W + 2 * K * v;
  Lanes<T, 2 * K> a, b;
  a.v = __ldg(reinterpret_cast<const uint4*>(r0));
  b.v = __ldg(reinterpret_cast<const uint4*>(r0 + W));
  Lanes<T, K> o;
  #pragma unroll
  for (int k = 0; k < K; ++k)
    o.e[k] = mean4(a.e[2 * k], a.e[2 * k + 1], b.e[2 * k], b.e[2 * k + 1]);
  *reinterpret_cast<uint2*>(out + row * w + K * v) = o.v;
}

// Scalar path: one output sample a thread (odd or unaligned widths).
template <typename T>
__global__ void mean2_int_kernel(const T* __restrict__ in,
                                 T* __restrict__ out, long long H,
                                 long long W, long long h, long long w,
                                 long long total) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long row = i / w;
  long long ox = i - row * w;
  long long n = row / h;
  long long oy = row - n * h;
  const T* r0 = in + (n * H + 2 * oy) * W + 2 * ox;
  out[i] = mean4(r0[0], r0[1], r0[W], r0[W + 1]);
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

template <typename T>
int launch_mean2(const void* in, void* out, long long N, long long H,
                 long long W, cudaStream_t stream) {
  const int threads = 256;
  constexpr int K = 8 / sizeof(T);
  long long h = H / 2, w = W / 2;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  if (W % (2 * K) == 0 && aligned(in, 16) && aligned(out, 8)) {
    long long per_row = w / K;
    long long total = N * h * per_row;
    unsigned blocks = (unsigned)((total + threads - 1) / threads);
    mean2_int_kernel_vec<T><<<blocks, threads, 0, stream>>>(
        src, dst, H, W, h, w, per_row, total);
  } else {
    long long total = N * h * w;
    unsigned blocks = (unsigned)((total + threads - 1) / threads);
    mean2_int_kernel<T><<<blocks, threads, 0, stream>>>(src, dst, H, W, h,
                                                        w, total);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: fold chunk [zc, n] of pixel type ``dtype`` into out[n] (f32).
int project_fold_launch(const void* chunk, int dtype, int zc, long long n,
                        float* out, int alg, int first, int finalize,
                        float count, float type_max, void* stream) {
  if (n <= 0) return 0;
  FoldArgs a{n, zc, alg, first, finalize, count, type_max};
  bool vec = n % 8 == 0 && aligned(chunk, 16) && aligned(out, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case I8: return launch_fold<int8_t>(chunk, out, a, vec, s);
    case U8: return launch_fold<uint8_t>(chunk, out, a, vec, s);
    case I16: return launch_fold<int16_t>(chunk, out, a, vec, s);
    case U16: return launch_fold<uint16_t>(chunk, out, a, vec, s);
    case I32: return launch_fold<int32_t>(chunk, out, a, vec, s);
    case U32: return launch_fold<uint32_t>(chunk, out, a, vec, s);
    case F32: return launch_fold<float>(chunk, out, a, vec, s);
    case F64: return launch_fold<double>(chunk, out, a, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K8a: packed u8[B, nbytes] -> u8[B, H, W] 0/1 (H * W < 2^32).
int mask_rasterize_launch(const uint8_t* packed, int B, long long nbytes,
                          int W, int H, int fh, int fv, uint8_t* out,
                          void* stream) {
  const long long n = (long long)H * W;
  if (B <= 0 || n <= 0) return 0;
  if (n > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long lo = (long long)(reinterpret_cast<uintptr_t>(packed) & 3);
  // With a head, one group more than n / kMaskGroup rounded up.
  const long long groups = (n + 2 * kMaskGroup - 2) / kMaskGroup;
  dim3 grid((unsigned)((groups + threads - 1) / threads), (unsigned)B);
  mask_rasterize_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(packed - lo), lo,
      lo + (long long)B * nbytes, nbytes, (uint32_t)W, (uint32_t)H, fh, fv,
      out);
  return (int)cudaGetLastError();
}

// K8b: base u8[B, H, W, 4], grid u8[B, H, W], fills u8[B, 4] -> out
// (16-byte aligned).
int mask_overlay_launch(const uint8_t* base, const uint8_t* grid,
                        const uint8_t* fills, int B, long long px,
                        uint8_t* out, void* stream) {
  if (B <= 0 || px <= 0) return 0;
  if (!aligned(out, 16)) return (int)cudaErrorMisalignedAddress;
  const int threads = 128;
  // Whole chunks, and up to 3 + kOverlayPx - 1 head and tail pixels.
  const long long per_tile = px / kOverlayPx + 3 + kOverlayPx;
  dim3 g((unsigned)((per_tile + threads - 1) / threads), (unsigned)B);
  mask_overlay_kernel<<<g, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      base, grid, fills, out, px);
  return (int)cudaGetLastError();
}

// K9: in [N, H, W] of pixel type ``dtype`` (I8, U8, I16 or U16) ->
// out [N, H / 2, W / 2] of the same type.
int mean2_int_launch(const void* in, int dtype, long long N, long long H,
                     long long W, void* out, void* stream) {
  if (N <= 0 || H < 2 || W < 2) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case I8: return launch_mean2<int8_t>(in, out, N, H, W, s);
    case U8: return launch_mean2<uint8_t>(in, out, N, H, W, s);
    case I16: return launch_mean2<int16_t>(in, out, N, H, W, s);
    case U16: return launch_mean2<uint16_t>(in, out, N, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
