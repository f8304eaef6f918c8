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
// All four are byte passes, bound by device memory.  Each thread handles
// a short vector of consecutive elements with 16-byte loads (and 16- or
// 8-byte stores) where the sizes and the alignment allow (the *_launch
// function picks the path), and one element per thread otherwise.  Built with -fmad=false and without fast
// math: K7 rounds every conversion, add and divide as numpy does.

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

// The bit of output (y, x) of a mask: MSB first, continuous across rows,
// read at the flipped source position.
__device__ __forceinline__ uint8_t mask_bit(const uint8_t* __restrict__ row,
                                            int W, int H, int y, int x,
                                            int fh, int fv) {
  int sy = fv ? H - 1 - y : y;
  int sx = fh ? W - 1 - x : x;
  long long i = (long long)sy * W + sx;
  return (row[i >> 3] >> (7 - (int)(i & 7))) & 1;
}

// Vector path: H * W % 16 == 0 and ``out`` 16-byte aligned; 16 output
// bytes a thread, one 16-byte store.
__global__ void mask_rasterize_kernel_vec(const uint8_t* __restrict__ packed,
                                          long long nbytes, int W, int H,
                                          int fh, int fv,
                                          uint8_t* __restrict__ out,
                                          long long vecs_per_mask) {
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int b = (int)blockIdx.y;
  if (v >= vecs_per_mask) return;
  const uint8_t* row = packed + (long long)b * nbytes;
  long long o = v * 16;
  int y = (int)(o / W);
  int x = (int)(o - (long long)y * W);
  uint32_t w[4];
  #pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t word = 0;
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      word |= (uint32_t)mask_bit(row, W, H, y, x, fh, fv) << (8 * j);
      if (++x == W) {
        x = 0;
        ++y;
      }
    }
    w[k] = word;
  }
  reinterpret_cast<uint4*>(out + (long long)b * H * W)[v] =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// Scalar path: one output byte a thread.
__global__ void mask_rasterize_kernel(const uint8_t* __restrict__ packed,
                                      long long nbytes, int W, int H, int fh,
                                      int fv, uint8_t* __restrict__ out) {
  long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int b = (int)blockIdx.y;
  long long n = (long long)H * W;
  if (o >= n) return;
  int y = (int)(o / W);
  int x = (int)(o - (long long)y * W);
  out[(long long)b * n + o] =
      mask_bit(packed + (long long)b * nbytes, W, H, y, x, fh, fv);
}

// ------------------------------------------------------------------ K8b

// (base * (255 - a) + fill * a + 127) // 255 in u32, a = (grid != 0) *
// fill alpha; the base's alpha is copied.
__device__ __forceinline__ uint32_t blend_px(uint32_t px, uint8_t g,
                                             uint32_t fill) {
  uint32_t a = g ? (fill >> 24) : 0u;
  uint32_t ia = 255u - a;
  uint32_t r = ((px & 0xFFu) * ia + (fill & 0xFFu) * a + 127u) / 255u;
  uint32_t gg = (((px >> 8) & 0xFFu) * ia + ((fill >> 8) & 0xFFu) * a +
                 127u) / 255u;
  uint32_t bb = (((px >> 16) & 0xFFu) * ia + ((fill >> 16) & 0xFFu) * a +
                 127u) / 255u;
  return r | (gg << 8) | (bb << 16) | (px & 0xFF000000u);
}

__device__ __forceinline__ uint32_t fill_word(const uint8_t* fills, int b) {
  const uint8_t* f = fills + 4 * b;
  return (uint32_t)f[0] | ((uint32_t)f[1] << 8) | ((uint32_t)f[2] << 16) |
         ((uint32_t)f[3] << 24);
}

// Vector path: H * W % 4 == 0, base and out 16-byte aligned, grid 4-byte
// aligned; 4 pixels a thread.
__global__ void mask_overlay_kernel_vec(const uint8_t* __restrict__ base,
                                        const uint8_t* __restrict__ grid,
                                        const uint8_t* __restrict__ fills,
                                        uint8_t* __restrict__ out,
                                        long long quads_per_tile) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int b = (int)blockIdx.y;
  if (q >= quads_per_tile) return;
  long long quad = (long long)b * quads_per_tile + q;
  uint32_t fill = fill_word(fills, b);
  uint4 px = reinterpret_cast<const uint4*>(base)[quad];
  uint32_t g = reinterpret_cast<const uint32_t*>(grid)[quad];
  uint4 o;
  o.x = blend_px(px.x, g & 0xFFu, fill);
  o.y = blend_px(px.y, (g >> 8) & 0xFFu, fill);
  o.z = blend_px(px.z, (g >> 16) & 0xFFu, fill);
  o.w = blend_px(px.w, g >> 24, fill);
  reinterpret_cast<uint4*>(out)[quad] = o;
}

// Scalar path: one pixel a thread, byte loads and stores.
__global__ void mask_overlay_kernel(const uint8_t* __restrict__ base,
                                    const uint8_t* __restrict__ grid,
                                    const uint8_t* __restrict__ fills,
                                    uint8_t* __restrict__ out,
                                    long long px_per_tile) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int b = (int)blockIdx.y;
  if (p >= px_per_tile) return;
  long long i = (long long)b * px_per_tile + p;
  const uint8_t* s = base + 4 * i;
  uint32_t px = (uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                ((uint32_t)s[2] << 16) | ((uint32_t)s[3] << 24);
  uint32_t o = blend_px(px, grid[i], fill_word(fills, b));
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

// K8a: packed u8[B, nbytes] -> u8[B, H, W] 0/1.
int mask_rasterize_launch(const uint8_t* packed, int B, long long nbytes,
                          int W, int H, int fh, int fv, uint8_t* out,
                          void* stream) {
  long long n = (long long)H * W;
  if (B <= 0 || n <= 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 16 == 0 && aligned(out, 16)) {
    long long vecs = n / 16;
    dim3 grid((unsigned)((vecs + threads - 1) / threads), (unsigned)B);
    mask_rasterize_kernel_vec<<<grid, threads, 0, s>>>(packed, nbytes, W, H,
                                                       fh, fv, out, vecs);
  } else {
    dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)B);
    mask_rasterize_kernel<<<grid, threads, 0, s>>>(packed, nbytes, W, H, fh,
                                                   fv, out);
  }
  return (int)cudaGetLastError();
}

// K8b: base u8[B, H, W, 4], grid u8[B, H, W], fills u8[B, 4] -> out.
int mask_overlay_launch(const uint8_t* base, const uint8_t* grid,
                        const uint8_t* fills, int B, long long px,
                        uint8_t* out, void* stream) {
  if (B <= 0 || px <= 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (px % 4 == 0 && aligned(base, 16) && aligned(out, 16) &&
      aligned(grid, 4)) {
    long long quads = px / 4;
    dim3 g((unsigned)((quads + threads - 1) / threads), (unsigned)B);
    mask_overlay_kernel_vec<<<g, threads, 0, s>>>(base, grid, fills, out,
                                                  quads);
  } else {
    dim3 g((unsigned)((px + threads - 1) / threads), (unsigned)B);
    mask_overlay_kernel<<<g, threads, 0, s>>>(base, grid, fills, out, px);
  }
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
