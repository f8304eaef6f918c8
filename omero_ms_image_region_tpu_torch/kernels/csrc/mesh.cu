// Mesh kernels for Hopper (sm_90a): the channel-sharded composite of a mesh
// serving step, and its ordered pack.
//
// Together they replace the per-shard body of the JAX package's mesh steps
// (omero_ms_image_region_tpu/parallel/mesh.py, XLA programs under shard_map
// with no Pallas kernel of their own): _local_render (:100) and
// _composite_step (:150), jitted by render_step_sharded (:166) and
// render_jpeg_step_sharded (:184), and their per-tile-settings forms
// _local_render_batched (:227) and _composite_step_batched (:271), jitted by
// render_step_sharded_batched (:282) and render_jpeg_step_sharded_batched
// (:308).
//
//   composite_partial_kernel (K12a).  For the channels [c0, c1) of raw
//       [B, C, H, W] (uint8 / uint16 / float32, read in its storage type)
//       with per-tile settings [B, C]: K1's quantize (quantize.cuh: window
//       clamp, family curve, round half to even into [cd_start, cd_end],
//       reverse as cd_start + cd_end - q, clip 0..255), then in channel
//       order a multiply-accumulate with the ramp weights f32[B, C, 3]
//       (composite_partial_kernel) or a lookup in the tables f32[B, C, 256,
//       3] (composite_partial_lut_kernel), each product and sum rounded on
//       its own (__fmul_rn / __fadd_rn, built with -fmad=false).  Writes the
//       partial sums f32[3, B, H, W], component first as in JAX, so a
//       shard's partial is one contiguous buffer for the chan all-gather.
//   composite_pack_kernel (K12b).  Reads the all-gathered partials
//       f32[S, 3, B, H, W] of the S chan shards, sums them in shard order
//       (s = 0, 1, ..., each add rounded), rounds half to even, clips to
//       0..255 and packs R | G<<8 | B<<16 | 0xFF<<24 into i32[B, H, W]: the
//       psum over chan and the pack of _composite_step(_batched).  With
//       S = 1 it is round, clip and pack.
//
// They serve a mesh with chan > 1 only.  At chan = 1 the psum is the
// identity, and the mesh step (parallel/mesh.py) renders with K1 or K2
// (render.cu): the same bytes in one launch, without writing the partial's
// 12 bytes a pixel and reading them back (at B=8, C=4, 1024^2 u16, 100.7 MB
// moved instead of ~302 MB).
//
// Why an all-gather and an ordered sum, not an all-reduce: NCCL's ring sums
// in an order of its own from 3 ranks on, which can move a value at a .5
// boundary by 1 between world sizes; the ordered sum is the same on every
// rank and at every world size.  At chan = 2 the link bytes are the same.
//
// Bound: memory.  K12a reads each raw byte of its channels once and writes
// 12 bytes a pixel (B=8, a chan-2 shard of C=4, 1024^2 u16: 33.6 MB in,
// 100.7 MB out, ~0.040 ms at 3.35 TB/s); K12b reads 12 S bytes and writes 4
// bytes a pixel (S = 2: 201.3 MB in, 33.6 MB out, ~0.070 ms).  The
// arithmetic per pixel-channel is K1's (~20 f32 operations, more for the
// curved families).  The ramp kernel is K1's ramp kernel with another
// epilogue: each thread owns 8 contiguous pixels of one tile, loads them
// with one vector load per channel (16 B for uint16), and stores each
// component as two 16-byte stores; persistent blocks walk the B * ceil(hw
// / 8) groups grid-stride with the B * (c1 - c0) channel constants in
// shared memory.  The LUT kernel is K2's design (render.cu): persistent
// blocks that stay inside one tile, so that a block stages its tile's
// (c1 - c0) tables once in shared memory, each entry a float4 (r, g, b, 0)
// so that a lookup is one 16-byte shared load; tables beyond 227 KB are
// staged and consumed in chunks of channels, the sum kept in channel order.
// K12b gives each thread 4 pixels (16-byte loads of each shard's component
// planes, one 16-byte store), all evict-first (each byte is used once: at
// B=1 that took 5-9 % off, at B=8 nothing); the shards are summed in a
// runtime loop, in shard order (a shard count fixed at compile time, so
// that every load is issued before the first add, was tried and changed
// nothing).  On an NVIDIA H100 80GB HBM3 at 700 W and B=8, K12b runs at
// 1.05x a device copy of its bytes, K12a at 1.1x with ramp weights and
// 1.2x with tables (scripts/k12_redesign.py).  A ragged tile (hw % 8 != 0,
// for K12b n % 4 != 0) or an unaligned base takes the scalar path, with
// the same arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPackGroup = 4;           // pixels per thread in K12b
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ void store8(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The partial of eight pixels at dst (component planes `plane` apart): two
// 16-byte stores a component, or the first n scalars.
__device__ __forceinline__ void store_partial(float* dst, long long plane,
                                              const float acc[kGroup][3],
                                              bool vec, int n) {
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    if (vec) {
      float v8[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) v8[j] = acc[j][comp];
      store8(dst + comp * plane, v8);
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (j < n) dst[comp * plane + j] = acc[j][comp];
    }
  }
}

// K12a, ramp weights.  Dynamic shared memory: ChanParams[B * cl], entry
// b * cl + k for channel c0 + k of tile b.  `vec` is 1 when every group of
// a full tile is 16-byte aligned (hw % 8 == 0 and aligned bases).
template <typename T>
__global__ void __launch_bounds__(kThreads)
composite_partial_kernel(const T* __restrict__ raw,
                         const float* __restrict__ ws,
                         const float* __restrict__ we,
                         const float* __restrict__ coef,
                         const int32_t* __restrict__ fam,
                         const int32_t* __restrict__ rev,
                         const float* __restrict__ weights,
                         float* __restrict__ out, int B, int C, int c0,
                         int cl, long long hw, int cd_start, int cd_end,
                         int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChanParams* params = reinterpret_cast<ChanParams*>(smem);
  for (int i = threadIdx.x; i < B * cl; i += blockDim.x) {
    const int b = i / cl;
    load_params(params + i, b * C + c0 + (i - b * cl), ws, we, coef, fam,
                rev, weights);
  }
  __syncthreads();

  const float cd_start_f = static_cast<float>(cd_start);
  const float k_max = static_cast<float>(cd_end - cd_start);
  const float cd_sum = static_cast<float>(cd_start + cd_end);
  constexpr int kChunk = Pack8<T>::kChunk;
  const long long groups = (hw + kGroup - 1) / kGroup;   // per tile
  const long long all = groups * B;
  const long long plane = static_cast<long long>(B) * hw;  // one component
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < all; g += stride) {
    const int b = static_cast<int>(g / groups);
    const long long px0 = (g - static_cast<long long>(b) * groups) * kGroup;
    // Channel c0 of tile b.
    const T* slice = raw + (static_cast<long long>(b) * C + c0) * hw;
    const ChanParams* tp = params + b * cl;
    float acc[kGroup][3];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.f;
    const int n = static_cast<int>(
        hw - px0 < kGroup ? hw - px0 : static_cast<long long>(kGroup));

    if (vec) {
      for (int k0 = 0; k0 < cl; k0 += kChunk) {
        Pack8<T> v[kChunk];
        load_chunk(v, slice, hw, px0, k0, cl);
        accumulate_chunk(acc, v, tp, k0, cl, cd_start_f, k_max, cd_sum);
      }
    } else {
      for (int k = 0; k < cl; ++k) {
        const ChanParams& p = tp[k];
        const T* src = slice + static_cast<long long>(k) * hw + px0;
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (j < n)
            accumulate(acc[j],
                       quantize(p, load_raw(src + j), cd_start_f, k_max,
                                cd_sum),
                       p);
      }
    }
    store_partial(out + static_cast<long long>(b) * hw + px0, plane, acc,
                  vec, n);
  }
}

// K12a, tables.  Block x works in tile x / blocks_per_tile, on the pixel
// groups [part * run, (part + 1) * run) of it (run a multiple of kThreads).
// Dynamic shared memory: ChanParams[cl] for the channels c0 .. c1 - 1 of
// the tile, then their float4 tables, `tchunk` channels at a time (all cl
// unless they do not fit).  `vec` as for the ramp kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
composite_partial_lut_kernel(const T* __restrict__ raw,
                             const float* __restrict__ ws,
                             const float* __restrict__ we,
                             const float* __restrict__ coef,
                             const int32_t* __restrict__ fam,
                             const int32_t* __restrict__ rev,
                             const float* __restrict__ tables,
                             float* __restrict__ out, int B, int C, int c0,
                             int cl, long long hw, int cd_start, int cd_end,
                             int vec, int blocks_per_tile, long long run,
                             int tchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChanParams* params = reinterpret_cast<ChanParams*>(smem);
  float4* luts = reinterpret_cast<float4*>(params + cl);
  const int b = blockIdx.x / blocks_per_tile;
  const long long groups = (hw + kGroup - 1) / kGroup;
  const long long g0 = (blockIdx.x - static_cast<long long>(b) *
                                         blocks_per_tile) * run;
  const long long g1 = g0 + run < groups ? g0 + run : groups;
  const long long first = static_cast<long long>(b) * C + c0;
  const float* src = tables + first * kTableFloats;
  const bool staged_once = tchunk >= cl;
  for (int k = threadIdx.x; k < cl; k += blockDim.x)
    load_params(params + k, static_cast<int>(first) + k, ws, we, coef, fam,
                rev, nullptr);
  if (staged_once) stage_tables(luts, src, 0, cl);
  __syncthreads();

  const float cd_start_f = static_cast<float>(cd_start);
  const float k_max = static_cast<float>(cd_end - cd_start);
  const float cd_sum = static_cast<float>(cd_start + cd_end);
  constexpr int kChunk = Pack8<T>::kChunk;
  const long long plane = static_cast<long long>(B) * hw;  // one component
  const T* slice = raw + first * hw;
  // The loop bounds are uniform over the block: the chunked path's
  // __syncthreads() is reached by every thread.
  for (long long base = g0; base < g1; base += kThreads) {
    const long long g = base + threadIdx.x;
    const bool active = g < g1;
    const long long px0 = g * kGroup;
    float acc[kGroup][3];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.f;
    const int n = static_cast<int>(
        hw - px0 < kGroup ? hw - px0 : static_cast<long long>(kGroup));

    for (int cs = 0; cs < cl; cs += tchunk) {
      const int ce = cs + tchunk < cl ? cs + tchunk : cl;
      if (!staged_once) {
        __syncthreads();
        stage_tables(luts, src, cs, ce);
        __syncthreads();
      }
      if (!active) continue;
      if (vec) {
        for (int k0 = cs; k0 < ce; k0 += kChunk) {
          Pack8<T> v[kChunk];
          load_chunk(v, slice, hw, px0, k0, ce);
          lookup_chunk(acc, v, params, luts + (k0 - cs) * 256, k0, ce,
                       cd_start_f, k_max, cd_sum);
        }
      } else {
        for (int k = cs; k < ce; ++k) {
          const ChanParams& p = params[k];
          const T* plane_k = slice + static_cast<long long>(k) * hw + px0;
          const float4* lut = luts + (k - cs) * 256;
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (j < n)
              add_rgb(acc[j], lut[static_cast<int>(quantize(
                                  p, load_raw(plane_k + j), cd_start_f,
                                  k_max, cd_sum))]);
        }
      }
    }
    if (!active) continue;
    store_partial(out + static_cast<long long>(b) * hw + px0, plane, acc,
                  vec, n);
  }
}

// K12b over n = B * H * W pixels of the shards' partials [shards, 3, n].
// The partials are read once and the packed words written once: evict
// first (__ldcs / __stcs), so that neither stream displaces what the next
// launch reads.
__global__ void __launch_bounds__(kThreads)
composite_pack_kernel(const float* __restrict__ partials,
                      int32_t* __restrict__ out, int shards, long long n,
                      int vec) {
  const long long groups = (n + kPackGroup - 1) / kPackGroup;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const long long i0 = g * kPackGroup;
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(partials + i0);
      const long long step = n / kPackGroup;   // one component plane
      float rgb[3][kPackGroup];
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        const float4 a = __ldcs(src + comp * step);
        rgb[comp][0] = a.x;
        rgb[comp][1] = a.y;
        rgb[comp][2] = a.z;
        rgb[comp][3] = a.w;
      }
      for (int s = 1; s < shards; ++s) {
#pragma unroll
        for (int comp = 0; comp < 3; ++comp) {
          const float4 a =
              __ldcs(src + (static_cast<long long>(s) * 3 + comp) * step);
          rgb[comp][0] = __fadd_rn(rgb[comp][0], a.x);
          rgb[comp][1] = __fadd_rn(rgb[comp][1], a.y);
          rgb[comp][2] = __fadd_rn(rgb[comp][2], a.z);
          rgb[comp][3] = __fadd_rn(rgb[comp][3], a.w);
        }
      }
      int4 o;
      o.x = pack(rgb[0][0], rgb[1][0], rgb[2][0]);
      o.y = pack(rgb[0][1], rgb[1][1], rgb[2][1]);
      o.z = pack(rgb[0][2], rgb[1][2], rgb[2][2]);
      o.w = pack(rgb[0][3], rgb[1][3], rgb[2][3]);
      __stcs(reinterpret_cast<int4*>(out + i0), o);
    } else {
      const int m = static_cast<int>(
          n - i0 < kPackGroup ? n - i0 : static_cast<long long>(kPackGroup));
      for (int j = 0; j < m; ++j) {
        float r[3];
#pragma unroll
        for (int comp = 0; comp < 3; ++comp)
          r[comp] = __ldcs(partials + comp * n + i0 + j);
        for (int s = 1; s < shards; ++s)
#pragma unroll
          for (int comp = 0; comp < 3; ++comp)
            r[comp] = __fadd_rn(
                r[comp], __ldcs(partials +
                                (static_cast<long long>(s) * 3 + comp) * n +
                                i0 + j));
        __stcs(out + i0 + j, pack(r[0], r[1], r[2]));
      }
    }
  }
}

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, long long need,
                            unsigned* blocks) {
  cudaError_t err;
  if (smem > static_cast<size_t>(kDefaultSmem) &&
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<unsigned>(need < resident ? need : resident);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_partial(const void* raw, const float* ws, const float* we,
                           const float* coef, const int32_t* fam,
                           const int32_t* rev, const float* weights,
                           float* out, int B, int C, int c0, int cl,
                           long long hw, int cd_start, int cd_end, int vec,
                           cudaStream_t stream) {
  const size_t smem = sizeof(ChanParams) * B * cl;
  const long long need =
      ((hw + kGroup - 1) / kGroup * B + kThreads - 1) / kThreads;
  unsigned blocks = 0;
  cudaError_t err = resident_blocks(composite_partial_kernel<T>, smem, need,
                                    &blocks);
  if (err != cudaSuccess) return err;
  composite_partial_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(raw), ws, we, coef, fam, rev, weights, out, B, C,
      c0, cl, hw, cd_start, cd_end, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_partial_lut(const void* raw, const float* ws,
                               const float* we, const float* coef,
                               const int32_t* fam, const int32_t* rev,
                               const float* tables, float* out, int B, int C,
                               int c0, int cl, long long hw, int cd_start,
                               int cd_end, int vec, cudaStream_t stream) {
  const int tchunk = lut_table_chunk(cl);
  if (tchunk < 1) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(ChanParams) * cl + static_cast<size_t>(kLutBytes) * tchunk;
  // Every resident block counts: the split below gives each tile its share.
  unsigned resident = 0;
  cudaError_t err = resident_blocks(composite_partial_lut_kernel<T>, smem,
                                    0x7FFFFFFFLL, &resident);
  if (err != cudaSuccess) return err;
  long long run = 0, blocks_per_tile = 0;
  split_tiles(hw, B, resident, kThreads, &run, &blocks_per_tile);
  const long long blocks = blocks_per_tile * B;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  composite_partial_lut_kernel<T><<<static_cast<unsigned>(blocks), kThreads,
                                    smem, stream>>>(
      static_cast<const T*>(raw), ws, we, coef, fam, rev, tables, out, B, C,
      c0, cl, hw, cd_start, cd_end, vec, static_cast<int>(blocks_per_tile),
      run, tchunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_partial_mode(int lut, const void* raw, const float* ws,
                                const float* we, const float* coef,
                                const int32_t* fam, const int32_t* rev,
                                const float* tables, float* out, int B, int C,
                                int c0, int cl, long long hw, int cd_start,
                                int cd_end, cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(raw) |
                          reinterpret_cast<uintptr_t>(out);
  const int vec = hw % kGroup == 0 && align % 16 == 0;
  if (lut)
    return launch_partial_lut<T>(raw, ws, we, coef, fam, rev, tables, out, B,
                                 C, c0, cl, hw, cd_start, cd_end, vec,
                                 stream);
  return launch_partial<T>(raw, ws, we, coef, fam, rev, tables, out, B, C,
                           c0, cl, hw, cd_start, cd_end, vec, stream);
}

cudaError_t launch_pack(const float* partials, int32_t* out, int shards,
                        long long n, cudaStream_t stream) {
  const long long need =
      ((n + kPackGroup - 1) / kPackGroup + kThreads - 1) / kThreads;
  unsigned blocks = 0;
  cudaError_t err = resident_blocks(composite_pack_kernel, 0, need, &blocks);
  if (err != cudaSuccess) return err;
  const uintptr_t align = reinterpret_cast<uintptr_t>(partials) |
                          reinterpret_cast<uintptr_t>(out);
  const int vec = n % kPackGroup == 0 && align % 16 == 0;
  composite_pack_kernel<<<blocks, kThreads, 0, stream>>>(partials, out,
                                                         shards, n, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = uint8, 1 = uint16,
// 2 = float32; lut: 1 for f32[B, C, 256, 3] tables, 0 for f32[B, C, 3]
// ramp weights.  Each returns cudaGetLastError() after its launch (0 =
// launched).

extern "C" int composite_partial_launch(
    const void* raw, int dtype, const void* ws, const void* we,
    const void* coef, const void* fam, const void* rev, const void* tables,
    int lut, void* out, int B, int C, int c0, int c1, long long hw,
    int cd_start, int cd_end, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f_ws = static_cast<const float*>(ws);
  const auto* f_we = static_cast<const float*>(we);
  const auto* f_coef = static_cast<const float*>(coef);
  const auto* i_fam = static_cast<const int32_t*>(fam);
  const auto* i_rev = static_cast<const int32_t*>(rev);
  const auto* f_t = static_cast<const float*>(tables);
  auto* f_out = static_cast<float*>(out);
  const int cl = c1 - c0;
  if (B < 1 || cl < 1 || c0 < 0 || c1 > C) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_partial_mode<uint8_t>(lut, raw, f_ws, f_we, f_coef,
                                          i_fam, i_rev, f_t, f_out, B, C, c0,
                                          cl, hw, cd_start, cd_end, s);
    case 1:
      return launch_partial_mode<uint16_t>(lut, raw, f_ws, f_we, f_coef,
                                           i_fam, i_rev, f_t, f_out, B, C, c0,
                                           cl, hw, cd_start, cd_end, s);
    case 2:
      return launch_partial_mode<float>(lut, raw, f_ws, f_we, f_coef, i_fam,
                                        i_rev, f_t, f_out, B, C, c0, cl, hw,
                                        cd_start, cd_end, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int composite_pack_launch(const void* partials, void* out, int S,
                                     long long n, void* stream) {
  if (S < 1 || n < 1) return cudaErrorInvalidValue;
  return launch_pack(static_cast<const float*>(partials),
                     static_cast<int32_t*>(out), S, n,
                     static_cast<cudaStream_t>(stream));
}

// The most channel settings K12a's shared memory holds on this card's 227
// KB per block (checked by the Python wrapper first): with ramp weights the
// count of B * (c1 - c0) settings; with tables the c1 - c0 channels of one
// tile beside one channel's table (the tables are staged in chunks of
// channels).
extern "C" int mesh_max_settings(int lut) {
  return static_cast<int>((kMaxSmem - (lut ? kLutBytes : 0)) /
                          sizeof(ChanParams));
}
