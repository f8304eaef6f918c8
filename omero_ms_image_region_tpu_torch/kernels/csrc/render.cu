// Tile render kernels for Hopper (sm_90a): raw channel planes -> packed RGBA.
//
// Two kernels, the counterparts of the two Pallas TPU kernels in
// omero_ms_image_region_tpu/experimental/pallas_render.py:
//
//   render_ramp_kernel  replaces _render_kernel_ramp (pallas_call at :226).
//       Per channel: window clamp, family curve, round half to even into
//       [cd_start, cd_end], optional reverse, clip 0..255; then a
//       multiply-accumulate with f32[C, 3] ramp weights in channel order;
//       round, clip and pack R | G<<8 | B<<16 | 0xFF<<24.
//   render_lut_kernel   replaces _render_kernel_lut (pallas_call at :256).
//       The same quantize; the composite is a lookup in the tile's
//       f32[C, 256, 3] table (the TPU kernel's one-hot MXU product), staged
//       in shared memory, summed in channel order.
//
// Both take per-tile settings [B, C] (the XLA batched render's contract),
// raw [B, C, H, W] in uint8 / uint16 / float32 read in its storage type and
// widened in registers, and write int32 [B, H, W] (u32 bits).
//
// Bound: memory.  Each raw byte is read once and each output word written
// once: at B=1, C=4, 1024^2 u16 that is 8 MiB in and 4 MiB out (~12.6 MB,
// ~3.8 us at 3.35 TB/s).  The arithmetic is ~20 f32 operations per
// pixel-channel (more for the curved families' powf/logf/expf), below the
// card's f32 rate per byte moved, but not by much once an IEEE division
// (__fdiv_rn, a reciprocal and a refinement sequence) is among them: the
// division is the kernel's largest cost.  Each channel therefore carries
// RN(1 / den), and a / den is rounded correctly from it with a multiply and
// two fused multiply-adds (divide() below).
//
// render_ramp_kernel is built to keep enough bytes in flight.  Each thread
// owns 8 contiguous pixels: one 16-byte load per channel for uint16 (8 B
// for uint8, two 16-byte loads for float32), the loads of a chunk of
// channels (all of them up to 8) issued before any math, and two 16-byte
// stores of packed output.  The blocks are persistent (a few per SM) and
// walk the B * ceil(hw / 8) pixel groups of the whole batch grid-stride;
// each block computes the B * C channel constants (window bounds, F(ws),
// F(we), the selected denominator, the degenerate flag, the ramp weights)
// once into shared memory.  A group at a ragged tile end (hw % 8 != 0), or
// any group when a base is not 16-byte aligned, takes the scalar path: the
// same arithmetic, one pixel load at a time.  The family branch is uniform
// per channel, so only the selected curve is evaluated.
//
// render_lut_kernel moves pixels the same way, but its persistent blocks
// stay inside one tile: each of the B tiles gets an equal share of the
// resident blocks, and a block owns a contiguous run of its tile's pixel
// groups.  So a block stages its tile's channel constants and tables once
// (a few hundred 12 KB stagings at B=8), each table entry as a float4
// (r, g, b, 0) so that a lookup is one 16-byte shared load.  Tables of more
// channels than shared memory holds are staged and consumed in chunks of
// channels; the sum stays in channel order.
//
// Numerics follow the JAX reference exactly where IEEE allows: rintf (half
// to even, as jnp.round), explicit __fmul_rn/__fadd_rn and a correctly
// rounded division so no multiply-add is contracted into an FMA (also
// built with -fmad=false; the fused operations of divide() are exact by
// construction), and the composite summed in channel order.  powf, logf
// and expf may differ from XLA's by an ulp, which can move a curved-family
// value by 1.  The per-channel constants, the quantize and the loads live
// in quantize.cuh, shared with the mesh kernels (mesh.cu), and so do the
// LUT kernel's table staging and lookups and its split of the blocks over
// the tiles, which K12a's LUT mode reuses.

#include <cuda_runtime.h>
#include <stdint.h>
#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ void store_group(int32_t* dst,
                                            const float acc[kGroup][3]) {
  int4 lo, hi;
  lo.x = pack(acc[0][0], acc[0][1], acc[0][2]);
  lo.y = pack(acc[1][0], acc[1][1], acc[1][2]);
  lo.z = pack(acc[2][0], acc[2][1], acc[2][2]);
  lo.w = pack(acc[3][0], acc[3][1], acc[3][2]);
  hi.x = pack(acc[4][0], acc[4][1], acc[4][2]);
  hi.y = pack(acc[5][0], acc[5][1], acc[5][2]);
  hi.z = pack(acc[6][0], acc[6][1], acc[6][2]);
  hi.w = pack(acc[7][0], acc[7][1], acc[7][2]);
  reinterpret_cast<int4*>(dst)[0] = lo;
  reinterpret_cast<int4*>(dst)[1] = hi;
}

// Ramp composite.  Dynamic shared memory: ChanParams[B * C].  `vec` is 1
// when every pixel group of a full tile is 16-byte aligned (hw % 8 == 0 and
// aligned bases); the host computes it from the pointers.
template <typename T>
__global__ void __launch_bounds__(kThreads)
render_ramp_kernel(const T* __restrict__ raw, const float* __restrict__ ws,
                   const float* __restrict__ we,
                   const float* __restrict__ coef,
                   const int32_t* __restrict__ fam,
                   const int32_t* __restrict__ rev,
                   const float* __restrict__ weights,
                   int32_t* __restrict__ out, int B, int C, long long hw,
                   int cd_start, int cd_end, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChanParams* params = reinterpret_cast<ChanParams*>(smem);
  for (int i = threadIdx.x; i < B * C; i += blockDim.x)
    load_params(params + i, i, ws, we, coef, fam, rev, weights);
  __syncthreads();

  const float cd_start_f = static_cast<float>(cd_start);
  const float k_max = static_cast<float>(cd_end - cd_start);
  const float cd_sum = static_cast<float>(cd_start + cd_end);
  constexpr int kChunk = Pack8<T>::kChunk;
  const long long groups = (hw + kGroup - 1) / kGroup;   // per tile
  const long long all = groups * B;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < all; g += stride) {
    const int b = static_cast<int>(g / groups);
    const long long px0 = (g - static_cast<long long>(b) * groups) * kGroup;
    const T* tile = raw + static_cast<long long>(b) * C * hw;
    const ChanParams* tp = params + b * C;
    int32_t* dst = out + static_cast<long long>(b) * hw + px0;
    float acc[kGroup][3];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.f;

    if (vec) {
      for (int c0 = 0; c0 < C; c0 += kChunk) {
        Pack8<T> v[kChunk];
        load_chunk(v, tile, hw, px0, c0, C);
        accumulate_chunk(acc, v, tp, c0, C, cd_start_f, k_max, cd_sum);
      }
      store_group(dst, acc);
    } else {
      const int n = static_cast<int>(
          hw - px0 < kGroup ? hw - px0 : static_cast<long long>(kGroup));
      for (int c = 0; c < C; ++c) {
        const ChanParams& p = tp[c];
        const T* plane = tile + static_cast<long long>(c) * hw + px0;
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (j < n)
            accumulate(acc[j],
                       quantize(p, load_raw(plane + j), cd_start_f, k_max,
                                cd_sum),
                       p);
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (j < n) dst[j] = pack(acc[j][0], acc[j][1], acc[j][2]);
    }
  }
}

// LUT composite.  Block x works in tile x / blocks_per_tile, on the pixel
// groups [part * run, (part + 1) * run) of it (run a multiple of kThreads).
// Dynamic shared memory: ChanParams[C], then float4 tables of `tchunk`
// channels (all C unless they do not fit).  `vec` as for the ramp kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
render_lut_kernel(const T* __restrict__ raw, const float* __restrict__ ws,
                  const float* __restrict__ we,
                  const float* __restrict__ coef,
                  const int32_t* __restrict__ fam,
                  const int32_t* __restrict__ rev,
                  const float* __restrict__ tables,
                  int32_t* __restrict__ out, int C, long long hw,
                  int cd_start, int cd_end, int vec, int blocks_per_tile,
                  long long run, int tchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChanParams* params = reinterpret_cast<ChanParams*>(smem);
  float4* luts = reinterpret_cast<float4*>(params + C);
  const int b = blockIdx.x / blocks_per_tile;
  const long long groups = (hw + kGroup - 1) / kGroup;
  const long long g0 = (blockIdx.x - static_cast<long long>(b) *
                                         blocks_per_tile) * run;
  const long long g1 = g0 + run < groups ? g0 + run : groups;
  const float* src = tables + static_cast<long long>(b) * C * kTableFloats;
  const bool staged_once = tchunk >= C;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    load_params(params + c, b * C + c, ws, we, coef, fam, rev, nullptr);
  if (staged_once) stage_tables(luts, src, 0, C);
  __syncthreads();

  const float cd_start_f = static_cast<float>(cd_start);
  const float k_max = static_cast<float>(cd_end - cd_start);
  const float cd_sum = static_cast<float>(cd_start + cd_end);
  constexpr int kChunk = Pack8<T>::kChunk;
  const T* tile = raw + static_cast<long long>(b) * C * hw;
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

    for (int cs = 0; cs < C; cs += tchunk) {
      const int ce = cs + tchunk < C ? cs + tchunk : C;
      if (!staged_once) {
        __syncthreads();
        stage_tables(luts, src, cs, ce);
        __syncthreads();
      }
      if (!active) continue;
      if (vec) {
        for (int c0 = cs; c0 < ce; c0 += kChunk) {
          Pack8<T> v[kChunk];
          load_chunk(v, tile, hw, px0, c0, ce);
          lookup_chunk(acc, v, params, luts + (c0 - cs) * 256, c0, ce,
                       cd_start_f, k_max, cd_sum);
        }
      } else {
        for (int c = cs; c < ce; ++c) {
          const ChanParams& p = params[c];
          const T* plane = tile + static_cast<long long>(c) * hw + px0;
          const float4* lut = luts + (c - cs) * 256;
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (j < n)
              add_rgb(acc[j], lut[static_cast<int>(quantize(
                                  p, load_raw(plane + j), cd_start_f, k_max,
                                  cd_sum))]);
        }
      }
    }
    if (!active) continue;
    int32_t* dst = out + static_cast<long long>(b) * hw + px0;
    if (vec) {
      store_group(dst, acc);
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (j < n) dst[j] = pack(acc[j][0], acc[j][1], acc[j][2]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
cudaError_t launch_ramp(const void* raw, const float* ws, const float* we,
                        const float* coef, const int32_t* fam,
                        const int32_t* rev, const float* weights,
                        int32_t* out, int B, int C, long long hw,
                        int cd_start, int cd_end, cudaStream_t stream) {
  const size_t smem = sizeof(ChanParams) * B * C;
  cudaError_t err = allow_smem(render_ramp_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, render_ramp_kernel<T>, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long all = (hw + kGroup - 1) / kGroup * B;
  const long long need = (all + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned blocks =
      static_cast<unsigned>(need < resident ? need : resident);
  const uintptr_t align = reinterpret_cast<uintptr_t>(raw) |
                          reinterpret_cast<uintptr_t>(out);
  const int vec = hw % kGroup == 0 && align % 16 == 0;
  render_ramp_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(raw), ws, we, coef, fam, rev, weights, out, B, C,
      hw, cd_start, cd_end, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lut(const void* raw, const float* ws, const float* we,
                       const float* coef, const int32_t* fam,
                       const int32_t* rev, const float* tables,
                       int32_t* out, int B, int C, long long hw,
                       int cd_start, int cd_end, cudaStream_t stream) {
  const int tchunk = lut_table_chunk(C);
  if (tchunk < 1) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(ChanParams) * C + static_cast<size_t>(kLutBytes) * tchunk;
  cudaError_t err = allow_smem(render_lut_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, render_lut_kernel<T>, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long run = 0, blocks_per_tile = 0;
  split_tiles(hw, B, static_cast<long long>(sms) * per_sm, kThreads, &run,
              &blocks_per_tile);
  const long long blocks = blocks_per_tile * B;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  const uintptr_t align = reinterpret_cast<uintptr_t>(raw) |
                          reinterpret_cast<uintptr_t>(out);
  const int vec = hw % kGroup == 0 && align % 16 == 0;
  render_lut_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(
      static_cast<const T*>(raw), ws, we, coef, fam, rev, tables, out, C,
      hw, cd_start, cd_end, vec, static_cast<int>(blocks_per_tile), run,
      tchunk);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = uint8, 1 = uint16,
// 2 = float32.  Returns cudaGetLastError() after the launch (0 = launched).

extern "C" int render_ramp_launch(const void* raw, int dtype, const void* ws,
                                  const void* we, const void* coef,
                                  const void* fam, const void* rev,
                                  const void* weights, void* out, int B,
                                  int C, long long hw, int cd_start,
                                  int cd_end, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f_ws = static_cast<const float*>(ws);
  const auto* f_we = static_cast<const float*>(we);
  const auto* f_coef = static_cast<const float*>(coef);
  const auto* i_fam = static_cast<const int32_t*>(fam);
  const auto* i_rev = static_cast<const int32_t*>(rev);
  const auto* f_w = static_cast<const float*>(weights);
  auto* i_out = static_cast<int32_t*>(out);
  switch (dtype) {
    case 0:
      return launch_ramp<uint8_t>(raw, f_ws, f_we, f_coef, i_fam, i_rev, f_w,
                                  i_out, B, C, hw, cd_start, cd_end, s);
    case 1:
      return launch_ramp<uint16_t>(raw, f_ws, f_we, f_coef, i_fam, i_rev,
                                   f_w, i_out, B, C, hw, cd_start, cd_end, s);
    case 2:
      return launch_ramp<float>(raw, f_ws, f_we, f_coef, i_fam, i_rev, f_w,
                                i_out, B, C, hw, cd_start, cd_end, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int render_lut_launch(const void* raw, int dtype, const void* ws,
                                 const void* we, const void* coef,
                                 const void* fam, const void* rev,
                                 const void* tables, void* out, int B, int C,
                                 long long hw, int cd_start, int cd_end,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f_ws = static_cast<const float*>(ws);
  const auto* f_we = static_cast<const float*>(we);
  const auto* f_coef = static_cast<const float*>(coef);
  const auto* i_fam = static_cast<const int32_t*>(fam);
  const auto* i_rev = static_cast<const int32_t*>(rev);
  const auto* f_t = static_cast<const float*>(tables);
  auto* i_out = static_cast<int32_t*>(out);
  switch (dtype) {
    case 0:
      return launch_lut<uint8_t>(raw, f_ws, f_we, f_coef, i_fam, i_rev, f_t,
                                 i_out, B, C, hw, cd_start, cd_end, s);
    case 1:
      return launch_lut<uint16_t>(raw, f_ws, f_we, f_coef, i_fam, i_rev, f_t,
                                  i_out, B, C, hw, cd_start, cd_end, s);
    case 2:
      return launch_lut<float>(raw, f_ws, f_we, f_coef, i_fam, i_rev, f_t,
                               i_out, B, C, hw, cd_start, cd_end, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Largest channel count each kernel's shared memory holds on this card's
// 227 KB per block (checked by the Python wrappers before a launch): for
// the ramp kernel the count of B * C settings; for the LUT kernel the C
// channel constants of one tile beside one channel's table (its tables are
// staged in chunks of channels).
extern "C" int render_max_channels(int lut) {
  return static_cast<int>((kMaxSmem - (lut ? kLutBytes : 0)) /
                          sizeof(ChanParams));
}
