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
//       order a multiply-accumulate with the ramp weights f32[B, C, 3] or a
//       lookup in the tables f32[B, C, 256, 3], each product and sum
//       rounded on its own (__fmul_rn / __fadd_rn, built with
//       -fmad=false).  Writes the partial sums f32[3, B, H, W], component
//       first as in JAX, so a shard's partial is one contiguous buffer for
//       the chan all-gather.
//   composite_pack_kernel (K12b).  Reads the all-gathered partials
//       f32[S, 3, B, H, W] of the S chan shards, sums them in shard order
//       (s = 0, 1, ..., each add rounded), rounds half to even, clips to
//       0..255 and packs R | G<<8 | B<<16 | 0xFF<<24 into i32[B, H, W]: the
//       psum over chan and the pack of _composite_step(_batched).  With
//       S = 1 it is round, clip and pack.
//
// Why an all-gather and an ordered sum, not an all-reduce: NCCL's ring sums
// in an order of its own from 3 ranks on, which can move a value at a .5
// boundary by 1 between world sizes; the ordered sum is the same on every
// rank and at every world size.  At chan = 2 the link bytes are the same.
//
// Bound: memory.  K12a reads each raw byte of its channels once and writes
// 12 bytes a pixel (B=8, C=4, 1024^2 u16: 67.1 MB in, 100.7 MB out, ~0.050
// ms at 3.35 TB/s); K12b reads 12 S bytes and writes 4 bytes a pixel
// (S = 1: 100.7 MB in, 33.6 MB out, ~0.040 ms).  The arithmetic per
// pixel-channel is K1's (~20 f32 operations, more for the curved families).
// The design is K1's ramp kernel with another epilogue: each thread owns 8
// contiguous pixels of one tile, loads them with one vector load per
// channel (16 B for uint16), and stores each component as two 16-byte
// stores; persistent blocks walk the B * ceil(hw / 8) groups grid-stride
// with the B * (c1 - c0) channel constants in shared memory.  A LUT
// channel's table is read through the read-only cache (__ldg), not staged:
// a simple, correct kernel first.  K12b gives each thread 4 pixels (16-byte
// loads of each shard's component planes, one 16-byte store).  A ragged
// tile (hw % 8 != 0, for K12b n % 4 != 0) or an unaligned base takes the
// scalar path, with the same arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPackGroup = 4;           // pixels per thread in K12b
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;    // dynamic shared memory per block

// One channel's table entry for a quantized value q (0..255), added to acc
// in channel order.
__device__ __forceinline__ void add_entry(float acc[3], const float* table,
                                          float q) {
  const float* e = table + 3 * static_cast<int>(q);
  acc[0] = __fadd_rn(acc[0], __ldg(e));
  acc[1] = __fadd_rn(acc[1], __ldg(e + 1));
  acc[2] = __fadd_rn(acc[2], __ldg(e + 2));
}

template <int FAM, typename T>
__device__ __forceinline__ void lookup8(float acc[kGroup][3],
                                        const Pack8<T>& v,
                                        const ChanParams& p,
                                        const float* table, float cd_start,
                                        float k_max, float cd_sum) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    add_entry(acc[j], table,
              quantize_fam<FAM>(p, v.get(j), cd_start, k_max, cd_sum));
}

// The channels k0 .. min(k0 + kChunk, cl) - 1 of the slice, whose tables
// start at `tables` (channel k0's).
template <typename T>
__device__ __forceinline__ void lookup_chunk(float acc[kGroup][3],
                                             const Pack8<T>* v,
                                             const ChanParams* tp,
                                             const float* tables, int k0,
                                             int cl, float cd_start,
                                             float k_max, float cd_sum) {
#pragma unroll
  for (int k = 0; k < Pack8<T>::kChunk; ++k) {
    if (k0 + k < cl) {
      const ChanParams p = tp[k0 + k];
      with_family(p.fam, [&](auto fam) {
        lookup8<decltype(fam)::value>(acc, v[k], p, tables + k * 256 * 3,
                                      cd_start, k_max, cd_sum);
      });
    }
  }
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// K12a.  Dynamic shared memory: ChanParams[B * cl], entry b * cl + k for
// channel c0 + k of tile b.  `vec` is 1 when every group of a full tile is
// 16-byte aligned (hw % 8 == 0 and aligned bases).  LUT: `tables` is
// f32[B, C, 256, 3], else the ramp weights f32[B, C, 3].
template <typename T, bool LUT>
__global__ void __launch_bounds__(kThreads)
composite_partial_kernel(const T* __restrict__ raw,
                         const float* __restrict__ ws,
                         const float* __restrict__ we,
                         const float* __restrict__ coef,
                         const int32_t* __restrict__ fam,
                         const int32_t* __restrict__ rev,
                         const float* __restrict__ tables,
                         float* __restrict__ out, int B, int C, int c0,
                         int cl, long long hw, int cd_start, int cd_end,
                         int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChanParams* params = reinterpret_cast<ChanParams*>(smem);
  for (int i = threadIdx.x; i < B * cl; i += blockDim.x) {
    const int b = i / cl;
    load_params(params + i, b * C + c0 + (i - b * cl), ws, we, coef, fam,
                rev, LUT ? nullptr : tables);
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
    // Channel c0 of tile b, and its table.
    const T* slice = raw + (static_cast<long long>(b) * C + c0) * hw;
    const float* tb =
        LUT ? tables + (static_cast<long long>(b) * C + c0) * 256 * 3
            : nullptr;
    const ChanParams* tp = params + b * cl;
    float acc[kGroup][3];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.f;
    float* dst = out + static_cast<long long>(b) * hw + px0;

    if (vec) {
      for (int k0 = 0; k0 < cl; k0 += kChunk) {
        Pack8<T> v[kChunk];
        load_chunk(v, slice, hw, px0, k0, cl);
        if constexpr (LUT)
          lookup_chunk(acc, v, tp, tb + k0 * 256 * 3, k0, cl, cd_start_f,
                       k_max, cd_sum);
        else
          accumulate_chunk(acc, v, tp, k0, cl, cd_start_f, k_max, cd_sum);
      }
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        float v8[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) v8[j] = acc[j][comp];
        store8(dst + comp * plane, v8);
      }
    } else {
      const int n = static_cast<int>(
          hw - px0 < kGroup ? hw - px0 : static_cast<long long>(kGroup));
      for (int k = 0; k < cl; ++k) {
        const ChanParams& p = tp[k];
        const T* src = slice + static_cast<long long>(k) * hw + px0;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (j < n) {
            const float q =
                quantize(p, load_raw(src + j), cd_start_f, k_max, cd_sum);
            if constexpr (LUT)
              add_entry(acc[j], tb + k * 256 * 3, q);
            else
              accumulate(acc[j], q, p);
          }
        }
      }
#pragma unroll
      for (int comp = 0; comp < 3; ++comp)
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (j < n) dst[comp * plane + j] = acc[j][comp];
    }
  }
}

// K12b over n = B * H * W pixels of S shards' partials [S, 3, n].
__global__ void __launch_bounds__(kThreads)
composite_pack_kernel(const float* __restrict__ partials,
                      int32_t* __restrict__ out, int S, long long n,
                      int vec) {
  const long long groups = (n + kPackGroup - 1) / kPackGroup;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const long long i0 = g * kPackGroup;
    float rgb[3][kPackGroup];
    if (vec) {
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        const float4 a = __ldg(
            reinterpret_cast<const float4*>(partials + comp * n + i0));
        rgb[comp][0] = a.x;
        rgb[comp][1] = a.y;
        rgb[comp][2] = a.z;
        rgb[comp][3] = a.w;
      }
      for (int s = 1; s < S; ++s) {
#pragma unroll
        for (int comp = 0; comp < 3; ++comp) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(
              partials + (static_cast<long long>(s) * 3 + comp) * n + i0));
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
      reinterpret_cast<int4*>(out + i0)[0] = o;
    } else {
      const int m = static_cast<int>(
          n - i0 < kPackGroup ? n - i0 : static_cast<long long>(kPackGroup));
      for (int j = 0; j < m; ++j) {
        float r[3];
#pragma unroll
        for (int comp = 0; comp < 3; ++comp)
          r[comp] = __ldg(partials + comp * n + i0 + j);
        for (int s = 1; s < S; ++s)
#pragma unroll
          for (int comp = 0; comp < 3; ++comp)
            r[comp] = __fadd_rn(
                r[comp],
                __ldg(partials + (static_cast<long long>(s) * 3 + comp) * n +
                      i0 + j));
        out[i0 + j] = pack(r[0], r[1], r[2]);
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

template <typename T, bool LUT>
cudaError_t launch_partial(const void* raw, const float* ws, const float* we,
                           const float* coef, const int32_t* fam,
                           const int32_t* rev, const float* tables,
                           float* out, int B, int C, int c0, int cl,
                           long long hw, int cd_start, int cd_end,
                           cudaStream_t stream) {
  const size_t smem = sizeof(ChanParams) * B * cl;
  const long long need =
      ((hw + kGroup - 1) / kGroup * B + kThreads - 1) / kThreads;
  unsigned blocks = 0;
  cudaError_t err = resident_blocks(composite_partial_kernel<T, LUT>, smem,
                                    need, &blocks);
  if (err != cudaSuccess) return err;
  const uintptr_t align = reinterpret_cast<uintptr_t>(raw) |
                          reinterpret_cast<uintptr_t>(out);
  const int vec = hw % kGroup == 0 && align % 16 == 0;
  composite_partial_kernel<T, LUT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(raw), ws, we, coef, fam, rev, tables, out, B, C,
      c0, cl, hw, cd_start, cd_end, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_partial_mode(int lut, const void* raw, const float* ws,
                                const float* we, const float* coef,
                                const int32_t* fam, const int32_t* rev,
                                const float* tables, float* out, int B, int C,
                                int c0, int cl, long long hw, int cd_start,
                                int cd_end, cudaStream_t stream) {
  if (lut)
    return launch_partial<T, true>(raw, ws, we, coef, fam, rev, tables, out,
                                   B, C, c0, cl, hw, cd_start, cd_end,
                                   stream);
  return launch_partial<T, false>(raw, ws, we, coef, fam, rev, tables, out,
                                  B, C, c0, cl, hw, cd_start, cd_end, stream);
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
  const long long need =
      ((n + kPackGroup - 1) / kPackGroup + kThreads - 1) / kThreads;
  unsigned blocks = 0;
  cudaError_t err =
      resident_blocks(composite_pack_kernel, 0, need, &blocks);
  if (err != cudaSuccess) return err;
  const uintptr_t align = reinterpret_cast<uintptr_t>(partials) |
                          reinterpret_cast<uintptr_t>(out);
  const int vec = n % kPackGroup == 0 && align % 16 == 0;
  composite_pack_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<int32_t*>(out), S, n,
      vec);
  return cudaGetLastError();
}

// The most channel settings (B * (c1 - c0)) K12a's shared memory holds on
// this card's 227 KB per block (checked by the Python wrapper first).
extern "C" int mesh_max_settings() {
  return static_cast<int>(kMaxSmem / sizeof(ChanParams));
}
