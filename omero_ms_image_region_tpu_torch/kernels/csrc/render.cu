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
// pixel-channel (more for the curved families' powf/logf/expf), far below
// the card's f32 rate per byte moved.  The design therefore only has to keep
// the loads coalesced and enough of them in flight: a block owns one tile
// (blockIdx.y) and a run of kThreads * PIX pixels; each thread handles PIX
// pixels kThreads apart, so every warp load is contiguous, and the channel
// loop is outside the pixel loop so a thread issues PIX independent loads
// per channel.  The per-channel constants (window bounds, F(ws), F(we), the
// selected denominator, the degenerate flag, ramp weights) are computed once
// per block into shared memory, and the family branch is uniform across the
// block, so only the selected curve is evaluated.  Making these fast
// (16-byte vector loads, fusion with the JPEG front end) is later work.
//
// Numerics follow the JAX reference exactly where IEEE allows: rintf (half
// to even, as jnp.round), explicit __fmul_rn/__fadd_rn/__fdiv_rn so no
// multiply-add is contracted into an FMA (also built with -fmad=false), and
// the composite summed in channel order.  powf/logf/expf may differ from
// XLA's by an ulp, which can move a curved-family value by 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRampPix = 4;    // pixels per thread, ramp kernel
constexpr int kLutPix = 16;    // LUT kernel: more pixels amortize the table
constexpr float kEps = 1e-12f;
constexpr int kTableFloats = 256 * 3;
constexpr int kDefaultSmem = 48 * 1024;

enum Family { kLinear = 0, kPolynomial = 1, kLogarithmic = 2 };

struct __align__(16) ChanParams {
  float we, lo, hi, k;   // window end, ordered window bounds, coefficient
  float fs, fe, den;     // F(ws), F(we), selected denominator (exp: es, pe)
  int fam, rev, deg;     // family id, reverse flag, degenerate window
  float w[3];            // ramp weights (ramp kernel only)
  int pad;
};

__device__ __forceinline__ float signed_pow(float x, float k) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return __fmul_rn(s, powf(fabsf(x), k));
}

__device__ __forceinline__ float safe_log(float x) {
  return logf(fmaxf(x, 1.f));
}

// Per-channel constants of tile b, channel c (ops/quantum.py::_ratio with
// the scalar parts hoisted; a family id outside 0..2 is exponential, as the
// reference's where-chain selects).
__device__ void load_params(ChanParams* params, int b, int c, int C,
                            const float* ws, const float* we,
                            const float* coef, const int32_t* fam,
                            const int32_t* rev, const float* weights) {
  const int i = b * C + c;
  ChanParams p;
  const float s = ws[i], e = we[i], k = coef[i];
  p.we = e;
  p.lo = fminf(s, e);
  p.hi = fmaxf(s, e);
  p.k = k;
  p.fam = fam[i];
  p.rev = rev[i];
  switch (p.fam) {
    case kLinear:
      p.fs = s;
      p.fe = e;
      p.den = __fsub_rn(e, s);
      break;
    case kPolynomial:
      p.fs = signed_pow(s, k);
      p.fe = signed_pow(e, k);
      p.den = __fsub_rn(p.fe, p.fs);
      break;
    case kLogarithmic:
      p.fs = safe_log(s);
      p.fe = safe_log(e);
      p.den = __fsub_rn(p.fe, p.fs);
      break;
    default: {  // exponential, shifted by F(we): every exponent <= 0
      const float ps = signed_pow(s, k);
      p.fe = signed_pow(e, k);
      p.fs = expf(fminf(__fsub_rn(ps, p.fe), 0.f));
      p.den = __fsub_rn(1.f, p.fs);
    }
  }
  p.deg = fabsf(p.den) < kEps;
  if (p.deg) p.den = 1.f;
  if (weights != nullptr) {
    p.w[0] = weights[3 * i];
    p.w[1] = weights[3 * i + 1];
    p.w[2] = weights[3 * i + 2];
  } else {
    p.w[0] = p.w[1] = p.w[2] = 0.f;
  }
  p.pad = 0;
  params[c] = p;
}

// One channel's quantized value, reversed and clipped to 0..255, as f32
// (pallas_render.py::_quantize_channel).
__device__ __forceinline__ float quantize(const ChanParams& p, float x_raw,
                                          float cd_start, float k_max,
                                          float cd_sum) {
  const float x = fminf(fmaxf(x_raw, p.lo), p.hi);
  float r;
  if (p.deg) {
    r = x_raw >= p.we ? 1.f : 0.f;
  } else {
    float fx;
    switch (p.fam) {
      case kLinear:
        fx = x;
        break;
      case kPolynomial:
        fx = signed_pow(x, p.k);
        break;
      case kLogarithmic:
        fx = safe_log(x);
        break;
      default:
        fx = expf(fminf(__fsub_rn(signed_pow(x, p.k), p.fe), 0.f));
    }
    r = __fdiv_rn(__fsub_rn(fx, p.fs), p.den);
  }
  r = fminf(fmaxf(r, 0.f), 1.f);
  float q = rintf(__fadd_rn(cd_start, __fmul_rn(k_max, r)));
  if (p.rev) q = __fsub_rn(cd_sum, q);
  return fminf(fmaxf(q, 0.f), 255.f);
}

__device__ __forceinline__ int32_t to_byte(float v) {
  return static_cast<int32_t>(fminf(fmaxf(rintf(v), 0.f), 255.f));
}

__device__ __forceinline__ int32_t pack(float r, float g, float b) {
  return to_byte(r) | (to_byte(g) << 8) | (to_byte(b) << 16) |
         static_cast<int32_t>(0xFF000000u);
}

template <typename T>
__device__ __forceinline__ float load_raw(const T* p) {
  return static_cast<float>(__ldg(p));
}

// Ramp composite.  Dynamic shared memory: ChanParams[C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
render_ramp_kernel(const T* __restrict__ raw, const float* __restrict__ ws,
                   const float* __restrict__ we,
                   const float* __restrict__ coef,
                   const int32_t* __restrict__ fam,
                   const int32_t* __restrict__ rev,
                   const float* __restrict__ weights,
                   int32_t* __restrict__ out, int C, long long hw,
                   int cd_start, int cd_end) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChanParams* params = reinterpret_cast<ChanParams*>(smem);
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    load_params(params, b, c, C, ws, we, coef, fam, rev, weights);
  __syncthreads();

  const float cd_start_f = static_cast<float>(cd_start);
  const float k_max = static_cast<float>(cd_end - cd_start);
  const float cd_sum = static_cast<float>(cd_start + cd_end);
  const T* tile = raw + static_cast<long long>(b) * C * hw;
  const long long base =
      static_cast<long long>(blockIdx.x) * (kThreads * kRampPix) + threadIdx.x;

  float acc[kRampPix][3];
#pragma unroll
  for (int j = 0; j < kRampPix; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.f;

  for (int c = 0; c < C; ++c) {
    const ChanParams& p = params[c];
    const T* plane = tile + static_cast<long long>(c) * hw;
#pragma unroll
    for (int j = 0; j < kRampPix; ++j) {
      const long long px = base + static_cast<long long>(j) * kThreads;
      if (px < hw) {
        const float q =
            quantize(p, load_raw(plane + px), cd_start_f, k_max, cd_sum);
        acc[j][0] = __fadd_rn(acc[j][0], __fmul_rn(q, p.w[0]));
        acc[j][1] = __fadd_rn(acc[j][1], __fmul_rn(q, p.w[1]));
        acc[j][2] = __fadd_rn(acc[j][2], __fmul_rn(q, p.w[2]));
      }
    }
  }
  int32_t* dst = out + static_cast<long long>(b) * hw;
#pragma unroll
  for (int j = 0; j < kRampPix; ++j) {
    const long long px = base + static_cast<long long>(j) * kThreads;
    if (px < hw) dst[px] = pack(acc[j][0], acc[j][1], acc[j][2]);
  }
}

// LUT composite.  Dynamic shared memory: ChanParams[C], then the tile's
// tables f32[C][256][3].
template <typename T>
__global__ void __launch_bounds__(kThreads)
render_lut_kernel(const T* __restrict__ raw, const float* __restrict__ ws,
                  const float* __restrict__ we,
                  const float* __restrict__ coef,
                  const int32_t* __restrict__ fam,
                  const int32_t* __restrict__ rev,
                  const float* __restrict__ tables,
                  int32_t* __restrict__ out, int C, long long hw,
                  int cd_start, int cd_end) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChanParams* params = reinterpret_cast<ChanParams*>(smem);
  float* table = reinterpret_cast<float*>(params + C);
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    load_params(params, b, c, C, ws, we, coef, fam, rev, nullptr);
  const float* src = tables + static_cast<long long>(b) * C * kTableFloats;
  for (int i = threadIdx.x; i < C * kTableFloats; i += blockDim.x)
    table[i] = src[i];
  __syncthreads();

  const float cd_start_f = static_cast<float>(cd_start);
  const float k_max = static_cast<float>(cd_end - cd_start);
  const float cd_sum = static_cast<float>(cd_start + cd_end);
  const T* tile = raw + static_cast<long long>(b) * C * hw;
  const long long base =
      static_cast<long long>(blockIdx.x) * (kThreads * kLutPix) + threadIdx.x;

  float acc[kLutPix][3];
#pragma unroll
  for (int j = 0; j < kLutPix; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.f;

  for (int c = 0; c < C; ++c) {
    const ChanParams& p = params[c];
    const T* plane = tile + static_cast<long long>(c) * hw;
    const float* lut = table + c * kTableFloats;
#pragma unroll
    for (int j = 0; j < kLutPix; ++j) {
      const long long px = base + static_cast<long long>(j) * kThreads;
      if (px < hw) {
        const int q = static_cast<int>(
            quantize(p, load_raw(plane + px), cd_start_f, k_max, cd_sum));
        const float* rgb = lut + 3 * q;
        acc[j][0] = __fadd_rn(acc[j][0], rgb[0]);
        acc[j][1] = __fadd_rn(acc[j][1], rgb[1]);
        acc[j][2] = __fadd_rn(acc[j][2], rgb[2]);
      }
    }
  }
  int32_t* dst = out + static_cast<long long>(b) * hw;
#pragma unroll
  for (int j = 0; j < kLutPix; ++j) {
    const long long px = base + static_cast<long long>(j) * kThreads;
    if (px < hw) dst[px] = pack(acc[j][0], acc[j][1], acc[j][2]);
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
  const size_t smem = sizeof(ChanParams) * C;
  cudaError_t err = allow_smem(render_ramp_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(
      static_cast<unsigned>((hw + kThreads * kRampPix - 1) /
                            (kThreads * kRampPix)),
      B);
  render_ramp_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(raw), ws, we, coef, fam, rev, weights, out, C,
      hw, cd_start, cd_end);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lut(const void* raw, const float* ws, const float* we,
                       const float* coef, const int32_t* fam,
                       const int32_t* rev, const float* tables,
                       int32_t* out, int B, int C, long long hw,
                       int cd_start, int cd_end, cudaStream_t stream) {
  const size_t smem = (sizeof(ChanParams) + sizeof(float) * kTableFloats) * C;
  cudaError_t err = allow_smem(render_lut_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(
      static_cast<unsigned>((hw + kThreads * kLutPix - 1) /
                            (kThreads * kLutPix)),
      B);
  render_lut_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(raw), ws, we, coef, fam, rev, tables, out, C,
      hw, cd_start, cd_end);
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
// 227 KB per block (checked by the Python wrappers before a launch).
extern "C" int render_max_channels(int lut) {
  const size_t per_channel =
      sizeof(ChanParams) + (lut ? sizeof(float) * kTableFloats : 0);
  return static_cast<int>((227 * 1024) / per_channel);
}
