// Per-channel quantize shared by the render kernels (render.cu) and the mesh
// kernels (mesh.cu): window clamp, family curve, round half to even into
// [cd_start, cd_end], reverse, clip 0..255, and the loads and ramp
// accumulation of eight contiguous pixels; and the LUT composite's tables
// staged in shared memory as float4 entries, their lookups, and the split
// of a launch's blocks over its tiles.  The arithmetic is described in
// render.cu's header; it is the plain version's (ops/quantum.py,
// ops/render.py::quantize_tiles) operation for operation, and both files
// are built with -fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;      // contiguous pixels per thread
constexpr int kTableFloats = 256 * 3;   // one channel's f32[256][3] table
constexpr int kLutBytes = 256 * 16;     // one channel's staged float4 table
constexpr int kMaxSmem = 227 * 1024;    // dynamic shared memory per block
constexpr float kEps = 1e-12f;
// Above this |den| the reciprocal nears the subnormal range; such channels
// divide with __fdiv_rn.
constexpr float kMaxRecipDen = 1e30f;
// Below this |a| (and not 0) a / den may leave the normal range.
constexpr float kMinRecipNum = 1e-30f;

enum Family { kLinear = 0, kPolynomial = 1, kLogarithmic = 2 };

struct __align__(16) ChanParams {
  float we, lo, hi, k;   // window end, ordered window bounds, coefficient
  float fs, fe, den;     // F(ws), F(we), selected denominator (exp: es, pe)
  int fam, rev, deg;     // family id, reverse flag, degenerate window
  float w[3];            // ramp weights (ramp kernel only)
  float inv;             // RN(1 / den), or 0 where |den| is out of range
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
__device__ void load_params(ChanParams* dst, int i, const float* ws,
                            const float* we, const float* coef,
                            const int32_t* fam, const int32_t* rev,
                            const float* weights) {
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
  p.inv = fabsf(p.den) < kMaxRecipDen ? __fdiv_rn(1.f, p.den) : 0.f;
  if (weights != nullptr) {
    p.w[0] = weights[3 * i];
    p.w[1] = weights[3 * i + 1];
    p.w[2] = weights[3 * i + 2];
  } else {
    p.w[0] = p.w[1] = p.w[2] = 0.f;
  }
  *dst = p;
}

// a / den rounded to nearest even, as __fdiv_rn gives it, at the cost of a
// multiply and two fused multiply-adds.  With inv = RN(1 / den), q =
// RN(a * inv) is within an ulp of a / den, and one fused correction with
// the exact residual a - q * den rounds it correctly (Markstein's
// theorem), barring underflow and overflow, which the range guards send
// to __fdiv_rn.
__device__ __forceinline__ float divide(float a, const ChanParams& p) {
  if (p.inv != 0.f && !(a != 0.f && fabsf(a) < kMinRecipNum)) {
    const float q = __fmul_rn(a, p.inv);
    return __fmaf_rn(__fmaf_rn(-q, p.den, a), p.inv, q);
  }
  return __fdiv_rn(a, p.den);
}

// The family curve F(x) of a clamped value (ops/quantum.py::_ratio); a
// family id outside 0..2 is exponential, shifted by F(we).
template <int FAM>
__device__ __forceinline__ float curve(const ChanParams& p, float x) {
  if (FAM == kLinear) return x;
  if (FAM == kPolynomial) return signed_pow(x, p.k);
  if (FAM == kLogarithmic) return safe_log(x);
  return expf(fminf(__fsub_rn(signed_pow(x, p.k), p.fe), 0.f));
}

// One channel's quantized value, reversed and clipped to 0..255, as f32
// (pallas_render.py::_quantize_channel), for a channel of family FAM.
template <int FAM>
__device__ __forceinline__ float quantize_fam(const ChanParams& p,
                                              float x_raw, float cd_start,
                                              float k_max, float cd_sum) {
  float r;
  if (p.deg) {
    r = x_raw >= p.we ? 1.f : 0.f;
  } else {
    const float x = fminf(fmaxf(x_raw, p.lo), p.hi);
    r = divide(__fsub_rn(curve<FAM>(p, x), p.fs), p);
  }
  r = fminf(fmaxf(r, 0.f), 1.f);
  float q = rintf(__fadd_rn(cd_start, __fmul_rn(k_max, r)));
  if (p.rev) q = __fsub_rn(cd_sum, q);
  return fminf(fmaxf(q, 0.f), 255.f);
}

template <int FAM>
struct FamilyTag {
  static constexpr int value = FAM;
};

// f(FamilyTag<family>()) for a family id (one outside 0..2 is
// exponential): the one branch on the family, taken once per channel.
template <typename F>
__device__ __forceinline__ void with_family(int fam, F f) {
  switch (fam) {
    case kLinear:
      f(FamilyTag<kLinear>());
      break;
    case kPolynomial:
      f(FamilyTag<kPolynomial>());
      break;
    case kLogarithmic:
      f(FamilyTag<kLogarithmic>());
      break;
    default:
      f(FamilyTag<3>());
  }
}

__device__ __forceinline__ float quantize(const ChanParams& p, float x_raw,
                                          float cd_start, float k_max,
                                          float cd_sum) {
  float q;
  with_family(p.fam, [&](auto fam) {
    q = quantize_fam<decltype(fam)::value>(p, x_raw, cd_start, k_max, cd_sum);
  });
  return q;
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

// Eight contiguous raw values of one channel, loaded with vector loads.
template <typename T>
struct Pack8;

template <>
struct Pack8<uint16_t> {
  static constexpr int kChunk = 8;   // channels loaded before the math
  uint4 v;
  __device__ __forceinline__ void load(const uint16_t* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float get(int j) const {
    const uint32_t w = (&v.x)[j >> 1];
    return static_cast<float>((j & 1) ? (w >> 16) : (w & 0xFFFFu));
  }
};

template <>
struct Pack8<uint8_t> {
  static constexpr int kChunk = 8;
  uint2 v;
  __device__ __forceinline__ void load(const uint8_t* p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ float get(int j) const {
    const uint32_t w = (&v.x)[j >> 2];
    return static_cast<float>((w >> (8 * (j & 3))) & 0xFFu);
  }
};

template <>
struct Pack8<float> {
  static constexpr int kChunk = 4;
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float get(int j) const {
    return j < 4 ? (&a.x)[j] : (&b.x)[j - 4];
  }
};

__device__ __forceinline__ void accumulate(float acc[3], float q,
                                           const ChanParams& p) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(q, p.w[0]));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(q, p.w[1]));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(q, p.w[2]));
}

// Quantize and accumulate the eight loaded values of one channel; the
// family is uniform per channel, so its branch sits outside the pixels.
template <int FAM, typename T>
__device__ __forceinline__ void accumulate8(float acc[kGroup][3],
                                            const Pack8<T>& v,
                                            const ChanParams& p,
                                            float cd_start, float k_max,
                                            float cd_sum) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    accumulate(acc[j],
               quantize_fam<FAM>(p, v.get(j), cd_start, k_max, cd_sum), p);
}

template <typename T>
__device__ __forceinline__ void load_chunk(Pack8<T>* v, const T* tile,
                                           long long hw, long long px0,
                                           int c0, int C) {
#pragma unroll
  for (int k = 0; k < Pack8<T>::kChunk; ++k)
    if (c0 + k < C)
      v[k].load(tile + static_cast<long long>(c0 + k) * hw + px0);
}

template <typename T>
__device__ __forceinline__ void accumulate_chunk(float acc[kGroup][3],
                                                 const Pack8<T>* v,
                                                 const ChanParams* tp, int c0,
                                                 int C, float cd_start,
                                                 float k_max, float cd_sum) {
#pragma unroll
  for (int k = 0; k < Pack8<T>::kChunk; ++k) {
    if (c0 + k < C) {
      const ChanParams p = tp[c0 + k];
      with_family(p.fam, [&](auto fam) {
        accumulate8<decltype(fam)::value>(acc, v[k], p, cd_start, k_max,
                                          cd_sum);
      });
    }
  }
}

__device__ __forceinline__ void add_rgb(float acc[3], const float4 t) {
  acc[0] = __fadd_rn(acc[0], t.x);
  acc[1] = __fadd_rn(acc[1], t.y);
  acc[2] = __fadd_rn(acc[2], t.z);
}

// Quantize the eight loaded values of one channel of family FAM and add
// their table entries (lut: the channel's staged float4[256]).
template <int FAM, typename T>
__device__ __forceinline__ void lookup8(float acc[kGroup][3],
                                       const Pack8<T>& v, const ChanParams& p,
                                       const float4* lut, float cd_start,
                                       float k_max, float cd_sum) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    add_rgb(acc[j], lut[static_cast<int>(quantize_fam<FAM>(
                        p, v.get(j), cd_start, k_max, cd_sum))]);
}

// Channels c0 .. min(c0 + kChunk, ce) - 1, whose tables start at `luts`.
template <typename T>
__device__ __forceinline__ void lookup_chunk(float acc[kGroup][3],
                                             const Pack8<T>* v,
                                             const ChanParams* tp,
                                             const float4* luts, int c0,
                                             int ce, float cd_start,
                                             float k_max, float cd_sum) {
#pragma unroll
  for (int k = 0; k < Pack8<T>::kChunk; ++k) {
    if (c0 + k < ce) {
      const ChanParams p = tp[c0 + k];
      with_family(p.fam, [&](auto fam) {
        lookup8<decltype(fam)::value>(acc, v[k], p, luts + k * 256, cd_start,
                                      k_max, cd_sum);
      });
    }
  }
}

// Tables of channels cs .. ce - 1 of one tile (f32[C][256][3] at `src`) as
// float4 (r, g, b, 0) entries.
__device__ __forceinline__ void stage_tables(float4* luts, const float* src,
                                             int cs, int ce) {
  for (int i = threadIdx.x; i < (ce - cs) * 256; i += blockDim.x) {
    const float* e = src + (static_cast<long long>(cs) * 256 + i) * 3;
    luts[i] = make_float4(__ldg(e), __ldg(e + 1), __ldg(e + 2), 0.f);
  }
}

// Channels of float4 tables that fit beside C channels' constants.
inline int lut_table_chunk(int C) {
  const long long room = static_cast<long long>(kMaxSmem) -
                         static_cast<long long>(sizeof(ChanParams)) * C;
  const long long fit = room > 0 ? room / kLutBytes : 0;
  return static_cast<int>(fit < C ? fit : C);
}

// A LUT launch's blocks stay inside one tile: the `resident` blocks split
// evenly over the B tiles of hw pixels, each block's run of pixel groups a
// whole number of `threads`-group rounds.
inline void split_tiles(long long hw, int B, long long resident, int threads,
                        long long* run, long long* blocks_per_tile) {
  const long long groups = (hw + kGroup - 1) / kGroup;
  const long long rounds = (groups + threads - 1) / threads;
  const long long share = resident / B;
  const long long per_tile =
      share < 1 ? 1 : (share < rounds ? share : rounds);
  *run = (rounds + per_tile - 1) / per_tile * threads;
  *blocks_per_tile = (groups + *run - 1) / *run;
}

}  // namespace
