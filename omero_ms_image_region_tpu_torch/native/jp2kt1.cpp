// EBCOT Tier-1 decoder (ITU-T T.800) — native mirror of the Python
// implementation in io/jp2k.py::_t1_decode (MQ coder per Annex C,
// significance-propagation / magnitude-refinement / cleanup passes,
// dead-zone mid-point reconstruction).  This is where ~95% of JPEG 2000
// decode time goes (per-coefficient per-bit-plane work); everything
// else (markers, tag trees, packet walk, inverse DWT) stays in
// Python/numpy.  Plain C ABI for ctypes; the GIL is released for the
// whole call.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

constexpr int kCtxRl = 17;
constexpr int kCtxUni = 18;
constexpr int kNCtx = 19;

struct Mq {
  const uint8_t* data;
  size_t len;
  size_t bp = 0;
  uint32_t c = 0;
  uint32_t a = 0;
  int ct = 0;
  uint8_t idx[kNCtx];
  uint8_t mps[kNCtx];

  uint8_t b(size_t k = 0) const {
    size_t p = bp + k;
    return p < len ? data[p] : 0xFF;
  }
  void bytein() {
    if (b() == 0xFF) {
      if (b(1) > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp += 1;
        c += (uint32_t)b() << 9;
        ct = 7;
      }
    } else {
      bp += 1;
      c += (uint32_t)b() << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* d, size_t n) {
    data = d;
    len = n;
    std::memset(idx, 0, sizeof(idx));
    std::memset(mps, 0, sizeof(mps));
    idx[kCtxUni] = 46;
    idx[kCtxRl] = 3;
    idx[0] = 4;
    bp = 0;
    c = (uint32_t)(n ? d[0] : 0xFF) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  int decode(int cx) {
    const MqState& s = kMq[idx[cx]];
    uint32_t qe = s.qe;
    int d;
    a -= qe;
    if (((c >> 16) & 0xFFFF) < qe) {
      if (a < qe) {
        d = mps[cx];
        idx[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = 1 - mps[cx];
        idx[cx] = s.nlps;
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < qe) {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = 1 - mps[cx];
        idx[cx] = s.nlps;
      } else {
        d = mps[cx];
        idx[cx] = s.nmps;
      }
    }
    do {
      if (ct == 0) bytein();
      a = (a << 1) & 0xFFFF;
      c <<= 1;
      ct -= 1;
    } while (!(a & 0x8000));
    return d;
  }
};

// Zero-coding context (T.800 Table D.1), h/v clamped to 2, d to 4.
inline int zc_context(int h, int v, int d, int orient) {
  int hh, vv;
  if (orient == 3) {  // HH
    int hv = h + v;
    if (d >= 3) return 8;
    if (d == 2) return hv >= 1 ? 7 : 6;
    if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
    return hv >= 2 ? 2 : hv;
  }
  if (orient == 1) {  // HL swaps h and v
    hh = v;
    vv = h;
  } else {            // LL / LH
    hh = h;
    vv = v;
  }
  if (hh == 2) return 8;
  if (hh == 1) return vv >= 1 ? 7 : (d >= 1 ? 6 : 5);
  if (vv == 2) return 4;
  if (vv == 1) return 3;
  return d >= 2 ? 2 : d;
}

constexpr int kScCtx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
constexpr int kScXor[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};

}  // namespace

extern "C" {

// Decode one code-block.  out is f64[h*w] row-major signed values.
// Returns 0 on success, -1 on invalid arguments.
long long jp2k_t1_decode(const uint8_t* data, size_t len, int w, int h,
                         int npasses, int msbs, int orient, int segsym,
                         int half_at_zero, double* out) {
  if (!out || w <= 0 || h <= 0 || w > 4096 || h > 4096) return -1;
  std::memset(out, 0, sizeof(double) * (size_t)w * h);
  if (msbs <= 0 || npasses <= 0 || !data) return 0;

  const int W = w + 2, H = h + 2;
  std::vector<uint8_t> sig((size_t)W * H, 0);
  std::vector<int8_t> sgn((size_t)W * H, 0);
  std::vector<uint8_t> visited((size_t)W * H, 0);
  std::vector<uint8_t> refined((size_t)W * H, 0);
  std::vector<int64_t> mag((size_t)w * h, 0);
  Mq mq;
  mq.init(data, len);

  auto at = [W](int py, int px) { return (size_t)py * W + px; };
  auto nbr = [&](int py, int px, int* hn, int* vn, int* dn) {
    *hn = sig[at(py, px - 1)] + sig[at(py, px + 1)];
    *vn = sig[at(py - 1, px)] + sig[at(py + 1, px)];
    *dn = sig[at(py - 1, px - 1)] + sig[at(py - 1, px + 1)] +
          sig[at(py + 1, px - 1)] + sig[at(py + 1, px + 1)];
  };
  auto decode_sign = [&](int py, int px) -> int {
    int hc = sgn[at(py, px - 1)] + sgn[at(py, px + 1)];
    hc = hc > 1 ? 1 : (hc < -1 ? -1 : hc);
    int vc = sgn[at(py - 1, px)] + sgn[at(py + 1, px)];
    vc = vc > 1 ? 1 : (vc < -1 ? -1 : vc);
    int bit = mq.decode(kScCtx[hc + 1][vc + 1]);
    return (bit ^ kScXor[hc + 1][vc + 1]) ? -1 : 1;
  };

  int plane = msbs - 1;
  int pass_kind = 2;  // first pass is a cleanup
  for (int p = 0; p < npasses; ++p) {
    if (plane < 0) break;
    int64_t bitval = (int64_t)1 << plane;
    if (pass_kind == 0) {
      for (int y0 = 0; y0 < h; y0 += 4) {
        int ylim = y0 + 4 < h ? y0 + 4 : h;
        for (int x = 0; x < w; ++x) {
          for (int y = y0; y < ylim; ++y) {
            int py = y + 1, px = x + 1;
            if (sig[at(py, px)]) continue;
            int hn, vn, dn;
            nbr(py, px, &hn, &vn, &dn);
            if (hn + vn + dn == 0) continue;
            visited[at(py, px)] = 1;
            if (mq.decode(zc_context(hn > 2 ? 2 : hn, vn > 2 ? 2 : vn,
                                     dn > 4 ? 4 : dn, orient))) {
              int s = decode_sign(py, px);
              sig[at(py, px)] = 1;
              sgn[at(py, px)] = (int8_t)s;
              mag[(size_t)y * w + x] = bitval;
            }
          }
        }
      }
      pass_kind = 1;
    } else if (pass_kind == 1) {
      for (int y0 = 0; y0 < h; y0 += 4) {
        int ylim = y0 + 4 < h ? y0 + 4 : h;
        for (int x = 0; x < w; ++x) {
          for (int y = y0; y < ylim; ++y) {
            int py = y + 1, px = x + 1;
            if (!sig[at(py, px)] || visited[at(py, px)]) continue;
            int ctx;
            if (!refined[at(py, px)]) {
              int hn, vn, dn;
              nbr(py, px, &hn, &vn, &dn);
              ctx = (hn + vn + dn) ? 15 : 14;
              refined[at(py, px)] = 1;
            } else {
              ctx = 16;
            }
            if (mq.decode(ctx)) mag[(size_t)y * w + x] |= bitval;
          }
        }
      }
      pass_kind = 2;
    } else {
      for (int y0 = 0; y0 < h; y0 += 4) {
        int ylim = y0 + 4 < h ? y0 + 4 : h;
        for (int x = 0; x < w; ++x) {
          int y = y0;
          if (ylim - y0 == 4) {
            bool runnable = true;
            for (int yy = y0; yy < ylim; ++yy) {
              int py = yy + 1, px = x + 1;
              if (sig[at(py, px)] || visited[at(py, px)]) {
                runnable = false;
                break;
              }
              int hn, vn, dn;
              nbr(py, px, &hn, &vn, &dn);
              if (hn + vn + dn) {
                runnable = false;
                break;
              }
            }
            if (runnable) {
              if (!mq.decode(kCtxRl)) {
                for (int yy = y0; yy < ylim; ++yy)
                  visited[at(yy + 1, x + 1)] = 0;
                continue;
              }
              int r2 = (mq.decode(kCtxUni) << 1) | mq.decode(kCtxUni);
              y = y0 + r2;
              int py = y + 1, px = x + 1;
              int s = decode_sign(py, px);
              sig[at(py, px)] = 1;
              sgn[at(py, px)] = (int8_t)s;
              mag[(size_t)y * w + x] = bitval;
              y += 1;
            }
          }
          for (; y < ylim; ++y) {
            int py = y + 1, px = x + 1;
            if (sig[at(py, px)] || visited[at(py, px)]) {
              visited[at(py, px)] = 0;
              continue;
            }
            int hn, vn, dn;
            nbr(py, px, &hn, &vn, &dn);
            if (mq.decode(zc_context(hn > 2 ? 2 : hn, vn > 2 ? 2 : vn,
                                     dn > 4 ? 4 : dn, orient))) {
              int s = decode_sign(py, px);
              sig[at(py, px)] = 1;
              sgn[at(py, px)] = (int8_t)s;
              mag[(size_t)y * w + x] = bitval;
            }
          }
        }
      }
      if (segsym) {
        for (int k = 0; k < 4; ++k) mq.decode(kCtxUni);
      }
      std::fill(visited.begin(), visited.end(), 0);
      plane -= 1;
      pass_kind = 0;
    }
  }

  int last_plane = plane + 1;
  double half = 0.0;
  if (last_plane > 0 || half_at_zero) {
    int lp = last_plane > 0 ? last_plane : 0;
    half = 0.5 * (double)((int64_t)1 << lp);
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int64_t m = mag[(size_t)y * w + x];
      if (!m) continue;
      double v = (double)m + half;
      if (sgn[at(y + 1, x + 1)] < 0) v = -v;
      out[(size_t)y * w + x] = v;
    }
  }
  return 0;
}

}  // extern "C"
