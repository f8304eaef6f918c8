// JPEG decoder (ITU-T T.81): a copy of the JAX package's
// native/jpegdec.cpp, the native path behind io/jpegdec.py (same scope:
// SOF0/1 baseline AND SOF2 progressive, 8-bit, 1..4 components, sampling
// 1-2, abbreviated streams with external JPEGTables, DRI/RST, progressive
// spectral selection + successive approximation with inter-scan
// DHT/DQT/DRI updates).  Plain C ABI for ctypes; the GIL is released for
// the whole decode.  tests/test_torch_jpegdec.py holds it byte for byte
// against the Python decoder and the JAX package's.
//
// Validation contract mirrors the Python decoder exactly (byte-parity
// tests depend on identical accept/reject behavior): frame-scaled
// block-visit budget, scan-script succession checks (DC-before-AC,
// Ah continuing the band's Al).
//
// Return contract (jpeg_decode_baseline):
//   >= 0  bytes written to out (h*w*ncomp, interleaved)
//   -1    malformed / unsupported stream
//   -2    out_cap too small; *out_w/*out_h/*out_ncomp are set, so the
//         caller sizes the buffer as w*h*ncomp and retries

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

constexpr int kZigzag[64] = {
    0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huff {
  // 16-bit left-aligned prefix -> value/length; len 0 = invalid.
  std::vector<uint8_t> val, len;
  bool present = false;
  bool build(const uint8_t* bits, const uint8_t* values, int nvals) {
    val.assign(65536, 0);
    len.assign(65536, 0);
    uint32_t code = 0;
    int k = 0;
    for (int length = 1; length <= 16; ++length) {
      for (int i = 0; i < bits[length - 1]; ++i) {
        if (k >= nvals) return false;
        uint32_t aligned = code << (16 - length);
        uint32_t span = 1u << (16 - length);
        if (aligned + span > 65536) return false;
        for (uint32_t j = 0; j < span; ++j) {
          val[aligned + j] = values[k];
          len[aligned + j] = (uint8_t)length;
        }
        ++code;
        ++k;
      }
      code <<= 1;
    }
    present = true;
    return true;
  }
};

struct Component {
  int ident = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
};

struct Tables {
  int32_t quant[4][64];
  bool quant_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
};

struct Frame {
  int w = 0, h = 0, ncomp = 0;
  Component comp[4];
  bool present = false;
};

struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t pos;
  uint64_t buf = 0;
  int nbits = 0;
  int marker = -1;  // -1: none seen

  void fill() {
    while (nbits <= 48) {
      if (marker >= 0 || pos >= len) {
        buf = (buf << 8) | 0xFF;  // T.81 F.2.2.5 pad bits
        nbits += 8;
        continue;
      }
      uint8_t b = data[pos];
      if (b == 0xFF) {
        uint8_t nxt = (pos + 1 < len) ? data[pos + 1] : 0xD9;
        if (nxt == 0x00) {
          pos += 2;
        } else {
          marker = nxt;  // RST handled by restart(), EOI/other stops
          continue;
        }
      } else {
        pos += 1;
      }
      buf = (buf << 8) | b;
      nbits += 8;
    }
  }
  inline uint32_t peek16() {
    if (nbits < 16) fill();
    return (uint32_t)((buf >> (nbits - 16)) & 0xFFFF);
  }
  inline void skip(int n) {
    nbits -= n;
    buf &= (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1);
  }
  inline int receive(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = (int)((buf >> (nbits - n)) & ((1ull << n) - 1));
    skip(n);
    return v;
  }
  bool restart() {
    buf = 0;
    nbits = 0;
    if (marker >= 0xD0 && marker <= 0xD7) {
      pos += 2;
      marker = -1;
      return true;
    }
    while (pos + 1 < len) {
      if (data[pos] == 0xFF && data[pos + 1] >= 0xD0 &&
          data[pos + 1] <= 0xD7) {
        pos += 2;
        marker = -1;  // stale non-RST marker must not pad out the rest
        return true;
      }
      ++pos;
    }
    return false;
  }
};

inline int extend(int v, int t) {
  return (t && v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

inline int decode_huff(BitReader& br, const Huff& h, bool* ok) {
  uint32_t prefix = br.peek16();
  int length = h.len[prefix];
  if (length == 0) {
    *ok = false;
    return 0;
  }
  br.skip(length);
  return h.val[prefix];
}

struct Scan {
  int ns = 0;
  int ci[4] = {0, 0, 0, 0};  // indices into Frame.comp
  int ss = 0, se = 63, ah = 0, al = 0;
};

bool handle_dqt(const uint8_t* body, size_t blen, Tables& t) {
  size_t i = 0;
  while (i < blen) {
    int pq = body[i] >> 4, tq = body[i] & 0xF;
    ++i;
    if (tq > 3) return false;
    if (pq == 0) {
      if (i + 64 > blen) return false;
      for (int j = 0; j < 64; ++j) t.quant[tq][j] = body[i + j];
      i += 64;
    } else {
      if (i + 128 > blen) return false;
      for (int j = 0; j < 64; ++j)
        t.quant[tq][j] =
            ((int32_t)body[i + 2 * j] << 8) | body[i + 2 * j + 1];
      i += 128;
    }
    t.quant_present[tq] = true;
  }
  return true;
}

bool handle_dht(const uint8_t* body, size_t blen, Tables& t) {
  size_t i = 0;
  while (i + 17 <= blen) {
    int tc = body[i] >> 4, th = body[i] & 0xF;
    if (th > 3 || tc > 1) return false;
    const uint8_t* bits = body + i + 1;
    int n = 0;
    for (int j = 0; j < 16; ++j) n += bits[j];
    if (i + 17 + (size_t)n > blen) return false;
    Huff& h = (tc == 0) ? t.dc[th] : t.ac[th];
    if (!h.build(bits, body + i + 17, n)) return false;
    i += 17 + n;
  }
  return true;
}

// SOS body -> Scan (and td/ta on the named components).  Progressive
// scans may name any subset; baseline requires all components.
bool parse_sos(const uint8_t* body, size_t blen, Frame& f,
               bool progressive, Scan& scan) {
  if (!f.present || blen < 1) return false;
  int ns = body[0];
  if (ns < 1 || ns > 4 || blen < 1 + 2 * (size_t)ns + 3) return false;
  if (!progressive && ns != f.ncomp) return false;
  scan.ns = ns;
  for (int si = 0; si < ns; ++si) {
    int cs = body[1 + 2 * si];
    int td = body[2 + 2 * si] >> 4, ta = body[2 + 2 * si] & 0xF;
    bool found = false;
    for (int ci = 0; ci < f.ncomp; ++ci) {
      if (f.comp[ci].ident == cs) {
        if (td > 3 || ta > 3) return false;
        f.comp[ci].td = td;
        f.comp[ci].ta = ta;
        scan.ci[si] = ci;
        found = true;
        break;
      }
    }
    if (!found) return false;
  }
  scan.ss = body[1 + 2 * ns];
  scan.se = body[2 + 2 * ns];
  int ahal = body[3 + 2 * ns];
  scan.ah = ahal >> 4;
  scan.al = ahal & 0xF;
  if (progressive) {
    if (scan.ss > scan.se || scan.se > 63 || scan.al > 13 ||
        scan.ah > 13)
      return false;
    if (scan.ss == 0 && scan.se != 0) return false;
    if (scan.ss > 0 && ns != 1) return false;
  }
  return true;
}

// Walk marker segments until SOS/EOI.  Returns scan start offset, or
// 0 on EOI (tables-only), or SIZE_MAX on error.
size_t parse_segments(const uint8_t* data, size_t len, Tables& t,
                      Frame& f, bool* progressive, Scan* scan) {
  if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) return SIZE_MAX;
  size_t pos = 2;
  while (pos + 2 <= len) {
    if (data[pos] != 0xFF) return SIZE_MAX;
    uint8_t marker = data[pos + 1];
    if (marker == 0xD9) return 0;  // EOI
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) {
      pos += 2;
      continue;
    }
    if (pos + 4 > len) return SIZE_MAX;
    size_t seglen = ((size_t)data[pos + 2] << 8) | data[pos + 3];
    if (seglen < 2 || pos + 2 + seglen > len) return SIZE_MAX;
    const uint8_t* body = data + pos + 4;
    size_t blen = seglen - 2;
    if (marker == 0xDB) {
      if (!handle_dqt(body, blen, t)) return SIZE_MAX;
    } else if (marker == 0xC4) {
      if (!handle_dht(body, blen, t)) return SIZE_MAX;
    } else if (marker == 0xDD) {  // DRI
      if (blen < 2) return SIZE_MAX;
      t.restart_interval = ((int)body[0] << 8) | body[1];
    } else if (marker == 0xC0 || marker == 0xC1 ||
               marker == 0xC2) {  // SOF0/1 baseline, SOF2 progressive
      if (blen < 6) return SIZE_MAX;
      if (body[0] != 8) return SIZE_MAX;  // 8-bit only
      f.h = ((int)body[1] << 8) | body[2];
      f.w = ((int)body[3] << 8) | body[4];
      f.ncomp = body[5];
      if (f.h == 0 || f.w == 0 || f.ncomp < 1 || f.ncomp > 4)
        return SIZE_MAX;
      // Hostile headers must not drive allocations (bad_alloc across
      // the C ABI would terminate the process).
      if ((int64_t)f.h * f.w * f.ncomp > ((int64_t)1 << 28))
        return SIZE_MAX;
      if (blen < 6 + 3 * (size_t)f.ncomp) return SIZE_MAX;
      for (int ci = 0; ci < f.ncomp; ++ci) {
        const uint8_t* e = body + 6 + 3 * ci;
        f.comp[ci].ident = e[0];
        f.comp[ci].h = e[1] >> 4;
        f.comp[ci].v = e[1] & 0xF;
        f.comp[ci].tq = e[2];
        if (f.comp[ci].h < 1 || f.comp[ci].h > 2 || f.comp[ci].v < 1 ||
            f.comp[ci].v > 2 || f.comp[ci].tq > 3)
          return SIZE_MAX;
      }
      f.present = true;
      if (progressive) *progressive = (marker == 0xC2);
    } else if (marker == 0xC3 || (marker >= 0xC5 && marker <= 0xC7) ||
               (marker >= 0xC9 && marker <= 0xCB) ||
               (marker >= 0xCD && marker <= 0xCF)) {
      return SIZE_MAX;  // unsupported JPEG process
    } else if (marker == 0xDA) {  // SOS
      Scan local;
      Scan& s = scan ? *scan : local;
      bool prog = progressive && *progressive;
      if (!parse_sos(body, blen, f, prog, s)) return SIZE_MAX;
      return pos + 2 + seglen;
    }
    pos += 2 + seglen;
  }
  return SIZE_MAX;
}

// IDCT basis as a C++11 magic static: decodes run with the GIL
// released, so first-use init must be thread-safe (a hand-rolled
// static bool would race).
struct IdctBasis {
  float M[8][8];
  IdctBasis() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        M[u][x] = (u == 0 ? std::sqrt(0.125f) : 0.5f) *
                  std::cos((2 * x + 1) * u * (float)M_PI / 16.0f);
  }
};

// Separable float IDCT on one dequantized 8x8 block (row-major input).
void idct8x8(const float* in, float* out) {
  static const IdctBasis basis;
  const auto& M = basis.M;
  float tmp[8][8];
  for (int u = 0; u < 8; ++u)  // tmp = in^T applied: tmp[x][v]
    for (int v = 0; v < 8; ++v) {
      float s = 0.f;
      for (int k = 0; k < 8; ++k) s += M[k][u] * in[k * 8 + v];
      tmp[u][v] = s;
    }
  for (int x = 0; x < 8; ++x)
    for (int y = 0; y < 8; ++y) {
      float s = 0.f;
      for (int k = 0; k < 8; ++k) s += tmp[x][k] * M[k][y];
      out[x * 8 + y] = s;
    }
}

// ------------------------------------------------------- progressive

// A component's TRUE (non-interleaved) block-grid dimensions.
void comp_block_dims(const Component& c, int h, int w, int hmax,
                     int vmax, int* nby, int* nbx) {
  int cw = (w * c.h + hmax - 1) / hmax;
  int ch = (h * c.v + vmax - 1) / vmax;
  *nby = (ch + 7) / 8;
  *nbx = (cw + 7) / 8;
}

// First non-RST, non-stuffing marker at/after pos (between scans).
size_t next_marker_pos(const uint8_t* data, size_t len, size_t pos) {
  while (pos + 1 < len) {
    if (data[pos] == 0xFF && data[pos + 1] != 0x00 &&
        data[pos + 1] != 0xFF &&
        !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7))
      return pos;
    ++pos;
  }
  return SIZE_MAX;
}

// T.81 G.2.2 first pass over one AC band; returns new eobrun or -1.
long long ac_first_block(BitReader& br, const Huff& ach, int32_t* block,
                         int ss, int se, int al, long long eobrun) {
  if (eobrun) return eobrun - 1;
  bool ok = true;
  int k = ss;
  while (k <= se) {
    int rs = decode_huff(br, ach, &ok);
    if (!ok) return -1;
    int r = rs >> 4, s = rs & 0xF;
    if (s == 0) {
      if (r == 15) {
        k += 16;  // ZRL
        continue;
      }
      long long run = 1ll << r;
      if (r) run += br.receive(r);
      return run - 1;  // covers this block
    }
    k += r;
    if (k > se) return -1;
    block[k] = extend(br.receive(s), s) << al;
    ++k;
  }
  return 0;
}

// T.81 G.2.3 correction pass (the jdphuff.c refinement walk).
long long ac_refine_block(BitReader& br, const Huff& ach, int32_t* block,
                          int ss, int se, int al, long long eobrun) {
  const int32_t p1 = 1 << al;
  const int32_t m1 = -(1 << al);
  bool ok = true;
  int k = ss;
  if (!eobrun) {
    while (k <= se) {
      int rs = decode_huff(br, ach, &ok);
      if (!ok) return -1;
      int r = rs >> 4, s = rs & 0xF;
      int32_t val = 0;
      if (s == 0) {
        if (r != 15) {
          eobrun = 1ll << r;
          if (r) eobrun += br.receive(r);
          break;
        }
        // r == 15: run of 16 zero-history coefficients
      } else {
        if (s != 1) return -1;
        val = br.receive(1) ? p1 : m1;
      }
      bool placed = false;
      while (k <= se) {
        if (block[k]) {
          if (br.receive(1) && !(block[k] & p1))
            block[k] += (block[k] >= 0) ? p1 : m1;
        } else {
          if (r == 0) {
            if (val) block[k] = val;
            ++k;
            placed = true;
            break;
          }
          --r;
        }
        ++k;
      }
      if (!placed && val) return -1;  // value past band end
    }
  }
  if (eobrun) {
    while (k <= se) {
      if (block[k]) {
        if (br.receive(1) && !(block[k] & p1))
          block[k] += (block[k] >= 0) ? p1 : m1;
      }
      ++k;
    }
    --eobrun;
  }
  return eobrun;
}

struct ProgState {
  // Scan-script succession state (mirrors the Python decoder): the
  // DC approximation level per component, and per-coefficient AC
  // levels; -2 = not coded yet.
  int dc_al[4] = {-2, -2, -2, -2};
  int ac_al[4][64];
  ProgState() {
    for (auto& row : ac_al)
      for (int& v : row) v = -2;
  }
};

// One progressive scan's succession validation + state update.
bool validate_scan_script(const Frame& f, const Scan& s,
                          ProgState& st) {
  if (s.ss == 0) {
    for (int si = 0; si < s.ns; ++si) {
      int ci = s.ci[si];
      if (s.ah == 0) {
        if (st.dc_al[ci] != -2) return false;  // duplicate first scan
      } else {
        if (st.dc_al[ci] != s.ah || s.al != s.ah - 1) return false;
      }
      st.dc_al[ci] = s.al;
    }
    return true;
  }
  int ci = s.ci[0];
  if (st.dc_al[ci] == -2) return false;  // AC before the DC first scan
  for (int k = s.ss; k <= s.se; ++k) {
    if (s.ah == 0) {
      if (st.ac_al[ci][k] != -2) return false;
    } else {
      if (st.ac_al[ci][k] != s.ah || s.al != s.ah - 1) return false;
    }
    st.ac_al[ci][k] = s.al;
  }
  return true;
}

long long decode_progressive(const uint8_t* data, size_t len, Tables& t,
                             Frame& f, Scan scan, size_t scan_pos,
                             uint8_t* out) {
  int hmax = 1, vmax = 1;
  for (int ci = 0; ci < f.ncomp; ++ci) {
    if (f.comp[ci].h > hmax) hmax = f.comp[ci].h;
    if (f.comp[ci].v > vmax) vmax = f.comp[ci].v;
  }
  int mcux = (f.w + 8 * hmax - 1) / (8 * hmax);
  int mcuy = (f.h + 8 * vmax - 1) / (8 * vmax);

  // Per-component coefficient grids [by][bx][64], zigzag order.
  std::vector<std::vector<int32_t>> grids(f.ncomp);
  int gw[4], gh[4];
  long long total_blocks = 0;
  for (int ci = 0; ci < f.ncomp; ++ci) {
    gw[ci] = mcux * f.comp[ci].h;
    gh[ci] = mcuy * f.comp[ci].v;
    grids[ci].assign((size_t)gw[ci] * gh[ci] * 64, 0);
    total_blocks += (long long)gw[ci] * gh[ci];
  }
  // Frame-scaled cumulative visit budget (shared rule with the Python
  // decoder): legitimately deep scan scripts over large frames pass,
  // tiny streams declaring huge frames with scan amplification fail.
  // The scale term is CAPPED (1<<25) so attacker-declared dimensions
  // cannot push the pure-Python fallback's wall time past ~seconds.
  const long long max_visits = std::max(
      (long long)1 << 23,
      std::min(64 * total_blocks, (long long)1 << 25));
  long long visits = 0;
  ProgState st;
  // The Python decoder requires every component's quant table before
  // the first scan (parity contract).
  for (int ci = 0; ci < f.ncomp; ++ci)
    if (!t.quant_present[f.comp[ci].tq]) return -1;

  for (int nscan = 0; nscan < 256; ++nscan) {
    if (!validate_scan_script(f, scan, st)) return -1;
    BitReader br{data, len, scan_pos};
    long long eobrun = 0;
    long long unit = 0;
    int ri = t.restart_interval;
    if (scan.ss == 0) {
      // DC scan: interleaved MCU walk, or the lone component's true
      // block grid.
      for (int si = 0; si < scan.ns; ++si) {
        int ci = scan.ci[si];
        if (scan.ah == 0 && !t.dc[f.comp[ci].td].present) return -1;
      }
      int preds[4] = {0, 0, 0, 0};
      bool ok = true;
      auto visit = [&](int ci, int by, int bx) {
        const Component& c = f.comp[ci];
        int32_t* block =
            grids[ci].data() + ((size_t)by * gw[ci] + bx) * 64;
        if (scan.ah == 0) {
          int tcat = decode_huff(br, t.dc[c.td], &ok);
          if (!ok || tcat > 15) {
            ok = false;
            return;
          }
          preds[ci] += extend(br.receive(tcat), tcat);
          block[0] = preds[ci] << scan.al;
        } else {
          if (br.receive(1)) block[0] |= (1 << scan.al);
        }
      };
      if (scan.ns > 1) {
        // Same accounting as the Python decoder: every coded block of
        // every selected component counts.
        for (int si = 0; si < scan.ns; ++si) {
          const Component& c = f.comp[scan.ci[si]];
          visits += (long long)mcux * c.h * mcuy * c.v;
        }
        if (visits > max_visits) return -1;
        for (int my = 0; my < mcuy && ok; ++my)
          for (int mx = 0; mx < mcux && ok; ++mx) {
            if (ri && unit && unit % ri == 0) {
              if (!br.restart()) return -1;
              preds[0] = preds[1] = preds[2] = preds[3] = 0;
            }
            ++unit;
            for (int si = 0; si < scan.ns && ok; ++si) {
              int ci = scan.ci[si];
              const Component& c = f.comp[ci];
              for (int by = 0; by < c.v && ok; ++by)
                for (int bx = 0; bx < c.h && ok; ++bx)
                  visit(ci, my * c.v + by, mx * c.h + bx);
            }
          }
      } else {
        int ci = scan.ci[0];
        int nby, nbx;
        comp_block_dims(f.comp[ci], f.h, f.w, hmax, vmax, &nby, &nbx);
        visits += (long long)nby * nbx;
        if (visits > max_visits) return -1;
        for (int by = 0; by < nby && ok; ++by)
          for (int bx = 0; bx < nbx && ok; ++bx) {
            if (ri && unit && unit % ri == 0) {
              if (!br.restart()) return -1;
              preds[0] = preds[1] = preds[2] = preds[3] = 0;
            }
            ++unit;
            visit(ci, by, bx);
          }
      }
      if (!ok) return -1;
    } else {
      // AC scan: always single-component, TRUE block grid.
      int ci = scan.ci[0];
      const Component& c = f.comp[ci];
      if (!t.ac[c.ta].present) return -1;
      const Huff& ach = t.ac[c.ta];
      int nby, nbx;
      comp_block_dims(c, f.h, f.w, hmax, vmax, &nby, &nbx);
      visits += (long long)nby * nbx;
      if (visits > max_visits) return -1;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          if (ri && unit && unit % ri == 0) {
            if (!br.restart()) return -1;
            eobrun = 0;
          }
          ++unit;
          int32_t* block =
              grids[ci].data() + ((size_t)by * gw[ci] + bx) * 64;
          eobrun = (scan.ah == 0)
                       ? ac_first_block(br, ach, block, scan.ss,
                                        scan.se, scan.al, eobrun)
                       : ac_refine_block(br, ach, block, scan.ss,
                                         scan.se, scan.al, eobrun);
          if (eobrun < 0) return -1;
        }
    }

    // Inter-scan segments: DHT/DQT/DRI updates, next SOS, or EOI.
    size_t pos = next_marker_pos(data, len, br.pos);
    if (pos == SIZE_MAX) return -1;
    bool have_scan = false;
    bool saw_eoi = false;
    while (pos + 2 <= len) {
      uint8_t marker = data[pos + 1];
      if (marker == 0xD9) {  // EOI: reconstruct below
        saw_eoi = true;
        break;
      }
      if (pos + 4 > len) return -1;
      size_t seglen = ((size_t)data[pos + 2] << 8) | data[pos + 3];
      if (seglen < 2 || pos + 2 + seglen > len) return -1;
      const uint8_t* body = data + pos + 4;
      size_t blen = seglen - 2;
      if (marker == 0xDA) {
        if (!parse_sos(body, blen, f, true, scan)) return -1;
        scan_pos = pos + 2 + seglen;
        have_scan = true;
        break;
      } else if (marker == 0xDB) {
        if (!handle_dqt(body, blen, t)) return -1;
      } else if (marker == 0xC4) {
        if (!handle_dht(body, blen, t)) return -1;
      } else if (marker == 0xDD) {
        if (blen < 2) return -1;
        t.restart_interval = ((int)body[0] << 8) | body[1];
      }  // APPn/COM: skipped
      pos += 2 + seglen;
    }
    if (have_scan) continue;
    // Data exhausted without EOI: malformed (parity with the Python
    // decoder's "ended without EOI").
    if (!saw_eoi) return -1;

    // EOI: dequant + IDCT + upsample + interleave + crop.
    int pw = mcux * 8 * hmax, ph = mcuy * 8 * vmax;
    std::vector<std::vector<uint8_t>> planes(
        f.ncomp, std::vector<uint8_t>((size_t)pw * ph));
    float deq[64], spatial[64];
    for (int ci = 0; ci < f.ncomp; ++ci) {
      const Component& c = f.comp[ci];
      const int32_t* q = t.quant[c.tq];
      int sx = hmax / c.h, sy = vmax / c.v;
      uint8_t* plane = planes[ci].data();
      for (int by = 0; by < gh[ci]; ++by) {
        for (int bx = 0; bx < gw[ci]; ++bx) {
          const int32_t* block =
              grids[ci].data() + ((size_t)by * gw[ci] + bx) * 64;
          for (int j = 0; j < 64; ++j)
            deq[kZigzag[j]] = (float)(block[j] * q[j]);
          idct8x8(deq, spatial);
          int ox = bx * 8, oy = by * 8;
          for (int yy = 0; yy < 8; ++yy)
            for (int xx = 0; xx < 8; ++xx) {
              float v = spatial[yy * 8 + xx] + 128.0f;
              int p = (int)std::lrintf(v);
              uint8_t u = (uint8_t)(p < 0 ? 0 : (p > 255 ? 255 : p));
              int gy0 = (oy + yy) * sy, gx0 = (ox + xx) * sx;
              for (int ry = 0; ry < sy; ++ry)
                for (int rx = 0; rx < sx; ++rx)
                  plane[(size_t)(gy0 + ry) * pw + gx0 + rx] = u;
            }
        }
      }
    }
    for (int y = 0; y < f.h; ++y)
      for (int ci = 0; ci < f.ncomp; ++ci) {
        const uint8_t* row = planes[ci].data() + (size_t)y * pw;
        uint8_t* dst = out + ((size_t)y * f.w) * f.ncomp + ci;
        for (int x = 0; x < f.w; ++x) dst[(size_t)x * f.ncomp] = row[x];
      }
    return (long long)f.w * f.h * f.ncomp;
  }
  return -1;  // > 256 scans
}

}  // namespace

extern "C" {

long long jpeg_decode_baseline(const uint8_t* data, size_t len,
                               const uint8_t* tables, size_t tables_len,
                               uint8_t* out, size_t out_cap, int* out_w,
                               int* out_h, int* out_ncomp) {
  if (!data || !out_w || !out_h || !out_ncomp) return -1;
  Tables t;
  if (tables && tables_len) {
    Frame tf;
    bool tp = false;
    if (parse_segments(tables, tables_len, t, tf, &tp, nullptr) ==
        SIZE_MAX)
      return -1;
  }
  Frame f;
  bool progressive = false;
  Scan first_scan;
  size_t scan =
      parse_segments(data, len, t, f, &progressive, &first_scan);
  if (scan == SIZE_MAX || scan == 0 || !f.present) return -1;

  size_t need = (size_t)f.w * f.h * f.ncomp;
  if (out_cap < need) {
    *out_w = f.w;
    *out_h = f.h;
    *out_ncomp = f.ncomp;
    return -2;
  }
  if (progressive) {
    long long n = decode_progressive(data, len, t, f, first_scan,
                                     scan, out);
    if (n < 0) return -1;
    *out_w = f.w;
    *out_h = f.h;
    *out_ncomp = f.ncomp;
    return n;
  }

  int hmax = 1, vmax = 1;
  for (int ci = 0; ci < f.ncomp; ++ci) {
    if (f.comp[ci].h > hmax) hmax = f.comp[ci].h;
    if (f.comp[ci].v > vmax) vmax = f.comp[ci].v;
  }
  int mcux = (f.w + 8 * hmax - 1) / (8 * hmax);
  int mcuy = (f.h + 8 * vmax - 1) / (8 * vmax);

  for (int ci = 0; ci < f.ncomp; ++ci) {
    const Component& c = f.comp[ci];
    if (!t.quant_present[c.tq] || !t.dc[c.td].present ||
        !t.ac[c.ta].present)
      return -1;
  }

  // Decoded full-resolution component planes (MCU-grid sized).
  int pw = mcux * 8 * hmax, ph = mcuy * 8 * vmax;
  std::vector<std::vector<uint8_t>> planes(
      f.ncomp, std::vector<uint8_t>((size_t)pw * ph));

  BitReader br{data, len, scan};
  int preds[4] = {0, 0, 0, 0};
  int ri = t.restart_interval;
  long long mcu_index = 0;
  float deq[64], spatial[64];
  int32_t block[64];
  bool ok = true;
  for (int my = 0; my < mcuy && ok; ++my) {
    for (int mx = 0; mx < mcux && ok; ++mx) {
      if (ri && mcu_index && mcu_index % ri == 0) {
        if (!br.restart()) return -1;
        preds[0] = preds[1] = preds[2] = preds[3] = 0;
      }
      ++mcu_index;
      for (int ci = 0; ci < f.ncomp && ok; ++ci) {
        const Component& c = f.comp[ci];
        const Huff& dch = t.dc[c.td];
        const Huff& ach = t.ac[c.ta];
        const int32_t* q = t.quant[c.tq];
        for (int by = 0; by < c.v && ok; ++by) {
          for (int bx = 0; bx < c.h && ok; ++bx) {
            std::memset(block, 0, sizeof(block));
            int tcat = decode_huff(br, dch, &ok);
            if (!ok) break;
            if (tcat > 15) {
              ok = false;
              break;
            }
            preds[ci] += extend(br.receive(tcat), tcat);
            block[0] = preds[ci];
            int k = 1;
            while (k < 64) {
              int rs = decode_huff(br, ach, &ok);
              if (!ok) break;
              int r = rs >> 4, s = rs & 0xF;
              if (s == 0) {
                if (r == 15) {
                  k += 16;
                  continue;
                }
                break;  // EOB
              }
              k += r;
              if (k > 63) {
                ok = false;
                break;
              }
              block[k] = extend(br.receive(s), s);
              ++k;
            }
            if (!ok) break;
            for (int j = 0; j < 64; ++j)
              deq[kZigzag[j]] = (float)(block[j] * q[j]);
            idct8x8(deq, spatial);
            // Store with replication upsampling folded in.
            int sx = hmax / c.h, sy = vmax / c.v;
            int ox = (mx * c.h + bx) * 8, oy = (my * c.v + by) * 8;
            uint8_t* plane = planes[ci].data();
            for (int yy = 0; yy < 8; ++yy) {
              for (int xx = 0; xx < 8; ++xx) {
                float v = spatial[yy * 8 + xx] + 128.0f;
                int p = (int)std::lrintf(v);
                uint8_t u = (uint8_t)(p < 0 ? 0 : (p > 255 ? 255 : p));
                int gy0 = (oy + yy) * sy, gx0 = (ox + xx) * sx;
                for (int ry = 0; ry < sy; ++ry)
                  for (int rx = 0; rx < sx; ++rx)
                    plane[(size_t)(gy0 + ry) * pw + gx0 + rx] = u;
              }
            }
          }
        }
      }
    }
  }
  if (!ok) return -1;

  // Interleave + crop.
  for (int y = 0; y < f.h; ++y) {
    for (int ci = 0; ci < f.ncomp; ++ci) {
      const uint8_t* row = planes[ci].data() + (size_t)y * pw;
      uint8_t* dst = out + ((size_t)y * f.w) * f.ncomp + ci;
      for (int x = 0; x < f.w; ++x) dst[(size_t)x * f.ncomp] = row[x];
    }
  }
  *out_w = f.w;
  *out_h = f.h;
  *out_ncomp = f.ncomp;
  return (long long)need;
}

}  // extern "C"
