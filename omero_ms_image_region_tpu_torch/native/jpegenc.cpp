// Baseline JFIF entropy encoder over device-produced JPEG coefficients.
//
// A copy of the JAX package's native/jpegenc.cpp, kept byte-for-byte in its
// algorithm (ITU T.81 Annex K.2 optimal Huffman construction, canonical
// code assignment, 4:2:0 interleaved MCU scan, byte-stuffed bit packing),
// so the port's JFIF bytes equal the JAX package's for equal coefficients;
// tests/test_torch_jpeg.py asserts that equality.
//
// Replaces the serial half of the reference's CPU JPEG stage
// (LocalCompress.compressToStream, ImageRegionRequestHandler.java:580-582).
// The lossy half (DCT/quantization) runs on the card
// (../kernels/csrc/jpeg.cu).
//
// C ABI only (loaded via ctypes).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ----------------------------------------------------------- tables

const int kBaseLuma[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const int kBaseChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

void quant_tables(int quality, uint8_t qy[64], uint8_t qc[64]) {
  quality = std::max(1, std::min(100, quality));
  int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  for (int i = 0; i < 64; i++) {
    int a = (kBaseLuma[i] * scale + 50) / 100;
    int b = (kBaseChroma[i] * scale + 50) / 100;
    qy[i] = static_cast<uint8_t>(std::max(1, std::min(255, a)));
    qc[i] = static_cast<uint8_t>(std::max(1, std::min(255, b)));
  }
}

// Zigzag: flat index into a row-major 8x8 block per zigzag position,
// generated the same way as ops/jpegenc.py zigzag_order().
void zigzag_order(int zig[64]) {
  struct RC { int r, c; };
  std::vector<RC> order;
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) order.push_back({r, c});
  std::sort(order.begin(), order.end(), [](const RC& a, const RC& b) {
    int sa = a.r + a.c, sb = b.r + b.c;
    if (sa != sb) return sa < sb;
    int ka = (sa % 2 == 0) ? a.c : a.r;
    int kb = (sb % 2 == 0) ? b.c : b.r;
    return ka < kb;
  });
  for (int i = 0; i < 64; i++) zig[i] = order[i].r * 8 + order[i].c;
}

// ----------------------------------------------------------- huffman K.2

struct HuffTable {
  int bits[33] = {0};       // bits[1..16] used after limiting
  std::vector<uint8_t> huffval;
  uint32_t code_of[256] = {0};
  int len_of[256] = {0};
};

void build_huffman(const int64_t freq_in[256], HuffTable* t) {
  int64_t freq[257];
  std::memcpy(freq, freq_in, sizeof(int64_t) * 256);
  freq[256] = 1;  // reserved: no real symbol gets the all-ones code
  int codesize[257] = {0};
  int others[257];
  std::fill(others, others + 257, -1);

  for (;;) {
    // v1: smallest nonzero frequency, ties -> largest symbol value.
    int v1 = -1, v2 = -1;
    int64_t f1 = INT64_MAX, f2 = INT64_MAX;
    for (int i = 0; i < 257; i++) {
      if (freq[i] <= 0) continue;
      if (freq[i] <= f1) { f1 = freq[i]; v1 = i; }
    }
    for (int i = 0; i < 257; i++) {
      if (freq[i] <= 0 || i == v1) continue;
      if (freq[i] <= f2) { f2 = freq[i]; v2 = i; }
    }
    if (v2 < 0) break;
    freq[v1] += freq[v2];
    freq[v2] = 0;
    codesize[v1]++;
    while (others[v1] != -1) { v1 = others[v1]; codesize[v1]++; }
    others[v1] = v2;
    codesize[v2]++;
    while (others[v2] != -1) { v2 = others[v2]; codesize[v2]++; }
  }

  for (int i = 0; i < 257; i++)
    if (codesize[i] > 0) t->bits[codesize[i]]++;

  // ADJUST_BITS (figure K.3).
  int i = 32;
  while (i > 16) {
    if (t->bits[i] > 0) {
      int j = i - 2;
      while (t->bits[j] == 0) j--;
      t->bits[i] -= 2;
      t->bits[i - 1] += 1;
      t->bits[j + 1] += 2;
      t->bits[j] -= 1;
    } else {
      i--;
    }
  }
  i = 16;
  while (t->bits[i] == 0) i--;
  t->bits[i] -= 1;

  // HUFFVAL ordered by (code length, symbol value); canonical codes.
  for (int len = 1; len <= 32; len++)
    for (int s = 0; s < 256; s++)
      if (codesize[s] == len) t->huffval.push_back(static_cast<uint8_t>(s));

  uint32_t code = 0;
  size_t k = 0;
  for (int len = 1; len <= 16; len++) {
    for (int n = 0; n < t->bits[len]; n++) {
      uint8_t sym = t->huffval[k++];
      t->code_of[sym] = code;
      t->len_of[sym] = len;
      code++;
    }
    code <<= 1;
  }
}

// ----------------------------------------------------------- bit writer

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t code, int length) {
    if (length == 0) return;
    acc = (acc << length) | (code & ((1ull << length) - 1));
    nbits += length;
    while (nbits >= 8) {
      nbits -= 8;
      uint8_t byte = static_cast<uint8_t>((acc >> nbits) & 0xFF);
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0x00);
    }
    acc &= (1ull << nbits) - 1;
  }
  void flush() {
    if (nbits) {
      int pad = 8 - nbits;
      put((1u << pad) - 1, pad);
    }
  }
};

inline int category(int v) {
  unsigned a = v < 0 ? -v : v;
  int s = 0;
  while (a) { s++; a >>= 1; }
  return s;
}

inline uint32_t amplitude_bits(int v, int size) {
  return static_cast<uint32_t>(v >= 0 ? v : v + (1 << size) - 1);
}

// Per-block symbol record: DC category/value + AC (symbol, value) list.
struct BlockSyms {
  int dc_sym;
  int dc_val;
  int dc_abs;  // absolute DC (the next block's predictor)
  // packed (symbol << 16) | (value & 0xFFFF); at most 63 ACs + EOB.
  int n_ac;
  uint32_t ac[64];
};

// Sparse variant: the block is given as `n` (position, value) entries with
// strictly ascending zigzag positions — exactly what the device's
// sparse_pack emits.  Positions absent from the list are zero.  Returns
// false on a malformed buffer (n > 64, positions not strictly ascending
// or > 63) rather than trusting wire data into fixed-size arrays.
// Read the 18-bit entry at index j of the packed stream (MSB-first at
// bit 18j): 6-bit zigzag position << 12 | 12-bit two's-complement value.
// `stream` must be readable for 4 bytes from byte (18j)/8 — the encoder
// wrapper pads its host copy, so prefix fetches stay safe.
static inline uint32_t read_entry18(const uint8_t* stream, long long j) {
  long long bit = j * 18;
  const uint8_t* p = stream + (bit >> 3);
  int shift = static_cast<int>(bit & 7);
  uint32_t window = (static_cast<uint32_t>(p[0]) << 24)
                  | (static_cast<uint32_t>(p[1]) << 16)
                  | (static_cast<uint32_t>(p[2]) << 8)
                  | static_cast<uint32_t>(p[3]);
  return (window >> (32 - 18 - shift)) & 0x3FFFF;
}

static inline int entry_val(uint32_t field) {
  int v = static_cast<int>(field & 0xFFF);
  return v >= 2048 ? v - 4096 : v;
}

bool block_symbols_sparse(const uint8_t* stream, long long first, int n,
                          int pred, BlockSyms* bs,
                          int64_t* dc_freq, int64_t* ac_freq) {
  // Entries [first, first+n) of the 18-bit packed stream.
  if (n < 0 || n > 64) return false;
  int k = 0;
  int dc = 0;
  if (n > 0) {
    uint32_t f = read_entry18(stream, first);
    if ((f >> 12) == 0) { dc = entry_val(f); k = 1; }
  }
  int dc_diff = dc - pred;
  bs->dc_sym = category(dc_diff);
  bs->dc_val = dc_diff;
  bs->dc_abs = dc;
  dc_freq[bs->dc_sym]++;
  bs->n_ac = 0;
  int last = 0;
  for (; k < n; k++) {
    uint32_t f = read_entry18(stream, first + k);
    int p = static_cast<int>(f >> 12);
    if (p <= last || p > 63) return false;
    int run = p - last - 1;
    last = p;
    while (run >= 16) {
      bs->ac[bs->n_ac++] = (0xF0u << 16);
      ac_freq[0xF0]++;
      run -= 16;
    }
    int v = entry_val(f);
    uint32_t sym = (static_cast<uint32_t>(run) << 4) | category(v);
    bs->ac[bs->n_ac++] = (sym << 16) | (static_cast<uint32_t>(v) & 0xFFFF);
    ac_freq[sym]++;
  }
  if (last != 63) {
    bs->ac[bs->n_ac++] = 0;  // EOB
    ac_freq[0x00]++;
  }
  return true;
}

void block_symbols(const int16_t* block, int pred, BlockSyms* bs,
                   int64_t* dc_freq, int64_t* ac_freq) {
  int dc_diff = static_cast<int>(block[0]) - pred;
  bs->dc_sym = category(dc_diff);
  bs->dc_val = dc_diff;
  bs->dc_abs = block[0];
  dc_freq[bs->dc_sym]++;
  bs->n_ac = 0;
  int run = 0;
  int last = 0;  // index of last nonzero (1-based into block), 0 = none yet
  for (int i = 1; i < 64; i++) {
    if (block[i] == 0) continue;
    run = i - last - 1;
    last = i;
    while (run >= 16) {
      bs->ac[bs->n_ac++] = (0xF0u << 16);
      ac_freq[0xF0]++;
      run -= 16;
    }
    int v = block[i];
    uint32_t sym = (static_cast<uint32_t>(run) << 4) | category(v);
    bs->ac[bs->n_ac++] = (sym << 16) | (static_cast<uint32_t>(v) & 0xFFFF);
    ac_freq[sym]++;
  }
  if (last != 63) {
    bs->ac[bs->n_ac++] = 0;  // EOB
    ac_freq[0x00]++;
  }
}

void emit_marker(std::vector<uint8_t>& out, uint8_t tag,
                 const std::vector<uint8_t>& payload) {
  out.push_back(0xFF);
  out.push_back(tag);
  size_t n = payload.size() + 2;
  out.push_back(static_cast<uint8_t>(n >> 8));
  out.push_back(static_cast<uint8_t>(n & 0xFF));
  out.insert(out.end(), payload.begin(), payload.end());
}

// Shared framing + Huffman build + bit-packing over collected symbols.
long long emit_jfif(const std::vector<BlockSyms>& ysyms,
                    const std::vector<BlockSyms>& cbsyms,
                    const std::vector<BlockSyms>& crsyms,
                    const int64_t y_dcf[256], const int64_t y_acf[256],
                    const int64_t c_dcf[256], const int64_t c_acf[256],
                    int width, int height, int quality,
                    uint8_t* out_buf, size_t out_cap) {
  int h16 = (height + 15) / 16, w16 = (width + 15) / 16;
  int n_mcu = h16 * w16;

  uint8_t qy[64], qc[64];
  quant_tables(quality, qy, qc);
  int zig[64];
  zigzag_order(zig);

  HuffTable dc0, ac0, dc1, ac1;
  build_huffman(y_dcf, &dc0);
  build_huffman(y_acf, &ac0);
  build_huffman(c_dcf, &dc1);
  build_huffman(c_acf, &ac1);

  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(n_mcu) * 96 + 1024);
  out.push_back(0xFF); out.push_back(0xD8);  // SOI
  emit_marker(out, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  {
    std::vector<uint8_t> p(65);
    p[0] = 0;
    for (int i = 0; i < 64; i++) p[1 + i] = qy[zig[i]];
    emit_marker(out, 0xDB, p);
    p[0] = 1;
    for (int i = 0; i < 64; i++) p[1 + i] = qc[zig[i]];
    emit_marker(out, 0xDB, p);
  }
  emit_marker(out, 0xC0, {8,
      static_cast<uint8_t>(height >> 8), static_cast<uint8_t>(height & 0xFF),
      static_cast<uint8_t>(width >> 8), static_cast<uint8_t>(width & 0xFF),
      3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  const HuffTable* dht_tables[4] = {&dc0, &ac0, &dc1, &ac1};
  const int dht_cls[4] = {0, 1, 0, 1};
  const int dht_id[4] = {0, 0, 1, 1};
  for (int k = 0; k < 4; k++) {
    const HuffTable* t = dht_tables[k];
    std::vector<uint8_t> p;
    p.push_back(static_cast<uint8_t>((dht_cls[k] << 4) | dht_id[k]));
    for (int i = 1; i <= 16; i++) p.push_back(static_cast<uint8_t>(t->bits[i]));
    p.insert(p.end(), t->huffval.begin(), t->huffval.end());
    emit_marker(out, 0xC4, p);
  }
  emit_marker(out, 0xDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

  BitWriter bw(out);
  auto put_block = [&bw](const BlockSyms& bs, const HuffTable& dc,
                         const HuffTable& ac) {
    bw.put(dc.code_of[bs.dc_sym], dc.len_of[bs.dc_sym]);
    if (bs.dc_sym) bw.put(amplitude_bits(bs.dc_val, bs.dc_sym), bs.dc_sym);
    for (int i = 0; i < bs.n_ac; i++) {
      uint32_t sym = bs.ac[i] >> 16;
      int v = static_cast<int16_t>(bs.ac[i] & 0xFFFF);
      bw.put(ac.code_of[sym], ac.len_of[sym]);
      int size = sym & 0x0F;
      if (size) bw.put(amplitude_bits(v, size), size);
    }
  };
  int yi = 0;
  for (int m = 0; m < n_mcu; m++) {
    for (int k = 0; k < 4; k++) put_block(ysyms[yi++], dc0, ac0);
    put_block(cbsyms[m], dc1, ac1);
    put_block(crsyms[m], dc1, ac1);
  }
  bw.flush();
  out.push_back(0xFF); out.push_back(0xD9);  // EOI

  if (out.size() > out_cap)
    return -static_cast<long long>(out.size());
  std::memcpy(out_buf, out.data(), out.size());
  return static_cast<long long>(out.size());
}

}  // namespace

extern "C" {

// Encode one image's zigzagged raster-order coefficient blocks to JFIF.
// y: (h16*2)*(w16*2) blocks of 64 int16; cb, cr: h16*w16 blocks each,
// where h16 = ceil(height/16), w16 = ceil(width/16).  Returns the number
// of bytes written to out, or -needed if out_cap is too small, or -1 on
// invalid arguments.
long long jpeg_encode(const int16_t* y, const int16_t* cb, const int16_t* cr,
                      int width, int height, int quality,
                      uint8_t* out_buf, size_t out_cap) {
  if (width <= 0 || height <= 0 || !y || !cb || !cr || !out_buf) return -1;
  int h16 = (height + 15) / 16, w16 = (width + 15) / 16;
  int n_mcu = h16 * w16;
  int yw = w16 * 2;

  uint8_t qy[64], qc[64];
  quant_tables(quality, qy, qc);
  int zig[64];
  zigzag_order(zig);

  // Pass 1: symbols + frequencies in MCU scan order.
  std::vector<BlockSyms> ysyms(n_mcu * 4), cbsyms(n_mcu), crsyms(n_mcu);
  int64_t y_dcf[256] = {0}, y_acf[256] = {0};
  int64_t c_dcf[256] = {0}, c_acf[256] = {0};
  int ypred = 0, cbpred = 0, crpred = 0;
  int yi = 0;
  for (int my = 0; my < h16; my++) {
    for (int mx = 0; mx < w16; mx++) {
      const int yidx[4] = {
          (2 * my) * yw + 2 * mx, (2 * my) * yw + 2 * mx + 1,
          (2 * my + 1) * yw + 2 * mx, (2 * my + 1) * yw + 2 * mx + 1};
      for (int k = 0; k < 4; k++) {
        const int16_t* blk = y + static_cast<size_t>(yidx[k]) * 64;
        block_symbols(blk, ypred, &ysyms[yi++], y_dcf, y_acf);
        ypred = blk[0];
      }
      int ci = my * w16 + mx;
      const int16_t* cbb = cb + static_cast<size_t>(ci) * 64;
      const int16_t* crb = cr + static_cast<size_t>(ci) * 64;
      block_symbols(cbb, cbpred, &cbsyms[ci], c_dcf, c_acf);
      cbpred = cbb[0];
      block_symbols(crb, crpred, &crsyms[ci], c_dcf, c_acf);
      crpred = crb[0];
    }
  }

  return emit_jfif(ysyms, cbsyms, crsyms, y_dcf, y_acf, c_dcf, c_acf,
                   width, height, quality, out_buf, out_cap);
}

// Encode one image straight from the device's sparse wire buffer
// (ops/jpegenc.py sparse_pack layout: [total i32 LE | counts u8[nb] |
// packed 18-bit (pos << 12 | val) entries], blocks ordered luma raster,
// Cb raster, Cr raster).  `buf` may be a prefix fetch: any length >=
// 4 + nb + ceil(18*total/8) decodes — the caller (ctypes wrapper) pads
// its copy by 4 bytes so the 32-bit window reads at the tail stay in
// bounds.  Returns bytes written, -needed if out_cap is short, -1 on
// invalid arguments, -2 if the buffer overflowed `cap` (entries dropped;
// caller must take the dense path).
long long jpeg_encode_sparse(const uint8_t* buf, size_t buf_len,
                             int width, int height, int quality, int cap,
                             uint8_t* out_buf, size_t out_cap) {
  if (!buf || !out_buf || width <= 0 || height <= 0 || cap <= 0) return -1;
  int h16 = (height + 15) / 16, w16 = (width + 15) / 16;
  int n_mcu = h16 * w16;
  int nb_y = n_mcu * 4, nb_c = n_mcu;
  int nb = nb_y + 2 * nb_c;
  if (buf_len < 4 + static_cast<size_t>(nb)) return -1;

  int32_t total;
  std::memcpy(&total, buf, 4);
  if (total > cap) return -2;
  if (total < 0 ||
      buf_len < 4 + static_cast<size_t>(nb) +
                    (static_cast<size_t>(total) * 18 + 7) / 8) return -1;
  const uint8_t* counts = buf + 4;
  const uint8_t* stream = buf + 4 + nb;

  // Per-block entry offsets (prefix sum of counts, flat block order).
  std::vector<int> start(nb + 1);
  for (int b = 0; b < nb; b++) start[b + 1] = start[b] + counts[b];
  if (start[nb] != total) return -1;

  std::vector<BlockSyms> ysyms(nb_y), cbsyms(nb_c), crsyms(nb_c);
  int64_t y_dcf[256] = {0}, y_acf[256] = {0};
  int64_t c_dcf[256] = {0}, c_acf[256] = {0};
  int ypred = 0, cbpred = 0, crpred = 0;
  int yw = w16 * 2;
  int yi = 0;
  for (int my = 0; my < h16; my++) {
    for (int mx = 0; mx < w16; mx++) {
      const int yidx[4] = {
          (2 * my) * yw + 2 * mx, (2 * my) * yw + 2 * mx + 1,
          (2 * my + 1) * yw + 2 * mx, (2 * my + 1) * yw + 2 * mx + 1};
      for (int k = 0; k < 4; k++) {
        int b = yidx[k];
        if (!block_symbols_sparse(stream, start[b],
                                  start[b + 1] - start[b], ypred,
                                  &ysyms[yi++], y_dcf, y_acf))
          return -1;
        ypred = ysyms[yi - 1].dc_abs;
      }
      int ci = my * w16 + mx;
      int b = nb_y + ci;
      if (!block_symbols_sparse(stream, start[b],
                                start[b + 1] - start[b], cbpred,
                                &cbsyms[ci], c_dcf, c_acf))
        return -1;
      cbpred = cbsyms[ci].dc_abs;
      b = nb_y + nb_c + ci;
      if (!block_symbols_sparse(stream, start[b],
                                start[b + 1] - start[b], crpred,
                                &crsyms[ci], c_dcf, c_acf))
        return -1;
      crpred = crsyms[ci].dc_abs;
    }
  }
  return emit_jfif(ysyms, cbsyms, crsyms, y_dcf, y_acf, c_dcf, c_acf,
                   width, height, quality, out_buf, out_cap);
}

}  // extern "C"
