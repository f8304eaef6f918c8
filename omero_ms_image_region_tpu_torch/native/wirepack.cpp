// Packed host->device staging: block bit-packed zigzag row deltas.
//
// A copy of the JAX package's native/wirepack.cpp, byte for byte the same
// output.  Microscopy content is smooth signal plus sensor noise: row
// deltas cost ~11.5 bits a sample instead of 16, and a FIXED width per
// block of 32 samples keeps the decode parallel on the device (a gather,
// a shift and a row scan; no sequential entropy decode).
//
// Layout, per row of `width` samples, blocks of 32 along the row:
//   widths[r*bpr + b] = w  (bits per sample in block b; 0..17)
//   payload: each block occupies exactly 32*w bits (partial edge
//   blocks pad with zero samples), samples LSB-first at bit
//   offset(block) + j*w, where offset = 32 * cumsum(widths).
// Sample encoding: zigzag(delta) with delta[0] = row[0] (absolute).
//
// The device inverse is K10, kernels/csrc/staging.cu (unpack16_kernel);
// its plain version is io/staging.py::unpack16_plain.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Returns words written, or -1 if words_cap is too small.
long long wirepack_pack16(const uint16_t* src, long long n_rows,
                          int width, uint8_t* widths_out,
                          uint32_t* words_out, long long words_cap) {
    if (width <= 0 || n_rows < 0) return -1;
    const int bpr = (width + 31) / 32;
    uint64_t accum = 0;
    int nbits = 0;
    long long w_idx = 0;
    for (long long r = 0; r < n_rows; ++r) {
        const uint16_t* row = src + r * width;
        for (int b = 0; b < bpr; ++b) {
            const int c0 = b * 32;
            const int c1 = std::min(c0 + 32, width);
            uint32_t zz[32];
            uint32_t all = 0;
            for (int c = c0; c < c1; ++c) {
                const int32_t d = (c == 0)
                    ? (int32_t)row[c]
                    : (int32_t)row[c] - (int32_t)row[c - 1];
                const uint32_t z = (d >= 0)
                    ? ((uint32_t)d << 1)
                    : (((uint32_t)(-d) << 1) - 1);
                zz[c - c0] = z;
                all |= z;
            }
            int w = 0;
            while (all >> w) ++w;                 // bit length of max
            widths_out[r * bpr + b] = (uint8_t)w;
            if (w == 0) continue;                 // block contributes 0 bits
            for (int j = 0; j < 32; ++j) {
                const uint32_t z = (j < c1 - c0) ? zz[j] : 0;
                accum |= (uint64_t)z << nbits;
                nbits += w;
                if (nbits >= 32) {
                    if (w_idx >= words_cap) return -1;
                    words_out[w_idx++] = (uint32_t)accum;
                    accum >>= 32;
                    nbits -= 32;
                }
            }
        }
    }
    if (nbits > 0) {
        if (w_idx >= words_cap) return -1;
        words_out[w_idx++] = (uint32_t)accum;
    }
    return w_idx;
}

}  // extern "C"
