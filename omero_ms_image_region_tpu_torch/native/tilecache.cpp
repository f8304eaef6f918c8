// Sharded LRU byte cache and pixel bit ops.
//
// A copy of the JAX package's native/tilecache.cpp.  The port binds
// (native/__init__.py) tiff_lzw_decode, the TIFF reader's LZW path
// (io/tiff.py), bits_unpack_msb and the byte-cache tier (tc_*), the local
// tier of the byte caches (NativeLRUCache, services/cache.py).  The mask
// blend and the flip are compiled but not bound.
//
// C ABI only, loaded with ctypes, which drops the GIL for the duration of
// a call.  Every function is exception-free.

#include <cstdint>
#include <cstring>
#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif
#include <list>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Entry {
    std::string key;
    std::vector<uint8_t> value;
};

class Shard {
  public:
    // list front = most recent; map points into the list.
    std::mutex mu;
    std::list<Entry> lru;
    std::unordered_map<std::string, std::list<Entry>::iterator> index;
    size_t bytes = 0;
    uint64_t hits = 0, misses = 0;
};

class TileCache {
  public:
    TileCache(size_t max_bytes, unsigned n_shards)
        : max_bytes_(max_bytes),
          shards_(n_shards ? n_shards : 1) {}

    Shard& shard_for(const std::string& key) {
        return shards_[hasher_(key) % shards_.size()];
    }

    size_t shard_budget() const { return max_bytes_ / shards_.size(); }

    size_t max_bytes_;
    std::vector<Shard> shards_;
    std::hash<std::string> hasher_;
};

void evict_to_budget(Shard& s, size_t budget) {
    while (s.bytes > budget && !s.lru.empty()) {
        Entry& victim = s.lru.back();
        s.bytes -= victim.value.size();
        s.index.erase(victim.key);
        s.lru.pop_back();
    }
}

}  // namespace

extern "C" {

void* tc_create(size_t max_bytes, unsigned n_shards) {
    return new (std::nothrow) TileCache(max_bytes, n_shards);
}

void tc_destroy(void* handle) {
    delete static_cast<TileCache*>(handle);
}

int tc_put(void* handle, const char* key_data, size_t key_len,
           const uint8_t* value, size_t value_len) {
    auto* cache = static_cast<TileCache*>(handle);
    if (!cache || !key_data) return -1;
    std::string key(key_data, key_len);
    Shard& s = cache->shard_for(key);
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.index.find(key);
    if (it != s.index.end()) {
        s.bytes -= it->second->value.size();
        s.lru.erase(it->second);
        s.index.erase(it);
    }
    s.lru.push_front(Entry{key, {value, value + value_len}});
    s.index[key] = s.lru.begin();
    s.bytes += value_len;
    evict_to_budget(s, cache->shard_budget());
    return 0;
}

// Returns value length and a malloc'd copy in *out (caller frees with
// tc_free), or -1 on miss.
long long tc_get(void* handle, const char* key_data, size_t key_len,
                 uint8_t** out) {
    auto* cache = static_cast<TileCache*>(handle);
    if (!cache || !key_data || !out) return -1;
    std::string key(key_data, key_len);
    Shard& s = cache->shard_for(key);
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.index.find(key);
    if (it == s.index.end()) {
        ++s.misses;
        return -1;
    }
    ++s.hits;
    s.lru.splice(s.lru.begin(), s.lru, it->second);  // mark most-recent
    const std::vector<uint8_t>& v = it->second->value;
    uint8_t* copy = static_cast<uint8_t*>(malloc(v.size() ? v.size() : 1));
    if (!copy) return -1;
    if (!v.empty()) memcpy(copy, v.data(), v.size());
    *out = copy;
    return static_cast<long long>(v.size());
}

void tc_free(uint8_t* p) { free(p); }

uint64_t tc_hits(void* handle) {
    auto* cache = static_cast<TileCache*>(handle);
    uint64_t n = 0;
    for (Shard& s : cache->shards_) {
        std::lock_guard<std::mutex> lock(s.mu);
        n += s.hits;
    }
    return n;
}

uint64_t tc_misses(void* handle) {
    auto* cache = static_cast<TileCache*>(handle);
    uint64_t n = 0;
    for (Shard& s : cache->shards_) {
        std::lock_guard<std::mutex> lock(s.mu);
        n += s.misses;
    }
    return n;
}

uint64_t tc_size_bytes(void* handle) {
    auto* cache = static_cast<TileCache*>(handle);
    uint64_t n = 0;
    for (Shard& s : cache->shards_) {
        std::lock_guard<std::mutex> lock(s.mu);
        n += s.bytes;
    }
    return n;
}

// ---------------------------------------------------------------- bit ops

// MSB-first 1-bit unpack (ome.util.PixelData "bit" order): n output bytes
// of 0/1 from ceil(n/8) packed input bytes.
void bits_unpack_msb(const uint8_t* src, size_t n_bits, uint8_t* dst) {
    for (size_t i = 0; i < n_bits; ++i) {
        dst[i] = (src[i >> 3] >> (7 - (i & 7))) & 1;
    }
}

// TIFF-variant LZW decode (TIFF 6.0 section 13: MSB-first codes, 9-bit
// start, ClearCode 256 / EOI 257, EARLY code-width bump).  Returns the
// decoded byte count, or -1 if dst_cap would overflow / the stream is
// malformed.  The table stores (prev_code, first_byte, suffix_byte,
// length) so no per-entry allocations happen; entries are emitted by
// walking the chain backwards into the output slot.
long long tiff_lzw_decode(const uint8_t* src, size_t n,
                          uint8_t* dst, size_t dst_cap) {
    const int MAXC = 4096;
    static thread_local int prev_of[4096];
    static thread_local uint8_t suffix[4096];
    static thread_local uint8_t first[4096];
    static thread_local int length[4096];
    for (int i = 0; i < 256; ++i) {
        prev_of[i] = -1;
        suffix[i] = first[i] = static_cast<uint8_t>(i);
        length[i] = 1;
    }
    int next = 258;
    int code_bits = 9;
    uint32_t buf = 0;
    int nbits = 0;
    int prev = -1;
    size_t out = 0;
    for (size_t i = 0; i < n; ++i) {
        buf = (buf << 8) | src[i];
        nbits += 8;
        while (nbits >= code_bits) {
            nbits -= code_bits;
            int code = (buf >> nbits) & ((1 << code_bits) - 1);
            if (code == 256) {              // ClearCode
                next = 258;
                code_bits = 9;
                prev = -1;
                continue;
            }
            if (code == 257) return static_cast<long long>(out);  // EOI
            int entry;
            if (prev < 0) {
                if (code >= 256) return -1;
                entry = code;
            } else if (code < next) {
                entry = code;
                if (next < MAXC) {
                    prev_of[next] = prev;
                    suffix[next] = first[entry];
                    first[next] = first[prev];
                    length[next] = length[prev] + 1;
                    ++next;
                }
            } else if (code == next && next < MAXC) {   // KwKwK
                prev_of[next] = prev;
                suffix[next] = first[prev];
                first[next] = first[prev];
                length[next] = length[prev] + 1;
                entry = next++;
            } else {
                return -1;
            }
            const size_t len = static_cast<size_t>(length[entry]);
            if (out + len > dst_cap) return -1;
            size_t pos = out + len;
            for (int c = entry; c >= 0; c = prev_of[c]) {
                dst[--pos] = suffix[c];
            }
            out += len;
            prev = entry;
            if (next >= (1 << code_bits) - 1 && code_bits < 12) {
                ++code_bits;
            }
        }
    }
    return static_cast<long long>(out);
}

// ---- mask overlay: one tile's blend, scalar and AVX2 forms ----------
//
// (x + 127) / 255 rounds x/255 to nearest for x >= 0.  The vector form
// uses the exact divide-by-255 identity q = (x + 1 + (x >> 8)) >> 8,
// verified exhaustively over every (base, fill, alpha) u8 triple —
// note the +1: the widespread (x + (x >> 8)) >> 8 variant is off by
// one at x = 255.

static void blend_plane_scalar(const uint8_t* bp, const uint8_t* gp,
                               const uint8_t* f, uint8_t* op,
                               size_t plane) {
    const uint32_t fr = f[0], fg = f[1], fb = f[2], fa = f[3];
    for (size_t i = 0; i < plane; ++i) {
        const uint32_t a = gp[i] ? fa : 0;
        const uint32_t ia = 255 - a;
        op[4 * i + 0] =
            static_cast<uint8_t>((bp[4 * i + 0] * ia + fr * a + 127)
                                 / 255);
        op[4 * i + 1] =
            static_cast<uint8_t>((bp[4 * i + 1] * ia + fg * a + 127)
                                 / 255);
        op[4 * i + 2] =
            static_cast<uint8_t>((bp[4 * i + 2] * ia + fb * a + 127)
                                 / 255);
        op[4 * i + 3] = bp[4 * i + 3];
    }
}

#if defined(__x86_64__) || defined(__i386__)
// 8 pixels per iteration: 8 mask bytes expand to 32 alpha bytes (the
// fill alpha on color lanes, 0 on the alpha lane — a = 0 reduces the
// formula to (b*255 + 127)/255 = b, so base alpha passes through with
// no special case), then the blend runs in u16 halves.  Bit-identical
// to the scalar loop (same integer formula, exact /255 identity);
// measured 7-8x on one core — the scalar form's per-pixel select and
// division resist auto-vectorization.
__attribute__((target("avx2")))
static void blend_plane_avx2(const uint8_t* bp, const uint8_t* gp,
                             const uint8_t* f, uint8_t* op,
                             size_t plane) {
    const __m128i rep_lo = _mm_setr_epi8(0, 0, 0, -128, 1, 1, 1, -128,
                                         2, 2, 2, -128, 3, 3, 3, -128);
    const __m128i rep_hi = _mm_setr_epi8(4, 4, 4, -128, 5, 5, 5, -128,
                                         6, 6, 6, -128, 7, 7, 7, -128);
    const __m256i fav = _mm256_set1_epi8(static_cast<char>(f[3]));
    uint32_t fw;
    std::memcpy(&fw, f, 4);
    const __m256i fillv =
        _mm256_set1_epi32(static_cast<int>(fw & 0x00FFFFFFu));
    const __m256i v255 = _mm256_set1_epi16(255);
    const __m256i v127 = _mm256_set1_epi16(127);
    const __m256i one16 = _mm256_set1_epi16(1);
    const __m256i zero = _mm256_setzero_si256();
    size_t i = 0;
    for (; i + 8 <= plane; i += 8) {
        __m128i m8 = _mm_loadl_epi64(
            reinterpret_cast<const __m128i*>(gp + i));
        __m128i on = _mm_xor_si128(
            _mm_cmpeq_epi8(m8, _mm_setzero_si128()), _mm_set1_epi8(-1));
        __m256i sel = _mm256_set_m128i(_mm_shuffle_epi8(on, rep_hi),
                                       _mm_shuffle_epi8(on, rep_lo));
        __m256i av = _mm256_and_si256(sel, fav);
        __m256i bv = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(bp + 4 * i));
        __m256i a_lo = _mm256_unpacklo_epi8(av, zero);
        __m256i a_hi = _mm256_unpackhi_epi8(av, zero);
        __m256i b_lo = _mm256_unpacklo_epi8(bv, zero);
        __m256i b_hi = _mm256_unpackhi_epi8(bv, zero);
        __m256i f_lo = _mm256_unpacklo_epi8(fillv, zero);
        __m256i f_hi = _mm256_unpackhi_epi8(fillv, zero);
        __m256i x_lo = _mm256_add_epi16(
            _mm256_add_epi16(
                _mm256_mullo_epi16(b_lo, _mm256_sub_epi16(v255, a_lo)),
                _mm256_mullo_epi16(f_lo, a_lo)), v127);
        __m256i x_hi = _mm256_add_epi16(
            _mm256_add_epi16(
                _mm256_mullo_epi16(b_hi, _mm256_sub_epi16(v255, a_hi)),
                _mm256_mullo_epi16(f_hi, a_hi)), v127);
        x_lo = _mm256_srli_epi16(
            _mm256_add_epi16(_mm256_add_epi16(x_lo, one16),
                             _mm256_srli_epi16(x_lo, 8)), 8);
        x_hi = _mm256_srli_epi16(
            _mm256_add_epi16(_mm256_add_epi16(x_hi, one16),
                             _mm256_srli_epi16(x_hi, 8)), 8);
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(op + 4 * i),
                            _mm256_packus_epi16(x_lo, x_hi));
    }
    if (i < plane)
        blend_plane_scalar(bp + 4 * i, gp + i, f, op + 4 * i, plane - i);
}
#endif  // x86

// Alpha-composite B mask fills over B RGBA tiles (straight alpha,
// integer math; ≙ the BufferedImage+IndexColorModel overlay a client of
// ShapeMaskRequestHandler.java:185-203 performs).  out may alias base.
void mask_overlay_u8(const uint8_t* base, const uint8_t* grids,
                     const uint8_t* fills, uint8_t* out,
                     int B, int H, int W) {
    const size_t plane = static_cast<size_t>(H) * W;
    void (*blend)(const uint8_t*, const uint8_t*, const uint8_t*,
                  uint8_t*, size_t) = blend_plane_scalar;
#if defined(__x86_64__) || defined(__i386__)
    if (__builtin_cpu_supports("avx2")) blend = blend_plane_avx2;
#endif
#pragma omp parallel for schedule(static)
    for (int b = 0; b < B; ++b) {
        blend(base + static_cast<size_t>(b) * plane * 4,
              grids + static_cast<size_t>(b) * plane,
              fills + static_cast<size_t>(b) * 4,
              out + static_cast<size_t>(b) * plane * 4, plane);
    }
}

// Flip a packed u32 image in place-free form (the reference's CPU flip,
// ImageRegionRequestHandler.java:616-642, as a single native pass).
void flip_u32(const uint32_t* src, uint32_t* dst, int height, int width,
              int flip_horizontal, int flip_vertical) {
    for (int y = 0; y < height; ++y) {
        int sy = flip_vertical ? height - 1 - y : y;
        const uint32_t* row = src + static_cast<size_t>(sy) * width;
        uint32_t* out = dst + static_cast<size_t>(y) * width;
        if (flip_horizontal) {
            for (int x = 0; x < width; ++x) out[x] = row[width - 1 - x];
        } else {
            memcpy(out, row, static_cast<size_t>(width) * 4);
        }
    }
}

}  // extern "C"
