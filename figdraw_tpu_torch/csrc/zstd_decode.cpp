// Zstandard (RFC 8878) decoding of a TIFF ZSTD strip as libtiff 4.7.1's
// ZSTDDecode reads it through libzstd's streaming decoder, host C++ built
// with g++ by figdraw_tpu_torch/utils/image_lib.py (load_zstd) and bound
// through ctypes by utils/zstd.py, whose decompress_plain is the twin and
// says what is read: one frame, blocks until the strip's bytes are out
// (and one more when they end on a block), every fault libzstd reports.
//
//   fd_zstd_decompress  data[0..len) -> out[0..limit): returns the bytes
//                       written (fewer than limit where the frame ends or
//                       the data is cut first), -1 for corrupt data, -2 for
//                       a dictionary, -3 for a window over 2^27 + 1 bytes,
//                       -4 for a content checksum that does not match.
//
// The frame's output is kept whole (matches reach back into it), in a
// buffer grown as the blocks come; nothing else is allocated.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { kCorrupt = -1, kDictionary = -2, kWindow = -3, kChecksum = -4 };
constexpr uint32_t kMagic = 0xFD2FB528u, kSkippable = 0x184D2A50u;
constexpr int64_t kBlockMax = 128 * 1024;
constexpr uint64_t kWindowMax = (1ull << 27) + 1;

struct Fail {
    int code;
};

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }
inline uint32_t le32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t le64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }

// ---- XXH64 ----
constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;
inline uint64_t rotl(uint64_t v, int r) { return (v << r) | (v >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, int64_t n) {
    const uint8_t* const end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
        for (; p + 32 <= end; p += 32)
            for (int k = 0; k < 4; ++k) v[k] = xround(v[k], le64(p + 8 * k));
        h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
        for (int k = 0; k < 4; ++k) h = (h ^ xround(0, v[k])) * P1 + P4;
    } else {
        h = P5;
    }
    h += (uint64_t)n;
    for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl(h ^ (uint64_t)le32(p) * P1, 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; ++p) h = rotl(h ^ (uint64_t)(*p) * P5, 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    return h ^ (h >> 32);
}

// ---- a backward bitstream: from the last byte's marker bit down to bit 0
// of the first; bits past the start read as zeros (overflow) ----
struct Backward {
    const uint8_t* data;
    int64_t pos;  // bits left; negative after an overflow

    Backward(const uint8_t* d, int64_t n) : data(d) {
        if (n <= 0 || d[n - 1] == 0) throw Fail{kCorrupt};
        pos = 8 * (n - 1) + highbit(d[n - 1]);
    }
    // the `n` (<= 25) bits below pos, as a number
    uint32_t look(int n) const {
        const int64_t lo = pos - n;
        uint64_t v = 0;
        if (lo >= 0) {
            const int64_t first = lo >> 3, last = (pos - 1) >> 3;
            for (int64_t i = last; i >= first; --i) v = (v << 8) | data[i];
            return (uint32_t)((v >> (lo & 7)) & ((1ull << n) - 1));
        }
        if (pos <= 0) return 0;
        for (int64_t i = (pos - 1) >> 3; i >= 0; --i) v = (v << 8) | data[i];
        return (uint32_t)((v << -lo) & ((1ull << n) - 1));
    }
    uint32_t read(int n) {
        if (n == 0) return 0;
        const uint32_t v = look(n);
        pos -= n;
        return v;
    }
};

// ---- FSE ----
struct FseEntry {
    uint16_t symbol;
    uint8_t bits;
    uint16_t base;
};
struct Fse {
    FseEntry t[512];
    int log = 0;
    bool set = false;
};

// an FSE table description: counts (-1 for "less than 1"), its accuracy
// log; returns the bytes read
int64_t read_ncount(const uint8_t* d, int64_t n, int max_symbol, int max_log, int16_t* counts,
                    int* nsym, int* log_out) {
    uint8_t buf[1032] = {0};
    const int64_t have = n < 1024 ? n : 1024;  // a description is shorter
    std::memcpy(buf, d, (size_t)have);
    int64_t pos = 0;
    auto take = [&](int k) -> uint32_t {
        uint64_t v = 0;
        const int64_t b = pos >> 3;
        for (int i = 3; i >= 0; --i) v = (v << 8) | (b + i < 1032 ? buf[b + i] : 0);
        return (uint32_t)((v >> (pos & 7)) & ((1u << k) - 1));
    };
    const int log = (int)take(4) + 5;
    pos += 4;
    if (log > max_log) throw Fail{kCorrupt};
    int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, k = 0;
    bool previous0 = false;
    for (;;) {
        if (pos > 8 * 1024) throw Fail{kCorrupt};
        if (previous0) {
            for (;;) {
                const int rep = (int)take(2);
                pos += 2;
                for (int i = 0; i < rep; ++i) {
                    if (k > max_symbol + 1) throw Fail{kCorrupt};
                    counts[k++] = 0;
                }
                if (rep < 3) break;
            }
            if (k > max_symbol) break;
        }
        const int mx = 2 * threshold - 1 - remaining;
        const int v = (int)take(nbits);
        int count;
        if ((v & (threshold - 1)) < mx) {
            count = v & (threshold - 1);
            pos += nbits - 1;
        } else {
            count = v & (2 * threshold - 1);
            if (count >= threshold) count -= mx;
            pos += nbits;
        }
        --count;
        remaining -= count < 0 ? -count : count;
        counts[k++] = (int16_t)count;
        previous0 = count == 0;
        if (remaining < threshold) {
            if (remaining <= 1) break;
            nbits = highbit((uint32_t)remaining) + 1;
            threshold = 1 << (nbits - 1);
        }
        if (k > max_symbol) break;
    }
    if (remaining != 1 || k > max_symbol + 1) throw Fail{kCorrupt};
    const int64_t used = (pos + 7) >> 3;
    if (used > n) throw Fail{kCorrupt};
    *nsym = k;
    *log_out = log;
    return used;
}

void build_fse(const int16_t* counts, int nsym, int log, Fse* f) {
    const int size = 1 << log;
    uint16_t symbols[512];
    uint16_t next[258];
    int high = size - 1;
    for (int s = 0; s < nsym; ++s) {
        if (counts[s] == -1) {
            symbols[high--] = (uint16_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint16_t)counts[s];
        }
    }
    const int step = (size >> 1) + (size >> 3) + 3;
    int pos = 0;
    for (int s = 0; s < nsym; ++s)
        for (int i = 0; i < counts[s]; ++i) {
            symbols[pos] = (uint16_t)s;
            pos = (pos + step) & (size - 1);
            while (pos > high) pos = (pos + step) & (size - 1);
        }
    if (pos != 0) throw Fail{kCorrupt};
    for (int u = 0; u < size; ++u) {
        const int s = symbols[u];
        const int state = next[s]++;
        const int nb = log - highbit((uint32_t)state);
        f->t[u] = FseEntry{(uint16_t)s, (uint8_t)nb, (uint16_t)((state << nb) - size)};
    }
    f->log = log;
    f->set = true;
}

// ---- Huffman ----
struct Huffman {
    uint8_t symbol[1 << 12];
    uint8_t bits[1 << 12];
    int max_bits = 0;
    bool set = false;
};

// Huffman weights coded with FSE: two interleaved states until overflow
int fse_weights(const uint8_t* d, int64_t n, uint8_t* out) {
    int16_t counts[258];
    int nsym, log;
    const int64_t used = read_ncount(d, n, 255, 6, counts, &nsym, &log);
    Fse f;
    build_fse(counts, nsym, log, &f);
    Backward b(d + used, n - used);
    uint32_t st[2];
    st[0] = b.read(log);
    st[1] = b.read(log);
    int k = 0;
    for (;;) {
        for (int a = 0; a < 2; ++a) {
            if (k > 253) throw Fail{kCorrupt};
            const FseEntry& e = f.t[st[a]];
            out[k++] = (uint8_t)e.symbol;
            st[a] = e.base + b.read(e.bits);
            if (b.pos < 0) {
                out[k++] = (uint8_t)f.t[st[1 - a]].symbol;
                return k;
            }
        }
    }
}

int64_t read_huffman(const uint8_t* d, int64_t n, Huffman* h) {
    if (n < 1) throw Fail{kCorrupt};
    uint8_t w[256];
    int count;
    int64_t size;
    const int head = d[0];
    if (head >= 128) {
        count = head - 127;
        size = (count + 1) / 2;
        if (size + 1 > n) throw Fail{kCorrupt};
        for (int i = 0; i < count; ++i) {
            const uint8_t b = d[1 + i / 2];
            w[i] = (i % 2 == 0) ? (uint8_t)(b >> 4) : (uint8_t)(b & 15);
        }
    } else {
        size = head;
        if (size + 1 > n) throw Fail{kCorrupt};
        count = fse_weights(d + 1, size, w);
    }
    uint32_t total = 0;
    int ranks[13] = {0};
    for (int i = 0; i < count; ++i) {
        if (w[i] > 12) throw Fail{kCorrupt};
        ranks[w[i]]++;
        total += (1u << w[i]) >> 1;
    }
    if (total == 0) throw Fail{kCorrupt};
    const int max_bits = highbit(total) + 1;
    if (max_bits > 12) throw Fail{kCorrupt};
    const uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1)) throw Fail{kCorrupt};
    const int last = highbit(rest) + 1;
    w[count++] = (uint8_t)last;
    ranks[last]++;
    if (ranks[1] < 2 || (ranks[1] & 1)) throw Fail{kCorrupt};
    int pos = 0;
    for (int wt = 1; wt <= max_bits; ++wt)
        for (int s = 0; s < count; ++s)
            if (w[s] == wt) {
                const int span = (1 << wt) >> 1;
                for (int i = 0; i < span; ++i) {
                    h->symbol[pos + i] = (uint8_t)s;
                    h->bits[pos + i] = (uint8_t)(max_bits + 1 - wt);
                }
                pos += span;
            }
    h->max_bits = max_bits;
    h->set = true;
    return size + 1;
}

// n symbols of the Huffman stream buf[lo, hi) into out, from bit position
// pos (its start if negative); bits below buf[lo] read as zeros. Returns
// the bit position it ends at.
int64_t decode_huffman(const uint8_t* buf, int64_t lo, int64_t hi, int64_t n, const Huffman& h,
                       int64_t pos, uint8_t* out) {
    if (pos < 0) {
        if (hi <= lo || buf[hi - 1] == 0) throw Fail{kCorrupt};
        pos = 8 * (hi - 1) + highbit(buf[hi - 1]);
    }
    const int64_t base = 8 * lo;
    const int mb = h.max_bits;
    const uint32_t mask = (1u << mb) - 1;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t low = pos - mb;
        uint64_t v = 0;
        if (low >= base) {
            for (int64_t k = (pos - 1) >> 3; k >= (low >> 3); --k) v = (v << 8) | buf[k];
            v >>= (low & 7);
        } else if (pos > base) {
            for (int64_t k = (pos - 1) >> 3; k >= (base >> 3); --k) v = (v << 8) | buf[k];
            v = (v >> (base & 7)) << (base - low);
        }
        const uint32_t idx = (uint32_t)v & mask;
        out[i] = h.symbol[idx];
        pos -= h.bits[idx];
    }
    return pos;
}

// four Huffman streams after their jump table, as utils/zstd.py's
// decode_streams says: libzstd's fast loop where it runs, else each stream
// used up exactly
void decode_streams(const uint8_t* src, int64_t slen, int64_t size, const Huffman& h,
                    uint8_t* out) {
    if (slen < 10) throw Fail{kCorrupt};
    const int64_t l1 = src[0] | (src[1] << 8), l2 = src[2] | (src[3] << 8),
                  l3 = src[4] | (src[5] << 8);
    if (6 + l1 + l2 + l3 > slen) throw Fail{kCorrupt};
    const int64_t per = (size + 3) / 4;
    const int64_t cuts[5] = {6, 6 + l1, 6 + l1 + l2, 6 + l1 + l2 + l3, slen};
    const int64_t counts[4] = {per, per, per, size - 3 * per};
    bool fast = h.max_bits <= 11 && 3 * per < size;
    for (int k = 0; k < 4; ++k) fast = fast && cuts[k + 1] - cuts[k] >= 8;
    if (!fast) {
        for (int k = 0; k < 4; ++k)
            if (decode_huffman(src, cuts[k], cuts[k + 1], counts[k], h, -1, out + k * per) !=
                8 * cuts[k])
                throw Fail{kCorrupt};
        return;
    }
    int64_t ip[4], used[4] = {0, 0, 0, 0}, pos[4];
    for (int k = 0; k < 4; ++k) {  // a last byte of 0 has no end mark: all its bits are read
        const uint8_t last = src[cuts[k + 1] - 1];
        ip[k] = cuts[k + 1] - 8;
        pos[k] = 8 * (cuts[k + 1] - 1) + (last ? highbit(last) : 8);
    }
    for (;;) {
        int64_t iters = (size - 3 * per - used[3]) / 5;
        if (ip[0] / 7 < iters) iters = ip[0] / 7;
        if (iters == 0 || ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
        for (int64_t it = 0; it < iters; ++it)
            for (int k = 0; k < 4; ++k) {
                pos[k] = decode_huffman(src, 0, 0, 5, h, pos[k], out + k * per + used[k]);
                used[k] += 5;
                ip[k] -= (8 * (ip[k] + 8) - pos[k]) >> 3;
            }
    }
    for (int k = 0; k < 4; ++k) {
        if (ip[k] < cuts[k] - 8) throw Fail{kCorrupt};
        decode_huffman(src, 0, 0, counts[k] - used[k], h, pos[k], out + k * per + used[k]);
    }
}

// ---- sequences ----
const uint32_t kLLBase[36] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                              4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
                              20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
                              35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                              1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Seq {
    uint32_t lit, value, match;
};

struct Frame {
    const uint8_t* d;
    int64_t len, limit;
    std::vector<uint8_t> out;
    Huffman huff;
    Fse ll, of, ml;
    uint64_t reps[3] = {1, 4, 8};
    std::vector<uint8_t> lits;
    std::vector<Seq> seqs;

    // the literals section; returns its size
    int64_t literals(const uint8_t* b, int64_t n, int64_t block_max) {
        if (n < 2) throw Fail{kCorrupt};
        const int kind = b[0] & 3, fmt = (b[0] >> 2) & 3;
        int64_t size, head;
        if (kind < 2) {
            if (fmt == 0 || fmt == 2) {
                size = b[0] >> 3;
                head = 1;
            } else if (fmt == 1) {
                size = (b[0] >> 4) + (b[1] << 4);
                head = 2;
            } else {
                if (n < 3) throw Fail{kCorrupt};
                size = (b[0] >> 4) + (b[1] << 4) + ((int64_t)b[2] << 12);
                head = 3;
            }
            if (size > block_max) throw Fail{kCorrupt};
            lits.resize((size_t)size);
            if (kind == 0) {
                if (head + size > n) throw Fail{kCorrupt};
                if (size) std::memcpy(lits.data(), b + head, (size_t)size);
                return head + size;
            }
            if (head + 1 > n) throw Fail{kCorrupt};
            if (size) std::memset(lits.data(), b[head], (size_t)size);
            return head + 1;
        }
        head = fmt == 0 || fmt == 1 ? 3 : fmt == 2 ? 4 : 5;
        if (n < 5) throw Fail{kCorrupt};
        const uint64_t v = (uint64_t)le32(b) | ((uint64_t)b[4] << 32);
        int64_t csize;
        if (head == 3) {
            size = (v >> 4) & 0x3FF;
            csize = (v >> 14) & 0x3FF;
        } else if (head == 4) {
            size = (v >> 4) & 0x3FFF;
            csize = (v >> 18) & 0x3FFF;
        } else {
            size = (v >> 4) & 0x3FFFF;
            csize = (v >> 22) & 0x3FFFF;
        }
        const int streams = fmt == 0 ? 1 : 4;
        if (size > block_max || head + csize > n) throw Fail{kCorrupt};
        if (streams == 4 && size < 6) throw Fail{kCorrupt};
        const uint8_t* src = b + head;
        int64_t slen = csize;
        if (kind == 2) {
            const int64_t used = read_huffman(src, slen, &huff);
            src += used;
            slen -= used;
        } else if (!huff.set) {
            throw Fail{kCorrupt};
        }
        lits.resize((size_t)size);
        if (streams == 1) {
            if (decode_huffman(src, 0, slen, size, huff, -1, lits.data()) != 0)
                throw Fail{kCorrupt};
        } else {
            decode_streams(src, slen, size, huff, lits.data());
        }
        return head + csize;
    }

    void table(int mode, const uint8_t* b, int64_t n, int64_t* pos, Fse* f, const int16_t* dflt,
               int dflt_n, int dflt_log, int max_symbol, int max_log) {
        if (mode == 0) {
            build_fse(dflt, dflt_n, dflt_log, f);
        } else if (mode == 1) {
            if (*pos >= n || b[*pos] > max_symbol) throw Fail{kCorrupt};
            f->t[0] = FseEntry{b[*pos], 0, 0};
            f->log = 0;
            f->set = true;
            *pos += 1;
        } else if (mode == 2) {
            int16_t counts[260];
            int nsym, log;
            *pos += read_ncount(b + *pos, n - *pos, max_symbol, max_log, counts, &nsym, &log);
            build_fse(counts, nsym, log, f);
        } else if (!f->set) {
            throw Fail{kCorrupt};
        }
    }

    void sequences(const uint8_t* b, int64_t n) {
        seqs.clear();
        if (n < 1) throw Fail{kCorrupt};
        int64_t count = b[0], pos = 1;
        if (count == 0) {
            if (n != 1) throw Fail{kCorrupt};
            return;
        }
        if (count >= 128) {
            if (count < 255) {
                if (n < 2) throw Fail{kCorrupt};
                count = ((count - 128) << 8) + b[1];
                pos = 2;
            } else {
                if (n < 3) throw Fail{kCorrupt};
                count = b[1] + (b[2] << 8) + 0x7F00;
                pos = 3;
            }
        }
        if (pos >= n) throw Fail{kCorrupt};
        const int modes = b[pos++];
        if (modes & 3) throw Fail{kCorrupt};
        table(modes >> 6, b, n, &pos, &ll, kLLDefault, 36, 6, 35, 9);
        table((modes >> 4) & 3, b, n, &pos, &of, kOFDefault, 29, 5, 31, 8);
        table((modes >> 2) & 3, b, n, &pos, &ml, kMLDefault, 53, 6, 52, 9);
        Backward bits(b + pos, n - pos);
        uint32_t ls = bits.read(ll.log), os = bits.read(of.log), ms = bits.read(ml.log);
        seqs.resize((size_t)count);
        for (int64_t i = 0; i < count; ++i) {
            const int lc = ll.t[ls].symbol, oc = of.t[os].symbol, mc = ml.t[ms].symbol;
            if (lc > 35 || mc > 52 || oc > 31) throw Fail{kCorrupt};
            Seq& s = seqs[(size_t)i];
            s.value = (1u << oc) + bits.read(oc);
            s.match = kMLBase[mc] + bits.read(kMLBits[mc]);
            s.lit = kLLBase[lc] + bits.read(kLLBits[lc]);
            if (i < count - 1) {
                ls = ll.t[ls].base + bits.read(ll.t[ls].bits);
                ms = ml.t[ms].base + bits.read(ml.t[ms].bits);
                os = of.t[os].base + bits.read(of.t[os].bits);
            }
        }
        if (bits.pos != 0) throw Fail{kCorrupt};
    }

    void execute(int64_t block_max) {
        const int64_t start = (int64_t)out.size();
        int64_t lp = 0;
        const int64_t nlits = (int64_t)lits.size();
        for (const Seq& s : seqs) {
            uint64_t offset;
            if (s.value > 3) {
                offset = s.value - 3;
                reps[2] = reps[1];
                reps[1] = reps[0];
                reps[0] = offset;
            } else {
                const int idx = (int)s.value - 1 + (s.lit == 0);
                if (idx == 0) {
                    offset = reps[0];
                } else if (idx == 3) {
                    offset = reps[0] - 1;
                    reps[2] = reps[1];
                    reps[1] = reps[0];
                    reps[0] = offset;
                } else {
                    offset = reps[idx];
                    if (idx == 2) reps[2] = reps[1];
                    reps[1] = reps[0];
                    reps[0] = offset;
                }
            }
            if (lp + (int64_t)s.lit > nlits) throw Fail{kCorrupt};
            out.insert(out.end(), lits.begin() + lp, lits.begin() + lp + s.lit);
            lp += s.lit;
            const int64_t have = (int64_t)out.size();
            if (offset == 0 || offset > (uint64_t)have) throw Fail{kCorrupt};
            if (have - start + (int64_t)s.match > block_max) throw Fail{kCorrupt};
            out.resize((size_t)(have + s.match));
            uint8_t* o = out.data() + have;
            const uint8_t* src = o - offset;
            for (uint32_t i = 0; i < s.match; ++i) o[i] = src[i];
        }
        out.insert(out.end(), lits.begin() + lp, lits.end());
        if ((int64_t)out.size() - start > block_max) throw Fail{kCorrupt};
    }

    int64_t run() {
        if (len < 4) return 0;
        const uint32_t magic = le32(d);
        if ((magic & 0xFFFFFFF0u) == kSkippable) return 0;
        if (magic != kMagic) throw Fail{kCorrupt};
        if (len < 6) return 0;
        const int desc = d[4];
        const int fcs_flag = desc >> 6, single = (desc >> 5) & 1, checksum = (desc >> 2) & 1,
                  did_flag = desc & 3;
        if (desc & 8) throw Fail{kCorrupt};
        int64_t pos = 5;
        uint64_t window = 0;
        if (!single) {
            const int wd = d[pos++];
            const int wlog = 10 + (wd >> 3);
            window = (1ull << wlog) + ((1ull << wlog) >> 3) * (uint64_t)(wd & 7);
        }
        const int did_size = did_flag == 3 ? 4 : did_flag;
        const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : 1 << fcs_flag;
        if (pos + did_size + fcs_size > len) return 0;
        uint64_t did = 0, fcs = 0;
        for (int i = did_size - 1; i >= 0; --i) did = (did << 8) | d[pos + i];
        pos += did_size;
        const bool has_fcs = fcs_size > 0;
        if (has_fcs) {
            for (int i = fcs_size - 1; i >= 0; --i) fcs = (fcs << 8) | d[pos + i];
            if (fcs_size == 2) fcs += 256;
            pos += fcs_size;
        }
        if (single) window = fcs;
        if (did) throw Fail{kDictionary};
        if (window > kWindowMax) throw Fail{kWindow};
        const int64_t block_max = (int64_t)(window < (uint64_t)kBlockMax ? window : kBlockMax);
        bool one_more = false;
        for (;;) {
            if (pos + 3 > len) return (int64_t)out.size();
            const uint32_t bh = d[pos] | (d[pos + 1] << 8) | (d[pos + 2] << 16);
            pos += 3;
            const int last = bh & 1, btype = (bh >> 1) & 3;
            const int64_t bsize = bh >> 3;
            if (btype == 3) throw Fail{kCorrupt};
            if (bsize > block_max || (btype == 2 && bsize >= kBlockMax)) throw Fail{kCorrupt};
            if (btype == 1) {
                if (pos + 1 > len) return (int64_t)out.size();
                out.insert(out.end(), (size_t)bsize, d[pos]);
                pos += 1;
            } else {
                if (pos + bsize > len) return (int64_t)out.size();
                if (btype == 0) {
                    out.insert(out.end(), d + pos, d + pos + bsize);
                } else {
                    const int64_t used = literals(d + pos, bsize, block_max);
                    sequences(d + pos + used, bsize - used);
                    execute(block_max);
                }
                pos += bsize;
            }
            const int64_t total = (int64_t)out.size();
            if (has_fcs && (uint64_t)total > fcs) throw Fail{kCorrupt};
            if (last) {
                if (has_fcs && (uint64_t)total != fcs) throw Fail{kCorrupt};
                if (checksum && total <= limit) {
                    if (pos + 4 > len) return total;
                    if (le32(d + pos) != (uint32_t)xxh64(out.data(), total)) throw Fail{kChecksum};
                }
                return total;
            }
            if (one_more || total > limit) return total;
            one_more = total == limit;
        }
    }
};

}  // namespace

extern "C" {

int64_t fd_zstd_decompress(const uint8_t* data, int64_t len, uint8_t* out, int64_t limit) {
    Frame f;
    f.d = data;
    f.len = len;
    f.limit = limit;
    int64_t got;
    try {
        got = f.run();
    } catch (const Fail& e) {
        return e.code;
    } catch (...) {
        return kCorrupt;
    }
    if (got > limit) got = limit;
    if (got > 0) std::memcpy(out, f.out.data(), (size_t)got);
    return got;
}

}  // extern "C"
