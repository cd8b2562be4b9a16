// Brotli (RFC 7932) decoding as libbrotlidec 1.2.0 reads a whole stream,
// host C++ built with g++ by figdraw_tpu_torch/utils/image_lib.py
// (load_brotli) and bound through ctypes by utils/brotli.py, whose
// decompress_plain is the twin and says what is read: the stream header,
// meta-block headers (uncompressed and metadata ones too), simple and
// complex prefix codes checked as libbrotlidec checks them, block types and
// counts, context modes and maps, insert-and-copy commands, the distance
// ring, and static-dictionary words with their transforms.
//
//   fd_brotli_decompress  data[0..len) with the static dictionary `dict`
//                         (utils/brotli_dictionary.bin) -> out[0..cap):
//                         returns the decoded size (only the first cap
//                         bytes are written when it is more), -1 for a
//                         corrupt stream (and a command that reads no bit
//                         and writes no byte, which would repeat without
//                         end), -2 for one that ends early, -3 for input
//                         left after the last meta-block.
//
// The transforms, the dictionary's word offsets and the context lookup
// come from csrc/brotli_tables.h (tools/make_brotli_tables.py).

#include <cstdint>
#include <cstring>
#include <vector>

#include "brotli_tables.h"

namespace {

enum { kCorrupt = -1, kTruncated = -2, kTrailing = -3 };
constexpr int kWindowGap = 16;
constexpr int64_t kMaxDistance = 0x7FFFFFFC;

struct Fail {
    int code;
};

[[noreturn]] inline void fail(int code = kCorrupt) { throw Fail{code}; }

// the stream's bits, LSB first, through a 64-bit window (zeros past the
// end); consuming a bit past the end fails
struct Bits {
    const uint8_t* d;
    int64_t n, next = 0;
    uint64_t buf = 0;
    int nbuf = 0;

    Bits(const uint8_t* data, int64_t len) : d(data), n(len) {}
    inline int64_t pos() const { return 8 * next - nbuf; }
    inline uint32_t peek(int k) {
        while (nbuf <= 56) {
            buf |= (uint64_t)(next < n ? d[next] : 0) << nbuf;
            ++next;
            nbuf += 8;
        }
        return (uint32_t)(buf & ((1ull << k) - 1));
    }
    inline void skip(int k) {
        buf >>= k;
        nbuf -= k;
        if (8 * next - nbuf > 8 * n) fail(kTruncated);
    }
    inline uint32_t read(int k) {
        const uint32_t v = peek(k);
        skip(k);
        return v;
    }
    // BrotliJumpToByteBoundary: the pad bits must be 0
    void align() {
        if (read(nbuf % 8)) fail();
    }
    // k whole bytes from a byte boundary
    const uint8_t* take(int64_t k) {
        const int64_t at = pos() / 8;
        if (k > n - at) fail(kTruncated);
        buf = 0;
        nbuf = 0;
        next = at + k;
        return d + at;
    }
};

// a prefix code read LSB first: a root table of the first 8 bits, and for
// codes longer than that a second-level table under their root entry
struct Code {
    struct Entry {
        uint16_t value;  // the symbol, or a root entry's subtable offset
        uint8_t len;     // bits consumed at this level
        uint8_t sub;     // a root entry's subtable bits (0: a symbol)
    };
    std::vector<Entry> t;

    void single(int sym) { t.assign(256, Entry{(uint16_t)sym, 0, 0}); }

    // a complete code of `size` lengths (the caller checked it)
    void build(const uint8_t* lengths, int size) {
        int count[16] = {0}, next[16] = {0};
        for (int s = 0; s < size; ++s) ++count[lengths[s]];
        count[0] = 0;
        for (int ln = 1, code = 0; ln < 16; ++ln) {
            code = (code + count[ln - 1]) << 1;
            next[ln] = code;
        }
        std::vector<uint16_t> rev(size, 0);
        int slot_max[256] = {0};
        for (int s = 0; s < size; ++s) {
            const int ln = lengths[s];
            if (!ln) continue;
            const int c = next[ln]++;
            int r = 0;
            for (int b = 0; b < ln; ++b) r |= ((c >> b) & 1) << (ln - 1 - b);
            rev[s] = (uint16_t)r;
            if (ln > 8 && ln > slot_max[r & 255]) slot_max[r & 255] = ln;
        }
        t.assign(256, Entry{0, 0, 0});
        for (int slot = 0; slot < 256; ++slot)
            if (slot_max[slot]) {
                const int sub = slot_max[slot] - 8;
                t[slot] = Entry{(uint16_t)t.size(), 8, (uint8_t)sub};
                t.resize(t.size() + ((size_t)1 << sub), Entry{0, 0, 0});
            }
        for (int s = 0; s < size; ++s) {
            const int ln = lengths[s];
            if (!ln) continue;
            if (ln <= 8) {
                for (int k = rev[s]; k < 256; k += 1 << ln) t[k] = Entry{(uint16_t)s, (uint8_t)ln, 0};
            } else {
                const Entry root = t[rev[s] & 255];
                for (int k = rev[s] >> 8; k < (1 << root.sub); k += 1 << (ln - 8))
                    t[root.value + k] = Entry{(uint16_t)s, (uint8_t)(ln - 8), 0};
            }
        }
    }

    inline int read(Bits& br) const {
        const uint32_t v = br.peek(15);
        const Entry& e = t[v & 255];
        if (!e.sub) {
            br.skip(e.len);
            return e.value;
        }
        const Entry& e2 = t[e.value + ((v >> 8) & ((1u << e.sub) - 1))];
        br.skip(8 + e2.len);
        return e2.value;
    }
};

struct Len {
    int base, extra;
};
constexpr Len kInsert[24] = {{0, 0},     {1, 0},     {2, 0},    {3, 0},    {4, 0},    {5, 0},
                             {6, 1},     {8, 1},     {10, 2},   {14, 2},   {18, 3},   {26, 3},
                             {34, 4},    {50, 4},    {66, 5},   {98, 5},   {130, 6},  {194, 7},
                             {322, 8},   {578, 9},   {1090, 10}, {2114, 12}, {6210, 14},
                             {22594, 24}};
constexpr Len kCopy[24] = {{2, 0},   {3, 0},   {4, 0},   {5, 0},   {6, 0},    {7, 0},
                           {8, 0},   {9, 0},   {10, 1},  {12, 1},  {14, 2},   {18, 2},
                           {22, 3},  {30, 3},  {38, 4},  {54, 4},  {70, 5},   {102, 5},
                           {134, 6}, {198, 7}, {326, 8}, {582, 9}, {1094, 10}, {2118, 24}};
constexpr int kCells[11][2] = {{0, 0}, {0, 8},  {0, 0},  {0, 8},  {8, 0},  {8, 8},
                               {0, 16}, {16, 0}, {8, 16}, {16, 8}, {16, 16}};
constexpr Len kBlockLength[26] = {
    {1, 2},    {5, 2},    {9, 2},    {13, 2},    {17, 3},    {25, 3},    {33, 3},
    {41, 3},   {49, 4},   {65, 4},   {81, 4},    {97, 4},    {113, 5},   {145, 5},
    {177, 5},  {209, 5},  {241, 6},  {305, 6},   {369, 7},   {497, 8},   {753, 9},
    {1265, 10}, {2289, 11}, {4337, 12}, {8433, 13}, {16625, 24}};
constexpr uint8_t kCodeLengthOrder[18] = {1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr uint8_t kCodeLengthPrefixLen[16] = {2, 2, 2, 3, 2, 2, 2, 4, 2, 2, 2, 3, 2, 2, 2, 4};
constexpr uint8_t kCodeLengthPrefixValue[16] = {0, 4, 3, 2, 0, 4, 3, 1, 0, 4, 3, 2, 0, 4, 3, 5};
// short distance codes 4-15: which of the last distances, and the delta
constexpr int kShortWhich[12] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1};
constexpr int kShortDelta[12] = {-1, 1, -2, 2, -3, 3, -1, 1, -2, 2, -3, 3};

// libbrotlicommon's ToUpperCase at p: the bytes it steps over
inline int upper(uint8_t* p) {
    if (p[0] < 0xC0) {
        if (p[0] >= 'a' && p[0] <= 'z') p[0] ^= 32;
        return 1;
    }
    if (p[0] < 0xE0) {
        p[1] ^= 32;
        return 2;
    }
    p[2] ^= 5;
    return 3;
}

struct Decoder {
    Bits br;
    const uint8_t* words;
    std::vector<uint8_t> out;
    int rb[4] = {16, 15, 11, 4};
    int rb_idx = 0;
    int64_t max_backward = 0;

    Decoder(const uint8_t* data, int64_t len, const uint8_t* dict) : br(data, len), words(dict) {}

    int window_bits() {
        if (!br.read(1)) return 16;
        int n = (int)br.read(3);
        if (n) return 17 + n;
        n = (int)br.read(3);
        if (n == 1) fail();  // the large-window escape
        return n ? 8 + n : 17;
    }

    int varlen8() {
        if (!br.read(1)) return 0;
        const int n = (int)br.read(3);
        return n == 0 ? 1 : (1 << n) + (int)br.read(n);
    }

    // ReadHuffmanCode over an alphabet of `size`
    void code(int size, Code& c) {
        const int kind = (int)br.read(2);
        std::vector<uint8_t> lengths(size, 0);
        if (kind == 1) {
            const int nsym = (int)br.read(2) + 1;
            int width = 0;
            while ((1 << width) < size) ++width;
            int syms[4];
            for (int i = 0; i < nsym; ++i) {
                syms[i] = (int)br.read(width);
                if (syms[i] >= size) fail();
            }
            for (int i = 0; i < nsym; ++i)
                for (int k = i + 1; k < nsym; ++k)
                    if (syms[i] == syms[k]) fail();
            if (nsym == 1) {
                c.single(syms[0]);
                return;
            }
            static const uint8_t kShapes[5][4] = {{0}, {0}, {1, 1}, {1, 2, 2}, {2, 2, 2, 2}};
            const uint8_t* shape = kShapes[nsym];
            static const uint8_t kTreeSelect[4] = {1, 2, 3, 3};
            if (nsym == 4 && br.read(1)) shape = kTreeSelect;
            for (int i = 0; i < nsym; ++i) lengths[syms[i]] = shape[i];
            c.build(lengths.data(), size);
            return;
        }
        uint8_t cl[18] = {0};
        int space = 32, ncodes = 0;
        for (int i = kind; i < 18; ++i) {
            const uint32_t ix = br.peek(4);
            br.skip(kCodeLengthPrefixLen[ix]);
            const int v = kCodeLengthPrefixValue[ix];
            cl[kCodeLengthOrder[i]] = (uint8_t)v;
            if (v) {
                space -= 32 >> v;
                ++ncodes;
                if (space <= 0) break;
            }
        }
        if (!(ncodes == 1 || space == 0)) fail();
        Code clc;
        if (ncodes == 1) {
            int s = 0;
            while (!cl[s]) ++s;
            clc.single(s);
        } else {
            clc.build(cl, 18);
        }
        int sym = 0, prev = 8, repeat = 0, repeat_len = 0;
        int64_t space2 = 32768;
        while (sym < size && space2 > 0) {
            const int v = clc.read(br);
            if (v < 16) {
                repeat = 0;
                if (v) {
                    lengths[sym] = (uint8_t)v;
                    prev = v;
                    space2 -= 32768 >> v;
                }
                ++sym;
                continue;
            }
            const int extra = v == 16 ? 2 : 3;
            const int delta_bits = (int)br.read(extra);
            const int new_len = v == 16 ? prev : 0;
            if (repeat_len != new_len) {
                repeat = 0;
                repeat_len = new_len;
            }
            const int old = repeat;
            if (repeat > 0) repeat = (repeat - 2) << extra;
            repeat += delta_bits + 3;
            const int delta = repeat - old;
            if (sym + delta > size) fail();
            if (repeat_len) {
                for (int k = 0; k < delta; ++k) lengths[sym + k] = (uint8_t)repeat_len;
                space2 -= (int64_t)delta << (15 - repeat_len);
            }
            sym += delta;
        }
        if (space2 != 0) fail();
        c.build(lengths.data(), size);
    }

    int block_length(const Code& c) {
        const Len l = kBlockLength[c.read(br)];
        return l.base + (int)br.read(l.extra);
    }

    int context_map(int size, std::vector<uint8_t>& map) {
        const int ntrees = varlen8() + 1;
        map.assign(size, 0);
        if (ntrees < 2) return ntrees;
        if (br.pos() + 5 > 8 * br.n) fail(kTruncated);  // libbrotlidec peeks five bits here
        const int rle = br.read(1) ? (int)br.read(4) + 1 : 0;
        Code c;
        code(ntrees + rle, c);
        for (int i = 0; i < size;) {
            const int v = c.read(br);
            if (v == 0) {
                ++i;
            } else if (v > rle) {
                map[i++] = (uint8_t)(v - rle);
            } else {
                const int reps = (1 << v) + (int)br.read(v);
                if (i + reps > size) fail();
                i += reps;
            }
        }
        if (br.read(1)) {  // the inverse move-to-front transform
            uint8_t mtf[256];
            for (int k = 0; k < 256; ++k) mtf[k] = (uint8_t)k;
            for (int k = 0; k < size; ++k) {
                const int v = map[k];
                const uint8_t value = mtf[v];
                map[k] = value;
                if (v) {
                    memmove(mtf + 1, mtf, (size_t)v);
                    mtf[0] = value;
                }
            }
        }
        return ntrees;
    }

    void word(int copy, int64_t distance, int64_t max_distance, int64_t& remaining,
              int64_t start_bits) {
        if (distance > kMaxDistance || copy < 4 || copy > 24) fail();
        const int shift = kBrotliNdbits[copy];
        const int64_t address = distance - max_distance - 1;
        const int64_t index = address & ((1 << shift) - 1), transform = address >> shift;
        if (transform >= (int64_t)(sizeof(kBrotliTransforms) / sizeof(kBrotliTransforms[0])))
            fail();
        const BrotliTransform& t = kBrotliTransforms[transform];
        const uint8_t* w = words + kBrotliOffsets[copy] + index * copy;
        int len = copy;
        if (t.type <= 9) {
            len -= t.type;
        } else if (t.type >= 12 && t.type <= 20) {
            w += t.type - 11;
            len -= t.type - 11;
        }
        uint8_t buf[24 + 3] = {0};
        if (len > 0) memcpy(buf, w, (size_t)len);
        if (t.type == 10 && len > 0) {
            upper(buf);
        } else if (t.type == 11) {
            for (int i = 0; i < len;) i += upper(buf + i);
        }
        const int body = len > 0 ? len : 0;
        // an empty word through codes of one symbol would repeat without end
        if (t.prefix_len + body + t.suffix_len == 0 && br.pos() == start_bits) fail();
        out.insert(out.end(), t.prefix, t.prefix + t.prefix_len);
        out.insert(out.end(), buf, buf + body);
        out.insert(out.end(), t.suffix, t.suffix + t.suffix_len);
        remaining -= t.prefix_len + body + t.suffix_len;
    }

    void compressed(int64_t mlen) {
        int ntypes[3] = {1, 1, 1}, btype[3] = {0, 0, 0}, ring[3][2] = {{1, 0}, {1, 0}, {1, 0}};
        int64_t blen[3] = {1 << 24, 1 << 24, 1 << 24};
        Code type_codes[3], len_codes[3];
        for (int k = 0; k < 3; ++k) {
            ntypes[k] = varlen8() + 1;
            if (ntypes[k] >= 2) {
                code(ntypes[k] + 2, type_codes[k]);
                code(26, len_codes[k]);
                blen[k] = block_length(len_codes[k]);
            }
        }
        const int bits = (int)br.read(6);
        const int npostfix = bits & 3, ndirect = (bits >> 2) << npostfix;
        std::vector<int> modes(ntypes[0]);
        for (auto& m : modes) m = (int)br.read(2);
        std::vector<uint8_t> cmap, dmap;
        const int nlit = context_map(ntypes[0] << 6, cmap);
        const int ndist = context_map(ntypes[2] << 2, dmap);
        std::vector<Code> lit(nlit), cmd(ntypes[1]), dist(ndist);
        for (auto& c : lit) code(256, c);
        for (auto& c : cmd) code(704, c);
        const int dsize = 16 + ndirect + (48 << npostfix);
        for (auto& c : dist) code(dsize, c);
        std::vector<int> dist_extra(dsize, 0);
        std::vector<int64_t> dist_offset(dsize, 0);
        int i = 16;
        for (int j = 0; j < ndirect; ++j) dist_offset[i++] = j + 1;
        for (int nbits = 1, half = 0; i < dsize;) {
            const int64_t base = ndirect + ((((int64_t)(2 + half) << nbits) - 4) << npostfix) + 1;
            for (int j = 0; j < (1 << npostfix) && i < dsize; ++j, ++i) {
                dist_extra[i] = nbits;
                dist_offset[i] = base + j;
            }
            nbits += half;
            half ^= 1;
        }
        auto switch_type = [&](int k) {
            const int c = type_codes[k].read(br);
            blen[k] = block_length(len_codes[k]);
            int t = c == 1 ? ring[k][1] + 1 : c == 0 ? ring[k][0] : c - 2;
            if (t >= ntypes[k]) t -= ntypes[k];
            ring[k][0] = ring[k][1];
            ring[k][1] = t;
            btype[k] = t;
        };
        int64_t remaining = mlen;
        int lit_slice = 0, lut_base = 512 * modes[0], dist_slice = 0;
        const Code* cmd_code = &cmd[0];
        while (true) {
            if (blen[1] == 0) {
                switch_type(1);
                cmd_code = &cmd[btype[1]];
            }
            --blen[1];
            const int64_t start_bits = br.pos();
            const int c = cmd_code->read(br);
            const int cell = c >> 6, low = c & 63;
            const int ins_code = kCells[cell][0] + (low >> 3);
            const int copy_code = kCells[cell][1] + (low & 7);
            const int64_t insert = kInsert[ins_code].base + br.read(kInsert[ins_code].extra);
            const int copy = kCopy[copy_code].base + (int)br.read(kCopy[copy_code].extra);
            remaining -= insert;
            if (remaining < 0) fail();
            for (int64_t k = 0; k < insert; ++k) {
                if (blen[0] == 0) {
                    switch_type(0);
                    lit_slice = btype[0] << 6;
                    lut_base = 512 * modes[btype[0]];
                }
                --blen[0];
                const size_t n = out.size();
                const int p1 = n ? out[n - 1] : 0, p2 = n > 1 ? out[n - 2] : 0;
                const int ctx = kBrotliContextLut[lut_base + p1] | kBrotliContextLut[lut_base + 256 + p2];
                out.push_back((uint8_t)lit[cmap[lit_slice + ctx]].read(br));
            }
            if (remaining == 0) break;
            int dcode = 0;
            if (cell >= 2) {
                if (blen[2] == 0) {
                    switch_type(2);
                    dist_slice = btype[2] << 2;
                }
                --blen[2];
                const int dctx = copy_code < 3 ? copy_code : 3;
                dcode = dist[dmap[dist_slice + dctx]].read(br);
            }
            int64_t distance;
            if (dcode < 16) {
                if (dcode < 4) {
                    distance = rb[(rb_idx - 1 - dcode) & 3];
                } else {
                    distance = (int64_t)rb[(rb_idx - 1 - kShortWhich[dcode - 4]) & 3] +
                               kShortDelta[dcode - 4];
                    if (distance <= 0) fail();
                }
            } else {
                distance = dist_offset[dcode] + ((int64_t)br.read(dist_extra[dcode]) << npostfix);
            }
            const int64_t max_distance =
                (int64_t)out.size() < max_backward ? (int64_t)out.size() : max_backward;
            if (distance > max_distance) {
                word(copy, distance, max_distance, remaining, start_bits);
            } else {
                if (dcode) {
                    rb[rb_idx & 3] = (int)distance;
                    ++rb_idx;
                }
                remaining -= copy;
                if (remaining < 0) fail();
                const size_t start = out.size() - (size_t)distance;
                out.resize(out.size() + copy);
                uint8_t* o = out.data();
                for (int k = 0; k < copy; ++k) o[start + distance + k] = o[start + k];
            }
            if (remaining <= 0) {
                if (remaining < 0) fail();
                break;
            }
        }
    }

    void run() {
        max_backward = ((int64_t)1 << window_bits()) - kWindowGap;
        while (true) {
            const int last = (int)br.read(1);
            if (last && br.read(1)) break;
            const int nibbles = (int)br.read(2) + 4;
            if (nibbles == 7) {  // a metadata meta-block
                if (br.read(1)) fail();
                const int nbytes = (int)br.read(2);
                int64_t skip = 0;
                for (int i = 0; i < nbytes; ++i) {
                    const int64_t b = br.read(8);
                    if (i + 1 == nbytes && nbytes > 1 && b == 0) fail();
                    skip |= b << (8 * i);
                }
                br.align();
                br.take(nbytes ? skip + 1 : 0);
            } else {
                int64_t mlen = 0;
                for (int i = 0; i < nibbles; ++i) {
                    const int64_t v = br.read(4);
                    if (i + 1 == nibbles && nibbles > 4 && v == 0) fail();
                    mlen |= v << (4 * i);
                }
                ++mlen;
                if (!last && br.read(1)) {
                    br.align();
                    const uint8_t* p = br.take(mlen);
                    out.insert(out.end(), p, p + mlen);
                } else {
                    compressed(mlen);
                }
            }
            if (last) break;
        }
        br.align();
        if (br.pos() != 8 * br.n) fail(kTrailing);
    }
};

}  // namespace

extern "C" {

int64_t fd_brotli_decompress(const uint8_t* data, int64_t len, const uint8_t* dict, uint8_t* out,
                             int64_t cap) {
    if (len < 0 || cap < 0) return kCorrupt;
    try {
        Decoder dec(data, len, dict);
        dec.out.reserve((size_t)cap);
        dec.run();
        const int64_t n = (int64_t)dec.out.size();
        memcpy(out, dec.out.data(), (size_t)(n < cap ? n : cap));
        return n;
    } catch (const Fail& f) {
        return f.code;
    }
}

}  // extern "C"
