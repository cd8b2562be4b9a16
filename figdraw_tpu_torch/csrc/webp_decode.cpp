// WebP decoding loops, host C++ built with g++ by
// figdraw_tpu_torch/utils/image_lib.py and bound through ctypes by
// utils/webp.py, which holds each entry point's plain Python twin (the
// tests' reference). The arithmetic is libwebp 1.6.0's, which PIL links:
//   fd_webp_vp8             a VP8 key frame (vp8_dec.c, tree_dec.c,
//                           quant_dec.c, frame_dec.c, dsp/dec.c) to cropped
//                           Y, U and V planes: the boolean decoder, the
//                           frame header, intra modes, tokens, the inverse
//                           WHT and DCT (TransformOne; its DC-only and AC3
//                           forms are equal to it), the predictions with
//                           the edge values 127 above and 129 left, and
//                           the simple and normal loop filters;
//   fd_webp_upsample        fancy upsampling of 4:2:0 chroma
//                           (UpsampleRgbaLinePair) and the 14-bit
//                           fixed-point YUV -> RGB (dsp/yuv.h), to RGBA;
//   fd_webp_vp8l            a VP8L image stream after its header (or an
//                           ALPH chunk's, which has none) to ARGB
//                           (vp8l_dec.c, huffman_utils.c, lossless.c; an
//                           ALPH stream of colour indices as
//                           DecodeAlphaData reads it);
//   fd_webp_alpha_unfilter  the ALPH unfilters (dsp/filters.c).
//
// Every function returns 0 on success and a negative code on malformed
// input (utils/webp.py ERRORS); every read of the input is bounded by its
// length.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "webp_tables.h"

namespace {

// ------------------------------------------------------- VP8 key frame ---

enum { kTruncated = -1, kStartCode = -2, kPartitions = -3, kPremature = -4, kVp8l = -5,
       kArgs = -6 };

// libwebp's VP8BitReader on a 64-bit host: range kept less one, an 8-bit
// window at `bits` of a 64-bit value, seven bytes a load while eight are
// left, then one at a time, then one byte of zeros past the end (`eof`).
// A corrupt stream can push the window past the range; the window is then
// cut to 32 bits as libwebp cuts it, so such a stream decodes as there.
struct BoolReader {
    const uint8_t* buf = nullptr;
    const uint8_t* end = nullptr;
    const uint8_t* buf_max = nullptr;
    uint64_t value = 0;
    uint32_t range = 254;
    int bits = -8;
    bool eof = false;

    void init(const uint8_t* b, const uint8_t* e) {
        buf = b;
        end = e;
        buf_max = e - b >= 8 ? e - 7 : b;
        value = 0;
        range = 254;
        bits = -8;
        eof = false;
    }
    inline void load() {
        if (buf < buf_max) {
            uint64_t v = 0;
            for (int i = 0; i < 7; ++i) v = (v << 8) | buf[i];
            buf += 7;
            value = (value << 56) | v;
            bits += 56;
        } else if (buf < end) {
            bits += 8;
            value = (value << 8) | *buf++;
        } else if (!eof) {
            value <<= 8;
            bits += 8;
            eof = true;
        } else {
            bits = 0;
        }
    }
    inline int bit(int prob) {
        if (bits < 0) load();
        uint32_t rng = range;
        const int pos = bits;
        const uint32_t split = (rng * (uint32_t)prob) >> 8;
        int b;
        if ((uint32_t)(value >> pos) > split) {
            rng -= split;
            value -= (uint64_t)(split + 1) << pos;
            b = 1;
        } else {
            rng = split + 1;
            b = 0;
        }
        const int shift = 7 ^ (31 - __builtin_clz(rng));
        bits -= shift;
        range = (rng << shift) - 1;
        return b;
    }
    // VP8GetSigned: v negated on a bit of probability 1/2, one shift
    inline int signed_bit(int v) {
        if (bits < 0) load();
        const int pos = bits;
        const uint32_t split = range >> 1;
        const uint32_t win = (uint32_t)(value >> pos);
        const int32_t mask = (int32_t)(split - win) >> 31;  // -1 or 0
        bits -= 1;
        range += (uint32_t)mask;
        range |= 1;
        value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
        return (v ^ mask) - mask;
    }
    inline int value_of(int n) {
        int v = 0;
        while (n-- > 0) v |= bit(0x80) << n;
        return v;
    }
    inline int signed_value(int n) {
        const int v = value_of(n);
        return bit(0x80) ? -v : v;
    }
};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

struct Strength { int limit, ilevel, hev, inner; };

struct MbInfo { uint8_t nz, nz_dc; };

struct Vp8 {
    int w, h, mbw, mbh;
    BoolReader br;
    BoolReader parts[8];
    int nparts;
    int update_map;
    int seg_p[3];
    int dq[4][3][2];  // [segment][y1, y2, uv][dc, ac]
    uint8_t proba[4][8][3][11];
    const uint8_t* band_proba[4][17];  // by token position: the band's [ctx][node] rows
    int use_skip, skip_p;
    int filter_type;
    Strength fstrength[4][2];
};

int parse_header(const uint8_t* s, int64_t len, Vp8* d) {
    if (len < 10) return kTruncated;
    const uint32_t bits = s[0] | (s[1] << 8) | (s[2] << 16);
    const uint32_t part0 = bits >> 5;
    if (s[3] != 0x9d || s[4] != 0x01 || s[5] != 0x2a) return kStartCode;
    d->w = (s[6] | (s[7] << 8)) & 0x3fff;
    d->h = (s[8] | (s[9] << 8)) & 0x3fff;
    d->mbw = (d->w + 15) >> 4;
    d->mbh = (d->h + 15) >> 4;
    if ((int64_t)part0 + 10 > len) return kPartitions;
    BoolReader& br = d->br;
    br.init(s + 10, s + 10 + part0);
    br.bit(0x80);  // colour space
    br.bit(0x80);  // clamping type
    int seg_q[4] = {0, 0, 0, 0}, seg_f[4] = {0, 0, 0, 0};
    d->seg_p[0] = d->seg_p[1] = d->seg_p[2] = 255;
    const int use_segment = br.bit(0x80);
    int absolute = 1;
    d->update_map = 0;
    if (use_segment) {
        d->update_map = br.bit(0x80);
        if (br.bit(0x80)) {
            absolute = br.bit(0x80);
            for (int i = 0; i < 4; ++i) seg_q[i] = br.bit(0x80) ? br.signed_value(7) : 0;
            for (int i = 0; i < 4; ++i) seg_f[i] = br.bit(0x80) ? br.signed_value(6) : 0;
        }
        if (d->update_map)
            for (int i = 0; i < 3; ++i) d->seg_p[i] = br.bit(0x80) ? br.value_of(8) : 255;
    }
    const int simple = br.bit(0x80);
    const int level = br.value_of(6);
    const int sharp = br.value_of(3);
    int ref_d[4] = {0, 0, 0, 0}, mode_d[4] = {0, 0, 0, 0};
    const int use_lf_delta = br.bit(0x80);
    if (use_lf_delta && br.bit(0x80)) {
        for (int i = 0; i < 4; ++i)
            if (br.bit(0x80)) ref_d[i] = br.signed_value(6);
        for (int i = 0; i < 4; ++i)
            if (br.bit(0x80)) mode_d[i] = br.signed_value(6);
    }
    d->filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) return kPremature;
    // token partitions
    d->nparts = 1 << br.value_of(2);
    const uint8_t* pos = s + 10 + part0;
    const uint8_t* end = s + len;
    const int64_t last = d->nparts - 1;
    if (end - pos < 3 * last) return kPartitions;
    const uint8_t* start = pos + 3 * last;
    for (int p = 0; p < last; ++p) {
        int64_t size = pos[3 * p] | (pos[3 * p + 1] << 8) | (pos[3 * p + 2] << 16);
        if (size > end - start) size = end - start;
        d->parts[p].init(start, start + size);
        start += size;
    }
    d->parts[last].init(start, end);
    if (start >= end) return kPartitions;
    // quantisers
    const int q0 = br.value_of(7);
    int dqd[5];
    for (int i = 0; i < 5; ++i) dqd[i] = br.bit(0x80) ? br.signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
        const int q = use_segment ? seg_q[i] + (absolute ? 0 : q0) : q0;
        int(*m)[2] = d->dq[i];
        m[0][0] = kDC_TABLE[clip(q + dqd[0], 127)];
        m[0][1] = kAC_TABLE[clip(q, 127)];
        m[1][0] = kDC_TABLE[clip(q + dqd[1], 127)] * 2;
        m[1][1] = (kAC_TABLE[clip(q + dqd[2], 127)] * 101581) >> 16;
        if (m[1][1] < 8) m[1][1] = 8;
        m[2][0] = kDC_TABLE[clip(q + dqd[3], 117)];
        m[2][1] = kAC_TABLE[clip(q + dqd[4], 127)];
    }
    br.bit(0x80);  // refresh_entropy_probs, ignored
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p)
                    d->proba[t][b][c][p] = br.bit(kCOEFFS_UPDATE_PROBA[t][b][c][p])
                                               ? (uint8_t)br.value_of(8)
                                               : kCOEFFS_PROBA0[t][b][c][p];
    for (int t = 0; t < 4; ++t)
        for (int n = 0; n < 17; ++n) d->band_proba[t][n] = &d->proba[t][kBANDS[n]][0][0];
    d->use_skip = br.bit(0x80);
    d->skip_p = d->use_skip ? br.value_of(8) : 0;
    for (int sg = 0; sg < 4; ++sg) {
        const int base = use_segment ? seg_f[sg] + (absolute ? 0 : level) : level;
        for (int i4 = 0; i4 < 2; ++i4) {
            int lv = base;
            if (use_lf_delta) lv += ref_d[0] + (i4 ? mode_d[0] : 0);
            lv = clip(lv, 63);
            Strength& f = d->fstrength[sg][i4];
            if (lv > 0) {
                int il = lv;
                if (sharp > 0) {
                    il >>= sharp > 4 ? 2 : 1;
                    if (il > 9 - sharp) il = 9 - sharp;
                }
                if (il < 1) il = 1;
                f.limit = 2 * lv + il;
                f.ilevel = il;
                f.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
            } else {
                f.limit = f.ilevel = f.hev = 0;
            }
            f.inner = i4;
        }
    }
    return 0;
}

// ---- tokens (GetCoeffs, GetLargeValue) ----

inline int large_value(BoolReader& br, const uint8_t* p) {
    if (!br.bit(p[3])) return !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    if (!br.bit(p[6])) {
        if (!br.bit(p[7])) return 5 + br.bit(159);
        int v = 7 + 2 * br.bit(165);
        return v + br.bit(145);
    }
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    static const uint8_t* const kCat[4] = {kCAT3, kCAT4, kCAT5, kCAT6};
    int v = 0;
    for (const uint8_t* tab = kCat[cat]; *tab; ++tab) v += v + br.bit(*tab);
    return v + 3 + (8 << cat);
}

// tokens from position n into out (raster, int16 as libwebp stores them);
// returns the position after the last non-zero one
int get_coeffs(BoolReader& br, const uint8_t* const* prob, int ctx, const int* dq, int n,
               int16_t* out) {
    const uint8_t* p = prob[n] + 11 * ctx;
    for (; n < 16; ++n) {
        if (!br.bit(p[0])) return n;
        while (!br.bit(p[1])) {
            p = prob[++n];
            if (n == 16) return 16;
        }
        const uint8_t* nxt = prob[n + 1];
        int v;
        if (!br.bit(p[2])) {
            v = 1;
            p = nxt + 11;
        } else {
            v = large_value(br, p);
            p = nxt + 22;
        }
        out[kZIGZAG[n]] = (int16_t)(br.signed_bit(v) * dq[n > 0]);
    }
    return 16;
}

inline uint32_t nz_code(uint32_t nz_coeffs, int nz, int dc_nz) {
    return (nz_coeffs << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

// fills the blocks' non-zero codes (two bits a block, block 0 highest) and
// returns whether the macroblock has no non-zero coefficient
bool parse_residuals(Vp8& d, BoolReader& br, MbInfo& mb, MbInfo& left, int seg, bool i4x4,
                     int16_t* coeffs, uint32_t* nz_y, uint32_t* nz_uv) {
    const int(*q)[2] = d.dq[seg];
    int16_t* dst = coeffs;
    const uint8_t* const* ac;
    int first;
    memset(coeffs, 0, 384 * sizeof(int16_t));
    if (!i4x4) {
        int16_t dc[16] = {0};
        const int ctx = mb.nz_dc + left.nz_dc;
        const int nz = get_coeffs(br, d.band_proba[1], ctx, q[1], 0, dc);
        mb.nz_dc = left.nz_dc = nz > 0;
        if (nz > 1) {
            transform_wht(dc, dst);
        } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
        }
        first = 1;
        ac = d.band_proba[0];
    } else {
        first = 0;
        ac = d.band_proba[3];
    }
    uint32_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f, non_zero_y = 0, non_zero_uv = 0;
    for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        uint32_t nzc = 0;
        for (int x = 0; x < 4; ++x) {
            const int nz = get_coeffs(br, ac, l + (tnz & 1), q[0], first, dst);
            l = nz > first;
            tnz = (tnz >> 1) | (l << 7);
            nzc = nz_code(nzc, nz, dst[0] != 0);
            dst += 16;
        }
        tnz >>= 4;
        lnz = (lnz >> 1) | (l << 7);
        non_zero_y = (non_zero_y << 8) | nzc;
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
        uint32_t nzc = 0;
        tnz = mb.nz >> (4 + ch);
        lnz = left.nz >> (4 + ch);
        for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
                const int nz = get_coeffs(br, d.band_proba[2], l + (tnz & 1), q[2], 0, dst);
                l = nz > 0;
                tnz = (tnz >> 1) | (l << 3);
                nzc = nz_code(nzc, nz, dst[0] != 0);
                dst += 16;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (l << 5);
        }
        non_zero_uv |= nzc << (4 * ch);
        out_t |= (tnz << 4) << ch;
        out_l |= (lnz & 0xf0) << ch;
    }
    mb.nz = (uint8_t)out_t;
    left.nz = (uint8_t)out_l;
    *nz_y = non_zero_y;
    *nz_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
}

// ---- reconstruction (dsp/dec.c) ----

constexpr int BPS = 32;  // the work buffers' stride

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

inline int w16(int v) { return (int16_t)(uint16_t)(v & 0xffff); }

// one pass of libwebp's Transform_SSE2 on a lane: 16-bit wrapping adds and
// _mm_mulhi_epi16 by 20091 and -30068 (35468 - 65536)
inline void pass16(int i0, int i1, int i2, int i3, int bias, int* out) {
    const int a = w16(w16(i0 + bias) + i2), b = w16(w16(i0 + bias) - i2);
    const int c = w16(w16(i1 - i3) + w16(((i1 * -30068) >> 16) - ((i3 * 20091) >> 16)));
    const int d = w16(w16(i1 + i3) + w16(((i1 * 20091) >> 16) + ((i3 * -30068) >> 16)));
    out[0] = w16(a + d);
    out[1] = w16(b + c);
    out[2] = w16(b - c);
    out[3] = w16(a - d);
}

// libwebp's DoTransform by a block's non-zero code: 3 the full transform as
// PIL's build runs it (Transform_SSE2, 16-bit lanes), 2 TransformAC3 and 1
// TransformDC (C, int; equal to TransformOne_C on their blocks), 0 nothing.
// The 16-bit lanes differ from TransformOne_C only on coefficients no
// encoder writes.
void transform(int code, const int16_t* in, uint8_t* dst) {
    if (code == 0) return;
    if (code == 3) {
        int cols[4][4], row[4];
        for (int i = 0; i < 4; ++i) pass16(in[i], in[4 + i], in[8 + i], in[12 + i], 0, cols[i]);
        for (int i = 0; i < 4; ++i, dst += BPS) {
            pass16(cols[0][i], cols[1][i], cols[2][i], cols[3][i], 4, row);
            for (int k = 0; k < 4; ++k) dst[k] = clip255(dst[k] + (row[k] >> 3));
        }
        return;
    }
    int C[16], *tmp = C;
    for (int i = 0; i < 4; ++i) {
        const int a = in[0] + in[8];
        const int b = in[0] - in[8];
        const int c = mul2(in[4]) - mul1(in[12]);
        const int d = mul1(in[4]) + mul2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + c;
        tmp[2] = b - c;
        tmp[3] = a - d;
        tmp += 4;
        in++;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0] + 4;
        const int a = dc + tmp[8];
        const int b = dc - tmp[8];
        const int c = mul2(tmp[4]) - mul1(tmp[12]);
        const int d = mul1(tmp[4]) + mul2(tmp[12]);
        dst[0] = clip255(dst[0] + ((a + d) >> 3));
        dst[1] = clip255(dst[1] + ((b + c) >> 3));
        dst[2] = clip255(dst[2] + ((b - c) >> 3));
        dst[3] = clip255(dst[3] + ((a - d) >> 3));
        tmp++;
        dst += BPS;
    }
}

#define DST(x, y) dst[(x) + (y)*BPS]
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

enum { DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };

void pred_big(uint8_t* dst, int n, int mode) {
    const uint8_t* top = dst - BPS;
    int v = -1;
    const int sh = n == 16 ? 5 : 4;
    if (mode == 0 || mode == DC_NOTOP || mode == DC_NOLEFT) {
        int dc = 0;
        for (int j = 0; j < n; ++j) {
            if (mode != DC_NOLEFT) dc += dst[-1 + j * BPS];
            if (mode != DC_NOTOP) dc += top[j];
        }
        v = mode == 0 ? (dc + n) >> sh : (dc + n / 2) >> (sh - 1);
    } else if (mode == DC_NOTOPLEFT) {
        v = 128;
    }
    for (int y = 0; y < n; ++y) {
        uint8_t* row = dst + y * BPS;
        for (int x = 0; x < n; ++x) {
            if (v >= 0) row[x] = (uint8_t)v;
            else if (mode == 1) row[x] = clip255(top[x] + dst[-1 + y * BPS] - top[-1]);
            else if (mode == 2) row[x] = top[x];
            else row[x] = dst[-1 + y * BPS];
        }
    }
}

void pred4(uint8_t* dst, int mode) {
    const int X = dst[-1 - BPS], A = dst[-BPS], B = dst[1 - BPS], C = dst[2 - BPS],
              D = dst[3 - BPS], E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS],
              H = dst[7 - BPS];
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    switch (mode) {
        case 0: {  // DC
            const int dc = (A + B + C + D + I + J + K + L + 4) >> 3;
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x) DST(x, y) = (uint8_t)dc;
            break;
        }
        case 1: {  // TM
            const int ls[4] = {I, J, K, L}, ts[4] = {A, B, C, D};
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x) DST(x, y) = clip255(ts[x] + ls[y] - X);
            break;
        }
        case 2: {  // VE
            const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x) DST(x, y) = vals[x];
            break;
        }
        case 3: {  // HE
            const uint8_t vals[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x) DST(x, y) = vals[y];
            break;
        }
        case 4:  // RD
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        case 5:  // VR
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        case 6:  // LD
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        case 7:  // VL
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        case 8:  // HD
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        default:  // HU
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
            break;
    }
}
#undef DST

inline int check_mode(int mbx, int mby, int mode) {
    if (mode != 0) return mode;
    if (mbx == 0) return mby == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mby == 0 ? DC_NOTOP : 0;
}

struct Planes {
    std::vector<uint8_t> y, u, v;
    int ys, cs;  // strides
};

// one macroblock predicted and reconstructed from the (unfiltered) planes
void reconstruct(const Vp8& d, Planes& P, int mbx, int mby, bool i4x4, const uint8_t* imodes,
                 int uvmode, const int16_t* coeffs, uint32_t nz_y, uint32_t nz_uv) {
    uint8_t yb[17 * BPS];
    uint8_t* y_dst = yb + BPS + 1;  // pixel (0, 0); row -1 and column -1 hold the edges
    const int y0 = mby * 16, x0 = mbx * 16, ys = P.ys;
    const uint8_t* Y = P.y.data();
    if (mby > 0) {
        memcpy(y_dst - BPS, Y + (y0 - 1) * ys + x0, 16);
        y_dst[-BPS - 1] = mbx > 0 ? Y[(y0 - 1) * ys + x0 - 1] : 129;
    } else {
        memset(y_dst - BPS - 1, 127, 21);
    }
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = mbx > 0 ? Y[(y0 + j) * ys + x0 - 1] : 129;
    if (i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mby > 0) {
            if (mbx == d.mbw - 1) memset(top_right, Y[(y0 - 1) * ys + x0 + 15], 4);
            else memcpy(top_right, Y + (y0 - 1) * ys + x0 + 16, 4);
        }
        for (int r = 4; r < 16; r += 4) memcpy(top_right + r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
            uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            pred4(dst, imodes[n]);
            transform((nz_y >> (30 - 2 * n)) & 3, coeffs + 16 * n, dst);
        }
    } else {
        pred_big(y_dst, 16, check_mode(mbx, mby, imodes[0]));
        for (int n = 0; n < 16; ++n)
            transform((nz_y >> (30 - 2 * n)) & 3, coeffs + 16 * n,
                      y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    for (int j = 0; j < 16; ++j) memcpy(P.y.data() + (y0 + j) * ys + x0, y_dst + j * BPS, 16);
    const int c0 = mby * 8, cx = mbx * 8, cs = P.cs;
    uint8_t* planes[2] = {P.u.data(), P.v.data()};
    for (int k = 0; k < 2; ++k) {
        uint8_t cb[9 * BPS];
        uint8_t* c_dst = cb + BPS + 1;
        const uint8_t* C = planes[k];
        if (mby > 0) {
            memcpy(c_dst - BPS, C + (c0 - 1) * cs + cx, 8);
            c_dst[-BPS - 1] = mbx > 0 ? C[(c0 - 1) * cs + cx - 1] : 129;
        } else {
            memset(c_dst - BPS - 1, 127, 9);
        }
        for (int j = 0; j < 8; ++j) c_dst[j * BPS - 1] = mbx > 0 ? C[(c0 + j) * cs + cx - 1] : 129;
        pred_big(c_dst, 8, check_mode(mbx, mby, uvmode));
        // DoUVTransform: all four blocks through the SSE2 transform when one
        // has an AC coefficient, else their DCs
        const int code = ((nz_uv >> (8 * k)) & 0xaa) ? 3 : 1;
        for (int n = 0; n < 4; ++n)
            transform(code, coeffs + 256 + 64 * k + 16 * n, c_dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
        for (int j = 0; j < 8; ++j) memcpy(planes[k] + (c0 + j) * cs + cx, c_dst + j * BPS, 8);
    }
}

// ---- the loop filter (dsp/dec.c) ----

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip255(p0 + a2);
    p[0] = clip255(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip255(p1 + a3);
    p[-step] = clip255(p0 + a2);
    p[0] = clip255(q0 - a1);
    p[step] = clip255(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip255(p2 + a3);
    p[-2 * step] = clip255(p1 + a2);
    p[-step] = clip255(p0 + a1);
    p[0] = clip255(q0 - a1);
    p[step] = clip255(q1 - a2);
    p[2 * step] = clip255(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int t) {
    return abs(p[-2 * step] - p[-step]) > t || abs(p[step] - p[0]) > t;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    return 4 * abs(p[-step] - p[0]) + abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
    return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
           abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

// hstride: across the edge; vstride: along it
void simple_loop(uint8_t* p, int hstride, int vstride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vstride)
        if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool mb_edge) {
    const int t2 = 2 * thresh + 1;
    for (; size-- > 0; p += vstride) {
        if (!needs_filter2(p, hstride, t2, ithresh)) continue;
        if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
        else if (mb_edge) do_filter6(p, hstride);
        else do_filter4(p, hstride);
    }
}

void loop_filter(const Vp8& d, Planes& P, const std::vector<Strength>& finfo) {
    const int ys = P.ys, cs = P.cs;
    for (int mby = 0; mby < d.mbh; ++mby) {
        for (int mbx = 0; mbx < d.mbw; ++mbx) {
            const Strength& f = finfo[mby * d.mbw + mbx];
            if (f.limit == 0) continue;
            uint8_t* y = P.y.data() + mby * 16 * ys + mbx * 16;
            if (d.filter_type == 1) {
                if (mbx > 0) simple_loop(y, 1, ys, f.limit + 4);
                if (f.inner)
                    for (int k = 4; k < 16; k += 4) simple_loop(y + k, 1, ys, f.limit);
                if (mby > 0) simple_loop(y, ys, 1, f.limit + 4);
                if (f.inner)
                    for (int k = 4; k < 16; k += 4) simple_loop(y + k * ys, ys, 1, f.limit);
                continue;
            }
            uint8_t* u = P.u.data() + mby * 8 * cs + mbx * 8;
            uint8_t* v = P.v.data() + mby * 8 * cs + mbx * 8;
            const int lim = f.limit, il = f.ilevel, hv = f.hev;
            if (mbx > 0) {
                filter_loop(y, 1, ys, 16, lim + 4, il, hv, true);
                filter_loop(u, 1, cs, 8, lim + 4, il, hv, true);
                filter_loop(v, 1, cs, 8, lim + 4, il, hv, true);
            }
            if (f.inner) {
                for (int k = 4; k < 16; k += 4) filter_loop(y + k, 1, ys, 16, lim, il, hv, false);
                filter_loop(u + 4, 1, cs, 8, lim, il, hv, false);
                filter_loop(v + 4, 1, cs, 8, lim, il, hv, false);
            }
            if (mby > 0) {
                filter_loop(y, ys, 1, 16, lim + 4, il, hv, true);
                filter_loop(u, cs, 1, 8, lim + 4, il, hv, true);
                filter_loop(v, cs, 1, 8, lim + 4, il, hv, true);
            }
            if (f.inner) {
                for (int k = 4; k < 16; k += 4)
                    filter_loop(y + k * ys, ys, 1, 16, lim, il, hv, false);
                filter_loop(u + 4 * cs, cs, 1, 8, lim, il, hv, false);
                filter_loop(v + 4 * cs, cs, 1, 8, lim, il, hv, false);
            }
        }
    }
}

// ------------------------------------------------------------- VP8L ---

// LSB-first bits; as libwebp's reader, a stream shorter than 8 bytes reads
// zeros up to 64 bits, and reading past that (or past a longer stream's
// end) sets err
struct LBits {
    const uint8_t* d;
    int64_t n, pos, limit;
    bool err = false;

    LBits(const uint8_t* data, int64_t len)
        : d(data), n(len), pos(0), limit(8 * len > 64 ? 8 * len : 64) {}
    inline uint64_t peek() const {
        const int64_t byte = pos >> 3;
        uint64_t v = 0;
        if (byte + 8 <= n) {
            memcpy(&v, d + byte, 8);
        } else {
            for (int i = 0; i < 8 && byte + i < n; ++i) v |= (uint64_t)d[byte + i] << (8 * i);
        }
        return v >> (pos & 7);
    }
    inline uint32_t read(int k) {
        if (pos + k > limit) {
            err = true;
            pos = limit;
            return 0;
        }
        const uint32_t v = (uint32_t)(peek() & ((1ull << k) - 1));
        pos += k;
        return v;
    }
};

constexpr int kLutBits = 8;

// a canonical prefix code: a kLutBits-bit table of (length << 16 | symbol),
// codes longer than that decoded bit by bit
struct Code {
    int single = -1;
    uint32_t lut[1 << kLutBits];
    int counts[16];
    std::vector<int> syms;

    bool build(const int* lengths, int size) {
        int nsym = 0, last = 0;
        memset(counts, 0, sizeof(counts));
        for (int s = 0; s < size; ++s)
            if (lengths[s]) {
                ++nsym;
                last = s;
                ++counts[lengths[s]];
            }
        if (nsym == 0) return false;
        if (nsym == 1) {
            single = last;
            return true;
        }
        int left = 1;
        for (int ln = 1; ln < 16; ++ln) {
            left = 2 * left - counts[ln];
            if (left < 0) return false;
        }
        if (left) return false;
        syms.clear();
        for (int ln = 1; ln < 16; ++ln)
            for (int s = 0; s < size; ++s)
                if (lengths[s] == ln) syms.push_back(s);
        memset(lut, 0, sizeof(lut));
        int code = 0, k = 0;
        for (int ln = 1; ln < 16; ++ln) {
            for (int i = 0; i < counts[ln]; ++i, ++k, ++code) {
                if (ln > kLutBits) continue;
                int rev = 0;
                for (int b = 0; b < ln; ++b) rev |= ((code >> b) & 1) << (ln - 1 - b);
                for (int fill = rev; fill < (1 << kLutBits); fill += 1 << ln)
                    lut[fill] = ((uint32_t)ln << 16) | (uint32_t)syms[k];
            }
            code <<= 1;
        }
        return true;
    }
    inline int read(LBits& br) const {
        if (single >= 0) return single;
        const uint32_t e = lut[br.peek() & ((1 << kLutBits) - 1)];
        if (e) {
            const int ln = (int)(e >> 16);
            if (br.pos + ln > br.limit) {
                br.err = true;
                return 0;
            }
            br.pos += ln;
            return (int)(e & 0xffff);
        }
        int code = 0, first = 0, index = 0;
        for (int ln = 1; ln < 16; ++ln) {
            code |= (int)br.read(1);
            if (br.err) return 0;
            const int c = counts[ln];
            if (code - first < c) return syms[index + code - first];
            index += c;
            first = (first + c) << 1;
            code <<= 1;
        }
        br.err = true;
        return 0;
    }
};

// libwebp's VP8LBitReader as DecodeAlphaData reads it, from an LBits
// position on: a 64-bit window over the stream's last 8 bytes once they are
// loaded (`base`), a peek past the end reading zeros up to the window's 64
// bits and wrapping to its start beyond (the shift is taken mod 64), and the
// end of stream found only where the window is refilled or the loop asks,
// which sets the position back to the window's start (the plain twin is
// utils/webp.py _WindowBits)
struct WindowBits {
    const uint8_t* d;
    int64_t n, pos, limit, base;
    uint64_t window = 0;
    bool eos = false;

    explicit WindowBits(const LBits& br) : d(br.d), n(br.n), pos(br.pos), limit(br.limit) {
        base = limit - 64;
        for (int i = 0; i < 8 && base / 8 + i < n; ++i)
            window |= (uint64_t)d[base / 8 + i] << (8 * i);
    }
    inline uint32_t peek() const {
        if (pos < base) {
            const int64_t byte = pos >> 3;
            uint64_t v = 0;
            for (int i = 0; i < 8 && byte + i < n; ++i) v |= (uint64_t)d[byte + i] << (8 * i);
            return (uint32_t)(v >> (pos & 7));
        }
        return (uint32_t)(window >> ((pos - base) & 63));
    }
    inline void shift() {
        if (eos || pos > limit) {
            eos = true;
            pos = base;
        }
    }
    inline void fill() {
        if (pos - base >= 32) shift();
    }
    inline uint32_t read(int k) {
        if (eos) {
            pos = base;
            return 0;
        }
        const uint32_t v = peek() & ((1u << k) - 1);
        pos += k;
        shift();
        return v;
    }
    // ReadSymbol: the first 8 bits from one peek, the rest of a longer code
    // from a second peek 8 bits on (libwebp's two-level table)
    inline int symbol(const Code& c, bool& bad) {
        if (c.single >= 0) return c.single;
        const uint32_t low = peek() & 0xff;
        pos += 8;
        const uint64_t bits = low | ((uint64_t)peek() << 8);
        pos -= 8;
        int code = 0, first = 0, index = 0;
        for (int ln = 1; ln < 16; ++ln) {
            code |= (int)((bits >> (ln - 1)) & 1);
            const int cnt = c.counts[ln];
            if (code - first < cnt) {
                pos += ln;
                return c.syms[index + code - first];
            }
            index += cnt;
            first = (first + cnt) << 1;
            code <<= 1;
        }
        bad = true;
        return 0;
    }
    inline bool at_end() {
        eos = eos || pos > limit;
        return eos;
    }
};

bool read_code(LBits& br, int size, Code& out) {
    std::vector<int> lengths(size > 256 ? size : 256, 0);
    if (br.read(1)) {
        const int two = (int)br.read(1);
        const int first_bits = br.read(1) ? 8 : 1;
        lengths[br.read(first_bits)] = 1;
        if (two) lengths[br.read(8)] = 1;
        return !br.err && out.build(lengths.data(), size);
    }
    int cl[19] = {0};
    const int ncodes = (int)br.read(4) + 4;
    for (int i = 0; i < ncodes; ++i) cl[kCODE_LENGTH_ORDER[i]] = (int)br.read(3);
    Code lcode;
    if (br.err || !lcode.build(cl, 19)) return false;
    int max_symbol = size;
    if (br.read(1)) {
        const int nbits = 2 + 2 * (int)br.read(3);
        max_symbol = 2 + (int)br.read(nbits);
        if (max_symbol > size) return false;
    }
    int sym = 0, prev = 8;
    while (sym < size) {
        if (max_symbol-- == 0) break;
        const int c = lcode.read(br);
        if (br.err) return false;
        if (c < 16) {
            lengths[sym++] = c;
            if (c) prev = c;
        } else {
            static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
            const int rep = (int)br.read(kExtra[c - 16]) + kOffset[c - 16];
            if (sym + rep > size) return false;
            const int v = c == 16 ? prev : 0;
            for (int k = 0; k < rep; ++k) lengths[sym++] = v;
        }
    }
    return !br.err && out.build(lengths.data(), size);
}

inline int sub_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_px(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t avg_px(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

inline int sub3(int a, int b, int c) { return abs(b - c) - abs(a - c); }

inline uint32_t select_px(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
    const int s = sub3(a >> 24, b >> 24, c >> 24) +
                  sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                  sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                  sub3(a & 0xff, b & 0xff, c & 0xff);
    return s <= 0 ? a : b;
}

inline uint32_t clip255u(int v) { return (uint32_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int sh = 0; sh < 32; sh += 8)
        out |= clip255u((int)((c0 >> sh) & 0xff) + (int)((c1 >> sh) & 0xff) -
                        (int)((c2 >> sh) & 0xff)) << sh;
    return out;
}

inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = avg_px(c0, c1);
    uint32_t out = 0;
    for (int sh = 0; sh < 32; sh += 8) {
        const int a = (int)((ave >> sh) & 0xff), b = (int)((c2 >> sh) & 0xff);
        out |= clip255u(a + (a - b) / 2) << sh;
    }
    return out;
}

inline uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TL, uint32_t TR) {
    switch (mode) {
        case 1: return L;
        case 2: return T;
        case 3: return TR;
        case 4: return TL;
        case 5: return avg_px(avg_px(L, TR), T);
        case 6: return avg_px(L, TL);
        case 7: return avg_px(L, T);
        case 8: return avg_px(TL, T);
        case 9: return avg_px(T, TR);
        case 10: return avg_px(avg_px(L, TL), avg_px(T, TR));
        case 11: return select_px(T, L, TL);
        case 12: return add_sub_full(L, T, TL);
        case 13: return add_sub_half(L, T, TL);
        default: return 0xff000000u;
    }
}

struct Transform {
    int kind, xsize, bits;
    std::vector<uint32_t> data;
};

struct Vp8l {
    LBits br;
    bool alpha;
    Vp8l(const uint8_t* d, int64_t n, bool alpha_stream) : br(d, n), alpha(alpha_stream) {}

    bool image(int xsize, int ysize, bool level0, std::vector<uint32_t>& out);
    bool pixels(int w, int h, const std::vector<Code>& codes, const std::vector<uint32_t>& meta,
                int meta_bits, int cache_bits, std::vector<uint32_t>& out);
    bool pixels_8b(int w, int h, const std::vector<Code>& codes,
                   const std::vector<uint32_t>& meta, int meta_bits, std::vector<uint32_t>& out);
};

bool inverse(const Transform& t, int h, std::vector<uint32_t>& px) {
    const int w = t.xsize;
    std::vector<uint32_t> out((size_t)w * h);
    if (t.kind == 2) {  // subtract green
        for (size_t i = 0; i < px.size(); ++i) {
            const uint32_t p = px[i], g = (p >> 8) & 0xff;
            out[i] = (p & 0xff00ff00u) | ((((p >> 16) + g) & 0xff) << 16) | ((p + g) & 0xff);
        }
    } else if (t.kind == 3) {  // colour indexing
        const int bpp = 8 >> t.bits, per = 1 << t.bits, mask = (1 << bpp) - 1;
        const int pw = sub_size(w, t.bits);
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                const uint32_t idx = (px[(size_t)y * pw + (x >> t.bits)] >> 8) & 0xff;
                out[(size_t)y * w + x] = t.data[(idx >> (bpp * (x & (per - 1)))) & mask];
            }
    } else {
        const int tiles = sub_size(w, t.bits);
        for (int y = 0; y < h; ++y) {
            const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles;
            for (int x = 0; x < w; ++x) {
                const size_t i = (size_t)y * w + x;
                const uint32_t m = modes[x >> t.bits];
                if (t.kind == 0) {  // predictor
                    uint32_t pred;
                    if (y == 0) pred = x == 0 ? 0xff000000u : out[i - 1];
                    else if (x == 0) pred = out[i - w];
                    else pred = predict((m >> 8) & 0xf, out[i - 1], out[i - w], out[i - w - 1],
                                        out[i - w + 1]);
                    out[i] = add_px(px[i], pred);
                } else {  // cross colour
                    const uint32_t p = px[i];
                    const int green = (int8_t)(p >> 8);
                    int red = (int)((p >> 16) & 0xff);
                    int blue = (int)(p & 0xff);
                    red = (red + (((int)(int8_t)(m & 0xff) * green) >> 5)) & 0xff;
                    blue += ((int)(int8_t)((m >> 8) & 0xff) * green) >> 5;
                    blue += ((int)(int8_t)((m >> 16) & 0xff) * (int)(int8_t)red) >> 5;
                    out[i] = (p & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)(blue & 0xff);
                }
            }
        }
    }
    px.swap(out);
    return true;
}

template <class Bits>
inline int prefix_value(int sym, Bits& br) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    return ((2 + (sym & 1)) << extra) + (int)br.read(extra) + 1;
}

bool Vp8l::image(int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
    std::vector<Transform> transforms;
    const int width = xsize;
    if (level0) {
        int seen = 0;
        while (br.read(1)) {
            const int kind = (int)br.read(2);
            if (br.err || (seen & (1 << kind))) return false;
            seen |= 1 << kind;
            Transform t{kind, xsize, 0, {}};
            if (kind == 0 || kind == 1) {
                t.bits = (int)br.read(3) + 2;
                if (!image(sub_size(xsize, t.bits), sub_size(ysize, t.bits), false, t.data))
                    return false;
            } else if (kind == 3) {
                const int n = (int)br.read(8) + 1;
                t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
                std::vector<uint32_t> pal;
                if (!image(n, 1, false, pal)) return false;
                t.data.assign((size_t)1 << (8 >> t.bits), 0);
                t.data[0] = pal[0];
                for (int i = 1; i < n; ++i) t.data[i] = add_px(pal[i], t.data[i - 1]);
                xsize = sub_size(xsize, t.bits);
            }
            transforms.push_back(std::move(t));
        }
    }
    int cache_bits = 0;
    if (br.read(1)) {
        cache_bits = (int)br.read(4);
        if (cache_bits < 1 || cache_bits > 11) return false;
    }
    int meta_bits = 0, ngroups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br.read(1)) {
        meta_bits = (int)br.read(3) + 2;
        if (!image(sub_size(xsize, meta_bits), sub_size(ysize, meta_bits), false, meta))
            return false;
        for (auto& m : meta) {
            m = (m >> 8) & 0xffff;
            if ((int)m + 1 > ngroups) ngroups = (int)m + 1;
        }
    }
    if (br.err) return false;
    std::vector<Code> codes((size_t)ngroups * 5);
    const int sizes[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0), 256, 256, 256, 40};
    for (int g = 0; g < ngroups; ++g)
        for (int j = 0; j < 5; ++j)
            if (!read_code(br, sizes[j], codes[(size_t)g * 5 + j])) return false;
    // libwebp decodes an ALPH stream of colour indices alone (no colour cache,
    // red, blue and alpha of one symbol each) with DecodeAlphaData
    bool eight_bit = level0 && alpha && transforms.size() == 1 && transforms[0].kind == 3 &&
                     cache_bits == 0;
    for (int g = 0; eight_bit && g < ngroups; ++g)
        for (int j = 1; j < 4; ++j) eight_bit = eight_bit && codes[(size_t)g * 5 + j].single >= 0;
    if (!(eight_bit ? pixels_8b(xsize, ysize, codes, meta, meta_bits, out)
                    : pixels(xsize, ysize, codes, meta, meta_bits, cache_bits, out)))
        return false;
    for (size_t k = transforms.size(); k-- > 0;)
        if (!inverse(transforms[k], ysize, out)) return false;
    return out.size() == (size_t)width * ysize;
}

bool Vp8l::pixels(int w, int h, const std::vector<Code>& codes, const std::vector<uint32_t>& meta,
                  int meta_bits, int cache_bits, std::vector<uint32_t>& out) {
    const int64_t n = (int64_t)w * h;
    out.assign((size_t)n, 0);
    std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
    const int mw = meta.empty() ? 0 : sub_size(w, meta_bits);
    int64_t pos = 0, cached = 0;
    int x = 0, y = 0;
    while (pos < n) {
        const Code* g =
            meta.empty() ? codes.data()
                         : codes.data() + (size_t)meta[(size_t)(y >> meta_bits) * mw +
                                                       (x >> meta_bits)] * 5;
        const int code = g[0].read(br);
        if (code < 256) {
            const int red = g[1].read(br), blue = g[2].read(br), alpha = g[3].read(br);
            out[pos++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) |
                         (uint32_t)blue;
            if (++x == w) {
                x = 0;
                ++y;
            }
        } else if (code < 280) {
            const int length = prefix_value(code - 256, br);
            int64_t dist = prefix_value(g[4].read(br), br);
            if (dist > 120) {
                dist -= 120;
            } else {
                const int c = kCODE_TO_PLANE[dist - 1];
                dist = (int64_t)(c >> 4) * w + 8 - (c & 0xf);
                if (dist < 1) dist = 1;
            }
            if (br.err) return false;
            if (dist > pos || n - pos < length) return false;
            for (int k = 0; k < length; ++k, ++pos) out[pos] = out[pos - dist];
            x += length;
            while (x >= w) {
                x -= w;
                ++y;
            }
        } else {
            if (cache.empty() || code - 280 >= (int)cache.size()) return false;
            for (; cached < pos; ++cached)
                cache[(out[cached] * 0x1e35a7bdu) >> (32 - cache_bits)] = out[cached];
            out[pos++] = cache[code - 280];
            if (++x == w) {
                x = 0;
                ++y;
            }
        }
        if (br.err) return false;
        if (!cache.empty())
            for (; cached < pos; ++cached)
                cache[(out[cached] * 0x1e35a7bdu) >> (32 - cache_bits)] = out[cached];
    }
    return true;
}

// DecodeAlphaData: the end of the stream is asked for only after each
// symbol and its copy, and the image fails only when the stream ended
// before its last pixel, so the last symbols may be read past the end
bool Vp8l::pixels_8b(int w, int h, const std::vector<Code>& codes,
                     const std::vector<uint32_t>& meta, int meta_bits,
                     std::vector<uint32_t>& out) {
    const int64_t n = (int64_t)w * h;
    out.assign((size_t)n, 0);
    const int mw = meta.empty() ? 0 : sub_size(w, meta_bits);
    WindowBits wb(br);
    bool bad = false;
    int64_t pos = 0;
    while (!wb.eos && pos < n) {
        const int x = (int)(pos % w), y = (int)(pos / w);
        const Code* g =
            meta.empty() ? codes.data()
                         : codes.data() + (size_t)meta[(size_t)(y >> meta_bits) * mw +
                                                       (x >> meta_bits)] * 5;
        wb.fill();
        const int code = wb.symbol(g[0], bad);
        if (bad) return false;
        if (code < 256) {
            out[pos++] = ((uint32_t)g[3].single << 24) | ((uint32_t)g[1].single << 16) |
                         ((uint32_t)code << 8) | (uint32_t)g[2].single;
        } else if (code < 280) {
            const int length = prefix_value(code - 256, wb);
            const int dsym = wb.symbol(g[4], bad);
            if (bad) return false;
            wb.fill();
            int64_t dist = prefix_value(dsym, wb);
            if (dist > 120) {
                dist -= 120;
            } else {
                const int c = kCODE_TO_PLANE[dist - 1];
                dist = (int64_t)(c >> 4) * w + 8 - (c & 0xf);
                if (dist < 1) dist = 1;
            }
            if (dist > pos || n - pos < length) return false;
            for (int k = 0; k < length; ++k, ++pos) out[pos] = out[pos - dist];
        } else {
            return false;
        }
        wb.at_end();
    }
    if (wb.at_end() && pos < n) return false;
    br.pos = wb.pos;
    return true;
}

}  // namespace

extern "C" {

int fd_webp_vp8(const uint8_t* data, int64_t len, int w, int h, uint8_t* y, uint8_t* u,
                uint8_t* v) {
    Vp8 d;
    const int status = parse_header(data, len, &d);
    if (status) return status;
    if (d.w != w || d.h != h || w < 1 || h < 1) return kArgs;
    Planes P;
    P.ys = d.mbw * 16;
    P.cs = d.mbw * 8;
    P.y.assign((size_t)P.ys * d.mbh * 16, 0);
    P.u.assign((size_t)P.cs * d.mbh * 8, 0);
    P.v.assign((size_t)P.cs * d.mbh * 8, 0);
    std::vector<uint8_t> intra_t((size_t)4 * d.mbw, 0);
    std::vector<MbInfo> nz_top(d.mbw, MbInfo{0, 0});
    std::vector<Strength> finfo((size_t)d.mbw * d.mbh, Strength{0, 0, 0, 0});
    int16_t coeffs[384];
    BoolReader& br = d.br;
    for (int mby = 0; mby < d.mbh; ++mby) {
        uint8_t intra_l[4] = {0, 0, 0, 0};
        MbInfo left{0, 0};
        BoolReader& tbr = d.parts[mby & (d.nparts - 1)];
        for (int mbx = 0; mbx < d.mbw; ++mbx) {
            // the intra modes (first partition)
            int seg = 0;
            if (d.update_map)
                seg = !br.bit(d.seg_p[0]) ? br.bit(d.seg_p[1]) : br.bit(d.seg_p[2]) + 2;
            int skip = d.use_skip ? br.bit(d.skip_p) : 0;
            const bool i4x4 = !br.bit(145);
            uint8_t* top = intra_t.data() + 4 * mbx;
            uint8_t imodes[16];
            if (!i4x4) {
                const int ymode = br.bit(156) ? (br.bit(128) ? 1 : 3) : (br.bit(163) ? 2 : 0);
                imodes[0] = (uint8_t)ymode;
                memset(top, ymode, 4);
                memset(intra_l, ymode, 4);
            } else {
                uint8_t* modes = imodes;
                for (int yy = 0; yy < 4; ++yy) {
                    int ym = intra_l[yy];
                    for (int xx = 0; xx < 4; ++xx) {
                        const uint8_t* prob = kBMODES_PROBA[top[xx]][ym];
                        int i = kYMODES_INTRA4[br.bit(prob[0])];
                        while (i > 0) i = kYMODES_INTRA4[2 * i + br.bit(prob[i])];
                        ym = -i;
                        top[xx] = (uint8_t)ym;
                    }
                    memcpy(modes, top, 4);
                    modes += 4;
                    intra_l[yy] = (uint8_t)ym;
                }
            }
            const int uvmode = !br.bit(142) ? 0 : !br.bit(114) ? 2 : br.bit(183) ? 1 : 3;
            if (br.eof) return kPremature;
            // the residuals (token partition)
            MbInfo& mb = nz_top[mbx];
            uint32_t nz_y = 0, nz_uv = 0;
            if (!skip) {
                skip = parse_residuals(d, tbr, mb, left, seg, i4x4, coeffs, &nz_y, &nz_uv);
            } else {
                left.nz = mb.nz = 0;
                if (!i4x4) left.nz_dc = mb.nz_dc = 0;
                memset(coeffs, 0, sizeof(coeffs));
            }
            if (tbr.eof) return kPremature;
            if (d.filter_type) {
                Strength f = d.fstrength[seg][i4x4 ? 1 : 0];
                f.inner = i4x4 || !skip;
                finfo[(size_t)mby * d.mbw + mbx] = f;
            }
            reconstruct(d, P, mbx, mby, i4x4, imodes, uvmode, coeffs, nz_y, nz_uv);
        }
    }
    if (d.filter_type) loop_filter(d, P, finfo);
    const int cw = (w + 1) / 2, ch = (h + 1) / 2;
    for (int r = 0; r < h; ++r) memcpy(y + (size_t)r * w, P.y.data() + (size_t)r * P.ys, w);
    for (int r = 0; r < ch; ++r) {
        memcpy(u + (size_t)r * cw, P.u.data() + (size_t)r * P.cs, cw);
        memcpy(v + (size_t)r * cw, P.v.data() + (size_t)r * P.cs, cw);
    }
    return 0;
}

static inline int mult_hi(int v, int c) { return (v * c) >> 8; }
static inline uint8_t yuv_clip8(int v) {
    return (uint8_t)((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255);
}
static inline void yuv_to_rgba(int yv, int uv, int vv, uint8_t* out) {
    const int yy = mult_hi(yv, 19077);
    out[0] = yuv_clip8(yy + mult_hi(vv, 26149) - 14234);
    out[1] = yuv_clip8(yy - mult_hi(uv, 6419) - mult_hi(vv, 13320) + 8708);
    out[2] = yuv_clip8(yy + mult_hi(uv, 33050) - 17685);
    out[3] = 0xff;
}

// one output row (UpsampleRgbaLinePair's top row): the nearer chroma row
// `tu`, `tv` weighs 3, the farther `cu`, `cv` 1
static void upsample_row(const uint8_t* yrow, const uint8_t* tu, const uint8_t* tv,
                         const uint8_t* cu, const uint8_t* cv, uint8_t* dst, int len) {
    const int last_pair = (len - 1) >> 1;
    int tlu = tu[0], tlv = tv[0], lu = cu[0], lv = cv[0];
    yuv_to_rgba(yrow[0], (3 * tlu + lu + 2) >> 2, (3 * tlv + lv + 2) >> 2, dst);
    for (int x = 1; x <= last_pair; ++x) {
        const int tu1 = tu[x], tv1 = tv[x], u1 = cu[x], v1 = cv[x];
        const int d12u = (tlu + 3 * tu1 + 3 * lu + u1 + 8) >> 3;
        const int d03u = (3 * tlu + tu1 + lu + 3 * u1 + 8) >> 3;
        const int d12v = (tlv + 3 * tv1 + 3 * lv + v1 + 8) >> 3;
        const int d03v = (3 * tlv + tv1 + lv + 3 * v1 + 8) >> 3;
        yuv_to_rgba(yrow[2 * x - 1], (d12u + tlu) >> 1, (d12v + tlv) >> 1, dst + 4 * (2 * x - 1));
        yuv_to_rgba(yrow[2 * x], (d03u + tu1) >> 1, (d03v + tv1) >> 1, dst + 4 * (2 * x));
        tlu = tu1;
        tlv = tv1;
        lu = u1;
        lv = v1;
    }
    if (!(len & 1))
        yuv_to_rgba(yrow[len - 1], (3 * tlu + lu + 2) >> 2, (3 * tlv + lv + 2) >> 2,
                    dst + 4 * (len - 1));
}

int fd_webp_upsample(const uint8_t* y, const uint8_t* u, const uint8_t* v, int w, int h,
                     uint8_t* rgba) {
    if (w < 1 || h < 1) return kArgs;
    const int cw = (w + 1) / 2;
    for (int row = 0; row < h; ++row) {
        const int k = (row + 1) / 2;
        int near, far;
        if (row == 0 || (row == h - 1 && !(h & 1))) {
            near = far = row == 0 ? 0 : k - 1;
        } else if (row & 1) {
            near = k - 1;
            far = k;
        } else {
            near = k;
            far = k - 1;
        }
        upsample_row(y + (size_t)row * w, u + (size_t)near * cw, v + (size_t)near * cw,
                     u + (size_t)far * cw, v + (size_t)far * cw, rgba + (size_t)row * w * 4, w);
    }
    return 0;
}

int fd_webp_vp8l(const uint8_t* data, int64_t len, int w, int h, int alpha, uint32_t* argb) {
    if (w < 1 || h < 1 || w > 16384 || h > 16384 || len < 0) return kArgs;
    Vp8l dec(data, len, alpha != 0);
    std::vector<uint32_t> px;
    if (!dec.image(w, h, true, px) || dec.br.err) return kVp8l;
    memcpy(argb, px.data(), px.size() * sizeof(uint32_t));
    return 0;
}

int fd_webp_alpha_unfilter(const uint8_t* in, int w, int h, int filter, uint8_t* out) {
    if (w < 1 || h < 1 || filter < 0 || filter > 3) return kArgs;
    for (int y = 0; y < h; ++y) {
        const uint8_t* d = in + (size_t)y * w;
        uint8_t* o = out + (size_t)y * w;
        const uint8_t* prev = y ? o - w : nullptr;
        if (filter == 0) {
            memcpy(o, d, w);
        } else if (filter == 1 || !prev) {
            uint8_t pred = prev ? prev[0] : 0;
            for (int x = 0; x < w; ++x) pred = o[x] = (uint8_t)(pred + d[x]);
        } else if (filter == 2) {
            for (int x = 0; x < w; ++x) o[x] = (uint8_t)(prev[x] + d[x]);
        } else {
            int left = prev[0], top_left = prev[0];
            for (int x = 0; x < w; ++x) {
                const int top = prev[x];
                int g = left + top - top_left;
                g = g < 0 ? 0 : g > 255 ? 255 : g;
                left = (uint8_t)(d[x] + g);
                top_left = top;
                o[x] = (uint8_t)left;
            }
        }
    }
    return 0;
}

}  // extern "C"
