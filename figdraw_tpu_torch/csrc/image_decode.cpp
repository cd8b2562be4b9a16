// Image-file decoding loops that numpy cannot vectorise, host C++ built
// with g++ by figdraw_tpu_torch/utils/imagefile.py and bound through ctypes
// by utils/jpeg.py, utils/gif.py and utils/qoi.py. Each entry point has a
// plain Python/numpy twin beside its binding (the tests' reference).
//
// JPEG: the integer arithmetic of libjpeg-turbo 3.1.3, which PIL links:
//   fd_jpeg_scan        Huffman entropy decoding of one scan into the
//                       components' coefficient blocks: sequential, and the
//                       four progressive kinds (DC first/refine, AC
//                       first/refine, EOB runs, successive approximation),
//                       restart intervals, read as jdhuff.c and jdphuff.c
//                       read the bytes PIL hands over (the fast path, the
//                       57-bit fills, the end of the data);
//   fd_jpeg_arith_scan  arithmetic decoding of one scan into the
//                       coefficient blocks: sequential and the four
//                       progressive kinds, the DAC conditioning, restarts
//                       resynchronised as libjpeg does (jdarith.c with the
//                       Qe table of jaricom.c);
//   fd_jpeg_lossless_scan  one lossless scan into the components' samples:
//                       Huffman-coded differences, predictors 1-7, the
//                       point transform (jdlhuff.c, jddiffct.c, jdlossls.c);
//   fd_jpeg_smooth      block smoothing of an incomplete progressive file:
//                       the still-zero low coefficients estimated from the
//                       DC neighbourhood (jdcoefct.c decompress_smooth_data);
//   fd_jpeg_idct_islow  dequantisation and the slow-but-accurate integer
//                       IDCT in the 16-bit lanes of its x86-64 SIMD form
//                       (jidctint.c, jidctint-avx2.asm);
//   fd_jpeg_upsample    one component to the full sampling grid: the fancy
//                       h2v1, h2v2 and h1v2 upsamplers, the box upsampler
//                       for the other integral ratios (jdsample.c);
//   fd_jpeg_color       YCbCr -> RGB and YCCK -> CMYK with the fixed-point
//                       tables of jdcolor.c (SCALEBITS 16).
// GIF: fd_gif_lzw, the variable-width LZW decoder of one image's data.
// QOI: fd_qoi_decode, the six-op QOI stream.
// TIFF: as libtiff 4.7.1 decodes a strip or tile:
//   fd_tiff_packbits    PackBits (tif_packbits.c);
//   fd_tiff_lzw         LZW with MSB-first codes and the early change of the
//                       code width (tif_lzw.c, new-style codes);
//   fd_tiff_predict     the horizontal and floating-point predictors
//                       (tif_predict.c: horAcc8/16/32/64 with their swab
//                       forms, fpAcc);
//   fd_tiff_fax         CCITT Modified Huffman, RLE-W, T.4 and T.6
//                       (tif_fax3.c, tif_fax3.h, with the code tables of
//                       fax_tables.h).
//
// Every function returns 0 (or a position) on success and a negative code
// on malformed input; only the lossless scan allocates (its rows of
// differences).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <utility>
#include <vector>
#include <algorithm>

#include "fax_tables.h"

extern "C" {

// ------------------------------------------------------------------ JPEG ---

// zigzag position -> natural (row-major) index, with 16 extra entries so
// that a corrupt run length past 63 writes coefficient 63 (jutils.c)
static const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
    // canonical decoding by code length (jdhuff.c jpeg_make_d_derived_tbl)
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    // HUFF_LOOKAHEAD (8 bits): (length << 8) | value, length 9 when the
    // code is longer or no code starts with the byte
    uint16_t look[256];
};

// spec: 16 code-length counts then up to 256 symbols
static int build_huff(const uint8_t* spec, Huff* h) {
    int huffsize[257], code = 0, p = 0;
    uint32_t huffcode[257];
    for (int l = 1; l <= 16; ++l) {
        int n = spec[l - 1];
        if (p + n > 256) return -1;
        while (n--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    int numsymbols = p, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1 << si)) return -1;  // code lengths overflow
        code <<= 1;
        ++si;
    }
    std::memcpy(h->vals, spec + 16, numsymbols);
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (spec[l - 1]) {
            h->valoffset[l] = p - (int32_t)huffcode[p];
            p += spec[l - 1];
            h->maxcode[l] = (int32_t)huffcode[p - 1];
        } else {
            h->maxcode[l] = -1;
        }
    }
    h->valoffset[17] = 0;
    h->maxcode[17] = 0x7FFFFFFF;  // sentinel: ends the slow search
    for (int i = 0; i < 256; ++i) h->look[i] = 9 << 8;
    p = 0;
    for (int l = 1; l <= 8; ++l) {
        for (int i = 1; i <= spec[l - 1]; ++i, ++p) {
            int look = (int)huffcode[p] << (8 - l);
            for (int c = 1 << (8 - l); c > 0; --c)
                h->look[look++] = (uint16_t)((l << 8) | h->vals[p]);
        }
    }
    return 0;
}

static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ----------------------------------------------- JPEG: libjpeg's data source
// The entropy decoders read bytes as libjpeg's jdmarker.c hands them:
// `unread` is the marker a decoder ran into (0 for none); reading at `avail`
// (the end of the bytes handed over so far: the file's end unless the
// Huffman scan sets it) sets `eof` (past the file's end PIL reports it
// truncated).

struct Src {
    const uint8_t* data;
    int64_t len, pos;
    int unread;
    bool eof;
    int64_t avail;
};

static inline int src_byte(Src* s) {
    if (s->pos >= s->avail) {
        s->eof = true;
        return 0;
    }
    return s->data[s->pos++];
}

// next_marker: skip to an 0xFF, swallow 0xFF fill, skip FF 00 pairs
static bool next_marker(Src* s) {
    for (;;) {
        int c = src_byte(s);
        while (c != 0xFF && !s->eof) c = src_byte(s);
        do c = src_byte(s);
        while (c == 0xFF && !s->eof);
        if (s->eof) return false;
        if (c != 0) {
            s->unread = c;
            return true;
        }
    }
}

// read_restart_marker with jpeg_resync_to_restart; false at the end of data
static bool read_restart(Src* s, int expect) {
    if (s->unread == 0 && !next_marker(s)) return false;
    if (s->unread == 0xD0 + expect) {
        s->unread = 0;
        return true;
    }
    int marker = s->unread;
    for (;;) {
        int action;
        if (marker < 0xC0) {
            action = 2;
        } else if (marker < 0xD0 || marker > 0xD7) {
            action = 3;
        } else if (marker == 0xD0 + ((expect + 1) & 7) || marker == 0xD0 + ((expect + 2) & 7)) {
            action = 3;
        } else if (marker == 0xD0 + ((expect - 1) & 7) || marker == 0xD0 + ((expect - 2) & 7)) {
            action = 2;
        } else {
            action = 1;
        }
        if (action == 1) {
            s->unread = 0;
            return true;
        }
        if (action == 3) return true;
        if (!next_marker(s)) return false;
        marker = s->unread;
    }
}

// the position of the marker that ends a scan (its last 0xFF), or the end
// of the data when none follows (the caller decides whether a file may end
// there); -6 when the scan itself ran past the end
static int64_t scan_end(Src* s) {
    if (s->eof) return -6;
    if (s->unread == 0 && !next_marker(s)) return s->len;
    return s->pos - 2;
}

// ------------------------------------------ JPEG: arithmetic decoding (F, D)
// jaricom.c's jpeg_aritab: (Qe << 16) | (Next_Index_MPS << 8) |
// (Switch_MPS << 7) | Next_Index_LPS; state 113 is the fixed bin's.
static const int32_t kQe[114] = {
    0x5A1D0181, 0x2586020E, 0x11140310, 0x080B0412, 0x03D80514, 0x01DA0617, 0x00E50719,
    0x006F081C, 0x0036091E, 0x001A0A21, 0x000D0B23, 0x00060C09, 0x00030D0A, 0x00010D0C,
    0x5A7F0F8F, 0x3F251024, 0x2CF21126, 0x207C1227, 0x17B91328, 0x1182142A, 0x0CEF152B,
    0x09A1162D, 0x072F172E, 0x055C1830, 0x04061931, 0x03031A33, 0x02401B34, 0x01B11C36,
    0x01441D38, 0x00F51E39, 0x00B71F3B, 0x008A203C, 0x0068213E, 0x004E223F, 0x003B2320,
    0x002C0921, 0x5AE125A5, 0x484C2640, 0x3A0D2741, 0x2EF12843, 0x261F2944, 0x1F332A45,
    0x19A82B46, 0x15182C48, 0x11772D49, 0x0E742E4A, 0x0BFB2F4B, 0x09F8304D, 0x0861314E,
    0x0706324F, 0x05CD3330, 0x04DE3432, 0x040F3532, 0x03633633, 0x02D43734, 0x025C3835,
    0x01F83936, 0x01A43A37, 0x01603B38, 0x01253C39, 0x00F63D3A, 0x00CB3E3B, 0x00AB3F3D,
    0x008F203D, 0x5B1241C1, 0x4D044250, 0x412C4351, 0x37D84452, 0x2FE84553, 0x293C4654,
    0x23794756, 0x1EDF4857, 0x1AA94957, 0x174E4A48, 0x14244B48, 0x119C4C4A, 0x0F6B4D4A,
    0x0D514E4B, 0x0BB64F4D, 0x0A40304D, 0x583251D0, 0x4D1C5258, 0x438E5359, 0x3BDD545A,
    0x34EE555B, 0x2EAE565C, 0x299A575D, 0x25164756, 0x557059D8, 0x4CA95A5F, 0x44D95B60,
    0x3E225C61, 0x38245D63, 0x32B45E63, 0x2E17565D, 0x56A860DF, 0x4F466165, 0x47E56266,
    0x41CF6367, 0x3C3D6468, 0x375E5D63, 0x52316669, 0x4C0F676A, 0x4639686B, 0x415E6367,
    0x56276AE9, 0x50E76B6C, 0x4B85676D, 0x55976D6E, 0x504F6B6F, 0x5A106FEE, 0x55226D70,
    0x59EB6FF0, 0x5A1D7171};

struct Arith {
    Src* src;
    int64_t c, a;
    int ct;  // -16: fetch two bytes first; 0..7 running; -1 after a bad code
};

// jdarith.c arith_decode: renormalisation and byte input (D.2.6), then the
// decision and the estimation of bin *st (D.2.4, D.2.5)
static inline int arith_decode(Arith* e, uint8_t* st) {
    while (e->a < 0x8000) {
        if (--e->ct < 0) {
            int data = 0;
            Src* s = e->src;
            if (!s->unread) {
                data = src_byte(s);
                if (data == 0xFF) {
                    do data = src_byte(s);
                    while (data == 0xFF && !s->eof);
                    if (data == 0) {
                        data = 0xFF;
                    } else {
                        s->unread = data;
                        data = 0;
                    }
                }
            }
            e->c = (e->c << 8) | data;
            if ((e->ct += 8) < 0)
                if (++e->ct == 0) e->a = 0x8000;
        }
        e->a <<= 1;
    }
    int sv = *st;
    int32_t qe = kQe[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = e->a - qe;
    e->a = temp;
    temp <<= e->ct;
    if (e->c >= temp) {
        e->c -= temp;
        if (e->a < qe) {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (e->a < 0x8000) {
        if (e->a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

struct ArithScan {
    Arith e;
    uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin[1];
    int last_dc[4], dc_context[4], dc_tbl[4], ac_tbl[4];
    const uint8_t* cond;  // DC L[16], DC U[16], AC Kx[16]
    int ncomp, ss, se, ah, al;
    bool progressive;
};

// start_pass and process_restart: statistics zeroed for the scan's tables,
// predictions and contexts 0, the coder reset
static void arith_start(ArithScan* s) {
    for (int ci = 0; ci < s->ncomp; ++ci) {
        if (!s->progressive || (s->ss == 0 && s->ah == 0)) {
            std::memset(s->dc_stats[s->dc_tbl[ci]], 0, 64);
            s->last_dc[ci] = 0;
            s->dc_context[ci] = 0;
        }
        if (!s->progressive || s->ss) std::memset(s->ac_stats[s->ac_tbl[ci]], 0, 256);
    }
    s->e.c = 0;
    s->e.a = 0;
    s->e.ct = -16;
}

// Decode_DC_DIFF (F.19, F.21-F.24) into last_dc[ci]; false after a bad code
static bool arith_dc(ArithScan* s, int ci) {
    const int tbl = s->dc_tbl[ci];
    uint8_t* st = s->dc_stats[tbl] + s->dc_context[ci];
    if (arith_decode(&s->e, st) == 0) {
        s->dc_context[ci] = 0;
        return true;
    }
    const int sign = arith_decode(&s->e, st + 1);
    st += 2 + sign;
    int m = arith_decode(&s->e, st);
    if (m != 0) {
        st = s->dc_stats[tbl] + 20;
        while (arith_decode(&s->e, st)) {
            if ((m <<= 1) == 0x8000) return false;
            st += 1;
        }
    }
    if (m < (int)((1L << s->cond[tbl]) >> 1))
        s->dc_context[ci] = 0;
    else if (m > (int)((1L << s->cond[16 + tbl]) >> 1))
        s->dc_context[ci] = 12 + sign * 4;
    else
        s->dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(&s->e, st)) v |= m;
    v += 1;
    if (sign) v = -v;
    s->last_dc[ci] = (s->last_dc[ci] + v) & 0xFFFF;
    return true;
}

// Decode_AC_coefficients (F.20-F.24) lo..hi into blk, scaled by al
static bool arith_ac(ArithScan* s, int ci, int16_t* blk, int lo, int hi, int al) {
    const int tbl = s->ac_tbl[ci];
    for (int k = lo; k <= hi; k++) {
        uint8_t* st = s->ac_stats[tbl] + 3 * (k - 1);
        if (arith_decode(&s->e, st)) break;  // EOB
        while (arith_decode(&s->e, st + 1) == 0) {
            st += 3;
            if (++k > hi) return false;
        }
        const int sign = arith_decode(&s->e, s->fixed_bin);
        st += 2;
        int m = arith_decode(&s->e, st);
        if (m != 0) {
            if (arith_decode(&s->e, st)) {
                m <<= 1;
                st = s->ac_stats[tbl] + (k <= s->cond[32 + tbl] ? 189 : 217);
                while (arith_decode(&s->e, st)) {
                    if ((m <<= 1) == 0x8000) return false;
                    st += 1;
                }
            }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
            if (arith_decode(&s->e, st)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[kNatural[k]] = (int16_t)((unsigned)v << al);
    }
    return true;
}

// decode_mcu_AC_refine on one block
static bool arith_ac_refine(ArithScan* s, int ci, int16_t* blk) {
    const int tbl = s->ac_tbl[ci];
    const int p1 = 1 << s->al, m1 = -1 * (1 << s->al);
    int kex;
    for (kex = s->se; kex > 0; kex--)
        if (blk[kNatural[kex]]) break;
    for (int k = s->ss; k <= s->se; k++) {
        uint8_t* st = s->ac_stats[tbl] + 3 * (k - 1);
        if (k > kex)
            if (arith_decode(&s->e, st)) break;  // EOB
        for (;;) {
            int16_t* t = blk + kNatural[k];
            if (*t) {
                if (arith_decode(&s->e, st + 2)) *t = (int16_t)(*t + (*t < 0 ? m1 : p1));
                break;
            }
            if (arith_decode(&s->e, st + 1)) {
                *t = (int16_t)(arith_decode(&s->e, s->fixed_bin) ? m1 : p1);
                break;
            }
            st += 3;
            if (++k > s->se) return false;
        }
    }
    return true;
}

// one block of the scan's kind; false after a bad code
static bool arith_block(ArithScan* s, int ci, int16_t* blk) {
    if (!s->progressive) {
        if (!arith_dc(s, ci)) return false;
        blk[0] = (int16_t)s->last_dc[ci];
        return arith_ac(s, ci, blk, 1, 63, 0);
    }
    if (s->ss == 0) {
        if (s->ah) {
            if (arith_decode(&s->e, s->fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << s->al));
            return true;
        }
        if (!arith_dc(s, ci)) return false;
        blk[0] = (int16_t)((unsigned)s->last_dc[ci] << s->al);
        return true;
    }
    if (s->ah) return arith_ac_refine(s, ci, blk);
    return arith_ac(s, ci, blk, s->ss, s->se, s->al);
}

// One arithmetic-coded scan (jdarith.c decode_mcu, decode_mcu_DC_first,
// _AC_first, _DC_refine, _AC_refine, process_restart). comps: ncomp rows
// of 7 int32: H, V, blocks_w, blocks across and down (non-interleaved), DC
// table, AC table. cond: the DAC values, DC L[16], DC U[16], AC Kx[16].
// coefs, mcus_x, mcus_y, the restart interval, ss, se, ah, al and kind as
// fd_jpeg_scan. After a bad code (a category or spectral overflow) the
// rest of the restart interval decodes nothing, as libjpeg's ct = -1.
// Returns the position of the marker that ends the scan, or -6 when the
// data ends first.
int64_t fd_jpeg_arith_scan(const uint8_t* data, int64_t len, int64_t pos, int ncomp,
                           const int32_t* comps, const uint8_t* cond, int16_t* const* coefs,
                           int mcus_x, int mcus_y, int restart_interval, int ss, int se,
                           int ah, int al, int kind) {
    if (ncomp < 1 || ncomp > 4) return -2;
    Src src{data, len, pos, 0, false, len};
    ArithScan s;
    s.e.src = &src;
    s.fixed_bin[0] = 113;
    s.cond = cond;
    s.ncomp = ncomp;
    s.ss = ss;
    s.se = se;
    s.ah = ah;
    s.al = al;
    s.progressive = kind == 1;
    for (int ci = 0; ci < ncomp; ++ci) {
        s.dc_tbl[ci] = comps[ci * 7 + 5] & 15;
        s.ac_tbl[ci] = comps[ci * 7 + 6] & 15;
    }
    arith_start(&s);
    int64_t total;
    int per_row;
    if (ncomp == 1) {
        per_row = comps[3];
        total = (int64_t)comps[3] * comps[4];
    } else {
        per_row = mcus_x;
        total = (int64_t)mcus_x * mcus_y;
    }
    int rst_left = restart_interval, next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
        if (restart_interval) {
            if (rst_left == 0) {
                if (!read_restart(&src, next_rst)) return -6;
                next_rst = (next_rst + 1) & 7;
                rst_left = restart_interval;
                arith_start(&s);
            }
            --rst_left;
        }
        if (s.e.ct == -1) continue;
        const int my = (int)(m / per_row), mx = (int)(m % per_row);
        bool ok = true;
        for (int ci = 0; ci < ncomp && ok; ++ci) {
            const int32_t* c = comps + ci * 7;
            const int hh = ncomp == 1 ? 1 : c[0], vv = ncomp == 1 ? 1 : c[1];
            for (int v = 0; v < vv && ok; ++v) {
                for (int h = 0; h < hh && ok; ++h) {
                    const int64_t row = (int64_t)my * vv + v, col = (int64_t)mx * hh + h;
                    ok = arith_block(&s, ci, coefs[ci] + (row * c[2] + col) * 64);
                }
            }
        }
        if (!ok) s.e.ct = -1;
        if (src.eof) return -6;
    }
    return scan_end(&src);
}

// ---------------------------------------------- JPEG: jdhuff.c's bit reader
// As jdhuff.c, jdphuff.c and jdlhuff.c drive it: each fill loads bytes until
// 57 bits are buffered (MIN_GET_BITS), reading ahead of the bits used (data
// that ends first sets the source's eof); a marker stops the feed and zero
// bits follow, `short_data` set once a fill needs bits past it
// (insufficient_data). The top n bits of acc's low bits are the buffer
// (bits above them are stale, as in libjpeg's get_buffer).
struct LBits {
    Src* src;
    uint64_t acc;
    int n;
    bool short_data;
    bool hit_marker;  // the fast path met a marker: decode the MCU again
};

static inline int peek(const LBits* b, int k) {
    return (int)((b->acc >> (b->n - k)) & (((uint64_t)1 << k) - 1));
}

static void lbits_fill(LBits* b, int need) {
    Src* s = b->src;
    if (!s->unread) {
        while (b->n < 57) {
            int c = src_byte(s);
            if (s->eof) return;
            if (c == 0xFF) {
                do c = src_byte(s);
                while (c == 0xFF && !s->eof);
                if (s->eof) return;
                if (c != 0) {
                    s->unread = c;
                    break;
                }
                c = 0xFF;
            }
            b->acc = (b->acc << 8) | (uint64_t)c;
            b->n += 8;
        }
        if (b->n >= 57) return;
    }
    if (need > b->n) {
        b->short_data = true;
        b->acc <<= 57 - b->n;
        b->n = 57;
    }
}

static inline int lbits_get(LBits* b, int k) {
    if (b->n < k) lbits_fill(b, k);
    if (b->n < k) return 0;  // only at the end of the data (eof)
    const int v = peek(b, k);
    b->n -= k;
    return v;
}

// HUFF_DECODE: the 8-bit lookahead, else jpeg_huff_decode bit by bit from
// 9 bits (from 1 when fewer than 8 are buffered); a code past 16 bits
// decodes as 0 with 17 read
static inline int lbits_decode(LBits* b, const Huff* h) {
    if (b->n < 8) lbits_fill(b, 0);
    int l = 1;
    if (b->n >= 8) {
        const int e = h->look[peek(b, 8)];
        l = e >> 8;
        if (l <= 8) {
            b->n -= l;
            return e & 0xFF;
        }
    }
    int code = lbits_get(b, l);
    while (code > h->maxcode[l]) {
        code = (code << 1) | lbits_get(b, 1);
        ++l;
    }
    if (l > 16) return 0;
    return h->vals[(code + h->valoffset[l]) & 0xFF];
}

// decode_mcu_fast's FILL_BIT_BUFFER_FAST: six bytes once 16 bits or fewer
// remain; an 0xFF not followed by 0 feeds a zero byte in its place, stays
// unread and sends the MCU to the slow path
static inline void fast_fill(LBits* b) {
    if (b->n > 16) return;
    Src* s = b->src;
    int64_t p = s->pos;
    for (int i = 0; i < 6; ++i) {
        const int c0 = p < s->len ? s->data[p] : 0, c1 = p + 1 < s->len ? s->data[p + 1] : 0;
        ++p;
        b->acc = (b->acc << 8) | (uint64_t)c0;
        b->n += 8;
        if (c0 == 0xFF) {
            ++p;
            if (c1 != 0) {
                b->hit_marker = true;
                p -= 2;
                b->acc &= ~(uint64_t)0xFF;
            }
        }
    }
    s->pos = p;
}

static inline int fast_get(LBits* b, int k) {
    fast_fill(b);
    b->n -= k;
    return (int)((b->acc >> b->n) & (((uint64_t)1 << k) - 1));
}

// HUFF_DECODE_FAST: the same code read after FILL_BIT_BUFFER_FAST
static inline int fast_decode(LBits* b, const Huff* h) {
    fast_fill(b);
    const int e = h->look[peek(b, 8)];
    int l = e >> 8;
    b->n -= l;
    if (l <= 8) return e & 0xFF;
    int code = (int)((b->acc >> b->n) & (((uint64_t)1 << l) - 1));
    while (code > h->maxcode[l]) {
        --b->n;
        code = (code << 1) | (int)((b->acc >> b->n) & 1);
        ++l;
    }
    if (l > 16) return 0;
    return h->vals[(code + h->valoffset[l]) & 0xFF];
}

// ------------------------------------------------------ JPEG: Huffman scans
// jdhuff.c decode_mcu_slow, or decode_mcu_fast when fast, on one MCU's
// blocks: each block's DC difference (its prediction wraps as libjpeg's
// unsigned sum) and AC run/size codes
static inline void sequential_mcu(bool fast, LBits* b, int nblk, int16_t* const* blks,
                                  const int* blk_ci, const Huff* dc, const Huff* ac, int* pred) {
    for (int i = 0; i < nblk; ++i) {
        const int ci = blk_ci[i];
        int16_t* blk = blks[i];
        int s = fast ? fast_decode(b, &dc[ci]) : lbits_decode(b, &dc[ci]);
        if (s) s = extend(fast ? fast_get(b, s) : lbits_get(b, s), s);
        pred[ci] = (int)((unsigned)pred[ci] + (unsigned)s);
        blk[0] = (int16_t)pred[ci];
        for (int k = 1; k < 64; ++k) {
            const int rs = fast ? fast_decode(b, &ac[ci]) : lbits_decode(b, &ac[ci]);
            const int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(fast ? fast_get(b, s) : lbits_get(b, s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }
}

// jdphuff.c decode_mcu_DC_first, _DC_refine, _AC_first and _AC_refine on
// one MCU's blocks
static void progressive_mcu(LBits* b, int nblk, int16_t* const* blks, const int* blk_ci,
                            const Huff* dc, const Huff* ac, int* pred, int* eobrun, int ss,
                            int se, int ah, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    for (int i = 0; i < nblk; ++i) {
        const int ci = blk_ci[i];
        int16_t* blk = blks[i];
        if (ss == 0) {
            if (ah == 0) {
                int s = lbits_decode(b, &dc[ci]);
                if (s) s = extend(lbits_get(b, s), s);
                pred[ci] += s;
                blk[0] = (int16_t)((unsigned)pred[ci] << al);
            } else if (lbits_get(b, 1)) {
                blk[0] = (int16_t)(blk[0] | p1);
            }
        } else if (ah == 0) {
            if (*eobrun > 0) {
                --*eobrun;
                continue;
            }
            for (int k = ss; k <= se; ++k) {
                const int rs = lbits_decode(b, &ac[ci]);
                const int r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    blk[kNatural[k]] = (int16_t)((unsigned)extend(lbits_get(b, s), s) << al);
                } else if (r == 15) {
                    k += 15;
                } else {
                    *eobrun = 1 << r;
                    if (r) *eobrun += lbits_get(b, r);
                    --*eobrun;
                    break;
                }
            }
        } else {
            int k = ss;
            if (*eobrun == 0) {
                for (; k <= se; ++k) {
                    const int rs = lbits_decode(b, &ac[ci]);
                    int r = rs >> 4, s = rs & 15;
                    if (s) {
                        s = lbits_get(b, 1) ? p1 : m1;
                    } else if (r != 15) {
                        *eobrun = 1 << r;
                        if (r) *eobrun += lbits_get(b, r);
                        break;
                    }
                    do {
                        int16_t* t = blk + kNatural[k];
                        if (*t != 0) {
                            if (lbits_get(b, 1) && (*t & p1) == 0)
                                *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
                        } else if (--r < 0) {
                            break;
                        }
                        ++k;
                    } while (k <= se);
                    if (s) blk[kNatural[k]] = (int16_t)s;
                }
            }
            if (*eobrun > 0) {
                for (; k <= se; ++k) {
                    int16_t* t = blk + kNatural[k];
                    if (*t != 0 && lbits_get(b, 1) && (*t & p1) == 0)
                        *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
                }
                --*eobrun;
            }
        }
    }
}

// PIL hands libjpeg a file in reads of 65536 bytes (ImageFile.MAXBLOCK);
// the fast path needs 512 bytes a block of the MCU in the source buffer
static const int64_t kChunk = 65536, kFastBytes = 512;

// One Huffman scan (jdhuff.c decode_mcu, jdphuff.c, process_restart) fed
// as PIL feeds libjpeg: the bytes handed over end at the read that held the
// scan's header, and an MCU that runs past them is decoded again with the
// next read (which may let it take the fast path); past the file's end the
// file is truncated (-6). comps (ncomp rows of 5 int32): H, V (the
// component's blocks in an MCU), blocks_w (the row pitch of its
// coefficient array), and the blocks a non-interleaved scan covers across
// and down. tabs: per component its DC spec then its AC spec (16 + 256
// bytes each; a table the scan does not use may be zeros). coefs[i]: the
// component's (blocks_h, blocks_w, 64) int16 coefficients in natural
// order, updated in place. mcus_x, mcus_y: the interleaved MCU grid. kind:
// 0 sequential, 1 progressive. After a marker cuts the data short, the rest
// of the restart interval decodes nothing (a DC refinement reads zeros).
// last_good: the iMCU row of the last MCU begun with data left. Returns
// the position of the marker that ends the scan, the end of the data when
// none follows, or a negative code.
int64_t fd_jpeg_scan(const uint8_t* data, int64_t len, int64_t pos, int ncomp,
                     const int32_t* comps, const uint8_t* tabs, int16_t* const* coefs,
                     int mcus_x, int mcus_y, int restart_interval, int ss, int se,
                     int ah, int al, int kind, int32_t* last_good) {
    if (ncomp < 1 || ncomp > 4) return -2;
    Huff dc[4], ac[4];
    for (int i = 0; i < ncomp; ++i) {
        if (build_huff(tabs + i * 544, &dc[i]) < 0) return -3;
        if (build_huff(tabs + i * 544 + 272, &ac[i]) < 0) return -3;
    }
    const bool progressive = kind == 1, fast_ok = !progressive && restart_interval == 0;
    const bool refine_dc = progressive && ss == 0 && ah != 0;
    Src src{data, len, pos, 0, false, len};
    if (fast_ok) src.avail = std::min(len, std::max(kChunk, (pos + kChunk - 1) / kChunk * kChunk));
    LBits b{&src, 0, 0, false, false};
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int64_t total;
    int per_row, imcu_v;
    if (ncomp == 1) {
        per_row = comps[3];
        total = (int64_t)comps[3] * comps[4];
        imcu_v = comps[1];
    } else {
        per_row = mcus_x;
        total = (int64_t)mcus_x * mcus_y;
        imcu_v = 1;
    }
    int16_t* blks[64];
    int blk_ci[64], nblk = 0;
    int16_t saved[64 * 64];
    int rst_left = restart_interval, next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
        const int my = (int)(m / per_row), mx = (int)(m % per_row);
        if (!b.short_data) *last_good = my / imcu_v;
        if (restart_interval && rst_left == 0) {
            b.acc = 0;
            b.n = 0;
            if (!read_restart(&src, next_rst)) return -6;
            next_rst = (next_rst + 1) & 7;
            rst_left = restart_interval;
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
            eobrun = 0;
            if (src.unread == 0) b.short_data = false;
        }
        nblk = 0;
        for (int ci = 0; ci < ncomp; ++ci) {
            const int32_t* c = comps + ci * 5;
            const int hh = ncomp == 1 ? 1 : c[0], vv = ncomp == 1 ? 1 : c[1];
            for (int v = 0; v < vv; ++v)
                for (int h = 0; h < hh; ++h) {
                    const int64_t row = (int64_t)my * vv + v, col = (int64_t)mx * hh + h;
                    blk_ci[nblk] = ci;
                    blks[nblk++] = coefs[ci] + (row * c[2] + col) * 64;
                }
        }
        if (!b.short_data || refine_dc) {
            for (;;) {
                const int64_t pos0 = src.pos;
                const int unread0 = src.unread, n0 = b.n, eob0 = eobrun;
                const uint64_t acc0 = b.acc;
                const bool short0 = b.short_data;
                int pred0[4];
                std::memcpy(pred0, pred, sizeof(pred));
                for (int i = 0; i < nblk; ++i) std::memcpy(saved + i * 64, blks[i], 128);
                if (progressive) {
                    progressive_mcu(&b, nblk, blks, blk_ci, dc, ac, pred, &eobrun, ss, se, ah, al);
                } else {
                    bool done = false;
                    if (fast_ok && src.unread == 0 && src.avail - src.pos >= kFastBytes * nblk) {
                        b.hit_marker = false;
                        sequential_mcu(true, &b, nblk, blks, blk_ci, dc, ac, pred);
                        done = !b.hit_marker;
                        if (!done) {
                            src.pos = pos0;
                            src.unread = unread0;
                            b.acc = acc0;
                            b.n = n0;
                            std::memcpy(pred, pred0, sizeof(pred));
                        }
                    }
                    if (!done) sequential_mcu(false, &b, nblk, blks, blk_ci, dc, ac, pred);
                }
                if (!src.eof) break;
                if (src.avail >= len) return -6;
                src.pos = pos0;
                src.unread = unread0;
                src.eof = false;
                src.avail = std::min(len, src.avail + kChunk);
                b.acc = acc0;
                b.n = n0;
                b.short_data = short0;
                eobrun = eob0;
                std::memcpy(pred, pred0, sizeof(pred));
                for (int i = 0; i < nblk; ++i) std::memcpy(blks[i], saved + i * 64, 128);
            }
        }
        if (restart_interval) --rst_left;
    }
    src.avail = len;
    return scan_end(&src);
}

// ------------------------------------------------ JPEG: lossless (H, jdlhuff)
static inline int predict(int psv, int ra, int rb, int rc) {
    switch (psv) {
        case 1: return ra;
        case 2: return rb;
        case 3: return rc;
        case 4: return ra + rb - rc;
        case 5: return ra + ((rb - rc) >> 1);
        case 6: return rb + ((ra - rc) >> 1);
        default: return (ra + rb) >> 1;
    }
}

// One lossless scan (jdlhuff.c decode_mcus, jddiffct.c decompress_data and
// process_restart, jdlossls.c's undifferencers and scaler). comps: ncomp
// rows of 4 int32: H, V, samples across (width_in_blocks), samples down.
// tabs: per component its DC Huffman spec (272 bytes; symbols 0-16, 16
// meaning 32768 with no extra bits). planes[i]: the component's (down,
// across) uint8 samples. mcus_x, mcus_y: the interleaved MCU grid (one
// sample a data unit), also the scan's iMCU rows. psv: the predictor
// (1-7); pt: the point transform. A restart (every restart_interval MCUs,
// a whole number of MCU rows) and data that ran out at a marker reset
// every component to the first-row rule, which takes effect at the next
// row undifferenced (libjpeg undifferences an iMCU row once all its MCU
// rows are decoded). Returns the position of the marker that ends the
// scan, -3 for a bad table, -4 for a restart interval that is not whole
// MCU rows, -6 when the data ends first.
int64_t fd_jpeg_lossless_scan(const uint8_t* data, int64_t len, int64_t pos, int ncomp,
                              const int32_t* comps, const uint8_t* tabs,
                              uint8_t* const* planes, int mcus_x, int mcus_y,
                              int restart_interval, int psv, int pt) {
    if (ncomp < 1 || ncomp > 4 || psv < 1 || psv > 7 || pt < 0 || pt > 7) return -2;
    Huff huff[4];
    for (int i = 0; i < ncomp; ++i)
        if (build_huff(tabs + i * 272, &huff[i]) < 0) return -3;
    const bool interleaved = ncomp > 1;
    const int per_row = interleaved ? mcus_x : comps[2];
    if (per_row < 1 || restart_interval % per_row) return -4;
    const int rows_per_restart = restart_interval / per_row;
    int mw[4], mh[4], width[4];
    std::vector<int32_t> diff[4], prev[4], cur[4];
    for (int ci = 0; ci < ncomp; ++ci) {
        const int32_t* c = comps + ci * 4;
        mw[ci] = interleaved ? c[0] : 1;
        mh[ci] = interleaved ? c[1] : 1;
        width[ci] = per_row * mw[ci];
        diff[ci].assign((size_t)c[1] * width[ci], 0);
        prev[ci].assign(c[2], 0);
        cur[ci].assign(c[2], 0);
    }
    Src src{data, len, pos, 0, false, len};
    LBits b{&src, 0, 0, false};
    bool first[4] = {true, true, true, true};
    int to_go = rows_per_restart, next_rst = 0;
    const int initial = 1 << (8 - pt - 1);
    for (int r = 0; r < mcus_y; ++r) {
        const bool last = r == mcus_y - 1;
        int heights[4];
        for (int ci = 0; ci < ncomp; ++ci) {
            const int v = comps[ci * 4 + 1], ch = comps[ci * 4 + 3];
            heights[ci] = last ? (ch % v ? ch % v : v) : v;
            std::fill(diff[ci].begin(), diff[ci].end(), 0);
        }
        const int mcu_rows = interleaved ? 1 : heights[0];
        for (int y = 0; y < mcu_rows; ++y) {
            if (restart_interval && to_go == 0) {
                b.acc = 0;
                b.n = 0;
                if (!read_restart(&src, next_rst)) return -6;
                next_rst = (next_rst + 1) & 7;
                if (src.unread == 0) b.short_data = false;
                for (int ci = 0; ci < 4; ++ci) first[ci] = true;
                to_go = rows_per_restart;
            }
            if (b.short_data) {
                for (int ci = 0; ci < 4; ++ci) first[ci] = true;  // zero differences
            } else {
                for (int mx = 0; mx < per_row; ++mx) {
                    for (int ci = 0; ci < ncomp; ++ci) {
                        for (int yy = 0; yy < mh[ci]; ++yy) {
                            int32_t* d = diff[ci].data() + (size_t)(y + yy) * width[ci] + mx * mw[ci];
                            for (int xx = 0; xx < mw[ci]; ++xx) {
                                const int s = lbits_decode(&b, &huff[ci]);
                                int v = 0;
                                if (s == 16) {
                                    v = 32768;
                                } else if (s) {
                                    v = extend(lbits_get(&b, s), s);
                                }
                                d[xx] = v;
                            }
                        }
                    }
                }
                if (src.eof) return -6;
            }
            if (restart_interval) --to_go;
        }
        for (int ci = 0; ci < ncomp; ++ci) {
            const int cw = comps[ci * 4 + 2], v = comps[ci * 4 + 1];
            for (int y = 0; y < heights[ci]; ++y) {
                const int32_t* d = diff[ci].data() + (size_t)y * width[ci];
                int32_t* out = cur[ci].data();
                const int32_t* up = prev[ci].data();
                int ra;
                if (first[ci]) {
                    ra = (d[0] + initial) & 0xFFFF;
                    out[0] = ra;
                    for (int x = 1; x < cw; ++x) out[x] = ra = (d[x] + ra) & 0xFFFF;
                    first[ci] = false;
                } else {
                    ra = (d[0] + up[0]) & 0xFFFF;
                    out[0] = ra;
                    for (int x = 1; x < cw; ++x)
                        out[x] = ra = (d[x] + predict(psv, ra, up[x], up[x - 1])) & 0xFFFF;
                }
                uint8_t* dst = planes[ci] + ((int64_t)r * v + y) * cw;
                for (int x = 0; x < cw; ++x) dst[x] = (uint8_t)(out[x] << pt);
                std::swap(cur[ci], prev[ci]);
            }
        }
    }
    return scan_end(&src);
}

// ------------------------------------------- JPEG: block smoothing (jdcoefct)
// decompress_smooth_data's estimate of one still-zero coefficient: num / (q
// << 8) rounded, its magnitude capped below 1 << al when al > 0
static inline int16_t smooth_pred(int64_t num, int64_t q, int al) {
    int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
    if (al > 0 && pred >= ((int64_t)1 << al)) pred = ((int64_t)1 << al) - 1;
    return (int16_t)(num >= 0 ? pred : -pred);
}

// Block smoothing of an incomplete progressive component (jdcoefct.c
// decompress_smooth_data, libjpeg-turbo 3.1.3): out is a copy of coefs
// (bh, bw, 64) in which each block within (nbh, nbw) has its still-zero
// coefficients 1-5 (and, for a component no AC scan reached, 6-9 and its
// DC) estimated from the DC values of its 5x5 neighbourhood. rows (nbh, 5)
// and cols (nbw, 5): the block rows and columns the neighbourhood reads
// (jpeg.smooth_geometry); qt: the natural-order quantisers; latches (2, 10):
// the coef_bits latch of DC and coefficients 1-9 (a coefficient is
// estimated unless its latch is 0) for the iMCU rows (v block rows each)
// up to last_good, and the one for the rows past it.
int fd_jpeg_smooth(const int16_t* coefs, int bh, int bw, int nbh, int nbw, const int32_t* rows,
                   const int32_t* cols, const uint16_t* qt, const int32_t* latches, int v,
                   int last_good, int16_t* out) {
    std::memcpy(out, coefs, (size_t)bh * bw * 64 * sizeof(int16_t));
    const int64_t Q00 = qt[0], Q01 = qt[1], Q10 = qt[8], Q20 = qt[16], Q11 = qt[9],
                  Q02 = qt[2], Q03 = qt[3], Q12 = qt[10], Q21 = qt[17], Q30 = qt[24];
    for (int by = 0; by < nbh; ++by) {
        const int32_t* bits = latches + (by / v > last_good ? 10 : 0);
        bool change_dc = true;
        for (int k = 1; k <= 9; ++k) change_dc = change_dc && bits[k] == -1;
        for (int bx = 0; bx < nbw; ++bx) {
            int64_t d[26];  // DC01..DC25 as libjpeg numbers them (d[0] unused)
            for (int i = 0; i < 5; ++i)
                for (int j = 0; j < 5; ++j)
                    d[1 + i * 5 + j] =
                        coefs[((int64_t)rows[by * 5 + i] * bw + cols[bx * 5 + j]) * 64];
            int16_t* ws = out + ((int64_t)by * bw + bx) * 64;
            int al;
            if ((al = bits[1]) != 0 && ws[1] == 0) {
                const int64_t num = Q00 * (change_dc ?
                    (-d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] + 3 * d[10] -
                     3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15] - 3 * d[16] + 13 * d[17] -
                     13 * d[19] + 3 * d[20] - d[21] - d[22] + d[24] + d[25]) :
                    (-7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]));
                ws[1] = smooth_pred(num, Q01, al);
            }
            if ((al = bits[2]) != 0 && ws[8] == 0) {
                const int64_t num = Q00 * (change_dc ?
                    (-d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7] +
                     38 * d[8] + 13 * d[9] - d[10] + d[16] - 13 * d[17] - 38 * d[18] -
                     13 * d[19] + d[20] + d[21] + 3 * d[22] + 3 * d[23] + 3 * d[24] + d[25]) :
                    (-7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]));
                ws[8] = smooth_pred(num, Q10, al);
            }
            if ((al = bits[3]) != 0 && ws[16] == 0) {
                const int64_t num = Q00 * (change_dc ?
                    (d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13] -
                     5 * d[14] + 2 * d[17] + 7 * d[18] + 2 * d[19] + d[23]) :
                    (-d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]));
                ws[16] = smooth_pred(num, Q20, al);
            }
            if ((al = bits[4]) != 0 && ws[9] == 0) {
                const int64_t num = Q00 * (change_dc ?
                    (-d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] + d[21] - d[25]) :
                    (d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] - d[24] +
                     d[4] - d[6] + 10 * d[7] - 10 * d[9]));
                ws[9] = smooth_pred(num, Q11, al);
            }
            if ((al = bits[5]) != 0 && ws[2] == 0) {
                const int64_t num = Q00 * (change_dc ?
                    (2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13] +
                     7 * d[14] + d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19]) :
                    (-d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]));
                ws[2] = smooth_pred(num, Q02, al);
            }
            if (!change_dc) continue;
            if ((al = bits[6]) != 0 && ws[3] == 0)
                ws[3] = smooth_pred(Q00 * (d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]),
                                    Q03, al);
            if ((al = bits[7]) != 0 && ws[10] == 0)
                ws[10] = smooth_pred(Q00 * (d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]),
                                     Q12, al);
            if ((al = bits[8]) != 0 && ws[17] == 0)
                ws[17] = smooth_pred(Q00 * (d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]),
                                     Q21, al);
            if ((al = bits[9]) != 0 && ws[24] == 0)
                ws[24] = smooth_pred(Q00 * (d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]),
                                     Q30, al);
            const int64_t num = Q00 *
                (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] + 6 * d[7] +
                 42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] + 152 * d[13] +
                 42 * d[14] - 8 * d[15] - 6 * d[16] + 6 * d[17] + 42 * d[18] + 6 * d[19] -
                 6 * d[20] - 2 * d[21] - 6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25]);
            ws[0] = smooth_pred(num, Q00, 0);
        }
    }
    return 0;
}

// The islow IDCT as libjpeg-turbo runs it on x86-64 (jsimd_idct_islow,
// jidctint-avx2.asm), which is what PIL's decode executes there. Its
// arithmetic is jidctint.c's (CONST_BITS 13, PASS1_BITS 2, the same
// constants, products regrouped exactly) in 16-bit lanes: the dequantised
// coefficient is the low 16 bits of coef * quantiser; in0 + in4, in0 - in4,
// in7 + in3 and in5 + in1 are 16-bit sums; pass 1's descaled results
// saturate to int16; a block whose rows 1-7 are all zero takes pass 1's
// shortcut (the DC << 2 in 16 bits); pass 2's results saturate to
// -128..127 before the +128. For every value that stays inside int16 this
// equals jidctint.c with its range-limit table; the two part only on
// coefficients no encoder of 8-bit samples writes (quantisers past 8191).
static inline int32_t wrap16(int64_t x) { return (int16_t)(uint16_t)(x & 0xFFFF); }
static inline int32_t sat16(int64_t x) { return x < -32768 ? -32768 : x > 32767 ? 32767 : (int32_t)x; }

static inline void dodct(const int32_t* x, int st, int n, int32_t* o, int ost) {
    const int64_t x0 = x[0], x1 = x[st], x2 = x[2 * st], x3 = x[3 * st], x4 = x[4 * st],
                  x5 = x[5 * st], x6 = x[6 * st], x7 = x[7 * st];
    const int64_t tmp3 = x2 * (4433 + 6270) + x6 * 4433;
    const int64_t tmp2 = x2 * 4433 + x6 * (4433 - 15137);
    const int64_t tmp0 = (int64_t)wrap16(x0 + x4) * 8192, tmp1 = (int64_t)wrap16(x0 - x4) * 8192;
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    const int64_t z3 = wrap16(x7 + x3), z4 = wrap16(x5 + x1);
    const int64_t z3p = z3 * (9633 - 16069) + z4 * 9633;
    const int64_t z4p = z3 * 9633 + z4 * (9633 - 3196);
    const int64_t t0 = x7 * (2446 - 7373) + x1 * -7373 + z3p;
    const int64_t t3 = x7 * -7373 + x1 * (12299 - 7373) + z4p;
    const int64_t t1 = x5 * (16819 - 20995) + x3 * -20995 + z4p;
    const int64_t t2 = x5 * -20995 + x3 * (25172 - 20995) + z3p;
    const int64_t v[8] = {t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                          t13 - t0, t12 - t1, t11 - t2, t10 - t3};
    const int64_t half = (int64_t)1 << (n - 1);
    for (int i = 0; i < 8; ++i) o[i * ost] = sat16((v[i] + half) >> n);
}

// coefs: (bh, bw, 64) int16 natural order; qt: 64 quantisers in natural
// order; out: (bh * 8, bw * 8) uint8 samples.
int fd_jpeg_idct_islow(const int16_t* coefs, int bh, int bw, const uint16_t* qt,
                       uint8_t* out) {
    const int64_t pitch = (int64_t)bw * 8;
    int32_t q[64];
    for (int i = 0; i < 64; ++i) q[i] = wrap16(qt[i]);
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            const int16_t* in = coefs + ((int64_t)by * bw + bx) * 64;
            int32_t d[64], ws[64], o[64];
            bool ac_zero = true;
            for (int i = 0; i < 64; ++i) {
                d[i] = wrap16((int64_t)in[i] * q[i]);
                if (i >= 8 && in[i]) ac_zero = false;
            }
            if (ac_zero) {
                for (int c = 0; c < 8; ++c) {
                    const int32_t dc = wrap16((int64_t)d[c] * 4);
                    for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
                }
            } else {
                for (int c = 0; c < 8; ++c) dodct(d + c, 8, 11, ws + c, 8);  // columns
            }
            for (int r = 0; r < 8; ++r) dodct(ws + r * 8, 1, 18, o + r * 8, 1);  // rows
            uint8_t* dst = out + (int64_t)by * 8 * pitch + (int64_t)bx * 8;
            for (int r = 0; r < 8; ++r)
                for (int c = 0; c < 8; ++c) {
                    const int32_t v = o[r * 8 + c];
                    dst[r * pitch + c] = (uint8_t)((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
                }
        }
    }
    return 0;
}

// One component plane (ch rows of cw samples, row pitch in_pitch) to the
// (oh, ow) output grid at integral factors (hx, vy). method: 0 box
// (fullsize when hx = vy = 1, int_upsample otherwise), 1 fancy h2v1,
// 2 fancy h2v2, 3 fancy h1v2. The fancy methods read the component's
// edge samples again past its edges (jdsample.c's first/last column cases
// and jdmainct.c's context rows).
int fd_jpeg_upsample(const uint8_t* in, int in_pitch, int cw, int ch, uint8_t* out, int ow,
                     int oh, int hx, int vy, int method) {
    if (cw < 1 || ch < 1) return -1;
    for (int y = 0; y < oh; ++y) {
        uint8_t* o = out + (int64_t)y * ow;
        int r = y / vy;
        if (r >= ch) r = ch - 1;
        const uint8_t* p = in + (int64_t)r * in_pitch;
        if (method == 0) {
            for (int x = 0; x < ow; ++x) {
                int c = x / hx;
                o[x] = p[c < cw ? c : cw - 1];
            }
        } else if (method == 1) {
            for (int x = 0; x < ow; ++x) {
                int c = x >> 1;
                if (c >= cw) c = cw - 1;
                int v3 = p[c] * 3;
                if (x & 1) {
                    int nb = p[c + 1 < cw ? c + 1 : cw - 1];
                    o[x] = (uint8_t)((v3 + nb + 2) >> 2);
                } else {
                    int nb = p[c > 0 ? c - 1 : 0];
                    o[x] = (uint8_t)((v3 + nb + 1) >> 2);
                }
            }
        } else {
            int rn = (y & 1) ? r + 1 : r - 1;
            rn = rn < 0 ? 0 : rn >= ch ? ch - 1 : rn;
            const uint8_t* q = in + (int64_t)rn * in_pitch;
            if (method == 3) {
                const int bias = (y & 1) ? 2 : 1;
                for (int x = 0; x < ow; ++x) {
                    int c = x < cw ? x : cw - 1;
                    o[x] = (uint8_t)((p[c] * 3 + q[c] + bias) >> 2);
                }
            } else {
                for (int x = 0; x < ow; ++x) {
                    int c = x >> 1;
                    if (c >= cw) c = cw - 1;
                    int cn = (x & 1) ? c + 1 : c - 1;
                    cn = cn < 0 ? 0 : cn >= cw ? cw - 1 : cn;
                    int t = p[c] * 3 + q[c], n = p[cn] * 3 + q[cn];
                    o[x] = (uint8_t)((x & 1) ? (t * 3 + n + 7) >> 4 : (t * 3 + n + 8) >> 4);
                }
            }
        }
    }
    return 0;
}

// jdcolor.c build_ycc_rgb_table, SCALEBITS 16
struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
};

static void ycc_tables(YccTables* t) {
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        t->cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
        t->cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
        t->cr_g[i] = -fix(0.71414) * x;
        t->cb_g[i] = -fix(0.34414) * x + one_half;
    }
}

static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// planes: the n samples of each of the first three components (Y, Cb,
// Cr). kind 0: YCbCr -> RGB (ycc_rgb_convert); kind 1: YCC -> the
// inverted RGB of YCCK -> CMYK (ycck_cmyk_convert's first three outputs).
// out: n pixels of 3 bytes.
int fd_jpeg_color(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int64_t n,
                  uint8_t* out, int kind) {
    YccTables t;
    ycc_tables(&t);
    for (int64_t i = 0; i < n; ++i) {
        const int Y = y[i], B = cb[i], R = cr[i];
        int r = Y + t.cr_r[R];
        int g = Y + (int)((t.cb_g[B] + t.cr_g[R]) >> 16);
        int b = Y + t.cb_b[B];
        if (kind == 1) {
            r = 255 - r;
            g = 255 - g;
            b = 255 - b;
        }
        out[i * 3] = clamp255(r);
        out[i * 3 + 1] = clamp255(g);
        out[i * 3 + 2] = clamp255(b);
    }
    return 0;
}

// ------------------------------------------------------------------- GIF ---

// The LZW stream of one GIF image (the sub-blocks already joined) at the
// initial code size min_size (2..8 bits a pixel, codes of min_size + 1 to
// 12 bits) into out[0..n): returns the pixels written (the rest of out is
// untouched), -1 for a code past the table.
int64_t fd_gif_lzw(const uint8_t* data, int64_t len, int min_size, uint8_t* out, int64_t n) {
    if (min_size < 1 || min_size > 11) return -2;
    static thread_local uint16_t prefix[4096];
    static thread_local uint8_t suffix[4096], first[4096];
    static thread_local uint8_t stack[4097];
    const int clear = 1 << min_size, eoi = clear + 1;
    int size = min_size + 1, next = clear + 2, prev = -1;
    for (int i = 0; i < clear; ++i) {
        prefix[i] = 0xFFFF;
        suffix[i] = (uint8_t)i;
        first[i] = (uint8_t)i;
    }
    int64_t o = 0, pos = 0;
    uint32_t buf = 0;
    int nbits = 0;
    while (o < n) {
        while (nbits < size && pos < len) {
            buf |= (uint32_t)data[pos++] << nbits;
            nbits += 8;
        }
        if (nbits < size) break;  // the data ran out
        int code = (int)(buf & ((1u << size) - 1));
        buf >>= size;
        nbits -= size;
        if (code == clear) {
            size = min_size + 1;
            next = clear + 2;
            prev = -1;
            continue;
        }
        if (code == eoi) break;
        int sp = 0, c;
        if (prev < 0) {
            if (code >= clear) return -1;
            out[o++] = (uint8_t)code;
            prev = code;
            continue;
        }
        if (code < next) {
            c = code;
        } else if (code == next) {
            stack[sp++] = first[prev];
            c = prev;
        } else {
            return -1;
        }
        const int f = first[c];
        while (c >= clear) {
            stack[sp++] = suffix[c];
            c = prefix[c];
        }
        stack[sp++] = (uint8_t)c;
        if (next < 4096) {
            prefix[next] = (uint16_t)prev;
            suffix[next] = (uint8_t)f;
            first[next] = first[prev];
            ++next;
            if (next == (1 << size) && size < 12) ++size;
        }
        while (sp && o < n) out[o++] = stack[--sp];
        prev = code;
    }
    return o;
}

// ------------------------------------------------------------------- QOI ---

// The QOI op stream data[0..len) (after the 14-byte header) into n RGBA
// pixels; returns the bytes read, -1 if the stream ends early.
int64_t fd_qoi_decode(const uint8_t* data, int64_t len, uint8_t* out, int64_t n) {
    uint8_t index[64][4];
    std::memset(index, 0, sizeof(index));
    uint8_t px[4] = {0, 0, 0, 255};
    int64_t p = 0;
    int run = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (run > 0) {
            --run;
        } else {
            if (p >= len) return -1;
            const int b1 = data[p++];
            if (b1 == 0xFE) {
                if (p + 3 > len) return -1;
                px[0] = data[p];
                px[1] = data[p + 1];
                px[2] = data[p + 2];
                p += 3;
            } else if (b1 == 0xFF) {
                if (p + 4 > len) return -1;
                std::memcpy(px, data + p, 4);
                p += 4;
            } else if ((b1 & 0xC0) == 0x00) {
                std::memcpy(px, index[b1], 4);
            } else if ((b1 & 0xC0) == 0x40) {
                px[0] = (uint8_t)(px[0] + ((b1 >> 4) & 3) - 2);
                px[1] = (uint8_t)(px[1] + ((b1 >> 2) & 3) - 2);
                px[2] = (uint8_t)(px[2] + (b1 & 3) - 2);
            } else if ((b1 & 0xC0) == 0x80) {
                if (p >= len) return -1;
                const int b2 = data[p++];
                const int vg = (b1 & 0x3F) - 32;
                px[0] = (uint8_t)(px[0] + vg - 8 + ((b2 >> 4) & 0x0F));
                px[1] = (uint8_t)(px[1] + vg);
                px[2] = (uint8_t)(px[2] + vg - 8 + (b2 & 0x0F));
            } else {
                // a run leaves the index as it is (PIL's QoiDecoder; the
                // reference decoder also files the pixel before it)
                run = b1 & 0x3F;
            }
            if ((b1 & 0xC0) != 0xC0 || b1 >= 0xFE) {
                const int h = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64;
                std::memcpy(index[h], px, 4);
            }
        }
        std::memcpy(out + i * 4, px, 4);
    }
    return p;
}

// ------------------------------------------------------------------ TIFF ---

// PackBits data[0..len) into out[0..n): a header byte h < 128 copies the
// next h + 1 bytes, h > 128 repeats the next byte 257 - h times, 128 is a
// no-op. Returns the bytes written (n, or fewer if the data ran out).
int64_t fd_tiff_packbits(const uint8_t* data, int64_t len, uint8_t* out, int64_t n) {
    int64_t p = 0, o = 0;
    while (o < n && p < len) {
        const int h = data[p++];
        if (h < 128) {
            int64_t k = h + 1;
            if (k > len - p) k = len - p;
            if (k > n - o) k = n - o;
            std::memcpy(out + o, data + p, (size_t)k);
            o += k;
            p += h + 1;
        } else if (h > 128) {
            if (p >= len) break;
            int64_t k = 257 - h;
            if (k > n - o) k = n - o;
            std::memset(out + o, data[p++], (size_t)k);
            o += k;
        }
    }
    return o;
}

// TIFF LZW data[0..len) into out[0..n): codes of 9 to 12 bits, most
// significant bit first; ClearCode 256 resets the table, EOI 257 ends the
// data; the width grows when the next free entry reaches 2^width - 1.
// An entry's string is the previous code's string and one byte more, and
// that byte follows it in the output: so each entry is kept as a run of
// the output (start, length) and decoded by copying the run forward (the
// copy may overlap its source when the code is the entry being made).
// Returns the bytes written (n, or fewer if the data ended), -1 for a code
// past the table.
int64_t fd_tiff_lzw(const uint8_t* data, int64_t len, uint8_t* out, int64_t n) {
    static thread_local int64_t start[4096];
    static thread_local int32_t length[4096];
    int size = 9, next = 258, prev = -1;
    int64_t prev_at = 0, o = 0, pos = 0;
    int32_t prev_len = 0;
    uint32_t buf = 0;
    int nbits = 0;
    while (o < n) {
        while (nbits < size && pos < len) {
            buf = (buf << 8) | data[pos++];
            nbits += 8;
        }
        if (nbits < size) break;  // the data ran out
        const int code = (int)((buf >> (nbits - size)) & ((1u << size) - 1));
        nbits -= size;
        buf &= (1u << nbits) - 1;
        if (code == 256) {
            size = 9;
            next = 258;
            prev = -1;
            continue;
        }
        if (code == 257) break;
        if (prev < 0) {
            if (code > 256) return -1;
            prev_at = o;
            prev_len = 1;
            out[o++] = (uint8_t)code;
            prev = code;
            continue;
        }
        int64_t src;
        int32_t k;
        if (code < 256) {
            src = -1;
            k = 1;
        } else if (code < next) {
            src = start[code];
            k = length[code];
        } else if (code == next) {
            src = prev_at;
            k = prev_len + 1;
        } else {
            return -1;
        }
        if (next < 4096) {
            start[next] = prev_at;
            length[next] = prev_len + 1;
            ++next;
            if (next == (1 << size) - 1 && size < 12) ++size;
        }
        const int64_t at = o;
        const int64_t m = k < n - o ? k : n - o;
        if (src < 0) {
            out[o++] = (uint8_t)code;
        } else {
            for (int64_t i = 0; i < m; ++i) out[o + i] = out[src + i];
            o += m;
        }
        prev_at = at;
        prev_len = k;
        prev = code;
    }
    return o;
}

static inline uint16_t swap16(uint16_t v) { return (uint16_t)((v >> 8) | (v << 8)); }
static inline uint32_t swap32(uint32_t v) { return __builtin_bswap32(v); }
static inline uint64_t swap64(uint64_t v) { return __builtin_bswap64(v); }

}  // extern "C"

// horAcc8/16/32/64 (swabHorAcc* when swap) on one row of `count` samples
template <typename T>
static void hor_acc(uint8_t* row, int64_t count, int spp, bool swap) {
    T* w = reinterpret_cast<T*>(row);  // rows are aligned by the caller
    if (swap) {
        for (int64_t i = 0; i < count; ++i) {
            if (sizeof(T) == 2) w[i] = (T)swap16((uint16_t)w[i]);
            else if (sizeof(T) == 4) w[i] = (T)swap32((uint32_t)w[i]);
            else w[i] = (T)swap64((uint64_t)w[i]);
        }
    }
    for (int64_t i = spp; i < count; ++i) w[i] = (T)(w[i] + w[i - spp]);
}

extern "C" {

// The predictor of `rows` rows of row_bytes bytes in place, each row on
// its own, samples of `bytes` bytes, spp samples a pixel (1 for a plane
// of a planar file). kind 2: horizontal differencing, the samples read in
// the file's byte order (swap: it is not the host's), the sums wrap at
// the sample's width, written in the host's order. kind 3: floating
// point: the row's bytes summed spp apart, then its byte planes (most
// significant first) interleaved into host-order samples. scratch holds
// row_bytes bytes. Returns 0, or -1 for a row that is not whole samples.
int fd_tiff_predict(uint8_t* buf, int64_t rows, int64_t row_bytes, int spp, int bytes,
                    int kind, int swap, uint8_t* scratch) {
    if (spp < 1 || row_bytes % ((int64_t)bytes * spp)) return -1;
    const int64_t count = row_bytes / bytes;
    for (int64_t r = 0; r < rows; ++r) {
        uint8_t* row = buf + r * row_bytes;
        if (kind == 2) {
            if (bytes == 1) hor_acc<uint8_t>(row, count, spp, false);
            else if (bytes == 2) hor_acc<uint16_t>(row, count, spp, swap != 0);
            else if (bytes == 4) hor_acc<uint32_t>(row, count, spp, swap != 0);
            else if (bytes == 8) hor_acc<uint64_t>(row, count, spp, swap != 0);
            else return -1;
        } else if (kind == 3) {
            for (int64_t i = spp; i < row_bytes; ++i) row[i] = (uint8_t)(row[i] + row[i - spp]);
            std::memcpy(scratch, row, (size_t)row_bytes);
            for (int64_t i = 0; i < count; ++i)
                for (int b = 0; b < bytes; ++b)
                    row[i * bytes + b] = scratch[(int64_t)(bytes - 1 - b) * count + i];
        } else {
            return -1;
        }
    }
    return 0;
}

}  // extern "C"

// -------------------------------------------------------------- CCITT fax ---
//
// libtiff 4.7.1's decoders of compressions 2, 3 and 4, step for step
// (utils/fax.py's decode_plain is the twin and says which leniencies they
// keep). Bits are read MSB first from the accumulator; at the end of the
// data a request is padded with zeros while any bit is left, as NeedBits
// does. The caller keeps `state` across an image's strips: a flag word
// (1: T.4 read without EOLs) and the two run arrays, which libtiff keeps
// too and whose stale entries a corrupt reference line reads.

namespace fax {

enum { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW,
       S_MakeUpB, S_MakeUp, S_EOL };
enum { kOk = 0, kEof = 1, kFailed = -1 };

struct Ent { uint8_t state, width; uint16_t param; };
static Ent white_t[1 << 12], black_t[1 << 13], main_t[1 << 7];
static std::once_flag tables_once;

template <size_t N>
static void fill_table(Ent* t, int bits, const FaxCode (&codes)[N]) {
    for (const FaxCode& c : codes) {
        const int base = c.code << (bits - c.length);
        for (int i = 0; i < (1 << (bits - c.length)); ++i)
            t[base + i] = Ent{c.state, c.length, c.param};
    }
}

static void build_tables() {
    fill_table(white_t, 12, kFaxWhite);
    fill_table(black_t, 13, kFaxBlack);
    fill_table(main_t, 7, kFaxMain);
}

struct Dec {
    const uint8_t* data;
    int64_t len, cp;
    uint32_t acc;   // `avail` valid bits, the next one highest
    int avail;
    int lastx, nruns, eolcnt;
    bool noeol;
    uint32_t* runs;  // 2 * nruns + 1 entries: curruns, refruns, a spare
    int cur, ref;    // offsets of curruns and refruns in runs

    bool need(int n) {  // NeedBits8 / NeedBits16
        while (avail < n) {
            if (cp >= len) {
                if (avail == 0) return false;
                acc <<= (n - avail);  // pad with zeros
                avail = n;
                return true;
            }
            acc = (acc << 8) | data[cp++];
            avail += 8;
        }
        return true;
    }
    int peek(int n) const { return (int)((acc >> (avail - n)) & ((1u << n) - 1)); }
    void clr(int n) {
        avail -= n;
        acc &= (avail >= 32) ? 0xFFFFFFFFu : ((1u << avail) - 1);
    }
    bool lookup(const Ent* t, int bits, Ent* e) {  // LOOKUP8 / LOOKUP16
        if (!need(bits)) return false;
        *e = t[peek(bits)];
        clr(e->width);
        return true;
    }
};

struct Row {
    Dec* d;
    int thisrun, pa;
    int32_t a0, run_length;

    int setvalue(int32_t x) {  // SETVALUE; kFailed on "Buffer overflow"
        if (pa >= thisrun + d->nruns) return kFailed;
        d->runs[pa++] = (uint32_t)run_length + (uint32_t)x;
        a0 = (int32_t)((uint32_t)a0 + (uint32_t)x);
        run_length = 0;
        return kOk;
    }
    void make_up(uint32_t run) {
        a0 = (int32_t)((uint32_t)a0 + run);
        run_length = (int32_t)((uint32_t)run_length + run);
    }
    int cleanup() {  // CLEANUP_RUNS
        const int32_t lastx = d->lastx;
        if (run_length && setvalue(0)) return kFailed;
        if (a0 != lastx) {
            while (a0 > lastx && pa > thisrun) a0 = (int32_t)((uint32_t)a0 - d->runs[--pa]);
            if (a0 < lastx) {
                if (a0 < 0) a0 = 0;
                if (((pa - thisrun) & 1) && setvalue(0)) return kFailed;
                if (setvalue((int32_t)((uint32_t)lastx - (uint32_t)a0))) return kFailed;
            } else if (a0 > lastx) {
                if (setvalue(lastx) || setvalue(0)) return kFailed;
            }
        }
        return kOk;
    }
};

// _TIFFFax3fillruns: runs [start, end) to the row's bits (the row zeroed
// first, black runs set), each run cut to the row and the cut written back
static void fill(uint32_t* runs, int start, int end, uint32_t lastx, uint8_t* row,
                 int64_t row_bytes) {
    if ((end - start) & 1) runs[end++] = 0;
    std::memset(row, 0, (size_t)row_bytes);
    uint32_t x = 0;
    for (int k = start; k < end; k += 2) {
        for (int j = 0; j < 2; ++j) {
            uint32_t run = runs[k + j];
            if (x + run > lastx || run > lastx) run = runs[k + j] = lastx - x;
            if (run) {
                if (j) {
                    for (uint32_t i = x; i < x + run; ++i) row[i >> 3] |= (uint8_t)(0x80 >> (i & 7));
                }
                x += run;
            }
        }
    }
}

// EXPAND1D: kOk, kEof (the row cleaned up), kFailed
static int expand1d(Dec& d, Row& r) {
    Ent e;
    const int32_t lastx = d.lastx;
    for (;;) {
        for (;;) {
            if (!d.lookup(white_t, 12, &e)) goto eof;
            if (e.state == S_EOL) { d.eolcnt = 1; return r.cleanup(); }
            if (e.state == S_TermW) { if (r.setvalue(e.param)) return kFailed; break; }
            if (e.state == S_MakeUpW || e.state == S_MakeUp) {
                r.make_up(e.param);
                continue;
            }
            return r.cleanup();  // unexpected("WhiteTable")
        }
        if (r.a0 >= lastx) return r.cleanup();
        for (;;) {
            if (!d.lookup(black_t, 13, &e)) goto eof;
            if (e.state == S_EOL) { d.eolcnt = 1; return r.cleanup(); }
            if (e.state == S_TermB) { if (r.setvalue(e.param)) return kFailed; break; }
            if (e.state == S_MakeUpB || e.state == S_MakeUp) {
                r.make_up(e.param);
                continue;
            }
            return r.cleanup();  // unexpected("BlackTable")
        }
        if (r.a0 >= lastx) return r.cleanup();
        if (d.runs[r.pa - 1] == 0 && d.runs[r.pa - 2] == 0) r.pa -= 2;
    }
eof:
    return r.cleanup() ? kFailed : kEof;  // prematureEOF
}

// one run of a horizontal mode code; kOk, kEof, or 2 for a bad code word
static int horizontal_run(Dec& d, Row& r, const Ent* t, int bits, int term, int make) {
    Ent e;
    for (;;) {
        if (!d.lookup(t, bits, &e)) return kEof;
        if (e.state == term) return r.setvalue(e.param) ? kFailed : kOk;
        if (e.state == make || e.state == S_MakeUp) {
            r.make_up(e.param);
            continue;
        }
        return 2;
    }
}

// EXPAND2D against the reference line: kOk, kEof (the row cleaned up),
// kFailed
static int expand2d(Dec& d, Row& r) {
    Ent e;
    uint32_t* runs = d.runs;
    const int32_t lastx = d.lastx;
    const int ref_end = d.ref + d.nruns;
    int pb = d.ref;
    int32_t b1 = (int32_t)runs[pb++];
    auto check_b1 = [&]() -> bool {
        if (r.pa != r.thisrun)
            while (b1 <= r.a0 && b1 < lastx) {
                if (pb + 1 >= ref_end) return false;
                b1 = (int32_t)((uint32_t)b1 + runs[pb] + runs[pb + 1]);
                pb += 2;
            }
        return true;
    };
    while (r.a0 < lastx) {
        if (r.pa >= r.thisrun + d.nruns) return kFailed;
        if (!d.lookup(main_t, 7, &e)) goto eof;
        switch (e.state) {
            case S_Pass:
                if (!check_b1() || pb + 1 >= ref_end) return kFailed;
                b1 = (int32_t)((uint32_t)b1 + runs[pb++]);
                r.run_length = (int32_t)((uint32_t)r.run_length + (uint32_t)b1 - (uint32_t)r.a0);
                r.a0 = b1;
                b1 = (int32_t)((uint32_t)b1 + runs[pb++]);
                break;
            case S_Horiz: {
                int rc;
                if ((r.pa - r.thisrun) & 1) {
                    rc = horizontal_run(d, r, black_t, 13, S_TermB, S_MakeUpB);
                    if (rc == kOk) rc = horizontal_run(d, r, white_t, 12, S_TermW, S_MakeUpW);
                } else {
                    rc = horizontal_run(d, r, white_t, 12, S_TermW, S_MakeUpW);
                    if (rc == kOk) rc = horizontal_run(d, r, black_t, 13, S_TermB, S_MakeUpB);
                }
                if (rc == kFailed) return kFailed;
                if (rc == kEof) goto eof;
                if (rc == 2) goto eol;  // unexpected("BlackTable" / "WhiteTable")
                if (!check_b1()) return kFailed;
                break;
            }
            case S_V0:
            case S_VR:
                if (!check_b1()) return kFailed;
                if (r.setvalue((int32_t)((uint32_t)b1 - (uint32_t)r.a0 +
                                         (e.state == S_VR ? e.param : 0u))))
                    return kFailed;
                if (pb >= ref_end) return kFailed;
                b1 = (int32_t)((uint32_t)b1 + runs[pb++]);
                break;
            case S_VL:
                if (!check_b1()) return kFailed;
                if (b1 < (int32_t)((uint32_t)r.a0 + e.param)) goto eol;  // unexpected("VL")
                if (r.setvalue((int32_t)((uint32_t)b1 - (uint32_t)r.a0 - e.param)))
                    return kFailed;
                b1 = (int32_t)((uint32_t)b1 - runs[--pb]);
                break;
            case S_Ext:  // extension(a0): "Uncompressed data (not supported)", reported
                runs[r.pa++] = (uint32_t)(lastx - r.a0);
                goto eol;
            case S_EOL:
                runs[r.pa++] = (uint32_t)(lastx - r.a0);
                if (!d.need(4)) goto eof;
                d.clr(4);  // unexpected("EOL") unless zeros
                d.eolcnt = 1;
                goto eol;
            default:
                goto eol;  // unexpected("MainTable")
        }
    }
    if (r.run_length) {
        if ((int32_t)((uint32_t)r.run_length + (uint32_t)r.a0) < lastx) {
            if (!d.need(1)) goto eof;
            if (!d.peek(1)) goto eol;  // badMain2d
            d.clr(1);
        }
        if (r.setvalue(0)) return kFailed;
    }
eol:
    return r.cleanup();
eof:
    return r.cleanup() ? kFailed : kEof;  // prematureEOF
}

// SYNC_EOL: kOk, kEof, or 2 when the data ends after an EOL's zeros
static int sync_eol(Dec& d) {
    if (d.noeol) return kOk;
    if (d.eolcnt == 0) {
        for (;;) {
            if (!d.need(11)) return kEof;
            if (d.peek(11) == 0) break;
            d.clr(1);
        }
    }
    for (;;) {
        if (!d.need(8)) return 2;  // noEOLFound
        if (d.peek(8)) break;
        d.clr(8);
    }
    while (d.peek(1) == 0) d.clr(1);
    d.clr(1);
    d.eolcnt = 0;
    return kOk;
}

}  // namespace fax

extern "C" {

// One CCITT strip or tile of `rows` rows of `width` pixels into out
// (row_bytes a row, MSB first, 1 for black; rows the data never reaches
// keep their bytes). mode: the TIFF compression, 2 (Modified Huffman, each
// row byte-aligned), 32771 (RLE-W: the same, each row word-aligned as
// Fax3DecodeRLE aligns it; odd: the data starts at an odd offset of its
// file, the parity of libtiff's read pointer in the file's mapping), 3
// (T.4: t4options bit 0 two-dimensional) or 4 (T.6). state: the image's
// flag word and run arrays (utils/fax.py: new_state), carried to its next
// strip. Returns the rows decoded, or -1 where libtiff fails the strip.
int fd_tiff_fax(const uint8_t* data, int64_t len, int width, int rows, int mode,
                int t4options, uint8_t* out, int64_t row_bytes, uint32_t* state, int odd) {
    using namespace fax;
    std::call_once(tables_once, build_tables);
    if (width < 1 || rows < 0 || row_bytes * 8 < width) return kFailed;
    const bool two_d = mode == 4 || (mode == 3 && (t4options & 1));
    Dec d{};
    d.data = data;
    d.len = len;
    d.lastx = width;
    d.nruns = (width + 1 + 31) / 32 * 32 * (two_d ? 2 : 1);
    d.runs = state + 1;
    d.cur = 0;
    d.ref = d.nruns;
    d.noeol = (state[0] & 1) != 0;
    if (two_d) {
        d.runs[d.ref] = (uint32_t)width;
        d.runs[d.ref + 1] = 0;
    }
    int line = 0, rc = kOk;
    while (line < rows && rc >= 0) {
        uint8_t* row = out + (int64_t)line * row_bytes;
        Row r{&d, d.cur, d.cur, 0, 0};
        if (mode == 2 || mode == 32771) {
            rc = expand1d(d, r);
            if (rc == kFailed) break;
            fill(d.runs, r.thisrun, r.pa, width, row, row_bytes);
            if (rc == kEof) { rc = kFailed; break; }
            if (mode == 2) {
                d.clr(d.avail % 8);  // each row starts on a byte
            } else {  // on a word: the bits down to 0 or 16, then an even address
                d.clr(d.avail % 16);
                if (d.avail == 0 && ((d.cp + odd) & 1)) ++d.cp;
            }
        } else if (mode == 3) {
            int s = sync_eol(d);
            int is1d = 1;
            if (s == 2) {  // retry the strip from its start without EOLs
                d.noeol = true;
                d.cp = 0;
                d.acc = 0;
                d.avail = d.eolcnt = 0;
                continue;
            }
            if (s == kOk && two_d) {
                if (!d.need(1)) {
                    s = kEof;
                } else {
                    is1d = d.peek(1);
                    d.clr(1);
                }
            }
            if (s == kEof) {
                if (r.cleanup()) { rc = kFailed; break; }
                fill(d.runs, r.thisrun, r.pa, width, row, row_bytes);
                rc = kFailed;
                break;
            }
            rc = (!two_d || is1d) ? expand1d(d, r) : expand2d(d, r);
            if (rc < 0) break;
            fill(d.runs, r.thisrun, r.pa, width, row, row_bytes);
            if (rc == kEof) { rc = kFailed; break; }
            if (two_d) {
                if (r.pa < r.thisrun + d.nruns && r.setvalue(0)) { rc = kFailed; break; }
                std::swap(d.cur, d.ref);
            }
        } else if (mode == 4) {
            rc = expand2d(d, r);
            if (rc < 0) break;
            if (rc == kEof || d.eolcnt) {  // EOFB, or the end of the data
                if (d.need(13)) d.clr(13);
                fill(d.runs, r.thisrun, r.pa, width, row, row_bytes);
                rc = line ? kOk : kFailed;
                break;
            }
            fill(d.runs, r.thisrun, r.pa, width, row, row_bytes);
            if (r.setvalue(0)) { rc = kFailed; break; }
            std::swap(d.cur, d.ref);
        } else {
            rc = kFailed;
            break;
        }
        ++line;
    }
    state[0] = d.noeol ? 1 : 0;
    return rc < 0 ? rc : line;
}

}  // extern "C"
