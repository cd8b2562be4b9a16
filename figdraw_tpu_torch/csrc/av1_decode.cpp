// AV1 intra decoding for AVIF still images, host C++ built with g++ by
// figdraw_tpu_torch/utils/image_lib.py and bound through ctypes by
// utils/av1.py, which parses the sequence and frame headers and holds the
// plain numpy twin of each self-contained stage. The decoding process is
// the AV1 specification's (section 7) for a shown key frame of profiles 0-2
// at 8, 10 or 12 bits (4:2:0, 4:2:2, 4:4:4 or monochrome) without superres,
// and its film grain; the tables are libaom's, the Gaussian sequence
// dav1d's (csrc/av1_tables.h). Planes hold
// uint8_t samples at 8 bits and uint16_t at 10 and 12 (the stages are
// templated on the sample type; the header's H_BITDEPTH picks it).
//   fd_av1_tile       one tile: the symbol decoder with CDF adaptation,
//                     partitions, intra frame mode info (segment id, skip,
//                     delta q / lf, y and uv modes with angle deltas, CfL
//                     alphas, palettes with their colour cache and index
//                     maps, filter intra), tx sizes and types, coefficients
//                     and their contexts, dequantisation, prediction and
//                     reconstruction, into the frame's planes and its
//                     per-4x4 block info, with the CDEF index of each 64x64
//                     and the loop restoration units' types and
//                     coefficients;
//   fd_av1_deblock    the loop filter of the whole frame;
//   fd_av1_cdef       CDEF (specification 7.15) of the deblocked frame;
//   fd_av1_lr         loop restoration (7.17): Wiener and self-guided
//                     filters over stripes of 64 luma rows;
//   fd_av1_scale      one plane to another size, as libavif 1.3.0 scales a
//                     decoded frame to its item's ispe (libyuv's ScalePlane
//                     with kFilterBox and its x86 column filter; its
//                     ScalePlane_16 past 8 bits);
//   fd_av1_film_grain film grain synthesis (7.18.3) as dav1d 1.5.1 applies
//                     it: the grain templates, the scaling lookups and the
//                     noise of 32x32 blocks over the frame;
//   fd_av1_to_rgb     YUV to RGBA as libavif 1.3.0 converts it for PIL
//                     (libyuv's fixed point with its chroma upsampling, or
//                     libavif's own float conversion), the alpha item's
//                     plane to alpha;
//   fd_av1_alpha_range a limited-range alpha plane to full range, as
//                     libavif 1.3.0 expands it (avifLimitedToFullY at the
//                     plane's bit depth);
//   fd_av1_unattenuate premultiplied 8-bit RGBA to straight, as libavif
//                     1.3.0 unpremultiplies it for PIL (libyuv's
//                     ARGBUnattenuate);
//   fd_av1_predict, fd_av1_cfl, fd_av1_inv_txfm, fd_av1_lf_edge,
//   fd_av1_cdef_block, fd_av1_wiener, fd_av1_sgr
//                     the stages alone at a bit depth (samples out as
//                     uint16_t), for the twins' tests.
//
// Every entry point returns 0 (or a count) on success and a negative code
// on bad input (utils/av1.py ERRORS); reads of the input are bounded.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <type_traits>
#include <vector>

#include "av1_tables.h"

namespace {

enum { kArgs = -2, kGolomb = -3, kScaleRatio = -4, kPartition422 = -5 };

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline int round2(int64_t x, int n) { return n == 0 ? (int)x : (int)((x + ((int64_t)1 << (n - 1))) >> n); }
inline int round2signed(int64_t x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline int floorlog2(uint32_t x) { int s = 0; while (x > 1) { x >>= 1; s++; } return s; }
inline int ceillog2(uint32_t x) { if (x < 2) return 0; int i = 1; uint32_t p = 2; while (p < x) { i++; p <<= 1; } return i; }
// Clip1 at BitDepth bd
inline int clip1(int v, int bd) { return v < 0 ? 0 : (v > (1 << bd) - 1 ? (1 << bd) - 1 : v); }

// ---------------------------------------------------------------- geometry ---

enum BlockSize { B4X4, B4X8, B8X4, B8X8, B8X16, B16X8, B16X16, B16X32, B32X16, B32X32, B32X64,
                 B64X32, B64X64, B64X128, B128X64, B128X128, B4X16, B16X4, B8X32, B32X8,
                 B16X64, B64X16, BLOCK_INVALID };
const int kBW[22] = {4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64};
const int kBH[22] = {4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16};

int block_of(int w, int h) {
    for (int b = 0; b < 22; b++) if (kBW[b] == w && kBH[b] == h) return b;
    return BLOCK_INVALID;
}
inline int mi_wlog2(int b) { return floorlog2(kBW[b] >> 2); }
inline int mi_hlog2(int b) { return floorlog2(kBH[b] >> 2); }

enum TxSize { T4X4, T8X8, T16X16, T32X32, T64X64, T4X8, T8X4, T8X16, T16X8, T16X32, T32X16,
              T32X64, T64X32, T4X16, T16X4, T8X32, T32X8, T16X64, T64X16 };
const int kTW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64};
const int kTH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16};
const int kMaxTxRect[22] = {T4X4, T4X8, T8X4, T8X8, T8X16, T16X8, T16X16, T16X32, T32X16, T32X32,
                            T32X64, T64X32, T64X64, T64X64, T64X64, T64X64, T4X16, T16X4, T8X32,
                            T32X8, T16X64, T64X16};
const int kMaxTxDepth[22] = {0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4};
const int kSplitTx[19] = {T4X4, T4X4, T8X8, T16X16, T32X32, T4X4, T4X4, T8X8, T8X8, T16X16,
                          T16X16, T32X32, T32X32, T4X8, T8X4, T8X16, T16X8, T16X32, T32X16};
const int kRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};

inline int tx_wlog2(int t) { return floorlog2(kTW[t]); }
inline int tx_hlog2(int t) { return floorlog2(kTH[t]); }
inline int sqr_index(int n) { return floorlog2(n) - 2; }  // 4 -> 0 ... 64 -> 4
inline int tx_sqr(int t) { return sqr_index(std::min(kTW[t], kTH[t])); }
inline int tx_sqr_up(int t) { return sqr_index(std::max(kTW[t], kTH[t])); }
int adjusted_tx(int t) {
    switch (t) {
        case T64X64: case T32X64: case T64X32: return T32X32;
        case T16X64: return T16X32;
        case T64X16: return T32X16;
        default: return t;
    }
}

// plane residual size of a block (Subsampled_Size wherever it is valid:
// 4:2:2 has no size for the blocks twice as tall as wide, whose partitions
// the tile refuses)
int plane_size(int b, int ssx, int ssy) {
    int w = kBW[b] >> ssx, h = kBH[b] >> ssy;
    if (w < 4) w = 4;
    if (h < 4) h = 4;
    return block_of(w, h);
}

enum Mode { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED,
            D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
inline bool directional(int m) { return m >= V_PRED && m <= D67_PRED; }

enum TxType { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
              FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST,
              H_ADST, V_FLIPADST, H_FLIPADST };
enum { T_DCT, T_ADST, T_FLIP, T_ID };
const int kColType[16] = {T_DCT, T_ADST, T_DCT, T_ADST, T_FLIP, T_DCT, T_FLIP, T_ADST, T_FLIP,
                          T_ID, T_DCT, T_ID, T_ADST, T_ID, T_FLIP, T_ID};
const int kRowType[16] = {T_DCT, T_DCT, T_ADST, T_ADST, T_DCT, T_FLIP, T_FLIP, T_FLIP, T_ADST,
                          T_ID, T_ID, T_DCT, T_ID, T_ADST, T_ID, T_FLIP};
enum { CLASS_2D, CLASS_HORIZ, CLASS_VERT };
inline int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return CLASS_VERT;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return CLASS_HORIZ;
    return CLASS_2D;
}
const int kModeToTxfm[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                             DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
enum { SET_DCTONLY, SET_INTRA_1, SET_INTRA_2, SET_INTER_1, SET_INTER_2, SET_INTER_3 };
// TX_TYPE_INV's rows, the tx type of each symbol of a set (libaom's av1_ext_tx_inv)
enum { INV_INTER_3, INV_INTRA_2, INV_INTRA_1, INV_INTER_2, INV_INTER_1 };

// ------------------------------------------------------------ transforms ---

inline int cos_lookup(int i) { return i == 64 ? 0 : COS128[i]; }
inline int cos128(int angle) {
    int a = angle & 255;
    if (a <= 64) return cos_lookup(a);
    if (a <= 128) return -cos_lookup(128 - a);
    if (a <= 192) return -cos_lookup(a - 128);
    return cos_lookup(256 - a);
}
inline int sin128(int angle) { return cos128(angle - 64); }

struct Tx1D {
    int32_t T[64];
    int r;  // clamp range in bits

    int clampr(int64_t v) const {
        int64_t lo = -((int64_t)1 << (r - 1)), hi = ((int64_t)1 << (r - 1)) - 1;
        return (int)(v < lo ? lo : (v > hi ? hi : v));
    }
    void B(int a, int b, int angle, int flip) {
        int64_t x = (int64_t)T[a] * cos128(angle) - (int64_t)T[b] * sin128(angle);
        int64_t y = (int64_t)T[a] * sin128(angle) + (int64_t)T[b] * cos128(angle);
        T[a] = round2(x, 12);
        T[b] = round2(y, 12);
        if (flip) std::swap(T[a], T[b]);
    }
    void H(int a, int b, int flip) {
        if (flip) std::swap(a, b);
        int x = T[a], y = T[b];
        T[a] = clampr((int64_t)x + y);
        T[b] = clampr((int64_t)x - y);
    }
    static int brev(int n, int x) {
        int v = 0;
        for (int i = 0; i < n; i++) if (x & (1 << i)) v |= 1 << (n - 1 - i);
        return v;
    }
    void dct(int n) {
        int n0 = 1 << n;
        int32_t c[64];
        std::memcpy(c, T, sizeof(int32_t) * n0);
        for (int i = 0; i < n0; i++) T[i] = c[brev(n, i)];
        if (n == 6) for (int i = 0; i < 16; i++) B(32 + i, 63 - i, 63 - 4 * brev(4, i), 0);
        if (n >= 5) for (int i = 0; i < 8; i++) B(16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
        if (n == 6) for (int i = 0; i < 16; i++) H(32 + i * 2, 33 + i * 2, i & 1);
        if (n >= 4) for (int i = 0; i < 4; i++) B(8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
        if (n >= 5) for (int i = 0; i < 8; i++) H(16 + 2 * i, 17 + 2 * i, i & 1);
        if (n == 6) for (int i = 0; i < 4; i++) for (int j = 0; j < 2; j++)
            B(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * brev(2, i) + 64 * j, 1);
        if (n >= 3) for (int i = 0; i < 2; i++) B(4 + i, 7 - i, 56 - 32 * i, 0);
        if (n >= 4) for (int i = 0; i < 4; i++) H(8 + 2 * i, 9 + 2 * i, i & 1);
        if (n >= 5) for (int i = 0; i < 2; i++) for (int j = 0; j < 2; j++)
            B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1);
        if (n == 6) for (int i = 0; i < 8; i++) for (int j = 0; j < 2; j++)
            H(32 + i * 4 + j, 35 + i * 4 - j, i & 1);
        for (int i = 0; i < 2; i++) B(2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i);
        if (n >= 3) for (int i = 0; i < 2; i++) H(4 + 2 * i, 5 + 2 * i, i);
        if (n >= 4) for (int i = 0; i < 2; i++) B(14 - i, 9 + i, 48 + 64 * i, 1);
        if (n >= 5) for (int i = 0; i < 4; i++) for (int j = 0; j < 2; j++)
            H(16 + 4 * i + j, 19 + 4 * i - j, i & 1);
        if (n == 6) for (int i = 0; i < 2; i++) for (int j = 0; j < 4; j++)
            B(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1);
        for (int i = 0; i < 2; i++) H(i, 3 - i, 0);
        if (n >= 3) B(6, 5, 32, 1);
        if (n >= 4) for (int i = 0; i < 2; i++) for (int j = 0; j < 2; j++)
            H(8 + 4 * i + j, 11 + 4 * i - j, i);
        if (n >= 5) for (int i = 0; i < 4; i++) B(29 - i, 18 + i, 48 + (i >> 1) * 64, 1);
        if (n == 6) for (int i = 0; i < 4; i++) for (int j = 0; j < 4; j++)
            H(32 + 8 * i + j, 39 + 8 * i - j, i & 1);
        if (n >= 3) for (int i = 0; i < 4; i++) H(i, 7 - i, 0);
        if (n >= 4) for (int i = 0; i < 2; i++) B(13 - i, 10 + i, 32, 1);
        if (n >= 5) for (int i = 0; i < 2; i++) for (int j = 0; j < 4; j++)
            H(16 + i * 8 + j, 23 + i * 8 - j, i);
        if (n == 6) for (int i = 0; i < 8; i++) B(59 - i, 36 + i, i < 4 ? 48 : 112, 1);
        if (n >= 4) for (int i = 0; i < 8; i++) H(i, 15 - i, 0);
        if (n >= 5) for (int i = 0; i < 4; i++) B(27 - i, 20 + i, 32, 1);
        if (n == 6) {
            for (int i = 0; i < 8; i++) H(32 + i, 47 - i, 0);
            for (int i = 0; i < 8; i++) H(48 + i, 63 - i, 1);
        }
        if (n >= 5) for (int i = 0; i < 16; i++) H(i, 31 - i, 0);
        if (n == 6) for (int i = 0; i < 8; i++) B(55 - i, 40 + i, 32, 1);
        if (n == 6) for (int i = 0; i < 32; i++) H(i, 63 - i, 0);
    }
    void adst4() {
        int64_t s0 = (int64_t)SINPI[1] * T[0], s1 = (int64_t)SINPI[2] * T[0];
        int64_t s2 = (int64_t)SINPI[3] * T[1], s3 = (int64_t)SINPI[4] * T[2];
        int64_t s4 = (int64_t)SINPI[1] * T[2], s5 = (int64_t)SINPI[2] * T[3];
        int64_t s6 = (int64_t)SINPI[4] * T[3];
        int a7 = T[0] - T[2];
        int b7 = a7 + T[3];
        s0 = s0 + s3;
        s1 = s1 - s4;
        s3 = s2;
        s2 = (int64_t)SINPI[3] * b7;
        s0 = s0 + s5;
        s1 = s1 - s6;
        int64_t x0 = s0 + s3, x1 = s1 + s3, x2 = s2, x3 = s0 + s1;
        x3 = x3 - s3;
        T[0] = round2(x0, 12);
        T[1] = round2(x1, 12);
        T[2] = round2(x2, 12);
        T[3] = round2(x3, 12);
    }
    void adst_in_perm(int n) {
        int n0 = 1 << n;
        int32_t c[16];
        std::memcpy(c, T, sizeof(int32_t) * n0);
        for (int i = 0; i < n0; i++) T[i] = c[(i & 1) ? (i - 1) : (n0 - i - 1)];
    }
    void adst_out_perm(int n) {
        int n0 = 1 << n;
        int32_t c[16];
        std::memcpy(c, T, sizeof(int32_t) * n0);
        for (int i = 0; i < n0; i++) {
            int a = (i >> 3) & 1, b = ((i >> 2) & 1) ^ ((i >> 3) & 1);
            int cc = ((i >> 1) & 1) ^ ((i >> 2) & 1), d = (i & 1) ^ ((i >> 1) & 1);
            int idx = ((d << 3) | (cc << 2) | (b << 1) | a) >> (4 - n);
            T[i] = (i & 1) ? -c[idx] : c[idx];
        }
    }
    void adst8() {
        adst_in_perm(3);
        for (int i = 0; i < 4; i++) B(2 * i, 1 + 2 * i, 60 - 16 * i, 1);
        for (int i = 0; i < 4; i++) H(i, 4 + i, 0);
        for (int i = 0; i < 2; i++) B(4 + 3 * i, 5 + i, 48 - 32 * i, 1);
        for (int i = 0; i < 2; i++) for (int j = 0; j < 2; j++) H(4 * j + i, 2 + 4 * j + i, 0);
        for (int i = 0; i < 2; i++) B(2 + 4 * i, 3 + 4 * i, 32, 1);
        adst_out_perm(3);
    }
    void adst16() {
        adst_in_perm(4);
        for (int i = 0; i < 8; i++) B(2 * i, 1 + 2 * i, 62 - 8 * i, 1);
        for (int i = 0; i < 8; i++) H(i, 8 + i, 0);
        for (int i = 0; i < 2; i++) {
            B(8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1);
            B(13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1);
        }
        for (int i = 0; i < 4; i++) for (int j = 0; j < 2; j++) H(8 * j + i, 4 + 8 * j + i, 0);
        for (int i = 0; i < 2; i++) for (int j = 0; j < 2; j++) {
            B(4 + 8 * j + 3 * i, 5 + 8 * j + i, 48 - 32 * i, 1);
        }
        for (int i = 0; i < 2; i++) for (int j = 0; j < 4; j++) H(4 * j + i, 2 + 4 * j + i, 0);
        for (int i = 0; i < 4; i++) B(2 + 4 * i, 3 + 4 * i, 32, 1);
        adst_out_perm(4);
    }
    void identity(int n) {
        int n0 = 1 << n;
        for (int i = 0; i < n0; i++) {
            if (n == 2) T[i] = round2((int64_t)T[i] * 5793, 12);
            else if (n == 3) T[i] = T[i] * 2;
            else if (n == 4) T[i] = round2((int64_t)T[i] * 11586, 12);
            else T[i] = T[i] * 4;
        }
    }
    void run(int type, int n) {
        if (type == T_DCT) dct(n);
        else if (type == T_ID) identity(n);
        else if (n == 2) adst4();
        else if (n == 3) adst8();
        else adst16();
    }
};

void wht(int32_t* T, int shift) {
    int a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
    a += c;
    d -= b;
    int e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    T[0] = a;
    T[1] = b;
    T[2] = c;
    T[3] = d;
}

// The 2D inverse transform of a txSz block: `deq` holds Dequant[i][j] at
// i * 64 + j (rows and columns past 32 zero), `res` gets Residual at
// i * w + j; the clamps of the rows (BitDepth + 8 bits) and columns
// (Max(BitDepth + 6, 16) bits) follow the bit depth bd.
void inverse_transform(const int32_t* deq, int txSz, int txType, int lossless, int32_t* res, int bd) {
    int log2W = tx_wlog2(txSz), log2H = tx_hlog2(txSz);
    int w = 1 << log2W, h = 1 << log2H;
    int rowShift = lossless ? 0 : kRowShift[txSz];
    int colShift = lossless ? 0 : 4;
    int rowClamp = bd + 8, colClamp = std::max(bd + 6, 16);
    int rt = kRowType[txType], ct = kColType[txType];
    Tx1D t;
    std::vector<int32_t> tmp((size_t)w * h);
    for (int i = 0; i < h; i++) {
        for (int j = 0; j < w; j++) t.T[j] = (i < 32 && j < 32) ? deq[i * 64 + j] : 0;
        if (lossless) {
            wht(t.T, 2);
        } else {
            if (std::abs(log2W - log2H) == 1)
                for (int j = 0; j < w; j++) t.T[j] = round2((int64_t)t.T[j] * 2896, 12);
            t.r = rowClamp;
            for (int j = 0; j < w; j++) t.T[j] = t.clampr(t.T[j]);
            t.run(rt == T_FLIP ? T_ADST : rt, log2W);
        }
        for (int j = 0; j < w; j++) {
            int v = round2((int64_t)t.T[j], rowShift);
            if (!lossless) v = clip3(-(1 << (colClamp - 1)), (1 << (colClamp - 1)) - 1, v);
            tmp[(size_t)i * w + (rt == T_FLIP ? w - 1 - j : j)] = v;
        }
    }
    for (int j = 0; j < w; j++) {
        for (int i = 0; i < h; i++) t.T[i] = tmp[(size_t)i * w + j];
        if (lossless) {
            wht(t.T, 0);
        } else {
            t.r = colClamp;
            t.run(ct == T_FLIP ? T_ADST : ct, log2H);
        }
        for (int i = 0; i < h; i++)
            res[(size_t)(ct == T_FLIP ? h - 1 - i : i) * w + j] = round2((int64_t)t.T[i], colShift);
    }
}

// ------------------------------------------------------------ prediction ---

struct PredParams {
    int mode, log2W, log2H, haveLeft, haveAbove, angleDelta, filterType, edgeFilter;
    int useFilterIntra, filterIntraMode, aboveLimit, leftLimit;  // limits: maxX - x + 1, maxY - y + 1
};

inline const int16_t* sm_weights(int log2) {
    static const int off[7] = {0, 0, 0, 4, 12, 28, 60};  // by log2 of the size (4 -> 0)
    return SM_WEIGHTS + off[log2];
}

int edge_strength(int w, int h, int filterType, int delta) {
    int d = std::abs(delta), blkWh = w + h, s = 0;
    if (filterType == 0) {
        if (blkWh <= 8) { if (d >= 56) s = 1; }
        else if (blkWh <= 12) { if (d >= 40) s = 1; }
        else if (blkWh <= 16) { if (d >= 40) s = 1; }
        else if (blkWh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
        else if (blkWh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
        else { if (d >= 1) s = 3; }
    } else {
        if (blkWh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
        else if (blkWh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
        else if (blkWh <= 24) { if (d >= 4) s = 3; }
        else { if (d >= 1) s = 3; }
    }
    return s;
}

int use_upsample(int w, int h, int filterType, int delta) {
    int d = std::abs(delta), blkWh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return filterType == 0 ? blkWh <= 16 : blkWh <= 8;
}

// `e` points at index 0 of an edge with valid indices -16 .. 271
void edge_filter(int* e, int sz, int strength) {
    if (strength == 0) return;
    int edge[300];
    for (int i = 0; i < sz; i++) edge[i] = e[i - 1];
    for (int i = 1; i < sz; i++) {
        int s = 0;
        for (int j = 0; j < 5; j++) {
            int k = clip3(0, sz - 1, i - 2 + j);
            s += INTRA_EDGE_KERNEL[(strength - 1) * 5 + j] * edge[k];
        }
        e[i - 1] = (s + 8) >> 4;
    }
}

void edge_upsample(int* buf, int numPx, int bd) {
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < numPx; i++) dup[i + 2] = buf[i];
    dup[numPx + 2] = buf[numPx - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < numPx; i++) {
        int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
        s = clip1(round2(s, 4), bd);
        buf[2 * i - 1] = s;
        buf[2 * i] = dup[i + 2];
    }
}

// The intra prediction of one block from its edges: `above` and `left` point
// at index 0 of arrays valid from -16 (AboveRow / LeftCol, w + h entries and
// the corner at -1, which the edge processes modify). `pred` gets w * h
// samples of bd bits.
template <typename P>
void predict(const PredParams& p, int* above, int* left, P* pred, int bd) {
    int w = 1 << p.log2W, h = 1 << p.log2H;
    if (p.useFilterIntra) {
        int w4 = w >> 2, h2 = h >> 1;
        for (int i2 = 0; i2 < h2; i2++) {
            for (int j4 = 0; j4 < w4; j4++) {
                int pv[7];
                for (int i = 0; i < 7; i++) {
                    if (i < 5) {
                        if (i2 == 0) pv[i] = above[(j4 << 2) + i - 1];
                        else if (j4 == 0 && i == 0) pv[i] = left[(i2 << 1) - 1];
                        else pv[i] = pred[((i2 << 1) - 1) * w + (j4 << 2) + i - 1];
                    } else {
                        if (j4 == 0) pv[i] = left[(i2 << 1) + i - 5];
                        else pv[i] = pred[((i2 << 1) + i - 5) * w + (j4 << 2) - 1];
                    }
                }
                for (int i = 0; i < 8; i++) {
                    int pr = 0;
                    for (int j = 0; j < 7; j++)
                        pr += FILTER_INTRA_TAPS[(p.filterIntraMode * 8 + i) * 8 + j] * pv[j];
                    pred[((i2 << 1) + (i >> 2)) * w + (j4 << 2) + (i & 3)] = (P)clip1(round2signed(pr, 4), bd);
                }
            }
        }
        return;
    }
    int mode = p.mode;
    if (directional(mode)) {
        int pAngle = MODE_TO_ANGLE[mode] + p.angleDelta * 3;
        int upA = 0, upL = 0;
        if (p.edgeFilter) {
            if (pAngle != 90 && pAngle != 180) {
                if (pAngle > 90 && pAngle < 180 && (w + h) >= 24) {
                    int s = left[0] * 5 + above[-1] * 6 + above[0] * 5;
                    above[-1] = left[-1] = round2(s, 4);
                }
                if (p.haveAbove) {
                    int strength = edge_strength(w, h, p.filterType, pAngle - 90);
                    int numPx = std::min(w, p.aboveLimit) + (pAngle < 90 ? h : 0) + 1;
                    edge_filter(above, numPx, strength);
                }
                if (p.haveLeft) {
                    int strength = edge_strength(w, h, p.filterType, pAngle - 180);
                    int numPx = std::min(h, p.leftLimit) + (pAngle > 180 ? w : 0) + 1;
                    edge_filter(left, numPx, strength);
                }
            }
            upA = use_upsample(w, h, p.filterType, pAngle - 90);
            if (upA) edge_upsample(above, w + (pAngle < 90 ? h : 0), bd);
            upL = use_upsample(w, h, p.filterType, pAngle - 180);
            if (upL) edge_upsample(left, h + (pAngle > 180 ? w : 0), bd);
        }
        int dx = 0, dy = 0;
        if (pAngle < 90) dx = DR_INTRA_DERIVATIVE[pAngle];
        else if (pAngle > 90 && pAngle < 180) dx = DR_INTRA_DERIVATIVE[180 - pAngle];
        if (pAngle > 90 && pAngle < 180) dy = DR_INTRA_DERIVATIVE[pAngle - 90];
        else if (pAngle > 180) dy = DR_INTRA_DERIVATIVE[270 - pAngle];
        for (int i = 0; i < h; i++) {
            for (int j = 0; j < w; j++) {
                int v;
                if (pAngle < 90) {
                    int idx = (i + 1) * dx;
                    int base = (idx >> (6 - upA)) + (j << upA);
                    int shift = ((idx << upA) >> 1) & 0x1F;
                    int maxBaseX = (w + h - 1) << upA;
                    if (base < maxBaseX)
                        v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                    else
                        v = above[maxBaseX];
                } else if (pAngle > 90 && pAngle < 180) {
                    int idx = (j << 6) - (i + 1) * dx;
                    int base = idx >> (6 - upA);
                    if (base >= -(1 << upA)) {
                        int shift = ((idx * (1 << upA)) >> 1) & 0x1F;
                        v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                    } else {
                        idx = (i << 6) - (j + 1) * dy;
                        base = idx >> (6 - upL);
                        int shift = ((idx * (1 << upL)) >> 1) & 0x1F;
                        v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                    }
                } else if (pAngle > 180) {
                    int idx = (j + 1) * dy;
                    int base = (idx >> (6 - upL)) + (i << upL);
                    int shift = ((idx << upL) >> 1) & 0x1F;
                    v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                } else if (pAngle == 90) {
                    v = above[j];
                } else {
                    v = left[i];
                }
                pred[i * w + j] = (P)v;
            }
        }
        return;
    }
    if (mode == SMOOTH_PRED) {
        const int16_t* wx = sm_weights(p.log2W);
        const int16_t* wy = sm_weights(p.log2H);
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int s = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] +
                        (256 - wx[j]) * above[w - 1];
                pred[i * w + j] = (P)round2(s, 9);
            }
        return;
    }
    if (mode == SMOOTH_V_PRED) {
        const int16_t* wy = sm_weights(p.log2H);
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                pred[i * w + j] = (P)round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
        return;
    }
    if (mode == SMOOTH_H_PRED) {
        const int16_t* wx = sm_weights(p.log2W);
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                pred[i * w + j] = (P)round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
        return;
    }
    if (mode == DC_PRED) {
        int avg;
        if (p.haveLeft && p.haveAbove) {
            int sum = 0;
            for (int k = 0; k < w; k++) sum += above[k];
            for (int k = 0; k < h; k++) sum += left[k];
            avg = (sum + ((w + h) >> 1)) / (w + h);
        } else if (p.haveLeft) {
            int sum = 0;
            for (int k = 0; k < h; k++) sum += left[k];
            avg = clip1((sum + (h >> 1)) >> p.log2H, bd);
        } else if (p.haveAbove) {
            int sum = 0;
            for (int k = 0; k < w; k++) sum += above[k];
            avg = clip1((sum + (w >> 1)) >> p.log2W, bd);
        } else {
            avg = 1 << (bd - 1);
        }
        std::fill(pred, pred + (size_t)w * h, (P)avg);
        return;
    }
    // PAETH
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int base = above[j] + left[i] - above[-1];
            int pL = std::abs(base - left[i]), pT = std::abs(base - above[j]);
            int pTL = std::abs(base - above[-1]);
            int v;
            if (pL <= pT && pL <= pTL) v = left[i];
            else if (pT <= pTL) v = above[j];
            else v = above[-1];
            pred[i * w + j] = (P)v;
        }
}

// CfL: `luma` holds the (padded) luma samples the block averages, lw x lh
// of subsampled positions already summed as in the specification (L[i][j]),
// `pred` the DC prediction of w x h, modified in place (bd bits).
template <typename P>
void cfl_apply(const int32_t* L, int w, int h, int alpha, P* pred, int bd) {
    int64_t sum = 0;
    for (int k = 0; k < w * h; k++) sum += L[k];
    int avg = round2(sum, floorlog2(w) + floorlog2(h));
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int dc = pred[i * w + j];
            int scaled = round2signed((int64_t)alpha * (L[i * w + j] - avg), 6);
            pred[i * w + j] = (P)clip1(dc + scaled, bd);
        }
}

// ----------------------------------------------------------- loop filter ---

struct LfParams {
    int filterSize, plane, limit, blimit, thresh;
};

// One position across an edge: s[k] for k = -8 .. 7 (s + 8 is q0), in place;
// the limits (given at 8 bits) and the flatness threshold scale by bd - 8,
// the narrow filter's lanes are bd bits around 0x80 << (bd - 8).
void lf_sample(int* s, const LfParams& lp, int bd) {
    int q0 = s[0], q1 = s[1], q2 = s[2], q3 = s[3];
    int p0 = s[-1], p1 = s[-2], p2 = s[-3], p3 = s[-4];
    int shift = bd - 8, limit = lp.limit << shift, blimit = lp.blimit << shift, thresh = lp.thresh << shift;
    int one = 1 << shift;
    int hevMask = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
    int filterLen;
    if (lp.filterSize == 4) filterLen = 4;
    else if (lp.plane != 0) filterLen = 6;
    else if (lp.filterSize == 8) filterLen = 8;
    else filterLen = 16;
    int mask = std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit &&
               std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
    if (filterLen >= 6) mask = mask && std::abs(p2 - p1) <= limit && std::abs(q2 - q1) <= limit;
    if (filterLen >= 8) mask = mask && std::abs(p3 - p2) <= limit && std::abs(q3 - q2) <= limit;
    if (!mask) return;
    int flat = 0, flat2 = 0;
    if (lp.filterSize >= 8) {
        flat = std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one && std::abs(p2 - p0) <= one &&
               std::abs(q2 - q0) <= one;
        if (filterLen >= 8) flat = flat && std::abs(p3 - p0) <= one && std::abs(q3 - q0) <= one;
    }
    if (lp.filterSize >= 16) {
        flat2 = std::abs(s[-7] - p0) <= one && std::abs(s[6] - q0) <= one && std::abs(s[-6] - p0) <= one &&
                std::abs(s[5] - q0) <= one && std::abs(s[-5] - p0) <= one && std::abs(s[4] - q0) <= one;
    }
    if (lp.filterSize == 4 || !flat) {
        int lo = -(1 << (bd - 1)), hi = (1 << (bd - 1)) - 1, mid = 0x80 << shift;
        auto c = [lo, hi](int v) { return clip3(lo, hi, v); };
        int ps1 = p1 - mid, ps0 = p0 - mid, qs0 = q0 - mid, qs1 = q1 - mid;
        int filter = hevMask ? c(ps1 - qs1) : 0;
        filter = c(filter + 3 * (qs0 - ps0));
        int filter1 = c(filter + 4) >> 3;
        int filter2 = c(filter + 3) >> 3;
        s[0] = c(qs0 - filter1) + mid;
        s[-1] = c(ps0 + filter2) + mid;
        if (!hevMask) {
            filter = round2(filter1, 1);
            s[1] = c(qs1 - filter) + mid;
            s[-2] = c(ps1 + filter) + mid;
        }
        return;
    }
    int log2Size = (lp.filterSize == 8 || !flat2) ? 3 : 4;
    int n, n2;
    if (log2Size == 4) n = 6;
    else if (lp.plane == 0) n = 3;
    else n = 2;
    n2 = (log2Size == 3 && lp.plane == 0) ? 0 : 1;
    int F[16], out[16];
    for (int k = -8; k < 8; k++) F[k + 8] = s[k];
    for (int i = -n; i < n; i++) {
        int t = 0;
        for (int j = -n; j <= n; j++) {
            int pp = clip3(-(n + 1), n, i + j);
            int tap = (std::abs(j) <= n2) ? 2 : 1;
            t += F[pp + 8] * tap;
        }
        out[i + 8] = round2(t, log2Size);
    }
    for (int i = -n; i < n; i++) s[i] = out[i + 8];
}

// ------------------------------------------------------------------ trace ---

// A trace of the stage calls for utils/av1.py's plain twins: records of
// int32 appended while they fit (kinds TRACE_*), off unless fd_av1_trace set
// a buffer. Not thread-safe; the load path never sets one.
enum { TRACE_PREDICT = 1, TRACE_CFL = 2, TRACE_TXFM = 3, TRACE_LF = 4, TRACE_CDEF = 5, TRACE_WIENER = 6,
       TRACE_SGR = 7, TRACE_DEPTH = 8 };
int32_t* g_trace = nullptr;
int64_t g_trace_cap = 0, g_trace_len = 0, g_trace_lost = 0;

struct TraceRecord {
    int64_t start;
    bool ok;
    explicit TraceRecord(int64_t need) : start(g_trace_len), ok(g_trace && g_trace_len + need <= g_trace_cap) {
        if (g_trace && !ok) g_trace_lost++;
    }
    void put(int32_t v) { if (ok) g_trace[g_trace_len++] = v; }
};

// A record of kind TRACE_DEPTH sets the bit depth of the records after it
// (8 until one does): each entry point of a frame at 10 or 12 bits writes
// one first, so an 8-bit frame's trace is as it was.
void trace_depth(int bd) {
    if (bd == 8) return;
    TraceRecord tr(g_trace ? 2 : 0);
    tr.put(TRACE_DEPTH);
    tr.put(bd);
}

// ---------------------------------------------------------- symbol decoder ---

struct SymbolDecoder {
    const uint8_t* buf = nullptr;
    int64_t size = 0, bitpos = 0, maxBits = 0;
    uint32_t value = 0, range = 0;
    int disableUpdate = 0;

    int bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) {
            int bit = 0;
            if (bitpos < size * 8) bit = (buf[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
            bitpos++;
            v = (v << 1) | bit;
        }
        return (int)v;
    }
    void init(const uint8_t* b, int64_t sz, int disable) {
        buf = b;
        size = sz;
        bitpos = 0;
        disableUpdate = disable;
        int numBits = (int)std::min<int64_t>(sz * 8, 15);
        uint32_t v = (uint32_t)bits(numBits);
        uint32_t padded = v << (15 - numBits);
        value = ((1u << 15) - 1) ^ padded;
        range = 1u << 15;
        maxBits = 8 * sz - 15;
    }
    int decode(const uint16_t* cdf, int N) {
        uint32_t cur = range, prev;
        int symbol = -1;
        do {
            symbol++;
            prev = cur;
            uint32_t f = cdf[symbol];
            cur = (((range >> 8) * (f >> 6)) >> 1) + 4 * (uint32_t)(N - symbol - 1);
        } while (value < cur);
        range = prev - cur;
        value -= cur;
        int b = 15 - floorlog2(range);
        range <<= b;
        int numBits = (int)std::min<int64_t>(b, std::max<int64_t>(0, maxBits));
        uint32_t newData = (uint32_t)this->bits(numBits);
        uint32_t padded = newData << (b - numBits);
        value = padded ^ (((value + 1) << b) - 1);
        maxBits -= b;
        return symbol;
    }
    int symbol(uint16_t* cdf, int N) {
        int s = decode(cdf, N);
        if (!disableUpdate) {
            int rate = 3 + (cdf[N] > 15) + (cdf[N] > 31) + std::min(floorlog2(N), 2);
            int tmp = 32768;
            for (int i = 0; i < N - 1; i++) {
                if (i == s) tmp = 0;
                if (tmp < cdf[i]) cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
                else cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
            }
            cdf[N] += (cdf[N] < 32);
        }
        return s;
    }
    int boolean() {
        static const uint16_t half[3] = {16384, 0, 0};
        return decode(half, 2);
    }
    int literal(int n) {
        int x = 0;
        for (int i = 0; i < n; i++) x = 2 * x + boolean();
        return x;
    }
    int ns(int n) {
        int w = floorlog2(n) + 1;
        int m = (1 << w) - n;
        int v = literal(w - 1);
        if (v < m) return v;
        int extra = literal(1);
        return (v << 1) - m + extra;
    }
};

// ------------------------------------------------------------------ CDFs ---

struct Cdfs {
    uint16_t kf_y_mode[5][5][14];
    uint16_t uv_cfl_not[13][14];
    uint16_t uv_cfl[13][15];
    uint16_t angle_delta[8][8];
    uint16_t partition_w8[4][5], partition_w16[4][11], partition_w32[4][11], partition_w64[4][11];
    uint16_t partition_w128[4][9];
    uint16_t segment_id[3][9];
    uint16_t tx_8x8[3][3], tx_16x16[3][4], tx_32x32[3][4], tx_64x64[3][4];
    uint16_t filter_intra_mode[6];
    uint16_t filter_intra[22][3];
    uint16_t skip[3][3];
    uint16_t delta_q[5], delta_lf[5], delta_lf_multi[4][5];
    uint16_t intra_tx_set1[2][13][8];
    uint16_t intra_tx_set2[3][13][6];
    uint16_t cfl_sign[9];
    uint16_t cfl_alpha[6][17];
    uint16_t palette_y_size[7][8], palette_uv_size[7][8];
    uint16_t palette_y_color[7][5][9], palette_uv_color[7][5][9];
    uint16_t palette_y_mode[7][3][3], palette_uv_mode[2][3];
    uint16_t intrabc[3];
    uint16_t txfm_split[21][3];
    uint16_t inter_tx_set1[4][17], inter_tx_set2[4][13], inter_tx_set3[4][3];
    uint16_t mv_joint[5];
    uint16_t mv_class[2][12], mv_sign[2][3], mv_class0[2][3], mv_bits[2][10][3];
    uint16_t txb_skip[5][13][3];
    uint16_t eob_pt16[2][2][6], eob_pt32[2][2][7], eob_pt64[2][2][8], eob_pt128[2][2][9];
    uint16_t eob_pt256[2][2][10], eob_pt512[2][2][11], eob_pt1024[2][2][12];
    uint16_t eob_extra[5][2][9][3];
    uint16_t dc_sign[2][3][3];
    uint16_t coeff_base_eob[5][2][4][4];
    uint16_t coeff_base[5][2][42][5];
    uint16_t coeff_br[5][2][21][5];
    uint16_t restoration_type[4], use_wiener[3], use_sgrproj[3];
};

template <typename D, typename S>
void copy_table(D& dst, const S& src) {
    static_assert(sizeof(D) == sizeof(S), "table shapes differ");
    std::memcpy(&dst, &src, sizeof(D));
}

void init_cdfs(Cdfs& c, int baseQ) {
    copy_table(c.kf_y_mode, KF_Y_MODE);
    copy_table(c.uv_cfl_not, UV_MODE_CFL_NOT_ALLOWED);
    copy_table(c.uv_cfl, UV_MODE_CFL_ALLOWED);
    copy_table(c.angle_delta, ANGLE_DELTA);
    copy_table(c.partition_w8, PARTITION_W8);
    copy_table(c.partition_w16, PARTITION_W16);
    copy_table(c.partition_w32, PARTITION_W32);
    copy_table(c.partition_w64, PARTITION_W64);
    copy_table(c.partition_w128, PARTITION_W128);
    copy_table(c.segment_id, SEGMENT_ID);
    copy_table(c.tx_8x8, TX_8X8);
    copy_table(c.tx_16x16, TX_16X16);
    copy_table(c.tx_32x32, TX_32X32);
    copy_table(c.tx_64x64, TX_64X64);
    copy_table(c.filter_intra_mode, FILTER_INTRA_MODE);
    copy_table(c.filter_intra, FILTER_INTRA);
    copy_table(c.skip, SKIP);
    copy_table(c.delta_q, DELTA_Q);
    copy_table(c.delta_lf, DELTA_LF);
    copy_table(c.delta_lf_multi, DELTA_LF_MULTI);
    copy_table(c.intra_tx_set1, INTRA_TX_SET1);
    copy_table(c.intra_tx_set2, INTRA_TX_SET2);
    copy_table(c.cfl_sign, CFL_SIGN);
    copy_table(c.cfl_alpha, CFL_ALPHA);
    copy_table(c.palette_y_size, PALETTE_Y_SIZE);
    copy_table(c.palette_uv_size, PALETTE_UV_SIZE);
    copy_table(c.palette_y_color, PALETTE_Y_COLOR);
    copy_table(c.palette_uv_color, PALETTE_UV_COLOR);
    copy_table(c.palette_y_mode, PALETTE_Y_MODE);
    copy_table(c.palette_uv_mode, PALETTE_UV_MODE);
    copy_table(c.intrabc, INTRABC);
    copy_table(c.txfm_split, TXFM_SPLIT);
    copy_table(c.inter_tx_set1, INTER_TX_SET1);
    copy_table(c.inter_tx_set2, INTER_TX_SET2);
    copy_table(c.inter_tx_set3, INTER_TX_SET3);
    copy_table(c.mv_joint, MV_JOINT);
    copy_table(c.restoration_type, RESTORATION_TYPE);
    copy_table(c.use_wiener, USE_WIENER);
    copy_table(c.use_sgrproj, USE_SGRPROJ);
    for (int comp = 0; comp < 2; comp++) {  // the two components start alike
        copy_table(c.mv_class[comp], MV_CLASS);
        copy_table(c.mv_sign[comp], MV_SIGN);
        copy_table(c.mv_class0[comp], MV_CLASS0);
        copy_table(c.mv_bits[comp], MV_BITS);
    }
    int q = baseQ <= 20 ? 0 : baseQ <= 60 ? 1 : baseQ <= 120 ? 2 : 3;
    copy_table(c.txb_skip, TXB_SKIP[q]);
    copy_table(c.eob_pt16, EOB_PT_16[q]);
    copy_table(c.eob_pt32, EOB_PT_32[q]);
    copy_table(c.eob_pt64, EOB_PT_64[q]);
    copy_table(c.eob_pt128, EOB_PT_128[q]);
    copy_table(c.eob_pt256, EOB_PT_256[q]);
    copy_table(c.eob_pt512, EOB_PT_512[q]);
    copy_table(c.eob_pt1024, EOB_PT_1024[q]);
    copy_table(c.eob_extra, EOB_EXTRA[q]);
    copy_table(c.dc_sign, DC_SIGN[q]);
    copy_table(c.coeff_base_eob, COEFF_BASE_EOB[q]);
    copy_table(c.coeff_base, COEFF_BASE[q]);
    copy_table(c.coeff_br, COEFF_BR[q]);
}

// ---------------------------------------------------------------- header ---

// The frame header as utils/av1.py packs it (HDR_* there).
enum {
    H_WIDTH, H_HEIGHT, H_MI_COLS, H_MI_ROWS, H_MONO, H_USE128, H_FILTER_INTRA, H_EDGE_FILTER,
    H_DISABLE_CDF_UPDATE, H_SCREEN_CONTENT, H_ALLOW_INTRABC, H_BASE_Q, H_DQ_Y_DC, H_DQ_U_DC, H_DQ_U_AC, H_DQ_V_DC,
    H_DQ_V_AC, H_SEG_ENABLED, H_SEG_PRE_SKIP, H_LAST_ACTIVE_SEG, H_DELTA_Q_PRESENT, H_DELTA_Q_RES,
    H_DELTA_LF_PRESENT, H_DELTA_LF_RES, H_DELTA_LF_MULTI, H_TX_MODE, H_REDUCED_TX_SET, H_LF_LEVEL0,
    H_SHARPNESS = H_LF_LEVEL0 + 4, H_LF_DELTA_ENABLED, H_REF_DELTAS,
    H_ROW_START = H_REF_DELTAS + 8, H_ROW_END, H_COL_START, H_COL_END,
    H_FEATURE_ENABLED, H_FEATURE_DATA = H_FEATURE_ENABLED + 64, H_LOSSLESS = H_FEATURE_DATA + 64,
    H_STRIDE_Y = H_LOSSLESS + 8, H_STRIDE_UV, H_USING_QM, H_QM_Y, H_QM_U, H_QM_V,
    // CDEF: read_cdef reads (enable_cdef, not coded lossless, no intra block
    // copy), damping, cdef_bits, the strengths of each index (secondary 3
    // read as 4)
    H_CDEF_READ, H_CDEF_DAMPING, H_CDEF_BITS, H_CDEF_Y_PRI, H_CDEF_Y_SEC = H_CDEF_Y_PRI + 8,
    H_CDEF_UV_PRI = H_CDEF_Y_SEC + 8, H_CDEF_UV_SEC = H_CDEF_UV_PRI + 8,
    // loop restoration: each plane's FrameRestorationType, unit size in
    // samples, units down and across, and the units of a plane in the
    // out-array (its stride)
    H_LR_TYPE = H_CDEF_UV_SEC + 8, H_LR_SIZE = H_LR_TYPE + 3, H_LR_ROWS = H_LR_SIZE + 3,
    H_LR_COLS = H_LR_ROWS + 3, H_LR_STRIDE = H_LR_COLS + 3,
    // the chroma planes' subsampling across and down (1 for monochrome),
    // BitDepth (8, 10 or 12)
    H_SSX, H_SSY, H_BITDEPTH, H_SIZE
};
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };
// a restoration unit in the out-array: its type, the Wiener taps 0-2 of the
// vertical then the horizontal filter, the self-guided set and weights
enum { L_TYPE, L_WIENER, L_SET = L_WIENER + 6, L_XQD, L_FIELDS = L_XQD + 2 };
enum { TX_ONLY_4X4, TX_LARGEST, TX_SELECT };

// The planes are allocated to whole 128x128 superblocks (the strides in the
// header), since a transform block may run past the frame's last 4x4.

// per 4x4 (MI) info the tile writes and the loop filter reads
enum { M_SIZE, M_SKIP, M_SEG, M_TX_Y, M_TX_UV, M_DLF0, M_DLF1, M_DLF2, M_DLF3, M_YMODE,
       M_UVMODE, M_INTER, M_MV_ROW, M_MV_COL, M_WRITTEN, M_FIELDS };

// ------------------------------------------------------------------ tile ---

template <typename P>
struct Tile {
    const int32_t* hdr;
    int miCols, miRows, rowStart, rowEnd, colStart, colEnd;
    // 4:2:0, 4:2:2 or 4:4:4 (a monochrome frame has no chroma planes)
    int ssx, ssy;
    int mono, numPlanes, use128, sbSize4;
    int bd;  // BitDepth: 8 (P uint8_t), 10 or 12 (uint16_t)
    P* plane[3];
    int stride[3];
    int32_t* mi;  // [miRows][miCols][M_FIELDS]
    int32_t* cdefIdx;  // [(miRows + 15) / 16][(miCols + 15) / 16], -1 unread
    int32_t* lrUnits;  // [3][H_LR_STRIDE][L_FIELDS]
    int refLrWiener[3][2][3], refSgrXqd[3][2];
    SymbolDecoder sd;
    Cdfs cdf;
    // frame-wide block state read by the contexts
    std::vector<uint8_t> palSize[2];
    std::vector<uint16_t> palColors[2];  // 8 a 4x4
    std::vector<uint8_t> txTypes;
    std::vector<uint8_t> txSizes;
    std::vector<uint8_t> aboveLevel[3], aboveDc[3], leftLevel[3], leftDc[3];
    uint8_t blockDecoded[3][35][35];
    int currentQ;
    int deltaLF[4];
    int readDeltas;
    int err = 0;

    // the block being decoded
    int miRow, miCol, miSize, bw4, bh4, hasChroma, availU, availL, availUC, availLC;
    int skip, segmentId, lossless, yMode, uvMode, angleDeltaY, angleDeltaUV, cflAlphaU, cflAlphaV;
    int useFilterIntra, filterIntraMode, paletteSizeY, paletteSizeUV, txSize, isInter;
    int mvRow, mvCol;  // an intra block copy's vector, 1/8 pel
    int paletteColors[3][8];
    uint8_t colorMapY[64][64], colorMapUV[64][64];
    int maxLumaW, maxLumaH;
    int planeTxType;

    int32_t* m(int r, int c) { return mi + ((size_t)r * miCols + c) * M_FIELDS; }
    bool inside(int r, int c) const {
        return c >= colStart && c < colEnd && r >= rowStart && r < rowEnd;
    }
    int feature(int seg, int f) const { return hdr[H_FEATURE_ENABLED + seg * 8 + f]; }
    int feature_data(int seg, int f) const { return hdr[H_FEATURE_DATA + seg * 8 + f]; }
    int qidx(int ignoreDelta, int seg) const {
        if (hdr[H_SEG_ENABLED] && feature(seg, 0)) {
            int data = feature_data(seg, 0);
            int q = hdr[H_BASE_Q] + data;
            if (!ignoreDelta && hdr[H_DELTA_Q_PRESENT]) q = currentQ + data;
            return clip3(0, 255, q);
        }
        if (!ignoreDelta && hdr[H_DELTA_Q_PRESENT]) return currentQ;
        return hdr[H_BASE_Q];
    }

    void clear_block_decoded(int r, int c) {
        for (int p = 0; p < numPlanes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int sbW4 = (colEnd - c) >> sx, sbH4 = (rowEnd - r) >> sy;
            for (int y = -1; y <= (sbSize4 >> sy); y++)
                for (int x = -1; x <= (sbSize4 >> sx); x++) {
                    int v;
                    if (y < 0 && x < sbW4) v = 1;
                    else if (x < 0 && y < sbH4) v = 1;
                    else v = 0;
                    blockDecoded[p][y + 1][x + 1] = (uint8_t)v;
                }
            blockDecoded[p][(sbSize4 >> sy) + 1][0] = 0;
        }
    }

    // ---- partitions
    void decode_partition(int r, int c, int bSize) {
        if (err) return;
        if (r >= miRows || c >= miCols) return;
        int aU = inside(r - 1, c), aL = inside(r, c - 1);
        int num4 = kBW[bSize] >> 2, half = num4 >> 1, quarter = half >> 1;
        int hasRows = (r + half) < miRows, hasCols = (c + half) < miCols;
        int partition;
        if (bSize < B8X8) {
            partition = 0;
        } else {
            int bsl = mi_wlog2(bSize);
            int above = aU && mi_wlog2(m(r - 1, c)[M_SIZE]) < bsl;
            int left = aL && mi_hlog2(m(r, c - 1)[M_SIZE]) < bsl;
            int ctx = left * 2 + above;
            uint16_t* pc;
            int N;
            if (bSize == B8X8) { pc = cdf.partition_w8[ctx]; N = 4; }
            else if (bSize == B16X16) { pc = cdf.partition_w16[ctx]; N = 10; }
            else if (bSize == B32X32) { pc = cdf.partition_w32[ctx]; N = 10; }
            else if (bSize == B64X64) { pc = cdf.partition_w64[ctx]; N = 10; }
            else { pc = cdf.partition_w128[ctx]; N = 8; }
            if (hasRows && hasCols) {
                partition = sd.symbol(pc, N);
            } else if (hasCols || hasRows) {
                auto Pr = [&](int s) { return s >= N ? 0 : (s == 0 ? 32768 : pc[s - 1]) - pc[s]; };
                int psum;
                if (hasCols)  // split_or_horz
                    psum = Pr(2) + Pr(3) + Pr(4) + Pr(6) + Pr(7) + (bSize != B128X128 ? Pr(9) : 0);
                else          // split_or_vert
                    psum = Pr(1) + Pr(3) + Pr(4) + Pr(5) + Pr(6) + (bSize != B128X128 ? Pr(8) : 0);
                uint16_t tmp[3] = {(uint16_t)psum, 0, 0};
                int bit = sd.decode(tmp, 2);
                partition = bit ? 3 : (hasCols ? 1 : 2);
            } else {
                partition = 3;
            }
            // 4:2:2 has no chroma size for a block twice as tall as wide:
            // dav1d rejects the partitions that make one
            if (ssx && !ssy && (partition == 2 || partition == 6 || partition == 7 || partition == 9)) {
                err = kPartition422;
                return;
            }
        }
        int w = kBW[bSize], h = kBH[bSize];
        int subSize, splitSize = block_of(w / 2, h / 2);
        switch (partition) {
            case 0: subSize = bSize; break;
            case 1: case 4: case 5: subSize = block_of(w, h / 2); break;
            case 2: case 6: case 7: subSize = block_of(w / 2, h); break;
            case 3: subSize = splitSize; break;
            case 8: subSize = block_of(w, h / 4); break;
            default: subSize = block_of(w / 4, h); break;
        }
        switch (partition) {
            case 0: decode_block(r, c, subSize); break;
            case 1:
                decode_block(r, c, subSize);
                if (hasRows) decode_block(r + half, c, subSize);
                break;
            case 2:
                decode_block(r, c, subSize);
                if (hasCols) decode_block(r, c + half, subSize);
                break;
            case 3:
                decode_partition(r, c, subSize);
                decode_partition(r, c + half, subSize);
                decode_partition(r + half, c, subSize);
                decode_partition(r + half, c + half, subSize);
                break;
            case 4:
                decode_block(r, c, splitSize);
                decode_block(r, c + half, splitSize);
                decode_block(r + half, c, subSize);
                break;
            case 5:
                decode_block(r, c, subSize);
                decode_block(r + half, c, splitSize);
                decode_block(r + half, c + half, splitSize);
                break;
            case 6:
                decode_block(r, c, splitSize);
                decode_block(r + half, c, splitSize);
                decode_block(r, c + half, subSize);
                break;
            case 7:
                decode_block(r, c, subSize);
                decode_block(r, c + half, splitSize);
                decode_block(r + half, c + half, splitSize);
                break;
            case 8:
                for (int i = 0; i < 4; i++)
                    if (i < 3 || r + quarter * 3 < miRows) decode_block(r + quarter * i, c, subSize);
                break;
            default:
                for (int i = 0; i < 4; i++)
                    if (i < 3 || c + quarter * 3 < miCols) decode_block(r, c + quarter * i, subSize);
                break;
        }
    }

    // ---- mode info
    void read_segment_id() {
        int prevUL = -1, prevU = -1, prevL = -1;
        if (availU && availL) prevUL = m(miRow - 1, miCol - 1)[M_SEG];
        if (availU) prevU = m(miRow - 1, miCol)[M_SEG];
        if (availL) prevL = m(miRow, miCol - 1)[M_SEG];
        int ctx;
        if (prevUL < 0) ctx = 0;
        else if (prevUL == prevU && prevUL == prevL) ctx = 2;
        else if (prevUL == prevU || prevUL == prevL || prevU == prevL) ctx = 1;
        else ctx = 0;
        int pred;
        if (prevU == -1) pred = prevL == -1 ? 0 : prevL;
        else if (prevL == -1) pred = prevU;
        else pred = prevUL == prevU ? prevU : prevL;
        if (skip) {
            segmentId = pred;
            return;
        }
        int s = sd.symbol(cdf.segment_id[ctx], 8);
        int mx = hdr[H_LAST_ACTIVE_SEG] + 1;
        int v;
        if (!pred) v = s;
        else if (pred >= mx - 1) v = mx - s - 1;
        else if (2 * pred < mx) {
            if (s <= 2 * pred) v = (s & 1) ? pred + ((s + 1) >> 1) : pred - (s >> 1);
            else v = s;
        } else {
            if (s <= 2 * (mx - pred - 1)) v = (s & 1) ? pred + ((s + 1) >> 1) : pred - (s >> 1);
            else v = mx - (s + 1);
        }
        segmentId = clip3(0, hdr[H_LAST_ACTIVE_SEG], v);
    }
    void intra_segment_id() {
        if (hdr[H_SEG_ENABLED]) read_segment_id();
        else segmentId = 0;
        lossless = hdr[H_LOSSLESS + segmentId];
    }
    void read_skip() {
        if (hdr[H_SEG_PRE_SKIP] && feature(segmentId, 6)) {
            skip = 1;
            return;
        }
        int ctx = 0;
        if (availU) ctx += m(miRow - 1, miCol)[M_SKIP];
        if (availL) ctx += m(miRow, miCol - 1)[M_SKIP];
        skip = sd.symbol(cdf.skip[ctx], 2);
    }
    // ---- CDEF index and loop restoration units (specification 5.11.56-58)
    int cdefCols() const { return (miCols + 15) >> 4; }
    void set_cdef(int r, int c, int h4, int w4, int v) {
        int rows = (miRows + 15) >> 4;
        for (int y = r; y < r + h4; y += 16)
            for (int x = c; x < c + w4; x += 16)
                if ((y >> 4) < rows && (x >> 4) < cdefCols()) cdefIdx[(y >> 4) * cdefCols() + (x >> 4)] = v;
    }
    void read_cdef() {
        if (skip || !hdr[H_CDEF_READ]) return;
        int r = miRow & ~15, c = miCol & ~15;
        if (cdefIdx[(r >> 4) * cdefCols() + (c >> 4)] != -1) return;
        set_cdef(r, c, bh4, bw4, sd.literal(hdr[H_CDEF_BITS]));
    }
    int decode_subexp_bool(int numSyms, int k) {
        int i = 0, mk = 0;
        while (true) {
            int b2 = i ? k + i - 1 : k;
            int a = 1 << b2;
            if (numSyms <= mk + 3 * a) return sd.ns(numSyms - mk) + mk;
            if (!sd.literal(1)) return sd.literal(b2) + mk;
            i++;
            mk += a;
        }
    }
    static int inverse_recenter(int r, int v) {
        if (v > 2 * r) return v;
        if (v & 1) return r - ((v + 1) >> 1);
        return r + (v >> 1);
    }
    int decode_signed_subexp_with_ref_bool(int low, int high, int k, int r) {
        int mx = high - low;
        r -= low;
        int v = decode_subexp_bool(mx, k);
        int x = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
        return x + low;
    }
    void read_lr_unit(int p, int unitRow, int unitCol) {
        int32_t* u = lrUnits + ((size_t)p * hdr[H_LR_STRIDE] + (size_t)unitRow * hdr[H_LR_COLS + p] + unitCol) * L_FIELDS;
        int frameType = hdr[H_LR_TYPE + p], type;
        if (frameType == RESTORE_WIENER) type = sd.symbol(cdf.use_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
        else if (frameType == RESTORE_SGRPROJ) type = sd.symbol(cdf.use_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
        else type = sd.symbol(cdf.restoration_type, 3);
        u[L_TYPE] = type;
        if (type == RESTORE_WIENER) {
            for (int pass = 0; pass < 2; pass++) {
                int first = p ? 1 : 0;
                if (p) u[L_WIENER + pass * 3] = 0;
                for (int j = first; j < 3; j++) {
                    int v = decode_signed_subexp_with_ref_bool(WIENER_TAPS_MIN[j], WIENER_TAPS_MAX[j] + 1,
                                                               WIENER_TAPS_K[j], refLrWiener[p][pass][j]);
                    u[L_WIENER + pass * 3 + j] = v;
                    refLrWiener[p][pass][j] = v;
                }
            }
        } else if (type == RESTORE_SGRPROJ) {
            int set = sd.literal(4);
            u[L_SET] = set;
            for (int i = 0; i < 2; i++) {
                int radius = SGR_PARAMS[set][i];
                int mn = SGRPROJ_XQD_MIN[i], mx = SGRPROJ_XQD_MAX[i], v;
                if (radius) {
                    v = decode_signed_subexp_with_ref_bool(mn, mx + 1, 4, refSgrXqd[p][i]);
                } else {
                    v = 0;
                    if (i == 1) v = clip3(mn, mx, (1 << 7) - refSgrXqd[p][0]);
                }
                u[L_XQD + i] = v;
                refSgrXqd[p][i] = v;
            }
        }
    }
    void read_lr(int r, int c) {
        if (hdr[H_ALLOW_INTRABC]) return;
        for (int p = 0; p < numPlanes; p++) {
            if (hdr[H_LR_TYPE + p] == RESTORE_NONE) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int unitSize = hdr[H_LR_SIZE + p];
            int unitRows = hdr[H_LR_ROWS + p], unitCols = hdr[H_LR_COLS + p];
            int rowStart = (r * (4 >> sy) + unitSize - 1) / unitSize;
            int rowEnd = std::min(unitRows, ((r + sbSize4) * (4 >> sy) + unitSize - 1) / unitSize);
            int colStart = (c * (4 >> sx) + unitSize - 1) / unitSize;
            int colEnd = std::min(unitCols, ((c + sbSize4) * (4 >> sx) + unitSize - 1) / unitSize);
            for (int ur = rowStart; ur < rowEnd; ur++)
                for (int uc = colStart; uc < colEnd; uc++) read_lr_unit(p, ur, uc);
        }
    }

    int read_delta_abs(uint16_t* c) {
        int a = sd.symbol(c, 4);
        if (a == 3) {
            int rem = sd.literal(3) + 1;
            a = sd.literal(rem) + (1 << rem) + 1;
        }
        return a;
    }
    void read_delta_qindex() {
        int sbSize = use128 ? B128X128 : B64X64;
        if (miSize == sbSize && skip) return;
        if (readDeltas) {
            int a = read_delta_abs(cdf.delta_q);
            if (a) {
                int sign = sd.literal(1);
                int red = sign ? -a : a;
                currentQ = clip3(1, 255, currentQ + (red << hdr[H_DELTA_Q_RES]));
            }
        }
    }
    void read_delta_lf() {
        int sbSize = use128 ? B128X128 : B64X64;
        if (miSize == sbSize && skip) return;
        if (readDeltas && hdr[H_DELTA_LF_PRESENT]) {
            int n = 1;
            if (hdr[H_DELTA_LF_MULTI]) n = mono ? 2 : 4;
            for (int i = 0; i < n; i++) {
                int a = read_delta_abs(hdr[H_DELTA_LF_MULTI] ? cdf.delta_lf_multi[i] : cdf.delta_lf);
                if (a) {
                    int sign = sd.literal(1);
                    int red = sign ? -a : a;
                    deltaLF[i] = clip3(-63, 63, deltaLF[i] + (red << hdr[H_DELTA_LF_RES]));
                }
            }
        }
    }
    void read_cfl_alphas() {
        int signs = sd.symbol(cdf.cfl_sign, 8);
        int signU = (signs + 1) / 3, signV = (signs + 1) % 3;
        if (signU) {
            int a = sd.symbol(cdf.cfl_alpha[(signU - 1) * 3 + signV], 16);
            cflAlphaU = signU == 1 ? -(a + 1) : a + 1;
        } else {
            cflAlphaU = 0;
        }
        if (signV) {
            int a = sd.symbol(cdf.cfl_alpha[(signV - 1) * 3 + signU], 16);
            cflAlphaV = signV == 1 ? -(a + 1) : a + 1;
        } else {
            cflAlphaV = 0;
        }
    }
    int palette_cache(int p, int* cache) {
        int aboveN = 0, leftN = 0;
        if (((miRow * 4) % 64) && availU) aboveN = palSize[p][(size_t)(miRow - 1) * miCols + miCol];
        if (availL) leftN = palSize[p][(size_t)miRow * miCols + miCol - 1];
        const uint16_t* ac = &palColors[p][((size_t)(miRow - 1) * miCols + miCol) * 8];
        const uint16_t* lc = &palColors[p][((size_t)miRow * miCols + miCol - 1) * 8];
        int ai = 0, li = 0, n = 0;
        while (ai < aboveN && li < leftN) {
            int a = ac[ai], l = lc[li];
            if (l < a) {
                if (n == 0 || l != cache[n - 1]) cache[n++] = l;
                li++;
            } else {
                if (n == 0 || a != cache[n - 1]) cache[n++] = a;
                ai++;
                if (l == a) li++;
            }
        }
        while (ai < aboveN) {
            int v = ac[ai++];
            if (n == 0 || v != cache[n - 1]) cache[n++] = v;
        }
        while (li < leftN) {
            int v = lc[li++];
            if (n == 0 || v != cache[n - 1]) cache[n++] = v;
        }
        return n;
    }
    void read_palette_colors(int p, int size, int* colors) {
        int cache[16];
        int cacheN = palette_cache(p, cache);
        int idx = 0;
        for (int i = 0; i < cacheN && idx < size; i++)
            if (sd.literal(1)) colors[idx++] = cache[i];
        if (idx < size) colors[idx++] = sd.literal(bd);
        int paletteBits = 0;
        if (idx < size) paletteBits = bd - 3 + sd.literal(2);
        while (idx < size) {
            int delta = sd.literal(paletteBits);
            if (p == 0) delta++;
            colors[idx] = clip1(colors[idx - 1] + delta, bd);
            int range = (1 << bd) - colors[idx] - (p == 0 ? 1 : 0);
            idx++;
            paletteBits = std::min(paletteBits, ceillog2(range));
        }
        std::sort(colors, colors + size);
    }
    void palette_mode_info() {
        int bsizeCtx = mi_wlog2(miSize) + mi_hlog2(miSize) - 2;
        if (yMode == DC_PRED) {
            int ctx = 0;
            if (availU && palSize[0][(size_t)(miRow - 1) * miCols + miCol] > 0) ctx++;
            if (availL && palSize[0][(size_t)miRow * miCols + miCol - 1] > 0) ctx++;
            if (sd.symbol(cdf.palette_y_mode[bsizeCtx][ctx], 2)) {
                paletteSizeY = sd.symbol(cdf.palette_y_size[bsizeCtx], 7) + 2;
                read_palette_colors(0, paletteSizeY, paletteColors[0]);
            }
        }
        if (hasChroma && uvMode == DC_PRED) {
            int ctx = paletteSizeY > 0;
            if (sd.symbol(cdf.palette_uv_mode[ctx], 2)) {
                paletteSizeUV = sd.symbol(cdf.palette_uv_size[bsizeCtx], 7) + 2;
                read_palette_colors(1, paletteSizeUV, paletteColors[1]);
                if (sd.literal(1)) {
                    int bits = bd - 4 + sd.literal(2), maxVal = 1 << bd;
                    paletteColors[2][0] = sd.literal(bd);
                    for (int idx = 1; idx < paletteSizeUV; idx++) {
                        int d = sd.literal(bits);
                        if (d && sd.literal(1)) d = -d;
                        int val = paletteColors[2][idx - 1] + d;
                        if (val < 0) val += maxVal;
                        if (val >= maxVal) val -= maxVal;
                        paletteColors[2][idx] = clip1(val, bd);
                    }
                } else {
                    for (int idx = 0; idx < paletteSizeUV; idx++) paletteColors[2][idx] = sd.literal(bd);
                }
            }
        }
    }
    void intra_frame_mode_info() {
        if (hdr[H_SEG_PRE_SKIP]) intra_segment_id();
        read_skip();
        if (!hdr[H_SEG_PRE_SKIP]) intra_segment_id();
        read_cdef();
        read_delta_qindex();
        read_delta_lf();
        readDeltas = 0;
        useFilterIntra = 0;
        paletteSizeY = paletteSizeUV = 0;
        angleDeltaY = angleDeltaUV = 0;
        cflAlphaU = cflAlphaV = 0;
        isInter = 0;
        yMode = uvMode = DC_PRED;
        if (hdr[H_ALLOW_INTRABC] && sd.symbol(cdf.intrabc, 2)) {
            isInter = 1;
            find_mv_stack();
            assign_mv();
            return;
        }
        int above = availU ? m(miRow - 1, miCol)[M_YMODE] : DC_PRED;
        int left = availL ? m(miRow, miCol - 1)[M_YMODE] : DC_PRED;
        yMode = sd.symbol(cdf.kf_y_mode[INTRA_MODE_CONTEXT[above]][INTRA_MODE_CONTEXT[left]], 13);
        if (miSize >= B8X8 && directional(yMode))
            angleDeltaY = sd.symbol(cdf.angle_delta[yMode - V_PRED], 7) - 3;
        uvMode = DC_PRED;
        if (hasChroma) {
            int cflAllowed;
            if (lossless && plane_size(miSize, ssx, ssy) == B4X4) cflAllowed = 1;
            else if (!lossless && std::max(kBW[miSize], kBH[miSize]) <= 32) cflAllowed = 1;
            else cflAllowed = 0;
            uvMode = cflAllowed ? sd.symbol(cdf.uv_cfl[yMode], 14) : sd.symbol(cdf.uv_cfl_not[yMode], 13);
            if (uvMode == UV_CFL_PRED) read_cfl_alphas();
            if (miSize >= B8X8 && directional(uvMode))
                angleDeltaUV = sd.symbol(cdf.angle_delta[uvMode - V_PRED], 7) - 3;
        }
        if (miSize >= B8X8 && kBW[miSize] <= 64 && kBH[miSize] <= 64 && hdr[H_SCREEN_CONTENT])
            palette_mode_info();
        if (hdr[H_FILTER_INTRA] && yMode == DC_PRED && paletteSizeY == 0 &&
            std::max(kBW[miSize], kBH[miSize]) <= 32) {
            useFilterIntra = sd.symbol(cdf.filter_intra[miSize], 2);
            if (useFilterIntra) filterIntraMode = sd.symbol(cdf.filter_intra_mode, 5);
        }
    }

    // ---- palette tokens
    void color_context(uint8_t map[64][64], int r, int c, int n, int* order, int* ctx) {
        int scores[8] = {0};
        for (int i = 0; i < 8; i++) order[i] = i;
        if (c > 0) scores[map[r][c - 1]] += 2;
        if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
        if (r > 0) scores[map[r - 1][c]] += 2;
        for (int i = 0; i < 3; i++) {
            int maxScore = scores[i], maxIdx = i;
            for (int j = i + 1; j < n; j++)
                if (scores[j] > maxScore) { maxScore = scores[j]; maxIdx = j; }
            if (maxIdx != i) {
                maxScore = scores[maxIdx];
                int maxOrder = order[maxIdx];
                for (int k = maxIdx; k > i; k--) {
                    scores[k] = scores[k - 1];
                    order[k] = order[k - 1];
                }
                scores[i] = maxScore;
                order[i] = maxOrder;
            }
        }
        int hash = 0;
        for (int i = 0; i < 3; i++) hash += scores[i] * PALETTE_COLOR_HASH_MULTIPLIERS[i];
        *ctx = PALETTE_COLOR_CONTEXT[hash];
    }
    void read_color_map(uint8_t map[64][64], int n, int bw, int bh, int onW, int onH, int plane) {
        map[0][0] = (uint8_t)sd.ns(n);
        for (int i = 1; i < onH + onW - 1; i++) {
            for (int j = std::min(i, onW - 1); j >= std::max(0, i - onH + 1); j--) {
                int order[8], ctx;
                color_context(map, i - j, j, n, order, &ctx);
                uint16_t* c = plane ? cdf.palette_uv_color[n - 2][ctx] : cdf.palette_y_color[n - 2][ctx];
                int idx = sd.symbol(c, n);
                map[i - j][j] = (uint8_t)order[idx];
            }
        }
        for (int i = 0; i < onH; i++)
            for (int j = onW; j < bw; j++) map[i][j] = map[i][onW - 1];
        for (int i = onH; i < bh; i++)
            for (int j = 0; j < bw; j++) map[i][j] = map[onH - 1][j];
    }
    void palette_tokens() {
        int bh = kBH[miSize], bw = kBW[miSize];
        int onH = std::min(bh, (miRows - miRow) * 4), onW = std::min(bw, (miCols - miCol) * 4);
        if (paletteSizeY) read_color_map(colorMapY, paletteSizeY, bw, bh, onW, onH, 0);
        if (paletteSizeUV) {
            bh >>= ssy;
            bw >>= ssx;
            onH = std::min(bh, ((miRows - miRow) * 4) >> ssy);
            onW = std::min(bw, ((miCols - miCol) * 4) >> ssx);
            if (bw < 4) { bw += 2; onW += 2; }
            if (bh < 4) { bh += 2; onH += 2; }
            read_color_map(colorMapUV, paletteSizeUV, bw, bh, onW, onH, 1);
        }
    }

    // ---- tx size
    int above_tx_width(int r, int c) {
        if (r == miRow) {
            if (!availU) return 64;
            int32_t* a = m(r - 1, c);
            if (a[M_SKIP] && a[M_INTER]) return kBW[a[M_SIZE]];
        }
        return kTW[txSizes[(size_t)(r - 1) * miCols + c]];
    }
    int left_tx_height(int r, int c) {
        if (c == miCol) {
            if (!availL) return 64;
            int32_t* l = m(r, c - 1);
            if (l[M_SKIP] && l[M_INTER]) return kBH[l[M_SIZE]];
        }
        return kTH[txSizes[(size_t)r * miCols + c - 1]];
    }
    void set_tx_sizes(int r, int c, int w4, int h4, int tx) {
        for (int i = 0; i < h4; i++)
            for (int j = 0; j < w4; j++)
                if (r + i < miRows && c + j < miCols) txSizes[(size_t)(r + i) * miCols + c + j] = (uint8_t)tx;
    }
    void read_var_tx_size(int r, int c, int tx, int depth) {
        if (r >= miRows || c >= miCols) return;
        int split = 0;
        if (tx != T4X4 && depth != 2) {
            int above = above_tx_width(r, c) < kTW[tx];
            int left = left_tx_height(r, c) < kTH[tx];
            int size = std::min(64, std::max(kBW[miSize], kBH[miSize]));
            int maxTx = sqr_index(size);
            int ctx = (tx_sqr_up(tx) != maxTx) * 3 + (5 - 1 - maxTx) * 6 + above + left;
            split = sd.symbol(cdf.txfm_split[ctx], 2);
        }
        int w4 = kTW[tx] >> 2, h4 = kTH[tx] >> 2;
        if (split) {
            int sub = kSplitTx[tx];
            for (int i = 0; i < h4; i += kTH[sub] >> 2)
                for (int j = 0; j < w4; j += kTW[sub] >> 2) read_var_tx_size(r + i, c + j, sub, depth + 1);
        } else {
            set_tx_sizes(r, c, w4, h4, tx);
            txSize = tx;
        }
    }
    void read_block_tx_size() {
        if (hdr[H_TX_MODE] == TX_SELECT && miSize > B4X4 && isInter && !skip && !lossless) {
            int maxTx = kMaxTxRect[miSize];
            for (int r = miRow; r < miRow + bh4; r += kTH[maxTx] >> 2)
                for (int c = miCol; c < miCol + bw4; c += kTW[maxTx] >> 2) read_var_tx_size(r, c, maxTx, 0);
            return;
        }
        read_tx_size(!skip || !isInter);
        set_tx_sizes(miRow, miCol, bw4, bh4, txSize);
    }
    void read_tx_size(int allowSelect) {
        if (lossless) {
            txSize = T4X4;
            return;
        }
        int maxRect = kMaxTxRect[miSize];
        int maxDepth = kMaxTxDepth[miSize];
        txSize = maxRect;
        if (miSize > B4X4 && allowSelect && hdr[H_TX_MODE] == TX_SELECT) {
            int aboveW = 0, leftH = 0;
            if (availU) {
                int32_t* a = m(miRow - 1, miCol);
                aboveW = a[M_INTER] ? kBW[a[M_SIZE]] : above_tx_width(miRow, miCol);
            }
            if (availL) {
                int32_t* l = m(miRow, miCol - 1);
                leftH = l[M_INTER] ? kBH[l[M_SIZE]] : left_tx_height(miRow, miCol);
            }
            int ctx = (aboveW >= kTW[maxRect]) + (leftH >= kTH[maxRect]);
            int depth;
            if (maxDepth == 1) depth = sd.symbol(cdf.tx_8x8[ctx], 2);
            else if (maxDepth == 2) depth = sd.symbol(cdf.tx_16x16[ctx], 3);
            else if (maxDepth == 3) depth = sd.symbol(cdf.tx_32x32[ctx], 3);
            else depth = sd.symbol(cdf.tx_64x64[ctx], 3);
            for (int i = 0; i < depth; i++) txSize = kSplitTx[txSize];
        }
    }

    // ---- intra block copy: the vector stack, the vector and the prediction
    int numMvFound, refStack[8][2], weightStack[8], foundMatch;
    void add_ref_mv(int r, int c, int weight) {
        int32_t* b = m(r, c);
        if (!b[M_INTER]) return;  // a neighbour coded by intra block copy (RefFrame INTRA_FRAME)
        int mv[2] = {b[M_MV_ROW], b[M_MV_COL]};  // integer already (force_integer_mv)
        foundMatch = 1;
        int idx = 0;
        while (idx < numMvFound && !(refStack[idx][0] == mv[0] && refStack[idx][1] == mv[1])) idx++;
        if (idx < numMvFound) {
            weightStack[idx] += weight;
        } else if (numMvFound < 8) {
            refStack[numMvFound][0] = mv[0];
            refStack[numMvFound][1] = mv[1];
            weightStack[numMvFound] = weight;
            numMvFound++;
        }
    }
    void scan_row(int deltaRow) {
        int end4 = std::min(std::min(bw4, miCols - miCol), 16), deltaCol = 0;
        int useStep16 = bw4 >= 16;
        if (std::abs(deltaRow) > 1) {
            deltaRow += miRow & 1;
            deltaCol = 1 - (miCol & 1);
        }
        for (int i = 0; i < end4;) {
            int r = miRow + deltaRow, c = miCol + deltaCol + i;
            if (!inside(r, c)) break;
            int len = std::min(bw4, kBW[m(r, c)[M_SIZE]] >> 2);
            if (std::abs(deltaRow) > 1) len = std::max(2, len);
            if (useStep16) len = std::max(4, len);
            add_ref_mv(r, c, len * 2);
            i += len;
        }
    }
    void scan_col(int deltaCol) {
        int end4 = std::min(std::min(bh4, miRows - miRow), 16), deltaRow = 0;
        int useStep16 = bh4 >= 16;
        if (std::abs(deltaCol) > 1) {
            deltaRow = 1 - (miRow & 1);
            deltaCol += miCol & 1;
        }
        for (int i = 0; i < end4;) {
            int r = miRow + deltaRow + i, c = miCol + deltaCol;
            if (!inside(r, c)) break;
            int len = std::min(bh4, kBH[m(r, c)[M_SIZE]] >> 2);
            if (std::abs(deltaCol) > 1) len = std::max(2, len);
            if (useStep16) len = std::max(4, len);
            add_ref_mv(r, c, len * 2);
            i += len;
        }
    }
    void scan_point(int deltaRow, int deltaCol) {
        int r = miRow + deltaRow, c = miCol + deltaCol;
        if (inside(r, c) && m(r, c)[M_WRITTEN]) add_ref_mv(r, c, 4);
    }
    void sort_stack(int start, int end) {
        while (end > start) {
            int newEnd = start;
            for (int idx = start + 1; idx < end; idx++)
                if (weightStack[idx - 1] < weightStack[idx]) {
                    std::swap(weightStack[idx - 1], weightStack[idx]);
                    std::swap(refStack[idx - 1][0], refStack[idx][0]);
                    std::swap(refStack[idx - 1][1], refStack[idx][1]);
                    newEnd = idx;
                }
            end = newEnd;
        }
    }
    // find_mv_stack for RefFrame INTRA_FRAME: no temporal, global or
    // compound candidates; extra_search adds none (no neighbour refers to
    // another frame) and fills the stack to 2 with the zero global vector
    void find_mv_stack() {
        numMvFound = 0;
        std::memset(refStack, 0, sizeof(refStack));
        foundMatch = 0;
        scan_row(-1);
        foundMatch = 0;
        scan_col(-1);
        foundMatch = 0;
        if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
        int numNearest = numMvFound;
        for (int idx = 0; idx < numNearest; idx++) weightStack[idx] += 640;  // REF_CAT_LEVEL
        scan_point(-1, -1);
        scan_row(-3);
        scan_col(-3);
        if (bh4 > 1) scan_row(-5);
        if (bw4 > 1) scan_col(-5);
        sort_stack(0, numNearest);
        sort_stack(numNearest, numMvFound);
        for (int idx = numMvFound; idx < 2; idx++) refStack[idx][0] = refStack[idx][1] = 0;
        int border = 128;  // MV_BORDER
        for (int idx = 0; idx < numMvFound; idx++) {
            int top = -(miRow * 4 * 8), bottom = (miRows - bh4 - miRow) * 4 * 8;
            int left = -(miCol * 4 * 8), right = (miCols - bw4 - miCol) * 4 * 8;
            refStack[idx][0] = clip3(top - border - bh4 * 4 * 8, bottom + border + bh4 * 4 * 8, refStack[idx][0]);
            refStack[idx][1] = clip3(left - border - bw4 * 4 * 8, right + border + bw4 * 4 * 8, refStack[idx][1]);
        }
    }
    int read_mv_component(int comp) {
        int sign = sd.symbol(cdf.mv_sign[comp], 2);
        int cls = sd.symbol(cdf.mv_class[comp], 11);
        int mag;
        if (cls == 0) {
            int bit = sd.symbol(cdf.mv_class0[comp], 2);
            mag = ((bit << 3) | (3 << 1) | 1) + 1;  // fr 3, hp 1: integer vectors
        } else {
            int d = 0;
            for (int i = 0; i < cls; i++) d |= sd.symbol(cdf.mv_bits[comp][i], 2) << i;
            mag = (2 << (cls + 2)) + ((d << 3) | (3 << 1) | 1) + 1;
        }
        return sign ? -mag : mag;
    }
    void assign_mv() {
        int pred[2] = {refStack[0][0], refStack[0][1]};
        if (pred[0] == 0 && pred[1] == 0) {
            pred[0] = refStack[1][0];
            pred[1] = refStack[1][1];
        }
        if (pred[0] == 0 && pred[1] == 0) {
            int sb4 = use128 ? 32 : 16;
            if (miRow - sb4 < rowStart) {
                pred[0] = 0;
                pred[1] = -(sb4 * 4 + 256) * 8;  // INTRABC_DELAY_PIXELS
            } else {
                pred[0] = -(sb4 * 4 * 8);
                pred[1] = 0;
            }
        }
        int joint = sd.symbol(cdf.mv_joint, 4);
        int diff[2] = {0, 0};
        if (joint == 2 || joint == 3) diff[0] = read_mv_component(0);
        if (joint == 1 || joint == 3) diff[1] = read_mv_component(1);
        mvRow = pred[0] + diff[0];
        mvCol = pred[1] + diff[1];
    }
    // The block copied from the frame decoded so far (BILINEAR at the
    // chroma's half pels; the rounding of a single prediction, InterRound0
    // 3 and InterRound1 11, at 12 bits 5 and 9)
    void predict_intrabc() {
        int round0 = bd == 12 ? 5 : 3, round1 = bd == 12 ? 9 : 11;
        for (int p = 0; p < 1 + hasChroma * 2; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int planeSz = plane_size(miSize, sx, sy);
            int w = kBW[planeSz], h = kBH[planeSz];
            int baseX = (miCol >> sx) * 4, baseY = (miRow >> sy) * 4;
            int64_t startX = ((int64_t)(baseX << 4) + ((2 * mvCol) >> sx)) * 64 + 32;
            int64_t startY = ((int64_t)(baseY << 4) + ((2 * mvRow) >> sy)) * 64 + 32;
            int lastX = ((hdr[H_WIDTH] + sx) >> sx) - 1, lastY = ((hdr[H_HEIGHT] + sy) >> sy) - 1;
            const P* f = plane[p];
            int st = stride[p];
            static int32_t inter[(128 + 8) * 128];
            static P out[128 * 128];
            int ih = h + 7;
            for (int r = 0; r < ih; r++)
                for (int c = 0; c < w; c++) {
                    int64_t pos = startX + 1024 * c;
                    int k = (int)((pos >> 6) & 15);
                    int y = clip3(0, lastY, (int)(startY >> 10) + r - 3);
                    int x0 = clip3(0, lastX, (int)(pos >> 10));
                    int x1 = clip3(0, lastX, (int)(pos >> 10) + 1);
                    int s = (128 - 8 * k) * f[(size_t)y * st + x0] + 8 * k * f[(size_t)y * st + x1];
                    inter[r * w + c] = round2(s, round0);
                }
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++) {
                    int64_t pos = (startY & 1023) + 1024 * r;
                    int k = (int)((pos >> 6) & 15);
                    int row = (int)(pos >> 10) + 3;
                    int s = (128 - 8 * k) * inter[row * w + c] + 8 * k * inter[(row + 1) * w + c];
                    out[r * w + c] = (P)clip1(round2(s, round1), bd);
                }
            P* dst = plane[p] + (size_t)baseY * st + baseX;
            for (int r = 0; r < h; r++) std::memcpy(dst + (size_t)r * st, out + r * w, sizeof(P) * w);
        }
    }

    // ---- coefficients
    int tx_set(int txSz) {
        int sqr = tx_sqr(txSz), up = tx_sqr_up(txSz);
        if (up > 3) return SET_DCTONLY;
        if (isInter) {
            if (hdr[H_REDUCED_TX_SET] || up == 3) return SET_INTER_3;
            if (sqr == 2) return SET_INTER_2;
            return SET_INTER_1;
        }
        if (up == 3) return SET_DCTONLY;
        if (hdr[H_REDUCED_TX_SET]) return SET_INTRA_2;
        if (sqr == 2) return SET_INTRA_2;
        return SET_INTRA_1;
    }
    static bool in_set(int set, int t) {
        switch (set) {
            case SET_DCTONLY: return t == DCT_DCT;
            case SET_INTRA_1: return t == DCT_DCT || t == ADST_DCT || t == DCT_ADST || t == ADST_ADST ||
                                     t == IDTX || t == V_DCT || t == H_DCT;
            case SET_INTRA_2: return t == DCT_DCT || t == ADST_DCT || t == DCT_ADST || t == ADST_ADST ||
                                     t == IDTX;
            case SET_INTER_1: return true;
            case SET_INTER_2: return t != V_ADST && t != H_ADST && t != V_FLIPADST && t != H_FLIPADST;
            default: return t == IDTX || t == DCT_DCT;
        }
    }
    void transform_type(int x4, int y4, int txSz) {
        int set = tx_set(txSz);
        int q = hdr[H_SEG_ENABLED] ? qidx(1, segmentId) : hdr[H_BASE_Q];
        int type = DCT_DCT;
        if (set > 0 && q > 0) {
            static const int kFilterDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
            int dir = useFilterIntra ? kFilterDir[filterIntraMode] : yMode;
            int sqr = tx_sqr(txSz);
            const int32_t(*inv)[16] = TX_TYPE_INV;
            if (set == SET_INTRA_1) type = inv[INV_INTRA_1][sd.symbol(cdf.intra_tx_set1[sqr][dir], 7)];
            else if (set == SET_INTRA_2) type = inv[INV_INTRA_2][sd.symbol(cdf.intra_tx_set2[sqr][dir], 5)];
            else if (set == SET_INTER_1) type = inv[INV_INTER_1][sd.symbol(cdf.inter_tx_set1[sqr], 16)];
            else if (set == SET_INTER_2) type = inv[INV_INTER_2][sd.symbol(cdf.inter_tx_set2[sqr], 12)];
            else type = inv[INV_INTER_3][sd.symbol(cdf.inter_tx_set3[sqr], 2)];
        }
        for (int i = 0; i < (kTW[txSz] >> 2); i++)
            for (int j = 0; j < (kTH[txSz] >> 2); j++)
                if (y4 + j < miRows && x4 + i < miCols) txTypes[(size_t)(y4 + j) * miCols + x4 + i] = (uint8_t)type;
    }
    int compute_tx_type(int plane, int txSz, int x4, int y4) {
        if (lossless || tx_sqr_up(txSz) > 3) return DCT_DCT;
        int set = tx_set(txSz);
        if (plane == 0) return txTypes[(size_t)y4 * miCols + x4];
        int t;
        if (isInter) {
            int lx = std::max(miCol, x4 << ssx), ly = std::max(miRow, y4 << ssy);
            t = txTypes[(size_t)ly * miCols + lx];
        } else {
            t = kModeToTxfm[uvMode];
        }
        return in_set(set, t) ? t : DCT_DCT;
    }
    const int16_t* scan_of(int txSz) {
        static int16_t mrow[19][256], mcol[19][256];
        static bool made = false;
        if (!made) {
            for (int t = 0; t < 19; t++) {
                int w = kTW[t], h = kTH[t];
                if (w > 16 || h > 16) continue;
                int k = 0;
                for (int i = 0; i < h; i++) for (int j = 0; j < w; j++) mrow[t][k++] = (int16_t)(i * w + j);
                k = 0;
                for (int j = 0; j < w; j++) for (int i = 0; i < h; i++) mcol[t][k++] = (int16_t)(i * w + j);
            }
            made = true;
        }
        if (txSz == T16X64) return DEFAULT_SCAN_16X32;
        if (txSz == T64X16) return DEFAULT_SCAN_32X16;
        if (tx_sqr_up(txSz) == 4) return DEFAULT_SCAN_32X32;
        if (planeTxType != IDTX) {
            int cls = tx_class(planeTxType);
            if (cls == CLASS_VERT) return mrow[txSz];
            if (cls == CLASS_HORIZ) return mcol[txSz];
        }
        switch (txSz) {
            case T4X4: return DEFAULT_SCAN_4X4;
            case T8X8: return DEFAULT_SCAN_8X8;
            case T16X16: return DEFAULT_SCAN_16X16;
            case T32X32: return DEFAULT_SCAN_32X32;
            case T4X8: return DEFAULT_SCAN_4X8;
            case T8X4: return DEFAULT_SCAN_8X4;
            case T8X16: return DEFAULT_SCAN_8X16;
            case T16X8: return DEFAULT_SCAN_16X8;
            case T16X32: return DEFAULT_SCAN_16X32;
            case T32X16: return DEFAULT_SCAN_32X16;
            case T4X16: return DEFAULT_SCAN_4X16;
            case T16X4: return DEFAULT_SCAN_16X4;
            case T8X32: return DEFAULT_SCAN_8X32;
            default: return DEFAULT_SCAN_32X8;
        }
    }
    int quant[1024];
    int base_ctx_offset(int txSz, int row, int col) {
        int w = kTW[txSz], h = kTH[txSz];
        static const int sq[5][5] = {{0, 1, 6, 6, 21}, {1, 6, 6, 21, 21}, {6, 6, 21, 21, 21},
                                     {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}};
        static const int wide[5][5] = {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21}, {16, 16, 21, 21, 21},
                                       {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}};
        static const int tall[5][5] = {{0, 11, 11, 11, 11}, {11, 11, 11, 11, 11}, {6, 6, 21, 21, 21},
                                       {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}};
        int r = std::min(row, 4), c = std::min(col, 4);
        if (w == h) return sq[r][c];
        if (w > h) return wide[r][c];
        return tall[r][c];
    }
    int coeff_base_ctx(int txSz, int bwl, int txh, int pos, int c, int isEob) {
        if (isEob) {
            if (c == 0) return 42 - 4;
            if (c <= (txh << bwl) / 8) return 42 - 3;
            if (c <= (txh << bwl) / 4) return 42 - 2;
            return 42 - 1;
        }
        static const int off[3][5][2] = {{{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
                                         {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
                                         {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
        int cls = tx_class(planeTxType);
        int row = pos >> bwl, col = pos - (row << bwl);
        int mag = 0;
        for (int i = 0; i < 5; i++) {
            int rr = row + off[cls][i][0], cc = col + off[cls][i][1];
            if (rr < txh && cc < (1 << bwl)) mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
        }
        int ctx = std::min((mag + 1) >> 1, 4);
        if (cls == CLASS_2D) {
            if (row == 0 && col == 0) return 0;
            return ctx + base_ctx_offset(txSz, row, col);
        }
        int idx = cls == CLASS_VERT ? row : col;
        static const int posOff[3] = {26, 31, 36};
        return ctx + posOff[std::min(idx, 2)];
    }
    int coeff_br_ctx(int bwl, int txh, int pos) {
        static const int off[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}},
                                         {{0, 1}, {1, 0}, {2, 0}}};
        int cls = tx_class(planeTxType);
        int row = pos >> bwl, col = pos - (row << bwl);
        int mag = 0;
        for (int i = 0; i < 3; i++) {
            int rr = row + off[cls][i][0], cc = col + off[cls][i][1];
            if (rr < txh && cc < (1 << bwl)) mag += std::min(quant[(rr << bwl) + cc], 15);
        }
        mag = std::min((mag + 1) >> 1, 6);
        if (pos == 0) return mag;
        if (cls == CLASS_2D) return (row < 2 && col < 2) ? mag + 7 : mag + 14;
        if (cls == CLASS_HORIZ) return col == 0 ? mag + 7 : mag + 14;
        return row == 0 ? mag + 7 : mag + 14;
    }
    int coeffs(int plane, int startX, int startY, int txSz) {
        int x4 = startX >> 2, y4 = startY >> 2, w4 = kTW[txSz] >> 2, h4 = kTH[txSz] >> 2;
        int txSzCtx = (tx_sqr(txSz) + tx_sqr_up(txSz) + 1) >> 1;
        int ptype = plane > 0;
        int segEob = (txSz == T16X64 || txSz == T64X16) ? 512 : std::min(1024, kTW[txSz] * kTH[txSz]);
        for (int c = 0; c < segEob; c++) quant[c] = 0;
        int eob = 0, culLevel = 0, dcCategory = 0;
        int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
        int maxX4 = miCols >> sx, maxY4 = miRows >> sy;
        // all_zero ctx
        int ctx;
        int bsize = plane_size(miSize, sx, sy);
        int w = kTW[txSz], h = kTH[txSz];
        if (plane == 0) {
            int top = 0, left = 0;
            for (int k = 0; k < w4; k++) if (x4 + k < maxX4) top = std::max(top, (int)aboveLevel[0][x4 + k]);
            for (int k = 0; k < h4; k++) if (y4 + k < maxY4) left = std::max(left, (int)leftLevel[0][y4 + k]);
            top = std::min(top, 255);
            left = std::min(left, 255);
            if (kBW[bsize] == w && kBH[bsize] == h) ctx = 0;
            else if (top == 0 && left == 0) ctx = 1;
            else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
            else if (std::max(top, left) <= 3) ctx = 4;
            else if (std::min(top, left) <= 3) ctx = 5;
            else ctx = 6;
        } else {
            int above = 0, left = 0;
            for (int i = 0; i < w4; i++) if (x4 + i < maxX4) above |= aboveLevel[plane][x4 + i] | aboveDc[plane][x4 + i];
            for (int i = 0; i < h4; i++) if (y4 + i < maxY4) left |= leftLevel[plane][y4 + i] | leftDc[plane][y4 + i];
            ctx = (above != 0) + (left != 0) + 7;
            if (kBW[bsize] * kBH[bsize] > w * h) ctx += 3;
        }
        int allZero = sd.symbol(cdf.txb_skip[txSzCtx][ctx], 2);
        if (allZero) {
            if (plane == 0)
                for (int i = 0; i < w4; i++)
                    for (int j = 0; j < h4; j++)
                        if (y4 + j < miRows && x4 + i < miCols) txTypes[(size_t)(y4 + j) * miCols + x4 + i] = DCT_DCT;
        } else {
            if (plane == 0) transform_type(x4, y4, txSz);
            planeTxType = compute_tx_type(plane, txSz, x4, y4);
            const int16_t* scan = scan_of(txSz);
            int eobMultisize = std::min(tx_wlog2(txSz), 5) + std::min(tx_hlog2(txSz), 5) - 4;
            int ectx = tx_class(planeTxType) == CLASS_2D ? 0 : 1;
            int eobPt;
            switch (eobMultisize) {
                case 0: eobPt = sd.symbol(cdf.eob_pt16[ptype][ectx], 5); break;
                case 1: eobPt = sd.symbol(cdf.eob_pt32[ptype][ectx], 6); break;
                case 2: eobPt = sd.symbol(cdf.eob_pt64[ptype][ectx], 7); break;
                case 3: eobPt = sd.symbol(cdf.eob_pt128[ptype][ectx], 8); break;
                case 4: eobPt = sd.symbol(cdf.eob_pt256[ptype][ectx], 9); break;
                case 5: eobPt = sd.symbol(cdf.eob_pt512[ptype][0], 10); break;
                default: eobPt = sd.symbol(cdf.eob_pt1024[ptype][0], 11); break;
            }
            eobPt += 1;
            eob = eobPt < 2 ? eobPt : (1 << (eobPt - 2)) + 1;
            int eobShift = eobPt - 3;
            if (eobShift >= 0) {
                if (sd.symbol(cdf.eob_extra[txSzCtx][ptype][eobPt - 3], 2)) eob += 1 << eobShift;
                for (int i = 1; i < std::max(0, eobPt - 2); i++) {
                    eobShift = std::max(0, eobPt - 2) - 1 - i;
                    if (sd.literal(1)) eob += 1 << eobShift;
                }
            }
            int adj = adjusted_tx(txSz);
            int bwl = tx_wlog2(adj), txh = kTH[adj];
            for (int c = eob - 1; c >= 0; c--) {
                int pos = scan[c];
                int level;
                if (c == eob - 1) {
                    int cctx = coeff_base_ctx(txSz, bwl, txh, pos, c, 1) - 42 + 4;
                    level = sd.symbol(cdf.coeff_base_eob[txSzCtx][ptype][cctx], 3) + 1;
                } else {
                    int cctx = coeff_base_ctx(txSz, bwl, txh, pos, c, 0);
                    level = sd.symbol(cdf.coeff_base[txSzCtx][ptype][cctx], 4);
                }
                if (level > 2) {
                    int bctx = coeff_br_ctx(bwl, txh, pos);
                    for (int idx = 0; idx < 4; idx++) {
                        int br = sd.symbol(cdf.coeff_br[std::min(txSzCtx, 3)][ptype][bctx], 4);
                        level += br;
                        if (br < 3) break;
                    }
                }
                quant[pos] = level;
            }
            for (int c = 0; c < eob; c++) {
                int pos = scan[c];
                int sign = 0;
                if (quant[pos] != 0) {
                    if (c == 0) {
                        int dcSign = 0;
                        for (int k = 0; k < w4; k++)
                            if (x4 + k < maxX4) {
                                int s = aboveDc[plane][x4 + k];
                                if (s == 1) dcSign--;
                                else if (s == 2) dcSign++;
                            }
                        for (int k = 0; k < h4; k++)
                            if (y4 + k < maxY4) {
                                int s = leftDc[plane][y4 + k];
                                if (s == 1) dcSign--;
                                else if (s == 2) dcSign++;
                            }
                        int dctx = dcSign < 0 ? 1 : (dcSign > 0 ? 2 : 0);
                        sign = sd.symbol(cdf.dc_sign[ptype][dctx], 2);
                    } else {
                        sign = sd.literal(1);
                    }
                }
                if (quant[pos] > 14) {
                    int length = 0, bit;
                    do {
                        length++;
                        bit = sd.literal(1);
                        if (length > 20) {
                            err = kGolomb;
                            return 0;
                        }
                    } while (!bit);
                    int x = 1;
                    for (int i = length - 2; i >= 0; i--) x = (x << 1) | sd.literal(1);
                    quant[pos] = x + 14;
                }
                if (pos == 0 && quant[pos] > 0) dcCategory = sign ? 1 : 2;
                quant[pos] &= 0xFFFFF;
                culLevel += quant[pos];
                if (sign) quant[pos] = -quant[pos];
            }
            culLevel = std::min(63, culLevel);
        }
        for (int i = 0; i < w4; i++)
            if (x4 + i < (int)aboveLevel[plane].size()) {
                aboveLevel[plane][x4 + i] = (uint8_t)culLevel;
                aboveDc[plane][x4 + i] = (uint8_t)dcCategory;
            }
        for (int i = 0; i < h4; i++)
            if (y4 + i < (int)leftLevel[plane].size()) {
                leftLevel[plane][y4 + i] = (uint8_t)culLevel;
                leftDc[plane][y4 + i] = (uint8_t)dcCategory;
            }
        return eob;
    }

    // ---- reconstruction
    // Dc_Qlookup and Ac_Qlookup, the row of the bit depth
    int dc_q(int b) const {
        const int16_t* t = bd == 12 ? DC_QLOOKUP_12 : (bd == 10 ? DC_QLOOKUP_10 : DC_QLOOKUP);
        return t[clip3(0, 255, b)];
    }
    int ac_q(int b) const {
        const int16_t* t = bd == 12 ? AC_QLOOKUP_12 : (bd == 10 ? AC_QLOOKUP_10 : AC_QLOOKUP);
        return t[clip3(0, 255, b)];
    }
    void reconstruct(int plane, int x, int y, int txSz) {
        int pels = kTW[txSz] * kTH[txSz];
        int dqShift = (pels > 256) + (pels > 1024);
        int log2W = tx_wlog2(txSz), log2H = tx_hlog2(txSz);
        int w = 1 << log2W, h = 1 << log2H;
        int tw = std::min(32, w), th = std::min(32, h);
        int q0 = qidx(0, segmentId);
        int dcQ, acQ;
        if (plane == 0) { dcQ = dc_q(q0 + hdr[H_DQ_Y_DC]); acQ = ac_q(q0); }
        else if (plane == 1) { dcQ = dc_q(q0 + hdr[H_DQ_U_DC]); acQ = ac_q(q0 + hdr[H_DQ_U_AC]); }
        else { dcQ = dc_q(q0 + hdr[H_DQ_V_DC]); acQ = ac_q(q0 + hdr[H_DQ_V_AC]); }
        static int32_t deq[64 * 64];
        static int32_t res[64 * 64];
        std::memset(deq, 0, sizeof(deq));
        const int64_t dqMax = ((int64_t)1 << (7 + bd)) - 1;
        // the quantiser matrix of the plane's level (15: none; none for the
        // identity and 1D types), at the adjusted size's offset in QM_IWT
        // (sizes in order, 64s reusing 32s)
        int qmLevel = (lossless || !hdr[H_USING_QM] || planeTxType >= IDTX) ? 15 : hdr[H_QM_Y + plane];
        const uint8_t* qm = nullptr;
        if (qmLevel < 15) {
            int off = 0, adj = adjusted_tx(txSz);
            for (int t = 0; t < adj; t++)
                if (adjusted_tx(t) == t) off += kTW[t] * kTH[t];
            qm = QM_IWT[qmLevel][plane > 0] + off;
        }
        for (int i = 0; i < th; i++)
            for (int j = 0; j < tw; j++) {
                int qv = quant[i * tw + j];
                if (!qv) continue;
                int q = (i == 0 && j == 0) ? dcQ : acQ;
                if (qm) q = round2((int64_t)q * qm[i * tw + j], 5);
                int64_t v = ((int64_t)std::abs(qv) * q) & 0xFFFFFF;
                v >>= dqShift;
                if (qv < 0) v = -v;
                deq[i * 64 + j] = (int32_t)std::max<int64_t>(-dqMax - 1, std::min<int64_t>(dqMax, v));
            }
        int nnz = 0;
        for (int i = 0; i < th; i++)
            for (int j = 0; j < tw; j++) nnz += deq[i * 64 + j] != 0;
        TraceRecord tr(g_trace ? 5 + 2 * nnz + w * h : 0);
        tr.put(TRACE_TXFM);
        tr.put(txSz);
        tr.put(planeTxType);
        tr.put(lossless);
        tr.put(nnz);
        for (int i = 0; i < th; i++)
            for (int j = 0; j < tw; j++)
                if (deq[i * 64 + j]) {
                    tr.put(i * 64 + j);
                    tr.put(deq[i * 64 + j]);
                }
        inverse_transform(deq, txSz, planeTxType, lossless, res, bd);
        for (int k = 0; k < w * h; k++) tr.put(res[k]);
        P* p = plane_ptr(plane, x, y);
        int st = stride[plane];
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) p[(size_t)i * st + j] = (P)clip1(p[(size_t)i * st + j] + res[i * w + j], bd);
    }
    P* plane_ptr(int p, int x, int y) { return plane[p] + (size_t)y * stride[p] + x; }

    // ---- intra prediction of one tx block
    int is_smooth(int r, int c, int p) {
        int mode = m(r, c)[p == 0 ? M_YMODE : M_UVMODE];
        return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
    }
    int filter_type(int p) {
        int aboveSmooth = 0, leftSmooth = 0;
        if (p == 0 ? availU : availUC) {
            int r = miRow - 1, c = miCol;
            if (p > 0) {
                if (ssx && !(miCol & 1)) c++;
                if (ssy && (miRow & 1)) r--;
            }
            aboveSmooth = is_smooth(r, c, p);
        }
        if (p == 0 ? availL : availLC) {
            int r = miRow, c = miCol - 1;
            if (p > 0) {
                if (ssx && (miCol & 1)) c--;
                if (ssy && !(miRow & 1)) r++;
            }
            leftSmooth = is_smooth(r, c, p);
        }
        return aboveSmooth || leftSmooth;
    }
    void predict_intra(int p, int x, int y, int haveLeft, int haveAbove, int haveAboveRight,
                       int haveBelowLeft, int mode, int log2W, int log2H) {
        int w = 1 << log2W, h = 1 << log2H;
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int maxX = ((miCols * 4) >> sx) - 1, maxY = ((miRows * 4) >> sy) - 1;
        int aboveBuf[320], leftBuf[320];
        int* above = aboveBuf + 16;
        int* left = leftBuf + 16;
        P* f = plane[p];
        int st = stride[p];
        auto px = [&](int yy, int xx) { return (int)f[(size_t)yy * st + xx]; };
        int base = 1 << (bd - 1);
        for (int i = 0; i < w + h; i++) {
            if (!haveAbove && haveLeft) above[i] = px(y, x - 1);
            else if (!haveAbove && !haveLeft) above[i] = base - 1;
            else {
                int aboveLimit = std::min(maxX, x + (haveAboveRight ? 2 * w : w) - 1);
                above[i] = px(y - 1, std::min(aboveLimit, x + i));
            }
            if (!haveLeft && haveAbove) left[i] = px(y - 1, x);
            else if (!haveLeft && !haveAbove) left[i] = base + 1;
            else {
                int leftLimit = std::min(maxY, y + (haveBelowLeft ? 2 * h : h) - 1);
                left[i] = px(std::min(leftLimit, y + i), x - 1);
            }
        }
        if (haveAbove && haveLeft) above[-1] = px(y - 1, x - 1);
        else if (haveAbove) above[-1] = px(y - 1, x);
        else if (haveLeft) above[-1] = px(y, x - 1);
        else above[-1] = base;
        left[-1] = above[-1];
        PredParams pp;
        pp.mode = mode;
        pp.log2W = log2W;
        pp.log2H = log2H;
        pp.haveLeft = haveLeft;
        pp.haveAbove = haveAbove;
        pp.angleDelta = p == 0 ? angleDeltaY : angleDeltaUV;
        pp.filterType = hdr[H_EDGE_FILTER] ? filter_type(p) : 0;
        pp.edgeFilter = hdr[H_EDGE_FILTER];
        pp.useFilterIntra = p == 0 && useFilterIntra;
        pp.filterIntraMode = filterIntraMode;
        pp.aboveLimit = maxX - x + 1;
        pp.leftLimit = maxY - y + 1;
        P pred[64 * 64];
        int n = w + h + 1;
        TraceRecord tr(g_trace ? 14 + 2 * n + w * h : 0);
        if (tr.ok) {
            const int32_t pv[12] = {pp.mode, pp.log2W, pp.log2H, pp.haveLeft, pp.haveAbove, pp.angleDelta,
                                    pp.filterType, pp.edgeFilter, pp.useFilterIntra, pp.filterIntraMode,
                                    pp.aboveLimit, pp.leftLimit};
            tr.put(TRACE_PREDICT);
            for (int k = 0; k < 12; k++) tr.put(pv[k]);
            tr.put(n);
            for (int k = -1; k < n - 1; k++) tr.put(above[k]);
            for (int k = -1; k < n - 1; k++) tr.put(left[k]);
        }
        predict(pp, above, left, pred, bd);
        for (int k = 0; k < w * h; k++) tr.put(pred[k]);
        for (int i = 0; i < h; i++) std::memcpy(f + (size_t)(y + i) * st + x, pred + i * w, sizeof(P) * w);
    }
    void predict_cfl(int p, int startX, int startY, int txSz) {
        int w = kTW[txSz], h = kTH[txSz];
        int alpha = p == 1 ? cflAlphaU : cflAlphaV;
        static int32_t L[64 * 64];
        int lx0 = startX << ssx, ly0 = startY << ssy;
        int maxLX = ((maxLumaW - lx0) >> ssx) - 1, maxLY = ((maxLumaH - ly0) >> ssy) - 1;
        for (int i = 0; i < h; i++) {
            int lumaY = std::min(i, maxLY);
            for (int j = 0; j < w; j++) {
                int lumaX = std::min(j, maxLX);
                int t = 0;
                for (int dy = 0; dy <= ssy; dy++)
                    for (int dx = 0; dx <= ssx; dx++)
                        t += plane[0][(size_t)(ly0 + (lumaY << ssy) + dy) * stride[0] + lx0 + (lumaX << ssx) + dx];
                L[i * w + j] = t << (3 - ssx - ssy);
            }
        }
        P pred[64 * 64];
        P* f = plane_ptr(p, startX, startY);
        for (int i = 0; i < h; i++) std::memcpy(pred + i * w, f + (size_t)i * stride[p], sizeof(P) * w);
        TraceRecord tr(g_trace ? 4 + 3 * w * h : 0);
        tr.put(TRACE_CFL);
        tr.put(w);
        tr.put(h);
        tr.put(alpha);
        for (int k = 0; k < w * h; k++) tr.put(L[k]);
        for (int k = 0; k < w * h; k++) tr.put(pred[k]);
        cfl_apply(L, w, h, alpha, pred, bd);
        for (int k = 0; k < w * h; k++) tr.put(pred[k]);
        for (int i = 0; i < h; i++) std::memcpy(f + (size_t)i * stride[p], pred + i * w, sizeof(P) * w);
    }
    void predict_palette(int p, int startX, int startY, int x, int y, int txSz) {
        int w = kTW[txSz], h = kTH[txSz];
        const int* pal = paletteColors[p];
        P* f = plane_ptr(p, startX, startY);
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int idx = p == 0 ? colorMapY[y * 4 + i][x * 4 + j] : colorMapUV[y * 4 + i][x * 4 + j];
                f[(size_t)i * stride[p] + j] = (P)pal[idx];
            }
    }
    void transform_block(int p, int baseX, int baseY, int txSz, int x, int y) {
        int startX = baseX + 4 * x, startY = baseY + 4 * y;
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int row = (startY << sy) >> 2, col = (startX << sx) >> 2;
        int sbMask = use128 ? 31 : 15;
        int subRow = row & sbMask, subCol = col & sbMask;
        int stepX = kTW[txSz] >> 2, stepY = kTH[txSz] >> 2;
        int maxX = (miCols * 4) >> sx, maxY = (miRows * 4) >> sy;
        if (startX >= maxX || startY >= maxY) return;
        if (isInter) {
            // predicted whole by predict_intrabc
        } else if (paletteSizeY && p == 0) {
            predict_palette(p, startX, startY, x, y, txSz);
        } else if (paletteSizeUV && p != 0) {
            predict_palette(p, startX, startY, x, y, txSz);
        } else {
            int isCfl = p > 0 && uvMode == UV_CFL_PRED;
            int mode = p == 0 ? yMode : (isCfl ? DC_PRED : uvMode);
            int bdR = (subRow >> sy), bdC = (subCol >> sx);
            predict_intra(p, startX, startY, (p == 0 ? availL : availLC) || x > 0,
                          (p == 0 ? availU : availUC) || y > 0,
                          blockDecoded[p][bdR - 1 + 1][bdC + stepX + 1],
                          blockDecoded[p][bdR + stepY + 1][bdC - 1 + 1], mode, tx_wlog2(txSz),
                          tx_hlog2(txSz));
            if (isCfl) predict_cfl(p, startX, startY, txSz);
        }
        if (p == 0 && !isInter) {
            maxLumaW = startX + stepX * 4;
            maxLumaH = startY + stepY * 4;
        }
        if (!skip) {
            int eob = coeffs(p, startX, startY, txSz);
            if (err) return;
            if (eob > 0) reconstruct(p, startX, startY, txSz);
        }
        for (int i = 0; i < stepY; i++)
            for (int j = 0; j < stepX; j++) {
                int rr = (row >> sy) + i, cc = (col >> sx) + j;
                int mr = rr << sy, mc = cc << sx;  // the MI holding this plane 4x4
                if (mr < miRows && mc < miCols) m(mr, mc)[p == 0 ? M_TX_Y : M_TX_UV] = txSz;
                int br = (subRow >> sy) + i + 1, bc = (subCol >> sx) + j + 1;
                if (br < 35 && bc < 35) blockDecoded[p][br][bc] = 1;
            }
    }
    int get_tx_size(int p, int txSz) {
        if (p == 0) return txSz;
        int uvTx = kMaxTxRect[plane_size(miSize, ssx, ssy)];
        if (kTW[uvTx] == 64 || kTH[uvTx] == 64) {
            if (kTW[uvTx] == 16) return T16X32;
            if (kTH[uvTx] == 16) return T32X16;
            return T32X32;
        }
        return uvTx;
    }
    void residual() {
        int widthChunks = std::max(1, kBW[miSize] >> 6), heightChunks = std::max(1, kBH[miSize] >> 6);
        for (int cy = 0; cy < heightChunks; cy++)
            for (int cx = 0; cx < widthChunks; cx++) {
                for (int p = 0; p < 1 + hasChroma * 2; p++) {
                    int txSz = lossless ? T4X4 : get_tx_size(p, txSize);
                    int stepX = kTW[txSz] >> 2, stepY = kTH[txSz] >> 2;
                    int sx = p ? ssx : 0, sy = p ? ssy : 0;
                    int planeSz = plane_size(miSize, sx, sy);
                    int num4W = kBW[planeSz] >> 2, num4H = kBH[planeSz] >> 2;
                    int baseX = (miCol >> sx) * 4, baseY = (miRow >> sy) * 4;
                    if (isInter && !lossless && p == 0) {
                        transform_tree(baseX + (cx << 6), baseY + (cy << 6), std::min(64, num4W * 4),
                                       std::min(64, num4H * 4));
                        if (err) return;
                        continue;
                    }
                    for (int y = 0; y < std::min(num4H, 16 >> sy); y += stepY)
                        for (int x = 0; x < std::min(num4W, 16 >> sx); x += stepX) {
                            transform_block(p, baseX, baseY, txSz, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
                            if (err) return;
                        }
                }
            }
    }
    int find_tx_size(int w, int h) {
        for (int t = 0; t < 19; t++) if (kTW[t] == w && kTH[t] == h) return t;
        return -1;
    }
    void transform_tree(int startX, int startY, int w, int h) {
        if (startX >= miCols * 4 || startY >= miRows * 4) return;
        int tx = txSizes[(size_t)(startY >> 2) * miCols + (startX >> 2)];
        if (find_tx_size(w, h) == tx) {
            transform_block(0, startX, startY, tx, 0, 0);
        } else if (w > h) {
            transform_tree(startX, startY, w / 2, h);
            transform_tree(startX + w / 2, startY, w / 2, h);
        } else if (w < h) {
            transform_tree(startX, startY, w, h / 2);
            transform_tree(startX, startY + h / 2, w, h / 2);
        } else {
            transform_tree(startX, startY, w / 2, h / 2);
            transform_tree(startX + w / 2, startY, w / 2, h / 2);
            transform_tree(startX, startY + h / 2, w / 2, h / 2);
            transform_tree(startX + w / 2, startY + h / 2, w / 2, h / 2);
        }
    }
    void reset_block_context() {
        for (int p = 0; p < 1 + 2 * hasChroma; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            for (int i = miCol >> sx; i < ((miCol + bw4) >> sx); i++)
                if (i < (int)aboveLevel[p].size()) aboveLevel[p][i] = aboveDc[p][i] = 0;
            for (int i = miRow >> sy; i < ((miRow + bh4) >> sy); i++)
                if (i < (int)leftLevel[p].size()) leftLevel[p][i] = leftDc[p][i] = 0;
        }
    }
    void decode_block(int r, int c, int subSize) {
        if (err) return;
        miRow = r;
        miCol = c;
        miSize = subSize;
        bw4 = kBW[subSize] >> 2;
        bh4 = kBH[subSize] >> 2;
        if (bh4 == 1 && ssy && (miRow & 1) == 0) hasChroma = 0;
        else if (bw4 == 1 && ssx && (miCol & 1) == 0) hasChroma = 0;
        else hasChroma = numPlanes > 1;
        availU = inside(r - 1, c);
        availL = inside(r, c - 1);
        availUC = availU;
        availLC = availL;
        if (hasChroma) {
            if (ssy && bh4 == 1) availUC = inside(r - 2, c);
            if (ssx && bw4 == 1) availLC = inside(r, c - 2);
        } else {
            availUC = availLC = 0;
        }
        intra_frame_mode_info();
        if (err) return;
        palette_tokens();
        read_block_tx_size();
        if (skip) reset_block_context();
        for (int y = 0; y < bh4; y++)
            for (int x = 0; x < bw4; x++) {
                int rr = r + y, cc = c + x;
                if (rr >= miRows || cc >= miCols) continue;
                int32_t* b = m(rr, cc);
                b[M_SIZE] = miSize;
                b[M_SKIP] = skip;
                b[M_SEG] = segmentId;
                b[M_YMODE] = yMode;
                b[M_UVMODE] = uvMode;
                b[M_INTER] = isInter;
                b[M_MV_ROW] = isInter ? mvRow : 0;
                b[M_MV_COL] = isInter ? mvCol : 0;
                b[M_WRITTEN] = 1;
                for (int k = 0; k < 4; k++) b[M_DLF0 + k] = deltaLF[k];
                size_t i = (size_t)rr * miCols + cc;
                palSize[0][i] = (uint8_t)paletteSizeY;
                palSize[1][i] = (uint8_t)paletteSizeUV;
                for (int k = 0; k < 8; k++) {
                    palColors[0][i * 8 + k] = (uint16_t)(k < paletteSizeY ? paletteColors[0][k] : 0);
                    palColors[1][i * 8 + k] = (uint16_t)(k < paletteSizeUV ? paletteColors[1][k] : 0);
                }
            }
        if (isInter) predict_intrabc();
        residual();
    }

    int run(const uint8_t* data, int64_t size) {
        miCols = hdr[H_MI_COLS];
        miRows = hdr[H_MI_ROWS];
        rowStart = hdr[H_ROW_START];
        rowEnd = hdr[H_ROW_END];
        colStart = hdr[H_COL_START];
        colEnd = hdr[H_COL_END];
        mono = hdr[H_MONO];
        numPlanes = mono ? 1 : 3;
        ssx = hdr[H_SSX];
        ssy = hdr[H_SSY];
        bd = hdr[H_BITDEPTH];
        trace_depth(bd);
        use128 = hdr[H_USE128];
        sbSize4 = use128 ? 32 : 16;
        size_t n = (size_t)miRows * miCols;
        for (int p = 0; p < 2; p++) {
            palSize[p].assign(n, 0);
            palColors[p].assign(n * 8, 0);
        }
        txTypes.assign(n, 0);
        txSizes.assign(n, 0);
        for (int p = 0; p < 3; p++) {
            aboveLevel[p].assign(miCols + 32, 0);
            aboveDc[p].assign(miCols + 32, 0);
            leftLevel[p].assign(miRows + 32, 0);
            leftDc[p].assign(miRows + 32, 0);
        }
        init_cdfs(cdf, hdr[H_BASE_Q]);
        sd.init(data, size, hdr[H_DISABLE_CDF_UPDATE]);
        currentQ = hdr[H_BASE_Q];
        for (int i = 0; i < 4; i++) deltaLF[i] = 0;
        for (int p = 0; p < 3; p++)
            for (int pass = 0; pass < 2; pass++) {
                refSgrXqd[p][pass] = SGRPROJ_XQD_MID[pass];
                for (int i = 0; i < 3; i++) refLrWiener[p][pass][i] = WIENER_TAPS_MID[i];
            }
        int sbBlock = use128 ? B128X128 : B64X64;
        for (int r = rowStart; r < rowEnd; r += sbSize4) {
            for (int p = 0; p < 3; p++) {
                std::fill(leftLevel[p].begin(), leftLevel[p].end(), 0);
                std::fill(leftDc[p].begin(), leftDc[p].end(), 0);
            }
            for (int c = colStart; c < colEnd; c += sbSize4) {
                readDeltas = hdr[H_DELTA_Q_PRESENT];
                set_cdef(r, c, sbSize4, sbSize4, -1);  // clear_cdef
                clear_block_decoded(r, c);
                read_lr(r, c);
                decode_partition(r, c, sbBlock);
                if (err) return err;
            }
        }
        return 0;
    }
};

// ---------------------------------------------------------------- deblock ---

template <typename P>
struct Deblock {
    int ssx, ssy, bd;
    const int32_t* hdr;
    int miCols, miRows, numPlanes, width, height;
    P* plane[3];
    int stride[3];
    const int32_t* mi;

    const int32_t* m(int r, int c) const { return mi + ((size_t)r * miCols + c) * M_FIELDS; }

    void strength(int row, int col, int p, int pass, int* lvl, int* limit, int* blimit, int* thresh) const {
        const int32_t* b = m(row, col);
        int segment = b[M_SEG];
        int deltaLF = hdr[H_DELTA_LF_MULTI] ? b[M_DLF0 + (p == 0 ? pass : p + 1)] : b[M_DLF0];
        int i = p == 0 ? pass : p + 1;
        int base = clip3(0, 63, deltaLF + hdr[H_LF_LEVEL0 + i]);
        int l = base;
        int feature = 1 + i;
        if (hdr[H_SEG_ENABLED] && hdr[H_FEATURE_ENABLED + segment * 8 + feature]) {
            l = clip3(0, 63, hdr[H_FEATURE_DATA + segment * 8 + feature] + l);
        }
        if (hdr[H_LF_DELTA_ENABLED]) {
            int nShift = l >> 5;
            l = l + (hdr[H_REF_DELTAS + 0] * (1 << nShift));  // every block of a key frame is intra
            l = clip3(0, 63, l);
        }
        int sharp = hdr[H_SHARPNESS];
        int shift = sharp > 4 ? 2 : (sharp > 0 ? 1 : 0);
        int lim = sharp > 0 ? clip3(1, 9 - sharp, l >> shift) : std::max(1, l >> shift);
        *lvl = l;
        *limit = lim;
        *blimit = 2 * (l + 2) + lim;
        *thresh = l >> 4;
    }

    void edge(int p, int pass, int row, int col) {
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int dx = pass == 0 ? 1 : 0, dy = pass == 1 ? 1 : 0;
        int x = col * 4, y = row * 4;
        row |= sy;
        col |= sx;
        int onScreen;
        if (x >= width) onScreen = 0;
        else if (y >= height) onScreen = 0;
        else if (pass == 0 && x == 0) onScreen = 0;
        else if (pass == 1 && y == 0) onScreen = 0;
        else onScreen = 1;
        if (!onScreen) return;
        int xP = x >> sx, yP = y >> sy;
        int prevRow = row - (dy << sy), prevCol = col - (dx << sx);
        int txSz = m((row >> sy) << sy, (col >> sx) << sx)[p == 0 ? M_TX_Y : M_TX_UV];
        int prevTx = m((prevRow >> sy) << sy, (prevCol >> sx) << sx)[p == 0 ? M_TX_Y : M_TX_UV];
        // every block of a key frame is intra: each transform edge is filtered
        int applyFilter = pass == 0 ? (xP % kTW[txSz] == 0) : (yP % kTH[txSz] == 0);
        int baseSize = pass == 0 ? std::min(kTW[prevTx], kTW[txSz]) : std::min(kTH[prevTx], kTH[txSz]);
        int filterSize = p == 0 ? std::min(16, baseSize) : std::min(8, baseSize);
        int lvl, limit, blimit, thresh;
        strength(row, col, p, pass, &lvl, &limit, &blimit, &thresh);
        if (lvl == 0) strength(prevRow, prevCol, p, pass, &lvl, &limit, &blimit, &thresh);
        if (!applyFilter || lvl == 0) return;
        LfParams lp{filterSize, p, limit, blimit, thresh};
        P* f = plane[p];
        int st = stride[p], ph = (miRows * 4) >> sy;
        for (int i = 0; i < 4; i++) {
            int xx = xP + dy * i, yy = yP + dx * i;
            int s[16];
            int pw = (miCols * 4) >> sx;
            auto ok = [&](int px, int py) { return px >= 0 && py >= 0 && px < pw && py < ph; };
            for (int k = -8; k < 8; k++) {
                int px = xx + dx * k, py = yy + dy * k;
                s[k + 8] = ok(px, py) ? f[(size_t)py * st + px] : 0;
            }
            TraceRecord tr(g_trace ? 38 : 0);
            tr.put(TRACE_LF);
            tr.put(lp.filterSize);
            tr.put(lp.plane);
            tr.put(lp.limit);
            tr.put(lp.blimit);
            tr.put(lp.thresh);
            for (int k = 0; k < 16; k++) tr.put(s[k]);
            lf_sample(s + 8, lp, bd);
            for (int k = 0; k < 16; k++) tr.put(s[k]);
            for (int k = -7; k < 7; k++) {
                int px = xx + dx * k, py = yy + dy * k;
                if (ok(px, py)) f[(size_t)py * st + px] = (P)s[k + 8];
            }
        }
    }

    void run() {
        if (!hdr[H_LF_LEVEL0] && !hdr[H_LF_LEVEL0 + 1]) return;
        trace_depth(bd);
        for (int p = 0; p < numPlanes; p++) {
            if (p == 1 && !hdr[H_LF_LEVEL0 + 2]) continue;
            if (p == 2 && !hdr[H_LF_LEVEL0 + 3]) continue;
            for (int pass = 0; pass < 2; pass++) {
                int rowStep = p == 0 ? 1 : (1 << ssy), colStep = p == 0 ? 1 : (1 << ssx);
                for (int row = 0; row < miRows; row += rowStep)
                    for (int col = 0; col < miCols; col += colStep) edge(p, pass, row, col);
            }
        }
    }
};

// ------------------------------------------------------------------- CDEF ---

// The direction search of one 8x8 (specification 7.15.2) on its samples
// `b` (row stride `st`, bd bits, searched at 8): the best of the 8
// directions and the variance.
int cdef_direction(const int* b, int st, int* var, int bd) {
    int cost[8] = {0}, partial[8][15] = {{0}};
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
            int x = (b[i * st + j] >> (bd - 8)) - 128;
            partial[0][i + j] += x;
            partial[1][i + j / 2] += x;
            partial[2][i] += x;
            partial[3][3 + i - j / 2] += x;
            partial[4][7 + i - j] += x;
            partial[5][3 - i / 2 + j] += x;
            partial[6][j] += x;
            partial[7][i / 2 + j] += x;
        }
    for (int i = 0; i < 8; i++) {
        cost[2] += partial[2][i] * partial[2][i];
        cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= CDEF_DIV_TABLE[8];
    cost[6] *= CDEF_DIV_TABLE[8];
    for (int i = 0; i < 7; i++) {
        cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * CDEF_DIV_TABLE[i + 1];
        cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * CDEF_DIV_TABLE[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * CDEF_DIV_TABLE[8];
    cost[4] += partial[4][7] * partial[4][7] * CDEF_DIV_TABLE[8];
    for (int i = 1; i < 8; i += 2) {
        for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
        cost[i] *= CDEF_DIV_TABLE[8];
        for (int j = 0; j < 3; j++)
            cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * CDEF_DIV_TABLE[2 * j + 2];
    }
    int best = 0, dir = 0;
    for (int d = 0; d < 8; d++)
        if (cost[d] > best) {
            best = cost[d];
            dir = d;
        }
    *var = (best - cost[(dir + 4) & 7]) >> 10;
    return dir;
}

// constrain() of 7.15.3 with its damping shift max(0, damping -
// FloorLog2(threshold)) computed once a block
inline int cdef_constrain(int diff, int threshold, int shift) {
    int a = std::abs(diff);
    int val = std::min(a, std::max(0, threshold - (a >> shift)));
    return diff < 0 ? -val : val;
}

// The CDEF filter (7.15.3) of a w x h block from its window `win`: (h + 4)
// rows of w + 4 samples, the block at (2, 2), -1 where a sample lies
// outside the frame (CdefAvailable 0); `out` gets w * h. The strengths and
// damping are the bit depth's (shifted by coeffShift = bd - 8), and the
// taps follow the primary strength at 8 bits.
template <typename P>
void cdef_filter(const int* win, int w, int h, int pri, int sec, int damping, int dir, P* out, int bd) {
    int ws = w + 4;
    const int16_t* pt = CDEF_PRI_TAPS[(pri >> (bd - 8)) & 1];
    const int16_t* st = CDEF_SEC_TAPS[(pri >> (bd - 8)) & 1];
    int priShift = pri ? std::max(0, damping - floorlog2(pri)) : 0;
    int secShift = sec ? std::max(0, damping - floorlog2(sec)) : 0;
    // the window offsets of the primary taps (k = 0, 1) and of the
    // secondary ones (directions dir - 2 and dir + 2), one side each
    int po[2], so[2][2];
    for (int k = 0; k < 2; k++) {
        po[k] = CDEF_DIRECTIONS[dir][k][0] * ws + CDEF_DIRECTIONS[dir][k][1];
        for (int e = 0; e < 2; e++) {
            int d2 = (dir + (e ? 2 : -2)) & 7;
            so[k][e] = CDEF_DIRECTIONS[d2][k][0] * ws + CDEF_DIRECTIONS[d2][k][1];
        }
    }
    // A group of taps of strength 0 adds nothing, and leaving its samples
    // out of the clamp changes nothing: each group's taps weigh 12 / 16 in
    // all, so the other group moves x no further than its own samples.
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            const int* c = win + (i + 2) * ws + j + 2;
            int x = *c;
            int sum = 0, mx = x, mn = x;
            for (int k = 0; k < 2; k++)
                for (int sign = -1; sign <= 1; sign += 2) {
                    int p = c[sign * po[k]];
                    if (pri && p >= 0) {
                        sum += pt[k] * cdef_constrain(p - x, pri, priShift);
                        mx = std::max(p, mx);
                        mn = std::min(p, mn);
                    }
                    for (int e = 0; sec && e < 2; e++) {
                        int q = c[sign * so[k][e]];
                        if (q >= 0) {
                            sum += st[k] * cdef_constrain(q - x, sec, secShift);
                            mx = std::max(q, mx);
                            mn = std::min(q, mn);
                        }
                    }
                }
            out[i * w + j] = (P)clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
        }
}

// One block's CDEF (7.15.1) from its window: the strengths and damping as
// the header gives them (damping one less for chroma), shifted by bd - 8;
// luma turns its primary strength off with the direction where it is 0 and
// adjusts it by the variance; chroma maps the luma direction yDir through
// Cdef_Uv_Dir by its subsampling, which the block's size gives (8 >> ssx
// wide, 8 >> ssy tall; the identity for 4:2:0 and 4:4:4). Returns the
// direction used.
template <typename P>
int cdef_apply(const int* win, int w, int h, int plane, int pri, int sec, int damping, int yDir, int var,
               P* out, int bd) {
    int dir, coeffShift = bd - 8;
    pri <<= coeffShift;
    sec <<= coeffShift;
    damping += coeffShift;
    if (plane == 0) {
        dir = pri ? yDir : 0;
        int varStr = (var >> 6) ? std::min(floorlog2(var >> 6), 12) : 0;
        pri = var ? (pri * (4 + varStr) + 8) >> 4 : 0;
    } else {
        dir = pri ? CDEF_UV_DIR[w == 4][h == 4][yDir] : 0;
    }
    cdef_filter(win, w, h, pri, sec, damping, dir, out, bd);
    return dir;
}

template <typename P>
struct Cdef {
    const int32_t* hdr;
    int miCols, miRows, numPlanes, ssx, ssy, bd;
    const P* src[3];
    P* dst[3];
    int stride[3];
    const int32_t* mi;
    const int32_t* idx;

    int skip(int r, int c) const { return mi[((size_t)r * miCols + c) * M_FIELDS + M_SKIP]; }

    // the window of the 8x8's plane-p block at MI (r, c)
    void window(int p, int r, int c, int* win) const {
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int w = 8 >> sx, h = 8 >> sy;
        int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy;
        bool inside = y0 >= 2 && x0 >= 2 && ((y0 + h + 2) << sy) <= miRows * 4 &&
                      ((x0 + w + 2) << sx) <= miCols * 4;
        for (int i = -2; i < h + 2; i++)
            for (int j = -2; j < w + 2; j++) {
                int y = y0 + i, x = x0 + j;
                bool in = inside || (y >= 0 && x >= 0 && (y << sy) < miRows * 4 && (x << sx) < miCols * 4);
                win[(i + 2) * (w + 4) + j + 2] = in ? src[p][(size_t)y * stride[p] + x] : -1;
            }
    }

    // one plane's filtered block into dst, traced: for luma `pri` is the
    // strength before the variance adjustment and yDir / var the search's
    void filter(int p, int r, int c, int pri, int sec, int damping, int yDir, int var) {
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int w = 8 >> sx, h = 8 >> sy;
        int win[12 * 12];
        P out[64];
        window(p, r, c, win);
        int dir = cdef_apply(win, w, h, p, pri, sec, damping, yDir, var, out, bd);
        int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy;
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) dst[p][(size_t)(y0 + i) * stride[p] + x0 + j] = out[i * w + j];
        int n = (w + 4) * (h + 4);
        TraceRecord tr(g_trace ? 10 + n + w * h : 0);
        tr.put(TRACE_CDEF);
        tr.put(p);
        tr.put(w);
        tr.put(h);
        tr.put(pri);
        tr.put(sec);
        tr.put(damping);
        tr.put(p ? yDir : -1);
        for (int k = 0; k < n; k++) tr.put(win[k]);
        tr.put(p ? dir : yDir);
        tr.put(p ? 0 : var);
        for (int k = 0; k < w * h; k++) tr.put(out[k]);
    }

    void run() {
        trace_depth(bd);
        int cols = (miCols + 15) >> 4;
        for (int r = 0; r < miRows; r += 2)
            for (int c = 0; c < miCols; c += 2) {
                int id = idx[(r >> 4) * cols + (c >> 4)];
                if (id == -1) continue;
                if (skip(r, c) && skip(r + 1, c) && skip(r, c + 1) && skip(r + 1, c + 1)) continue;
                int yPri = hdr[H_CDEF_Y_PRI + id], ySec = hdr[H_CDEF_Y_SEC + id];
                int uvPri = hdr[H_CDEF_UV_PRI + id], uvSec = hdr[H_CDEF_UV_SEC + id];
                int damping = hdr[H_CDEF_DAMPING];
                int var = 0, yDir = 0;
                if (yPri || ySec || (numPlanes > 1 && (uvPri || uvSec))) {
                    int b[64];
                    for (int i = 0; i < 8; i++)
                        for (int j = 0; j < 8; j++) b[i * 8 + j] = src[0][(size_t)(r * 4 + i) * stride[0] + c * 4 + j];
                    yDir = cdef_direction(b, 8, &var, bd);
                }
                if (yPri || ySec) filter(0, r, c, yPri, ySec, damping, yDir, var);
                if (numPlanes > 1 && (uvPri || uvSec))
                    for (int p = 1; p < 3; p++) filter(p, r, c, uvPri, uvSec, damping - 1, yDir, 0);
            }
    }
};

// ------------------------------------------------------- loop restoration ---

// The Wiener filter (7.17.4) of a w x h block from its window `win`: (h + 6)
// rows of w + 6 samples, the block at (3, 3); the vertical and horizontal
// taps 0-2 (tap 3 is 128 less twice their sum); the rounding of the bit
// depth bd (InterRound0 3, InterRound1 11; 5 and 9 at 12 bits) with the
// intermediate clipped.
template <typename P>
void wiener_filter(const int* win, int w, int h, const int* vtaps, const int* htaps, P* out, int bd) {
    int vf[7], hf[7];
    vf[3] = hf[3] = 128;
    for (int i = 0; i < 3; i++) {
        vf[i] = vf[6 - i] = vtaps[i];
        hf[i] = hf[6 - i] = htaps[i];
        vf[3] -= 2 * vtaps[i];
        hf[3] -= 2 * htaps[i];
    }
    const int round0 = bd == 12 ? 5 : 3, round1 = bd == 12 ? 9 : 11;
    const int offset = 1 << (bd + 7 - round0 - 1), limit = (1 << (bd + 1 + 7 - round0)) - 1;
    int ws = w + 6;
    std::vector<int> mid((size_t)(h + 6) * w);
    for (int r = 0; r < h + 6; r++)
        for (int c = 0; c < w; c++) {
            int s = 0;
            for (int t = 0; t < 7; t++) s += hf[t] * win[r * ws + c + t];
            mid[(size_t)r * w + c] = clip3(-offset, limit - offset, round2(s, round0));
        }
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int s = 0;
            for (int t = 0; t < 7; t++) s += vf[t] * mid[(size_t)(r + t) * w + c];
            out[r * w + c] = (P)clip1(round2(s, round1), bd);
        }
}

// One box filter pass (7.17.3) of the self-guided filter: F (h x w) from the
// window (as wiener_filter's) with radius r and scale s; the variance is
// taken at 8 bits (the sums rounded by bd - 8 and twice that).
void sgr_box(const int* win, int w, int h, int r, int s, int pass, std::vector<int>& F, int bd) {
    int ws = w + 6, n = (2 * r + 1) * (2 * r + 1);
    int aw = w + 2;
    std::vector<int> A((size_t)(h + 2) * aw), B((size_t)(h + 2) * aw);
    int oneOverN = ONE_BY_X[n - 1];
    for (int i = -1; i < h + 1; i++)
        for (int j = -1; j < w + 1; j++) {
            int64_t a = 0, b = 0;
            for (int dy = -r; dy <= r; dy++)
                for (int dx = -r; dx <= r; dx++) {
                    int c = win[(i + 3 + dy) * ws + j + 3 + dx];
                    a += c * c;
                    b += c;
                }
            int64_t a8 = bd == 8 ? a : (a + ((int64_t)1 << (2 * (bd - 8) - 1))) >> (2 * (bd - 8));
            int64_t d8 = bd == 8 ? b : (b + ((int64_t)1 << (bd - 9))) >> (bd - 8);
            int64_t p = std::max<int64_t>(0, a8 * n - d8 * d8);
            int64_t z = (p * s + (1 << 19)) >> 20;
            int a2 = X_BY_XPLUS1[std::min<int64_t>(z, 255)];
            int64_t b2 = (int64_t)((1 << 8) - a2) * b * oneOverN;
            A[(size_t)(i + 1) * aw + j + 1] = a2;
            B[(size_t)(i + 1) * aw + j + 1] = (int)((b2 + (1 << 11)) >> 12);
        }
    F.assign((size_t)h * w, 0);
    for (int i = 0; i < h; i++) {
        int shift = (pass == 0 && (i & 1)) ? 4 : 5;
        for (int j = 0; j < w; j++) {
            int64_t a = 0, b = 0;
            for (int dy = -1; dy <= 1; dy++)
                for (int dx = -1; dx <= 1; dx++) {
                    int weight;
                    if (pass == 0) weight = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                    else weight = (dx == 0 || dy == 0) ? 4 : 3;
                    a += weight * A[(size_t)(i + 1 + dy) * aw + j + 1 + dx];
                    b += weight * B[(size_t)(i + 1 + dy) * aw + j + 1 + dx];
                }
            int64_t v = a * win[(i + 3) * ws + j + 3] + b;
            F[(size_t)i * w + j] = round2(v, 8 + shift - 4);
        }
    }
}

// The self-guided filter (7.17.3) of a w x h block from its window: the
// set's two box passes (a radius of 0 leaves one out) and the projection
// with weights xqd.
template <typename P>
void sgr_filter(const int* win, int w, int h, int set, const int* xqd, P* out, int bd) {
    std::vector<int> f0, f1;
    int r0 = SGR_PARAMS[set][0], r1 = SGR_PARAMS[set][1];
    if (r0) sgr_box(win, w, h, r0, SGR_PARAMS[set][2], 0, f0, bd);
    if (r1) sgr_box(win, w, h, r1, SGR_PARAMS[set][3], 1, f1, bd);
    int w0 = xqd[0], w1 = xqd[1], w2 = (1 << 7) - w0 - w1;
    int ws = w + 6;
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int u = win[(i + 3) * ws + j + 3] << 4;
            int64_t v = (int64_t)w1 * u;
            v += (int64_t)w0 * (r0 ? f0[(size_t)i * w + j] : u);
            v += (int64_t)w2 * (r1 ? f1[(size_t)i * w + j] : u);
            out[i * w + j] = (P)clip1(round2(v, 4 + 7), bd);
        }
}

template <typename P>
struct Restoration {
    const int32_t* hdr;
    int numPlanes, width, height, ssx, ssy, bd;
    const P* pre[3];   // deblocked, before CDEF
    const P* cdef[3];  // CDEF's output
    P* dst[3];
    int stride[3];
    const int32_t* units;

    void run() {
        trace_depth(bd);
        for (int p = 0; p < numPlanes; p++) {
            if (hdr[H_LR_TYPE + p] == RESTORE_NONE) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int unitSize = hdr[H_LR_SIZE + p], unitRows = hdr[H_LR_ROWS + p], unitCols = hdr[H_LR_COLS + p];
            int planeW = (width + sx) >> sx, planeH = (height + sy) >> sy;
            for (int k = 0;; k++) {
                // stripes of 64 luma rows, the first 8 short
                int stripeStart = k ? (64 * k - 8) >> sy : -(8 >> sy);
                if (stripeStart > planeH - 1) break;
                int stripeEnd = stripeStart + (64 >> sy) - 1;
                int y0 = std::max(0, stripeStart), y1 = std::min(planeH - 1, stripeEnd);
                int unitRow = std::min(unitRows - 1, ((64 * k) >> sy) / unitSize);
                for (int uc = 0; uc < unitCols; uc++) {
                    int x0 = uc * unitSize, x1 = uc == unitCols - 1 ? planeW : std::min(planeW, x0 + unitSize);
                    const int32_t* u = units + ((size_t)p * hdr[H_LR_STRIDE] + (size_t)unitRow * unitCols + uc) * L_FIELDS;
                    if (u[L_TYPE] == RESTORE_NONE || x0 >= x1) continue;
                    block(p, u, x0, y0, x1 - x0, y1 - y0 + 1, stripeStart, stripeEnd, planeW, planeH);
                }
            }
        }
    }

    // get_source_sample of 7.17.6: clamped to the plane, rows past the stripe
    // (at most 2) from the deblocked frame, the rest from CDEF's output
    int sample(int p, int x, int y, int stripeStart, int stripeEnd, int planeW, int planeH) const {
        x = clip3(0, planeW - 1, x);
        y = clip3(0, planeH - 1, y);
        if (y < stripeStart) return pre[p][(size_t)std::max(stripeStart - 2, y) * stride[p] + x];
        if (y > stripeEnd) return pre[p][(size_t)std::min(stripeEnd + 2, y) * stride[p] + x];
        return cdef[p][(size_t)y * stride[p] + x];
    }

    void block(int p, const int32_t* u, int x0, int y0, int w, int h, int stripeStart, int stripeEnd, int planeW,
               int planeH) {
        int ws = w + 6, n = ws * (h + 6);
        std::vector<int> win(n);
        for (int r = 0; r < h + 6; r++)
            for (int c = 0; c < ws; c++)
                win[(size_t)r * ws + c] = sample(p, x0 + c - 3, y0 + r - 3, stripeStart, stripeEnd, planeW, planeH);
        std::vector<P> out((size_t)w * h);
        int wiener = u[L_TYPE] == RESTORE_WIENER;
        if (wiener) wiener_filter(win.data(), w, h, u + L_WIENER, u + L_WIENER + 3, out.data(), bd);
        else sgr_filter(win.data(), w, h, u[L_SET], u + L_XQD, out.data(), bd);
        for (int i = 0; i < h; i++)
            std::memcpy(dst[p] + (size_t)(y0 + i) * stride[p] + x0, out.data() + (size_t)i * w, sizeof(P) * w);
        TraceRecord tr(g_trace ? 9 + n + w * h : 0);
        tr.put(wiener ? TRACE_WIENER : TRACE_SGR);
        tr.put(w);
        tr.put(h);
        if (wiener) {
            for (int k = 0; k < 6; k++) tr.put(u[L_WIENER + k]);
        } else {
            tr.put(u[L_SET]);
            tr.put(u[L_XQD]);
            tr.put(u[L_XQD + 1]);
            for (int k = 0; k < 3; k++) tr.put(0);
        }
        for (int k = 0; k < n; k++) tr.put(win[k]);
        for (int k = 0; k < w * h; k++) tr.put(out[k]);
    }
};

// ------------------------------------------------------------------ scale ---

// libyuv's ScalePlane as libavif's avifImageScale calls it (kFilterBox,
// reduced by ScaleFilterReduce), each path as libyuv takes it: a vertical
// interpolation where the width is kept; exact halves and quarters as 2x2
// and 4x4 means; box means where both sides shrink below half; the 2x
// linear and bilinear upsamplers; bilinear filtering (rows interpolated at
// 8 bits, columns at 7 bits with the x86 column filter's rounding) up or
// down; point sampling where a side is 1 wide. The 3/4 and 3/8 filters are
// not ported (kScaleRatio). The 16-bit planes of a 10- or 12-bit frame
// take ScalePlane_16's paths, the same but for two: its box sums are 32
// bits wide (the 8-bit ones wrap at 16), and its column filter is the C
// one, 16-bit fractions (libyuv has no x86 form of it).
namespace scale {

enum { F_NONE, F_LINEAR, F_BILINEAR, F_BOX };

int fixed_div(int num, int div) { return (int)(((int64_t)num << 16) / div); }
int fixed_div1(int num, int div) { return (int)((((int64_t)num << 16) - 0x00010001) / (div - 1)); }
int centerstart(int dx, int s) { return dx < 0 ? -((-dx >> 1) + s) : ((dx >> 1) + s); }

int reduce(int sw, int sh, int dw, int dh, int f) {
    if (f == F_BOX && (dw * 2 >= sw || dh * 2 >= sh)) f = F_BILINEAR;
    if (f == F_BILINEAR) {
        if (sh == 1) f = F_LINEAR;
        if (dh == sh || dh * 3 == sh) f = F_LINEAR;
        if (sw == 1) f = F_NONE;
    }
    if (f == F_LINEAR) {
        if (sw == 1) f = F_NONE;
        if (dw == sw || dw * 3 == sw) f = F_NONE;
    }
    return f;
}

template <typename P>
void interp_row(const P* a, const P* b, int n, int f, P* out) {
    for (int x = 0; x < n; x++) out[x] = f ? (P)((a[x] * (256 - f) + b[x] * f + 128) >> 8) : a[x];
}

// the x86 column filter of 8-bit rows: 7-bit fractions, (128 - f) a + f b
// rounded
void filter_cols(const uint8_t* row, int dw, int x, int dx, uint8_t* out) {
    for (int j = 0; j < dw; j++, x += dx) {
        int xi = x >> 16, f = (x >> 9) & 127;
        int a = row[xi], b = f ? row[xi + 1] : 0;
        out[j] = (uint8_t)(((128 - f) * a + f * b + 64) >> 7);
    }
}

// ScaleFilterCols_16_C: 16-bit fractions, a + (f (b - a) + 0x8000) >> 16
void filter_cols(const uint16_t* row, int dw, int x, int dx, uint16_t* out) {
    for (int j = 0; j < dw; j++, x += dx) {
        int xi = x >> 16, f = x & 0xffff;
        int a = row[xi], b = f ? row[xi + 1] : a;
        out[j] = (uint16_t)(a + (int)(((int64_t)f * (b - a) + 0x8000) >> 16));
    }
}

void slope(int sw, int sh, int dw, int dh, int f, int* x, int* y, int* dx, int* dy) {
    *x = *y = *dx = *dy = 0;
    if (f == F_BILINEAR || f == F_LINEAR) {
        if (dw <= sw) {
            *dx = fixed_div(sw, dw);
            *x = centerstart(*dx, -32768);
        } else if (sw > 1 && dw > 1) {
            *dx = fixed_div1(sw, dw);
        }
        if (f == F_LINEAR) {
            *dy = fixed_div(sh, dh);
            *y = *dy >> 1;
        } else if (dh <= sh) {
            *dy = fixed_div(sh, dh);
            *y = centerstart(*dy, -32768);
        } else if (sh > 1 && dh > 1) {
            *dy = fixed_div1(sh, dh);
        }
    } else {
        *dx = fixed_div(sw, dw);
        *dy = fixed_div(sh, dh);
        if (f == F_NONE) {
            *x = centerstart(*dx, 0);
            *y = centerstart(*dy, 0);
        }
    }
}

template <typename P>
int plane(const P* src, int ss, int sw, int sh, P* dst, int ds, int dw, int dh) {
    // libyuv's ScaleAddRow sums: uint16_t for 8-bit rows (they wrap), uint32_t for 16-bit
    using Sum = typename std::conditional<sizeof(P) == 1, uint16_t, uint32_t>::type;
    int f = reduce(sw, sh, dw, dh, F_BOX);
    auto S = [&](int r) { return src + (size_t)r * ss; };
    auto D = [&](int r) { return dst + (size_t)r * ds; };
    if (dw == sw && dh == sh) {
        for (int r = 0; r < dh; r++) std::memcpy(D(r), S(r), sizeof(P) * dw);
        return 0;
    }
    if (dw == sw && f != F_BOX) {  // ScalePlaneVertical
        int dy = 0, y = 0;
        if (dh <= sh) {
            dy = fixed_div(sh, dh);
            y = centerstart(dy, -32768);
        } else if (sh > 1 && dh > 1) {
            dy = fixed_div1(sh, dh);
        }
        int maxY = sh > 1 ? ((sh - 1) << 16) - 1 : 0;
        for (int j = 0; j < dh; j++, y += dy) {
            y = std::min(y, maxY);
            int yi = y >> 16, yf = f ? (y >> 8) & 255 : 0;
            interp_row(S(yi), S(std::min(yi + 1, sh - 1)), dw, yf, D(j));
        }
        return 0;
    }
    if (dw <= sw && dh <= sh) {
        if (4 * dw == 3 * sw && 4 * dh == 3 * sh) return kScaleRatio;
        if (2 * dw == sw && 2 * dh == sh) {  // 2x2 means
            for (int j = 0; j < dh; j++)
                for (int i = 0; i < dw; i++)
                    D(j)[i] = (P)((S(2 * j)[2 * i] + S(2 * j)[2 * i + 1] + S(2 * j + 1)[2 * i] +
                                   S(2 * j + 1)[2 * i + 1] + 2) >> 2);
            return 0;
        }
        if (8 * dw == 3 * sw && 8 * dh == 3 * sh) return kScaleRatio;
        if (4 * dw == sw && 4 * dh == sh) {  // 4x4 means
            for (int j = 0; j < dh; j++)
                for (int i = 0; i < dw; i++) {
                    int t = 8;
                    for (int a = 0; a < 4; a++)
                        for (int b = 0; b < 4; b++) t += S(4 * j + a)[4 * i + b];
                    D(j)[i] = (P)(t >> 4);
                }
            return 0;
        }
    }
    if (f == F_BOX && dh * 2 < sh) {  // ScalePlaneBox: both sides below half, boxes 2 or more wide
        int dx = fixed_div(sw, dw), dy = fixed_div(sh, dh), y = 0, maxY = sh << 16;
        std::vector<Sum> row(sw);
        for (int j = 0; j < dh; j++) {
            int iy = y >> 16;
            y = std::min(y + dy, maxY);
            int bh = std::max(1, (y >> 16) - iy);
            std::fill(row.begin(), row.end(), 0);
            for (int k = 0; k < bh; k++)
                for (int i = 0; i < sw; i++) row[i] = (Sum)(row[i] + S(iy + k)[i]);
            for (int i = 0, x = 0; i < dw; i++) {
                // a fractional step gives boxes of dx >> 16 or one more
                int ix = (dx & 0xffff) ? x >> 16 : i * (dx >> 16);
                x += dx;
                int bw = (dx & 0xffff) ? (x >> 16) - ix : dx >> 16;
                uint32_t t = 0;
                for (int k = 0; k < bw; k++) t += row[ix + k];
                D(j)[i] = (P)((t * (uint32_t)(65536 / (bw * bh))) >> 16);
            }
        }
        return 0;
    }
    if ((dw + 1) / 2 == sw && f == F_LINEAR) {  // ScalePlaneUp2_Linear
        auto up = [&](const P* r, P* o) {
            o[0] = r[0];
            int n = ((dw - 1) & ~1) / 2;
            for (int x = 0; x < n; x++) {
                o[1 + 2 * x] = (P)((3 * r[x] + r[x + 1] + 2) >> 2);
                o[2 + 2 * x] = (P)((r[x] + 3 * r[x + 1] + 2) >> 2);
            }
            o[dw - 1] = r[(dw - 1) / 2];
        };
        if (dh == 1) {
            up(S((sh - 1) / 2), D(0));
        } else {
            int dy = fixed_div(sh - 1, dh - 1), y = (1 << 15) - 1;
            for (int j = 0; j < dh; j++, y += dy) up(S(y >> 16), D(j));
        }
        return 0;
    }
    if ((dh + 1) / 2 == sh && (dw + 1) / 2 == sw && (f == F_BILINEAR || f == F_BOX)) {  // ScalePlaneUp2_Bilinear
        auto two = [&](const P* a, const P* b, P* da, P* db) {
            da[0] = (P)((3 * a[0] + b[0] + 2) >> 2);
            if (db) db[0] = (P)((a[0] + 3 * b[0] + 2) >> 2);
            int n = ((dw - 1) & ~1) / 2;
            for (int x = 0; x < n; x++) {
                int s0 = a[x], s1 = a[x + 1], t0 = b[x], t1 = b[x + 1];
                da[1 + 2 * x] = (P)((s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4);
                da[2 + 2 * x] = (P)((s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4);
                if (db) {
                    db[1 + 2 * x] = (P)((s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4);
                    db[2 + 2 * x] = (P)((s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4);
                }
            }
            int k = (dw - 1) / 2;
            da[dw - 1] = (P)((3 * a[k] + b[k] + 2) >> 2);
            if (db) db[dw - 1] = (P)((a[k] + 3 * b[k] + 2) >> 2);
        };
        two(S(0), S(0), D(0), nullptr);
        int r = 1;
        for (int k = 0; k < sh - 1; k++, r += 2) two(S(k), S(k + 1), D(r), r + 1 < dh ? D(r + 1) : nullptr);
        if (!(dh & 1)) two(S(sh - 1), S(sh - 1), D(r), nullptr);
        return 0;
    }
    int x, y, dx, dy;
    if (f) {
        slope(sw, sh, dw, dh, f, &x, &y, &dx, &dy);
        int maxY = (sh - 1) << 16;
        y = std::min(y, maxY);
        std::vector<P> top(dw), bot(dw), row(sw + 1, 0);
        for (int j = 0; j < dh; j++) {
            int yi = y >> 16;
            if (dh > sh) {  // ScalePlaneBilinearUp: the columns of two rows, then the rows
                filter_cols(S(yi), dw, x, dx, top.data());
                if (f == F_LINEAR) {
                    std::memcpy(D(j), top.data(), sizeof(P) * dw);
                } else {
                    filter_cols(S(std::min(yi + 1, sh - 1)), dw, x, dx, bot.data());
                    interp_row(top.data(), bot.data(), dw, (y >> 8) & 255, D(j));
                }
                y = std::min(y + dy, maxY);
            } else {  // ScalePlaneBilinearDown: the rows, then the columns
                if (f == F_LINEAR) std::memcpy(row.data(), S(yi), sizeof(P) * sw);
                else interp_row(S(yi), S(std::min(yi + 1, sh - 1)), sw, (y >> 8) & 255, row.data());
                filter_cols(row.data(), dw, x, dx, D(j));
                y = std::min(y + dy, maxY);
            }
        }
        return 0;
    }
    // ScalePlaneSimple: point sampling (2x across by repetition)
    slope(sw, sh, dw, dh, F_NONE, &x, &y, &dx, &dy);
    bool up2 = sw * 2 == dw && x < 0x8000;
    for (int j = 0; j < dh; j++, y += dy) {
        int xx = x;
        for (int i = 0; i < dw; i++, xx += dx) D(j)[i] = S(y >> 16)[up2 ? i >> 1 : xx >> 16];
    }
    return 0;
}

}  // namespace scale

// ------------------------------------------------------------ YUV -> RGB ---

// The conversion utils/av1.py's `conversion` picks as libavif 1.3.0 does
// for PIL: its route (libyuv's fixed point with one set of YuvConstants, or
// libavif's own float conversion), the chroma subsampling, the range, the
// float route's mode and kr / kb (float bits), the constants' YG, YB, UB,
// UG, VG and VR; then the planes' bit depth (8, 10 or 12: uint16_t samples
// past 8), C_DOWN (the planes brought to 8 bits first, >> (depth - 8) as
// libyuv's Convert16To8Plane, where libavif downshifts an image that libyuv
// has no high-bit-depth function for, and converted as an 8-bit image),
// C_NEAREST (libyuv's I012ToARGBMatrix: each 4:2:0 chroma sample for its
// 2x2, no filter) and C_ALPHA_ROUND (the alpha plane to 8 bits as libavif
// rounds it, a * 255 / max; else shifted, as libyuv takes it).
enum { C_ROUTE, C_SSX, C_SSY, C_FULL, C_MODE, C_KR, C_KB, C_YG, C_YB, C_UB, C_UG, C_VG, C_VR, C_DEPTH, C_DOWN,
       C_NEAREST, C_ALPHA_ROUND, C_FIELDS };
enum { ROUTE_LIBYUV, ROUTE_FLOAT };
enum { MODE_YUV, MODE_IDENTITY, MODE_YCGCO, MODE_YCGCO_RE };

// libyuv's YuvPixel (row_common.cc): Y as 16 bits (y * 0x0101 at 8 bits,
// the sample's bits repeated at 10 and 12) scaled by YG >> 16, U and V at
// 8 bits with the biases folded into the constants, 6 fractional bits.
inline void yuv_pixel(const int32_t* c, uint32_t y32, int u, int v, uint8_t* rgb) {
    int yg = c[C_YG], yb = c[C_YB], ub = c[C_UB], ug = c[C_UG], vg = c[C_VG], vr = c[C_VR];
    int y1 = (int)((y32 * (uint32_t)yg) >> 16);
    int b16 = y1 + u * ub - (ub * 128 - yb);
    int g16 = y1 + (ug * 128 + vg * 128 + yb) - (u * ug + v * vg);
    int r16 = y1 + v * vr - (vr * 128 - yb);
    rgb[0] = (uint8_t)clip1(r16 >> 6, 8);
    rgb[1] = (uint8_t)clip1(g16 >> 6, 8);
    rgb[2] = (uint8_t)clip1(b16 >> 6, 8);
}

// a sample of `depth` bits as libyuv's 16-bit Y
inline uint32_t libyuv_y16(int y, int depth) { return ((uint32_t)y << (16 - depth)) | ((uint32_t)y >> (2 * depth - 16)); }

// libyuv's chroma upsampling of one output row into urow / vrow, then to
// 8 bits (>> (depth - 8), at most 255): none for 4:4:4; 4:2:2 across only
// (ScaleRowUp2_Linear, 3:1); 4:2:0 the two chroma rows nearest, 3:1, then
// across, 3:1 (ScaleRowUp2_Bilinear, 9-3-3-1 / 16), or with `nearest` the
// sample of the 2x2. The first and last columns take their chroma sample.
template <typename P>
void libyuv_chroma_row(const P* u, const P* v, int cs, int ssx, int ssy, int nearest, int depth, int row, int w,
                       int h, int* urow, int* vrow) {
    int cw = (w + ssx) >> ssx, ch = (h + ssy) >> ssy, s = depth - 8;
    int near = row, far = row;
    if (ssy) {
        int c0 = (row - 1) >> 1;
        near = (row & 1) ? c0 : c0 + 1;
        far = (row & 1) ? c0 + 1 : c0;
        if (row == 0) near = far = 0;
        if (nearest) near = far = row >> 1;
        near = std::min(std::max(near, 0), ch - 1);
        far = std::min(std::max(far, 0), ch - 1);
    }
    const P* un = u + (size_t)near * cs;
    const P* uf = u + (size_t)far * cs;
    const P* vn = v + (size_t)near * cs;
    const P* vf = v + (size_t)far * cs;
    for (int x = 0; x < w; x++) {
        int uu, vv;
        if (!ssx) {
            uu = un[x];
            vv = vn[x];
        } else if (nearest) {
            uu = un[x >> 1];
            vv = vn[x >> 1];
        } else {
            int cx = (x - 1) >> 1;
            int nx = (x & 1) ? cx : cx + 1, fx = (x & 1) ? cx + 1 : cx;
            if (x == 0) nx = fx = 0;
            if (x == w - 1) nx = fx = (w - 1) >> 1;
            nx = std::min(std::max(nx, 0), cw - 1);
            fx = std::min(std::max(fx, 0), cw - 1);
            if (ssy) {
                uu = (9 * un[nx] + 3 * uf[nx] + 3 * un[fx] + uf[fx] + 8) >> 4;
                vv = (9 * vn[nx] + 3 * vf[nx] + 3 * vn[fx] + vf[fx] + 8) >> 4;
            } else {
                uu = (3 * un[nx] + un[fx] + 2) >> 2;
                vv = (3 * vn[nx] + vn[fx] + 2) >> 2;
            }
        }
        urow[x] = std::min(uu >> s, 255);
        vrow[x] = std::min(vv >> s, 255);
    }
}

// libavif's own conversion (reformat.c, avifImageYUVAnyToRGBAnySlow and
// its fast paths, which compute the same): float unorm tables of the bit
// depth, 4:2:x chroma upsampled bilinearly on the floats (the nearest
// sample 9/16, the adjacent column and row 3/16, the diagonal 1/16; 4:2:2
// takes the row itself as its adjacent row), then the mode's formulas, a
// clamp to [0, 1] and 0.5 + x * 255 truncated. Built without contraction
// (no FMA), as each operation rounds in libavif. YCgCo-Re (10-bit samples
// of 8-bit RGB) takes the integers back from the floats (Cg and Co rounded
// from the upsampled chroma) and libavif's lifting steps, each of G and B
// clamped before R is made from B.
template <typename P>
void float_pixel_row(const int32_t* c, const float* tY, const float* tUV, const P* yr, const P* u, const P* v,
                     int cs, int row, int w, int h, uint8_t* out) {
    int ssx = c[C_SSX], ssy = c[C_SSY], mode = c[C_MODE];
    float kr, kb;
    std::memcpy(&kr, &c[C_KR], 4);
    std::memcpy(&kb, &c[C_KB], 4);
    float kg = 1.0f - kr - kb;
    int uvJ = row >> ssy;
    int adjRow = 0;
    if (!(row == 0 || (row == h - 1 && (row % 2) != 0) || !ssy)) adjRow = (row % 2) != 0 ? 1 : -1;
    for (int i = 0; i < w; i++) {
        float Y = tY[yr[i]], R, G, B;
        if (!u) {
            R = G = B = Y;
        } else {
            float Cb, Cr;
            int uvI = i >> ssx;
            if (!ssx && !ssy) {
                Cb = tUV[u[(size_t)uvJ * cs + uvI]];
                Cr = tUV[v[(size_t)uvJ * cs + uvI]];
            } else {
                int adjCol = 0;
                if (!(i == 0 || (i == w - 1 && (i % 2) != 0))) adjCol = (i % 2) != 0 ? 1 : -1;
                std::ptrdiff_t p00 = (std::ptrdiff_t)uvJ * cs + uvI, p10 = p00 + adjCol,
                               p01 = p00 + (std::ptrdiff_t)adjRow * cs, p11 = p01 + adjCol;
                Cb = (tUV[u[p00]] * (9.0f / 16.0f)) + (tUV[u[p10]] * (3.0f / 16.0f)) +
                     (tUV[u[p01]] * (3.0f / 16.0f)) + (tUV[u[p11]] * (1.0f / 16.0f));
                Cr = (tUV[v[p00]] * (9.0f / 16.0f)) + (tUV[v[p10]] * (3.0f / 16.0f)) +
                     (tUV[v[p01]] * (3.0f / 16.0f)) + (tUV[v[p11]] * (1.0f / 16.0f));
            }
            if (mode == MODE_YCGCO_RE) {
                int max = c[C_DEPTH] == 8 ? 255 : (1 << c[C_DEPTH]) - 1;
                int cg = (int)std::floor(Cb * (float)max + 0.5f), co = (int)std::floor(Cr * (float)max + 0.5f);
                int t = (int)yr[i] - (cg >> 1);
                int g = clip1(t + cg, 8), b = clip1(t - (co >> 1), 8), r = clip1(b + co, 8);
                out[(size_t)i * 4] = (uint8_t)r;
                out[(size_t)i * 4 + 1] = (uint8_t)g;
                out[(size_t)i * 4 + 2] = (uint8_t)b;
                continue;
            } else if (mode == MODE_IDENTITY) {
                G = Y;
                B = Cb;
                R = Cr;
            } else if (mode == MODE_YCGCO) {
                float t = Y - Cb;
                G = Y + Cb;
                B = t - Cr;
                R = t + Cr;
            } else {
                R = Y + (2 * (1 - kr)) * Cr;
                B = Y + (2 * (1 - kb)) * Cb;
                G = Y - ((2 * ((kr * (1 - kr) * Cr) + (kb * (1 - kb) * Cb))) / kg);
            }
        }
        const float rgb[3] = {R, G, B};
        for (int k = 0; k < 3; k++) {
            float x = rgb[k] < 0.0f ? 0.0f : (rgb[k] > 1.0f ? 1.0f : rgb[k]);
            out[(size_t)i * 4 + k] = (uint8_t)(0.5f + (x * 255.0f));
        }
    }
}

// The colour of a w x h image (samples of `depth` bits) into RGBA's R, G
// and B by the conversion `c`.
template <typename P>
void to_rgb(const int32_t* c, int depth, const P* y, int ys, const P* u, const P* v, int cs, int w, int h,
            uint8_t* out) {
    int n = 1 << depth, s = depth - 8, full = c[C_FULL];
    std::vector<float> tY(n), tUV(n);
    float biasY = full ? 0.0f : (float)(16 << s), rangeY = full ? (float)(n - 1) : (float)(219 << s);
    float biasUV = (float)(128 << s), rangeUV = full ? (float)(n - 1) : (float)(224 << s);
    for (int cp = 0; cp < n; cp++) {
        tY[cp] = ((float)cp - biasY) / rangeY;
        tUV[cp] = c[C_MODE] == MODE_IDENTITY ? tY[cp] : ((float)cp - biasUV) / rangeUV;
    }
    std::vector<int> urow(w + 1), vrow(w + 1);
    for (int row = 0; row < h; row++) {
        const P* yr = y + (size_t)row * ys;
        uint8_t* o = out + (size_t)row * w * 4;
        if (c[C_ROUTE] == ROUTE_FLOAT) {
            float_pixel_row(c, tY.data(), tUV.data(), yr, u, v, cs, row, w, h, o);
        } else if (!u) {  // libyuv's YPixel: grey
            for (int x = 0; x < w; x++) {
                int y1 = (int)((libyuv_y16(yr[x], depth) * (uint32_t)c[C_YG]) >> 16);
                o[x * 4] = o[x * 4 + 1] = o[x * 4 + 2] = (uint8_t)clip1((y1 + c[C_YB]) >> 6, 8);
            }
        } else {
            libyuv_chroma_row(u, v, cs, c[C_SSX], c[C_SSY], c[C_NEAREST], depth, row, w, h, urow.data(),
                              vrow.data());
            for (int x = 0; x < w; x++) yuv_pixel(c, libyuv_y16(yr[x], depth), urow[x], vrow[x], o + x * 4);
        }
    }
}

// rows x cols samples of `depth` bits (stride st) brought to 8 bits
std::vector<uint8_t> downshift(const uint16_t* p, int st, int cols, int rows, int depth) {
    std::vector<uint8_t> out((size_t)cols * rows);
    for (int r = 0; r < rows; r++)
        for (int x = 0; x < cols; x++)
            out[(size_t)r * cols + x] = (uint8_t)std::min(p[(size_t)r * st + x] >> (depth - 8), 255);
    return out;
}

}  // namespace

extern "C" {

// Start (buf, cap) or stop (null) tracing the stage calls; returns the
// int32s written since the last start, or -1 if records were lost.
int64_t fd_av1_trace(int32_t* buf, int64_t cap) {
    int64_t n = g_trace_lost ? -1 : g_trace_len;
    g_trace = buf;
    g_trace_cap = buf ? cap : 0;
    g_trace_len = 0;
    g_trace_lost = 0;
    return n;
}

}  // extern "C"

namespace {

inline bool valid_depth(int bd) { return bd == 8 || bd == 10 || bd == 12; }

template <typename P>
int tile_at(const uint8_t* data, int64_t size, const int32_t* hdr, void* y, void* u, void* v, int32_t* mi,
            int64_t* left, int32_t* cdef, int32_t* lr) {
    Tile<P>* t = new Tile<P>();
    t->hdr = hdr;
    t->plane[0] = (P*)y;
    t->plane[1] = (P*)u;
    t->plane[2] = (P*)v;
    t->stride[0] = hdr[H_STRIDE_Y];
    t->stride[1] = t->stride[2] = hdr[H_STRIDE_UV];
    t->mi = mi;
    t->cdefIdx = cdef;
    t->lrUnits = lr;
    int r = t->run(data, size);
    if (left) *left = t->sd.maxBits;
    delete t;
    return r;
}

template <typename P>
void deblock_at(const int32_t* hdr, void* y, void* u, void* v, const int32_t* mi) {
    Deblock<P> d;
    d.hdr = hdr;
    d.miCols = hdr[H_MI_COLS];
    d.miRows = hdr[H_MI_ROWS];
    d.numPlanes = hdr[H_MONO] ? 1 : 3;
    d.ssx = hdr[H_SSX];
    d.ssy = hdr[H_SSY];
    d.bd = hdr[H_BITDEPTH];
    d.width = hdr[H_WIDTH];
    d.height = hdr[H_HEIGHT];
    d.plane[0] = (P*)y;
    d.plane[1] = (P*)u;
    d.plane[2] = (P*)v;
    d.stride[0] = hdr[H_STRIDE_Y];
    d.stride[1] = d.stride[2] = hdr[H_STRIDE_UV];
    d.mi = mi;
    d.run();
}

template <typename P>
void cdef_at(const int32_t* hdr, const void* y, const void* u, const void* v, void* dy, void* du, void* dv,
             const int32_t* mi, const int32_t* cdef) {
    Cdef<P> c;
    c.hdr = hdr;
    c.miCols = hdr[H_MI_COLS];
    c.miRows = hdr[H_MI_ROWS];
    c.numPlanes = hdr[H_MONO] ? 1 : 3;
    c.ssx = hdr[H_SSX];
    c.ssy = hdr[H_SSY];
    c.bd = hdr[H_BITDEPTH];
    c.src[0] = (const P*)y;
    c.src[1] = (const P*)u;
    c.src[2] = (const P*)v;
    c.dst[0] = (P*)dy;
    c.dst[1] = (P*)du;
    c.dst[2] = (P*)dv;
    c.stride[0] = hdr[H_STRIDE_Y];
    c.stride[1] = c.stride[2] = hdr[H_STRIDE_UV];
    c.mi = mi;
    c.idx = cdef;
    c.run();
}

template <typename P>
void lr_at(const int32_t* hdr, const void* const* pre, const void* const* cdef, void* const* dst, const int32_t* lr) {
    Restoration<P> R;
    R.hdr = hdr;
    R.numPlanes = hdr[H_MONO] ? 1 : 3;
    R.ssx = hdr[H_SSX];
    R.ssy = hdr[H_SSY];
    R.bd = hdr[H_BITDEPTH];
    R.width = hdr[H_WIDTH];
    R.height = hdr[H_HEIGHT];
    for (int i = 0; i < 3; i++) {
        R.pre[i] = (const P*)pre[i];
        R.cdef[i] = (const P*)cdef[i];
        R.dst[i] = (P*)dst[i];
    }
    R.stride[0] = hdr[H_STRIDE_Y];
    R.stride[1] = R.stride[2] = hdr[H_STRIDE_UV];
    R.units = lr;
    R.run();
}

template <typename P>
int cdef_block_at(const int32_t* win, int w, int h, int plane, int pri, int sec, int damping, int ydir, int bd,
                  P* out, int32_t* dv) {
    if (!win || !out || !dv || (w != 4 && w != 8) || (h != 4 && h != 8) || (!plane && (w != 8 || h != 8)) ||
        pri < 0 || pri > 15 || sec < 0 || sec > 4 ||
        damping < 2 || damping > 6 || ydir < -1 || ydir > 7 || !valid_depth(bd))
        return kArgs;
    std::vector<int> v(win, win + (w + 4) * (h + 4));
    int var = 0;
    if (plane == 0) {
        int b[64];
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++) b[i * 8 + j] = v[(i + 2) * 12 + j + 2];
        ydir = cdef_direction(b, 8, &var, bd);
    } else if (ydir < 0) {
        return kArgs;
    }
    int dir = cdef_apply(v.data(), w, h, plane, pri, sec, damping, ydir, var, out, bd);
    dv[0] = plane ? dir : ydir;
    dv[1] = plane ? 0 : var;
    return 0;
}

// ------------------------------------------------------------ film grain ---

// film_grain_params as utils/av1.py's parse_film_grain writes them (G_*
// there), then the sequence's subsampling, monochrome, BitDepth and
// whether its matrix is the identity.
enum { G_SEED, G_NUM_Y, G_Y_POINTS, G_CSFL = G_Y_POINTS + 28, G_NUM_UV, G_UV_POINTS = G_NUM_UV + 2,
       G_SCALING_SHIFT = G_UV_POINTS + 40, G_AR_LAG, G_AR_Y, G_AR_UV = G_AR_Y + 24, G_AR_SHIFT = G_AR_UV + 50,
       G_GRAIN_SCALE_SHIFT, G_UV_MULT, G_UV_LUMA_MULT = G_UV_MULT + 2, G_UV_OFFSET = G_UV_LUMA_MULT + 2,
       G_OVERLAP = G_UV_OFFSET + 2, G_CLIP, G_SSX, G_SSY, G_MONO, G_BITDEPTH, G_IS_ID, G_FIELDS };
constexpr int kGrainH = 73, kGrainW = 82, kSubGrainH = 38, kSubGrainW = 44, kGrainBlock = 32;
constexpr int kScalingSize = 4096;

// The 16-bit LFSR of the specification's get_random_number.
inline int grain_random(int bits, unsigned* state) {
    unsigned r = *state;
    unsigned bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    *state = (r >> 1) | (bit << 15);
    return (int)((*state >> (16 - bits)) & ((1u << bits) - 1));
}

// dav1d's round2 of the film grain (an arithmetic shift, 0 rounds nothing)
inline int grain_round2(int x, int shift) { return (x + ((1 << shift) >> 1)) >> shift; }

// The grain templates (dav1d's generate_grain_y / generate_grain_uv):
// Gaussian values by the LFSR, shifted to the bit depth and by
// grain_scale_shift, then the autoregressive filter of lag 0-3 from row and
// column 3 on (chroma adds the luma template's average over its sample's
// luma samples, where there is luma grain), clamped to the grain's range.
// lut[1] and lut[2] are written only for a chroma plane that takes grain
// (38 x 44 where subsampled); the luma template always, as dav1d does.
void grain_templates(const int32_t* g, int16_t (*lut)[kGrainH][kGrainW]) {
    int bdm8 = g[G_BITDEPTH] - 8, lag = g[G_AR_LAG];
    int shift = 4 - bdm8 + g[G_GRAIN_SCALE_SHIFT];
    int gmin = -(128 << bdm8), gmax = (128 << bdm8) - 1;
    for (int p = 0; p < 3; p++) {
        if (p && (g[G_MONO] || !(g[G_NUM_UV + p - 1] || g[G_CSFL]))) continue;
        int sx = p ? g[G_SSX] : 0, sy = p ? g[G_SSY] : 0;
        int cw = sx ? kSubGrainW : kGrainW, ch = sy ? kSubGrainH : kGrainH;
        unsigned seed = (unsigned)g[G_SEED] ^ (p == 1 ? 0xb524u : p == 2 ? 0x49d8u : 0u);
        int16_t (*buf)[kGrainW] = lut[p];
        for (int y = 0; y < ch; y++)
            for (int x = 0; x < cw; x++) buf[y][x] = (int16_t)grain_round2(GAUSSIAN_SEQUENCE[grain_random(11, &seed)], shift);
        const int32_t* coeff0 = p ? g + G_AR_UV + 25 * (p - 1) : g + G_AR_Y;
        for (int y = 3; y < ch; y++) {
            for (int x = 3; x < cw - 3; x++) {
                const int32_t* coeff = coeff0;
                int sum = 0;
                for (int dy = -lag; dy <= 0; dy++) {
                    for (int dx = -lag; dx <= lag; dx++) {
                        if (!dx && !dy) {
                            if (p && g[G_NUM_Y]) {
                                int luma = 0, lx = ((x - 3) << sx) + 3, ly = ((y - 3) << sy) + 3;
                                for (int i = 0; i <= sy; i++)
                                    for (int j = 0; j <= sx; j++) luma += lut[0][ly + i][lx + j];
                                sum += grain_round2(luma, sx + sy) * *coeff;
                            }
                            break;
                        }
                        sum += *(coeff++) * buf[y + dy][x + dx];
                    }
                }
                buf[y][x] = (int16_t)clip3(gmin, gmax, buf[y][x] + grain_round2(sum, g[G_AR_SHIFT]));
            }
        }
    }
}

// The scaling lookup of a plane's points (x, scaling pairs; dav1d's
// generate_scaling): the first point's value before it, the points joined
// by 16.16 steps, the last point's value after it; at 10 and 12 bits the
// 8-bit points are spread to the depth and each run between them
// interpolated again.
void grain_scaling(int bd, const int32_t* pts, int num, uint8_t* scaling) {
    int shift = bd - 8, size = 1 << bd;
    if (!num) {
        memset(scaling, 0, size);
        return;
    }
    memset(scaling, pts[1], (size_t)pts[0] << shift);
    for (int i = 0; i < num - 1; i++) {
        int bx = pts[2 * i], by = pts[2 * i + 1], ex = pts[2 * i + 2], ey = pts[2 * i + 3];
        int dx = ex - bx, dy = ey - by;
        int delta = dy * ((0x10000 + (dx >> 1)) / dx);
        for (int x = 0, d = 0x8000; x < dx; x++) {
            scaling[(bx + x) << shift] = (uint8_t)(by + (d >> 16));
            d += delta;
        }
    }
    int n = pts[2 * (num - 1)] << shift;
    memset(scaling + n, pts[2 * (num - 1) + 1], size - n);
    if (!shift) return;
    int pad = 1 << shift, rnd = pad >> 1;
    for (int i = 0; i < num - 1; i++) {
        int bx = pts[2 * i] << shift, dx = (pts[2 * i + 2] << shift) - bx;
        for (int x = 0; x < dx; x += pad) {
            int range = scaling[bx + x + pad] - scaling[bx + x];
            for (int k = 1, r = rnd; k < pad; k++) {
                r += range;
                scaling[bx + x + k] = (uint8_t)(scaling[bx + x] + (r >> shift));
            }
        }
    }
}

// One row of 32 luma rows (`row`) of plane p (dav1d's fgy_32x32xn and
// fguv_32x32xn): pw x bh samples of src into dst (stride st), in blocks of
// 32 (16 across or down where chroma is subsampled) each at its random
// template offset (each block row's LFSR seeded from grain_seed and the
// row), the first two columns (one subsampled) blended with the block to
// the left and the first two rows with the block above where overlap_flag
// is set; the noise is the template's value times the scaling lookup of
// the sample (of chroma: the co-located luma's average across, or its
// combination with the chroma sample by mult, luma_mult and offset),
// shifted by scaling_shift, and the sum is clipped to the full or the
// restricted range.
template <typename P>
void grain_row(const int32_t* g, const int16_t (*lut)[kGrainW], const uint8_t* scaling, int p, const P* src, P* dst,
               int st, int pw, int bh, int row, const P* luma, int lst, int lw) {
    static const int kBlend[2][2][2] = {{{27, 17}, {17, 27}}, {{23, 22}, {0, 0}}};
    int bd = g[G_BITDEPTH], bdm8 = bd - 8, bmax = (1 << bd) - 1;
    int sx = p ? g[G_SSX] : 0, sy = p ? g[G_SSY] : 0;
    int gmin = -(128 << bdm8), gmax = (128 << bdm8) - 1;
    int lo = 0, hi = bmax;
    if (g[G_CLIP]) {
        lo = 16 << bdm8;
        hi = (p == 0 || g[G_IS_ID] ? 235 : 240) << bdm8;
    }
    int overlap = g[G_OVERLAP], rows = 1 + (overlap && row > 0);
    int uv = p ? p - 1 : 0, csfl = g[G_CSFL], shift = g[G_SCALING_SHIFT];
    int mult = g[G_UV_MULT + uv], lmult = g[G_UV_LUMA_MULT + uv], offset = g[G_UV_OFFSET + uv] * (1 << bdm8);
    unsigned seed[2];
    for (int i = 0; i < rows; i++)
        seed[i] = (unsigned)g[G_SEED] ^ ((((row - i) * 37 + 178) & 0xFF) << 8) ^ (((row - i) * 173 + 105) & 0xFF);
    int bsx = kGrainBlock >> sx, bsy = kGrainBlock >> sy;
    int offsets[2][2] = {{0, 0}, {0, 0}};  // [current / left block][current / above row]
    auto sample = [&](int bxi, int byi, int x, int y) -> int {
        int rv = offsets[bxi][byi];
        int offx = 3 + (2 >> sx) * (3 + (rv >> 4)), offy = 3 + (2 >> sy) * (3 + (rv & 0xF));
        return lut[offy + y + bsy * byi][offx + x + bsx * bxi];
    };
    auto blend = [&](int old, int cur, const int* w) { return clip3(gmin, gmax, grain_round2(old * w[0] + cur * w[1], 5)); };
    for (int bx = 0; bx < pw; bx += bsx) {
        int bw = std::min(bsx, pw - bx);
        if (overlap && bx)
            for (int i = 0; i < rows; i++) offsets[1][i] = offsets[0][i];
        for (int i = 0; i < rows; i++) offsets[0][i] = grain_random(8, &seed[i]);
        int ystart = overlap && row ? std::min(2 >> sy, bh) : 0;
        int xstart = overlap && bx ? std::min(2 >> sx, bw) : 0;
        for (int y = 0; y < bh; y++) {
            for (int x = 0; x < bw; x++) {
                int grain = sample(0, 0, x, y);
                if (x < xstart) grain = blend(sample(1, 0, x, y), grain, kBlend[sx][x]);
                if (y < ystart) {
                    int top = sample(0, 1, x, y);
                    if (x < xstart) top = blend(sample(1, 1, x, y), top, kBlend[sx][x]);
                    grain = blend(top, grain, kBlend[sy][y]);
                }
                int s = src[(size_t)y * st + bx + x], val = s;
                if (p) {
                    int lx = (bx + x) << sx;
                    const P* l = luma + (size_t)(y << sy) * lst + lx;
                    int avg = l[0];
                    if (sx) avg = (avg + (lx + 1 < lw ? l[1] : l[0]) + 1) >> 1;  // dav1d repeats the last column
                    val = avg;
                    if (!csfl) val = clip3(0, bmax, ((avg * lmult + s * mult) >> 6) + offset);
                }
                int noise = grain_round2(scaling[val] * grain, shift);
                dst[(size_t)y * st + bx + x] = (P)clip3(lo, hi, s + noise);
            }
        }
    }
}

// Film grain over a w x h frame (dav1d's prep_grain, then apply_grain_row
// for each row of 32 luma rows): luma where it has points, each chroma
// plane where it has points or chroma_scaling_from_luma is set (from the
// ungrained luma).
template <typename P>
void film_grain(const int32_t* g, int w, int h, const P* const* src, const int* st, P* const* dst,
                int16_t (*lut)[kGrainH][kGrainW], uint8_t (*scaling)[kScalingSize]) {
    int bd = g[G_BITDEPTH], sx = g[G_SSX], sy = g[G_SSY], csfl = g[G_CSFL];
    grain_templates(g, lut);
    if (g[G_NUM_Y] || csfl) grain_scaling(bd, g + G_Y_POINTS, g[G_NUM_Y], scaling[0]);
    for (int pl = 0; pl < 2; pl++)
        if (g[G_NUM_UV + pl]) grain_scaling(bd, g + G_UV_POINTS + 20 * pl, g[G_NUM_UV + pl], scaling[1 + pl]);
    int cw = (w + sx) >> sx;
    for (int row = 0; row * kGrainBlock < h; row++) {
        int bh = std::min(h - row * kGrainBlock, kGrainBlock);
        const P* luma = src[0] + (size_t)row * kGrainBlock * st[0];
        if (g[G_NUM_Y])
            grain_row<P>(g, lut[0], scaling[0], 0, luma, dst[0] + (size_t)row * kGrainBlock * st[0], st[0], w, bh,
                         row, nullptr, 0, w);
        if (g[G_MONO]) continue;
        int cbh = (bh + sy) >> sy;
        size_t off = (size_t)(row * kGrainBlock >> sy) * st[1];
        for (int pl = 0; pl < 2; pl++)
            if (csfl || g[G_NUM_UV + pl])
                grain_row<P>(g, lut[1 + pl], scaling[csfl ? 0 : 1 + pl], 1 + pl, src[1 + pl] + off,
                             dst[1 + pl] + off, st[1], cw, cbh, row, luma, st[0], w);
    }
}

// The parameters' bounds that keep every read of the templates and the
// lookups in place (the header parser holds the stream to them).
bool grain_valid(const int32_t* g) {
    if (!valid_depth(g[G_BITDEPTH]) || g[G_NUM_Y] < 0 || g[G_NUM_Y] > 14 || g[G_AR_LAG] < 0 || g[G_AR_LAG] > 3 ||
        g[G_SCALING_SHIFT] < 8 || g[G_SCALING_SHIFT] > 11 || g[G_AR_SHIFT] < 6 || g[G_AR_SHIFT] > 9 ||
        g[G_GRAIN_SCALE_SHIFT] < 0 || g[G_GRAIN_SCALE_SHIFT] > 3 || g[G_SSX] < 0 || g[G_SSX] > 1 ||
        g[G_SSY] < 0 || g[G_SSY] > g[G_SSX])
        return false;
    for (int k = 0; k < 3; k++) {
        int n = k ? g[G_NUM_UV + k - 1] : g[G_NUM_Y];
        const int32_t* pts = k ? g + G_UV_POINTS + 20 * (k - 1) : g + G_Y_POINTS;
        if (n < 0 || n > (k ? 10 : 14)) return false;
        for (int i = 0; i < n; i++)
            if (pts[2 * i] < 0 || pts[2 * i] > 255 || pts[2 * i + 1] < 0 || pts[2 * i + 1] > 255 ||
                (i && pts[2 * i] <= pts[2 * i - 2]))
                return false;
    }
    return true;
}

}  // namespace

extern "C" {

// One tile into the planes (uint8_t at 8 bits, else uint16_t, by the
// header's H_BITDEPTH) and the per-4x4 info; `left` gets the symbol
// decoder's SymbolMaxBits at the tile's end (negative: bits read past it).
// `cdef` gets each 64x64's CDEF index (-1 where read_cdef read none), `lr`
// each restoration unit ([3][H_LR_STRIDE][L_FIELDS]).
int fd_av1_tile(const uint8_t* data, int64_t size, const int32_t* hdr, void* y, void* u, void* v, int32_t* mi,
                int64_t* left, int32_t* cdef, int32_t* lr) {
    if (!data || size < 0 || !hdr || !y || !mi || !cdef || !lr || !valid_depth(hdr[H_BITDEPTH])) return kArgs;
    if (hdr[H_BITDEPTH] == 8) return tile_at<uint8_t>(data, size, hdr, y, u, v, mi, left, cdef, lr);
    return tile_at<uint16_t>(data, size, hdr, y, u, v, mi, left, cdef, lr);
}

int fd_av1_deblock(const int32_t* hdr, void* y, void* u, void* v, const int32_t* mi) {
    if (!hdr || !y || !mi || !valid_depth(hdr[H_BITDEPTH])) return kArgs;
    if (hdr[H_BITDEPTH] == 8) deblock_at<uint8_t>(hdr, y, u, v, mi);
    else deblock_at<uint16_t>(hdr, y, u, v, mi);
    return 0;
}

// CDEF of the deblocked planes y, u, v (null for monochrome) into dy, du, dv
// (copies of them), by the per-4x4 info and the 64x64 indices.
int fd_av1_cdef(const int32_t* hdr, const void* y, const void* u, const void* v, void* dy, void* du, void* dv,
                const int32_t* mi, const int32_t* cdef) {
    if (!hdr || !y || !dy || !mi || !cdef || !valid_depth(hdr[H_BITDEPTH])) return kArgs;
    if (!hdr[H_MONO] && !(u && v && du && dv)) return kArgs;
    if (hdr[H_BITDEPTH] == 8) cdef_at<uint8_t>(hdr, y, u, v, dy, du, dv, mi, cdef);
    else cdef_at<uint16_t>(hdr, y, u, v, dy, du, dv, mi, cdef);
    return 0;
}

// Loop restoration of CDEF's planes (cy, cu, cv) into dy, du, dv (copies of
// them), the stripes' edge rows from the deblocked planes (py, pu, pv).
int fd_av1_lr(const int32_t* hdr, const void* py, const void* pu, const void* pv, const void* cy, const void* cu,
              const void* cv, void* dy, void* du, void* dv, const int32_t* lr) {
    if (!hdr || !py || !cy || !dy || !lr || !valid_depth(hdr[H_BITDEPTH])) return kArgs;
    if (!hdr[H_MONO] && !(pu && pv && cu && cv && du && dv)) return kArgs;
    const void* pre[3] = {py, pu, pv};
    const void* c[3] = {cy, cu, cv};
    void* d[3] = {dy, du, dv};
    if (hdr[H_BITDEPTH] == 8) lr_at<uint8_t>(hdr, pre, c, d, lr);
    else lr_at<uint16_t>(hdr, pre, c, d, lr);
    return 0;
}

// Y (ys stride), U and V (cs stride, or null for monochrome), alpha (as
// stride, or null: 255) of a w x h image to RGBA by the conversion `conv`
// (C_FIELDS values); samples are uint8_t at C_DEPTH 8, else uint16_t, and
// strides count samples.
int fd_av1_to_rgb(const void* y, int ys, const void* u, const void* v, int cs, const void* a, int as, int w, int h,
                  const int32_t* conv, uint8_t* out) {
    if (!y || !out || !conv || w <= 0 || h <= 0 || (!u != !v)) return kArgs;
    int route = conv[C_ROUTE], ssx = conv[C_SSX], ssy = conv[C_SSY], depth = conv[C_DEPTH];
    if ((route != ROUTE_LIBYUV && route != ROUTE_FLOAT) || ssx < 0 || ssx > 1 || ssy < 0 || ssy > ssx ||
        conv[C_MODE] < MODE_YUV || conv[C_MODE] > MODE_YCGCO_RE || !valid_depth(depth))
        return kArgs;
    if (depth == 8) {
        to_rgb(conv, 8, (const uint8_t*)y, ys, (const uint8_t*)u, (const uint8_t*)v, cs, w, h, out);
    } else if (conv[C_DOWN]) {
        int cw = (w + ssx) >> ssx, ch = (h + ssy) >> ssy;
        std::vector<uint8_t> y8 = downshift((const uint16_t*)y, ys, w, h, depth), u8, v8;
        if (u) {
            u8 = downshift((const uint16_t*)u, cs, cw, ch, depth);
            v8 = downshift((const uint16_t*)v, cs, cw, ch, depth);
        }
        to_rgb(conv, 8, y8.data(), w, u ? u8.data() : nullptr, u ? v8.data() : nullptr, cw, w, h, out);
    } else {
        to_rgb(conv, depth, (const uint16_t*)y, ys, (const uint16_t*)u, (const uint16_t*)v, cs, w, h, out);
    }
    int mx = (1 << depth) - 1;
    for (int row = 0; row < h; row++) {
        uint8_t* o = out + (size_t)row * w * 4;
        for (int x = 0; x < w; x++) {
            int av = 255;
            if (a && depth == 8) av = ((const uint8_t*)a)[(size_t)row * as + x];
            else if (a) {
                int s = ((const uint16_t*)a)[(size_t)row * as + x];
                av = conv[C_ALPHA_ROUND] ? (s * 255 + mx / 2) / mx : std::min(s >> (depth - 8), 255);
            }
            o[x * 4 + 3] = (uint8_t)av;
        }
    }
    return 0;
}

// A sw x sh plane (src, stride ss) to dw x dh (dst, stride ds) as libavif
// scales a decoded frame to its ispe: samples of `bytes` 1 (uint8_t) or 2
// (uint16_t, libyuv's ScalePlane_16); kScaleRatio for the 3/4 and 3/8
// scales, which are not ported.
int fd_av1_scale(const void* src, int ss, int sw, int sh, void* dst, int ds, int dw, int dh, int bytes) {
    if (!src || !dst || sw <= 0 || sh <= 0 || dw <= 0 || dh <= 0 || ss < sw || ds < dw || bytes < 1 || bytes > 2)
        return kArgs;
    if (bytes == 1) return scale::plane((const uint8_t*)src, ss, sw, sh, (uint8_t*)dst, ds, dw, dh);
    return scale::plane((const uint16_t*)src, ss, sw, sh, (uint16_t*)dst, ds, dw, dh);
}

// A limited-range alpha plane (w x h samples, stride as) to full range in
// place, as libavif 1.3.0 expands the alpha that dav1d returns with
// color_range 0: avifLimitedToFullY's ((v - lo) * full + (hi - lo) / 2) /
// (hi - lo), truncated and clamped to [0, full], with libavif's constants
// of the bit depth bd (8: 16..235 of 255; 10: 64..940 of 1023; 12:
// 256..3760 of 4095); samples are uint8_t at 8 bits, else uint16_t.
int fd_av1_alpha_range(void* a, int as, int w, int h, int bd) {
    if (!a || w <= 0 || h <= 0 || as < w || !valid_depth(bd)) return kArgs;
    int lo = 16 << (bd - 8), hi = 235 << (bd - 8), full = (1 << bd) - 1;
    for (int row = 0; row < h; row++) {
        for (int x = 0; x < w; x++) {
            size_t at = (size_t)row * as + x;
            int v = bd == 8 ? ((uint8_t*)a)[at] : ((uint16_t*)a)[at];
            v = clip3(0, full, ((v - lo) * full + (hi - lo) / 2) / (hi - lo));
            if (bd == 8) ((uint8_t*)a)[at] = (uint8_t)v;
            else ((uint16_t*)a)[at] = (uint16_t)v;
        }
    }
    return 0;
}

// n pixels of premultiplied 8-bit RGBA to straight alpha in place, as
// libyuv's x86 rows (ARGBUnattenuateRow_SSE2 / _AVX2) divide them for
// libavif 1.3.0: alpha kept, each colour c to v = (c * 257 * ia) >> 16, ia
// from libyuv's 8.8 inverse table (0 for alpha 0, 0xffff for 1, 65536 / a
// below 255, 256 for 255), packed as packuswb packs it: the 16-bit v read
// as signed, so 0 from 32768 up (alpha 1 and c >= 128), else min(v, 255).
int fd_av1_unattenuate(uint8_t* rgba, int64_t n) {
    if (!rgba || n < 0) return kArgs;
    for (int64_t i = 0; i < n; i++) {
        uint8_t* p = rgba + i * 4;
        int a = p[3];
        uint32_t ia = a == 0 ? 0 : (a == 1 ? 0xffff : (a == 255 ? 0x100 : 0x10000 / a));
        for (int c = 0; c < 3; c++) {
            uint32_t v = ((uint32_t)p[c] * 257 * ia) >> 16;
            p[c] = (uint8_t)(v >= 32768 ? 0 : std::min<uint32_t>(v, 255));
        }
    }
    return 0;
}

// The stages alone at bit depth bd (8, 10 or 12), samples out as uint16_t.

// CDEF of one block from its window ((h + 4) x (w + 4) samples, -1
// outside the frame; the strengths and damping as the header gives them):
// luma (plane 0, 8x8) searches its direction on the window's centre,
// chroma (4x4, 4 wide and 8 tall for 4:2:2, 8x8 for 4:4:4) maps ydir by
// its size; out gets w * h, dv the direction and variance as the trace
// records them.
int fd_av1_cdef_block(const int32_t* win, int w, int h, int plane, int pri, int sec, int damping, int ydir, int bd,
                      uint16_t* out, int32_t* dv) {
    return cdef_block_at(win, w, h, plane, pri, sec, damping, ydir, bd, out, dv);
}

// The Wiener filter of a w x h block from its window ((h + 6) x (w + 6)):
// taps = the vertical then the horizontal taps 0-2; out gets w * h.
int fd_av1_wiener(const int32_t* win, int w, int h, const int32_t* taps, int bd, uint16_t* out) {
    if (!win || !taps || !out || w <= 0 || h <= 0 || !valid_depth(bd)) return kArgs;
    std::vector<int> v(win, win + (size_t)(w + 6) * (h + 6));
    int t[6];
    for (int i = 0; i < 6; i++) t[i] = taps[i];
    wiener_filter(v.data(), w, h, t, t + 3, out, bd);
    return 0;
}

// The self-guided filter of a w x h block from its window (as
// fd_av1_wiener's) with parameter set `set` and weights xqd[2].
int fd_av1_sgr(const int32_t* win, int w, int h, int set, const int32_t* xqd, int bd, uint16_t* out) {
    if (!win || !xqd || !out || w <= 0 || h <= 0 || set < 0 || set > 15 || !valid_depth(bd)) return kArgs;
    std::vector<int> v(win, win + (size_t)(w + 6) * (h + 6));
    int x[2] = {xqd[0], xqd[1]};
    sgr_filter(v.data(), w, h, set, x, out, bd);
    return 0;
}

// One block's intra prediction: params = {mode, log2W, log2H, haveLeft,
// haveAbove, angleDelta, filterType, edgeFilter, useFilterIntra,
// filterIntraMode, aboveLimit, leftLimit}; above / left hold w + h + 1
// values each, the corner first; pred gets w * h.
int fd_av1_predict(const int32_t* params, const int32_t* above_in, const int32_t* left_in, int bd, uint16_t* pred) {
    PredParams p{params[0], params[1], params[2], params[3], params[4], params[5],
                 params[6], params[7], params[8], params[9], params[10], params[11]};
    if (p.log2W < 2 || p.log2W > 6 || p.log2H < 2 || p.log2H > 6 || !valid_depth(bd)) return kArgs;
    int n = (1 << p.log2W) + (1 << p.log2H);
    int ab[320], lb[320];
    for (int i = 0; i <= n; i++) {
        ab[15 + i] = above_in[i];
        lb[15 + i] = left_in[i];
    }
    predict(p, ab + 16, lb + 16, pred, bd);
    return 0;
}

// CfL on a w x h DC prediction from the averaged luma L (w * h, the
// specification's L[i][j]).
int fd_av1_cfl(const int32_t* L, int w, int h, int alpha, int bd, uint16_t* pred) {
    if (w < 4 || h < 4 || w > 32 || h > 32 || !valid_depth(bd)) return kArgs;
    cfl_apply(L, w, h, alpha, pred, bd);
    return 0;
}

// The inverse transform of tx size `tx` (0-18) and type `type` (0-15):
// deq is 64 x 64 (Dequant[i][j] at i * 64 + j), res gets w * h.
int fd_av1_inv_txfm(const int32_t* deq, int tx, int type, int lossless, int bd, int32_t* res) {
    if (tx < 0 || tx > 18 || type < 0 || type > 15 || !valid_depth(bd)) return kArgs;
    inverse_transform(deq, tx, type, lossless, res, bd);
    return 0;
}

// Film grain (specification 7.18.3, as dav1d 1.5.1 applies it) of a w x h
// frame's planes y, u, v (null for monochrome; strides ys and cs in
// samples; uint8_t at 8 bits, else uint16_t, by G_BITDEPTH) into dy, du, dv
// (copies of them: a plane without grain is left as it is) by the
// parameters g (G_FIELDS; the caller checks that dav1d grains the frame at
// all). templ, when not null, gets the three grain templates (int16_t
// [3][73][82], zeros where a chroma plane takes none), and scal the three
// scaling lookups (uint8_t [3][4096], zeros past the depth's 1 << bd).
int fd_av1_film_grain(const int32_t* g, int w, int h, const void* y, const void* u, const void* v, int ys, int cs,
                      void* dy, void* du, void* dv, int16_t* templ, uint8_t* scal) {
    if (!g || !y || !dy || w <= 0 || h <= 0 || ys < w || !grain_valid(g)) return kArgs;
    int cw = (w + g[G_SSX]) >> g[G_SSX];
    if (!g[G_MONO] && (!u || !v || !du || !dv || cs < cw)) return kArgs;
    std::vector<int16_t> lut((size_t)3 * kGrainH * kGrainW, 0);
    std::vector<uint8_t> scaling((size_t)3 * kScalingSize, 0);
    auto* L = (int16_t (*)[kGrainH][kGrainW])lut.data();
    auto* S = (uint8_t (*)[kScalingSize])scaling.data();
    int st[2] = {ys, cs};
    if (g[G_BITDEPTH] == 8) {
        const uint8_t* src[3] = {(const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v};
        uint8_t* dst[3] = {(uint8_t*)dy, (uint8_t*)du, (uint8_t*)dv};
        film_grain<uint8_t>(g, w, h, src, st, dst, L, S);
    } else {
        const uint16_t* src[3] = {(const uint16_t*)y, (const uint16_t*)u, (const uint16_t*)v};
        uint16_t* dst[3] = {(uint16_t*)dy, (uint16_t*)du, (uint16_t*)dv};
        film_grain<uint16_t>(g, w, h, src, st, dst, L, S);
    }
    if (templ) memcpy(templ, lut.data(), lut.size() * sizeof(int16_t));
    if (scal) memcpy(scal, scaling.data(), scaling.size());
    return 0;
}

// One loop filter position: s holds 16 samples, q0 at s[8]; params =
// {filterSize, plane, limit, blimit, thresh} (at 8 bits); filtered in place.
int fd_av1_lf_edge(int32_t* s, const int32_t* params, int bd) {
    if (!valid_depth(bd)) return kArgs;
    LfParams lp{params[0], params[1], params[2], params[3], params[4]};
    int v[16];
    for (int i = 0; i < 16; i++) v[i] = s[i];
    lf_sample(v + 8, lp, bd);
    for (int i = 0; i < 16; i++) s[i] = v[i];
    return 0;
}

}  // extern "C"
