// The packed wire row and what a tile binning needs of a quad, as device
// functions for csrc/binning.cu.
//
// The wire decode replaces figdraw_tpu/executor.py `unpack_combo_device`
// (:181, XLA ops, no Pallas): (N, 52) f32 packed rows -> (N, 68) f32 fields
// and (N, 2) i32 modes, bit for bit (ops/layout.py):
//   packed [0, 16)  -> fields [0, 16)
//   packed [16, 22) -> fields [16, 40): six little-endian u8x4 colour words,
//                      byte k of word w -> column 16 + 4 w + k as k / 255
//   packed [22, 50) -> fields [40, 68)
//   packed [50, 52) -> modes, the words as int32.
// Only the colour bytes are arithmetic: k / 255 through __fdiv_rn, the
// correctly rounded quotient, which is numpy's arange(256) / 255 that the
// plain decode and the JAX package index (a block builds the 256 values in
// shared memory once and looks them up). Every other lane moves as a raw
// 32-bit word, so NaN payloads and the sign of zero pass through.
//
// The quad terms replace the cover tests of figdraw_tpu/ops/binning.py
// `bin_quads` (:35) as ops/binning.bin_quads_plain computes them, once a
// quad instead of once a (tile, quad) pair:
//   * the bbox's tile range: tile tx meets the quad when x0 < (tx+1) w and
//     x1 > tx w, that is floor(x0 / w) <= tx <= ceil(x1 / w) - 1, exact in
//     double for any integer tile size (a float quotient can underflow; a
//     power-of-two size multiplies by its exact reciprocal);
//     NaN gives an empty range, +-inf and values past int16 clamp to the
//     tiles, so the range is four int16;
//   * with culling, the cover rectangle (cx -+ ihx, cy -+ ihy), every step
//     rounded once in the plain version's order (an FMA contraction would
//     move a cover across a tile edge), as its tile range: tile tx is covered
//     when cx - ihx <= tx w + 0.5 and cx + ihx >= (tx+1) w - 0.5, that is
//     ceil((cx - ihx - 0.5) / w) <= tx <= floor((cx + ihx + 0.5) / w) - 1;
//     and (log2 transmittance, opaque).
// A band origin `org_y` (the global row of tile row 0, bin_quads'
// y_offset, :36-42 and :73) moves the tile rows: y ranges are taken of
// y - org_y, exact in double.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace figdraw {

// ops/layout.py
constexpr int QF_WIDTH = 68;
constexpr int PACKED_WIDTH = 52;
constexpr int PACKED_MODES = 50;
constexpr int PACKED_COLOR_WORDS = 16;  // 6 words
constexpr int PACKED_TAIL = 22;         // packed [22, 50) = fields [40, 68)
constexpr int FIELDS_TAIL = 40;
constexpr int QF_INV_B = 1;
constexpr int QF_INV_C = 2;
constexpr int QF_BBOX_X0 = 6;
constexpr int QF_COLOR0 = 16;
constexpr int QF_MID_COLOR = 32;
constexpr int QF_STOP_COLOR = 36;
constexpr int QF_PARAMS = 40;
constexpr int QF_RADII = 44;
constexpr int QF_AA = 50;
constexpr int QF_RECT_PARAMS = 52;

constexpr float LOG2_SAT_EPS = -11.0f;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.minimum and torch.clamp: a NaN operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? nan_f() : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}


// A quad's cover test inputs, from a field row or a packed row.
struct QuadIn {
  float x0, y0, x1, y1;
  float inv_b, inv_c;
  float alpha[6];  // the four vertex colours', then the mid and stop colours'
  float hx, hy;
  float radii[4];
  float aa, rect_pz;
  int mode, mask;
};

__device__ __forceinline__ QuadIn quad_from_fields(const float* f, const int* m) {
  QuadIn q;
  q.x0 = f[QF_BBOX_X0];
  q.y0 = f[QF_BBOX_X0 + 1];
  q.x1 = f[QF_BBOX_X0 + 2];
  q.y1 = f[QF_BBOX_X0 + 3];
  q.inv_b = f[QF_INV_B];
  q.inv_c = f[QF_INV_C];
#pragma unroll
  for (int v = 0; v < 4; v++) q.alpha[v] = f[QF_COLOR0 + 4 * v + 3];
  q.alpha[4] = f[QF_MID_COLOR + 3];
  q.alpha[5] = f[QF_STOP_COLOR + 3];
  q.hx = f[QF_PARAMS + 2];
  q.hy = f[QF_PARAMS + 3];
#pragma unroll
  for (int k = 0; k < 4; k++) q.radii[k] = f[QF_RADII + k];
  q.aa = f[QF_AA];
  q.rect_pz = f[QF_RECT_PARAMS + 2];
  q.mode = m != nullptr ? m[0] : 0;
  q.mask = m != nullptr ? m[1] : 0;
  return q;
}

// field column c >= 40 of a packed row p
__device__ __forceinline__ float packed_tail(const float* p, int c) {
  return p[c - FIELDS_TAIL + PACKED_TAIL];
}

// unit: the 256 values k / 255
__device__ __forceinline__ QuadIn quad_from_packed(const float* p, const float* unit) {
  QuadIn q;
  q.x0 = p[QF_BBOX_X0];
  q.y0 = p[QF_BBOX_X0 + 1];
  q.x1 = p[QF_BBOX_X0 + 2];
  q.y1 = p[QF_BBOX_X0 + 3];
  q.inv_b = p[QF_INV_B];
  q.inv_c = p[QF_INV_C];
  // colour column 16 + 4 w + 3 is byte 3 of word w: the four vertex
  // colours are words 0-3, the mid colour word 4, the stop colour word 5
#pragma unroll
  for (int w = 0; w < 6; w++)
    q.alpha[w] = unit[__float_as_uint(p[PACKED_COLOR_WORDS + w]) >> 24];
  q.hx = packed_tail(p, QF_PARAMS + 2);
  q.hy = packed_tail(p, QF_PARAMS + 3);
#pragma unroll
  for (int k = 0; k < 4; k++) q.radii[k] = packed_tail(p, QF_RADII + k);
  q.aa = packed_tail(p, QF_AA);
  q.rect_pz = packed_tail(p, QF_RECT_PARAMS + 2);
  q.mode = __float_as_int(p[PACKED_MODES]);
  q.mask = __float_as_int(p[PACKED_MODES + 1]);
  return q;
}

// What the tile kernel reads of a quad with culling: the cover rectangle's
// tile range (empty for a quad that can never cover), lt = log2(max(1 -
// a_min, 2^-24)) and whether it is opaque (a_min >= 1); 16 bytes.
struct __align__(16) CoverTerm {
  short4 range;
  float lt;
  int opaque;
};

// t as a tile index clamped to [0, tiles - 1], so that it fits int16
// (tiles <= 32767)
__device__ __forceinline__ short clamp_tile(double t, int tiles) {
  return (short)(t < 0.0 ? 0.0 : t > (double)(tiles - 1) ? (double)(tiles - 1) : t);
}

// v / size, exact: v * inv when inv (1 / size, a power of two) is given
__device__ __forceinline__ double over(double v, int size, double inv) {
  return inv != 0.0 ? v * inv : v / (double)size;
}

// [first, last] of the tiles t in [a, b] clamped to [0, tiles - 1]; (1, 0)
// when there is none (NaN fails a <= b)
__device__ __forceinline__ void clamp_span(double a, double b, int tiles, short& first,
                                           short& last) {
  if (!(a <= b) || b < 0.0 || a > (double)(tiles - 1)) {
    first = 1;
    last = 0;
    return;
  }
  first = clamp_tile(a, tiles);
  last = clamp_tile(b, tiles);
}

// the tiles [floor((lo - org) / size), ceil((hi - org) / size) - 1] that a
// span (lo, hi) meets, tile 0 starting at org
__device__ __forceinline__ void span_tiles(float lo, float hi, double org, int size,
                                           double inv, int tiles, short& first,
                                           short& last) {
  clamp_span(floor(over((double)lo - org, size, inv)),
             ceil(over((double)hi - org, size, inv)) - 1.0, tiles, first, last);
}

// the tiles t with lo <= org + t size + 0.5 and hi >= org + (t + 1) size - 0.5
__device__ __forceinline__ void cover_tiles(float lo, float hi, double org, int size,
                                            double inv, int tiles, short& first,
                                            short& last) {
  clamp_span(ceil(over((double)lo - org - 0.5, size, inv)),
             floor(over((double)hi - org + 0.5, size, inv)) - 1.0, tiles, first, last);
}

__device__ __forceinline__ short4 bbox_tiles(const QuadIn& q, int tiles_x, int tiles_y,
                                             int tile_w, int tile_h, double inv_w,
                                             double inv_h, double org_y) {
  short4 r;
  span_tiles(q.x0, q.x1, 0.0, tile_w, inv_w, tiles_x, r.x, r.z);
  span_tiles(q.y0, q.y1, org_y, tile_h, inv_h, tiles_y, r.y, r.w);
  if (r.x > r.z || r.y > r.w) r = make_short4(1, 1, 0, 0);  // no tile
  return r;
}

// ops/binning.bin_quads_plain :65-132, once a quad
__device__ __forceinline__ CoverTerm cover_term(const QuadIn& q, int tiles_x, int tiles_y,
                                                int tile_w, int tile_h, double inv_w,
                                                double inv_h, double org_y) {
  const int rest = q.mode & 255;      // torch.remainder(m, 256)
  const int fill_mode = q.mode >> 8;  // floor division by 256
  float a_min = min_nan(min_nan(q.alpha[0], q.alpha[1]), min_nan(q.alpha[2], q.alpha[3]));
  if (fill_mode != 0) a_min = min_nan(a_min, min_nan(q.alpha[4], q.alpha[5]));
  const bool elliptical = rest >= 128;
  // elliptical corners carry 12+12-bit packed (x, y) radii; negative is a
  // circular radius -v-1. A NaN radius fails radii_ok, so the maxima need
  // not propagate NaN.
  float max_r = 0.0f, rx_max = 0.0f, ry_max = 0.0f;
  bool circ_ok = true, ell_ok = true;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const float r = q.radii[k];
    const float circ = __fsub_rn(-r, 1.0f);
    const float pk = r >= 8388608.0f ? r : floorf(__fadd_rn(r, 0.5f));
    // pk is a whole number >= 0 (or inf, NaN), so pk / 4096 is exact and so
    // is pk mod 4096 = pk - 4096 floor(pk / 4096) (fmodf's value, NaN for inf)
    const float hi12 = floorf(__fmul_rn(pk, 0x1p-12f));
    const float lo12 = __fsub_rn(pk, __fmul_rn(hi12, 4096.0f));
    const float rx = r < 0.0f ? circ : __fdiv_rn(__fmul_rn(lo12, q.hx), 4095.0f);
    const float ry = r < 0.0f ? circ : __fdiv_rn(__fmul_rn(hi12, q.hy), 4095.0f);
    max_r = k == 0 ? r : fmaxf(max_r, r);
    rx_max = k == 0 ? rx : fmaxf(rx_max, rx);
    ry_max = k == 0 ? ry : fmaxf(ry_max, ry);
    circ_ok = circ_ok && r >= 0.0f;
    ell_ok = ell_ok && rx >= 0.0f && ry >= 0.0f;
  }
  const float inset_x = elliptical ? rx_max : max_r;
  const float inset_y = elliptical ? ry_max : max_r;
  const float margin = __fadd_rn(__fdiv_rn(0.5f, max_nan(q.aa, 1e-3f)), 0.01f);
  const float ihx = __fsub_rn(__fsub_rn(q.hx, inset_x), margin);
  const float ihy = __fsub_rn(__fsub_rn(q.hy, inset_y), margin);
  const bool coverer = (rest & 127) == 3 && q.mask == 0 && q.inv_b == 0.0f &&
                       q.inv_c == 0.0f && q.rect_pz < 0.0f &&
                       (elliptical ? ell_ok : circ_ok) && ihx > 0.0f && ihy > 0.0f;
  CoverTerm t;
  t.range = make_short4(1, 1, 0, 0);
  t.lt = 0.0f;
  t.opaque = 0;
  if (coverer) {
    // axis-aligned: the bbox center is the shape center
    const float cx = __fmul_rn(__fadd_rn(q.x0, q.x1), 0.5f);
    const float cy = __fmul_rn(__fadd_rn(q.y0, q.y1), 0.5f);
    short4 r;
    cover_tiles(__fsub_rn(cx, ihx), __fadd_rn(cx, ihx), 0.0, tile_w, inv_w, tiles_x, r.x,
                r.z);
    cover_tiles(__fsub_rn(cy, ihy), __fadd_rn(cy, ihy), org_y, tile_h, inv_h, tiles_y, r.y,
                r.w);
    if (r.x <= r.z && r.y <= r.w) {
      t.range = r;
      t.lt = log2f(max_nan(__fsub_rn(1.0f, a_min), 0x1p-24f));
      t.opaque = a_min >= 1.0f;
    }
  }
  return t;
}

__device__ __forceinline__ bool in_range(short4 r, int tx, int ty) {
  return tx >= r.x && tx <= r.z && ty >= r.y && ty <= r.w;
}

// whether a non-empty cover range lies outside the bbox range: then a tile
// may be covered by a quad that does not meet it (never for the walks'
// quads, whose cover rectangle is inside their bbox)
__device__ __forceinline__ bool cover_outside(short4 c, short4 b) {
  return c.x <= c.z && (c.x < b.x || c.z > b.z || c.y < b.y || c.w > b.w);
}

}  // namespace figdraw
