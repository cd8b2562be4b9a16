// SDF primitives, the atlas sampler and the per-pixel quad evaluator for
// the tile rasterizer (csrc/raster.cu): the device twin of ops/sdf.py and
// ops/quad_eval_planar.py, which port figdraw_tpu/ops/sdf.py, the SDF
// branch of figdraw_tpu/ops/quad_eval_planar.py:56-379 and the atlas
// branch of figdraw_tpu/ops/quad_eval.py:287-335.
//
// One thread evaluates one pixel. Every quad of a block is the same quad for
// all its threads, so each `if` on the mode below is uniform across the
// block and only the family the quad uses is evaluated (the JAX evaluator's
// lax.cond branches). Operation order follows the reference term by term;
// floor-mod is spelled out (never fmodf), and the acos/cbrt substitutes the
// reference computes with are kept.
#pragma once

#include <cuda_runtime.h>

namespace figdraw {

// quad record layout (ops/layout.py)
constexpr int QF_INV_A = 0, QF_INV_B = 1, QF_INV_C = 2, QF_INV_D = 3;
constexpr int QF_ORG_X = 4, QF_ORG_Y = 5;
constexpr int QF_UV3_X = 10, QF_UV3_Y = 11, QF_UVDU_X = 12, QF_UVDU_Y = 13,
              QF_UVDV_X = 14, QF_UVDV_Y = 15;
constexpr int QF_COLOR0 = 16, QF_MID_COLOR = 32, QF_STOP_COLOR = 36;
constexpr int QF_PARAMS = 40, QF_RADII = 44, QF_FACTORS = 48, QF_AA = 50;
constexpr int QF_SUBPIXEL_SHIFT = 51;
constexpr int QF_RECT_PARAMS = 52, QF_RECT_RADII = 56, QF_RECT_MATX = 60,
              QF_RECT_MATY = 64;
constexpr int QF_WIDTH = 68;

// SdfMode (figdraw_tpu/ops/quad_eval.py:48-69)
constexpr int MODE_ATLAS = 0, MODE_MSDF = 13, MODE_MTSDF = 14,
              MODE_MSDF_ANNULAR = 15, MODE_MTSDF_ANNULAR = 16;
constexpr int MODE_DROP_SHADOW = 7, MODE_DROP_SHADOW_AA = 8,
              MODE_INSET_SHADOW = 9, MODE_ANNULAR = 11, MODE_ANNULAR_AA = 12,
              MODE_BACKDROP_BLUR = 17, MODE_BEZIER_ROUND = 18,
              MODE_BEZIER_BUTT = 19, MODE_BEZIER_SQUARE = 20,
              MODE_DROP_SHADOW_LINEAR = 21;

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float sq(float x) { return x * x; }

// jnp.mod for a positive divisor (floor semantics)
__device__ __forceinline__ float floor_mod(float x, float m) {
  return x - floorf(x / m) * m;
}

__device__ __forceinline__ float select_corner(float px, float py, float r_tr,
                                               float r_br, float r_tl,
                                               float r_bl) {
  return px > 0.0f ? (py > 0.0f ? r_tr : r_br) : (py > 0.0f ? r_tl : r_bl);
}

// rounded box, per-quadrant radius (atlas.frag:51-69)
__device__ __forceinline__ float sd_rounded_box(float px, float py, float bx,
                                                float by, float r_tr,
                                                float r_br, float r_tl,
                                                float r_bl) {
  const float rr = select_corner(px, py, r_tr, r_br, r_tl, r_bl);
  const float qx = fabsf(px) - bx + rr;
  const float qy = fabsf(py) - by + rr;
  const float outside = sqrtf(sq(fmaxf(qx, 0.0f)) + sq(fmaxf(qy, 0.0f)));
  return fminf(fmaxf(qx, qy), 0.0f) + outside - rr;
}

// approximate ellipse (atlas.frag:71-79)
__device__ __forceinline__ float sd_ellipse(float px, float py, float rx,
                                            float ry) {
  const float sx = fmaxf(rx, 1e-6f);
  const float sy = fmaxf(ry, 1e-6f);
  const float k0 = sqrtf(sq(px / sx) + sq(py / sy));
  const float k1 = sqrtf(sq(px / (sx * sx)) + sq(py / (sy * sy)));
  const float d = k0 * (k0 - 1.0f) / fmaxf(k1, 1e-6f);
  return k0 <= 1e-6f ? -fminf(sx, sy) : d;
}

// elliptical-corner rounded box with the 12+12-bit packed radii decode
// (atlas.frag:88-115)
__device__ __forceinline__ float sd_elliptical_rounded_box(
    float px, float py, float bx, float by, float r_tr, float r_br,
    float r_tl, float r_bl) {
  const float selected = select_corner(px, py, r_tr, r_br, r_tl, r_bl);
  if (selected < 0.0f) {  // circular corner with radius -v - 1
    const float circ_r = -selected - 1.0f;
    return sd_rounded_box(px, py, bx, by, circ_r, circ_r, circ_r, circ_r);
  }
  // f32 has no x.5 above 2^23, where packed values are exact integers
  const float packed =
      selected >= 8388608.0f ? selected : floorf(selected + 0.5f);
  const float rad_x = floor_mod(packed, 4096.0f) * bx / 4095.0f;
  const float rad_y = floorf(packed / 4096.0f) * by / 4095.0f;
  if (rad_x <= 0.0f || rad_y <= 0.0f) {  // sharp corner
    const float qx0 = fabsf(px) - bx;
    const float qy0 = fabsf(py) - by;
    return fminf(fmaxf(qx0, qy0), 0.0f) +
           sqrtf(sq(fmaxf(qx0, 0.0f)) + sq(fmaxf(qy0, 0.0f)));
  }
  if (rad_x == rad_y)
    return sd_rounded_box(px, py, bx, by, rad_x, rad_x, rad_x, rad_x);
  const float qx = fabsf(px) - bx + rad_x;
  const float qy = fabsf(py) - by + rad_y;
  if (qx > 0.0f && qy > 0.0f) return sd_ellipse(qx, qy, rad_x, rad_y);
  return fmaxf(qx - rad_x, qy - rad_y);
}

// polynomial acos (Abramowitz & Stegun 4.4.45), the reference's substitute
__device__ __forceinline__ float acos_poly(float x) {
  const float xc = fminf(fmaxf(x, -1.0f), 1.0f);
  const float a = fabsf(xc);
  const float poly =
      1.5707288f + a * (-0.2121144f + a * (0.0742610f + a * (-0.0187293f)));
  const float r = sqrtf(fmaxf(1.0f - a, 0.0f)) * poly;
  return xc >= 0.0f ? r : 3.14159265358979f - r;
}

// signed cube root via exp/log, the reference's substitute
__device__ __forceinline__ float cbrt_explog(float x) {
  const float ax = fabsf(x);
  if (ax < 1e-30f) return 0.0f;
  const float r = expf(logf(fmaxf(ax, 1e-30f)) / 3.0f);
  return x > 0.0f ? r : -r;
}

// exact quadratic-bezier distance via the cubic-root solve
// (atlas.frag:121-160)
__device__ __forceinline__ float sd_bezier(float posx, float posy, float ax_,
                                           float ay_, float bx_, float by_,
                                           float cx_, float cy_) {
  const float abx = bx_ - ax_;
  const float aby = by_ - ay_;
  const float bbx = ax_ - 2.0f * bx_ + cx_;
  const float bby = ay_ - 2.0f * by_ + cy_;
  const float bb = bbx * bbx + bby * bby;
  if (bb <= 1e-6f) {  // collinear control point: segment distance
    const float bax = cx_ - ax_;
    const float bay = cy_ - ay_;
    const float seg_h = clip01(((posx - ax_) * bax + (posy - ay_) * bay) /
                               fmaxf(bax * bax + bay * bay, 1e-6f));
    return sqrtf(sq(posx - (ax_ + bax * seg_h)) +
                 sq(posy - (ay_ + bay * seg_h)));
  }
  const float cx2 = abx * 2.0f;
  const float cy2 = aby * 2.0f;
  const float dx = ax_ - posx;
  const float dy = ay_ - posy;
  const float kk = 1.0f / fmaxf(bb, 1e-6f);
  const float kx = kk * (abx * bbx + aby * bby);
  const float ky =
      kk * (2.0f * (abx * abx + aby * aby) + (dx * bbx + dy * bby)) / 3.0f;
  const float kz = kk * (dx * abx + dy * aby);
  const float p = ky - kx * kx;
  const float p3 = p * p * p;
  const float q = kx * (2.0f * kx * kx - 3.0f * ky) + kz;
  const float h = q * q + 4.0f * p3;
  float res;
  if (h >= 0.0f) {  // single root
    const float hs = sqrtf(fmaxf(h, 0.0f));
    const float x1 = (hs - q) / 2.0f;
    const float x2 = (-hs - q) / 2.0f;
    const float t = clip01(cbrt_explog(x1) + cbrt_explog(x2) - kx);
    const float qx = dx + (cx2 + bbx * t) * t;
    const float qy = dy + (cy2 + bby * t) * t;
    res = qx * qx + qy * qy;
  } else {  // two candidate roots; p < 0 so the denominator is negative
    const float z = sqrtf(fmaxf(-p, 1e-12f));
    float denom = p * z * 2.0f;
    if (fabsf(denom) < 1e-12f) denom = -1e-12f;
    const float v = acos_poly(fminf(fmaxf(q / denom, -1.0f), 1.0f)) / 3.0f;
    const float m = cosf(v);
    const float n = sinf(v) * 1.732050808f;
    const float t1 = clip01((m + m) * z - kx);
    const float t2 = clip01((-n - m) * z - kx);
    const float q1x = dx + (cx2 + bbx * t1) * t1;
    const float q1y = dy + (cy2 + bby * t1) * t1;
    const float q2x = dx + (cx2 + bbx * t2) * t2;
    const float q2y = dy + (cy2 + bby * t2) * t2;
    res = fminf(q1x * q1x + q1y * q1y, q2x * q2x + q2y * q2y);
  }
  return sqrtf(fmaxf(res, 0.0f));
}

// gaussian falloff, CSS-like sigma = blur/2 (atlas.frag:211-216)
__device__ __forceinline__ float shadow_profile(float sd, float blur_radius) {
  const float sigma = fmaxf(0.5f * blur_radius, 0.5f);
  const float z = sd / sigma;
  return expf(-0.5f * z * z);
}

__device__ __forceinline__ void norm_or(float vx, float vy, float fbx,
                                        float fby, float& ox, float& oy) {
  const float ln = sqrtf(vx * vx + vy * vy);
  if (ln > 1e-6f) {
    ox = vx / fmaxf(ln, 1e-6f);
    oy = vy / fmaxf(ln, 1e-6f);
  } else {
    ox = fbx;
    oy = fby;
  }
}

// cap trimming for bezier strokes (atlas.frag:179-209)
__device__ __forceinline__ float bezier_stroke_sd(float dist, float posx,
                                                  float posy, float ax_,
                                                  float ay_, float bx_,
                                                  float by_, float cx_,
                                                  float cy_, float half_w,
                                                  int mode) {
  if (mode == MODE_BEZIER_ROUND) return dist - half_w;
  const float chordx = cx_ - ax_;
  const float chordy = cy_ - ay_;
  const float chord_len = sqrtf(chordx * chordx + chordy * chordy);
  const float fx = chord_len <= 1e-6f ? 1.0f : chordx / fmaxf(chord_len, 1e-6f);
  const float fy = chord_len <= 1e-6f ? 0.0f : chordy / fmaxf(chord_len, 1e-6f);
  float stx, sty, etx, ety;
  norm_or(bx_ - ax_, by_ - ay_, fx, fy, stx, sty);
  norm_or(cx_ - bx_, cy_ - by_, fx, fy, etx, ety);
  const float start_proj = (posx - ax_) * stx + (posy - ay_) * sty;
  const float end_proj = (posx - cx_) * etx + (posy - cy_) * ety;
  const bool is_square = mode == MODE_BEZIER_SQUARE;
  const float trim = is_square ? half_w : 0.0f;
  float tube = dist;
  if (is_square && start_proj < 0.0f)
    tube = fminf(tube, fabsf((posx - ax_) * sty - (posy - ay_) * stx));
  if (is_square && end_proj > 0.0f)
    tube = fminf(tube, fabsf((posx - cx_) * ety - (posy - cy_) * etx));
  const float cap_dist = fmaxf(-start_proj - trim, end_proj - trim);
  return fmaxf(tube - half_w, cap_dist);
}

__device__ __forceinline__ float box_dist(bool elliptical, float qx, float qy,
                                          float bx, float by, const float* r) {
  return elliptical
             ? sd_elliptical_rounded_box(qx, qy, bx, by, r[0], r[1], r[2], r[3])
             : sd_rounded_box(qx, qy, bx, by, r[0], r[1], r[2], r[3]);
}

// --- the atlas (S, S, 4) f32, row-major RGBA texels ----------------------------
//
// Sampled in FP32 in software, never by the texture unit: its filter weights
// have 8 fractional bits, which can cost half the 1/255 bound on a hard
// edge. The texel coordinates follow quad_eval.sample_atlas_* op for op,
// with the roundings pinned (__fmul_rn / __fsub_rn): nvcc would contract
// u * S - 0.5 into one FMA, and for nearest sampling a floor that flips at
// an exact texel boundary picks another texel outright.

__device__ __forceinline__ float4 texel(const float4* atlas, int size, int x,
                                        int y) {
  return __ldg(atlas + (size_t)y * size + x);
}

// index of a floored coordinate, clamped as a float first (NaN -> 0)
__device__ __forceinline__ int clamp_index(float c, int size) {
  return (int)fminf(fmaxf(c, 0.0f), (float)(size - 1));
}

// GL_LINEAR, clamp-to-edge: weights from the unclamped floor, taps clamped
__device__ __forceinline__ float4 sample_bilinear(const float4* atlas,
                                                  int size, float u, float v) {
  const float s = (float)size;
  const float tx = __fsub_rn(__fmul_rn(u, s), 0.5f);
  const float ty = __fsub_rn(__fmul_rn(v, s), 0.5f);
  const float x0 = floorf(tx);
  const float y0 = floorf(ty);
  const float fx = tx - x0;
  const float fy = ty - y0;
  const int x0i = clamp_index(x0, size);
  const int y0i = clamp_index(y0, size);
  const int x1i = min(x0i + 1, size - 1);
  const int y1i = min(y0i + 1, size - 1);
  const float4 c00 = texel(atlas, size, x0i, y0i);
  const float4 c10 = texel(atlas, size, x1i, y0i);
  const float4 c01 = texel(atlas, size, x0i, y1i);
  const float4 c11 = texel(atlas, size, x1i, y1i);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  float4 r;
  r.x = (c00.x * gx + c10.x * fx) * gy + (c01.x * gx + c11.x * fx) * fy;
  r.y = (c00.y * gx + c10.y * fx) * gy + (c01.y * gx + c11.y * fx) * fy;
  r.z = (c00.z * gx + c10.z * fx) * gy + (c01.z * gx + c11.z * fx) * fy;
  r.w = (c00.w * gx + c10.w * fx) * gy + (c01.w * gx + c11.w * fx) * fy;
  return r;
}

// GL_NEAREST, clamp-to-edge (pixelate)
__device__ __forceinline__ float4 sample_nearest(const float4* atlas, int size,
                                                 float u, float v) {
  const float s = (float)size;
  return texel(atlas, size, clamp_index(floorf(__fmul_rn(u, s)), size),
               clamp_index(floorf(__fmul_rn(v, s)), size));
}

__device__ __forceinline__ float median3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// fill color at (u, v): flat or bilinear vertex colors (fm 0), or a 3-stop
// gradient (fm 1-4)
__device__ __forceinline__ void fill_color(const float* f, int fm, float u,
                                           float v, float out[4]) {
  const float* c = f + QF_COLOR0;  // vertex order BL, BR, TR, TL
  const float w3 = (1.0f - u) * (1.0f - v);  // TL
  const float w2 = u * (1.0f - v);           // TR
  const float w0 = (1.0f - u) * v;           // BL
  const float w1 = u * v;                    // BR
  if (fm == 0) {
    bool flat = true;
    for (int ch = 0; ch < 4; ++ch)
      flat = flat && c[ch] == c[4 + ch] && c[ch] == c[8 + ch] &&
             c[ch] == c[12 + ch];
    for (int ch = 0; ch < 4; ++ch)
      out[ch] = flat ? c[ch]
                     : c[12 + ch] * w3 + c[8 + ch] * w2 + c[ch] * w0 +
                           c[4 + ch] * w1;
    return;
  }
  float t3 = fm == 1   ? u
             : fm == 2 ? v
             : fm == 3 ? 0.5f * (u + v)
                       : 0.5f * (u + (1.0f - v));
  t3 = clip01(t3);
  const float mid = fminf(fmaxf(f[QF_FACTORS + 1], 0.01f), 0.99f);
  const bool low = t3 <= mid;
  const float lo_t = t3 / mid;
  const float hi_t = (t3 - mid) / (1.0f - mid);
  for (int ch = 0; ch < 4; ++ch) {
    const float vc =
        c[12 + ch] * w3 + c[8 + ch] * w2 + c[ch] * w0 + c[4 + ch] * w1;
    const float mc = f[QF_MID_COLOR + ch];
    const float sc = f[QF_STOP_COLOR + ch];
    out[ch] = low ? vc * (1.0f - lo_t) + mc * lo_t
                  : mc * (1.0f - hi_t) + sc * hi_t;
  }
}

// An atlas-mode quad (0, 13-16) at one pixel (quad_eval.py:287-335): fill
// rgb into out[0..2], the fragment alpha before the rect mask into out[3].
// (rx_, ry_): the pixel center relative to the quad origin; u, v: the
// evaluator's quad parameters (for the fill).
__device__ __forceinline__ void atlas_frag(const float* f, int mode, int fm,
                                           float rx_, float ry_, float u,
                                           float v, const float4* atlas,
                                           int atlas_size, bool pixelate,
                                           bool subpixel, float out[4]) {
  // the uv chain in the plain version's order and roundings
  const float ua = __fadd_rn(__fmul_rn(f[QF_INV_A], rx_),
                             __fmul_rn(f[QF_INV_B], ry_));
  const float va = __fadd_rn(__fmul_rn(f[QF_INV_C], rx_),
                             __fmul_rn(f[QF_INV_D], ry_));
  const float tex_u = __fadd_rn(__fadd_rn(f[QF_UV3_X], __fmul_rn(ua, f[QF_UVDU_X])),
                                __fmul_rn(va, f[QF_UVDV_X]));
  const float tex_v = __fadd_rn(__fadd_rn(f[QF_UV3_Y], __fmul_rn(ua, f[QF_UVDU_Y])),
                                __fmul_rn(va, f[QF_UVDV_Y]));
  if (mode == MODE_ATLAS) {
    // the sample tinted by the vertex color, no SDF alpha
    const float su =
        subpixel ? __fsub_rn(tex_u, __fdiv_rn(f[QF_SUBPIXEL_SHIFT], (float)atlas_size))
                 : tex_u;
    const float4 t = pixelate ? sample_nearest(atlas, atlas_size, su, tex_v)
                              : sample_bilinear(atlas, atlas_size, su, tex_v);
    fill_color(f, 0, u, v, out);
    out[0] *= t.x;
    out[1] *= t.y;
    out[2] *= t.z;
    out[3] *= t.w;
    return;
  }
  // MSDF family: median (13, 15) or alpha (14, 16) distance, solid (13, 14)
  // or stroked (15, 16), over the analytic screenPxRange of the quad's
  // constant uv affine
  const float4 t = pixelate ? sample_nearest(atlas, atlas_size, tex_u, tex_v)
                            : sample_bilinear(atlas, atlas_size, tex_u, tex_v);
  const bool mtsdf = mode == MODE_MTSDF || mode == MODE_MTSDF_ANNULAR;
  const float sd = mtsdf ? t.w : median3(t.x, t.y, t.z);
  const float fw_u = fabsf(f[QF_UVDU_X] * f[QF_INV_A] + f[QF_UVDV_X] * f[QF_INV_C]) +
                     fabsf(f[QF_UVDU_X] * f[QF_INV_B] + f[QF_UVDV_X] * f[QF_INV_D]);
  const float fw_v = fabsf(f[QF_UVDU_Y] * f[QF_INV_A] + f[QF_UVDV_Y] * f[QF_INV_C]) +
                     fabsf(f[QF_UVDU_Y] * f[QF_INV_B] + f[QF_UVDV_Y] * f[QF_INV_D]);
  const float unit_range = f[QF_FACTORS + 0] / (float)atlas_size;
  const float px_range = fmaxf(
      0.5f * (unit_range / fmaxf(fw_u, 1e-9f) + unit_range / fmaxf(fw_v, 1e-9f)),
      1.0f);
  const float dist_px = px_range * (sd - f[QF_FACTORS + 1]);
  const float half_w = fmaxf(f[QF_PARAMS + 1], 0.0f) * 0.5f;
  const float a = (mode == MODE_MSDF_ANNULAR || mode == MODE_MTSDF_ANNULAR)
                      ? clip01(half_w - fabsf(dist_px) + 0.5f)
                      : clip01(dist_px + 0.5f);
  fill_color(f, fm, u, v, out);
  out[3] *= a;
}

// One quad at one pixel center (px, py): straight-alpha fragment with quad
// coverage and rect mask applied. f: the quad's 68 fields. bd: the pixel's
// backdrop RGBA, or nullptr when the pass has no backdrop planes. atlas:
// the (atlas_size, atlas_size) RGBA atlas, or nullptr when the pass samples
// none (atlas-mode quads then evaluate as SDF boxes, as the reference's
// SDF-only evaluator does); pixelate: nearest sampling; subpixel: mode 0
// shifts u by the quad's subpixel shift.
__device__ __forceinline__ void eval_quad(const float* f, int mode_packed,
                                          float px, float py, const float* bd,
                                          float out[4],
                                          const float4* atlas = nullptr,
                                          int atlas_size = 0,
                                          bool pixelate = false,
                                          bool subpixel = false) {
  const int fm = (mode_packed / 256) % 8;  // modes are >= 0
  const int rest = mode_packed % 256;
  const bool elliptical = rest >= 128;
  const int mode = elliptical ? rest - 128 : rest;

  const float rx_ = px - f[QF_ORG_X];
  const float ry_ = py - f[QF_ORG_Y];
  const float u = f[QF_INV_A] * rx_ + f[QF_INV_B] * ry_;
  const float v = f[QF_INV_C] * rx_ + f[QF_INV_D] * ry_;
  // epsilon guard against exact-boundary FP ties (quad_eval.py `inside`)
  if (!(u >= -1e-6f && u <= 1.000001f && v >= -1e-6f && v <= 1.000001f)) {
    out[0] = out[1] = out[2] = out[3] = 0.0f;
    return;
  }

  float fill[4];
  float out_a;
  if (atlas != nullptr &&
      (mode == MODE_ATLAS || (mode >= MODE_MSDF && mode <= MODE_MTSDF_ANNULAR))) {
    atlas_frag(f, mode, fm, rx_, ry_, u, v, atlas, atlas_size, pixelate,
               subpixel, fill);
    out_a = fill[3];
  } else {
    const float quad_hx = f[QF_PARAMS + 0];
    const float quad_hy = f[QF_PARAMS + 1];
    const float p_x = (u - 0.5f) * 2.0f * quad_hx;
    const float p_y = (v - 0.5f) * 2.0f * quad_hy;
    const float* radii = f + QF_RADII;
    const float pz = f[QF_PARAMS + 2];
    const float pw = f[QF_PARAMS + 3];
    const float sdf_factor = f[QF_FACTORS + 0];
    const float factor_y = f[QF_FACTORS + 1];
    const float sdf_spread = fm == 0 ? factor_y : 0.0f;
    const float aa = f[QF_AA];

    float alpha;
    if (mode >= MODE_BEZIER_ROUND && mode <= MODE_BEZIER_SQUARE) {
      const float dist =
          sd_bezier(p_x, p_y, pz, pw, radii[0], radii[1], radii[2], radii[3]);
      const float bez_sd =
          bezier_stroke_sd(dist, p_x, p_y, pz, pw, radii[0], radii[1],
                           radii[2], radii[3], fmaxf(sdf_factor, 0.0f) * 0.5f,
                           mode);
      alpha = 1.0f - clip01(aa * bez_sd + 0.5f);
    } else if (mode == MODE_INSET_SHADOW) {
      const float clip_dist =
          box_dist(elliptical, p_x, -p_y, quad_hx, quad_hy, radii);
      const float shadow_dist =
          box_dist(elliptical, p_x - pz, -p_y + pw, quad_hx, quad_hy, radii);
      const float clip_alpha = 1.0f - clip01(aa * clip_dist + 0.5f);
      const float in_sd = shadow_dist + sdf_spread;
      const float in_prof = fminf(shadow_profile(in_sd, sdf_factor), 1.0f);
      alpha = clip_alpha * (in_sd < 0.0f ? in_prof : 1.0f);
    } else {
      const float dist = box_dist(elliptical, p_x, -p_y, pz, pw, radii);
      const float a_default = 1.0f - clip01(aa * dist + 0.5f);
      if (mode == MODE_DROP_SHADOW || mode == MODE_DROP_SHADOW_AA ||
          mode == MODE_DROP_SHADOW_LINEAR) {
        const float ds_sd = dist - sdf_spread;
        if (mode == MODE_DROP_SHADOW_LINEAR) {
          alpha = ds_sd > 0.0f
                      ? clip01(1.0f - ds_sd / fmaxf(sdf_factor, 1e-6f))
                      : 1.0f;
        } else {
          const float ds_prof = fminf(shadow_profile(ds_sd, sdf_factor), 1.0f);
          if (mode == MODE_DROP_SHADOW)
            alpha = ds_sd > 0.0f ? ds_prof : 1.0f;
          else
            alpha = ds_sd >= 0.0f ? ds_prof : a_default;
        }
      } else if (mode == MODE_ANNULAR || mode == MODE_ANNULAR_AA) {
        const float fhalf = sdf_factor * 0.5f;
        const float ann_sd = fabsf(dist + fhalf) - fhalf;
        alpha = mode == MODE_ANNULAR ? (ann_sd < 0.0f ? 1.0f : 0.0f)
                                     : 1.0f - clip01(aa * ann_sd + 0.5f);
      } else {
        alpha = a_default;
      }
    }

    fill_color(f, fm, u, v, fill);
    out_a = fill[3] * alpha;
    if (bd != nullptr && mode == MODE_BACKDROP_BLUR) {
      fill[0] = bd[0];
      fill[1] = bd[1];
      fill[2] = bd[2];
      out_a = bd[3] * alpha;
    }
  }

  // rect-mask fast path
  const float rm_hx = f[QF_RECT_PARAMS + 2];
  const float rm_hy = f[QF_RECT_PARAMS + 3];
  if (rm_hx >= 0.0f && rm_hy >= 0.0f) {
    const float* mx = f + QF_RECT_MATX;
    const float* my = f + QF_RECT_MATY;
    const float lx = mx[0] * px + mx[1] * py + mx[2];
    const float ly = my[0] * px + my[1] * py + my[2];
    const float qx = lx - f[QF_RECT_PARAMS + 0];
    const float qy = ly - f[QF_RECT_PARAMS + 1];
    const float d = box_dist(my[3] > 0.5f, qx, -qy, fmaxf(rm_hx, 0.0f),
                             fmaxf(rm_hy, 0.0f), f + QF_RECT_RADII);
    out_a = out_a * (1.0f - clip01(f[QF_AA] * d + 0.5f));
  }
  out[0] = fill[0];
  out[1] = fill[1];
  out[2] = fill[2];
  out[3] = out_a;
}

}  // namespace figdraw
