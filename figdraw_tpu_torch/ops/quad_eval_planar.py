"""Quad fragment evaluation over a pixel grid, in plain torch
(figdraw_tpu/ops/quad_eval_planar.py:56-379, the SDF branch).

The JAX evaluator picks its SDF family with scalar `lax.cond` branches; here
every family is evaluated and `torch.where` selects, which gives the same
values (the unselected side is discarded, NaNs included) and lets one call
evaluate many quads at once: fields and modes broadcast against the pixel
grid (a (n, 1, 1) per-quad column against (n, th, tw) pixels). The branches
that change values, not only speed, are kept as selects: flat versus
bilinear vertex fill, elliptical versus circular boxes, the rect mask's
elliptical flag and the ±1e-6 `inside` guard. Atlas modes (0, 13-16) are not
part of the slice. csrc/sdf.cuh is the CUDA twin.
"""

from __future__ import annotations

import torch

from . import sdf
from .layout import (
    QF_AA,
    QF_COLOR0,
    QF_FACTORS,
    QF_INV_A,
    QF_INV_B,
    QF_INV_C,
    QF_INV_D,
    QF_MID_COLOR,
    QF_ORG_X,
    QF_ORG_Y,
    QF_PARAMS,
    QF_RADII,
    QF_RECT_MATX,
    QF_RECT_MATY,
    QF_RECT_PARAMS,
    QF_RECT_RADII,
    QF_STOP_COLOR,
)

# SdfMode constants (figdraw_tpu/ops/quad_eval.py:48-69)
MODE_CLIP_AA = 3
MODE_DROP_SHADOW = 7
MODE_DROP_SHADOW_AA = 8
MODE_INSET_SHADOW = 9
MODE_ANNULAR = 11
MODE_ANNULAR_AA = 12
MODE_BACKDROP_BLUR = 17
MODE_BEZIER_ROUND = 18
MODE_BEZIER_BUTT = 19
MODE_BEZIER_SQUARE = 20
MODE_DROP_SHADOW_LINEAR = 21  # legacy linear shadow falloff (golden pin)


def eval_quad_planar(fget, mode_packed, px, py, backdrop_planes=None):
    """Evaluate SDF quads over pixel grids.

    fget(k) -> f32 tensor of field k (ops/layout.py offsets), broadcastable
    against px. mode_packed: i32 tensor broadcastable the same way (mode +
    128*elliptical + 256*fill_mode). px, py: pixel-center grids.
    backdrop_planes: optional 4-tuple of planes read by mode 17.

    Returns (r, g, b, a): straight-alpha fragment planes with quad coverage
    and rect mask applied.
    """
    fm = torch.remainder(torch.div(mode_packed, 256, rounding_mode="floor"), 8)
    rest = torch.remainder(mode_packed, 256)
    elliptical = rest >= 128
    mode = torch.where(elliptical, rest - 128, rest)

    ox = fget(QF_ORG_X)
    oy = fget(QF_ORG_Y)
    rx_ = px - ox
    ry_ = py - oy
    u = fget(QF_INV_A) * rx_ + fget(QF_INV_B) * ry_
    v = fget(QF_INV_C) * rx_ + fget(QF_INV_D) * ry_
    # epsilon guard against exact-boundary FP ties (quad_eval.py `inside`)
    inside = (u >= -1e-6) & (u <= 1.0 + 1e-6) & (v >= -1e-6) & (v <= 1.0 + 1e-6)

    quad_hx = fget(QF_PARAMS + 0)
    quad_hy = fget(QF_PARAMS + 1)
    p_x = (u - 0.5) * 2.0 * quad_hx
    p_y = (v - 0.5) * 2.0 * quad_hy

    r_tr = fget(QF_RADII + 0)
    r_br = fget(QF_RADII + 1)
    r_tl = fget(QF_RADII + 2)
    r_bl = fget(QF_RADII + 3)
    pz = fget(QF_PARAMS + 2)
    pw = fget(QF_PARAMS + 3)

    sdf_factor = fget(QF_FACTORS + 0)
    factor_y = fget(QF_FACTORS + 1)
    sdf_spread = torch.where(fm == 0, factor_y, 0.0)
    aa = fget(QF_AA)

    is_bezier = (mode >= MODE_BEZIER_ROUND) & (mode <= MODE_BEZIER_SQUARE)
    is_inset = mode == MODE_INSET_SHADOW

    def box_dist(qx, qy, bx, by):
        return torch.where(
            elliptical,
            sdf.sd_elliptical_rounded_box(qx, qy, bx, by, r_tr, r_br, r_tl, r_bl),
            sdf.sd_rounded_box(qx, qy, bx, by, r_tr, r_br, r_tl, r_bl),
        )

    # --- alpha: box family / inset / bezier --------------------------------------
    dist = box_dist(p_x, -p_y, pz, pw)
    cl = torch.clamp(aa * dist + 0.5, 0.0, 1.0)
    a_default = 1.0 - cl
    # shadow family
    ds_sd = dist - sdf_spread
    ds_prof = torch.clamp(sdf.shadow_profile(ds_sd, sdf_factor), max=1.0)
    a_drop = torch.where(ds_sd > 0.0, ds_prof, 1.0)
    a_drop_aa = torch.where(ds_sd >= 0.0, ds_prof, a_default)
    ds_lin = torch.clamp(
        1.0 - ds_sd / torch.clamp(sdf_factor, min=1e-6), 0.0, 1.0
    )
    a_lin = torch.where(ds_sd > 0.0, ds_lin, 1.0)
    a_shadow = torch.where(mode == MODE_DROP_SHADOW, a_drop, a_drop_aa)
    a_shadow = torch.where(mode == MODE_DROP_SHADOW_LINEAR, a_lin, a_shadow)
    # plain fills and annular strokes
    fhalf = sdf_factor * 0.5
    ann_sd = torch.abs(dist + fhalf) - fhalf
    a_ann = torch.where(ann_sd < 0.0, 1.0, 0.0)
    a_ann_aa = 1.0 - torch.clamp(aa * ann_sd + 0.5, 0.0, 1.0)
    a_plain = torch.where(mode == MODE_ANNULAR, a_ann, a_default)
    a_plain = torch.where(mode == MODE_ANNULAR_AA, a_ann_aa, a_plain)
    is_shadow = (
        (mode == MODE_DROP_SHADOW)
        | (mode == MODE_DROP_SHADOW_AA)
        | (mode == MODE_DROP_SHADOW_LINEAR)
    )
    alpha_box = torch.where(is_shadow, a_shadow, a_plain)

    # inset shadow: clip to the quad's own box, gaussian of the offset box
    qx_s = p_x - pz
    qy_s = -p_y + pw
    clip_dist = box_dist(p_x, -p_y, quad_hx, quad_hy)
    shadow_dist = box_dist(qx_s, qy_s, quad_hx, quad_hy)
    clip_alpha = 1.0 - torch.clamp(aa * clip_dist + 0.5, 0.0, 1.0)
    in_sd = shadow_dist + sdf_spread
    in_prof = torch.clamp(sdf.shadow_profile(in_sd, sdf_factor), max=1.0)
    inset_a = torch.where(in_sd < 0.0, in_prof, 1.0)
    alpha_inset = clip_alpha * inset_a

    # quadratic bezier stroke with caps
    bez_dist = sdf.sd_bezier(p_x, p_y, pz, pw, r_tr, r_br, r_tl, r_bl)
    bez_sd = sdf.bezier_stroke_sd(
        bez_dist, p_x, p_y, pz, pw, r_tr, r_br, r_tl, r_bl,
        torch.clamp(sdf_factor, min=0.0) * 0.5,
        mode, MODE_BEZIER_ROUND, MODE_BEZIER_BUTT, MODE_BEZIER_SQUARE,
    )
    alpha_bezier = 1.0 - torch.clamp(aa * bez_sd + 0.5, 0.0, 1.0)

    alpha = torch.where(is_bezier, alpha_bezier,
                        torch.where(is_inset, alpha_inset, alpha_box))

    # --- fill color (vertex flat/bilinear, or 3-stop gradient) -------------------
    w3 = (1.0 - u) * (1.0 - v)  # TL (c3)
    w2 = u * (1.0 - v)  # TR (c2)
    w0 = (1.0 - u) * v  # BL (c0)
    w1 = u * v  # BR (c1)

    def vert_channel(ch):
        return (
            fget(QF_COLOR0 + 12 + ch) * w3
            + fget(QF_COLOR0 + 8 + ch) * w2
            + fget(QF_COLOR0 + 0 + ch) * w0
            + fget(QF_COLOR0 + 4 + ch) * w1
        )

    # equal corners (the typical solid fill) take the corner color as is
    const = None
    for ch in range(4):
        c0 = fget(QF_COLOR0 + ch)
        eq = (
            (c0 == fget(QF_COLOR0 + 4 + ch))
            & (c0 == fget(QF_COLOR0 + 8 + ch))
            & (c0 == fget(QF_COLOR0 + 12 + ch))
        )
        const = eq if const is None else const & eq

    t3 = torch.where(
        fm == 1, u,
        torch.where(fm == 2, v,
                    torch.where(fm == 3, 0.5 * (u + v), 0.5 * (u + (1.0 - v)))),
    )
    t3 = torch.clamp(t3, 0.0, 1.0)
    mid = torch.clamp(factor_y, 0.01, 0.99)
    lo_t = t3 / mid
    hi_t = (t3 - mid) / (1.0 - mid)
    low = t3 <= mid

    out = []
    for ch in range(4):
        vc = vert_channel(ch)
        vertex = torch.where(const, fget(QF_COLOR0 + ch), vc)
        mc = fget(QF_MID_COLOR + ch)
        sc = fget(QF_STOP_COLOR + ch)
        grad = torch.where(
            low, vc * (1.0 - lo_t) + mc * lo_t, mc * (1.0 - hi_t) + sc * hi_t
        )
        out.append(torch.where(fm == 0, vertex, grad))
    out_r, out_g, out_b, fa = out
    out_a = fa * alpha

    if backdrop_planes is not None:
        is_bd = mode == MODE_BACKDROP_BLUR
        br, bg, bb, ba = backdrop_planes
        out_r = torch.where(is_bd, br, out_r)
        out_g = torch.where(is_bd, bg, out_g)
        out_b = torch.where(is_bd, bb, out_b)
        out_a = torch.where(is_bd, ba * alpha, out_a)

    # --- rect-mask fast path ----------------------------------------------------
    rm_hx = fget(QF_RECT_PARAMS + 2)
    rm_hy = fget(QF_RECT_PARAMS + 3)
    rm_enabled = (rm_hx >= 0.0) & (rm_hy >= 0.0)
    lx = (fget(QF_RECT_MATX + 0) * px + fget(QF_RECT_MATX + 1) * py
          + fget(QF_RECT_MATX + 2))
    ly = (fget(QF_RECT_MATY + 0) * px + fget(QF_RECT_MATY + 1) * py
          + fget(QF_RECT_MATY + 2))
    qx = lx - fget(QF_RECT_PARAMS + 0)
    qy = ly - fget(QF_RECT_PARAMS + 1)
    hx = torch.clamp(rm_hx, min=0.0)
    hy = torch.clamp(rm_hy, min=0.0)
    rt, rb, rtl, rbl = (fget(QF_RECT_RADII + k) for k in range(4))
    d = torch.where(
        fget(QF_RECT_MATY + 3) > 0.5,
        sdf.sd_elliptical_rounded_box(qx, -qy, hx, hy, rt, rb, rtl, rbl),
        sdf.sd_rounded_box(qx, -qy, hx, hy, rt, rb, rtl, rbl),
    )
    rm_alpha = torch.where(
        rm_enabled, 1.0 - torch.clamp(aa * d + 0.5, 0.0, 1.0), 1.0
    )
    out_a = out_a * rm_alpha

    out_a = torch.where(inside, out_a, 0.0)
    return out_r, out_g, out_b, out_a
