"""Quad fragment evaluation over a pixel grid, in plain torch: the SDF
branch of figdraw_tpu/ops/quad_eval_planar.py:56-379 and the atlas branch
of figdraw_tpu/ops/quad_eval.py:287-335.

The JAX evaluator picks its SDF family with scalar `lax.cond` branches; here
the families the batch uses are evaluated and `torch.where` selects, which
gives the same values (the unselected side is discarded, NaNs included) and
lets one call evaluate many quads at once: fields and modes broadcast
against the pixel grid (a (n, 1, 1) per-quad column against (n, th, tw)
pixels). A family no quad of the batch uses is not computed at all. The
branches that change values, not only speed, are kept as selects: flat
versus bilinear vertex fill, elliptical versus circular boxes, the rect
mask's elliptical flag and the ±1e-6 `inside` guard. csrc/sdf.cuh is the
CUDA twin.
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
    QF_SUBPIXEL_SHIFT,
    QF_UV3_X,
    QF_UV3_Y,
    QF_UVDU_X,
    QF_UVDU_Y,
    QF_UVDV_X,
    QF_UVDV_Y,
)

# SdfMode constants (figdraw_tpu/ops/quad_eval.py:48-69)
MODE_ATLAS = 0
MODE_CLIP_AA = 3
MODE_DROP_SHADOW = 7
MODE_DROP_SHADOW_AA = 8
MODE_INSET_SHADOW = 9
MODE_ANNULAR = 11
MODE_ANNULAR_AA = 12
MODE_MSDF = 13
MODE_MTSDF = 14
MODE_MSDF_ANNULAR = 15
MODE_MTSDF_ANNULAR = 16
MODE_BACKDROP_BLUR = 17
MODE_BEZIER_ROUND = 18
MODE_BEZIER_BUTT = 19
MODE_BEZIER_SQUARE = 20
MODE_DROP_SHADOW_LINEAR = 21  # legacy linear shadow falloff (golden pin)


def _any(mask) -> bool:
    return bool(torch.as_tensor(mask).any())


def sample_atlas_bilinear(atlas, u, v):
    """GL_LINEAR, clamp-to-edge sample of the (S, S, 4) f32 atlas at
    normalized (u, v) (quad_eval.sample_atlas_bilinear): the weights come
    from the unclamped floor, the taps are clamped. Returns u.shape + (4,)."""
    size = atlas.shape[0]
    tx = u * size - 0.5
    ty = v * size - 0.5
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    fx = (tx - x0)[..., None]
    fy = (ty - y0)[..., None]
    # clamped as floats, then converted: the same texels as the reference's
    # convert-then-clip for every representable index
    x0i = torch.clamp(x0, 0, size - 1).long()
    y0i = torch.clamp(y0, 0, size - 1).long()
    x1i = torch.clamp(x0i + 1, max=size - 1)
    y1i = torch.clamp(y0i + 1, max=size - 1)
    flat = atlas.reshape(-1, 4)
    c00 = flat[y0i * size + x0i]
    c10 = flat[y0i * size + x1i]
    c01 = flat[y1i * size + x0i]
    c11 = flat[y1i * size + x1i]
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_atlas_nearest(atlas, u, v):
    """GL_NEAREST, clamp-to-edge (the pixelate mag filter,
    quad_eval.sample_atlas_nearest). Returns u.shape + (4,)."""
    size = atlas.shape[0]
    xi = torch.clamp(torch.floor(u * size), 0, size - 1).long()
    yi = torch.clamp(torch.floor(v * size), 0, size - 1).long()
    return atlas.reshape(-1, 4)[yi * size + xi]


def eval_quad_planar(fget, mode_packed, px, py, backdrop_planes=None,
                     atlas=None, pixelate: bool = False,
                     subpixel_positioning: bool = False):
    """Evaluate quads over pixel grids.

    fget(k) -> f32 tensor of field k (ops/layout.py offsets), broadcastable
    against px. mode_packed: i32 tensor broadcastable the same way (mode +
    128*elliptical + 256*fill_mode). px, py: pixel-center grids.
    backdrop_planes: optional 4-tuple of planes read by mode 17.
    atlas: optional (S, S, 4) f32 atlas sampled by modes 0 and 13-16
    (without it they evaluate as SDF boxes, as the reference's SDF-only
    evaluator does); pixelate: nearest instead of bilinear sampling;
    subpixel_positioning: mode 0 shifts u by the quad's subpixel shift.

    Returns (r, g, b, a): straight-alpha fragment planes with quad coverage
    and rect mask applied.
    """
    fm = torch.remainder(torch.div(mode_packed, 256, rounding_mode="floor"), 8)
    rest = torch.remainder(mode_packed, 256)
    elliptical = rest >= 128
    mode = torch.where(elliptical, rest - 128, rest)
    any_ell = _any(elliptical)

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
        circ = sdf.sd_rounded_box(qx, qy, bx, by, r_tr, r_br, r_tl, r_bl)
        if not any_ell:
            return circ
        return torch.where(
            elliptical,
            sdf.sd_elliptical_rounded_box(qx, qy, bx, by, r_tr, r_br, r_tl, r_bl),
            circ,
        )

    # --- alpha: box family / inset / bezier --------------------------------------
    dist = box_dist(p_x, -p_y, pz, pw)
    cl = torch.clamp(aa * dist + 0.5, 0.0, 1.0)
    a_default = 1.0 - cl
    alpha_box = a_default
    is_shadow = (
        (mode == MODE_DROP_SHADOW)
        | (mode == MODE_DROP_SHADOW_AA)
        | (mode == MODE_DROP_SHADOW_LINEAR)
    )
    is_annular = (mode == MODE_ANNULAR) | (mode == MODE_ANNULAR_AA)
    if _any(is_annular):
        fhalf = sdf_factor * 0.5
        ann_sd = torch.abs(dist + fhalf) - fhalf
        a_ann = torch.where(ann_sd < 0.0, 1.0, 0.0)
        a_ann_aa = 1.0 - torch.clamp(aa * ann_sd + 0.5, 0.0, 1.0)
        alpha_box = torch.where(mode == MODE_ANNULAR, a_ann, alpha_box)
        alpha_box = torch.where(mode == MODE_ANNULAR_AA, a_ann_aa, alpha_box)
    if _any(is_shadow):
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
        alpha_box = torch.where(is_shadow, a_shadow, alpha_box)
    alpha = alpha_box

    if _any(is_inset):
        # inset shadow: clip to the quad's own box, gaussian of the offset box
        qx_s = p_x - pz
        qy_s = -p_y + pw
        clip_dist = box_dist(p_x, -p_y, quad_hx, quad_hy)
        shadow_dist = box_dist(qx_s, qy_s, quad_hx, quad_hy)
        clip_alpha = 1.0 - torch.clamp(aa * clip_dist + 0.5, 0.0, 1.0)
        in_sd = shadow_dist + sdf_spread
        in_prof = torch.clamp(sdf.shadow_profile(in_sd, sdf_factor), max=1.0)
        inset_a = torch.where(in_sd < 0.0, in_prof, 1.0)
        alpha = torch.where(is_inset, clip_alpha * inset_a, alpha)

    if _any(is_bezier):
        # quadratic bezier stroke with caps
        bez_dist = sdf.sd_bezier(p_x, p_y, pz, pw, r_tr, r_br, r_tl, r_bl)
        bez_sd = sdf.bezier_stroke_sd(
            bez_dist, p_x, p_y, pz, pw, r_tr, r_br, r_tl, r_bl,
            torch.clamp(sdf_factor, min=0.0) * 0.5,
            mode, MODE_BEZIER_ROUND, MODE_BEZIER_BUTT, MODE_BEZIER_SQUARE,
        )
        alpha_bezier = 1.0 - torch.clamp(aa * bez_sd + 0.5, 0.0, 1.0)
        alpha = torch.where(is_bezier, alpha_bezier, alpha)

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

    gradient = _any(fm != 0)
    if gradient:
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

    vertex = []
    fill = []
    for ch in range(4):
        vc = vert_channel(ch)
        vertex.append(torch.where(const, fget(QF_COLOR0 + ch), vc))
        if not gradient:
            fill.append(vertex[ch])
            continue
        mc = fget(QF_MID_COLOR + ch)
        sc = fget(QF_STOP_COLOR + ch)
        grad = torch.where(
            low, vc * (1.0 - lo_t) + mc * lo_t, mc * (1.0 - hi_t) + sc * hi_t
        )
        fill.append(torch.where(fm == 0, vertex[ch], grad))
    out_r, out_g, out_b, fa = fill
    out_a = fa * alpha

    # --- atlas modes (quad_eval.py:287-335) ----------------------------------------
    if atlas is not None:
        is_atlas = mode == MODE_ATLAS
        is_msdf = (mode >= MODE_MSDF) & (mode <= MODE_MTSDF_ANNULAR)
        any_atlas, any_msdf = _any(is_atlas), _any(is_msdf)
        size = atlas.shape[0]
        sample = sample_atlas_nearest if pixelate else sample_atlas_bilinear
        if any_atlas or any_msdf:
            tex_u = fget(QF_UV3_X) + u * fget(QF_UVDU_X) + v * fget(QF_UVDV_X)
            tex_v = fget(QF_UV3_Y) + u * fget(QF_UVDU_Y) + v * fget(QF_UVDV_Y)
        if any_atlas:
            # mode 0: the sample tinted by the vertex color, no SDF alpha
            au = tex_u
            if subpixel_positioning:
                au = au - fget(QF_SUBPIXEL_SHIFT) / size
            tex = sample(atlas, au, tex_v)
            out_r = torch.where(is_atlas, tex[..., 0] * vertex[0], out_r)
            out_g = torch.where(is_atlas, tex[..., 1] * vertex[1], out_g)
            out_b = torch.where(is_atlas, tex[..., 2] * vertex[2], out_b)
            out_a = torch.where(is_atlas, tex[..., 3] * vertex[3], out_a)
        if any_msdf:
            # modes 13-16: multi-channel (median) or true (alpha) distance,
            # the analytic screenPxRange from the quad's constant affine,
            # solid or stroked, times the fill color
            tex0 = sample(atlas, tex_u, tex_v)
            is_mtsdf = (mode == MODE_MTSDF) | (mode == MODE_MTSDF_ANNULAR)
            is_stroke = (mode == MODE_MSDF_ANNULAR) | (mode == MODE_MTSDF_ANNULAR)
            sd = torch.where(
                is_mtsdf, tex0[..., 3],
                sdf.median3(tex0[..., 0], tex0[..., 1], tex0[..., 2]))
            du_x, dv_x = fget(QF_UVDU_X), fget(QF_UVDV_X)
            du_y, dv_y = fget(QF_UVDU_Y), fget(QF_UVDV_Y)
            inv_a, inv_b = fget(QF_INV_A), fget(QF_INV_B)
            inv_c, inv_d = fget(QF_INV_C), fget(QF_INV_D)
            fw_u = (torch.abs(du_x * inv_a + dv_x * inv_c)
                    + torch.abs(du_x * inv_b + dv_x * inv_d))
            fw_v = (torch.abs(du_y * inv_a + dv_y * inv_c)
                    + torch.abs(du_y * inv_b + dv_y * inv_d))
            unit_range = sdf_factor / size
            screen_px_range = torch.clamp(
                0.5 * (unit_range / torch.clamp(fw_u, min=1e-9)
                       + unit_range / torch.clamp(fw_v, min=1e-9)),
                min=1.0)
            dist_px = screen_px_range * (sd - factor_y)
            half_w = torch.clamp(quad_hy, min=0.0) * 0.5
            a_stroke = torch.clamp(half_w - torch.abs(dist_px) + 0.5, 0.0, 1.0)
            a_solid = torch.clamp(dist_px + 0.5, 0.0, 1.0)
            msdf_alpha = torch.where(is_stroke, a_stroke, a_solid)
            out_r = torch.where(is_msdf, fill[0], out_r)
            out_g = torch.where(is_msdf, fill[1], out_g)
            out_b = torch.where(is_msdf, fill[2], out_b)
            out_a = torch.where(is_msdf, fa * msdf_alpha, out_a)

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
    if _any(rm_enabled):
        lx = (fget(QF_RECT_MATX + 0) * px + fget(QF_RECT_MATX + 1) * py
              + fget(QF_RECT_MATX + 2))
        ly = (fget(QF_RECT_MATY + 0) * px + fget(QF_RECT_MATY + 1) * py
              + fget(QF_RECT_MATY + 2))
        qx = lx - fget(QF_RECT_PARAMS + 0)
        qy = ly - fget(QF_RECT_PARAMS + 1)
        hx = torch.clamp(rm_hx, min=0.0)
        hy = torch.clamp(rm_hy, min=0.0)
        rt, rb, rtl, rbl = (fget(QF_RECT_RADII + k) for k in range(4))
        ell = fget(QF_RECT_MATY + 3) > 0.5
        d = sdf.sd_rounded_box(qx, -qy, hx, hy, rt, rb, rtl, rbl)
        if _any(ell & rm_enabled):
            d = torch.where(
                ell, sdf.sd_elliptical_rounded_box(qx, -qy, hx, hy, rt, rb, rtl, rbl),
                d)
        rm_alpha = torch.where(
            rm_enabled, 1.0 - torch.clamp(aa * d + 0.5, 0.0, 1.0), 1.0
        )
        out_a = out_a * rm_alpha

    out_a = torch.where(inside, out_a, 0.0)
    return out_r, out_g, out_b, out_a
