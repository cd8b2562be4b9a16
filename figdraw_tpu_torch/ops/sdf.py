"""Signed-distance-field primitives in plain torch (figdraw_tpu/ops/sdf.py).

Every function is elementwise and shape-polymorphic: scalar tensors
broadcast over whatever pixel-grid shape the caller evaluates. The
operation order follows the JAX reference term by term, and floor-mod is
`torch.remainder` (never `fmod`), so CPU results agree to rounding.
csrc/sdf.cuh is the CUDA twin.
"""

from __future__ import annotations

import torch


def _sq(x):
    return x * x


def sd_rounded_box(px, py, bx, by, r_tr, r_br, r_tl, r_bl):
    """Rounded-box SDF with per-quadrant radius select (atlas.frag:51-69).

    p is in the shader's y-up local frame; radii order is the packed
    (TR, BR, TL, BL) vec.
    """
    rr = torch.where(
        px > 0.0,
        torch.where(py > 0.0, r_tr, r_br),
        torch.where(py > 0.0, r_tl, r_bl),
    )
    qx = torch.abs(px) - bx + rr
    qy = torch.abs(py) - by + rr
    outside = torch.sqrt(
        _sq(torch.clamp(qx, min=0.0)) + _sq(torch.clamp(qy, min=0.0))
    )
    return torch.clamp(torch.maximum(qx, qy), max=0.0) + outside - rr


def sd_ellipse(px, py, rx, ry):
    """Approximate ellipse SDF (atlas.frag:71-79)."""
    sx = torch.clamp(rx, min=1e-6)
    sy = torch.clamp(ry, min=1e-6)
    k0 = torch.sqrt(_sq(px / sx) + _sq(py / sy))
    k1 = torch.sqrt(_sq(px / (sx * sx)) + _sq(py / (sy * sy)))
    d = k0 * (k0 - 1.0) / torch.clamp(k1, min=1e-6)
    return torch.where(k0 <= 1e-6, -torch.minimum(sx, sy), d)


def _select_corner(px, py, r_tr, r_br, r_tl, r_bl):
    """atlas.frag:81-86."""
    return torch.where(
        px > 0.0,
        torch.where(py > 0.0, r_tr, r_br),
        torch.where(py > 0.0, r_tl, r_bl),
    )


def sd_elliptical_rounded_box(px, py, bx, by, r_tr, r_br, r_tl, r_bl):
    """Elliptical-corner rounded box with the 12+12-bit packed radii decode
    (atlas.frag:88-115)."""
    selected = _select_corner(px, py, r_tr, r_br, r_tl, r_bl)

    # negative encoding: circular corner with radius = -v - 1
    circ_r = -selected - 1.0
    d_circular = sd_rounded_box(px, py, bx, by, circ_r, circ_r, circ_r, circ_r)

    # f32 cannot represent x.5 above 2^23, where packed values are exact
    # integers already: only round below it (figdraw_tpu/ops/sdf.py:67-73)
    packed = torch.where(
        selected >= 8388608.0, selected, torch.floor(selected + 0.5)
    )
    rad_x = torch.remainder(packed, 4096.0) * bx / 4095.0
    rad_y = torch.floor(packed / 4096.0) * by / 4095.0

    # sharp corner when either radius collapses
    qx0 = torch.abs(px) - bx
    qy0 = torch.abs(py) - by
    d_sharp = torch.clamp(torch.maximum(qx0, qy0), max=0.0) + torch.sqrt(
        _sq(torch.clamp(qx0, min=0.0)) + _sq(torch.clamp(qy0, min=0.0))
    )

    # equal-axis packed radius → circular path
    d_equal = sd_rounded_box(px, py, bx, by, rad_x, rad_x, rad_x, rad_x)

    # true elliptical corner
    qx = torch.abs(px) - bx + rad_x
    qy = torch.abs(py) - by + rad_y
    d_corner = sd_ellipse(qx, qy, rad_x, rad_y)
    d_edge = torch.maximum(qx - rad_x, qy - rad_y)
    d_elliptical = torch.where((qx > 0.0) & (qy > 0.0), d_corner, d_edge)

    d = torch.where(
        (rad_x <= 0.0) | (rad_y <= 0.0),
        d_sharp,
        torch.where(rad_x == rad_y, d_equal, d_elliptical),
    )
    return torch.where(selected < 0.0, d_circular, d)


def _acos(x):
    """Polynomial acos (Abramowitz & Stegun 4.4.45, |err| < 6.7e-5 rad): the
    JAX reference computes with this substitute on all its paths."""
    xc = torch.clamp(x, -1.0, 1.0)
    a = torch.abs(xc)
    poly = 1.5707288 + a * (-0.2121144 + a * (0.0742610 + a * (-0.0187293)))
    r = torch.sqrt(torch.clamp(1.0 - a, min=0.0)) * poly
    return torch.where(xc >= 0.0, r, 3.14159265358979 - r)


def _cbrt(x):
    """Signed cube root via exp/log (the JAX reference's substitute)."""
    ax = torch.abs(x)
    r = torch.exp(torch.log(torch.clamp(ax, min=1e-30)) / 3.0)
    return torch.where(ax < 1e-30, 0.0, torch.sign(x) * r)


def sd_bezier(posx, posy, ax_, ay_, bx_, by_, cx_, cy_):
    """Exact quadratic-bezier distance via the cubic-root solve
    (atlas.frag:121-160). Control points A, B, C broadcast against pos."""
    abx = bx_ - ax_
    aby = by_ - ay_
    bbx = ax_ - 2.0 * bx_ + cx_
    bby = ay_ - 2.0 * by_ + cy_
    bb = bbx * bbx + bby * bby

    # degenerate: control point collinear midpoint → segment distance
    bax = cx_ - ax_
    bay = cy_ - ay_
    seg_h = torch.clamp(
        ((posx - ax_) * bax + (posy - ay_) * bay)
        / torch.clamp(bax * bax + bay * bay, min=1e-6),
        0.0,
        1.0,
    )
    d_seg = torch.sqrt(
        _sq(posx - (ax_ + bax * seg_h)) + _sq(posy - (ay_ + bay * seg_h))
    )

    cx2 = abx * 2.0
    cy2 = aby * 2.0
    dx = ax_ - posx
    dy = ay_ - posy
    kk = 1.0 / torch.clamp(bb, min=1e-6)
    kx = kk * (abx * bbx + aby * bby)
    ky = kk * (2.0 * (abx * abx + aby * aby) + (dx * bbx + dy * bby)) / 3.0
    kz = kk * (dx * abx + dy * aby)
    p = ky - kx * kx
    p3 = p * p * p
    q = kx * (2.0 * kx * kx - 3.0 * ky) + kz
    h = q * q + 4.0 * p3

    def dot2t(t):
        qx = dx + (cx2 + bbx * t) * t
        qy = dy + (cy2 + bby * t) * t
        return qx * qx + qy * qy

    # h >= 0: single root
    hs = torch.sqrt(torch.clamp(h, min=0.0))
    x1 = (hs - q) / 2.0
    x2 = (-hs - q) / 2.0
    t_single = torch.clamp(_cbrt(x1) + _cbrt(x2) - kx, 0.0, 1.0)
    res_single = dot2t(t_single)

    # h < 0: two candidate roots (p < 0 here, so the denominator is negative;
    # guard |denom| against 0 and let the clip keep acos in range)
    z = torch.sqrt(torch.clamp(-p, min=1e-12))
    denom = p * z * 2.0
    denom = torch.where(torch.abs(denom) < 1e-12, -1e-12, denom)
    v = _acos(torch.clamp(q / denom, -1.0, 1.0)) / 3.0
    m = torch.cos(v)
    n = torch.sin(v) * 1.732050808
    t1 = torch.clamp((m + m) * z - kx, 0.0, 1.0)
    t2 = torch.clamp((-n - m) * z - kx, 0.0, 1.0)
    res_double = torch.minimum(dot2t(t1), dot2t(t2))

    res = torch.where(h >= 0.0, res_single, res_double)
    d_curve = torch.sqrt(torch.clamp(res, min=0.0))
    return torch.where(bb <= 1e-6, d_seg, d_curve)


def median3(a, b, c):
    """The median of three MSDF channels (atlas.frag:41-43)."""
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def shadow_profile(sd, blur_radius):
    """Gaussian falloff, CSS-like sigma = blur/2 (atlas.frag:211-216)."""
    sigma = torch.clamp(0.5 * blur_radius, min=0.5)
    z = sd / sigma
    return torch.exp(-0.5 * z * z)


def bezier_stroke_sd(dist, posx, posy, ax_, ay_, bx_, by_, cx_, cy_, half_w,
                     mode, MODE_ROUND, MODE_BUTT, MODE_SQUARE):
    """Cap trimming for bezier strokes (atlas.frag:179-209)."""
    chordx = cx_ - ax_
    chordy = cy_ - ay_
    chord_len = torch.sqrt(chordx * chordx + chordy * chordy)
    fx = torch.where(chord_len <= 1e-6, 1.0,
                     chordx / torch.clamp(chord_len, min=1e-6))
    fy = torch.where(chord_len <= 1e-6, 0.0,
                     chordy / torch.clamp(chord_len, min=1e-6))

    def norm_or(vx, vy, fbx, fby):
        ln = torch.sqrt(vx * vx + vy * vy)
        ok = ln > 1e-6
        return (
            torch.where(ok, vx / torch.clamp(ln, min=1e-6), fbx),
            torch.where(ok, vy / torch.clamp(ln, min=1e-6), fby),
        )

    stx, sty = norm_or(bx_ - ax_, by_ - ay_, fx, fy)
    etx, ety = norm_or(cx_ - bx_, cy_ - by_, fx, fy)
    start_proj = (posx - ax_) * stx + (posy - ay_) * sty
    end_proj = (posx - cx_) * etx + (posy - cy_) * ety

    is_square = mode == MODE_SQUARE
    trim = torch.where(is_square, half_w, 0.0)
    tube = dist
    cross_start = torch.abs((posx - ax_) * sty - (posy - ay_) * stx)
    cross_end = torch.abs((posx - cx_) * ety - (posy - cy_) * etx)
    tube = torch.where(is_square & (start_proj < 0.0),
                       torch.minimum(tube, cross_start), tube)
    tube = torch.where(is_square & (end_proj > 0.0),
                       torch.minimum(tube, cross_end), tube)
    cap_dist = torch.maximum(-start_proj - trim, end_proj - trim)
    trimmed = torch.maximum(tube - half_w, cap_dist)
    return torch.where(mode == MODE_ROUND, dist - half_w, trimmed)
