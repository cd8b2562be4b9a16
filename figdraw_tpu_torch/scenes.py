"""Benchmark and check scenes, in array form and in tree form.

`make_render_tree_array` is figdraw_tpu/scenes.py:44-344 (the 300-box
animated shadow demo bench.py renders at 1080p), bit-identical to it: the
same seeded box placement, the same static columns and the same C animator.
`make_modes_scene_array` is a small scene that drives every SDF family the
tile rasterizer evaluates; `walk_free_mode_rows` adds the modes the walk
never emits, and `atlas_modes_tape` the atlas modes. The clip tables of
bench_clipmask.py and the image panels of bench_images.py are built
byte-identical to the JAX package's; `load_text_plan` reads bench_text's
frame as the JAX package planned it. `build_grid` is bench_retained.py's
grid of one root a box, `box_tracks` and `anim_table` bench_sceneanim.py's
per-root affine animation of the demo scene.

In tree form, built with the port's Fig API: `make_render_tree` (the
headline), `make_table_scene` and `make_nonclip_scene` (bench_clipmask's
tables; from_renders of a table equals make_clip_table_scene's rows byte
for byte) and the scenes of three examples (`EXAMPLE_SCENES`), which
`render_example` renders in each of `EXAMPLE_FORMS` against figdraw_tpu's
stored block means (`example_reference_path`).

Images from files and generated SDFs: `make_msdf_star_scene`
(examples/msdf_star.py; its star's SDF made by utils/sdfgen, `star_sdf`) and
`make_mtsdf_scene` (all four SDF image modes on test_images.py's synthetic
circle) are example scenes too, with their images in `EXAMPLE_IMAGES`;
`make_image_file_scene` (examples/image_renderlist.py) and
`make_loaded_photo_wall` (a 1080p photo grid) draw an image loaded from a
file, the repo's PNG fixture (`IMAGE_FIXTURE`; `render_image_file` loads it
through resources.load_image), held to `example_reference_path
("image_file", form)` and `PHOTO_WALL_REFERENCE`, and the fixture's decode
and sidecar to the digests in `IMAGE_FIXTURE_REFERENCE`.

For the frame loop's entry points: `make_blurred_cards_scene` (the
clipped photo cards under a backdrop blur, a frosted panel and a second
band of cards above it: a long tape with a blur, which the planner sends to
the rolled executor) and examples/overlay_3d.py's scene with its numpy
pyramid (`make_overlay_scene`, `rasterize_pyramid`), each held to stored
block means of figdraw_tpu's frames (`BLURRED_REFERENCE`,
`OVERLAY_REFERENCE`).
"""

from __future__ import annotations

import json
import math
import os
from types import SimpleNamespace

import numpy as np

from .basics import (
    BackdropBlurStyle, FigFlags, FigKind, MsdfImageStyle, RenderShadow,
    RenderStroke, ShadowStyle, StrokeCap, StrokeJoin, image_style,
)
from .borders import (
    fig_dashed_rounded_rect_border, fig_dotted_rounded_rect_border,
    fig_rounded_rect_border,
)
from .colors import rgba
from .fill import FillGradientAxis, fill, linear
from .geometry import rect, vec2
from .nodes import (
    DrawableKind, Fig, RenderList, Renders, drawable_arc, drawable_bezier,
    drawable_circle, drawable_line, drawable_rect, new_renders,
)
from .nodesarray import OP_DTYPE, RenderListArray, RendersArray, from_renders

# Box-placement clamp bounds shared with the native animator: the rightmost
# box column starts at x=320 / the lowest at y=300, max animated size
# 260x180.
_SCENE_CLAMP_X = 320.0 + 260.0  # = 580
_SCENE_CLAMP_Y = 300.0 + 180.0  # = 480

_scene_random_cache = {}


def _scene_randoms(copies: int, max_x: float, max_y: float):
    key = (copies, max_x, max_y)
    cached = _scene_random_cache.get(key)
    if cached is None:
        rng = np.random.RandomState(12345)
        cached = (
            rng.uniform(0.0, max_x, size=copies),
            rng.uniform(0.0, max_y, size=copies),
        )
        _scene_random_cache[key] = cached
    return cached


# The animator's sixteen phase functions t*a + i*b; row order is
# load-bearing (fd_scene_animate indexes these).
_SIN_COEF = np.array(
    [[1.0, 0.15], [0.8, 0.07], [1.25, 0.11], [0.7, 0.05], [0.85, 0.05],
     [1.1, 0.05], [0.9, 0.03], [1.05, 0.06], [0.85, 0.04]]
)
_COS_COEF = np.array(
    [[0.9, 0.2], [0.65, 0.09], [0.8, 0.06], [0.95, 0.08], [0.75, 0.04],
     [0.9, 0.03], [0.8, 0.04]]
)

_scene_anim_cache = {}


def _scene_anim_state(copies: int):
    """Per-copies cached angle-addition tables: sin/cos of the per-copy
    phase offsets, evaluated once; per frame only the t-dependent scalars
    go through libm."""
    state = _scene_anim_cache.get(copies)
    if state is None:
        i = np.arange(copies, dtype=np.float64)
        sin_phase = i[None, :] * _SIN_COEF[:, 1:2]
        cos_phase = i[None, :] * _COS_COEF[:, 1:2]
        state = {
            "sin_of_sp": np.sin(sin_phase),
            "cos_of_sp": np.cos(sin_phase),
            "sin_of_cp": np.sin(cos_phase),
            "cos_of_cp": np.cos(cos_phase),
            "sin_t": np.ascontiguousarray(_SIN_COEF[:, 0]),
            "cos_t": np.ascontiguousarray(_COS_COEF[:, 0]),
        }
        _scene_anim_cache[copies] = state
    return state


def _scene_static(w: float, h: float, copies: int):
    """Everything in the 300-box scene that does NOT depend on the frame:
    node kinds/flags, fill kinds and colors, strokes, shadow styles and
    shadow fills, the static pill. Returns (RendersArray, RenderListArray)."""
    n_nodes = 1 + copies * 3 + 3
    lst = RenderListArray(capacity=n_nodes)
    lst.count = n_nodes
    lst.root_ids = list(range(n_nodes))
    nodes = lst.nodes
    nodes["parent"] = -1

    # backdrop
    nodes["kind"][0] = int(FigKind.nkRectangle)
    nodes["box"][0] = (0, 0, w, h)
    nodes["fill"]["kind"][0] = 0
    nodes["fill"]["c0"][0] = (255, 255, 255, 155)

    red = slice(1, 1 + 3 * copies, 3)
    green = slice(2, 2 + 3 * copies, 3)
    blue = slice(3, 3 + 3 * copies, 3)

    nodes["kind"][red] = int(FigKind.nkRectangle)
    nodes["flags"][red] = int(FigFlags.NfEllipticalCorners)
    nodes["fill"]["c0"][red] = (220, 40, 40, 155)
    nodes["stroke_weight"][red] = 5.0
    nodes["stroke_fill"]["c0"][red] = (0, 0, 0, 155)

    nodes["kind"][green] = int(FigKind.nkRectangle)
    green_grad = (np.arange(copies) % 2) == 0
    gidx = np.arange(2, 2 + 3 * copies, 3)
    gg = gidx[green_grad]
    gs = gidx[~green_grad]
    nodes["fill"]["kind"][gg] = 2
    nodes["fill"]["axis"][gg] = np.where(
        (np.arange(copies)[green_grad] % 4) < 2,
        int(FillGradientAxis.fgaX),
        int(FillGradientAxis.fgaDiagTLBR),
    )
    nodes["fill"]["midpos"][gg] = 128
    nodes["fill"]["c0"][gg] = (18, 112, 64, 255)
    nodes["fill"]["c1"][gg] = (40, 180, 90, 255)
    nodes["fill"]["c2"][gg] = (78, 224, 188, 255)
    nodes["fill"]["c0"][gs] = (40, 180, 90, 155)
    nodes["shadows"]["style"][green, 0] = 1
    nodes["shadows"]["fill"]["c0"][green, 0] = (0, 0, 0, 155)

    nodes["kind"][blue] = int(FigKind.nkRectangle)
    blue_grad = (np.arange(copies) % 3) == 0
    bidx = np.arange(3, 3 + 3 * copies, 3)
    bg_ = bidx[blue_grad]
    bs_ = bidx[~blue_grad]
    nodes["fill"]["kind"][bg_] = 2
    nodes["fill"]["axis"][bg_] = np.where(
        (np.arange(copies)[blue_grad] % 2) == 0,
        int(FillGradientAxis.fgaY),
        int(FillGradientAxis.fgaDiagBLTR),
    )
    nodes["fill"]["midpos"][bg_] = 132
    nodes["fill"]["c0"][bg_] = (44, 72, 186, 255)
    nodes["fill"]["c1"][bg_] = (60, 90, 220, 255)
    nodes["fill"]["c2"][bg_] = (118, 168, 255, 255)
    nodes["fill"]["c0"][bs_] = (60, 90, 220, 155)
    nodes["stroke_weight"][blue] = 4.0
    nodes["stroke_fill"]["c0"][blue] = (255, 255, 255, 210)
    nodes["shadows"]["style"][blue, 0] = 2
    nodes["shadows"]["fill"]["kind"][bg_, 0] = 1
    nodes["shadows"]["fill"]["axis"][bg_, 0] = int(FillGradientAxis.fgaDiagBLTR)
    nodes["shadows"]["fill"]["c0"][bg_, 0] = (25, 25, 40, 100)
    nodes["shadows"]["fill"]["c1"][bg_, 0] = (65, 65, 95, 180)
    nodes["shadows"]["fill"]["c0"][bs_, 0] = (40, 40, 60, 150)

    # static elliptical pill
    base = 1 + 3 * copies
    nodes["kind"][base] = int(FigKind.nkRectangle)
    nodes["box"][base] = (max(20.0, w - 200.0), 20, 180, 100)
    nodes["fill"]["c0"][base] = (238, 140, 30, 220)
    nodes["corners"][base] = (90, 90, 90, 90)
    nodes["corners_y"][base] = (50, 50, 50, 50)
    nodes["flags"][base] = int(FigFlags.NfEllipticalCorners)
    nodes["stroke_weight"][base] = 4.0
    nodes["stroke_fill"]["c0"][base] = (90, 45, 0, 220)

    # blur panel + overlay (boxes animate; styles don't)
    nodes["kind"][base + 1] = int(FigKind.nkBackdropBlur)
    nodes["blur"][base + 1] = 18.0
    nodes["kind"][base + 2] = int(FigKind.nkRectangle)
    nodes["fill"]["c0"][base + 2] = (255, 225, 55, 120)
    nodes["stroke_weight"][base + 2] = 6.0
    nodes["stroke_fill"]["c0"][base + 2] = (95, 72, 0, 185)

    out = RendersArray()
    out.set_layer(0, lst)
    return out, lst


def _scene_animate(nodes, w: float, h: float, frame: int, copies: int) -> None:
    """The frame-dependent columns (box positions/sizes, corner radii,
    shadow blur/spread/offsets, the moving blur panel + overlay), written by
    the C animator fd_scene_animate."""
    from . import native

    max_x = max(0.0, w - _SCENE_CLAMP_X)
    max_y = max(0.0, h - _SCENE_CLAMP_Y)
    base_xs, base_ys = _scene_randoms(copies, max_x, max_y)
    native.scene_animate(nodes, w, h, frame, copies, base_xs, base_ys,
                         _scene_anim_state(copies), _SCENE_CLAMP_X,
                         _SCENE_CLAMP_Y)


def make_render_tree_array(w: float, h: float, frame: int, copies: int = 100,
                           cache: dict = None):
    """The 300-box demo scene (at copies=100) in array form.

    cache: a caller-owned dict enables the retained form — the static
    columns are written once and only the animated columns update per
    frame."""
    if cache is not None:
        key = (w, h, copies)
        ent = cache.get(key)
        if ent is None:
            ent = cache[key] = _scene_static(w, h, copies)
        out, lst = ent
        _scene_animate(lst.nodes, w, h, frame, copies)
        return out
    out, lst = _scene_static(w, h, copies)
    _scene_animate(lst.nodes, w, h, frame, copies)
    return out


# --- the SDF modes scene --------------------------------------------------------


def _rect_node(lst, row, box, fill_c0, *, fill_kind=0, axis=0, midpos=128,
               c1=(0, 0, 0, 0), c2=(0, 0, 0, 0), corners=(0, 0, 0, 0),
               corners_y=None, stroke=0.0, stroke_c0=(0, 0, 0, 0), flags=0):
    n = lst.nodes
    n["kind"][row] = int(FigKind.nkRectangle)
    n["box"][row] = box
    n["flags"][row] = flags
    n["fill"]["kind"][row] = fill_kind
    n["fill"]["axis"][row] = axis
    n["fill"]["midpos"][row] = midpos
    n["fill"]["c0"][row] = fill_c0
    n["fill"]["c1"][row] = c1
    n["fill"]["c2"][row] = c2
    n["corners"][row] = corners
    if corners_y is not None:
        n["corners_y"][row] = corners_y
        n["flags"][row] = flags | int(FigFlags.NfEllipticalCorners)
    n["stroke_weight"][row] = stroke
    n["stroke_fill"]["c0"][row] = stroke_c0


# --- the device-resident benchmarks' scenes ---------------------------------------


def build_grid(n_boxes: int, w: float = 1920.0, h: float = 1080.0):
    """bench_retained.py's scene: a backdrop and one root per box (the
    retained unit) on a w x h grid, rounded, rotated and translucent.
    Returns (RendersArray, the boxes' root node indices)."""
    lst = RenderListArray(capacity=n_boxes + 1)
    # midpos 0: a solid fill packs no gradient midpoint
    _rect_node(lst, lst.add_root_raw(), (0, 0, w, h), (24, 26, 34, 255),
               midpos=0)
    cols = max(int((n_boxes * w / h) ** 0.5), 1)
    rows = (n_boxes + cols - 1) // cols
    cw, ch = w / cols, h / rows
    boxes = []
    for i in range(n_boxes):
        r, c = divmod(i, cols)
        row = lst.add_root_raw()
        _rect_node(lst, row, (c * cw + 2, r * ch + 2, cw - 4, ch - 4),
                   ((i * 37) % 255, (i * 91) % 255, 200, 155),
                   midpos=0, corners=(4,) * 4)
        lst.set_rotation(row, (i * 7) % 23 - 11)
        boxes.append(row)
    out = RendersArray()
    out.set_layer(0, lst)
    return out, boxes


def box_tracks(copies: int, frame: int, w: float = 1920.0, h: float = 1080.0):
    """The demo's position and size phase math for its 3 * copies animated
    boxes (bench_sceneanim._box_tracks): (3, copies, 4) float64 x, y, w, h
    at `frame`."""
    t = frame * 0.02
    st = _scene_anim_state(copies)
    sin_ta = np.sin(t * st["sin_t"])[:, None]
    cos_ta = np.cos(t * st["sin_t"])[:, None]
    s = st["cos_of_sp"] * sin_ta + st["sin_of_sp"] * cos_ta
    cos_tc = np.cos(t * st["cos_t"])[:, None]
    sin_tc = np.sin(t * st["cos_t"])[:, None]
    c = st["cos_of_cp"] * cos_tc - st["sin_of_cp"] * sin_tc
    max_x = max(0.0, w - _SCENE_CLAMP_X)
    max_y = max(0.0, h - _SCENE_CLAMP_Y)
    base_xs, base_ys = _scene_randoms(copies, max_x, max_y)
    off_x = np.clip(base_xs + s[0] * 20, 0.0, max_x)
    off_y = np.clip(base_ys + c[0] * 20, 0.0, max_y)
    pulse_w = 0.5 + 0.5 * s[1]
    pulse_h = 0.5 + 0.5 * c[1]
    out = np.empty((3, copies, 4))
    out[0, :, 0] = 60.0 + off_x
    out[0, :, 1] = 60.0 + off_y
    out[0, :, 2] = 160.0 + 100.0 * pulse_w
    out[0, :, 3] = 110.0 + 70.0 * pulse_h
    out[1, :, 0] = 320.0 + off_x
    out[1, :, 1] = 120.0 + off_y
    out[1, :, 2] = 160.0 + 100.0 * pulse_h
    out[1, :, 3] = 110.0 + 70.0 * pulse_w
    out[2, :, 0] = 180.0 + off_x
    out[2, :, 1] = 300.0 + off_y
    out[2, :, 2] = 160.0 + 100.0 * (1.0 - pulse_w)
    out[2, :, 3] = 110.0 + 70.0 * (1.0 - pulse_h)
    return out


def anim_table(copies: int, base, frame: int, out, w: float = 1920.0,
               h: float = 1080.0):
    """bench_sceneanim._anim_table: fills `out`, the bulk (R, 6) affine table
    of render_view's root_transforms in slot order (the demo scene's roots
    are its node indices 0..n-1), with each box's scale about its base
    origin (`base` = box_tracks at the snapshot's frame) and its translation
    to the position at `frame`; the other roots keep what `out` holds
    (identity). Returns out."""
    cur = box_tracks(copies, frame, w, h)
    sx = cur[..., 2] / base[..., 2]
    sy = cur[..., 3] / base[..., 3]
    # node idx of box (k, i) is 1 + 3*i + k
    rows = out[1 : 1 + 3 * copies].reshape(copies, 3, 6)
    rows[:, :, 0] = sx.T
    rows[:, :, 3] = sy.T
    rows[:, :, 4] = (cur[..., 0] - sx * base[..., 0]).T
    rows[:, :, 5] = (cur[..., 1] - sy * base[..., 1]).T
    return out


def make_modes_scene_array(w: float = 256.0, h: float = 128.0) -> RendersArray:
    """One frame-target run that reaches every SDF family the walk emits:
    fills with circular and elliptical corners (mode 3, +128), annular AA
    strokes (12), drop (7) and inset (9) shadows, quadratic bezier strokes
    with round, butt and square caps (18-20), flat and bilinear vertex fills
    (fill mode 0), 3-stop gradients on all four axes (fill modes 1-4), and
    circular and elliptical rect masks (QF_RECT_*). Coordinates scale with
    (w, h) from a 256x128 layout; nothing crosses a clip mask, an atlas
    mode or a pass break."""
    sx, sy = w / 256.0, h / 128.0
    lst = RenderListArray(capacity=32)

    def box(x, y, bw, bh):
        return (x * sx, y * sy, bw * sx, bh * sy)

    # translucent backdrop: bilinear vertex fill (linear2 → 4 vertex colors)
    r = lst.add_root_raw()
    _rect_node(lst, r, box(0, 0, 256, 128), (30, 60, 200, 120), fill_kind=1,
               axis=int(FillGradientAxis.fgaDiagTLBR), c1=(240, 200, 40, 200))
    # 3-stop gradients on every axis (fill modes 1-4), stroked, some
    # elliptical, with drop and inset shadows
    for k, axis in enumerate(FillGradientAxis):
        r = lst.add_root_raw()
        ell = (18, 9, 14, 6) if k % 2 else None
        _rect_node(lst, r, box(8 + 60 * k, 8, 52, 40), (200, 40, 60, 255),
                   fill_kind=2, axis=int(axis), midpos=90 + 30 * k,
                   c1=(40, 200, 90, 230), c2=(30, 40, 220, 180),
                   corners=(12, 4, 8, 16), corners_y=ell, stroke=3.0,
                   stroke_c0=(0, 0, 0, 170))
        sh = lst.nodes["shadows"][r]
        sh["style"][0] = int(ShadowStyle.DropShadow if k < 2
                             else ShadowStyle.InnerShadow)
        sh["blur"][0] = 6.0 + 2 * k
        sh["spread"][0] = 2.0 + k
        sh["x"][0] = 4.0 - 3 * k
        sh["y"][0] = 3.0
        sh["fill"]["c0"][0] = (0, 0, 0, 150)
        if k == 3:  # gradient inset shadow fill
            sh["fill"]["kind"][0] = 1
            sh["fill"]["axis"][0] = int(FillGradientAxis.fgaDiagBLTR)
            sh["fill"]["c1"][0] = (60, 60, 120, 200)
    # fully round elliptical pill (the 2^24-1 packed-radius case), flat fill
    r = lst.add_root_raw()
    _rect_node(lst, r, box(150, 96, 72, 24), (250, 140, 30, 230),
               corners=(36, 36, 36, 36), corners_y=(12, 12, 12, 12),
               stroke=2.0, stroke_c0=(90, 45, 0, 220))
    # rect masks: the fast path clips each parent's children, circular and
    # elliptical
    for k, ell in enumerate((None, (14, 6, 10, 4))):
        p = lst.add_root_raw()
        _rect_node(lst, p, box(12 + 70 * k, 60, 60, 40), (220, 220, 220, 200),
                   corners=(10, 10, 10, 10), corners_y=ell,
                   flags=int(FigFlags.NfRectMaskContent))
        c = lst.add_child_raw(p)
        _rect_node(lst, c, box(0 + 70 * k, 50, 80, 64), (240, 30, 30, 210),
                   fill_kind=2, axis=int(FillGradientAxis.fgaY),
                   c1=(30, 240, 30, 210), c2=(30, 30, 240, 210),
                   corners=(6, 6, 6, 6), stroke=4.0, stroke_c0=(0, 0, 90, 255))
    # quadratic bezier strokes, one per cap (round, butt, square); the
    # square one takes a 3-stop gradient stroke
    for k, cap in enumerate((StrokeCap.scRound, StrokeCap.scButt,
                             StrokeCap.scSquare)):
        d = lst.add_root_raw()
        n = lst.nodes
        n["kind"][d] = int(FigKind.nkDrawable)
        n["box"][d] = (0.0, 0.0, w, h)
        n["draw_weight"][d] = 5.0 + 2 * k
        n["draw_cap"][d] = int(cap)
        n["draw_stroke_fill"]["c0"][d] = (20 + 80 * k, 20, 160, 230)
        if k == 2:
            n["draw_stroke_fill"]["kind"][d] = 2
            n["draw_stroke_fill"]["axis"][d] = int(FillGradientAxis.fgaX)
            n["draw_stroke_fill"]["midpos"][d] = 128
            n["draw_stroke_fill"]["c1"][d] = (250, 250, 40, 255)
            n["draw_stroke_fill"]["c2"][d] = (20, 220, 220, 200)
        n["ops_start"][d] = len(lst.ops_rows)
        n["ops_count"][d] = 1
        op = np.zeros((), dtype=OP_DTYPE)
        op["kind"] = int(DrawableKind.dkBezier)
        op["p_start"] = len(lst.points_rows)
        op["p_count"] = 3
        lst.ops_rows.append(op)
        x0 = (150 + 30 * k) * sx
        lst.points_rows.extend([(x0, 62 * sy), (x0 + 40 * sx, (30 + 20 * k) * sy),
                                (x0 + 14 * sx, 118 * sy)])
    out = RendersArray()
    out.set_layer(0, lst)
    return out


def walk_free_mode_rows(w: float = 256.0, h: float = 128.0):
    """Tape rows for the SDF modes the kernels evaluate but the walk never
    emits: 8 (drop shadow, AA interior), 11 (annular, no AA) and 21 (linear
    drop shadow), plus mode 17 (backdrop sample) over a rounded panel.
    Axis-aligned, rounded-box quads; returns ((4, 68) f32 logical fields,
    (4, 2) i32 modes)."""
    from .ops.layout import (
        QF_AA, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, QF_COLOR0,
        QF_FACTORS, QF_INV_A, QF_INV_D, QF_ORG_X, QF_ORG_Y, QF_PARAMS,
        QF_RADII, QF_RECT_PARAMS, QF_UVDU_X, QF_UVDV_Y, QF_WIDTH,
    )

    specs = (  # (mode, x, y, qw, qh, factor, spread, rgba)
        (8, 20, 70, 70, 50, 8.0, 3.0, (0.1, 0.1, 0.3, 0.6)),
        (11, 100, 20, 60, 60, 6.0, 0.0, (0.9, 0.5, 0.1, 1.0)),
        (21, 170, 60, 70, 56, 10.0, 2.0, (0.0, 0.0, 0.0, 0.5)),
        (17, 60, 30, 120, 70, 12.0, 0.0, (1.0, 1.0, 1.0, 1.0)),
    )
    sx, sy = w / 256.0, h / 128.0
    fields = np.zeros((len(specs), QF_WIDTH), np.float32)
    modes = np.zeros((len(specs), 2), np.int32)
    for i, (mode, x, y, qw, qh, factor, spread, col) in enumerate(specs):
        x, y, qw, qh = x * sx, y * sy, qw * sx, qh * sy
        f = fields[i]
        f[QF_INV_A] = 1.0 / qw
        f[QF_INV_D] = 1.0 / qh
        f[QF_ORG_X] = x
        f[QF_ORG_Y] = y
        f[QF_BBOX_X0], f[QF_BBOX_Y0] = x, y
        f[QF_BBOX_X1], f[QF_BBOX_Y1] = x + qw, y + qh
        f[QF_UVDU_X] = 1.0
        f[QF_UVDV_Y] = 1.0
        f[QF_COLOR0 : QF_COLOR0 + 16] = np.tile(col, 4)
        f[QF_PARAMS : QF_PARAMS + 4] = (qw / 2, qh / 2, qw / 2 - factor,
                                        qh / 2 - factor)
        f[QF_RADII : QF_RADII + 4] = (10.0, 4.0, 8.0, 0.0)
        f[QF_FACTORS] = factor
        f[QF_FACTORS + 1] = spread
        f[QF_AA] = 1.2
        f[QF_RECT_PARAMS + 2] = -1.0
        f[QF_RECT_PARAMS + 3] = -1.0
        modes[i, 0] = mode
    return fields, modes


def modes_tape(w: float = 256.0, h: float = 128.0):
    """The modes scene walked by the native flattener plus
    walk_free_mode_rows, as logical rows padded to their quad bucket:
    ((n_pad, 68) f32 fields, (n_pad, 2) i32 modes, n_live). One frame-target
    run [0, n_live) that exercises every mode the tile rasterizer handles."""
    from . import native
    from .plan import bucket
    from .renderer import DEFAULT_SDF_AA_FACTOR

    tape = native.flatten_renders_array(
        make_modes_scene_array(w, h), w, h, 1.0, 1.0, DEFAULT_SDF_AA_FACTOR,
        (1.0, 1.0, 1.0, 1.0))
    walked_f, walked_m = tape.fields, tape.modes
    extra_f, extra_m = walk_free_mode_rows(w, h)
    n_live = tape.count + extra_f.shape[0]
    n_pad = bucket(n_live)
    fields = np.zeros((n_pad, walked_f.shape[1]), np.float32)
    modes = np.zeros((n_pad, 2), np.int32)
    fields[: tape.count] = walked_f[: tape.count]
    modes[: tape.count] = walked_m[: tape.count]
    fields[tape.count : n_live] = extra_f
    modes[tape.count : n_live] = extra_m
    return fields, modes, n_live


def atlas_modes_tape(w: int, h: int, atlas_size: int, seed: int = 0,
                     n: int = 48, one_to_one: bool = False):
    """Seeded tape rows that drive every branch of the atlas sampler, with a
    seeded (S, S, 4) atlas: mode-0 quads at 1:1 (fractional origins),
    minified by exactly 2 (texel-boundary ties under nearest sampling),
    scaled by non-powers of two, rotated and v-flipped; MSDF and MTSDF
    quads (13, 14) and their strokes (15, 16) with vertex and gradient
    fills; an SDF box every seventh quad; rect masks on some. one_to_one:
    only axis-aligned 1:1 mode-0 quads at whole-pixel origins, SDF boxes
    between them (the quads the TPU kernel samples in-kernel). Returns
    ((n_pad, 68) f32 logical fields, (n_pad, 2) i32 modes, n, (S, S, 4) f32
    atlas)."""
    from .ops.layout import (
        QF_AA, QF_BBOX_X0, QF_COLOR0, QF_FACTORS, QF_INV_A, QF_MID_COLOR,
        QF_ORG_X, QF_PARAMS, QF_RECT_MATX, QF_RECT_MATY, QF_RECT_PARAMS,
        QF_STOP_COLOR, QF_SUBPIXEL_SHIFT, QF_UV3_X, QF_WIDTH,
    )
    from .plan import bucket

    rng = np.random.RandomState(seed)
    s = atlas_size
    atlas = rng.rand(s, s, 4).astype(np.float32)
    n_pad = bucket(n)
    fields = np.zeros((n_pad, QF_WIDTH), np.float32)
    modes = np.zeros((n_pad, 2), np.int32)
    for i in range(n):
        f = fields[i]
        kind = i % 7 if not one_to_one else (6 if i % 3 == 2 else 0)
        # an atlas entry (texels) and its draw size (pixels)
        ew = int(rng.randint(4, max(5, min(40, s // 2))))
        eh = int(rng.randint(4, max(5, min(40, s // 2))))
        ex = int(rng.randint(0, s - ew + 1))
        ey = int(rng.randint(0, s - eh + 1))
        dw, dh = float(ew), float(eh)
        angle = 0.0
        flip = False
        if kind == 1:  # minified by exactly 2: ties on texel boundaries
            dw, dh = ew / 2.0, eh / 2.0
        elif kind == 2:  # scaled by a non-power of two, rotated
            dw, dh = ew * 1.37, eh * 0.81
            angle = float(rng.uniform(-0.6, 0.6))
        elif kind in (3, 4, 5):  # MSDF family, magnified, some flipped
            dw, dh = ew * 2.3, eh * 1.7
            flip = kind == 5
        ox = float(rng.randint(0, max(1, w - 48)))
        oy = float(rng.randint(0, max(1, h - 48)))
        if kind in (0, 2, 3) and not one_to_one:
            ox += float(rng.choice([0.25, 0.5, 0.37]))
        # the quad's edge vectors along u and v, and the inverse affine
        cu, su = np.cos(angle), np.sin(angle)
        eu = np.array([dw * cu, dw * su])
        ev = np.array([-dh * su, dh * cu])
        inv = np.linalg.inv(np.stack([eu, ev], axis=1))
        f[QF_INV_A : QF_INV_A + 4] = inv.reshape(-1)
        f[QF_ORG_X : QF_ORG_X + 2] = (ox, oy)
        corners = np.array([[ox, oy], [ox, oy] + eu, [ox, oy] + ev,
                            [ox, oy] + eu + ev])
        f[QF_BBOX_X0 : QF_BBOX_X0 + 4] = (
            np.floor(corners[:, 0].min()), np.floor(corners[:, 1].min()),
            np.ceil(corners[:, 0].max()), np.ceil(corners[:, 1].max()))
        v0, v1 = (ey + eh, ey) if flip else (ey, ey + eh)
        f[QF_UV3_X : QF_UV3_X + 6] = (ex / s, v0 / s, ew / s, 0.0, 0.0,
                                      (v1 - v0) / s)
        colors = rng.randint(0, 256, (4, 4)) / 255.0
        if i % 2 == 0:  # flat vertex colors take the evaluator's shortcut
            colors[:] = colors[0]
        f[QF_COLOR0 : QF_COLOR0 + 16] = colors.reshape(-1)
        f[QF_MID_COLOR : QF_MID_COLOR + 4] = rng.randint(0, 256, 4) / 255.0
        f[QF_STOP_COLOR : QF_STOP_COLOR + 4] = rng.randint(0, 256, 4) / 255.0
        f[QF_AA] = 1.2
        f[QF_SUBPIXEL_SHIFT] = float(rng.uniform(0.0, 1.0))
        f[QF_RECT_PARAMS + 2] = f[QF_RECT_PARAMS + 3] = -1.0
        if kind in (0, 1, 2):
            mode, fm = 0, 0
        elif kind == 6:  # an SDF box among the atlas quads
            mode, fm = 3, 0
            f[QF_PARAMS : QF_PARAMS + 4] = (dw / 2, dh / 2, dw / 2, dh / 2)
        else:
            mode = 13 + (i + 2 * (i // 7)) % 4  # solid or stroked, m or mt
            fm = int(rng.randint(0, 5))  # vertex or gradient fills
            f[QF_PARAMS : QF_PARAMS + 2] = (s, float(rng.uniform(0.0, 3.0)))
            f[QF_FACTORS : QF_FACTORS + 2] = (float(rng.uniform(2.0, 6.0)),
                                              float(rng.uniform(0.3, 0.7)))
        if i % 5 == 3:  # a rect mask through the quad's center
            f[QF_RECT_PARAMS : QF_RECT_PARAMS + 4] = (
                ox + dw / 2, oy + dh / 2, dw / 3, dh / 3)
            f[QF_RECT_MATX : QF_RECT_MATX + 3] = (1.0, 0.0, 0.0)
            f[QF_RECT_MATY : QF_RECT_MATY + 3] = (0.0, 1.0, 0.0)
        modes[i, 0] = mode + 256 * fm
    return fields, modes, n, atlas


def mega_modes_tape(n_masks: int, seed: int, w: int = 512, h: int = 256,
                    atlas_size=None):
    """A seeded megakernel tape that drives every clamp: modes_tape's rows
    (atlas_modes_tape's, on a seeded atlas, when atlas_size is given) with
    seeded targets and mask reads, some out of range and some targeting
    plane 0, and eight clear sentinels spliced in, each with the bbox union
    of the rows that read or write its plane, under the kernel's clamps,
    before the plane's next clear. Returns ((n_pad, 68) f32 fields, (n_pad,
    2) i32 mode lanes, (S, S, 4) f32 atlas or None)."""
    from .ops.layout import QF_BBOX_X0, QF_WIDTH, QI_MASK, QI_MODE
    from .ops.mega import MEGA_CLEAR_BIT, MEGA_TARGET_SHIFT
    from .plan import bucket

    atlas = None
    if atlas_size is None:
        fields, modes, n_live = modes_tape(w, h)
    else:
        fields, modes, n_live, atlas = atlas_modes_tape(w, h, atlas_size,
                                                        seed=atlas_size, n=96)
    fields, modes = fields[:n_live], modes[:n_live].copy()
    rng = np.random.RandomState(seed)
    kmax = n_masks - 1
    tgt = rng.randint(0, n_masks + 2, n_live)
    tgt[rng.rand(n_live) < 0.5] = 0  # half the quads draw into the frame
    modes[:, QI_MODE] += tgt << MEGA_TARGET_SHIFT
    modes[:, QI_MASK] = rng.randint(-1, n_masks + 2, n_live)
    modes[rng.rand(n_live) < 0.5, QI_MASK] = 0  # half read the all-pass plane
    n_clear = 8
    pos = np.sort(rng.choice(n_live, n_clear, replace=False))
    clear_tgt = rng.randint(0, n_masks + 2, n_clear)
    cleared = np.clip(clear_tgt - 1, 1, max(kmax, 1))
    # the planes each row touches: its read, its write and the write's source
    touches = np.stack([np.clip(modes[:, QI_MASK], 0, kmax),
                        np.where(tgt > 0, np.clip(tgt - 1, 1, kmax), -1),
                        np.where(tgt > 0, np.clip(tgt - 1, 0, kmax), -1)], 1)
    cf = np.zeros((n_clear, QF_WIDTH), np.float32)
    for i in range(n_clear):
        later = pos[i + 1 :][cleared[i + 1 :] == cleared[i]]
        stop = later[0] if later.size else n_live
        rel = (touches[pos[i] : stop] == cleared[i]).any(axis=1)
        bb = fields[pos[i] : stop, QF_BBOX_X0 : QF_BBOX_X0 + 4][rel]
        if len(bb):
            cf[i, QF_BBOX_X0 : QF_BBOX_X0 + 4] = np.concatenate(
                [bb[:, :2].min(0), bb[:, 2:].max(0)])
    cm = np.zeros((n_clear, 2), np.int32)
    cm[:, QI_MODE] = MEGA_CLEAR_BIT + (clear_tgt << MEGA_TARGET_SHIFT)
    fields = np.insert(fields, pos, cf, axis=0)
    modes = np.insert(modes, pos, cm, axis=0)
    n_pad = bucket(fields.shape[0])
    fields = np.concatenate([fields, np.zeros((n_pad - fields.shape[0], QF_WIDTH),
                                              np.float32)])
    modes = np.concatenate([modes, np.zeros((n_pad - modes.shape[0], 2), np.int32)])
    return fields, modes, atlas


# --- the clip-table benchmark scenes ------------------------------------------
#
# bench_clipmask.py, the JAX package's reproduction of the reference's
# windy_clip_mask_benchmark.nim and windy_non_clip_benchmark.nim (1200x800,
# 180 rows x 6 columns), with the table size as arguments. The node rows
# are byte-identical to figdraw_tpu's from_renders of the same scene.

def binning_tape(n: int, n_live: int, seed: int, sat: bool = False,
                 w: float = 384.0, h: float = 256.0):
    """A seeded tape for the tile binning's culls, in the logical layout:
    n_live quads over a w x h frame (the rest zero rows) with bboxes,
    rounded-box half-extents, corner radii (some elliptical-packed, some
    negative), u8 alphas, a mix of covers (big opaque or constant-alpha
    axis-aligned boxes) and quads that must never cover (rotated, mask-read,
    rect-masked, non-fill modes). sat: mostly big boxes of alpha 155, 200
    or 255, so translucent stacks saturate. Returns ((n, 68) f32 fields,
    (n, 2) i32 mode lanes)."""
    from .ops.layout import (
        QF_AA, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, QF_COLOR0,
        QF_INV_B, QF_MID_COLOR, QF_PARAMS, QF_RADII, QF_RECT_PARAMS,
        QF_STOP_COLOR, QF_WIDTH,
    )

    rng = np.random.RandomState(seed)
    f = np.zeros((n, QF_WIDTH), np.float32)
    m = np.zeros((n, 2), np.int32)
    big = rng.rand(n_live) < (0.6 if sat else 0.15)
    cw = np.where(big, rng.uniform(200, 500, n_live), rng.uniform(4, 150, n_live))
    ch = np.where(big, rng.uniform(160, 400, n_live), rng.uniform(4, 150, n_live))
    cx = rng.uniform(-40, w + 40, n_live)
    cy = rng.uniform(-40, h + 40, n_live)
    f[:n_live, QF_BBOX_X0] = cx - cw / 2
    f[:n_live, QF_BBOX_X1] = cx + cw / 2
    f[:n_live, QF_BBOX_Y0] = cy - ch / 2
    f[:n_live, QF_BBOX_Y1] = cy + ch / 2
    f[:n_live, QF_PARAMS + 2] = cw / 2
    f[:n_live, QF_PARAMS + 3] = ch / 2
    f[:n_live, QF_AA] = 1.2
    f[:n_live, QF_RECT_PARAMS + 2] = np.where(rng.rand(n_live) < 0.05, 30.0, -1.0)
    f[:n_live, QF_INV_B] = np.where(rng.rand(n_live) < 0.05, 0.01, 0.0)
    ell = rng.rand(n_live) < 0.3
    radii = rng.randint(0, 24, size=(n_live, 4)).astype(np.float32)
    packed = (rng.randint(0, 4096, size=(n_live, 4))
              + 4096 * rng.randint(0, 4096, size=(n_live, 4))).astype(np.float32)
    packed[:, 0] = np.where(rng.rand(n_live) < 0.2, -5.0, packed[:, 0])
    f[:n_live, QF_RADII : QF_RADII + 4] = np.where(ell[:, None], packed, radii)
    if sat:
        alpha = rng.choice([155, 200, 255], size=n_live)
    else:
        alpha = np.where(rng.rand(n_live) < 0.5, 255, rng.randint(0, 256, n_live))
    a = (alpha / 255.0).astype(np.float32)
    for c in range(4):
        f[:n_live, QF_COLOR0 + 4 * c + 3] = a
    fm = np.where(rng.rand(n_live) < 0.2, rng.randint(1, 5, n_live), 0)
    f[:n_live, QF_MID_COLOR + 3] = np.where(rng.rand(n_live) < 0.5, a, 0.5)
    f[:n_live, QF_STOP_COLOR + 3] = a
    mode = np.where(rng.rand(n_live) < 0.85, 3, rng.choice([7, 9, 12], n_live))
    m[:n_live, 0] = mode + 128 * ell + 256 * fm
    m[:n_live, 1] = np.where(rng.rand(n_live) < 0.05, 1, 0)
    return f, m


def _table_cell(lst, parent, box, rgba, flags=0, corners=0):
    """One flat-filled rounded rectangle, as bench_clipmask's rect_fig."""
    row = lst.add_root_raw() if parent < 0 else lst.add_child_raw(parent)
    _rect_node(lst, row, box, rgba, midpos=0, corners=(corners,) * 4,
               flags=flags)
    return row


def _table_scene(kind: str, w: float, h: float, rows: int,
                 cols: int) -> RendersArray:
    """The clipped table (bench_clipmask.make_table_scene, from
    windy_clip_mask_benchmark.nim makeTableRenderTree): a rounded viewport
    that clips with a mask plane, and rows x cols cells that clip their
    three spilling children. kind "subclip": every cell clips with its own
    mask plane (the megakernel's scene); "rectmask": cells clip through
    the rect-mask fast path of their children's quads."""
    margin, gap = 22.0, 4.0
    vx, vy, vw = margin, margin, w - margin * 2
    cell_h = 22.0
    cell_w = (vw - gap * (cols + 1)) / cols
    scroll_y = 37.0
    cell_flags = int(FigFlags.NfClipContent if kind == "subclip"
                     else FigFlags.NfRectMaskContent)

    lst = RenderListArray(capacity=2 + 4 * rows * cols)
    _table_cell(lst, -1, (0, 0, w, h), (248, 249, 251, 255))
    vp = _table_cell(lst, -1, (vx, vy, vw, h - margin * 2), (232, 235, 240, 255),
                     flags=int(FigFlags.NfClipContent), corners=10)
    for row in range(rows):
        y = vy + gap + row * (cell_h + gap) - scroll_y
        for col in range(cols):
            x = vx + gap + col * (cell_w + gap)
            color = ((255, 255, 255, 255) if (row + col) % 2 == 0
                     else (242, 246, 250, 255))
            ci = _table_cell(lst, vp, (x, y, cell_w, cell_h), color,
                             flags=cell_flags, corners=4)
            tone = 42 + (row * 7 + col * 17) % 72
            _table_cell(lst, ci, (x - 12, y + 4, cell_w + 24, 5),
                        (36, 120 + (row * 5) % 80, 235, 255), corners=2)
            _table_cell(lst, ci, (x + cell_w * 0.38, y - 5, cell_w * 0.74,
                                  cell_h + 10),
                        (tone, 170 - (col * 11) % 70, 220, 255), corners=3)
            _table_cell(lst, ci, (x + 7, y + cell_h - 7, cell_w - 14, 8),
                        (190 + (row + col) % 30, 210, 220, 255), corners=2)
    out = RendersArray()
    out.set_layer(0, lst)
    return out


def _nonclip_scene(w: float, h: float, rows: int, cols: int) -> RendersArray:
    """The flat table without masks (bench_clipmask.make_nonclip_scene, from
    windy_non_clip_benchmark.nim makeNonClipRenderTree), the control of the
    clipped tables."""
    margin, gap, cell_h = 18.0, 5.0, 18.0
    cell_w = (w - margin * 2 - gap * (cols - 1)) / cols
    lst = RenderListArray(capacity=1 + rows * cols)
    _table_cell(lst, -1, (0, 0, w, h), (248, 249, 251, 255))
    for row in range(rows):
        y = margin + row * (cell_h + gap)
        for col in range(cols):
            x = margin + col * (cell_w + gap)
            shade = 220 + (row * 3 + col * 7) % 35
            accent = 80 + (row * 11 + col * 13) % 90
            _table_cell(lst, -1, (x, y, cell_w, cell_h),
                        (shade, 245 - (col % 5) * 5, accent, 255), corners=4)
    out = RendersArray()
    out.set_layer(0, lst)
    return out


def make_clip_table_scene(kind: str, w: float = 1200.0, h: float = 800.0,
                          rows: int = 180, cols: int = 6) -> RendersArray:
    """One of bench_clipmask's three scenes by its name: "noclip",
    "rectmask" or "subclip"."""
    if kind == "noclip":
        return _nonclip_scene(w, h, rows, cols)
    if kind not in ("rectmask", "subclip"):
        raise ValueError(f"unknown table kind {kind!r}")
    return _table_scene(kind, w, h, rows, cols)


# --- the image benchmark scenes --------------------------------------------------
#
# bench_images.py (the windy_image_renderlist class of workload): n panels of
# a rounded box and an image at 1080p. The node rows are byte-identical to
# figdraw_tpu's from_renders of bench_images.build_scene.

# figdraw_tpu's frames of the reduced image scenes (480x270, 25 panels) and
# bench_text's stored plan, made by tests/torch_reference.py
REFERENCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "reference")
TEXT_REFERENCE = os.path.join(REFERENCE_DIR, "text_1200x800.npz")
TEXT_TABLE_REFERENCE = os.path.join(REFERENCE_DIR, "textclip_1200x800.npz")

IMAGE_ID = 7001  # bench_images.IMG_ID
IMAGE_SRC = 64  # the source image's edge (bench_images.SRC)
IMAGE_VARIANTS = ("sdf_control", "images_11", "images_scaled", "images_mixed",
                  "images_clipped")


def image_reference_path(variant: str) -> str:
    """The stored 8x8 block means of figdraw_tpu's 480x270, 25-panel frame
    of an image variant."""
    name = variant[len("images_"):] if variant.startswith("images_") else variant
    return os.path.join(REFERENCE_DIR, f"images_{name}_480x270_blocks8.npy")


def load_text_plan(path: str = TEXT_REFERENCE):
    """bench_text's frame (1200x800, 36 lines of DejaVuSans at 15 px) as
    figdraw_tpu planned it, stored because the port has no text host
    pipeline yet: (ExecPlan, (S, S, 4) f32 atlas its glyph uv point into,
    (100, 150, 4) 8x8 block means of figdraw_tpu's frame)."""
    from .plan import from_jax_plan

    with np.load(path) as z:
        jax_plan = SimpleNamespace(
            combo=z["combo"], bounds=z["bounds"].tolist(),
            structure=[tuple(item) for item in json.loads(str(z["structure"]))],
            radii=z["radii"].tolist(), height=int(z["height"]),
            width=int(z["width"]), n_masks=int(z["n_masks"]),
            tile_h=int(z["tile_h"]), has_init_frame=bool(z["has_init_frame"]),
            mega_combo=None)
        return from_jax_plan(jax_plan), z["atlas"].copy(), z["blocks"].copy()


def load_text_tape(path: str = TEXT_TABLE_REFERENCE):
    """A table of text in clipped cells (1200x800: bench_clipmask's 180 rows
    x 6 cells in a clipped viewport, each cell clipping a line of DejaVuSans
    at 13 px that spills over it) as figdraw_tpu flattened it, stored
    because the port has no text host pipeline yet: (Tape, (S, S, 4) f32
    atlas its glyph uv point into, (100, 150, 4) 8x8 block means of
    figdraw_tpu's frame). The tape is what the port's own walk would hand
    to plan.plan_execution: the packed combo with its one meta row (the
    clear color), the pass items, the structure and the tile density."""
    from .tape import ClearMaskItem, DrawItem, Tape

    with np.load(path) as z:
        structure = [tuple(item) for item in json.loads(str(z["structure"]))]
        bounds = [tuple(b) for b in z["bounds"].tolist()]
        tape = Tape()
        tape.count = int(z["count"])
        tape.combo = z["combo"].copy()
        tape.combo_quads = tape.combo.shape[0] - 1
        tape.mask_count = int(z["n_masks"]) - 1
        tape.frame_size = (float(z["width"]), float(z["height"]))
        tape.clear_color = tuple(float(v) for v in tape.combo[-1, :4])
        runs = iter(bounds)
        for item in structure:
            if item[0] == "clear_mask":
                tape.items.append(ClearMaskItem(index=int(item[1])))
            else:
                start, end = next(runs)
                tape.items.append(DrawItem(target=int(item[1]), start=start, end=end))
        tape.structure_cache = (structure, bounds, [],
                                any(it[0] == "draw" and it[2] for it in structure),
                                False)
        tape.tile_density = tuple(float(v) for v in z["density"])
        return tape, z["atlas"].copy(), z["blocks"].copy()


# --- the text scenes, typeset by the port ---------------------------------------------

TEXT_SIZE = (1200, 800)  # bench_text.py's W, H
TEXT_LINES = 36  # bench_text.LINES


TEXT_LINE = "The quick brown fox jumps over the lazy dog near the riverbank %d"
TABLE_CELL = "cell r{row}c{col} spills wide past its clip"


def make_text_scene(tid: int, ink, seed: int, w: int = TEXT_SIZE[0],
                    h: int = TEXT_SIZE[1], lines: int = TEXT_LINES, variations=(),
                    text: str = TEXT_LINE):
    """bench_text.build_scene with the port's API: a plain background and
    `lines` lines of the typeface `tid` at 15 px (typeset_cached), 22 px
    apart, at the variation location `variations` (FontVariation objects;
    none by default), each line `text` % (seed + row) (bench_text's line
    by default). Returns (RendersArray, number of arranged glyphs).
    Its packed combo and its atlas are figdraw_tpu's byte for byte (the
    stored TEXT_REFERENCE holds them, for DejaVuSans, seed 0,
    atlas_size=512; reference/fonts.json their digests for the FigPort Sans
    faces)."""
    from .text.layout import typeset_cached
    from .text.typefaces import FigFont

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(250, 250, 250, 255))))
    y = 4.0
    n = 0
    for row in range(lines):
        f = FigFont(typeface_id=tid, size=15.0, variations=tuple(variations))
        arr = typeset_cached(vec2(w - 20, 22), [(f, ink, text % (seed + row))])
        n += len(arr.arranged_glyphs)
        renders.add_root(0, Fig(kind=FigKind.nkText,
                                screen_box=rect(8, y, w - 20, 22),
                                text_layout=arr))
        y += 22.0
    return from_renders(renders), n


# --- the FigPort Sans faces (CFF, variable glyf and CFF2, WOFF, VARC, WOFF2) ---------

FONTS_REFERENCE = os.path.join(REFERENCE_DIR, "fonts.json")
# the faces tools/make_port_faces.py writes
FONT_FACES = ("FigPortSans-CFF.otf", "FigPortSans-VF.ttf", "FigPortSans-VF.otf",
              "FigPortSans-VF.woff", "FigPortSans-VARC.ttf", "FigPortSans-VF.woff2",
              "FigPortSans-CFF.woff2")
# the WOFF 2.0 faces: DejaVu Sans as the web serves it, and two written
# through fontTools' WOFF2Writer (glyf, loca and hmtx transformed; CFF)
WOFF2_FACES = ("DejaVuSans.woff2", "FigPortSans-VF.woff2", "FigPortSans-CFF.woff2")
# every face whose outline digests reference/fonts.json holds
FONT_OUTLINE_FACES = FONT_FACES + ("DejaVuSans.woff2",)
# (tag, value) pairs: the default, then each axis at its minimum, a middle
# (wdth 90 is where avar maps 90 to 85) and its maximum
FONT_LOCATIONS = ((), (("wdth", 75.0),), (("wdth", 90.0),), (("wdth", 125.0),),
                  (("slnt", -12.0),), (("slnt", -6.0),), (("slnt", 0.0),))
# bench_text's scene from each face: (face, location)
FONT_TEXT_CASES = (("FigPortSans-CFF.otf", ()),
                   ("FigPortSans-VF.ttf", (("wdth", 75.0),)),
                   ("FigPortSans-VF.ttf", (("wdth", 125.0), ("slnt", -12.0))),
                   ("FigPortSans-VF.otf", (("wdth", 75.0),)),
                   ("FigPortSans-VF.otf", (("wdth", 125.0), ("slnt", -12.0))),
                   ("FigPortSans-VF.woff", (("wdth", 75.0),)),
                   ("FigPortSans-VARC.ttf", (("wdth", 125.0), ("slnt", -12.0))),
                   ("DejaVuSans.woff2", ()),
                   ("FigPortSans-VF.woff2", (("wdth", 75.0),)),
                   ("FigPortSans-CFF.woff2", ()))
FONT_TABLE_CASE = ("FigPortSans-VF.otf", (("wdth", 90.0), ("slnt", -6.0)))
# the text table from the VARC face (on the megakernel with the atlas)
FONT_VARC_TABLE_CASE = ("FigPortSans-VARC.ttf", (("wdth", 112.5), ("slnt", -6.0)))
# the text table from the glyf variable face as WOFF 2.0
FONT_WOFF2_TABLE_CASE = ("FigPortSans-VF.woff2", (("wdth", 125.0), ("slnt", -6.0)))
FONT_TABLE_CASES = (FONT_TABLE_CASE, FONT_VARC_TABLE_CASE, FONT_WOFF2_TABLE_CASE)
FONT_PACK_CASES = (("FigPortSans-VF.ttf", (("wdth", 75.0),)),
                   ("FigPortSans-VF.ttf", (("wdth", 125.0), ("slnt", -12.0))),
                   ("FigPortSans-VF.woff", (("wdth", 75.0),)))
# the lines a face's scenes set where bench_text's would draw none of its
# own glyphs: the VARC face's variable composites are the accented letters
FONT_TEXTS = {"FigPortSans-VARC.ttf": (
    "ÀÁÂÃÄ ÈÉÊ Ça déjà vu, Ñandú, Œuvre, Žluťoučký kůň úpěl ďábelské ódy %d",
    "Çéll r{row}c{col} ÀÁÂÃÄ ÈÉÊ spïlls wíde")}


def font_text(face: str) -> tuple:
    """(bench_text's line, the text table's cell) for a face's scenes."""
    return FONT_TEXTS.get(face, (TEXT_LINE, TABLE_CELL))


def font_case_key(face: str, location) -> str:
    """A face and a location as one name: "FigPortSans-VF.ttf@wdth=75,slnt=-12"."""
    return face + "@" + ",".join(f"{t}={v:g}" for t, v in location)


def font_blocks_path(key: str) -> str:
    """The stored 8x8 block means of figdraw_tpu's frame of a font case."""
    stem = key.replace(".", "_").replace("@", "_").replace("=", "").replace(",", "_")
    stem = stem.rstrip("_")
    return os.path.join(REFERENCE_DIR, f"font_{stem}_blocks8.npy")


def _digest_number(v) -> str:
    return repr(float(v) + 0.0)  # ints and floats alike, -0.0 as 0.0


def outline_digests(tf, variations) -> tuple:
    """(sha256 of every glyph's outline, sha256 of every glyph's advance) of
    a typeface at a location: the recording-pen value lists and
    var_advance, numbers written as floats, so figdraw_tpu's typeface (on
    fontTools) and the port's hash alike when their values are equal."""
    import hashlib

    paths, advances = hashlib.sha256(), hashlib.sha256()
    for gid in range(len(tf._glyph_order)):
        for op, pts in tf.glyph_path(gid, variations):
            paths.update(op.encode())
            for pt in pts:
                paths.update(b"N" if pt is None else
                             (_digest_number(pt[0]) + "," + _digest_number(pt[1]) + ";").encode())
        advances.update((_digest_number(tf.var_advance(gid, variations)) + ";").encode())
    return paths.hexdigest(), advances.hexdigest()


def array_digest(a, zero_sign: bool = False) -> str:
    """sha256 of an array's 32-bit words; with `zero_sign` a -0.0 word
    hashes as +0.0 (a Python walk's integer snap, see load_text_tape)."""
    import hashlib

    words = np.ascontiguousarray(a).view(np.uint32)
    if zero_sign:
        words = np.where((words & np.uint32(0x7FFFFFFF)) == 0, np.uint32(0), words)
    return hashlib.sha256(words.tobytes()).hexdigest()


def make_text_table_scene(rows: int = 180, cols: int = 6, w: float = 1200.0,
                          h: float = 800.0, tid: int = None, variations=(),
                          text: str = TABLE_CELL) -> Renders:
    """A table of text in clipped cells, as a tree (the text-in-clip scene at
    bench_clipmask.make_table_scene's size and layout): a clipped viewport
    scrolled by 37 px over rows x cols rounded cells of 22 px, each
    clipping a 13 px line of the typeface `tid` (default: the bundled
    DejaVuSans) at the variation location `variations` that runs past its
    right edge (`text` formatted with the cell's row and col). Its tape is the one TEXT_TABLE_REFERENCE stores, made by
    figdraw_tpu's Python walk."""
    from .text.layout import typeset
    from .text.typefaces import FigFont, bundled_font_path, load_typeface

    if tid is None:
        tid = load_typeface(bundled_font_path())
    f = FigFont(typeface_id=tid, size=13.0, variations=tuple(variations))
    margin, gap, cell_h, scroll_y = 22.0, 4.0, 22.0, 37.0
    viewport = rect(margin, margin, w - margin * 2, h - margin * 2)
    cell_w = (viewport.w - gap * (cols + 1)) / cols
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(248, 249, 251, 255))))
    vp = lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=viewport,
                          fill=fill(rgba(232, 235, 240, 255)), corners=(10,) * 4,
                          flags=FigFlags.NfClipContent))
    for row in range(rows):
        y = viewport.y + gap + row * (cell_h + gap) - scroll_y
        for col in range(cols):
            cell = rect(viewport.x + gap + col * (cell_w + gap), y, cell_w, cell_h)
            shade = 255 if (row + col) % 2 == 0 else 244
            ci = lst.add_child(vp, Fig(
                kind=FigKind.nkRectangle, screen_box=cell, corners=(4,) * 4,
                flags=FigFlags.NfClipContent,
                fill=fill(rgba(shade, shade, 255, 255))))
            arr = typeset(vec2(cell_w + 60, 20), [(
                f, fill(rgba(30, 30 + (row * 7) % 90, 40 + (col * 29) % 120, 255)),
                text.format(row=row, col=col))])
            lst.add_child(ci, Fig(
                kind=FigKind.nkText,
                screen_box=rect(cell.x + 4, cell.y + 3, cell_w + 60, 20),
                text_layout=arr))
    renders = Renders()
    renders.set_layer(0, lst)
    return renders


def photo_image(edge: int = IMAGE_SRC) -> np.ndarray:
    """bench_images._photo_image: a deterministic (edge, edge, 4) uint8
    'photo' of smooth gradients and a checker of hard edges."""
    y, x = np.mgrid[0:edge, 0:edge]
    img = np.zeros((edge, edge, 4), np.uint8)
    img[..., 0] = (x * 255 / edge).astype(np.uint8)
    img[..., 1] = (y * 255 / edge).astype(np.uint8)
    img[..., 2] = ((x + y) * 127 / edge).astype(np.uint8)
    img[(x // 8 + y // 8) % 2 == 0, 2] = 220
    img[..., 3] = 255
    return img


def _image_node(lst, parent, box, image_id):
    row = lst.add_root_raw() if parent < 0 else lst.add_child_raw(parent)
    n = lst.nodes
    n["kind"][row] = int(FigKind.nkImage)
    n["box"][row] = box
    n["image_id"][row] = image_id
    n["image_fill"]["c0"][row] = (255, 255, 255, 255)  # image_style's white tint
    return row


def make_image_panels_scene(w: float, h: float, n: int,
                            variant: str) -> RendersArray:
    """bench_images.build_scene(n, variant) at a (w, h) frame, in array form.
    Each of n seeded panels (seed 777) is a 104x104 rounded box plus:

    sdf_control: an 80x80 rounded box (no image);
    images_11: the 64x64 image at its native size (1:1 atlas quads);
    images_scaled: the image at 80, 40 or 96 px (minified draws of a
      mipmapped image take a second, trilinear quad);
    images_mixed: the scaled image, then a drop-shadowed translucent box
      (one draw run carries both kinds);
    images_clipped: the panel clips its content (NfClipContent, a mask
      plane each) and its child is a 96x96 image at (x + 24, y + 24), which
      the clip cuts: photo thumbnails in rounded cards. Not in
      bench_images.py: its > 24 pass items drive the rolled executor."""
    if variant not in IMAGE_VARIANTS:
        raise ValueError(f"unknown image variant {variant!r}")
    rng = np.random.RandomState(777)
    lst = RenderListArray(capacity=1 + 3 * n)
    _rect_node(lst, lst.add_root_raw(), (0, 0, w, h), (30, 30, 30, 255),
               midpos=0)
    for i in range(n):
        x = float(rng.uniform(0, w - 120))
        y = float(rng.uniform(0, h - 120))
        flags = int(FigFlags.NfClipContent) if variant == "images_clipped" else 0
        panel = lst.add_root_raw()
        _rect_node(lst, panel, (x, y, 104, 104), (80, 80, 80, 255), midpos=0,
                   corners=(12,) * 4, flags=flags)
        if variant == "sdf_control":
            _rect_node(lst, lst.add_root_raw(), (x + 12, y + 12, 80, 80),
                       (120 + i % 90, 90, 200, 255), midpos=0,
                       corners=(6,) * 4)
            continue
        if variant == "images_clipped":
            _image_node(lst, panel, (x + 24, y + 24, 96, 96), IMAGE_ID)
            continue
        if variant == "images_11":
            box = (x + 20, y + 20, IMAGE_SRC, IMAGE_SRC)
        else:
            s = (80, 40, 96)[i % 3]
            box = (x + 12, y + 12, s, s)
        _image_node(lst, -1, box, IMAGE_ID)
        if variant == "images_mixed":
            r = lst.add_root_raw()
            _rect_node(lst, r, (x + 60, y + 60, 70, 50), (200, 160, 60, 200),
                       midpos=0, corners=(8,) * 4)
            sh = lst.nodes["shadows"][r]
            sh["style"][0] = int(ShadowStyle.DropShadow)
            sh["blur"][0] = 8.0
            sh["spread"][0] = 3.0
            sh["x"][0] = 4.0
            sh["y"][0] = 4.0
            sh["fill"]["c0"][0] = (0, 0, 0, 140)
    out = RendersArray()
    out.set_layer(0, lst)
    return out


# --- tree-form scenes -------------------------------------------------------------
#
# Built with the port's own Fig API, node for node as their sources build
# them with figdraw_tpu's: bench.py's headline (figdraw_tpu/scenes.py
# make_render_tree), bench_clipmask.py's tables (make_table_scene,
# make_nonclip_scene) and the scenes of examples/layers_clip.py,
# examples/drawable_beziers.py and examples/dashed_dotted_borders.py.

def make_render_tree(w: float, h: float, frame: int, copies: int = 100) -> Renders:
    """bench.py's headline scene as a Fig tree (scenes.make_render_tree of
    the JAX package): the same scene as make_render_tree_array, built node
    by node; from_renders of it holds make_render_tree_array's rows up to the
    f32 round trip of the animated columns."""
    lst = RenderList()
    t = frame * 0.02

    lst.add_root(
        Fig(
            kind=FigKind.nkRectangle,
            zlevel=0,
            screen_box=rect(0, 0, w, h),
            fill=fill(rgba(255, 255, 255, 155)),
        )
    )

    red_start = (60.0, 60.0)
    green_start = (320.0, 120.0)
    blue_start = (180.0, 300.0)
    max_w, max_h = 260.0, 180.0
    max_x = max(0.0, w - (green_start[0] + max_w))
    max_y = max(0.0, h - (blue_start[1] + max_h))

    rng = np.random.RandomState(12345)
    base_xs = rng.uniform(0.0, max_x, size=copies)
    base_ys = rng.uniform(0.0, max_y, size=copies)

    for i in range(copies):
        jitter_x = math.sin(t + i * 0.15) * 20
        jitter_y = math.cos(t * 0.9 + i * 0.2) * 20
        off_x = min(max(base_xs[i] + jitter_x, 0.0), max_x)
        off_y = min(max(base_ys[i] + jitter_y, 0.0), max_y)

        pulse_w = 0.5 + 0.5 * math.sin(t * 0.8 + i * 0.07)
        pulse_h = 0.5 + 0.5 * math.cos(t * 0.65 + i * 0.09)
        red_w = 160.0 + 100.0 * pulse_w
        red_h = 110.0 + 70.0 * pulse_h
        green_w = 160.0 + 100.0 * pulse_h
        green_h = 110.0 + 70.0 * pulse_w
        blue_w = 160.0 + 100.0 * (1.0 - pulse_w)
        blue_h = 110.0 + 70.0 * (1.0 - pulse_h)

        cp = 0.5 + 0.5 * math.sin(t * 1.25 + i * 0.11)
        c0 = 4.0 + 26.0 * cp
        c1 = 6.0 + 22.0 * (1.0 - cp)
        c2 = 8.0 + 18.0 * (0.5 + 0.5 * math.sin(t * 0.7 + i * 0.05))
        c3 = 10.0 + 16.0 * (0.5 + 0.5 * math.cos(t * 0.8 + i * 0.06))

        gp = 0.5 + 0.5 * math.cos(t * 0.95 + i * 0.08)
        g0 = 6.0 + 22.0 * gp
        g1 = 8.0 + 18.0 * (1.0 - gp)
        g2 = 10.0 + 16.0 * (0.5 + 0.5 * math.cos(t * 0.75 + i * 0.04))
        g3 = 12.0 + 14.0 * (0.5 + 0.5 * math.sin(t * 0.85 + i * 0.05))

        sp = 0.5 + 0.5 * math.sin(t * 1.1 + i * 0.05)
        shadow_blur = max(0.0, 6.0 + 18.0 * sp)
        shadow_spread = max(0.0, 4.0 + 20.0 * (1.0 - sp))
        shadow_x = 6.0 + 10.0 * math.sin(t * 0.9 + i * 0.03)
        shadow_y = 6.0 + 10.0 * math.cos(t * 0.9 + i * 0.03)
        ip = 0.5 + 0.5 * math.sin(t * 1.05 + i * 0.06)
        inset_blur = max(0.0, 8.0 + 10.0 * ip)
        inset_spread = max(0.0, 2.0 + 10.0 * (1.0 - ip))
        inset_x = 6.0 * math.sin(t * 0.85 + i * 0.04)
        inset_y = 6.0 * math.cos(t * 0.8 + i * 0.04)
        use_green_gradient = (i % 2) == 0
        use_blue_gradient = (i % 3) == 0

        lst.add_root(
            Fig(
                kind=FigKind.nkRectangle,
                zlevel=0,
                corners=(int(c0), int(c1), int(c2), int(c3)),
                corner_radii_y=(int(c0), int(c1 * 2), int(c2), int(c3 * 2)),
                flags=FigFlags.NfEllipticalCorners,
                screen_box=rect(red_start[0] + off_x, red_start[1] + off_y, red_w, red_h),
                fill=fill(rgba(220, 40, 40, 155)),
                stroke=RenderStroke(weight=5.0, fill=fill(rgba(0, 0, 0, 155))),
            )
        )

        green_fill = (
            linear(
                rgba(18, 112, 64, 255),
                rgba(40, 180, 90, 255),
                rgba(78, 224, 188, 255),
                axis=(
                    FillGradientAxis.fgaX
                    if (i % 4) < 2
                    else FillGradientAxis.fgaDiagTLBR
                ),
                mid_pos=128,
            )
            if use_green_gradient
            else fill(rgba(40, 180, 90, 155))
        )
        lst.add_root(
            Fig(
                kind=FigKind.nkRectangle,
                zlevel=0,
                screen_box=rect(
                    green_start[0] + off_x, green_start[1] + off_y, green_w, green_h
                ),
                corners=(int(g0), int(g1), int(g2), int(g3)),
                fill=green_fill,
                shadows=(
                    RenderShadow(
                        style=ShadowStyle.DropShadow,
                        blur=shadow_blur,
                        spread=shadow_spread,
                        x=shadow_x,
                        y=shadow_y,
                        fill=fill(rgba(0, 0, 0, 155)),
                    ),
                ),
            )
        )

        blue_fill = (
            linear(
                rgba(44, 72, 186, 255),
                rgba(60, 90, 220, 255),
                rgba(118, 168, 255, 255),
                axis=(
                    FillGradientAxis.fgaY
                    if (i % 2) == 0
                    else FillGradientAxis.fgaDiagBLTR
                ),
                mid_pos=132,
            )
            if use_blue_gradient
            else fill(rgba(60, 90, 220, 155))
        )
        inner_fill = (
            linear(rgba(25, 25, 40, 100), rgba(65, 65, 95, 180),
                   axis=FillGradientAxis.fgaDiagBLTR)
            if use_blue_gradient
            else fill(rgba(40, 40, 60, 150))
        )
        lst.add_root(
            Fig(
                kind=FigKind.nkRectangle,
                zlevel=0,
                screen_box=rect(
                    blue_start[0] + off_x, blue_start[1] + off_y, blue_w, blue_h
                ),
                fill=blue_fill,
                stroke=RenderStroke(weight=4.0, fill=fill(rgba(255, 255, 255, 210))),
                shadows=(
                    RenderShadow(
                        style=ShadowStyle.InnerShadow,
                        blur=inset_blur,
                        spread=inset_spread,
                        x=inset_x,
                        y=inset_y,
                        fill=inner_fill,
                    ),
                ),
            )
        )

    # elliptical orange pill
    lst.add_root(
        Fig(
            kind=FigKind.nkRectangle,
            zlevel=0,
            screen_box=rect(max(20.0, w - 200.0), 20, 180, 100),
            fill=fill(rgba(238, 140, 30, 220)),
            corners=(90, 90, 90, 90),
            corner_radii_y=(50, 50, 50, 50),
            flags=FigFlags.NfEllipticalCorners,
            stroke=RenderStroke(weight=4.0, fill=fill(rgba(90, 45, 0, 220))),
        )
    )

    # moving backdrop-blur panel + yellow overlay
    yw, yh, ym = 360.0, 240.0, 20.0
    travel_x = max(0.0, w - yw - ym * 2.0)
    travel_y = max(0.0, h - yh - ym * 2.0)
    yx = ym + travel_x * (0.5 + 0.5 * math.sin(t * 0.33))
    yy = ym + travel_y * (0.5 + 0.5 * math.cos(t * 0.41))
    yc = 20.0 + 12.0 * (0.5 + 0.5 * math.sin(t * 0.7))

    lst.add_root(
        Fig(
            kind=FigKind.nkBackdropBlur,
            zlevel=0,
            corners=(int(yc),) * 4,
            screen_box=rect(yx, yy, yw, yh),
            fill=fill(rgba(0, 0, 0, 0)),
            backdrop_blur=BackdropBlurStyle(blur=18.0),
        )
    )
    lst.add_root(
        Fig(
            kind=FigKind.nkRectangle,
            zlevel=0,
            corners=(int(yc),) * 4,
            screen_box=rect(yx, yy, yw, yh),
            fill=fill(rgba(255, 225, 55, 120)),
            stroke=RenderStroke(weight=6.0, fill=fill(rgba(95, 72, 0, 185))),
        )
    )

    renders = new_renders()
    renders.set_layer(0, lst)
    return renders


def _tree_rect(box, color, flags=0, corners=0, zlevel=0) -> Fig:
    return Fig(kind=FigKind.nkRectangle, zlevel=zlevel, screen_box=box,
               fill=fill(color), corners=(corners,) * 4, flags=flags)


def make_table_scene(kind: str, w: float = 1200.0, h: float = 800.0,
                     rows: int = 180, cols: int = 6) -> Renders:
    """bench_clipmask.make_table_scene as a tree: kind "subclip" (every cell
    clips with a mask plane) or "rectmask" (the rect-mask fast path).
    from_renders of it equals make_clip_table_scene(kind, ...) byte for
    byte."""
    if kind not in ("rectmask", "subclip"):
        raise ValueError(f"unknown table kind {kind!r}")
    margin, gap = 22.0, 4.0
    viewport = rect(margin, margin, w - margin * 2, h - margin * 2)
    cell_h = 22.0
    cell_w = (viewport.w - gap * (cols + 1)) / cols
    scroll_y = 37.0

    lst = RenderList()
    lst.add_root(_tree_rect(rect(0, 0, w, h), rgba(248, 249, 251, 255)))
    vp = lst.add_root(_tree_rect(viewport, rgba(232, 235, 240, 255),
                                 flags=FigFlags.NfClipContent, corners=10))
    cell_flags = (FigFlags.NfClipContent if kind == "subclip"
                  else FigFlags.NfRectMaskContent)
    for row in range(rows):
        y = viewport.y + gap + row * (cell_h + gap) - scroll_y
        for col in range(cols):
            x = viewport.x + gap + col * (cell_w + gap)
            cell = rect(x, y, cell_w, cell_h)
            color = (rgba(255, 255, 255, 255) if (row + col) % 2 == 0
                     else rgba(242, 246, 250, 255))
            ci = lst.add_child(vp, _tree_rect(cell, color, flags=cell_flags,
                                              corners=4))
            tone = 42 + (row * 7 + col * 17) % 72
            lst.add_child(ci, _tree_rect(
                rect(cell.x - 12, cell.y + 4, cell.w + 24, 5),
                rgba(36, 120 + (row * 5) % 80, 235, 255), corners=2))
            lst.add_child(ci, _tree_rect(
                rect(cell.x + cell.w * 0.38, cell.y - 5, cell.w * 0.74, cell.h + 10),
                rgba(tone, 170 - (col * 11) % 70, 220, 255), corners=3))
            lst.add_child(ci, _tree_rect(
                rect(cell.x + 7, cell.y + cell.h - 7, cell.w - 14, 8),
                rgba(190 + (row + col) % 30, 210, 220, 255), corners=2))
    renders = new_renders()
    renders.set_layer(0, lst)
    return renders


def make_nonclip_scene(w: float = 1200.0, h: float = 800.0, rows: int = 180,
                       cols: int = 6) -> Renders:
    """bench_clipmask.make_nonclip_scene as a tree, the control of the
    clipped tables: plain rounded cells, no masks."""
    margin, gap, cell_h = 18.0, 5.0, 18.0
    cell_w = (w - margin * 2 - gap * (cols - 1)) / cols
    lst = RenderList()
    lst.add_root(_tree_rect(rect(0, 0, w, h), rgba(248, 249, 251, 255)))
    for row in range(rows):
        y = margin + row * (cell_h + gap)
        for col in range(cols):
            x = margin + col * (cell_w + gap)
            shade = 220 + (row * 3 + col * 7) % 35
            accent = 80 + (row * 11 + col * 13) % 90
            lst.add_root(_tree_rect(rect(x, y, cell_w, cell_h),
                                    rgba(shade, 245 - (col % 5) * 5, accent, 255),
                                    corners=4))
    renders = new_renders()
    renders.set_layer(0, lst)
    return renders


# the example scenes' own frame sizes
LAYERS_CLIP_SIZE = (900, 560)
DRAWABLE_BEZIERS_SIZE = (760, 560)
DASHED_BORDERS_SIZE = (820, 560)


def make_layers_clip_scene(w: float = 900.0, h: float = 560.0,
                           slide: float = 12.0) -> Renders:
    """examples/layers_clip.py's scene: ZLevel layers around a z=0 plane with
    two containers, one clipping its overflowing button with a rounded
    mask plane and one with the rect-mask fast path, and buttons under
    (z=-5) and over (z=5) them. slide 12 is the example's last frame."""
    def fig(box, color, z, clip=False, rect_mask=False, corners=10):
        flags = FigFlags(0)
        if clip:
            flags |= FigFlags.NfClipContent
        if rect_mask:
            flags |= FigFlags.NfRectMaskContent
        return _tree_rect(box, color, flags=flags, corners=corners, zlevel=z)

    bg = rgba(255, 255, 255, 255)
    container = rgba(208, 208, 208, 255)
    button = rgba(43, 159, 234, 255)
    under = rgba(234, 96, 43, 255)
    over = rgba(80, 200, 120, 255)
    cw, ch = w * 0.30, w * 0.40
    cy = h * 0.10
    clx, crx = w * 0.03, w * 0.50
    bx = cw * 0.10 + slide
    bw, bh = cw * 1.30, ch * 0.20
    by1, by2, by3 = ch * 0.15, ch * 0.45, ch * 0.75

    renders = new_renders()
    renders.add_root(-20, fig(rect(0, 0, w, h), bg, -20, corners=0))
    left = renders.add_root(0, fig(rect(clx, cy, cw, ch), container, 0, clip=True))
    right = renders.add_root(0, fig(rect(crx, cy, cw, ch), container, 0,
                                    rect_mask=True))
    renders.add_child(0, left, fig(rect(clx + bx, cy + by2, bw, bh), button, 0))
    renders.add_child(0, right, fig(rect(crx + bx, cy + by2, bw, bh), button, 0))
    renders.add_root(-5, fig(rect(clx + bx, cy + by3, bw, bh), under, -5))
    renders.add_root(-5, fig(rect(crx + bx, cy + by3, bw, bh), under, -5))
    renders.add_root(5, fig(rect(clx + bx, cy + by1, bw, bh), over, 5))
    renders.add_root(5, fig(rect(crx + bx, cy + by1, bw, bh), over, 5))
    return renders


def make_drawable_beziers_scene(w: float = 760.0, h: float = 560.0) -> Renders:
    """examples/drawable_beziers.py's scene: quadratic, cubic and 5-point
    beziers stroked with butt, square and round caps and bevel and round
    joins, their control polygons and points, two arc sweeps, a rounded
    rect drawable and endpoint markers."""
    def drawable(area, node_fill, stroke, ops, steps=0, aa=0.0):
        return Fig(kind=FigKind.nkDrawable, screen_box=area, fill=fill(node_fill),
                   draw_stroke=stroke, draw_steps=steps, draw_aa=aa,
                   draw_ops=tuple(ops))

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(246, 248, 252, 255))))
    margin = max(28.0, min(w, h) * 0.08)
    area = rect(margin, margin, w - margin * 2, h - margin * 2)

    def lp(x, y):
        return vec2(area.w * x, area.h * y)

    transparent = rgba(0, 0, 0, 0)
    blue, rose, green = (rgba(26, 99, 214, 255), rgba(221, 62, 125, 255),
                         rgba(40, 153, 94, 255))
    muted = {"blue": rgba(26, 99, 214, 70), "rose": rgba(221, 62, 125, 70),
             "green": rgba(40, 153, 94, 70), "ink": rgba(82, 92, 112, 120)}
    white = rgba(255, 255, 255, 230)
    quadratic = [lp(0.08, 0.72), lp(0.29, 0.10), lp(0.52, 0.64)]
    cubic = [lp(0.14, 0.38), lp(0.36, 0.04), lp(0.58, 0.94), lp(0.83, 0.42)]
    generic = [lp(0.10, 0.58), lp(0.25, 0.88), lp(0.43, 0.44), lp(0.64, 0.80),
               lp(0.91, 0.20)]
    arc_center = lp(0.76, 0.75)

    def add(node):
        renders.add_root(0, node)

    add(drawable(area, transparent,
                 RenderStroke(weight=3.0, fill=fill(muted["ink"]),
                              cap=StrokeCap.scSquare, join=StrokeJoin.sjBevel),
                 [drawable_arc(arc_center, min(area.w, area.h) * 0.10,
                               -math.pi * 1.10, math.pi * 1.35),
                  drawable_arc(arc_center, min(area.w, area.h) * 0.15,
                               -math.pi * 0.85, math.pi * 0.95)],
                 steps=24, aa=0.85))
    add(drawable(area, transparent,
                 RenderStroke(weight=2.0, fill=fill(rgba(80, 90, 110, 90))),
                 [drawable_rect(rect(18, 18, area.w - 36, area.h - 36),
                                corners=(16, 16, 16, 16))]))
    for pts, key in ((quadratic, "blue"), (cubic, "rose"), (generic, "green")):
        add(drawable(area, transparent,
                     RenderStroke(weight=1.4, fill=fill(muted[key])),
                     [drawable_line(pts[i], pts[i + 1]) for i in range(len(pts) - 1)]))
        add(drawable(area, muted[key],
                     RenderStroke(weight=1.5, fill=fill(white)),
                     [drawable_circle(p, 5.0) for p in pts]))
    add(drawable(area, transparent,
                 RenderStroke(weight=7.0, fill=fill(blue), cap=StrokeCap.scButt),
                 [drawable_bezier(quadratic)], aa=0.9))
    add(drawable(area, transparent,
                 RenderStroke(weight=8.0, fill=fill(rose), cap=StrokeCap.scSquare,
                              join=StrokeJoin.sjBevel),
                 [drawable_bezier(cubic)], steps=24, aa=0.9))
    add(drawable(area, transparent,
                 RenderStroke(weight=5.5, fill=fill(green), cap=StrokeCap.scRound,
                              join=StrokeJoin.sjRound),
                 [drawable_bezier(generic)], steps=32, aa=0.9))
    for p, c, r in ((lp(0.52, 0.64), blue, 9.0), (lp(0.83, 0.42), rose, 9.0),
                    (lp(0.91, 0.20), green, 8.0)):
        add(drawable(area, c, RenderStroke(weight=2.0, fill=fill(white)),
                     [drawable_circle(p, r)]))
    return renders


def make_dashed_borders_scene(w: float = 820.0, h: float = 560.0,
                              phase: float = 5.0) -> Renders:
    """examples/dashed_dotted_borders.py's scene: a 3x2 grid of shadowed
    cards, each with a solid, dashed (butt or round caps), dotted or
    marching-ants rounded-rect border from borders.py; phase 5 is the
    example's frame."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(236, 240, 247, 255))))
    cols, rows = 3, 2
    pad, gap = 36.0, 28.0
    card_w = (w - pad * 2 - gap * (cols - 1)) / cols
    card_h = (h - pad * 2 - gap * (rows - 1)) / rows
    ink = rgba(34, 48, 74, 255)
    blue = rgba(26, 99, 214, 255)
    rose = rgba(221, 62, 125, 255)
    green = rgba(40, 153, 94, 255)
    borders = [
        lambda box: fig_rounded_rect_border(box, (14, 14, 14, 14), fill(ink), 3.0),
        lambda box: fig_dashed_rounded_rect_border(
            box, (14, 14, 14, 14), fill(blue), 3.0, dash_length=14.0,
            gap_length=8.0),
        lambda box: fig_dashed_rounded_rect_border(
            box, (22, 22, 22, 22), fill(rose), 5.0, dash_length=2.0,
            gap_length=12.0, cap=StrokeCap.scRound),
        lambda box: fig_dotted_rounded_rect_border(
            box, (14, 14, 14, 14), fill(green), 5.0, gap_length=7.0),
        lambda box: fig_dotted_rounded_rect_border(
            box, (28, 28, 4, 4), fill(ink), 3.0, gap_length=3.0),
        lambda box: fig_dashed_rounded_rect_border(
            box, (10, 10, 10, 10), fill(blue), 2.0, dash_length=8.0,
            gap_length=6.0, offset=phase),
    ]
    i = 0
    for row in range(rows):
        for col in range(cols):
            x = pad + col * (card_w + gap)
            y = pad + row * (card_h + gap)
            renders.add_root(0, Fig(
                kind=FigKind.nkRectangle, screen_box=rect(x, y, card_w, card_h),
                fill=fill(rgba(255, 255, 255, 245)), corners=(14, 14, 14, 14),
                shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=14,
                                      spread=2, x=0, y=6,
                                      fill=fill(rgba(25, 35, 55, 34))),),
            ))
            renders.add_root(0, borders[i](rect(x + 18, y + 18, card_w - 36,
                                                card_h - 36)))
            i += 1
    return renders


# --- generated SDF images ---------------------------------------------------------

MSDF_STAR_SIZE = (760, 520)  # examples/msdf_star.py's W, H
STAR_ID = 9001  # msdf_star.STAR_ID
STAR_PX_RANGE = 8.0  # msdf_star.PX_RANGE
MTSDF_SIZE = (280, 100)
MTSDF_ID = 98  # test_images.py's synthetic MSDF image


def star_coverage(size: int = 96, points: int = 5,
                  inner_frac: float = 0.42) -> np.ndarray:
    """examples/msdf_star.py's star_coverage: the analytic coverage of a
    regular star polygon, 4x supersampled."""
    ss = 4
    n = size * ss
    yy, xx = np.mgrid[0:n, 0:n]
    cx = cy = n / 2.0
    px = (xx + 0.5 - cx) / (n / 2.0)
    py = (yy + 0.5 - cy) / (n / 2.0)
    r_outer = 0.92
    r_inner = r_outer * inner_frac
    verts = []
    for i in range(points * 2):
        ang = -math.pi / 2.0 + i * math.pi / points
        r = r_outer if i % 2 == 0 else r_inner
        verts.append((r * math.cos(ang), r * math.sin(ang)))
    # even-odd point-in-polygon over the supersampled grid
    inside = np.zeros((n, n), bool)
    m = len(verts)
    for i in range(m):
        x0, y0 = verts[i]
        x1, y1 = verts[(i + 1) % m]
        crosses = ((y0 > py) != (y1 > py)) & (
            px < (x1 - x0) * (py - y0) / (y1 - y0 + 1e-30) + x0
        )
        inside ^= crosses
    cov = inside.reshape(size, ss, size, ss).mean(axis=(1, 3))
    return cov.astype(np.float32)


def star_sdf() -> np.ndarray:
    """The star's SDF image as msdf_star.main publishes it: the port's
    utils.sdfgen.sdf_from_coverage of star_coverage(), px_range 8."""
    from .utils.sdfgen import sdf_from_coverage

    return sdf_from_coverage(star_coverage(), px_range=STAR_PX_RANGE)


def make_msdf_star_scene(w: float = 760.0, h: float = 520.0) -> Renders:
    """examples/msdf_star.py's make_scene: one star SDF (STAR_ID) drawn
    through nkMsdfImage at 24 to 300 px (mode 13), as outlines through
    stroke_weight (mode 15) and fattened through sd_threshold."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(24, 28, 40, 255))))

    def star(x, y, s, color, stroke_weight=0.0, sd_threshold=0.0):
        renders.add_root(0, Fig(
            kind=FigKind.nkMsdfImage, screen_box=rect(x, y, s, s),
            msdf_image=MsdfImageStyle(id=STAR_ID, fill=fill(color),
                                      px_range=STAR_PX_RANGE,
                                      sd_threshold=sd_threshold,
                                      stroke_weight=stroke_weight)))

    x = 36.0
    for s in (24.0, 48.0, 96.0, 180.0):
        star(x, h - s - 40.0, s, rgba(250, 200, 70, 255))
        x += s + 26.0
    star(430.0, 40.0, 300.0, rgba(90, 70, 190, 255))
    star(60.0, 60.0, 120.0, rgba(120, 190, 250, 255), stroke_weight=3.0)
    star(210.0, 90.0, 80.0, rgba(240, 110, 160, 255), stroke_weight=1.5)
    star(300.0, 60.0, 110.0, rgba(245, 245, 250, 255), sd_threshold=-0.12)
    return renders


def synthetic_msdf(size: int = 32, radius: float = 10.0,
                   px_range: float = 4.0) -> np.ndarray:
    """tests/test_images.py's synthetic_msdf: the true SDF of a circle in
    r, g and b (their median is the SDF) and in alpha (the MTSDF plane)."""
    yy, xx = np.mgrid[0:size, 0:size]
    d = np.sqrt((xx + 0.5 - size / 2) ** 2 + (yy + 0.5 - size / 2) ** 2)
    sd = (radius - d) / px_range + 0.5
    sd = np.clip(sd, 0.0, 1.0).astype(np.float32)
    return np.stack([sd, sd, sd, sd], axis=-1)


def make_mtsdf_scene(w: float = 280.0, h: float = 100.0) -> Renders:
    """test_images.py::test_mtsdf_and_annular_msdf_render's scene, widened
    by a third shape so that all four SDF image modes draw: an MTSDF disc
    (mode 14), an annular MSDF ring (15) and an annular MTSDF ring (16) of
    synthetic_msdf (MTSDF_ID) on a light background. The test's MTSDF node
    sets msdf_image, which an nkMtsdfImage does not read, so it draws
    nothing there; here each node sets the style its kind reads."""
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(250, 250, 250, 255))))
    lst.add_root(Fig(kind=FigKind.nkMtsdfImage, screen_box=rect(10, 20, 64, 64),
                     mtsdf_image=MsdfImageStyle(id=MTSDF_ID, fill=fill(rgba(20, 60, 200, 255)),
                                                px_range=4.0)))
    lst.add_root(Fig(kind=FigKind.nkMsdfImage, screen_box=rect(110, 20, 64, 64),
                     msdf_image=MsdfImageStyle(id=MTSDF_ID, fill=fill(rgba(200, 40, 40, 255)),
                                               px_range=4.0, stroke_weight=2.0)))
    lst.add_root(Fig(kind=FigKind.nkMtsdfImage, screen_box=rect(200, 20, 64, 64),
                     mtsdf_image=MsdfImageStyle(id=MTSDF_ID, fill=fill(rgba(30, 150, 60, 255)),
                                                px_range=4.0, stroke_weight=3.0)))
    renders = new_renders()
    renders.set_layer(0, lst)
    return renders


# --- images from files ------------------------------------------------------------

# the repo's PNG fixture the image-file scenes load: 800x600 RGBA8, rows
# filtered Sub, Up and Paeth
IMAGE_FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "tests", "goldens", "render_3d_overlay_gaussian.png")
IMAGE_FIXTURE_REFERENCE = os.path.join(REFERENCE_DIR, "image_fixture.json")
IMAGE_FILE_SIZE = (800, 600)  # examples/image_renderlist.py's W, H
PHOTO_WALL_SIZE = (1920, 1080)
PHOTO_WALL_PANELS = 48
PHOTO_WALL_EDGES = (400, 200, 100, 50)  # a panel's image edge, by i % 4
PHOTO_WALL_SMALL = (480, 270, 12)  # the stored reference's frame and panels
PHOTO_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_480x270_blocks8.npy")
# the stored files of the image decoders (tools/make_image_formats.py: from
# IMAGE_FIXTURE with PIL) and their digests; the baseline JPEG draws the
# image-file scene and the photo wall as the PNG does, against figdraw_tpu's
# block means of each from the same file
IMAGE_FORMATS_DIR = os.path.join(REFERENCE_DIR, "images")
IMAGE_FORMATS_REFERENCE = os.path.join(REFERENCE_DIR, "image_formats.json")
JPEG_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "baseline_420_q90.jpg")
JPEG_FILE_REFERENCE = os.path.join(REFERENCE_DIR, "example_image_file_jpeg_1x_blocks8.npy")
JPEG_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_jpeg_480x270_blocks8.npy")
# the fixture as an LZW + Predictor 2 TIFF, drawn likewise
TIFF_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_lzw_pred2.tif")
TIFF_FILE_REFERENCE = os.path.join(REFERENCE_DIR, "example_image_file_tiff_1x_blocks8.npy")
TIFF_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_tiff_480x270_blocks8.npy")
# the fixture as a lossy WebP at q 90, drawn likewise
WEBP_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_q90.webp")
WEBP_FILE_REFERENCE = os.path.join(REFERENCE_DIR, "example_image_file_webp_1x_blocks8.npy")
WEBP_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_webp_480x270_blocks8.npy")
# the fixture as a ZSTD + Predictor 2 TIFF, drawn likewise; the fixture
# dithered to 1 bit as a Group 3 2D fax, drawn in the image-file scene; a
# TIFF-F fax page (1728x1143) as Group 4, drawn in the photo wall, whose
# references start figdraw_tpu's atlas at FAX_ATLAS (it asserts on an image
# more than twice its edge)
ZSTD_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_zstd_pred2.tif")
ZSTD_FILE_REFERENCE = os.path.join(REFERENCE_DIR, "example_image_file_zstd_1x_blocks8.npy")
# the crop (left, top, right, bottom) of the fixture stored in 64x64 ZSTD
# tiles (fixture_zstd_tiles.tif), partial tiles at its right and bottom
ZSTD_TILES_BOX = (200, 150, 450, 340)
ZSTD_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_zstd_480x270_blocks8.npy")
G3_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_dither_g3_2d.tif")
G3_FILE_REFERENCE = os.path.join(REFERENCE_DIR, "example_image_file_g3_1x_blocks8.npy")
FAX_PAGE = os.path.join(IMAGE_FORMATS_DIR, "fax_page_g4.tif")
G4_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_g4_480x270_blocks8.npy")
FAX_ATLAS = 1024
# the fixture as a progressive arithmetic-coded JPEG (SOF10) with restarts,
# drawn in the image-file scene; a 224x168 crop of it as a lossless JPEG
# (SOF3, predictor 1), drawn in the photo wall
ARITH_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "arith_progressive_rst.jpg")
ARITH_FILE_REFERENCE = os.path.join(REFERENCE_DIR, "example_image_file_arith_1x_blocks8.npy")
LOSSLESS_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "lossless_crop_p1.jpg")
LOSSLESS_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_lossless_480x270_blocks8.npy")
# the fixture as a progressive Huffman JPEG whose scans leave the last
# bit of every AC coefficient unrefined (libjpeg smooths its blocks), and
# its centre (400x300) dithered to 1 bit as a CCITT RLE-W TIFF: each drawn
# in the image-file scene and on the photo wall
INCOMPLETE_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "progressive_incomplete_huff.jpg")
INCOMPLETE_FILE_REFERENCE = os.path.join(REFERENCE_DIR,
                                         "example_image_file_incomplete_1x_blocks8.npy")
INCOMPLETE_WALL_REFERENCE = os.path.join(REFERENCE_DIR,
                                         "photo_wall_incomplete_480x270_blocks8.npy")
RLEW_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "rlew_dither.tif")
RLEW_FILE_REFERENCE = os.path.join(REFERENCE_DIR, "example_image_file_rlew_1x_blocks8.npy")
RLEW_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_rlew_480x270_blocks8.npy")
# the fixture as PIL's default AVIF (quality 75, speed 6, 4:2:0), drawn in
# the image-file scene and on the photo wall
AVIF_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_q75.avif")
AVIF_FILE_REFERENCE = os.path.join(REFERENCE_DIR, "example_image_file_avif_1x_blocks8.npy")
AVIF_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_avif_480x270_blocks8.npy")
# the fixture as PIL's AVIF at speed 2 with aom's CDEF on (quality 75,
# 4:2:0; the frame turns on CDEF and loop restoration), drawn in the
# image-file scene and on the photo wall
AVIF_CDEF_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_s2_cdef.avif")
AVIF_CDEF_FILE_REFERENCE = os.path.join(REFERENCE_DIR,
                                        "example_image_file_avif_cdef_1x_blocks8.npy")
AVIF_CDEF_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_avif_cdef_480x270_blocks8.npy")
# the fixture as PIL's AVIF at 4:4:4 (AV1 profile 1; avifenc's default
# chroma), quality 75, speed 6, drawn in the image-file scene and on the
# photo wall
AVIF_444_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_444.avif")
AVIF_444_FILE_REFERENCE = os.path.join(REFERENCE_DIR, "example_image_file_avif_444_1x_blocks8.npy")
AVIF_444_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_avif_444_480x270_blocks8.npy")
# the fixture as PIL's AVIF at 4:2:2 (profile 2), speed 0 with CDEF (4:2:2's
# CDEF direction map, Wiener and self-guided units), marked limited-range
# BT.709 as camera and video files are
AVIF_422_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_422_limited_cdef.avif")
AVIF_422_FILE_REFERENCE = os.path.join(REFERENCE_DIR, "example_image_file_avif_422_1x_blocks8.npy")
AVIF_422_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_avif_422_480x270_blocks8.npy")
# the three made 10- and 12-bit by rewriting their AV1 sequence headers
# (tools/make_image_formats.py's avif_at_depth; their tile symbols read at
# the new depth): the speed-2 CDEF file at 10 bits (4:2:0, CDEF and loop
# restoration), the 4:4:4 file at 10 bits (profile 1) and the
# limited-range 4:2:2 file at 12 bits (profile 2, CDEF and restoration),
# each drawn in the image-file scene and on the photo wall
AVIF_CDEF10_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_s2_cdef_10bit.avif")
AVIF_CDEF10_FILE_REFERENCE = os.path.join(REFERENCE_DIR,
                                          "example_image_file_avif_cdef10_1x_blocks8.npy")
AVIF_CDEF10_WALL_REFERENCE = os.path.join(REFERENCE_DIR,
                                          "photo_wall_avif_cdef10_480x270_blocks8.npy")
AVIF_444_10_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_444_10bit.avif")
AVIF_444_10_FILE_REFERENCE = os.path.join(REFERENCE_DIR,
                                          "example_image_file_avif_444_10_1x_blocks8.npy")
AVIF_444_10_WALL_REFERENCE = os.path.join(REFERENCE_DIR,
                                          "photo_wall_avif_444_10_480x270_blocks8.npy")
AVIF_422_12_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_422_12bit.avif")
AVIF_422_12_FILE_REFERENCE = os.path.join(REFERENCE_DIR,
                                          "example_image_file_avif_422_12_1x_blocks8.npy")
AVIF_422_12_WALL_REFERENCE = os.path.join(REFERENCE_DIR,
                                          "photo_wall_avif_422_12_480x270_blocks8.npy")
# the fixture, its alpha faded towards the corners, as an AVIF grid of 4x3
# tiles of 200x200 with an alpha grid (libavif's encoder, quality 75, speed
# 6, 4:2:0), drawn in the image-file scene and on the photo wall
AVIF_GRID_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_grid.avif")
AVIF_GRID_FILE_REFERENCE = os.path.join(REFERENCE_DIR,
                                        "example_image_file_avif_grid_1x_blocks8.npy")
AVIF_GRID_WALL_REFERENCE = os.path.join(REFERENCE_DIR, "photo_wall_avif_grid_480x270_blocks8.npy")
# film grain: the fixture with the grid's faded alpha as PIL's AVIF with
# aom's film-grain-test vector 2 (luma and chroma points, AR lag 3,
# overlap_flag; the alpha item grained too), and the fixture at 4:2:2
# with vector 4 (nine points a plane) made 10-bit by avif_at_depth, each
# drawn in the image-file scene and on the photo wall
AVIF_GRAIN_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_grain.avif")
AVIF_GRAIN_FILE_REFERENCE = os.path.join(REFERENCE_DIR,
                                         "example_image_file_avif_grain_1x_blocks8.npy")
AVIF_GRAIN_WALL_REFERENCE = os.path.join(REFERENCE_DIR,
                                         "photo_wall_avif_grain_480x270_blocks8.npy")
AVIF_GRAIN_422_10_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "fixture_grain_422_10bit.avif")
AVIF_GRAIN_422_10_FILE_REFERENCE = os.path.join(
    REFERENCE_DIR, "example_image_file_avif_grain_422_10_1x_blocks8.npy")
AVIF_GRAIN_422_10_WALL_REFERENCE = os.path.join(
    REFERENCE_DIR, "photo_wall_avif_grain_422_10_480x270_blocks8.npy")
# an image sequence (PIL's save_all): two 64x64 crops of the fixture with
# the vignette alpha at quality 50, premultiplied (prem), whose first frame
# is drawn in the image-file scene and on the photo wall, as is the same
# file with its alpha track marked limited-range (a byte rewrite that
# chip_smoke.py makes on the card's host: tools/make_image_formats.py's
# card_rewrites)
AVIF_SEQUENCE_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "sequence_prem_64x64.avif")
AVIF_SEQUENCE_FILE_REFERENCE = os.path.join(REFERENCE_DIR,
                                            "example_image_file_avif_sequence_1x_blocks8.npy")
AVIF_SEQUENCE_WALL_REFERENCE = os.path.join(REFERENCE_DIR,
                                            "photo_wall_avif_sequence_480x270_blocks8.npy")
AVIF_SEQUENCE_LIMITED_FILE_REFERENCE = os.path.join(
    REFERENCE_DIR, "example_image_file_avif_sequence_limited_1x_blocks8.npy")
AVIF_SEQUENCE_LIMITED_WALL_REFERENCE = os.path.join(
    REFERENCE_DIR, "photo_wall_avif_sequence_limited_480x270_blocks8.npy")
# the fixture scaled to a 12 MP phone photo, 4032x3024, as a grid of 8x6
# tiles of 512x512 whose last column and row the grid crops (quality 50,
# speed 10): decoded and loaded, not drawn
AVIF_PHOTO_FIXTURE = os.path.join(IMAGE_FORMATS_DIR, "photo_grid_4032x3024.avif")


def make_image_file_scene(w: float, h: float, image_id: int) -> Renders:
    """examples/image_renderlist.py's scene: a dark page, a rounded grey
    card and the image `image_id` (the example's ImageRef-owned picture;
    here a loaded file) drawn at 280x280 on top."""
    renders = new_renders()
    root = renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                                   fill=fill(rgba(30, 30, 30, 255))))
    renders.add_child(0, root, Fig(kind=FigKind.nkRectangle,
                                   screen_box=rect(40, 40, 320, 320), corners=(16,) * 4,
                                   fill=fill(rgba(80, 80, 80, 255))))
    renders.add_child(0, root, Fig(kind=FigKind.nkImage, screen_box=rect(60, 60, 280, 280),
                                   image=image_style(image_id)))
    return renders


def make_loaded_photo_wall(w: float, h: float, n: int, image_id: int) -> RendersArray:
    """A photo grid of one loaded image (image_id, 800x600): on a dark
    page, n seeded panels (seed 777, as make_image_panels_scene), panel i a
    rounded grey card holding the image at an edge of PHOTO_WALL_EDGES[i %
    4] px (3:4 high), minified draws across levels 1-4 of its mip chain.
    Every fourth group of four panels (a quarter) clips its content
    (NfClipContent, a mask plane each) and holds the image 8 px past its
    right and bottom edge, which the clip cuts; the others hold it inset by
    8 px. The planner's routing decides the kernels: more than 24 pass
    items go to the megakernel with the atlas."""
    rng = np.random.RandomState(777)
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(30, 30, 30, 255))))
    for i in range(n):
        s = float(PHOTO_WALL_EDGES[i % 4])
        ih = s * 0.75
        x = float(rng.uniform(0, max(1.0, w - s - 16)))
        y = float(rng.uniform(0, max(1.0, h - ih - 16)))
        clip = (i // 4) % 4 == 0
        box = rect(x, y, s, ih) if clip else rect(x, y, s + 16, ih + 16)
        panel = lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=box,
                                 fill=fill(rgba(80, 80, 80, 255)), corners=(12,) * 4,
                                 flags=FigFlags.NfClipContent if clip else 0))
        lst.add_child(panel, Fig(kind=FigKind.nkImage, screen_box=rect(x + 8, y + 8, s, ih),
                                 image=image_style(image_id)))
    renders = new_renders()
    renders.set_layer(0, lst)
    return from_renders(renders)


# name -> (make function, frame size): the example scenes chip_smoke.py and the
# tests hold to the JAX package's frames
EXAMPLE_SCENES = {
    "layers_clip": (make_layers_clip_scene, LAYERS_CLIP_SIZE),
    "drawable_beziers": (make_drawable_beziers_scene, DRAWABLE_BEZIERS_SIZE),
    "dashed_borders": (make_dashed_borders_scene, DASHED_BORDERS_SIZE),
    "msdf_star": (make_msdf_star_scene, MSDF_STAR_SIZE),
    "mtsdf": (make_mtsdf_scene, MTSDF_SIZE),
}

# name -> the images an example scene draws, as (id, image) pairs that
# render_example publishes on the renderer's own bus
EXAMPLE_IMAGES = {
    "msdf_star": lambda: [(STAR_ID, star_sdf())],
    "mtsdf": lambda: [(MTSDF_ID, synthetic_msdf())],
}

# the forms each example scene is held to the JAX package's frame in:
# form -> (renderer pixel_scale, UI scale, frame_size multiplier); either
# scale of 2 gives a frame of twice the size, drawn differently (the UI
# scale scales the scene's coordinates before the walk, the pixel scale the
# walk's transform)
EXAMPLE_FORMS = {"1x": (1.0, 1.0, 1), "pixel2": (2.0, 1.0, 2), "ui2": (1.0, 2.0, 1)}


def example_reference_path(name: str, form: str) -> str:
    """figdraw_tpu's frame of an example scene (or of the image-file scene,
    name "image_file") in one form, as 8x8 block means
    (tests/torch_reference.py writes them)."""
    if (name not in EXAMPLE_SCENES and name != "image_file") or form not in EXAMPLE_FORMS:
        raise ValueError(f"unknown example {name!r} or form {form!r}")
    return os.path.join(REFERENCE_DIR, f"example_{name}_{form}_blocks8.npy")


def render_in_form(ren, scene_for, size, form: str):
    """ren's frame of scene_for(w, h) in `form` (the renderer already has
    the form's pixel scale): the UI scale is set for the frame and restored
    after it."""
    from .basics import fig_ui_scale, set_fig_ui_scale

    (w, h), (_ps, ui_scale, mult) = size, EXAMPLE_FORMS[form]
    old = fig_ui_scale()
    set_fig_ui_scale(ui_scale)
    try:
        return ren.render_frame(scene_for(w, h), vec2(w * mult, h * mult))
    finally:
        set_fig_ui_scale(old)


def render_example(renderer_for, name: str, form: str):
    """The frame of example scene `name` in `form`: renderer_for(pixel_scale)
    gives the renderer, and the scene's images (EXAMPLE_IMAGES) are
    published on a bus of its own. Returns (renderer, frame)."""
    from .resources import ImageMessageBus, put_image

    build, size = EXAMPLE_SCENES[name]
    ren = renderer_for(EXAMPLE_FORMS[form][0])
    if name in EXAMPLE_IMAGES:
        bus = ImageMessageBus()
        ren.ensure_image_message_subscription(bus)
        for image_id, image in EXAMPLE_IMAGES[name]():
            put_image(image_id, image, bus=bus)
    return ren, render_in_form(ren, build, size, form)


def render_image_file(renderer_for, path: str, form: str):
    """The image-file scene in `form`: the PNG at `path` loaded by
    resources.load_image (through its .flippy sidecar, written beside it)
    on a bus of the renderer's own. Returns (renderer, frame, the
    ImageRef)."""
    from .resources import ImageMessageBus, load_image

    ren = renderer_for(EXAMPLE_FORMS[form][0])
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = load_image(path, bus=bus)
    frame = render_in_form(ren, lambda w, h: make_image_file_scene(w, h, ref.id),
                           IMAGE_FILE_SIZE, form)
    return ren, frame, ref


# --- the frame loop's scenes ------------------------------------------------------

BLURRED_REFERENCE = os.path.join(REFERENCE_DIR, "blurred_cards_480x270_blocks8.npy")
BLURRED_SMALL = (480, 270, 25)  # the stored reference's frame and cards
BLURRED_RADIUS = 12.0


def _card(lst: RenderList, x: float, y: float, image_id: int) -> None:
    """One of images_clipped's cards: a 104x104 rounded panel that clips a
    96x96 image child at (x + 24, y + 24)."""
    panel = lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(x, y, 104, 104),
                             fill=fill(rgba(80, 80, 80, 255)), corners=(12,) * 4,
                             flags=FigFlags.NfClipContent))
    lst.add_child(panel, Fig(kind=FigKind.nkImage,
                             screen_box=rect(x + 24, y + 24, 96, 96),
                             image=image_style(image_id)))


def blurred_panel(w: float, h: float):
    """The frosted panel's box: the lower 45% of the frame, inset by 8%."""
    return rect(w * 0.08, h * 0.5, w * 0.84, h * 0.45)


def make_blurred_cards_scene(w: float, h: float, n: int) -> RendersArray:
    """images_clipped's n cards (seed 777) on its dark background, then a
    backdrop blur of radius BLURRED_RADIUS over the frosted panel (a
    rounded, translucent white nkBackdropBlur node: the blur item and a
    backdrop quad), then a second band of n // 5 clipped cards (seed 778)
    inside the panel, above the blur. Built with the port's Fig API and
    from_renders, node for node as tests/torch_reference.py builds it with
    figdraw_tpu's; more than 24 pass items with a blur and a backdrop, so
    plan.plan_execution sends it to the rolled executor."""
    rng = np.random.RandomState(777)
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(30, 30, 30, 255))))
    for _ in range(n):
        x = float(rng.uniform(0, w - 120))
        y = float(rng.uniform(0, h - 120))
        _card(lst, x, y, IMAGE_ID)
    panel = blurred_panel(w, h)
    lst.add_root(Fig(kind=FigKind.nkBackdropBlur, screen_box=panel,
                     backdrop_blur=BackdropBlurStyle(blur=BLURRED_RADIUS),
                     corners=(16,) * 4, fill=fill(rgba(255, 255, 255, 70))))
    rng = np.random.RandomState(778)
    for _ in range(n // 5):
        x = float(rng.uniform(panel.x, panel.x + panel.w - 104))
        y = float(rng.uniform(panel.y, panel.y + panel.h - 104))
        _card(lst, x, y, IMAGE_ID)
    renders = new_renders()
    renders.set_layer(0, lst)
    return from_renders(renders)


OVERLAY_SIZE = (420, 300)  # examples/overlay_3d.py's W, H
OVERLAY_FRAMES = 6  # the example's strip: t = 0.35 + 0.5 i
OVERLAY_REFERENCE = os.path.join(REFERENCE_DIR, "overlay_3d_420x300_blocks8.npy")


def overlay_time(i: int) -> float:
    return 0.35 + i * 0.5


def rasterize_pyramid(w: int, h: int, t: float) -> np.ndarray:
    """examples/overlay_3d.py's external 3D pass, copied (numpy, no JAX): a
    spinning pyramid of 6 vertex-colored triangles with a z-buffer, opaque
    over a dark clear color; (h, w, 4) f32."""
    verts = np.array([[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5],
                      [-0.5, 0, 0.5], [0.0, 0.8, 0.0]])
    colors = np.array([[1, 0.2, 0.2], [0.2, 1, 0.2], [0.2, 0.2, 1],
                       [1, 1, 0.2], [1, 0.2, 1.0]])
    tris = [(0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4), (0, 1, 2), (2, 3, 0)]
    cy_, sy_ = np.cos(t), np.sin(t)
    rot = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    v = verts @ rot.T
    eye = np.array([1.5, 1.2, 2.3])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    cam = (v - eye) @ np.stack([right, up, -fwd], axis=1)
    f = 1.0 / np.tan(np.radians(24))
    sx = (f * cam[:, 0] / -cam[:, 2] * h / w + 1) * 0.5 * w
    sy = (1 - f * cam[:, 1] / -cam[:, 2]) * 0.5 * h
    sz = -cam[:, 2]

    frame = np.empty((h, w, 4), np.float32)
    frame[..., :3] = (0.08, 0.10, 0.14)
    frame[..., 3] = 1.0
    zbuf = np.full((h, w), np.inf)
    yy, xx = np.mgrid[0:h, 0:w]
    px, py = xx + 0.5, yy + 0.5
    for ia, ib, ic in tris:
        area = ((sx[ib] - sx[ia]) * (sy[ic] - sy[ia])
                - (sy[ib] - sy[ia]) * (sx[ic] - sx[ia]))
        if abs(area) < 1e-12:
            continue
        w0 = ((sx[ib] - px) * (sy[ic] - py) - (sy[ib] - py) * (sx[ic] - px)) / area
        w1 = ((sx[ic] - px) * (sy[ia] - py) - (sy[ic] - py) * (sx[ia] - px)) / area
        w2 = 1.0 - w0 - w1
        z = w0 * sz[ia] + w1 * sz[ib] + w2 * sz[ic]
        hit = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z < zbuf)
        if not hit.any():
            continue
        for ch in range(3):
            attr = w0 * colors[ia, ch] + w1 * colors[ib, ch] + w2 * colors[ic, ch]
            frame[..., ch] = np.where(hit, attr, frame[..., ch])
        zbuf = np.where(hit, z, zbuf)
    return frame


def make_overlay_scene(w: float, h: float) -> Renders:
    """examples/overlay_3d.py's make_scene: a gradient backdrop at zlevel -1
    and a translucent HUD at zlevel 0; the pyramid composites at boundary
    0, after the backdrop and before the HUD."""
    back = RenderList()
    back.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                      fill=linear(rgba(30, 34, 60, 255), rgba(8, 8, 16, 255))))
    hud = RenderList()
    hud.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(16, h - 72, w - 32, 56),
                     corners=(12, 12, 12, 12), fill=fill(rgba(255, 255, 255, 48))))
    hud.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(24, h - 64, 150, 40),
                     corners=(8, 8, 8, 8), fill=fill(rgba(70, 200, 140, 220))))
    r = new_renders()
    r.set_layer(-1, back)
    r.set_layer(0, hud)
    return r
