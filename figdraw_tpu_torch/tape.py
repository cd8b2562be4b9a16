"""The flattened frame and the Python walk's backend (figdraw_tpu/tape.py).

A Tape holds quad records and ordered pass items. The native walk exports
its rows straight into the packed upload buffer (`combo`, ops/layout.py's
wire layout); the Python walk (render.render_root on a TapeBackend) writes
logical (68-wide) `fields` and (2-wide) `modes` rows, which the planner
packs (plan.pack_walked_tape). TapeBackend is the JAX package's backend;
a renderer hands it its glyph loader and glyph offsets (text/glyphs.py
draw_text_layout reads them).

Encodings kept from the reference renderer, so both walks give the same
rows: ceil() vertex snapping after the transform, the corner-radius packing
with its 12+12-bit elliptical form, the sdf mode packing (mode + 128 *
elliptical + 256 * fill mode) and the drop and inset shadow parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np

from .backend import (
    BackendContext,
    BackendFill,
    BackendFillKind,
    SdfMode,
    bezier_stroke_sdf_mode,
    encode_sdf_mode,
    gradient_colors,
    linear3_fill_mode,
    rounded_radii_vec,
    SDF_FILL_SOLID_OR_VERTEX,
)
from .basics import CornerRadii2D, StrokeCap
from .colors import Color, ColorRGBA
from .geometry import Rect, Vec2, vec2
from .ops.layout import (
    QF_AA,
    QF_BBOX_X0,
    QF_BBOX_X1,
    QF_BBOX_Y0,
    QF_BBOX_Y1,
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
    QF_WIDTH,
    QI_MASK,
    QI_MODE,
    QI_WIDTH,
)

FRAME_TARGET = -1


@dataclass
class DrawItem:
    """A contiguous run of quads drawn to one target with one mask read."""

    target: int  # FRAME_TARGET or mask-texture index being written
    start: int
    end: int


@dataclass
class BlurItem:
    """Backdrop capture + separable gaussian blur event."""

    radius: float


@dataclass
class ClearMaskItem:
    """Clear mask texture `index` to zero before writing (beginMask)."""

    index: int


TapeItem = Union[DrawItem, BlurItem, ClearMaskItem]


@dataclass
class RectMask:
    fast: bool
    params: Tuple[float, float, float, float] = (0.0, 0.0, -1.0, -1.0)
    radii: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    mat_x: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    mat_y: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


class Tape:
    """Quad records plus ordered pass items.

    capacity > 0 gives growable logical `fields` / `modes` rows for the
    Python walk (alloc); a native export leaves them None and writes the
    packed `combo` instead, and `fields` / `modes` then unpack it on first
    read (bit-identical to the rows before the pack). The native combo is a
    pooled ping-pong buffer: its contents are valid until the second next
    flatten on the same renderer."""

    __slots__ = (
        "_fields",
        "_modes",
        "count",
        "items",
        "mask_count",
        "frame_size",
        "clear_color",
        "combo",
        "combo_quads",
        "structure_cache",
        "tile_density",
        "root_spans",
    )

    def __init__(self, capacity: int = 0):
        self._fields = (np.zeros((capacity, QF_WIDTH), dtype=np.float32)
                        if capacity else None)
        self._modes = (np.zeros((capacity, QI_WIDTH), dtype=np.int32)
                       if capacity else None)
        self.count = 0
        self.items: List[TapeItem] = []
        self.mask_count = 0
        self.frame_size: Tuple[float, float] = (0.0, 0.0)
        self.clear_color: Optional[Tuple[float, float, float, float]] = None
        # (bucket + meta rows, PACKED_WIDTH) f32 upload buffer and the padded
        # quad-row count it was sized for
        self.combo: Optional[np.ndarray] = None
        self.combo_quads = 0
        # (structure, draw bounds, blur radii, any_atlas, any_backdrop): from
        # the C++ item flag bits for a native export, from the mode lanes
        # (plan.tape_structure) for a walked tape; and the fd_density tile
        # summary, which only the native export gives
        self.structure_cache = None
        self.tile_density = None
        # (lvl, root_node_idx) -> (qs, qe), each root's rows, when the walk
        # recorded them (native.flatten_renders_array(record_spans=True))
        self.root_spans = None

    @property
    def fields(self) -> np.ndarray:
        """Logical (rows, 68) f32 quad records."""
        if self._fields is None:
            self._materialize()
        return self._fields

    @fields.setter
    def fields(self, value):
        self._fields = value

    @property
    def modes(self) -> np.ndarray:
        """(rows, 2) i32 mode lanes: the sdf mode and the mask read."""
        if self._modes is None:
            self._materialize()
        return self._modes

    @modes.setter
    def modes(self, value):
        self._modes = value

    def _materialize(self) -> None:
        from .ops.layout import unpack_fields_np

        f, m = unpack_fields_np(self.combo[: self.combo_quads])
        if self._fields is None:
            self._fields = f
        if self._modes is None:
            self._modes = m

    def _grow(self) -> None:
        cap = self.fields.shape[0] * 2
        nf = np.zeros((cap, QF_WIDTH), dtype=np.float32)
        nm = np.zeros((cap, QI_WIDTH), dtype=np.int32)
        nf[: self.count] = self.fields[: self.count]
        nm[: self.count] = self.modes[: self.count]
        self.fields, self.modes = nf, nm

    def alloc(self) -> int:
        if self.count == self.fields.shape[0]:
            self._grow()
        i = self.count
        self.count += 1
        return i


def _color_rgba_norm(c: ColorRGBA) -> Tuple[float, float, float, float]:
    return (c.r / 255.0, c.g / 255.0, c.b / 255.0, c.a / 255.0)


class TapeBackend(BackendContext):
    """BackendContext that records to a Tape. One instance per frame walk."""

    def __init__(self, white_uv: Optional[Tuple[float, float]] = None):
        super().__init__()
        self.tape = Tape(capacity=1024)
        self.mask_write = 0
        self.mask_begun = False
        # per-plane clip SUPPORT: the union of the write quads' stored screen
        # bboxes since the plane's last clear (begin_mask). A quad reading
        # plane k contributes exactly 0 outside this box (the evaluators
        # hard-clip coverage at the write quad's vertex extent via the uv
        # `inside` test, and every executor's plane is 0 wherever no write
        # landed), so clipped content CLAMPS its bbox to it — spilling
        # children stop binning into tiles where their mask is all-zero.
        # Bit-exact: dropped tiles only lose fa*0 blends (IEEE identities);
        # the XLA paths never read bboxes for coverage. Index 0 (the all-pass
        # plane) is never clamped.
        self.plane_support: List = [None]
        self.rect_mask_stack: List[RectMask] = []
        # run tracking: current open DrawItem (target, mask_read) or None
        self._run_target: Optional[Tuple[int, int]] = None
        self._run_start = 0
        # atlas entries: image_id -> uv rect (x, y, w, h) in [0,1]; owned by the
        # renderer, injected per frame.
        self.entries = {}
        self.atlas_size = 1
        self._white_uv = white_uv or (0.0, 0.0)

    # --- pass/run management ---------------------------------------------------

    def _current_target(self) -> Tuple[int, int]:
        if self.mask_begun:
            # writing INTO mask[mask_write]; reads multiply by the parent mask
            # (endMask flushes with read = write-1, glcontext.nim:1916-1921)
            return (self.mask_write, self.mask_write - 1)
        return (FRAME_TARGET, self.mask_write)

    def _close_run(self) -> None:
        if self._run_target is not None and self._run_start < self.tape.count:
            target, _mask = self._run_target
            self.tape.items.append(
                DrawItem(target=target, start=self._run_start, end=self.tape.count)
            )
        self._run_target = None

    def _ensure_run(self) -> int:
        """Returns the mask-read index quads in this run should use."""
        tgt = self._current_target()
        if self._run_target != tgt:
            self._close_run()
            self._run_target = tgt
            self._run_start = self.tape.count
        return tgt[1]

    # --- rect-mask fast path -----------------------------------------------------

    def _make_rect_mask(self, mask_rect: Rect, radii: CornerRadii2D) -> RectMask:
        inv = self.mat.inverse()
        # The mask-plane twin draws its clip quad with ceil-snapped vertices
        # and stretches the SDF field onto them (uv-interpolated local point,
        # glcontext.nim:1080-1086 + :1051), so its boundary lands on the
        # snapped edges. Snap the fast path's local rect through the same
        # transform round trip so both clip paths cut at identical pixels
        # (the reference's two paths only agree to ~1px here; ours are
        # exact). Rotated transforms keep the unsnapped rect — vertex
        # snapping has no axis-aligned equivalent there.
        m = self.mat
        if m.b == 0.0 and m.c == 0.0 and m.a > 0.0 and m.d > 0.0:
            p0 = m.apply(mask_rect.xy)
            p1 = m.apply(mask_rect.xy + mask_rect.wh)
            s0 = vec2(math.ceil(p0.x), math.ceil(p0.y))
            s1 = vec2(math.ceil(p1.x), math.ceil(p1.y))
            l0 = inv.apply(s0)
            l1 = inv.apply(s1)
            half = (l1 - l0) * 0.5
            center = l0 + half
        else:
            half = mask_rect.wh * 0.5
            center = mask_rect.xy + half
        packed, elliptical = rounded_radii_vec(radii, half)
        # Row-vectors of the inverse transform in homogeneous form, mirroring
        # makeRectMask (glcontext.nim:831-850): matX = (m00, m01, tx, 1),
        # matY = (m10, m11, ty, ellipticalFlag).
        return RectMask(
            fast=True,
            params=(center.x, center.y, half.x, half.y),
            radii=packed,
            mat_x=(inv.a, inv.b, inv.tx, 1.0),
            mat_y=(inv.c, inv.d, inv.ty, 1.0 if elliptical else 0.0),
        )

    def _active_rect_mask(self) -> Optional[RectMask]:
        if self.mask_begun:
            return None
        for rm in reversed(self.rect_mask_stack):
            if rm.fast:
                return rm
        return None

    # --- quad emission ------------------------------------------------------------

    def _emit_quad(
        self,
        pos_quad,  # 4 x Vec2 (already transformed + ceil'd), order BL BR TR TL
        uv_quad,  # 4 x (u, v)
        colors,  # 4 x ColorRGBA, order BL BR TR TL
        params: Tuple[float, float, float, float],
        radii: Tuple[float, float, float, float],
        factors: Tuple[float, float],
        packed_mode: int,
        mid_color: ColorRGBA = ColorRGBA(),
        stop_color: ColorRGBA = ColorRGBA(),
    ) -> None:
        mask_read = self._ensure_run()
        t = self.tape
        i = t.alloc()
        f = t.fields[i]

        p0, p1, p2, p3 = pos_quad  # BL BR TR TL
        # u axis: TL->TR, v axis: TL->BL
        ax, ay = p2.x - p3.x, p2.y - p3.y
        bx, by = p0.x - p3.x, p0.y - p3.y
        det = ax * by - ay * bx
        if abs(det) <= 1e-12:
            t.count -= 1  # degenerate quad: drop
            return
        inv_det = 1.0 / det
        f[QF_INV_A] = by * inv_det
        f[QF_INV_B] = -bx * inv_det
        f[QF_INV_C] = -ay * inv_det
        f[QF_INV_D] = ax * inv_det
        f[QF_ORG_X] = p3.x
        f[QF_ORG_Y] = p3.y
        xs = (p0.x, p1.x, p2.x, p3.x)
        ys = (p0.y, p1.y, p2.y, p3.y)
        bx0, by0, bx1, by1 = min(xs), min(ys), max(xs), max(ys)
        if mask_read >= 1:
            # clip-support clamp (see plane_support): outside the plane's
            # write-quad union this quad's contribution is exactly 0
            s = self.plane_support[mask_read]
            if s is not None:
                bx0 = max(bx0, s[0])
                by0 = max(by0, s[1])
                bx1 = min(bx1, s[2])
                by1 = min(by1, s[3])
                if bx0 > bx1 or by0 > by1:
                    # fully clipped away: the inert-row bbox (never binned)
                    bx0, by0, bx1, by1 = 2e9, 2e9, -2e9, -2e9
        f[QF_BBOX_X0] = bx0
        f[QF_BBOX_Y0] = by0
        f[QF_BBOX_X1] = bx1
        f[QF_BBOX_Y1] = by1
        if self.mask_begun:
            s = self.plane_support[self.mask_write]
            self.plane_support[self.mask_write] = (
                min(s[0], float(f[QF_BBOX_X0])),
                min(s[1], float(f[QF_BBOX_Y0])),
                max(s[2], float(f[QF_BBOX_X1])),
                max(s[3], float(f[QF_BBOX_Y1])),
            )

        uv0, uv1, uv2, uv3 = uv_quad
        f[QF_UV3_X + 0] = uv3[0]
        f[QF_UV3_X + 1] = uv3[1]
        f[QF_UV3_X + 2] = uv2[0] - uv3[0]
        f[QF_UV3_X + 3] = uv2[1] - uv3[1]
        f[QF_UV3_X + 4] = uv0[0] - uv3[0]
        f[QF_UV3_X + 5] = uv0[1] - uv3[1]

        for vi, c in enumerate(colors):
            f[QF_COLOR0 + vi * 4 : QF_COLOR0 + vi * 4 + 4] = _color_rgba_norm(c)
        f[QF_MID_COLOR : QF_MID_COLOR + 4] = _color_rgba_norm(mid_color)
        f[QF_STOP_COLOR : QF_STOP_COLOR + 4] = _color_rgba_norm(stop_color)
        f[QF_PARAMS : QF_PARAMS + 4] = params
        f[QF_RADII : QF_RADII + 4] = radii
        f[QF_FACTORS : QF_FACTORS + 2] = factors
        f[QF_AA] = self.aa_factor
        f[QF_SUBPIXEL_SHIFT] = self._active_subpixel_shift()

        rm = self._active_rect_mask()
        if rm is not None:
            f[QF_RECT_PARAMS : QF_RECT_PARAMS + 4] = rm.params
            f[QF_RECT_RADII : QF_RECT_RADII + 4] = rm.radii
            f[QF_RECT_MATX : QF_RECT_MATX + 4] = rm.mat_x
            f[QF_RECT_MATY : QF_RECT_MATY + 4] = rm.mat_y
        else:
            f[QF_RECT_PARAMS : QF_RECT_PARAMS + 4] = (0.0, 0.0, -1.0, -1.0)

        t.modes[i, QI_MODE] = packed_mode
        t.modes[i, QI_MASK] = mask_read

    def _active_subpixel_shift(self) -> float:
        if not self._text_subpixel_positioning:
            return 0.0
        return max(0.0, min(self._text_subpixel_shift, 0.999))

    def _pos_quad(self, at: Vec2, to: Vec2):
        """Transform + ceil-snap the 4 corners (glcontext.nim:1036-1040, order
        BL BR TR TL). The snapped corners are floats, as the C++ walk's
        doubles are: with Python ints an axis-aligned quad's zero edge term
        would negate to +0.0 where the C++ walk writes -0.0 (the JAX
        package's Python walk does so), and the two walks' rows would differ
        in the sign of those zeros."""
        m = self.mat

        def ceil_v(v: Vec2) -> Vec2:
            return vec2(math.ceil(v.x), math.ceil(v.y))

        return (
            ceil_v(m.apply(Vec2(at.x, to.y))),
            ceil_v(m.apply(Vec2(to.x, to.y))),
            ceil_v(m.apply(Vec2(to.x, at.y))),
            ceil_v(m.apply(Vec2(at.x, at.y))),
        )

    @staticmethod
    def _sdf_uv_quad():
        return ((0.0, 1.0), (1.0, 1.0), (1.0, 0.0), (0.0, 0.0))

    # --- BackendContext draw methods ------------------------------------------------

    def draw_rounded_rect_sdf(
        self,
        rect: Rect,
        fill,
        radii: CornerRadii2D,
        mode: SdfMode = SdfMode.sdfModeClipAA,
        factor: float = 4.0,
        spread: float = 0.0,
        shape_size: Vec2 = vec2(0, 0),
    ) -> None:
        if rect.w <= 0 or rect.h <= 0:
            return
        fill_mode = SDF_FILL_SOLID_OR_VERTEX
        mid_color = stop_color = ColorRGBA()
        fill_mid_pos = 0.5
        if isinstance(fill, BackendFill):
            if fill.kind == BackendFillKind.bfLinear3 and mode in (
                SdfMode.sdfModeClipAA,
                SdfMode.sdfModeAnnular,
                SdfMode.sdfModeAnnularAA,
            ):
                # dedicated linear3 shader fill path (glcontext.nim:1591-1607)
                fill_mode = linear3_fill_mode(fill.axis)
                colors = (fill.start,) * 4
                mid_color, stop_color = fill.mid, fill.stop
                fill_mid_pos = fill.mid_pos
            else:
                colors = gradient_colors(fill)
        elif isinstance(fill, Color):
            c = fill.rgba()
            colors = (c, c, c, c)
        else:
            colors = tuple(fill)  # 4 explicit vertex colors

        quad_half = rect.wh * 0.5
        inset_mode = mode == SdfMode.sdfModeInsetShadow
        resolved_shape = (
            shape_size if (shape_size.x > 0.0 and shape_size.y > 0.0) else rect.wh
        )
        shape_half = quad_half if inset_mode else resolved_shape * 0.5
        if inset_mode:
            params = (quad_half.x, quad_half.y, shape_size.x, shape_size.y)
        else:
            params = (quad_half.x, quad_half.y, shape_half.x, shape_half.y)
        packed_radii, elliptical = rounded_radii_vec(radii, shape_half)

        if fill_mode == SDF_FILL_SOLID_OR_VERTEX:
            factors = (factor, spread)
        else:
            factors = (factor, min(max(fill_mid_pos, 0.01), 0.99))

        at = rect.xy
        to = rect.xy + rect.wh
        self._emit_quad(
            self._pos_quad(at, to),
            self._sdf_uv_quad(),
            colors,
            params,
            packed_radii,
            factors,
            encode_sdf_mode(mode, fill_mode, elliptical),
            mid_color,
            stop_color,
        )

    def draw_quadratic_bezier_sdf(
        self,
        rect: Rect,
        fill,
        p0: Vec2,
        p1: Vec2,
        p2: Vec2,
        stroke_weight: float,
        cap: StrokeCap,
    ) -> None:
        if rect.w <= 0.0 or rect.h <= 0.0 or stroke_weight <= 0.0:
            return
        fill_mode = SDF_FILL_SOLID_OR_VERTEX
        mid_color = stop_color = ColorRGBA()
        fill_mid_pos = 0.5
        if isinstance(fill, BackendFill):
            if fill.kind == BackendFillKind.bfLinear3:
                fill_mode = linear3_fill_mode(fill.axis)
                colors = (fill.start,) * 4
                mid_color, stop_color = fill.mid, fill.stop
                fill_mid_pos = fill.mid_pos
            else:
                colors = gradient_colors(fill)
        elif isinstance(fill, Color):
            c = fill.rgba()
            colors = (c, c, c, c)
        else:
            colors = tuple(fill)

        quad_half = rect.wh * 0.5
        params = (quad_half.x, quad_half.y, p0.x, p0.y)
        curve = (p1.x, p1.y, p2.x, p2.y)
        if fill_mode == SDF_FILL_SOLID_OR_VERTEX:
            factors = (stroke_weight, 0.0)
        else:
            factors = (stroke_weight, min(max(fill_mid_pos, 0.01), 0.99))
        at = rect.xy
        to = rect.xy + rect.wh
        self._emit_quad(
            self._pos_quad(at, to),
            self._sdf_uv_quad(),
            colors,
            params,
            curve,
            factors,
            encode_sdf_mode(bezier_stroke_sdf_mode(cap), fill_mode),
            mid_color,
            stop_color,
        )

    def draw_filled_quad(self, verts, colors) -> None:
        """Arbitrary filled quad through the white atlas texel
        (glcontext.nim:963-982)."""
        m = self.mat

        def ceil_v(v: Vec2) -> Vec2:
            return vec2(math.ceil(m.apply(v).x), math.ceil(m.apply(v).y))

        pos_quad = tuple(ceil_v(v) for v in verts)
        uv = self._white_uv
        uv_quad = (uv, uv, uv, uv)
        self._emit_quad(
            pos_quad,
            uv_quad,
            tuple(colors),
            (0.0, 0.0, 0.0, 0.0),
            (0.0, 0.0, 0.0, 0.0),
            (0.0, 0.0),
            int(SdfMode.sdfModeAtlas),
        )

    def _image_uv_bounds(self, r, flip_y: bool):
        x, y, w, h = r
        if flip_y:
            return (x, y + h), (x + w, y)
        return (x, y), (x + w, y + h)

    def _draw_uv_rect(self, at: Vec2, to: Vec2, uv_at, uv_to, colors, mode, factors, params):
        pos_quad = self._pos_quad(at, to)
        uv_quad = (
            (uv_at[0], uv_to[1]),
            (uv_to[0], uv_to[1]),
            (uv_to[0], uv_at[1]),
            (uv_at[0], uv_at[1]),
        )
        self._emit_quad(
            pos_quad,
            uv_quad,
            colors,
            params,
            (0.0, 0.0, 0.0, 0.0),
            factors,
            int(mode),
        )

    def has_image(self, key) -> bool:
        return key in self.entries

    def draw_image(self, image_id, pos: Vec2, colors, size: Vec2, flip_y: bool) -> None:
        r = self.entries.get(image_id)
        if r is None:
            return
        if size.x > 0.0 and size.y > 0.0:
            draw_size = size
        else:
            draw_size = vec2(r[2] * self.atlas_size, r[3] * self.atlas_size)
        # minified draws blend the two bracketing mip levels when the atlas
        # carries a chain — flatten-time TRILINEAR (GL mipmapped atlas,
        # glcontext.nim:610-620): the per-quad scale is constant, so the
        # level pair and blend fraction resolve here. The blend rides a
        # second quad at level+1 whose vertex alpha carries the fraction
        # (u8-quantized: the PACKED wire layout requires quantized colors):
        # source-over of the pair equals the texel lerp exactly for opaque
        # images and approximates it for translucent ones — animated zooms
        # fade between levels instead of popping (tests/test_images.py).
        # The fraction is linear in scale over [1, 2) (not log2) so BOTH
        # walks compute it with the same primitive ops (C++ twin:
        # native/flatten.cpp draw_image_node, bit-identical).
        native_w = r[2] * self.atlas_size
        native_h = r[3] * self.atlas_size
        blend = None  # (level+1 entry, u8 alpha scale) second pass
        # LOD comes from the MAX-axis minification (GL derives it from the
        # max-axis footprint): a 64x64 image in a 64x16 box is 4x minified
        # even though x is 1:1
        if (draw_size.x > 0 and draw_size.y > 0
                and (native_w > draw_size.x or native_h > draw_size.y)):
            level = 0
            scale = max(native_w / max(draw_size.x, 1e-6),
                        native_h / max(draw_size.y, 1e-6))
            while scale >= 2.0 and (image_id, level + 1) in self.entries:
                level += 1
                scale *= 0.5
            if level > 0:
                r = self.entries[(image_id, level)]
            t = scale - 1.0  # in [0, 1) relative to the chosen level
            nxt = self.entries.get((image_id, level + 1))
            if t > 1.0 / 255.0 and nxt is not None:
                blend = (nxt, t)
        uv_at, uv_to = self._image_uv_bounds(r, flip_y)
        self._draw_uv_rect(
            pos,
            pos + draw_size,
            uv_at,
            uv_to,
            tuple(colors),
            SdfMode.sdfModeAtlas,
            (0.0, 0.0),
            (0.0, 0.0, 0.0, 0.0),
        )
        if blend is not None:
            nxt, t = blend
            bc = tuple(
                ColorRGBA(c.r, c.g, c.b, int(math.floor(c.a * t + 0.5)))
                for c in colors
            )
            uv_at, uv_to = self._image_uv_bounds(nxt, flip_y)
            self._draw_uv_rect(
                pos,
                pos + draw_size,
                uv_at,
                uv_to,
                bc,
                SdfMode.sdfModeAtlas,
                (0.0, 0.0),
                (0.0, 0.0, 0.0, 0.0),
            )

    def _draw_sd_image(self, image_id, pos, color, size, px_range, sd_threshold,
                       stroke_weight, flip_y, solid_mode, annular_mode):
        r = self.entries.get(image_id)
        if r is None:
            return
        uv_at, uv_to = self._image_uv_bounds(r, flip_y)
        stroke_w = max(0.0, stroke_weight)
        params = (float(self.atlas_size), stroke_w, 0.0, 0.0)
        mode = annular_mode if stroke_w > 0.0 else solid_mode
        c = color.rgba() if isinstance(color, Color) else color
        self._draw_uv_rect(
            pos,
            pos + size,
            uv_at,
            uv_to,
            (c, c, c, c),
            mode,
            (px_range, sd_threshold),
            params,
        )

    def draw_msdf_image(self, image_id, pos, color, size, px_range, sd_threshold,
                        stroke_weight, flip_y=False) -> None:
        self._draw_sd_image(
            image_id, pos, color, size, px_range, sd_threshold, stroke_weight,
            flip_y, SdfMode.sdfModeMsdf, SdfMode.sdfModeMsdfAnnular,
        )

    def draw_mtsdf_image(self, image_id, pos, color, size, px_range, sd_threshold,
                         stroke_weight, flip_y=False) -> None:
        self._draw_sd_image(
            image_id, pos, color, size, px_range, sd_threshold, stroke_weight,
            flip_y, SdfMode.sdfModeMtsdf, SdfMode.sdfModeMtsdfAnnular,
        )

    # --- masks (glcontext.nim:1873-1949) -------------------------------------------

    def begin_mask(self, clip_rect: Rect, radii: CornerRadii2D) -> None:
        assert not self.mask_begun, "begin_mask has already been called"
        self._close_run()
        self.mask_begun = True
        self.mask_write += 1
        self.tape.mask_count = max(self.tape.mask_count, self.mask_write)
        self.tape.items.append(ClearMaskItem(index=self.mask_write))
        while len(self.plane_support) <= self.mask_write:
            self.plane_support.append(None)
        # the clear empties the plane; write quads re-grow the support
        self.plane_support[self.mask_write] = (2e9, 2e9, -2e9, -2e9)
        self.draw_rounded_rect_sdf(
            rect=clip_rect,
            fill=Color(1.0, 0.0, 0.0, 1.0),
            radii=radii,
            mode=SdfMode.sdfModeClipAA,
            factor=4.0,
            spread=0.0,
            shape_size=vec2(0, 0),
        )

    def end_mask(self) -> None:
        assert self.mask_begun, "end_mask without begin_mask"
        self._close_run()
        self.mask_begun = False

    def pop_mask(self) -> None:
        self._close_run()
        self.mask_write -= 1

    def begin_rect_mask(self, mask_rect: Rect, radii: CornerRadii2D) -> None:
        assert not self.mask_begun, "begin_rect_mask cannot start inside a mask"
        if not self.rect_mask_stack and mask_rect.w > 0.0 and mask_rect.h > 0.0:
            self.rect_mask_stack.append(self._make_rect_mask(mask_rect, radii))
        else:
            self.begin_mask(mask_rect, radii)
            self.end_mask()
            self.rect_mask_stack.append(RectMask(fast=False))

    def pop_rect_mask(self) -> None:
        assert self.rect_mask_stack, "no rect mask has been pushed"
        rm = self.rect_mask_stack.pop()
        if not rm.fast:
            self.pop_mask()

    # --- blur ------------------------------------------------------------------------

    def draw_backdrop_blur(self, rect: Rect, radii: CornerRadii2D, blur_radius: float) -> None:
        if blur_radius <= 0.0 or rect.w <= 0.0 or rect.h <= 0.0:
            return
        self._close_run()
        self.tape.items.append(BlurItem(radius=blur_radius))
        self.draw_rounded_rect_sdf(
            rect=rect,
            fill=Color(1, 1, 1, 1),
            radii=radii,
            mode=SdfMode.sdfModeBackdropBlur,
            factor=blur_radius,
            spread=0.0,
            shape_size=vec2(0, 0),
        )

    # --- frame -------------------------------------------------------------------------

    def begin_frame(self, frame_size: Vec2, clear_main: bool = True,
                    clear_main_color: Color = Color(1, 1, 1, 1)) -> None:
        assert not self.frame_begun
        self.frame_begun = True
        self.frame_size = frame_size
        self.tape.frame_size = (frame_size.x, frame_size.y)
        if clear_main:
            self.tape.clear_color = (
                clear_main_color.r,
                clear_main_color.g,
                clear_main_color.b,
                clear_main_color.a,
            )
        else:
            self.tape.clear_color = None
        self.rect_mask_stack.clear()

    def end_frame(self) -> None:
        assert self.frame_begun
        assert self.mask_write == 0, "not all masks have been popped"
        assert not self.rect_mask_stack, "not all rect masks have been popped"
        self.frame_begun = False
        self._close_run()

    def finish(self) -> Tape:
        self._close_run()
        return self.tape
