"""Structure-of-arrays scene storage for the native flattener
(figdraw_tpu/nodesarray.py without the object-form Fig conversions).

The dtypes are byte-for-byte the JAX package's: the C++ walk
(native/flatten.cpp) reads these rows directly, and native.py checks each
struct size against the library at load time.
"""

from __future__ import annotations

import numpy as np

from .basics import FigKind
from .fill import FillKind

MAX_SHADOWS = 4

FILL_DTYPE = np.dtype(
    [
        ("kind", np.uint8),
        ("axis", np.uint8),
        ("midpos", np.uint8),
        ("_pad", np.uint8),
        ("c0", np.uint8, 4),  # solid color / gradient start
        ("c1", np.uint8, 4),  # gradient mid (linear3) / stop (linear2)
        ("c2", np.uint8, 4),  # gradient stop (linear3)
    ]
)

SHADOW_DTYPE = np.dtype(
    [
        ("style", np.uint8),
        ("_pad", np.uint8, 3),
        ("blur", np.float32),
        ("spread", np.float32),
        ("x", np.float32),
        ("y", np.float32),
        ("fill", FILL_DTYPE),
    ]
)

FIG_DTYPE = np.dtype(
    [
        ("kind", np.uint8),
        ("zlevel", np.int8),
        ("flags", np.uint16),
        ("parent", np.int16),
        ("child_count", np.int16),
        ("box", np.float32, 4),
        ("rotation", np.float32),
        ("fill", FILL_DTYPE),
        ("corners", np.uint16, 4),
        ("corners_y", np.uint16, 4),
        ("stroke_weight", np.float32),
        ("stroke_fill", FILL_DTYPE),
        ("shadows", SHADOW_DTYPE, MAX_SHADOWS),
        ("blur", np.float32),
        ("tx", np.float32),
        ("ty", np.float32),
        ("use_matrix", np.uint8),
        ("_pad2", np.uint8, 3),
        ("matrix", np.float32, 6),
        # nkImage / nkMsdfImage / nkMtsdfImage payload
        ("image_id", np.int64),
        ("px_range", np.float32),
        ("sd_threshold", np.float32),
        ("msdf_stroke", np.float32),
        ("image_fill", FILL_DTYPE),
        # nkDrawable payload: ops live in the layer's side arrays
        ("ops_start", np.int32),
        ("ops_count", np.int32),
        ("draw_weight", np.float32),
        ("draw_cap", np.uint8),
        ("draw_join", np.uint8),
        ("draw_steps", np.uint16),
        ("draw_aa", np.float32),
        ("draw_stroke_fill", FILL_DTYPE),
        # nkText payload: glyphs + selection/decoration rects in side arrays
        ("glyphs_start", np.int32),
        ("glyphs_count", np.int32),
        ("trects_start", np.int32),
        ("trects_count", np.int32),
    ]
)

# nkText side-array rows (the slice draws no text; the walk still takes the
# arrays, empty)
GLYPH_DTYPE = np.dtype(
    [
        ("font_id", np.int64),
        ("glyph_id", np.int32),
        ("fill", FILL_DTYPE),
        ("x", np.float64),
        ("y", np.float64),
        ("img_ox", np.float64),
        ("img_oy", np.float64),
    ]
)

TRECT_DTYPE = np.dtype(
    [
        ("x", np.float64),
        ("y", np.float64),
        ("w", np.float64),
        ("h", np.float64),
        ("fill", FILL_DTYPE),
    ]
)

# DrawableOp side-array row: kind + fixed payload; bezier control points live
# in the points buffer referenced by (p_start, p_count).
OP_DTYPE = np.dtype(
    [
        ("kind", np.uint8),
        ("_pad", np.uint8, 3),
        ("p_start", np.int32),
        ("p_count", np.int32),
        ("steps", np.uint16),
        ("_pad2", np.uint16),
        ("data", np.float32, 8),  # line: ax ay bx by | circle: cx cy r |
        # rect: x y w h + corners packed in data[4..7] | arc: cx cy r a0 sweep
        # | ellipse: cx cy rx ry
    ]
)

# node kinds the native flattener handles
NATIVE_KINDS = frozenset(
    {
        int(FigKind.nkFrame),
        int(FigKind.nkRectangle),
        int(FigKind.nkBackdropBlur),
        int(FigKind.nkTransform),
        int(FigKind.nkScrollBar),
        int(FigKind.nkImage),
        int(FigKind.nkMsdfImage),
        int(FigKind.nkMtsdfImage),
        int(FigKind.nkDrawable),
        int(FigKind.nkText),
    }
)

# uint8-indexed membership LUT for the per-frame all_native_kinds check
_NATIVE_KIND_LUT = np.zeros(256, bool)
_NATIVE_KIND_LUT[list(NATIVE_KINDS)] = True


def _merge_structured(rows: list, dtype) -> np.ndarray:
    """Merge a list of same-dtype structured blocks/rows into one array by
    raw byte copy."""
    if not rows:
        return np.zeros(0, dtype=dtype)
    blocks = [np.atleast_1d(b) for b in rows]
    total = sum(b.shape[0] for b in blocks)
    out = np.empty(total, dtype=dtype)
    out_b = out.view(np.uint8)
    isz = dtype.itemsize
    off = 0
    for b in blocks:
        nb = b.shape[0] * isz
        out_b[off : off + nb] = np.ascontiguousarray(b).view(np.uint8)
        off += nb
    return out


def _rgba_tuple(c):
    return (c.r, c.g, c.b, c.a)


def pack_fill(out, f) -> None:
    """Write a fill.Fill into a FILL_DTYPE row (nodesarray.pack_fill)."""
    if f.kind == FillKind.flColor:
        out["kind"] = 0
        out["c0"] = _rgba_tuple(f.color)
    elif f.kind == FillKind.flLinear2:
        out["kind"] = 1
        out["axis"] = int(f.lin2.axis)
        out["c0"] = _rgba_tuple(f.lin2.start)
        out["c1"] = _rgba_tuple(f.lin2.stop)
    else:
        out["kind"] = 2
        out["axis"] = int(f.lin3.axis)
        out["midpos"] = f.lin3.mid_pos
        out["c0"] = _rgba_tuple(f.lin3.start)
        out["c1"] = _rgba_tuple(f.lin3.mid)
        out["c2"] = _rgba_tuple(f.lin3.stop)


class RenderListArray:
    """Numpy-backed render list: FIG_DTYPE rows written column by column,
    plus the drawable/text side arrays the walk reads."""

    def __init__(self, capacity: int = 64):
        self.nodes = np.zeros(capacity, dtype=FIG_DTYPE)
        self.count = 0
        self.root_ids: list[int] = []
        self.ops_rows: list = []
        self.points_rows: list = []
        self.glyph_rows: list = []
        self.trect_rows: list = []
        self._ops_cache = None
        self._text_cache = None

    def ops_view(self):
        """(ops array, points array) for the native walk."""
        if self._ops_cache is None or self._ops_cache[0] != len(self.ops_rows):
            ops = _merge_structured(self.ops_rows, OP_DTYPE)
            pts = (
                np.asarray(self.points_rows, dtype=np.float32).reshape(-1, 2)
                if self.points_rows
                else np.zeros((0, 2), dtype=np.float32)
            )
            self._ops_cache = (len(self.ops_rows), ops, pts)
        return self._ops_cache[1], self._ops_cache[2]

    def text_view(self):
        """(glyphs array, trects array) for the native walk."""
        if self._text_cache is None or self._text_cache[0] != len(self.glyph_rows):
            glyphs = _merge_structured(self.glyph_rows, GLYPH_DTYPE)
            trects = _merge_structured(self.trect_rows, TRECT_DTYPE)
            self._text_cache = (len(self.glyph_rows), glyphs, trects)
        return self._text_cache[1], self._text_cache[2]

    def _grow(self) -> None:
        new = np.zeros(self.nodes.shape[0] * 2, dtype=FIG_DTYPE)
        new[: self.count] = self.nodes[: self.count]
        self.nodes = new

    def _alloc(self) -> int:
        if self.count == self.nodes.shape[0]:
            self._grow()
        i = self.count
        self.count += 1
        return i

    def add_root_raw(self) -> int:
        """Allocate a zeroed root row for direct field writes."""
        i = self._alloc()
        self.nodes[i]["parent"] = -1
        self.root_ids.append(i)
        return i

    def add_child_raw(self, parent_idx: int) -> int:
        """Allocate a zeroed child row of `parent_idx` for direct field
        writes (the walk scans forward from the parent for its children)."""
        i = self._alloc()
        self.nodes[i]["parent"] = parent_idx
        self.nodes[parent_idx]["child_count"] += 1
        return i

    # --- retained-scene edits in place (nodesarray.py:509-533) ---------------
    # These write FIG columns directly, so the walk's cached side arrays stay
    # valid; renderer.update_scene(scene, renders, dirty=[(lvl, root_idx),
    # ...]) then patches only the edited roots' rows on the device.

    def set_box(self, i: int, x: float, y: float, w: float, h: float) -> None:
        self.nodes[i]["box"] = (x, y, w, h)

    def set_rotation(self, i: int, degrees: float) -> None:
        self.nodes[i]["rotation"] = degrees

    def set_fill(self, i: int, f) -> None:
        pack_fill(self.nodes[i]["fill"], f)

    def set_stroke_fill(self, i: int, f) -> None:
        pack_fill(self.nodes[i]["stroke_fill"], f)

    def set_solid_color(self, i: int, color) -> None:
        """Recolor a solid fill; color: a ColorRGBA."""
        self.nodes[i]["fill"]["kind"] = 0
        self.nodes[i]["fill"]["c0"] = _rgba_tuple(color)

    def set_corners(self, i: int, radii) -> None:
        self.nodes[i]["corners"] = radii

    def set_transform_offset(self, i: int, tx: float, ty: float) -> None:
        """Move an nkTransform node (offset mode)."""
        self.nodes[i]["tx"] = tx
        self.nodes[i]["ty"] = ty

    def view(self) -> np.ndarray:
        return self.nodes[: self.count]

    def all_native_kinds(self) -> bool:
        return bool(_NATIVE_KIND_LUT[self.view()["kind"]].all())


class RendersArray:
    """ZLevel → RenderListArray layer table."""

    def __init__(self):
        self.layers: dict[int, RenderListArray] = {}

    def __getitem__(self, lvl: int) -> RenderListArray:
        if lvl not in self.layers:
            self.layers[lvl] = RenderListArray()
        return self.layers[lvl]

    def set_layer(self, lvl: int, lst: RenderListArray) -> None:
        self.layers[lvl] = lst

    def sorted_pairs(self):
        return sorted(self.layers.items(), key=lambda kv: kv[0])

    def all_native_kinds(self) -> bool:
        return all(lst.all_native_kinds() for lst in self.layers.values())
