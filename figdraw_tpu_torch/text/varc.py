"""The VARC table (variable composites) for the port's OpenType reader,
decoded as fontTools 4.61.1's otTables decodes it and drawn as its
ttGlyphSet._TTGlyphVARC draws a glyph onto a DecomposingRecordingPen:

- the table: Coverage, the MultiVarStore (text/varstore.py), the
  ConditionList (formats 1-5; 3 and 4 hold 24-bit offsets), the
  AxisIndicesList and the VarCompositeGlyphs, both CFF2-style INDEXes;
- a VarComponent: its VarComponentFlags as a uint32var, a 16- or 24-bit
  glyph id, the condition index, the axis indices index, the axis values
  (packed deltas in F2Dot14), the axis values' and the transform's
  variation indices, the transform fields each with its fraction bits and
  scale (VAR_TRANSFORM_MAPPING), scaleY following scaleX when absent, and
  a uint32var skipped for each reserved flag bit;
- the draw: MultiVarStoreInstancer at the glyph set's current location;
  a component's condition by _evaluateCondition (format 5 raises, as
  fontTools' reads an attribute the decoded table does not have); axis
  values plus fi2fl(delta, 14); VarComponent.applyTransformDeltas;
  DecomposedTransform.toTransform; the location pushed on both glyph sets
  (with RESET_UNSPECIFIED_AXES from the glyph set's original location,
  else from the current one, the component's axes set over it) for the
  component's draw. A component naming the glyph itself is drawn from the
  outline glyph set; any other through the VARC glyph set, so a component
  in Coverage is drawn as VARC again. Each draw goes through a TransformPen
  of its own: the pen chain transforms each point innermost first.

The pushed rawLocation only feeds pen.addVarComponent, which a
DecomposingRecordingPen refuses, so it is not kept.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Tuple

from .varstore import NO_VARIATION_INDEX, MultiVarStore, f2dot14, packed_values, tuple_list

_U16 = struct.Struct(">H").unpack_from
_U32 = struct.Struct(">I").unpack_from

# VarComponentFlags
RESET_UNSPECIFIED_AXES = 1 << 0
HAVE_AXES = 1 << 1
AXIS_VALUES_HAVE_VARIATION = 1 << 2
TRANSFORM_HAS_VARIATION = 1 << 3
HAVE_TRANSLATE_X = 1 << 4
HAVE_TRANSLATE_Y = 1 << 5
HAVE_ROTATION = 1 << 6
HAVE_CONDITION = 1 << 7
HAVE_SCALE_X = 1 << 8
HAVE_SCALE_Y = 1 << 9
HAVE_TCENTER_X = 1 << 10
HAVE_TCENTER_Y = 1 << 11
GID_IS_24BIT = 1 << 12
HAVE_SKEW_X = 1 << 13
HAVE_SKEW_Y = 1 << 14
RESERVED_MASK = (1 << 32) - (1 << 15)

# VAR_TRANSFORM_MAPPING: field -> (flag, fraction bits, scale, default), in
# the order the fields are stored
TRANSFORM_FIELDS = (
    ("translateX", HAVE_TRANSLATE_X, 0, 1, 0),
    ("translateY", HAVE_TRANSLATE_Y, 0, 1, 0),
    ("rotation", HAVE_ROTATION, 12, 180, 0),
    ("scaleX", HAVE_SCALE_X, 10, 1, 1),
    ("scaleY", HAVE_SCALE_Y, 10, 1, 1),
    ("skewX", HAVE_SKEW_X, 12, -180, 0),
    ("skewY", HAVE_SKEW_Y, 12, 180, 0),
    ("tCenterX", HAVE_TCENTER_X, 0, 1, 0),
    ("tCenterY", HAVE_TCENTER_Y, 0, 1, 0),
)

_EPSILON = 1e-15


def read_uint32var(data: bytes, i: int) -> Tuple[int, int]:
    """otTables._read_uint32var: (the number, the position after it)."""
    b0 = data[i]
    if b0 < 0x80:
        return b0, i + 1
    if b0 < 0xC0:
        return (b0 - 0x80) << 8 | data[i + 1], i + 2
    if b0 < 0xE0:
        return (b0 - 0xC0) << 16 | data[i + 1] << 8 | data[i + 2], i + 3
    if b0 < 0xF0:
        return ((b0 - 0xE0) << 24 | data[i + 1] << 16 | data[i + 2] << 8
                | data[i + 3]), i + 4
    return ((b0 - 0xF0) << 32 | data[i + 1] << 24 | data[i + 2] << 16
            | data[i + 3] << 8 | data[i + 4]), i + 5


class VarComponent:
    """One decoded VarComponent, under fontTools' attribute names (gid in
    place of glyphName); transform is a {field: value} dict."""

    __slots__ = ("flags", "gid", "conditionIndex", "axisIndicesIndex", "axisValues",
                 "axisValuesVarIndex", "transformVarIndex", "transform")


def decode_components(data: bytes, pos: int, end: int, axis_lists: List[list],
                      num_glyphs: int) -> List[VarComponent]:
    """VarCompositeGlyph.decompile: the components of one glyph's record."""
    out = []
    while pos < end:
        c = VarComponent()
        flags, pos = read_uint32var(data, pos)
        c.flags = flags
        if flags & GID_IS_24BIT:
            c.gid = int.from_bytes(data[pos : pos + 3], "big")
            pos += 3
        else:
            c.gid = _U16(data, pos)[0]
            pos += 2
        if c.gid >= num_glyphs:
            raise IndexError(f"a VarComponent names glyph {c.gid} of {num_glyphs}")
        c.conditionIndex = None
        if flags & HAVE_CONDITION:
            c.conditionIndex, pos = read_uint32var(data, pos)
        c.axisIndicesIndex = None
        c.axisValues = ()
        if flags & HAVE_AXES:
            c.axisIndicesIndex, pos = read_uint32var(data, pos)
            n_axes = len(axis_lists[c.axisIndicesIndex])
            values, pos = packed_values(data, pos, end, n_axes)
            c.axisValues = tuple(f2dot14(v) for v in values)
        c.axisValuesVarIndex = NO_VARIATION_INDEX
        if flags & AXIS_VALUES_HAVE_VARIATION:
            c.axisValuesVarIndex, pos = read_uint32var(data, pos)
        c.transformVarIndex = NO_VARIATION_INDEX
        if flags & TRANSFORM_HAS_VARIATION:
            c.transformVarIndex, pos = read_uint32var(data, pos)
        transform = {}
        for name, flag, bits, scale, default in TRANSFORM_FIELDS:
            if flags & flag:
                transform[name] = struct.unpack_from(">h", data, pos)[0] / (1 << bits) * scale
                pos += 2
            else:
                transform[name] = default
        if not flags & HAVE_SCALE_Y:
            transform["scaleY"] = transform["scaleX"]
        c.transform = transform
        n = flags & RESERVED_MASK
        while n:
            _, pos = read_uint32var(data, pos)
            n &= n - 1
        out.append(c)
    return out


def apply_transform_deltas(flags: int, transform: Dict[str, float], deltas) -> Dict[str, float]:
    """VarComponent.applyTransformDeltas on a copy: each flagged field plus
    fi2fl(its delta, its fraction bits) times its scale, in field order."""
    out = dict(transform)
    i = 0
    for name, flag, bits, scale, _default in TRANSFORM_FIELDS:
        value = 0
        if flags & flag:
            value = deltas[i] / (1 << bits) * scale
            i += 1
        out[name] = out[name] + value
    if not flags & HAVE_SCALE_Y:
        out["scaleY"] = out["scaleX"]
    if i != len(deltas):
        raise ValueError(f"{len(deltas)} transform deltas for {i} transform fields")
    return out


def _norm_sin_cos(v: float):
    if abs(v) < _EPSILON:
        return 0
    if v > 1 - _EPSILON:
        return 1
    if v < -1 + _EPSILON:
        return -1
    return v


def _then(t, other):
    """fontTools' Transform(t).transform(other)."""
    xx1, xy1, yx1, yy1, dx1, dy1 = other
    xx2, xy2, yx2, yy2, dx2, dy2 = t
    return (xx1 * xx2 + xy1 * yx2, xx1 * xy2 + xy1 * yy2,
            yx1 * xx2 + yy1 * yx2, yx1 * xy2 + yy1 * yy2,
            xx2 * dx1 + yx2 * dy1 + dx2, xy2 * dx1 + yy2 * dy1 + dy2)


def to_transform(tr: Dict[str, float]) -> tuple:
    """DecomposedTransform.toTransform: translate by the translation plus
    the centre, rotate, scale, skew, translate back by the centre."""
    t = (1, 0, 0, 1, 0, 0)
    t = _then(t, (1, 0, 0, 1, tr["translateX"] + tr["tCenterX"],
                  tr["translateY"] + tr["tCenterY"]))
    angle = math.radians(tr["rotation"])
    c, s = _norm_sin_cos(math.cos(angle)), _norm_sin_cos(math.sin(angle))
    t = _then(t, (c, s, -s, c, 0, 0))
    t = _then(t, (tr["scaleX"], 0, 0, tr["scaleY"], 0, 0))
    t = _then(t, (1, math.tan(math.radians(tr["skewY"])),
                  math.tan(math.radians(tr["skewX"])), 1, 0, 0))
    return _then(t, (1, 0, 0, 1, -tr["tCenterX"], -tr["tCenterY"]))


class Condition:
    """A decoded ConditionTable: format and its fields (sub-conditions
    decoded with it)."""

    __slots__ = ("Format", "AxisIndex", "FilterRangeMinValue", "FilterRangeMaxValue",
                 "DefaultValue", "VarIdx", "ConditionTable")


def decode_condition(data: bytes, off: int) -> Condition:
    c = Condition()
    c.Format = fmt = _U16(data, off)[0]
    if fmt == 1:
        c.AxisIndex, lo, hi = struct.unpack_from(">Hhh", data, off + 2)
        c.FilterRangeMinValue, c.FilterRangeMaxValue = f2dot14(lo), f2dot14(hi)
    elif fmt == 2:
        c.DefaultValue, c.VarIdx = struct.unpack_from(">hI", data, off + 2)
    elif fmt in (3, 4):
        n = data[off + 2]
        c.ConditionTable = [decode_condition(data, off + int.from_bytes(
            data[off + 3 + 3 * k : off + 6 + 3 * k], "big")) for k in range(n)]
    elif fmt == 5:
        c.ConditionTable = decode_condition(
            data, off + int.from_bytes(data[off + 2 : off + 5], "big"))
    return c


def evaluate_condition(c: Condition, axis_tags: List[str], location: Dict[str, float],
                       instancer) -> bool:
    """ttGlyphSet._evaluateCondition."""
    if c.Format == 1:
        value = location.get(axis_tags[c.AxisIndex], 0)
        return c.FilterRangeMinValue <= value <= c.FilterRangeMaxValue
    if c.Format == 2:
        value = c.DefaultValue
        value += instancer[c.VarIdx][0]
        return value > 0
    if c.Format == 3:
        return all(evaluate_condition(s, axis_tags, location, instancer)
                   for s in c.ConditionTable)
    if c.Format == 4:
        return any(evaluate_condition(s, axis_tags, location, instancer)
                   for s in c.ConditionTable)
    if c.Format == 5:
        raise NotImplementedError(
            "VARC condition format 5 (negation) is not drawn: fontTools 4.61.1's "
            "_evaluateCondition reads 'conditionTable', which its decoded table does "
            "not have, and raises AttributeError, so figdraw_tpu cannot draw such a "
            "glyph either")
    return False


class VarcTable:
    """A face's VARC table: Coverage as {gid: index}, its store, conditions
    and axis index lists; each glyph's components decoded on first use."""

    def __init__(self, data: bytes, off: int, axis_tags: List[str], num_glyphs: int):
        self.data = data
        self.axis_tags = list(axis_tags)
        self.num_glyphs = num_glyphs
        (version, cov, store, conds, axes, glyphs) = struct.unpack_from(">6I", data, off)
        if version >> 16 != 1:
            raise NotImplementedError(f"VARC version {version:#x}")
        self.coverage = _coverage(data, off + cov)
        self.store = MultiVarStore(data, off + store, axis_tags) if store else None
        self.conditions: List[Condition] = []
        if conds:
            at = off + conds
            n = _U32(data, at)[0]
            self.conditions = [decode_condition(data, at + o)
                               for o in struct.unpack_from(">%dI" % n, data, at + 4)]
        self.axis_lists: List[list] = []
        if axes:
            self.axis_lists = [packed_values(data, a, b)[0]
                               for a, b in tuple_list(data, off + axes)]
        self._records = tuple_list(data, off + glyphs)
        self._glyphs: Dict[int, List[VarComponent]] = {}
        self._instancers: Dict[tuple, object] = {}

    def components(self, gid: int) -> List[VarComponent]:
        found = self._glyphs.get(gid)
        if found is None:
            start, end = self._records[self.coverage[gid]]
            found = self._glyphs[gid] = decode_components(
                self.data, start, end, self.axis_lists, self.num_glyphs)
        return found

    def instancer(self, location: Dict[str, float]):
        key = tuple(location.items())
        inst = self._instancers.get(key)
        if inst is None:
            if self.store is None:
                inst = _EmptyInstancer()
            else:
                inst = self.store.instancer(location)
            self._instancers[key] = inst
        return inst

    def draw(self, font, gid: int, chain: tuple, state, out: list) -> None:
        """_TTGlyphVARC._draw onto `out` through the pen chain `chain`
        (transforms, innermost first) with the glyph sets' location in
        `state` (state.loc, state.original)."""
        if not self.axis_tags:
            raise KeyError("fvar")
        inst = self.instancer(state.loc)
        for comp in self.components(gid):
            if comp.flags & HAVE_CONDITION:
                cond = self.conditions[comp.conditionIndex]
                if not evaluate_condition(cond, self.axis_tags, state.loc, inst):
                    continue
            location = {}
            if comp.axisIndicesIndex is not None:
                indices = self.axis_lists[comp.axisIndicesIndex]
                values = comp.axisValues
                if comp.axisValuesVarIndex != NO_VARIATION_INDEX:
                    deltas = inst[comp.axisValuesVarIndex]
                    if len(deltas) != len(values):
                        raise ValueError(f"{len(deltas)} axis value deltas for "
                                         f"{len(values)} axes")
                    values = [v + d / (1 << 14) for v, d in zip(values, deltas)]
                if len(indices) != len(values):
                    raise ValueError(f"{len(values)} axis values for {len(indices)} axes")
                location = {self.axis_tags[i]: v for i, v in zip(indices, values)}
            transform = comp.transform
            if comp.transformVarIndex != NO_VARIATION_INDEX:
                transform = apply_transform_deltas(comp.flags, transform,
                                                   inst[comp.transformVarIndex])
            saved = state.loc
            state.loc = dict(state.original if comp.flags & RESET_UNSPECIFIED_AXES
                             else saved)
            state.loc.update(location)
            try:
                sub = (to_transform(transform),) + chain
                if comp.gid == gid:
                    font._draw_outline(comp.gid, sub, state, out)
                else:
                    font._draw_from_set(comp.gid, sub, state, out)
            finally:
                state.loc = saved


class _EmptyInstancer:
    """MultiVarStoreInstancer over a null store: no data to index."""

    def __getitem__(self, var_idx: int) -> list:
        if var_idx == NO_VARIATION_INDEX:
            return []
        raise IndexError(f"variation index {var_idx:#x} of a VARC table without a store")


def _coverage(data: bytes, off: int) -> Dict[int, int]:
    """A Coverage table as {gid: coverage index} (the first index of a
    glyph listed twice, as list.index finds it; format 2's ranges in
    StartCoverageIndex order, as fontTools' postRead sorts them)."""
    fmt, n = struct.unpack_from(">HH", data, off)
    gids: List[int] = []
    if fmt == 1:
        gids = list(struct.unpack_from(">%dH" % n, data, off + 4))
    elif fmt == 2:
        ranges = sorted((struct.unpack_from(">HHH", data, off + 4 + 6 * i) for i in range(n)),
                        key=lambda r: r[2])
        for start, end, _idx in ranges:
            gids.extend(range(start, end + 1))
    out: Dict[int, int] = {}
    for i, g in enumerate(gids):
        out.setdefault(g, i)
    return out


def apply_chain(chain: tuple, pt):
    """A point through a TransformPen chain (innermost transform first)."""
    x, y = pt
    for xx, xy, yx, yy, dx, dy in chain:
        x, y = xx * x + yx * y + dx, xy * x + yy * y + dy
    return (x, y)


def emit(recorded: list, chain: tuple, out: list) -> None:
    """A recording (pen value list) replayed onto `out` through the chain;
    qCurveTo's closing None passes as it is."""
    for op, pts in recorded:
        out.append((op, tuple(None if p is None else apply_chain(chain, p) for p in pts)))
