"""The gvar table for the port's OpenType reader: glyph variation data read
per glyph, and the instancing of a glyf glyph's points at a normalized
location, with no fontTools.

It gives what fontTools 4.61.1 gives figdraw_tpu (ttLib/tables/_g_v_a_r.py,
TupleVariation.py, varLib/iup.py and ttGlyphSet._TTGlyphGlyf
._getGlyphInstance), number for number:

- the table: shared tuples, the short and long offset forms, each glyph's
  tuple variation headers (shared or embedded peaks, intermediate regions,
  private or shared point numbers), packed point numbers and packed deltas
  (zero, byte, word and long runs);
- a region's axes as (start, peak, end), inferred from the peak when the
  header has no intermediate region; the axes whose triple is all zero
  left out;
- untouched points inferred contour by contour as iup_delta does, the four
  phantom points each a contour of its own;
- the instance: the glyph's points and phantom points as float64, each
  variation's deltas times its region scalar added in order, zero scalars
  skipped.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .varstore import f2dot14, packed_values, support_scalar

EMBEDDED_PEAK_TUPLE = 0x8000
INTERMEDIATE_REGION = 0x4000
PRIVATE_POINT_NUMBERS = 0x2000
TUPLE_INDEX_MASK = 0x0FFF
TUPLES_SHARE_POINT_NUMBERS = 0x8000
TUPLE_COUNT_MASK = 0x0FFF
POINTS_ARE_WORDS = 0x80
POINT_RUN_COUNT_MASK = 0x7F

Support = Dict[str, Tuple[float, float, float]]


def _points(data: bytes, pos: int, n_points: int):
    """Packed point numbers: (the points, the position after them); every
    point of the glyph when the count is 0."""
    count = data[pos]
    pos += 1
    if count & POINTS_ARE_WORDS:
        count = (count & POINT_RUN_COUNT_MASK) << 8 | data[pos]
        pos += 1
    if count == 0:
        return range(n_points), pos
    result: List[int] = []
    while len(result) < count:
        head = data[pos]
        pos += 1
        run = (head & POINT_RUN_COUNT_MASK) + 1
        if head & POINTS_ARE_WORDS:
            result.extend(struct.unpack_from(">%dH" % run, data, pos))
            pos += 2 * run
        else:
            result.extend(data[pos : pos + run])
            pos += run
    absolute, current = [], 0
    for d in result:
        current += d
        absolute.append(current)
    return absolute, pos


class Gvar:
    """A gvar table read from a face's bytes: variations decoded per glyph
    on first use."""

    def __init__(self, data: bytes, off: int, axis_tags: Sequence[str]):
        self.data = data
        self.axis_tags = list(axis_tags)
        (_major, _minor, n_axes, n_shared, shared_off, n_glyphs, flags,
         data_off) = struct.unpack_from(">HHHHIHHI", data, off)
        if n_axes != len(self.axis_tags):
            raise ValueError(f"gvar has {n_axes} axes, fvar {len(self.axis_tags)}")
        self.shared = []
        at = off + shared_off
        for _ in range(n_shared):
            self.shared.append(self._coord(data, at))
            at += 2 * n_axes
        if flags & 1:
            offs = np.frombuffer(data, ">u4", n_glyphs + 1, off + 20).astype(np.int64)
        else:
            offs = np.frombuffer(data, ">u2", n_glyphs + 1, off + 20).astype(np.int64) * 2
        self.offsets = offs
        self.data_base = off + data_off
        self.n_glyphs = n_glyphs
        self._cache: Dict[int, list] = {}

    def variations(self, gid: int, n_points: int) -> List[Tuple[Support, list]]:
        """Glyph `gid`'s variations: (axes, deltas) with a delta (dx, dy) or
        None per point (phantom points included in `n_points`)."""
        found = self._cache.get(gid)
        if found is not None:
            return found
        start = self.data_base + int(self.offsets[gid])
        end = self.data_base + int(self.offsets[gid + 1])
        out: List[Tuple[Support, list]] = []
        if end - start >= 4:
            out = self._decode(self.data[start:end], n_points)
        self._cache[gid] = out
        return out

    def _decode(self, data: bytes, n_points: int):
        n_axes = len(self.axis_tags)
        count, data_pos = struct.unpack_from(">HH", data, 0)
        pos = 4
        shared_points: Sequence[int] = []
        if count & TUPLES_SHARE_POINT_NUMBERS:
            shared_points, data_pos = _points(data, data_pos, n_points)
        out = []
        for _ in range(count & TUPLE_COUNT_MASK):
            size, flags = struct.unpack_from(">HH", data, pos)
            at = pos + 4
            if flags & EMBEDDED_PEAK_TUPLE:
                peak = self._coord(data, at)
                at += 2 * n_axes
            else:
                peak = self.shared[flags & TUPLE_INDEX_MASK]
            if flags & INTERMEDIATE_REGION:
                start = self._coord(data, at)
                end = self._coord(data, at + 2 * n_axes)
                at += 4 * n_axes
            else:
                start = {a: min(v, 0.0) for a, v in peak.items()}
                end = {a: max(v, 0.0) for a, v in peak.items()}
            axes: Support = {}
            for tag in self.axis_tags:
                region = start[tag], peak[tag], end[tag]
                if region != (0.0, 0.0, 0.0):
                    axes[tag] = region
            tuple_data = data[data_pos : data_pos + size]
            p = 0
            if flags & PRIVATE_POINT_NUMBERS:
                points, p = _points(tuple_data, 0, n_points)
            else:
                points = shared_points
            xs, p = packed_values(tuple_data, p, len(tuple_data), len(points))
            ys, p = packed_values(tuple_data, p, len(tuple_data), len(points))
            deltas: list = [None] * n_points
            for k, x, y in zip(points, xs, ys):
                if 0 <= k < n_points:
                    deltas[k] = (x, y)
            out.append((axes, deltas))
            pos = at
            data_pos += size
        return out

    def _coord(self, data: bytes, at: int) -> Dict[str, float]:
        raw = struct.unpack_from(">%dh" % len(self.axis_tags), data, at)
        return {tag: f2dot14(v) for tag, v in zip(self.axis_tags, raw)}


def _iup_segment(coords, rc1, rd1, rc2, rd2):
    out_arrays = [None, None]
    for j in 0, 1:
        out_arrays[j] = out = []
        x1, x2, d1, d2 = rc1[j], rc2[j], rd1[j], rd2[j]
        if x1 == x2:
            n = len(coords)
            out.extend([d1] * n if d1 == d2 else [0] * n)
            continue
        if x1 > x2:
            x1, x2 = x2, x1
            d1, d2 = d2, d1
        scale = (d2 - d1) / (x2 - x1)
        for pair in coords:
            x = pair[j]
            if x <= x1:
                d = d1
            elif x >= x2:
                d = d2
            else:
                nudge = (x - x1) * scale
                d = d1 + nudge
            out.append(d)
    return list(zip(*out_arrays))


def _iup_contour(deltas, coords):
    if None not in deltas:
        return deltas
    n = len(deltas)
    indices = [i for i, v in enumerate(deltas) if v is not None]
    if not indices:
        return [(0, 0)] * n
    out = []
    it = iter(indices)
    start = next(it)
    if start != 0:
        i1, i2, ri1, ri2 = 0, start, start, indices[-1]
        out.extend(_iup_segment(coords[i1:i2], coords[ri1], deltas[ri1], coords[ri2],
                                deltas[ri2]))
    out.append(deltas[start])
    for end in it:
        if end - start > 1:
            i1, i2, ri1, ri2 = start + 1, end, start, end
            out.extend(_iup_segment(coords[i1:i2], coords[ri1], deltas[ri1], coords[ri2],
                                    deltas[ri2]))
        out.append(deltas[end])
        start = end
    if start != n - 1:
        i1, i2, ri1, ri2 = start + 1, n, start, indices[0]
        out.extend(_iup_segment(coords[i1:i2], coords[ri1], deltas[ri1], coords[ri2],
                                deltas[ri2]))
    return out


def iup_delta(deltas, coords, ends: List[int]):
    """varLib.iup.iup_delta: the missing (None) deltas of each contour (and
    of each phantom point) interpolated from the contour's explicit ones."""
    n = len(coords)
    ends = list(ends) + [n - 4, n - 3, n - 2, n - 1]
    out = []
    start = 0
    for end in ends:
        end += 1
        out.extend(_iup_contour(deltas[start:end], coords[start:end]))
        start = end
    return out


def instance_coordinates(coords: np.ndarray, variations, location: Dict[str, float],
                         ends: List[int]) -> np.ndarray:
    """A glyph's (N + 4, 2) float64 points (phantom points last) moved to
    `location`: each variation whose region scalar is not 0 adds its deltas
    (untouched points inferred) times the scalar."""
    orig = None
    out = coords.astype(np.float64, copy=True)
    for axes, delta in variations:
        scalar = support_scalar(location, axes)
        if not scalar:
            continue
        if None in delta:
            if orig is None:
                orig = [_py_point(p) for p in coords.astype(np.float64).tolist()]
            delta = iup_delta(delta, orig, ends)
        out += np.asarray(delta, dtype=np.float64) * scalar
    return out


def _py_point(p):
    x, y = p
    return (int(x) if x.is_integer() else x, int(y) if y.is_integer() else y)
