"""OpenType variations for the port's OpenType reader: location
normalization (fvar, avar 1 and 2), the region scalar, the
ItemVariationStore and its index maps, in struct and plain Python floats.

Each function gives what fontTools 4.61.1 gives, operation for operation,
so that instanced outlines and advances equal figdraw_tpu's (which reads
faces through fontTools) as numbers:

- normalize_value / normalize_location: varLib.models.normalizeValue and
  normalizeLocation over fvar's (min, default, max) triples;
- piecewise_linear_map and Avar.renormalize: an avar table's segment maps
  and, for avar 2, its DeltaSetIndexMap and store
  (ttLib/tables/_a_v_a_r.py renormalizeLocation);
- support_scalar: varLib.models.supportScalar with ot=True;
- ItemVariationStore.delta / interpolate: varLib.varStore.VarStoreInstancer
  __getitem__ and interpolateFromDeltas;
- delta_set_index_map / var_idx_map: DeltaSetIndexMap formats 0 and 1 and
  HVAR's VarIdxMap (the mapping repeated past its end for every glyph);
- MultiVarStore / MultiStoreInstancer: the VARC table's store
  (varLib/multiVarStore.py): sparse regions (SparseVarRegion_get_support),
  packed delta rows in a TupleList, and MultiVarStoreInstancer's deltas,
  one vector per variation index.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

NO_VARIATION_INDEX = 0xFFFFFFFF

_U16 = struct.Struct(">H").unpack_from
_U32 = struct.Struct(">I").unpack_from


def ot_round(value: float) -> int:
    """fontTools' otRound: halves round towards +infinity."""
    return int(math.floor(value + 0.5))


def f2dot14(raw: int) -> float:
    return raw / (1 << 14)


def normalize_value(v: float, triple: Sequence[float]) -> float:
    """A user-space value to [-1, 1] on its axis's (min, default, max),
    clamped (normalizeValue without extrapolation)."""
    lower, default, upper = triple
    if not (lower <= default <= upper):
        raise ValueError(
            f"Invalid axis values, must be minimum, default, maximum: "
            f"{lower:3.3f}, {default:3.3f}, {upper:3.3f}")
    v = max(min(v, upper), lower)
    if v == default or lower == upper:
        return 0.0
    if (v < default and lower != default) or (v > default and upper == default):
        return (v - default) / (default - lower)
    return (v - default) / (upper - default)


def normalize_location(location: Dict[str, float],
                       axes: Dict[str, Tuple[float, float, float]]) -> Dict[str, float]:
    """Every axis of `axes` (fvar order), its value from `location` or its
    default, normalized."""
    return {tag: normalize_value(location.get(tag, triple[1]), triple)
            for tag, triple in axes.items()}


def piecewise_linear_map(v: float, mapping: Dict[float, float]) -> float:
    keys = mapping.keys()
    if not keys:
        return v
    if v in keys:
        return mapping[v]
    k = min(keys)
    if v < k:
        return v + mapping[k] - k
    k = max(keys)
    if v > k:
        return v + mapping[k] - k
    a = max(k for k in keys if k < v)
    b = min(k for k in keys if k > v)
    va = mapping[a]
    vb = mapping[b]
    return va + (vb - va) * (v - a) / (b - a)


def support_scalar(location: Dict[str, float],
                   support: Dict[str, Tuple[float, float, float]]) -> float:
    """The scalar of a region (tag -> (start, peak, end)) at a normalized
    location; an axis whose peak is 0 does not take part."""
    scalar = 1.0
    for axis, (lower, peak, upper) in support.items():
        if peak == 0.0:
            continue
        if lower > peak or peak > upper:
            continue
        if lower < 0.0 and upper > 0.0:
            continue
        v = location.get(axis, 0.0)
        if v == peak:
            continue
        if v <= lower or upper <= v:
            scalar = 0.0
            break
        if v < peak:
            scalar *= (v - lower) / (peak - lower)
        else:
            scalar *= (v - upper) / (peak - upper)
    return scalar


class ItemVariationStore:
    """An ItemVariationStore read from `data` at `off`: its regions (one
    support dict each, over the axis tags in fvar order) and its delta sets
    (VarData: region indices and rows of integer deltas)."""

    def __init__(self, data: bytes, off: int, axis_tags: Sequence[str], end: int = None,
                 name: str = "ItemVariationStore"):
        # every read lies within data[:end] (the table holding the store), as
        # fontTools' reader of the table's own bytes requires
        self.end = len(data) if end is None else min(end, len(data))
        self.name = name
        fmt, regions_off, n_data = self._unpack(data, ">HIH", off)
        if fmt != 1:
            raise NotImplementedError(f"ItemVariationStore format {fmt}")
        data_offs = self._unpack(data, ">%dI" % n_data, off + 8)
        self.regions: List[Dict[str, Tuple[float, float, float]]] = []
        if regions_off:
            at = off + regions_off
            n_axes, n_regions = self._unpack(data, ">HH", at)
            at += 4
            for _ in range(n_regions):
                coords = self._unpack(data, ">%dh" % (3 * n_axes), at)
                at += 6 * n_axes
                support = {}
                for i in range(n_axes):
                    start, peak, end = (f2dot14(c) for c in coords[3 * i : 3 * i + 3])
                    if peak != 0:
                        # an axis past fvar's has no tag, so no location moves it
                        support[axis_tags[i] if i < len(axis_tags) else None] = (start, peak, end)
                self.regions.append(support)
        self.var_data: List[Tuple[List[int], List[List[int]]]] = []
        for d_off in data_offs:
            self.var_data.append(self._var_data(data, off + d_off))

    def _unpack(self, data: bytes, fmt: str, at: int) -> tuple:
        if at < 0 or at + struct.calcsize(fmt) > self.end:
            raise ValueError(f"malformed {self.name}: a read at {at} runs past its table")
        return struct.unpack_from(fmt, data, at)

    def _var_data(self, data: bytes, at: int):
        n_items, word_count, n_regions = self._unpack(data, ">HHH", at)
        at += 6
        region_indices = list(self._unpack(data, ">%dH" % n_regions, at))
        at += 2 * n_regions
        long_words = bool(word_count & 0x8000)
        word_count &= 0x7FFF
        big, small = ("i", "h") if long_words else ("h", "b")
        n1, n2 = min(n_regions, word_count), max(n_regions, word_count)
        row = struct.Struct(">%d%s%d%s" % (n1, big, n2 - n1, small))
        if at + row.size * n_items > self.end:
            raise ValueError(f"malformed {self.name}: its delta rows run past its table")
        rows = []
        for _ in range(n_items):
            rows.append(list(row.unpack_from(data, at))[:n_regions])
            at += row.size
        return region_indices, rows

    def num_regions(self, outer: int) -> int:
        return len(self.var_data[outer][0])

    def instancer(self, location: Dict[str, float]) -> "StoreInstancer":
        return StoreInstancer(self, location)


class StoreInstancer:
    """VarStoreInstancer: deltas of a store at one normalized location,
    region scalars cached."""

    def __init__(self, store: ItemVariationStore, location: Dict[str, float]):
        self.store = store
        self.location = dict(location)
        self._scalars: Dict[int, float] = {}

    def _scalar(self, region: int) -> float:
        s = self._scalars.get(region)
        if s is None:
            s = self._scalars[region] = support_scalar(self.location,
                                                       self.store.regions[region])
        return s

    def interpolate(self, outer: int, deltas) -> float:
        """interpolateFromDeltas: the sum of deltas times the scalars of
        VarData `outer`'s regions, from 0.0, zero scalars skipped."""
        scalars = [self._scalar(r) for r in self.store.var_data[outer][0]]
        delta = 0.0
        for d, s in zip(deltas, scalars):
            if not s:
                continue
            delta += d * s
        return delta

    def __getitem__(self, var_idx: int) -> float:
        if var_idx == NO_VARIATION_INDEX:
            return 0.0
        outer, inner = var_idx >> 16, var_idx & 0xFFFF
        return self.interpolate(outer, self.store.var_data[outer][1][inner])


def _map_entries(data: bytes, at: int, entry_format: int, count: int) -> List[int]:
    inner_bits = 1 + (entry_format & 0x000F)
    inner_mask = (1 << inner_bits) - 1
    outer_mask = 0xFFFFFFFF - inner_mask
    outer_shift = 16 - inner_bits
    size = 1 + ((entry_format & 0x0030) >> 4)
    out = []
    for i in range(count):
        raw = int.from_bytes(data[at + size * i : at + size * (i + 1)], "big")
        out.append(((raw & outer_mask) << outer_shift) | (raw & inner_mask))
    return out


def delta_set_index_map(data: bytes, off: int) -> List[int]:
    """A DeltaSetIndexMap (formats 0 and 1) as its list of variation
    indices."""
    fmt, entry_format = data[off], data[off + 1]
    if fmt == 0:
        count, at = _U16(data, off + 2)[0], off + 4
    elif fmt == 1:
        count, at = _U32(data, off + 2)[0], off + 6
    else:
        raise NotImplementedError(f"DeltaSetIndexMap format {fmt}")
    if entry_format & 0xC0:
        raise ValueError("DeltaSetIndexMap entry format sets reserved bits")
    return _map_entries(data, at, entry_format, count)


def var_idx_map(data: bytes, off: int, n_glyphs: int) -> List[int]:
    """HVAR's advance-width map as fontTools reads it (a uint16 entry
    format and count, i.e. DeltaSetIndexMap format 0), its last entry
    repeated for the glyphs past its end."""
    entry_format, count = struct.unpack_from(">HH", data, off)
    if entry_format & 0xFFC0:
        raise ValueError("HVAR index map entry format sets reserved bits")
    out = _map_entries(data, off + 4, entry_format, count)
    out.extend([out[-1]] * (n_glyphs - len(out)))
    return out


class Avar:
    """An avar table: one {from: to} segment map per fvar axis and, for
    version 2, the axis index map and store applied after them."""

    def __init__(self, data: bytes, off: int, axis_tags: Sequence[str]):
        version = _U32(data, off)[0]
        self.major = version >> 16
        if self.major not in (1, 2):
            raise NotImplementedError("Unknown avar table version")
        n_axes = _U16(data, off + 6)[0]
        at = off + 8
        self.axis_tags = list(axis_tags)
        self.segments: Dict[str, Dict[float, float]] = {t: {} for t in axis_tags}
        for tag in list(axis_tags)[:n_axes]:
            count = _U16(data, at)[0]
            pairs = struct.unpack_from(">%dh" % (2 * count), data, at + 2)
            at += 2 + 4 * count
            seg = self.segments[tag] = {}
            for k in range(count):
                seg[f2dot14(pairs[2 * k])] = f2dot14(pairs[2 * k + 1])
        self.index_map: Optional[List[int]] = None
        self.store: Optional[ItemVariationStore] = None
        if self.major >= 2:
            map_off, store_off = struct.unpack_from(">II", data, at)
            if map_off:
                self.index_map = delta_set_index_map(data, off + map_off)
            if store_off:
                self.store = ItemVariationStore(data, off + store_off, axis_tags)

    def renormalize(self, location: Dict[str, float]) -> Dict[str, float]:
        mapped = {}
        for tag, value in location.items():
            seg = self.segments.get(tag)
            if seg is not None:
                value = piecewise_linear_map(value, seg)
            mapped[tag] = value
        if self.major < 2:
            return mapped
        inst = self.store.instancer(mapped) if self.store is not None else None
        coords = [ot_round(mapped.get(tag, 0) * (1 << 14)) for tag in self.axis_tags]
        out = []
        for idx, v in enumerate(coords):
            if self.index_map is not None:
                idx = self.index_map[idx]
            if inst is not None:
                v += ot_round(inst[idx])
                v = min(max(v, -(1 << 14)), 1 << 14)
            out.append(v)
        return {tag: f2dot14(v) for v, tag in zip(out, self.axis_tags) if v != 0}


DELTAS_ARE_ZERO, DELTAS_ARE_WORDS, DELTAS_ARE_LONGS = 0x80, 0x40, 0xC0
DELTAS_SIZE_MASK, DELTA_RUN_COUNT_MASK = 0xC0, 0x3F


def packed_values(data: bytes, pos: int, end: int, count: Optional[int] = None):
    """TupleVariation.decompileDeltas_: packed deltas (zero, byte, word and
    long runs) from `pos`, `count` of them (gvar's point deltas, VARC's
    axis values), or whole runs up to `end` when count is None (VARC's
    TupleList items); (the values, the position after them)."""
    out: List[int] = []
    while (len(out) < count) if count is not None else (pos < end):
        head = data[pos]
        pos += 1
        run = (head & DELTA_RUN_COUNT_MASK) + 1
        kind = head & DELTAS_SIZE_MASK
        if kind == DELTAS_ARE_ZERO:
            out.extend([0] * run)
            continue
        code, size = {DELTAS_ARE_LONGS: ("l", 4), DELTAS_ARE_WORDS: ("h", 2)}.get(
            kind, ("b", 1))
        out.extend(struct.unpack_from(">%d%s" % (run, code), data, pos))
        pos += size * run
    if count is not None and len(out) != count:
        raise ValueError(f"packed values: {len(out)} read, {count} expected")
    return out, pos


def tuple_list(data: bytes, off: int) -> List[Tuple[int, int]]:
    """A CFF2-style INDEX (uint32 count, offset size, 1-based offsets) as
    the (start, end) byte range of each item: otConverters' CFF2Index, which
    VARC's TupleLists and its glyph list are."""
    count = _U32(data, off)[0]
    if count == 0:
        return []
    size = data[off + 4]
    at = off + 5
    offs = [int.from_bytes(data[at + size * i : at + size * (i + 1)], "big")
            for i in range(count + 1)]
    base = at + size * (count + 1) - 1
    for a, b in zip(offs, offs[1:]):
        if b < a:
            raise ValueError("a TupleList's offsets go backwards")
    return [(base + a, base + b) for a, b in zip(offs, offs[1:])]


class MultiVarStore:
    """A MultiVarStore (format 1) read from `data` at `off`: its sparse
    regions (a support dict each, axes in the region's own order, as
    SparseVarRegion_get_support builds it) and its MultiVarData (region
    indices and the flat delta rows, one row per inner index)."""

    def __init__(self, data: bytes, off: int, axis_tags: Sequence[str]):
        fmt, regions_off, n_data = struct.unpack_from(">HIH", data, off)
        if fmt != 1:
            raise NotImplementedError(f"MultiVarStore format {fmt}")
        data_offs = struct.unpack_from(">%dI" % n_data, data, off + 8)
        self.regions: List[Dict[str, Tuple[float, float, float]]] = []
        if regions_off:
            at = off + regions_off
            n_regions = _U16(data, at)[0]
            for r_off in struct.unpack_from(">%dI" % n_regions, data, at + 2):
                r = at + r_off
                support = {}
                for k in range(_U16(data, r)[0]):
                    axis, start, peak, end = struct.unpack_from(">Hhhh", data, r + 2 + 8 * k)
                    support[axis_tags[axis]] = (f2dot14(start), f2dot14(peak), f2dot14(end))
                self.regions.append(support)
        self.var_data: List[Tuple[List[int], list]] = []
        for d_off in data_offs:
            at = off + d_off
            if data[at] != 1:
                raise NotImplementedError(f"MultiVarData format {data[at]}")
            n_regions = _U16(data, at + 1)[0]
            indices = list(struct.unpack_from(">%dH" % n_regions, data, at + 3))
            rows = [packed_values(data, a, b)[0]
                    for a, b in tuple_list(data, at + 3 + 2 * n_regions)]
            self.var_data.append((indices, rows))

    def instancer(self, location: Dict[str, float]) -> "MultiStoreInstancer":
        return MultiStoreInstancer(self, location)


class MultiStoreInstancer:
    """MultiVarStoreInstancer: a variation index's delta vector at one
    normalized location (region scalars cached), summed from 0 in region
    order with zero scalars skipped; an empty list for NO_VARIATION_INDEX."""

    def __init__(self, store: MultiVarStore, location: Dict[str, float]):
        self.store = store
        self.location = dict(location)
        self._scalars: Dict[int, float] = {}

    def _scalar(self, region: int) -> float:
        s = self._scalars.get(region)
        if s is None:
            s = self._scalars[region] = support_scalar(self.location,
                                                       self.store.regions[region])
        return s

    def __getitem__(self, var_idx: int) -> list:
        if var_idx == NO_VARIATION_INDEX:
            return []
        indices, rows = self.store.var_data[var_idx >> 16]
        deltas = rows[var_idx & 0xFFFF]
        if not deltas:
            return []
        scalars = [self._scalar(r) for r in indices]
        if len(deltas) % len(scalars):
            raise ValueError(f"a MultiVarData row of {len(deltas)} deltas over "
                             f"{len(scalars)} regions")
        m = len(deltas) // len(scalars)
        out = [0] * m
        for k, s in enumerate(scalars[: len(deltas) // m]):
            if not s:
                continue
            row = deltas[k * m : (k + 1) * m]
            out = [a + d * s for a, d in zip(out, row)]
        return out
