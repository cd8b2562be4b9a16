"""The port's CFF and CFF2 reader: the outline table of an 'OTTO' face and a
Type 2 charstring interpreter, in struct and plain Python numbers, with no
fontTools.

It gives what figdraw_tpu gets from fontTools 4.61.1 (cffLib and
misc/psCharStrings.py's T2OutlineExtractor drawing onto a
DecomposingRecordingPen), value for value:

- the table: the CFF header and its Name, Top DICT, String and Global Subrs
  INDEXes, or CFF2's header, Top DICT and 32-bit INDEXes; DICT operands
  (integers 28, 29 and 32-254, reals 30); CharStrings; a Private DICT and
  its local Subrs per font DICT; CID-keyed faces (ROS, FDArray, FDSelect
  formats 0, 3 and, in CFF2, 4); CFF2's VarStore;
- glyph names: charset formats 0, 1 and 2 and the predefined ISOAdobe,
  Expert and ExpertSubset charsets, repeated names renamed "name.N" as
  fontTools does, "cid%05d" in a CID-keyed face;
- the interpreter: every path operator (moveto, line, curve and flex
  forms), stem hints with hintmask/cntrmask's mask bytes counted and
  consumed, callsubr/callgsubr with the bias of 107, 1131 or 32768, the
  optional width operand, endchar with its seac form (the StandardEncoding
  components drawn in place), div, CFF2's vsindex and blend (deltas scaled
  at the location by the store's regions, or dropped at the default);
  fontTools' quirks are kept: a "return" or "endchar" does not stop the
  charstring, an unknown operator ends the charstring it is in, a subr
  index wraps as a Python list index does, and a path is closed when the
  next moveto or the end of the top-level charstring comes;
- an operator fontTools does not implement (and, or, not, store, abs,
  add, sub, load, neg, eq, drop, put, get, ifelse, random, mul, sqrt,
  dup, exch, index, roll) raises NotImplementedError, as fontTools does.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .cff_data import (
    EXPERT_CHARSET, EXPERT_SUBSET_CHARSET, STANDARD_ENCODING, STANDARD_STRINGS,
)
from .varstore import ItemVariationStore, StoreInstancer

_U16 = struct.Struct(">H").unpack_from
_U32 = struct.Struct(">I").unpack_from

_REAL_NIBBLES = ["0", "1", "2", "3", "4", "5", "6", "7", "8", "9", ".", "E", "E-",
                 None, "-"]

# Type 2 operators by opcode (an escaped one as (12, b1))
T2_OPERATORS = {
    1: "hstem", 3: "vstem", 4: "vmoveto", 5: "rlineto", 6: "hlineto", 7: "vlineto",
    8: "rrcurveto", 10: "callsubr", 11: "return", 14: "endchar", 15: "vsindex",
    16: "blend", 18: "hstemhm", 19: "hintmask", 20: "cntrmask", 21: "rmoveto",
    22: "hmoveto", 23: "vstemhm", 24: "rcurveline", 25: "rlinecurve",
    26: "vvcurveto", 27: "hhcurveto", 29: "callgsubr", 30: "vhcurveto",
    31: "hvcurveto", (12, 0): "ignore", (12, 3): "and", (12, 4): "or",
    (12, 5): "not", (12, 8): "store", (12, 9): "abs", (12, 10): "add",
    (12, 11): "sub", (12, 12): "div", (12, 13): "load", (12, 14): "neg",
    (12, 15): "eq", (12, 18): "drop", (12, 20): "put", (12, 21): "get",
    (12, 22): "ifelse", (12, 23): "random", (12, 24): "mul", (12, 26): "sqrt",
    (12, 27): "dup", (12, 28): "exch", (12, 29): "index", (12, 30): "roll",
    (12, 34): "hflex", (12, 35): "flex", (12, 36): "hflex1", (12, 37): "flex1",
}
_STANDARD_ENCODING = [STANDARD_ENCODING.get(code, ".notdef") for code in range(256)]
_UNIMPLEMENTED = frozenset((
    "and", "or", "not", "store", "abs", "add", "sub", "load", "neg", "eq", "drop",
    "put", "get", "ifelse", "random", "mul", "sqrt", "dup", "exch", "index", "roll"))

# DICT operators read here (the others are parsed and ignored)
_CHARSET, _CHARSTRINGS, _PRIVATE, _SUBRS = 15, 17, 18, 19
_DEFAULT_WIDTH, _NOMINAL_WIDTH, _VSINDEX, _BLEND, _VSTORE = 20, 21, 22, 23, 24
_CHARSTRING_TYPE, _ROS, _FDARRAY, _FDSELECT = (12, 6), (12, 30), (12, 36), (12, 37)
# Top DICT operators whose operands are string ids (ROS: its first two)
_SID_OPERATORS = (0, 1, 2, 3, 4, (12, 0), (12, 21), (12, 22), (12, 38), _ROS)


def subr_bias(n: int) -> int:
    """psCharStrings.calcSubrBias."""
    if n < 1240:
        return 107
    if n < 33900:
        return 1131
    return 32768


class Index:
    """A CFF INDEX read as cffLib's Index reads it: its count, offSize and
    offsets at construction (ValueError where they run past the table),
    each item when it is taken (ValueError where it does not lie within
    the table: cffLib asserts it reads an item's whole size)."""

    def __init__(self, data: bytes, pos: int, cff2: bool = False):
        self.data = data
        size = 4 if cff2 else 2
        if pos < 0 or pos + size > len(data):
            raise ValueError("malformed CFF INDEX: its count lies past the table")
        self.count = int.from_bytes(data[pos: pos + size], "big")
        pos += size
        self.offsets: List[int] = []
        if self.count == 0:
            self.end = pos
            return
        if pos >= len(data):
            raise ValueError("malformed CFF INDEX: its offSize lies past the table")
        off_size = data[pos]
        pos += 1
        if not 1 <= off_size <= 4:
            raise ValueError(f"CFF INDEX offSize {off_size}")
        if pos + off_size * (self.count + 1) > len(data):
            raise ValueError("malformed CFF INDEX: its offsets run past the table")
        self.offsets = [int.from_bytes(data[pos + off_size * i: pos + off_size * (i + 1)], "big")
                        for i in range(self.count + 1)]
        self.base = pos + off_size * (self.count + 1) - 1
        self.end = self.base + self.offsets[-1]

    def __len__(self) -> int:
        return self.count

    def __getitem__(self, i: int) -> bytes:
        if not 0 <= i < self.count:
            raise ValueError(f"CFF INDEX item {i} of {self.count}")
        start, stop = self.base + self.offsets[i], self.base + self.offsets[i + 1]
        if stop < start or stop > len(self.data):
            raise ValueError(f"malformed CFF INDEX: item {i} does not lie within the table")
        return self.data[start:stop]

    def __iter__(self):
        return (self[i] for i in range(self.count))


def read_index(data: bytes, pos: int, cff2: bool = False) -> Tuple[Index, int]:
    """An INDEX at `pos` (a 16-bit count, or CFF2's 32-bit one): (its items,
    taken lazily and checked, the position after it)."""
    index = Index(data, pos, cff2)
    return index, index.end


def read_dict(data: bytes) -> Dict[object, list]:
    """A DICT's {operator: operands}; the blend operator (23) leaves its
    operands to the next operator, which ignores them here."""
    out: Dict[object, list] = {}
    stack: list = []
    i, n = 0, len(data)
    while i < n:
        b0 = data[i]
        i += 1
        if b0 == 12:
            op = (12, data[i])
            i += 1
        elif b0 < 28 or b0 == 31:
            op = b0
        elif b0 == 28:
            stack.append(struct.unpack_from(">h", data, i)[0])
            i += 2
            continue
        elif b0 == 29:
            stack.append(struct.unpack_from(">l", data, i)[0])
            i += 4
            continue
        elif b0 == 30:
            number = ""
            while True:
                b = data[i]
                i += 1
                hi, lo = b >> 4, b & 0x0F
                if hi == 0xF:
                    break
                number += _REAL_NIBBLES[hi]
                if lo == 0xF:
                    break
                number += _REAL_NIBBLES[lo]
            stack.append(float(number))
            continue
        elif b0 <= 246:
            stack.append(b0 - 139)
            continue
        elif b0 <= 250:
            stack.append((b0 - 247) * 256 + data[i] + 108)
            i += 1
            continue
        elif b0 <= 254:
            stack.append(-(b0 - 251) * 256 - data[i] - 108)
            i += 1
            continue
        else:
            raise ValueError("reserved DICT operand byte 255")
        if op == _BLEND:
            continue
        out[op] = stack
        stack = []
    return out


class Private:
    """One Private DICT: local subrs and the width defaults (None in CFF2),
    and the default vsindex."""

    def __init__(self, data: bytes, size: int, off: int, cff2: bool):
        if off < 0 or size < 0 or off + size > len(data):
            raise ValueError("malformed CFF Private DICT: it does not lie within the table")
        d = read_dict(data[off : off + size])
        self.default_width = None if cff2 else d.get(_DEFAULT_WIDTH, [0])[0]
        self.nominal_width = None if cff2 else d.get(_NOMINAL_WIDTH, [0])[0]
        self.vsindex = d[_VSINDEX][0] if _VSINDEX in d else None
        self.subrs: Sequence[bytes] = []
        if _SUBRS in d:
            self.subrs = read_index(data, off + d[_SUBRS][0], cff2)[0]
        self.bias = subr_bias(len(self.subrs))


def _fd_select(data: bytes, pos: int, n_glyphs: int) -> List[Optional[int]]:
    """FDSelect formats 0, 3 and 4 as each glyph's font DICT index."""
    fmt = data[pos]
    if fmt == 0:
        return list(data[pos + 1 : pos + 1 + n_glyphs])
    if fmt not in (3, 4):
        raise NotImplementedError(f"FDSelect format {fmt}")
    gid_fmt, fd_fmt = (">I", ">H") if fmt == 4 else (">H", ">B")
    gid_size, fd_size = struct.calcsize(gid_fmt), struct.calcsize(fd_fmt)
    n_ranges = struct.unpack_from(gid_fmt, data, pos + 1)[0]
    at = pos + 1 + gid_size
    out: List[Optional[int]] = [None] * n_glyphs
    for _ in range(n_ranges):
        first = struct.unpack_from(gid_fmt, data, at)[0]
        fd = struct.unpack_from(fd_fmt, data, at + gid_size)[0]
        at += gid_size + fd_size
        end = struct.unpack_from(gid_fmt, data, at)[0]  # the next first, or the sentinel
        out[first:end] = [fd] * (end - first)
    return out


class CFFTable:
    """The first font of a 'CFF ' table, or a 'CFF2' table, read from the
    face's bytes at `off`. `axis_tags` (fvar order) reads CFF2's VarStore."""

    def __init__(self, data: bytes, off: int, length: int, cff2: bool,
                 axis_tags: Sequence[str] = ()):
        table = data[off : off + length]
        self.cff2 = cff2
        self.store: Optional[ItemVariationStore] = None
        if cff2:
            if len(table) < 5:
                raise ValueError("malformed 'CFF2' table: no header")
            major, _minor, hdr_size, top_len = struct.unpack_from(">BBBH", table, 0)
            if hdr_size + top_len > len(table):
                raise ValueError("malformed 'CFF2' table: its Top DICT runs past it")
            top = read_dict(table[hdr_size : hdr_size + top_len])
            self.global_subrs, _ = read_index(table, hdr_size + top_len, True)
            strings: List[str] = []
        else:
            if len(table) < 4:
                raise ValueError("malformed 'CFF ' table: no header")
            major, _minor, hdr_size, _off_size = struct.unpack_from(">BBBB", table, 0)
            names, pos = read_index(table, hdr_size)
            for name in names:  # cffLib decodes the font names as ASCII
                if not name.isascii():
                    raise ValueError("malformed 'CFF ' table: a font name that is not ASCII")
            tops, pos = read_index(table, pos)
            raw_strings, pos = read_index(table, pos)
            self.global_subrs, _ = read_index(table, pos)
            strings = [s.decode("latin1") for s in raw_strings]
            top = read_dict(tops[0])
            # cffLib resolves a DICT's string operands as it decompiles it,
            # popping them from the end of the operands (ROS: SID SID number)
            for op in _SID_OPERATORS:
                if op in top:
                    ops = top[op]
                    sids = ops[-3:-1] if op == _ROS else ops[-1:]
                    if len(sids) < (2 if op == _ROS else 1) or any(
                            isinstance(v, int) and v >= 391 + len(strings) for v in sids):
                        raise ValueError("malformed 'CFF ' Top DICT: a string id missing or "
                                         "past its strings")
        if top.get(_CHARSTRING_TYPE, [2])[0] != 2:
            raise NotImplementedError("CFF with Type 1 charstrings")
        self.global_bias = subr_bias(len(self.global_subrs))
        self.charstrings, _ = read_index(table, top[_CHARSTRINGS][0], cff2)
        n = len(self.charstrings)
        self.fd_select: Optional[List[Optional[int]]] = None
        if _FDARRAY in top:
            fds, _ = read_index(table, top[_FDARRAY][0], cff2)
            self.privates = []
            for fd in fds:
                size, p_off = read_dict(fd)[_PRIVATE]
                self.privates.append(Private(table, size, p_off, cff2))
            if _FDSELECT in top:
                self.fd_select = _fd_select(table, top[_FDSELECT][0], n)
        else:
            size, p_off = top[_PRIVATE]
            self.privates = [Private(table, size, p_off, cff2)]
        if _VSTORE in top:  # cffLib reads it with the CharStrings, in CFF too
            self.store = ItemVariationStore(table, top[_VSTORE][0] + 2, axis_tags,
                                            name=f"'{'CFF2' if cff2 else 'CFF '}' VarStore")
        self.glyph_names: Optional[List[str]] = None
        if not cff2:
            self.glyph_names = self._charset(table, top, strings, n, _ROS in top)

    @staticmethod
    def _charset(table: bytes, top, strings: List[str], n: int, is_cid: bool) -> List[str]:
        value = top.get(_CHARSET, [0])[0]

        def sid(s: int) -> str:
            if s < 391:
                return STANDARD_STRINGS[s]
            if s - 391 >= len(strings):
                raise ValueError(f"CFF charset names string {s} of {391 + len(strings)}")
            return strings[s - 391]

        def u16(at: int) -> int:
            if at + 2 > len(table):
                raise ValueError("malformed CFF charset: it runs past the table")
            return _U16(table, at)[0]

        if value > 2 or value < 0:
            if not 0 <= value < len(table):
                raise ValueError(f"CFF charset offset {value} outside the table")
            fmt = table[value]
            at = value + 1
            names = [".notdef"]
            if fmt == 0:
                for k in range(n - 1):
                    code = u16(at + 2 * k)
                    names.append("cid%05d" % code if is_cid else sid(code))
            elif fmt in (1, 2):
                while len(names) < n:
                    first = u16(at)
                    if at + 3 > len(table):
                        raise ValueError("malformed CFF charset: it runs past the table")
                    left = table[at + 2] if fmt == 1 else u16(at + 2)
                    at += 3 if fmt == 1 else 4
                    for code in range(first, first + left + 1):
                        names.append("cid%05d" % code if is_cid else sid(code))
            else:
                raise NotImplementedError(f"CFF charset format {fmt}")
            if len(names) != n:
                raise ValueError("CFF charset does not name every glyph")
            seen: Dict[str, int] = {}
            everything = set(names)
            for i, name in enumerate(names):
                if name in seen:
                    k = seen[name]
                    taken = set(seen) | everything
                    while f"{name}.{k}" in taken:
                        k += 1
                    seen[name] = k + 1
                    name = f"{name}.{k}"
                    names[i] = name
                seen[name] = 1
            return names
        if is_cid:
            raise ValueError("a CID-keyed CFF without a charset")
        names = {0: STANDARD_STRINGS[:229], 1: EXPERT_CHARSET,
                 2: EXPERT_SUBSET_CHARSET}[value][:n]
        if len(names) != n:
            raise NotImplementedError(
                f"{n} glyphs under the {len(names)}-name predefined charset {value}")
        return list(names)

    def private_of(self, gid: int) -> Private:
        if self.fd_select is not None:
            return self.privates[self.fd_select[gid]]
        return self.privates[0]

    def num_regions(self, private: Private, vsindex: Optional[int] = None) -> int:
        """cffLib PrivateDict.getNumRegions: VarData[vsindex]'s region
        count, vsindex defaulting to the Private DICT's, then 0."""
        if self.store is None:
            raise ValueError("blend or vsindex in a charstring of a face without a VarStore")
        if vsindex is None:
            vsindex = private.vsindex if private.vsindex is not None else 0
        return self.store.num_regions(vsindex)

    def draw(self, gid: int, out: list, instancer: Optional[StoreInstancer] = None,
             glyph_lookup: Optional[Callable[[str], int]] = None, transform=None) -> None:
        """Record glyph `gid`'s outline onto `out` (the value list of a
        DecomposingRecordingPen): blends at `instancer`'s location, or
        drops them (the default instance) without one. `glyph_lookup` maps
        a seac component's name to its glyph id."""
        _Extractor(self, self.private_of(gid), out, instancer, glyph_lookup,
                   transform).run(self.charstrings[gid])


def _apply(transform, pt):
    if transform is None:
        return pt
    xx, xy, yx, yy, dx, dy = transform
    x, y = pt
    return (xx * x + yx * y + dx, xy * x + yy * y + dy)


class _Extractor:
    """T2OutlineExtractor onto a recording list (points through `transform`,
    as fontTools' TransformPen draws a seac accent)."""

    def __init__(self, table: CFFTable, private: Private, out: list, instancer,
                 glyph_lookup, transform):
        self.table = table
        self.private = private
        self.out = out
        self.instancer = instancer
        self.glyph_lookup = glyph_lookup
        self.transform = transform
        self.stack: list = []
        self.hint_count = 0
        self.hint_mask_bytes = 0
        self.num_regions = 0
        self.vs_index = 0
        self.got_width = False
        self.width = 0
        self.current = (0, 0)
        self.saw_move = False
        self.level = 0

    # --- the pen ---------------------------------------------------------------

    def _point(self, d):
        if len(d) < 2:
            raise ValueError("a CFF charstring path operator with too few operands")
        x, y = self.current
        p = x + d[0], y + d[1]
        self.current = p
        return _apply(self.transform, p)

    def _move(self, d):
        self.out.append(("moveTo", (self._point(d),)))
        self.saw_move = True

    def _line(self, d):
        if not self.saw_move:
            self._move((0, 0))
        self.out.append(("lineTo", (self._point(d),)))

    def _curve(self, d1, d2, d3):
        if not self.saw_move:
            self._move((0, 0))
        p = self._point
        self.out.append(("curveTo", (p(d1), p(d2), p(d3))))

    def _end_path(self):
        if self.saw_move:
            self.out.append(("closePath", ()))
        self.saw_move = False

    # --- the operand stack -------------------------------------------------------

    def _popall(self):
        args, self.stack = self.stack, []
        return args

    def _popall_width(self, even_odd: int = 0):
        args = self._popall()
        if not self.got_width:
            if even_odd ^ (len(args) % 2):
                if self.private.default_width is None:
                    raise ValueError("CFF2 CharStrings must not have an initial width value")
                self.width = self.private.nominal_width + args[0]
                args = args[1:]
            else:
                self.width = self.private.default_width
            self.got_width = True
        return args

    def _count_hints(self):
        self.hint_count += len(self._popall_width()) // 2

    # --- the interpreter ----------------------------------------------------------

    def run(self, charstring: bytes) -> None:
        self.level += 1
        self._execute(charstring)
        self.level -= 1
        if self.level == 0:
            self._end_path()

    def _execute(self, code: bytes) -> None:
        i, n = 0, len(code)
        while i < n:
            b0 = code[i]
            i += 1
            need = (0 if 32 <= b0 <= 246 else 4 if b0 == 255 else 2 if b0 == 28
                    else 1 if b0 >= 247 or b0 == 12 else 0)
            if i + need > n:
                raise ValueError("a CFF charstring operand runs past its end")
            if b0 >= 32:
                if b0 <= 246:
                    self.stack.append(b0 - 139)
                elif b0 <= 250:
                    self.stack.append((b0 - 247) * 256 + code[i] + 108)
                    i += 1
                elif b0 <= 254:
                    self.stack.append(-(b0 - 251) * 256 - code[i] - 108)
                    i += 1
                else:
                    self.stack.append(struct.unpack_from(">l", code, i)[0] / 65536)
                    i += 4
                continue
            if b0 == 28:
                self.stack.append(struct.unpack_from(">h", code, i)[0])
                i += 2
                continue
            if b0 == 12:
                op = T2_OPERATORS.get((12, code[i]))
                i += 1
            else:
                op = T2_OPERATORS.get(b0)
            if op is None:
                return  # fontTools reads no token past an unknown operator
            if op in ("hintmask", "cntrmask"):
                if not self.hint_mask_bytes:
                    self._count_hints()
                    self.hint_mask_bytes = (self.hint_count + 7) // 8
                if i + self.hint_mask_bytes > n:
                    raise ValueError("a hint mask runs past its charstring")
                i += self.hint_mask_bytes
                continue
            if op in ("callsubr", "callgsubr"):
                index = self._pop()
                subrs, bias = ((self.private.subrs, self.private.bias) if op == "callsubr"
                               else (self.table.global_subrs, self.table.global_bias))
                if not 0 <= index + bias < len(subrs):
                    raise ValueError(f"a CFF charstring calls subr {index + bias} of "
                                     f"{len(subrs)}")
                self.run(subrs[index + bias])
                continue
            if op in _UNIMPLEMENTED:
                raise NotImplementedError(f"the Type 2 operator {op}")
            getattr(self, "op_" + op)()

    def _pop(self):
        if not self.stack:
            raise ValueError("a CFF charstring operator with too few operands")
        return self.stack.pop()

    # --- hints and control ------------------------------------------------------

    def op_hstem(self):
        self._count_hints()

    op_vstem = op_hstemhm = op_vstemhm = op_hstem

    def op_return(self):
        pass

    def op_ignore(self):
        pass

    def op_div(self):
        num2 = self._pop()
        num1 = self._pop()
        d1 = num1 // num2
        d2 = num1 / num2
        self.stack.append(d1 if d1 == d2 else d2)

    def op_vsindex(self):
        vi = self._pop()
        self.vs_index = vi
        self.num_regions = self.table.num_regions(self.private, vi)

    def op_blend(self):
        if self.num_regions == 0:
            self.num_regions = self.table.num_regions(self.private)
        n_blends = self._pop()
        n_ops = n_blends * (self.num_regions + 1)
        stack = self.stack
        if self.instancer is None:
            del stack[-(n_ops - n_blends):]
        else:
            argi = len(stack) - n_ops
            end_args = tuplei = argi + n_blends
            while argi < end_args:
                next_ti = tuplei + self.num_regions
                stack[argi] += self.instancer.interpolate(self.vs_index,
                                                          stack[tuplei:next_ti])
                tuplei = next_ti
                argi += 1
            stack[end_args:] = []

    # --- moveto and endchar -----------------------------------------------------

    def op_rmoveto(self):
        self._end_path()
        self._move(self._popall_width())

    def op_hmoveto(self):
        self._end_path()
        self._move((self._first(self._popall_width(1)), 0))

    def op_vmoveto(self):
        self._end_path()
        self._move((0, self._first(self._popall_width(1))))

    @staticmethod
    def _first(args):
        if not args:
            raise ValueError("a CFF charstring moveto with no operand")
        return args[0]

    def op_endchar(self):
        self._end_path()
        args = self._popall_width()
        if args:
            adx, ady, bchar, achar = args
            if not (0 <= bchar < 256 and 0 <= achar < 256):
                raise ValueError("a CFF seac component code outside StandardEncoding")
            self._component(_STANDARD_ENCODING[bchar], (1, 0, 0, 1, 0, 0))
            self._component(_STANDARD_ENCODING[achar], (1, 0, 0, 1, adx, ady))

    def _component(self, name: str, transform) -> None:
        """DecomposingRecordingPen.addComponent: the named glyph drawn in
        place through the transform (composed with this extractor's)."""
        gid = self.glyph_lookup(name) if self.glyph_lookup is not None else None
        if gid is None:
            raise ValueError(f"seac component {name!r} is not in the face")
        if self.transform is not None:
            transform = _compose(self.transform, transform)
        if tuple(transform) == (1, 0, 0, 1, 0, 0):
            transform = None
        self.table.draw(gid, self.out, self.instancer, self.glyph_lookup, transform)

    # --- lines and curves ---------------------------------------------------------

    def op_rlineto(self):
        args = self._popall()
        for i in range(0, len(args), 2):
            self._line(args[i : i + 2])

    def op_hlineto(self):
        self._alternating(True)

    def op_vlineto(self):
        self._alternating(False)

    def _alternating(self, horizontal: bool):
        for arg in self._popall():
            self._line((arg, 0) if horizontal else (0, arg))
            horizontal = not horizontal

    def op_rrcurveto(self):
        args = self._popall()
        for i in range(0, len(args), 6):
            dxa, dya, dxb, dyb, dxc, dyc = args[i : i + 6]
            self._curve((dxa, dya), (dxb, dyb), (dxc, dyc))

    def op_rcurveline(self):
        args = self._popall()
        for i in range(0, len(args) - 2, 6):
            dxb, dyb, dxc, dyc, dxd, dyd = args[i : i + 6]
            self._curve((dxb, dyb), (dxc, dyc), (dxd, dyd))
        self._line(args[-2:])

    def op_rlinecurve(self):
        args = self._popall()
        line_args = args[:-6]
        for i in range(0, len(line_args), 2):
            self._line(line_args[i : i + 2])
        dxb, dyb, dxc, dyc, dxd, dyd = args[-6:]
        self._curve((dxb, dyb), (dxc, dyc), (dxd, dyd))

    def op_vvcurveto(self):
        args = self._popall()
        if len(args) % 2:
            dx1, args = args[0], args[1:]
        else:
            dx1 = 0
        for i in range(0, len(args), 4):
            dya, dxb, dyb, dyc = args[i : i + 4]
            self._curve((dx1, dya), (dxb, dyb), (0, dyc))
            dx1 = 0

    def op_hhcurveto(self):
        args = self._popall()
        if len(args) % 2:
            dy1, args = args[0], args[1:]
        else:
            dy1 = 0
        for i in range(0, len(args), 4):
            dxa, dxb, dyb, dxc = args[i : i + 4]
            self._curve((dxa, dy1), (dxb, dyb), (dxc, 0))
            dy1 = 0

    def op_vhcurveto(self):
        args = self._popall()
        while args:
            args = self._vcurve(args)
            if args:
                args = self._hcurve(args)

    def op_hvcurveto(self):
        args = self._popall()
        while args:
            args = self._hcurve(args)
            if args:
                args = self._vcurve(args)

    def _vcurve(self, args):
        dya, dxb, dyb, dxc = args[:4]
        args = args[4:]
        if len(args) == 1:
            dyc, args = args[0], []
        else:
            dyc = 0
        self._curve((0, dya), (dxb, dyb), (dxc, dyc))
        return args

    def _hcurve(self, args):
        dxa, dxb, dyb, dyc = args[:4]
        args = args[4:]
        if len(args) == 1:
            dxc, args = args[0], []
        else:
            dxc = 0
        self._curve((dxa, 0), (dxb, dyb), (dxc, dyc))
        return args

    # --- flex ---------------------------------------------------------------------

    def op_hflex(self):
        dx1, dx2, dy2, dx3, dx4, dx5, dx6 = self._popall()
        dy1 = dy3 = dy4 = dy6 = 0
        dy5 = -dy2
        self._curve((dx1, dy1), (dx2, dy2), (dx3, dy3))
        self._curve((dx4, dy4), (dx5, dy5), (dx6, dy6))

    def op_flex(self):
        dx1, dy1, dx2, dy2, dx3, dy3, dx4, dy4, dx5, dy5, dx6, dy6, _fd = self._popall()
        self._curve((dx1, dy1), (dx2, dy2), (dx3, dy3))
        self._curve((dx4, dy4), (dx5, dy5), (dx6, dy6))

    def op_hflex1(self):
        dx1, dy1, dx2, dy2, dx3, dx4, dx5, dy5, dx6 = self._popall()
        dy3 = dy4 = 0
        dy6 = -(dy1 + dy2 + dy3 + dy4 + dy5)
        self._curve((dx1, dy1), (dx2, dy2), (dx3, dy3))
        self._curve((dx4, dy4), (dx5, dy5), (dx6, dy6))

    def op_flex1(self):
        dx1, dy1, dx2, dy2, dx3, dy3, dx4, dy4, dx5, dy5, d6 = self._popall()
        dx = dx1 + dx2 + dx3 + dx4 + dx5
        dy = dy1 + dy2 + dy3 + dy4 + dy5
        if abs(dx) > abs(dy):
            dx6, dy6 = d6, -dy
        else:
            dx6, dy6 = -dx, d6
        self._curve((dx1, dy1), (dx2, dy2), (dx3, dy3))
        self._curve((dx4, dy4), (dx5, dy5), (dx6, dy6))


def _compose(outer, inner):
    """fontTools' Transform(outer).transform(inner): inner applied first."""
    xx1, xy1, yx1, yy1, dx1, dy1 = inner
    xx2, xy2, yx2, yy2, dx2, dy2 = outer
    return (xx1 * xx2 + xy1 * yx2, xx1 * xy2 + xy1 * yy2,
            yx1 * xx2 + yy1 * yx2, yx1 * xy2 + yy1 * yy2,
            xx2 * dx1 + yx2 * dy1 + dx2, xy2 * dx1 + yy2 * dy1 + dy2)
