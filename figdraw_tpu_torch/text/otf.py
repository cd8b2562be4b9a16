"""The port's OpenType reader: the parts of an sfnt font the text pipeline
reads, in numpy and struct, with no fontTools.

It stands in for fontTools' TTFont where figdraw_tpu's typefaces.py,
typeface_info.py and shaper.py use it, and gives the same values:

- the sfnt and TTC headers; head, hhea, maxp, name, post glyph names
  (format 2 names, duplicates renamed "name.1" as fontTools does; other
  formats, or no post table, get synthesized unique names: the shaper only
  needs names to be unique and stable);
- cmap, the subtable fontTools' getBestCmap picks, formats 0, 4, 6 and 12;
- hmtx, the last advance repeating past numberOfHMetrics;
- the legacy kern table, format 0, as {(left name, right name): value};
- glyf/loca, simple and composite glyphs, parsed per glyph on first use:
  glyph_path gives the value list of fontTools' DecomposingRecordingPen
  (implied on-curve points left implicit, contours that start off-curve
  rotated to end on-curve, all-off-curve contours ending in None,
  components decomposed through their 2x2 transform and offsets);
- GDEF, GSUB (types 1-8) and GPOS (types 1-9), extensions included,
  decoded per lookup into SimpleNamespace objects under fontTools'
  attribute names (Coverage.glyphs in coverage-index order,
  ClassDef.classDefs as a dict without class 0, Value1/Value2 None for an
  empty value format), so the shaper reads them as it reads fontTools';
- fvar axes, as metadata.

A CFF or CFF2 face and a variable face drawn away from its default
location raise NotImplementedError with the ROADMAP item that holds them.
"""

from __future__ import annotations

import struct
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np

CFF_NOT_PORTED = (
    "CFF and CFF2 outlines (an 'OTTO' face) are not read by the port's "
    "OpenType reader (ROADMAP.md, port item 'Text host pipeline': CFF/CFF2)")
VARIATIONS_NOT_PORTED = (
    "a variation location away from the default needs gvar/HVAR/avar "
    "instancing, which the port's OpenType reader does not do (ROADMAP.md, "
    "port item 'Text host pipeline': variable-font instancing)")

_U16 = struct.Struct(">H").unpack_from
_I16 = struct.Struct(">h").unpack_from
_U32 = struct.Struct(">I").unpack_from

# the Macintosh standard glyph order of post formats 1 and 2
STANDARD_GLYPH_ORDER = [
    ".notdef", ".null", "nonmarkingreturn", "space", "exclam", "quotedbl",
    "numbersign", "dollar", "percent", "ampersand", "quotesingle",
    "parenleft", "parenright", "asterisk", "plus", "comma", "hyphen",
    "period", "slash", "zero", "one", "two", "three", "four", "five", "six",
    "seven", "eight", "nine", "colon", "semicolon", "less", "equal",
    "greater", "question", "at", "A", "B", "C", "D", "E", "F", "G", "H",
    "I", "J", "K", "L", "M", "N", "O", "P", "Q", "R", "S", "T", "U", "V",
    "W", "X", "Y", "Z", "bracketleft", "backslash", "bracketright",
    "asciicircum", "underscore", "grave", "a", "b", "c", "d", "e", "f", "g",
    "h", "i", "j", "k", "l", "m", "n", "o", "p", "q", "r", "s", "t", "u",
    "v", "w", "x", "y", "z", "braceleft", "bar", "braceright", "asciitilde",
    "Adieresis", "Aring", "Ccedilla", "Eacute", "Ntilde", "Odieresis",
    "Udieresis", "aacute", "agrave", "acircumflex", "adieresis", "atilde",
    "aring", "ccedilla", "eacute", "egrave", "ecircumflex", "edieresis",
    "iacute", "igrave", "icircumflex", "idieresis", "ntilde", "oacute",
    "ograve", "ocircumflex", "odieresis", "otilde", "uacute", "ugrave",
    "ucircumflex", "udieresis", "dagger", "degree", "cent", "sterling",
    "section", "bullet", "paragraph", "germandbls", "registered",
    "copyright", "trademark", "acute", "dieresis", "notequal", "AE",
    "Oslash", "infinity", "plusminus", "lessequal", "greaterequal", "yen",
    "mu", "partialdiff", "summation", "product", "pi", "integral",
    "ordfeminine", "ordmasculine", "Omega", "ae", "oslash", "questiondown",
    "exclamdown", "logicalnot", "radical", "florin", "approxequal", "Delta",
    "guillemotleft", "guillemotright", "ellipsis", "nonbreakingspace",
    "Agrave", "Atilde", "Otilde", "OE", "oe", "endash", "emdash",
    "quotedblleft", "quotedblright", "quoteleft", "quoteright", "divide",
    "lozenge", "ydieresis", "Ydieresis", "fraction", "currency",
    "guilsinglleft", "guilsinglright", "fi", "fl", "daggerdbl",
    "periodcentered", "quotesinglbase", "quotedblbase", "perthousand",
    "Acircumflex", "Ecircumflex", "Aacute", "Edieresis", "Egrave", "Iacute",
    "Icircumflex", "Idieresis", "Igrave", "Oacute", "Ocircumflex", "apple",
    "Ograve", "Uacute", "Ucircumflex", "Ugrave", "dotlessi", "circumflex",
    "tilde", "macron", "breve", "dotaccent", "ring", "cedilla",
    "hungarumlaut", "ogonek", "caron", "Lslash", "lslash", "Scaron",
    "scaron", "Zcaron", "zcaron", "brokenbar", "Eth", "eth", "Yacute",
    "yacute", "Thorn", "thorn", "minus", "multiply", "onesuperior",
    "twosuperior", "threesuperior", "onehalf", "onequarter",
    "threequarters", "franc", "Gbreve", "gbreve", "Idotaccent", "Scedilla",
    "scedilla", "Cacute", "cacute", "Ccaron", "ccaron", "dcroat",
]

# getBestCmap's (platform, encoding) preference order
CMAP_PREFERENCES = ((3, 10), (0, 6), (0, 4), (3, 1), (0, 3), (0, 2), (0, 1),
                    (0, 0))

# name-record codecs by (platform, encoding), fontTools' getEncoding table
# without its per-language Macintosh variants
_NAME_ENCODINGS = {
    1: {0: "mac_roman", 6: "mac_greek", 7: "mac_cyrillic", 29: "mac_latin2",
        35: "mac_turkish", 37: "mac_iceland"},
    2: {0: "ascii", 1: "utf_16_be", 2: "latin1"},
    3: {0: "utf_16_be", 1: "utf_16_be", 2: "shift_jis", 3: "gb2312",
        4: "big5", 5: "euc_kr", 6: "johab", 10: "utf_16_be"},
}

# glyf flags (the simple-glyph point flags and the component flags)
_ON_CURVE, _X_SHORT, _Y_SHORT, _REPEAT, _X_SAME, _Y_SAME = 1, 2, 4, 8, 16, 32
_CUBIC = 0x80
_ARG_WORDS, _ARGS_XY, _HAVE_SCALE = 0x1, 0x2, 0x8
_MORE_COMPONENTS, _HAVE_XY_SCALE, _HAVE_2X2 = 0x20, 0x40, 0x80
_IDENTITY = (1, 0, 0, 1, 0, 0)


def _f2dot14(v: int) -> float:
    return v / 16384.0


def collection_size(data: bytes) -> int:
    """The number of faces in a font file's bytes: a TTC/OTC header's
    count, else 1."""
    return _U32(data, 8)[0] if data[:4] == b"ttcf" else 1


class NameRecord(SimpleNamespace):
    """One name-table record (nameID, platformID, platEncID, langID and its
    raw bytes); toUnicode decodes it like fontTools' NameRecord."""

    def toUnicode(self) -> str:  # noqa: N802 - fontTools' name
        enc = (_NAME_ENCODINGS.get(self.platformID, {}).get(self.platEncID)
               if self.platformID != 0 else "utf_16_be")
        if enc is None:
            raise UnicodeDecodeError("unknown", self.string, 0, 1,
                                     "no codec for this platform/encoding")
        return self.string.decode(enc)


class OTFont:
    """One face of a TrueType-outline sfnt (.ttf, .otf with glyf, or one
    face of a .ttc/.otc collection), read from its bytes.

    The tables the pipeline needs are read at construction (they are
    small); cmap, kern, name, GSUB, GPOS and GDEF on first use; glyf per
    glyph."""

    def __init__(self, data: bytes, face_index: int = 0):
        self.data = data = bytes(data)
        base = 0
        if data[:4] == b"ttcf":
            n_fonts = _U32(data, 8)[0]
            if not 0 <= face_index < n_fonts:
                raise IndexError(f"face {face_index} of a {n_fonts}-face collection")
            base = _U32(data, 12 + 4 * face_index)[0]
        if data[base : base + 4] == b"OTTO":
            raise NotImplementedError(CFF_NOT_PORTED)
        num_tables = _U16(data, base + 4)[0]
        self.tables: Dict[str, Tuple[int, int]] = {}
        for i in range(num_tables):
            rec = base + 12 + 16 * i
            tag = data[rec : rec + 4].decode("latin1")
            _checksum, offset, length = struct.unpack_from(">III", data, rec + 4)
            self.tables[tag] = (offset, length)
        if "CFF " in self.tables or "CFF2" in self.tables:
            raise NotImplementedError(CFF_NOT_PORTED)
        for tag in ("head", "hhea", "maxp", "hmtx"):
            if tag not in self.tables:
                raise ValueError(f"not a TrueType face: no '{tag}' table")

        head = self.tables["head"][0]
        self.units_per_em = _U16(data, head + 18)[0]
        self.index_to_loc_format = _I16(data, head + 50)[0]
        hhea = self.tables["hhea"][0]
        self.ascent, self.descent, self.line_gap = struct.unpack_from(">hhh", data, hhea + 4)
        n_hmetrics = _U16(data, hhea + 34)[0]
        self.num_glyphs = _U16(data, self.tables["maxp"][0] + 4)[0]

        # advances and left side bearings; the last advance repeats
        hmtx = self.tables["hmtx"][0]
        n = self.num_glyphs
        n_h = min(n_hmetrics, n)
        metrics = np.frombuffer(data, dtype=">i2", count=2 * n_h, offset=hmtx).reshape(n_h, 2)
        self.advances = np.empty(n, np.int64)
        self.lsbs = np.empty(n, np.int64)
        self.advances[:n_h] = metrics[:, 0].view(">u2")
        self.lsbs[:n_h] = metrics[:, 1]
        if n > n_h:
            self.advances[n_h:] = self.advances[n_h - 1] if n_h else 0
            self.lsbs[n_h:] = np.frombuffer(data, dtype=">i2", count=n - n_h,
                                            offset=hmtx + 4 * n_h)

        self.glyph_order: List[str] = self._read_glyph_order()
        self._name_to_gid = {nm: i for i, nm in enumerate(self.glyph_order)}

        self._loca = None
        if "glyf" in self.tables and "loca" in self.tables:
            loca = self.tables["loca"][0]
            if self.index_to_loc_format == 0:
                self._loca = np.frombuffer(data, dtype=">u2", count=n + 1,
                                           offset=loca).astype(np.int64) * 2
            else:
                self._loca = np.frombuffer(data, dtype=">u4", count=n + 1,
                                           offset=loca).astype(np.int64)
        self._glyphs: Dict[int, tuple] = {}
        self._cmap: Optional[Dict[int, str]] = None
        self._kern: Optional[Dict[Tuple[str, str], int]] = None
        self._names: Optional[List[NameRecord]] = None
        self._layout: Dict[str, object] = {}

    def __contains__(self, tag: str) -> bool:
        return tag in self.tables

    def get(self, tag: str, default=None):
        """SimpleNamespace(table=...) for GSUB, GPOS or GDEF (decoded on
        first use), else `default` (TTFont.get for those tables)."""
        if tag not in ("GSUB", "GPOS", "GDEF") or tag not in self.tables:
            return default
        found = self._layout.get(tag)
        if found is None:
            reader = _LayoutReader(self, self.tables[tag][0])
            table = reader.gdef() if tag == "GDEF" else reader.gsub_gpos(tag == "GSUB")
            found = self._layout[tag] = SimpleNamespace(table=table)
        return found

    # --- glyph names -----------------------------------------------------------

    def glyph_name(self, gid: int) -> str:
        if 0 <= gid < len(self.glyph_order):
            return self.glyph_order[gid]
        return "glyph%.5d" % gid

    def _read_glyph_order(self) -> List[str]:
        n = self.num_glyphs
        names = None
        if "post" in self.tables:
            post = self.tables["post"][0]
            fmt = _U32(self.data, post)[0]
            if fmt == 0x00010000 and n <= len(STANDARD_GLYPH_ORDER):
                names = STANDARD_GLYPH_ORDER[:n]
            elif fmt == 0x00020000:
                names = self._post_format2(post + 32)
        if names is None:
            # no names to read (post format 3, or none): unique, stable ones
            return [".notdef"] + ["glyph%.5d" % i for i in range(1, n)]
        return names

    def _post_format2(self, pos: int) -> List[str]:
        """post format 2 names, as fontTools' decode_format_2_0 and
        build_psNameMapping give them: empty names become "glyph%05d", and
        a repeated name takes the first free ".N" suffix."""
        data = self.data
        n = self.num_glyphs
        count = min(_U16(data, pos)[0], n)
        indices = struct.unpack_from(">%dH" % count, data, pos + 2)
        pos += 2 + 2 * count
        end = self.tables["post"][0] + self.tables["post"][1]
        extra = []
        for _ in range(max(indices, default=0) - 257):
            length = data[pos] if pos < end else 0
            pos += 1
            extra.append("" if end <= pos + length - 1
                         else data[pos : pos + length].decode("latin1"))
            pos += length
        order = [""] * n
        for gid, index in enumerate(indices):
            if index > 257:
                order[gid] = extra[index - 258] if index - 258 < len(extra) else ""
            else:
                order[gid] = STANDARD_GLYPH_ORDER[index]
        in_order = set(order)
        seen: Dict[str, int] = {}
        for gid in range(n):
            name = order[gid]
            if name == "":
                name = "glyph%.5d" % gid
            if name in seen:
                k = seen[name]
                while f"{name}.{k}" in in_order:
                    k += 1
                seen[name] = k + 1
                name = f"{name}.{k}"
            seen[name] = 1
            order[gid] = name
        return order

    # --- cmap ------------------------------------------------------------------

    def getBestCmap(self) -> Optional[Dict[int, str]]:  # noqa: N802 - fontTools' name
        """{codepoint: glyph name} of the first subtable in CMAP_PREFERENCES
        order (gid 0 left out), or None without a Unicode subtable."""
        if self._cmap is None:
            self._cmap = self._read_cmap()
        return self._cmap if self._cmap is not False else None

    def _read_cmap(self):
        if "cmap" not in self.tables:
            return False
        data = self.data
        cmap = self.tables["cmap"][0]
        n_sub = _U16(data, cmap + 2)[0]
        subtables = {}
        for i in range(n_sub):
            pid, eid, off = struct.unpack_from(">HHI", data, cmap + 4 + 8 * i)
            subtables.setdefault((pid, eid), cmap + off)
        for key in CMAP_PREFERENCES:
            if key in subtables:
                chars, gids = self._cmap_subtable(subtables[key])
                names = self.glyph_name
                return {c: names(g) for c, g in zip(chars, gids) if g != 0}
        return False

    def _cmap_subtable(self, off: int):
        data = self.data
        fmt = _U16(data, off)[0]
        if fmt == 0:
            return list(range(256)), list(data[off + 6 : off + 262])
        if fmt == 4:
            seg2 = _U16(data, off + 6)[0]
            seg = seg2 // 2
            words = np.frombuffer(data, dtype=">u2", count=(_U16(data, off + 2)[0] - 14) // 2,
                                  offset=off + 14).astype(np.int64)
            end_code = words[:seg]
            start_code = words[seg + 1 : 2 * seg + 1]
            id_delta = words[2 * seg + 1 : 3 * seg + 1]
            range_off = words[3 * seg + 1 : 4 * seg + 1]
            gia = words[4 * seg + 1 :]
            chars, gids = [], []
            for i in range(seg - 1):  # the last segment (0xFFFF) is skipped
                codes = np.arange(start_code[i], end_code[i] + 1, dtype=np.int64)
                if codes.size == 0:
                    continue
                if range_off[i] == 0:
                    g = (codes + id_delta[i]) & 0xFFFF
                else:
                    idx = codes + (range_off[i] // 2 - start_code[i] + i - seg)
                    raw = gia[idx]
                    g = np.where(raw != 0, (raw + id_delta[i]) & 0xFFFF, 0)
                chars.extend(codes.tolist())
                gids.extend(g.tolist())
            return chars, gids
        if fmt == 6:
            first, count = struct.unpack_from(">HH", data, off + 6)
            gids = list(struct.unpack_from(">%dH" % count, data, off + 10))
            return list(range(first, first + count)), gids
        if fmt == 12:
            n_groups = _U32(data, off + 12)[0]
            chars, gids = [], []
            for k in range(n_groups):
                start, end, gid = struct.unpack_from(">III", data, off + 16 + 12 * k)
                chars.extend(range(start, end + 1))
                gids.extend(range(gid, gid + end - start + 1))
            return chars, gids
        raise NotImplementedError(
            f"cmap subtable format {fmt} is not read by the port's OpenType "
            "reader (formats 0, 4, 6 and 12 are)")

    # --- metrics and kerning ----------------------------------------------------

    def advance(self, gid: int) -> int:
        return int(self.advances[gid])

    def kern_pairs(self) -> Dict[Tuple[str, str], int]:
        """The legacy kern table's format 0 pairs, merged over its
        subtables in order: {(left name, right name): value}."""
        if self._kern is None:
            self._kern = self._read_kern()
        return self._kern

    def _read_kern(self) -> Dict[Tuple[str, str], int]:
        table: Dict[Tuple[str, str], int] = {}
        if "kern" not in self.tables:
            return table
        data = self.data
        pos, length = self.tables["kern"]
        version, n_tables = struct.unpack_from(">HH", data, pos)
        apple = length >= 8 and version == 1
        if apple:
            n_tables = _U32(data, pos + 4)[0]
            pos += 8
        else:
            pos += 4
        names = self.glyph_name
        for _ in range(n_tables):
            if apple:
                sub_len, _coverage, fmt, _tuple = struct.unpack_from(">IBBH", data, pos)
                head = 8
            else:
                _v, sub_len, fmt, _coverage = struct.unpack_from(">HHBB", data, pos)
                head = 6
                if n_tables == 1 and fmt == 0:
                    sub_len = _U16(data, pos + 6)[0] * 6 + 14
            if fmt == 0:
                n_pairs = _U16(data, pos + head)[0]
                rows = np.frombuffer(data, dtype=">u2", count=3 * n_pairs,
                                     offset=pos + head + 8).reshape(n_pairs, 3)
                values = rows[:, 2].astype(np.int64)
                values = np.where(values >= 32768, values - 65536, values)
                for left, right, value in zip(rows[:, 0].tolist(), rows[:, 1].tolist(),
                                              values.tolist()):
                    table[(names(left), names(right))] = value
            pos += sub_len
        return table

    # --- name and fvar ------------------------------------------------------------

    def name_records(self) -> List[NameRecord]:
        if self._names is None:
            self._names = []
            if "name" in self.tables:
                data = self.data
                pos = self.tables["name"][0]
                _fmt, count, str_off = struct.unpack_from(">HHH", data, pos)
                for i in range(count):
                    pid, eid, lid, nid, length, off = struct.unpack_from(
                        ">6H", data, pos + 6 + 12 * i)
                    start = pos + str_off + off
                    self._names.append(NameRecord(
                        platformID=pid, platEncID=eid, langID=lid, nameID=nid,
                        string=data[start : start + length]))
        return self._names

    def debug_name(self, name_id: int) -> Optional[str]:
        """The English record of name_id, else any decodable one
        (fontTools' getDebugName)."""
        english = some = None
        for rec in self.name_records():
            if rec.nameID != name_id:
                continue
            try:
                text = rec.toUnicode()
            except UnicodeDecodeError:
                continue
            some = text
            if (rec.platformID, rec.langID) in ((1, 0), (3, 0x409)):
                english = text
                break
        return english or some or None

    def fvar_axes(self) -> List[SimpleNamespace]:
        """fvar's axes: axisTag, minValue, defaultValue, maxValue, flags,
        axisNameID; empty for a face without fvar."""
        if "fvar" not in self.tables:
            return []
        data = self.data
        pos = self.tables["fvar"][0]
        axes_off, _res, count, size = struct.unpack_from(">HHHH", data, pos + 4)
        axes = []
        for i in range(count):
            at = pos + axes_off + size * i
            tag = data[at : at + 4].decode("latin1")
            lo, default, hi = struct.unpack_from(">iii", data, at + 4)
            flags, name_id = struct.unpack_from(">HH", data, at + 16)
            axes.append(SimpleNamespace(axisTag=tag, minValue=lo / 65536.0,
                                        defaultValue=default / 65536.0,
                                        maxValue=hi / 65536.0, flags=flags,
                                        axisNameID=name_id))
        return axes

    def is_default_location(self, location: Dict[str, float]) -> bool:
        """Whether a {tag: value} location draws the default instance: every
        axis of fvar is at its default (tags of no axis are ignored, as
        fontTools' normalizeLocation ignores them)."""
        for axis in self.fvar_axes():
            if float(location.get(axis.axisTag, axis.defaultValue)) != axis.defaultValue:
                return False
        return True

    # --- outlines ------------------------------------------------------------------

    def _glyph(self, gid: int) -> tuple:
        """The parsed glyf entry: ("empty",), ("simple", xs, ys, end_pts,
        flags, x_min) or ("composite", [(component gid, transform)])."""
        g = self._glyphs.get(gid)
        if g is not None:
            return g
        if self._loca is None:
            raise NotImplementedError("a face without glyf/loca outlines is not "
                                      "drawn by the port's OpenType reader")
        data = self.data
        start = self.tables["glyf"][0] + int(self._loca[gid])
        end = self.tables["glyf"][0] + int(self._loca[gid + 1])
        if end <= start:
            g = ("empty",)
        else:
            n_contours, x_min = struct.unpack_from(">hh", data, start)
            if n_contours >= 0:
                g = self._simple_glyph(start + 10, n_contours, x_min)
            else:
                g = self._composite_glyph(start + 10)
        self._glyphs[gid] = g
        return g

    def _simple_glyph(self, pos: int, n_contours: int, x_min: int) -> tuple:
        data = self.data
        if n_contours == 0:
            return ("simple", [], [], [], [], x_min)
        end_pts = list(struct.unpack_from(">%dH" % n_contours, data, pos))
        pos += 2 * n_contours
        pos += 2 + _U16(data, pos)[0]  # instructions
        n_points = end_pts[-1] + 1
        flags = []
        while len(flags) < n_points:
            f = data[pos]
            pos += 1
            repeat = 1
            if f & _REPEAT:
                repeat = data[pos] + 1
                pos += 1
            flags.extend([f] * repeat)
        flags = flags[:n_points]
        xs, pos = self._coords(flags, pos, _X_SHORT, _X_SAME)
        ys, pos = self._coords(flags, pos, _Y_SHORT, _Y_SAME)
        keep = [f & (_ON_CURVE | 0x40 | _CUBIC) for f in flags]
        return ("simple", xs, ys, end_pts, keep, x_min)

    def _coords(self, flags, pos: int, short: int, same: int):
        data = self.data
        out = []
        v = 0
        for f in flags:
            if f & short:
                d = data[pos]
                pos += 1
                v += d if f & same else -d
            elif not f & same:
                v += _I16(data, pos)[0]
                pos += 2
            out.append(v)
        return out, pos

    def _composite_glyph(self, pos: int) -> tuple:
        data = self.data
        comps = []
        while True:
            flags, gid = struct.unpack_from(">HH", data, pos)
            pos += 4
            if flags & _ARG_WORDS:
                fmt, step = (">hh", 4) if flags & _ARGS_XY else (">HH", 4)
            else:
                fmt, step = (">bb", 2) if flags & _ARGS_XY else (">BB", 2)
            a, b = struct.unpack_from(fmt, data, pos)
            pos += step
            if not flags & _ARGS_XY:
                raise NotImplementedError(
                    "composite glyphs placed by point matching are not read by "
                    "the port's OpenType reader (nor drawn by fontTools' pens)")
            if flags & _HAVE_SCALE:
                s = _f2dot14(_I16(data, pos)[0])
                trans = (s, 0, 0, s, a, b)
                pos += 2
            elif flags & _HAVE_XY_SCALE:
                sx, sy = struct.unpack_from(">hh", data, pos)
                trans = (_f2dot14(sx), 0, 0, _f2dot14(sy), a, b)
                pos += 4
            elif flags & _HAVE_2X2:
                xx, xy, yx, yy = struct.unpack_from(">hhhh", data, pos)
                trans = (_f2dot14(xx), _f2dot14(xy), _f2dot14(yx), _f2dot14(yy), a, b)
                pos += 8
            else:
                trans = (1, 0, 0, 1, a, b)
            comps.append((gid, trans))
            if not flags & _MORE_COMPONENTS:
                return ("composite", comps)

    def glyph_path(self, gid: int) -> list:
        """The glyph's outline as fontTools' DecomposingRecordingPen value
        list (font units, y up), drawn as TTGlyphSet draws it: a simple
        glyph at the top level shifted by its hmtx lsb minus its xMin."""
        out: list = []
        self._draw(gid, out, None, True)
        return out

    def _draw(self, gid: int, out: list, trans, top: bool) -> None:
        g = self._glyph(gid)
        if g[0] == "empty":
            return
        if g[0] == "composite":
            for cgid, ctrans in g[1]:
                if trans is not None:
                    ctrans = _compose(trans, ctrans)
                if tuple(ctrans) == _IDENTITY:
                    self._draw(cgid, out, None, False)
                else:
                    self._draw(cgid, out, ctrans, False)
            return
        _, xs, ys, end_pts, flags, x_min = g
        offset = int(self.lsbs[gid]) - x_min if top else 0
        if offset:
            xs = [x + offset for x in xs]
        if trans is None:
            pts = list(zip(xs, ys))
        else:
            xx, xy, yx, yy, dx, dy = trans
            pts = [(xx * x + yx * y + dx, xy * x + yy * y + dy) for x, y in zip(xs, ys)]
        _trace_contours(pts, end_pts, flags, out)


def _compose(outer, inner):
    """fontTools' Transform(outer).transform(inner): inner applied first."""
    xx1, xy1, yx1, yy1, dx1, dy1 = inner
    xx2, xy2, yx2, yy2, dx2, dy2 = outer
    return (xx1 * xx2 + xy1 * yx2, xx1 * xy2 + xy1 * yy2,
            yx1 * xx2 + yy1 * yx2, yx1 * xy2 + yy1 * yy2,
            xx2 * dx1 + yx2 * dy1 + dx2, xy2 * dx1 + yy2 * dy1 + dy2)


def _trace_contours(pts, end_pts, flags, out: list) -> None:
    """fontTools' Glyph.draw contour walk onto a recording list: pts are
    the (already transformed) points, flags the kept point flags."""
    start = 0
    for end in end_pts:
        end += 1
        contour = pts[start:end]
        c_flags = [_ON_CURVE & f for f in flags[start:end]]
        cu_flags = [_CUBIC & f for f in flags[start:end]]
        start = end
        if 1 not in c_flags:
            if cu_flags and all(cu_flags):
                raise NotImplementedError(
                    "cubic glyf contours are not read by the port's OpenType reader")
            contour.append(None)
            out.append(("qCurveTo", tuple(contour)))
        else:
            first_on = c_flags.index(1) + 1
            contour = contour[first_on:] + contour[:first_on]
            c_flags = c_flags[first_on:] + c_flags[:first_on]
            cu_flags = cu_flags[first_on:] + cu_flags[:first_on]
            out.append(("moveTo", (contour[-1],)))
            while contour:
                next_on = c_flags.index(1) + 1
                if next_on == 1:
                    if len(contour) > 1:
                        out.append(("lineTo", (contour[0],)))
                else:
                    if any(cu_flags[: next_on - 1]):
                        raise NotImplementedError(
                            "cubic glyf contours are not read by the port's "
                            "OpenType reader")
                    out.append(("qCurveTo", tuple(contour[:next_on])))
                contour = contour[next_on:]
                c_flags = c_flags[next_on:]
                cu_flags = cu_flags[next_on:]
        out.append(("closePath", ()))


# --- GDEF, GSUB and GPOS --------------------------------------------------------------


class _LazyLookups:
    """LookupList.Lookup: a sequence whose lookups decode on first access."""

    def __init__(self, reader, offsets, is_gsub):
        self._reader = reader
        self._offsets = offsets
        self._is_gsub = is_gsub
        self._done: Dict[int, SimpleNamespace] = {}

    def __len__(self):
        return len(self._offsets)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[k] for k in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self._offsets)
        found = self._done.get(i)
        if found is None:
            found = self._done[i] = self._reader.lookup(self._offsets[i], self._is_gsub)
        return found

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class _LayoutReader:
    """Decoder of one OpenType layout table at byte offset `base`."""

    def __init__(self, font: OTFont, base: int):
        self.font = font
        self.d = font.data
        self.base = base
        self.name = font.glyph_name

    def u16(self, off):
        return _U16(self.d, off)[0]

    def u16s(self, off, n):
        return list(struct.unpack_from(">%dH" % n, self.d, off)) if n else []

    def names(self, off, n):
        name = self.name
        return [name(g) for g in self.u16s(off, n)]

    def tag(self, off):
        return self.d[off : off + 4].decode("latin1")

    # --- common tables ---

    def coverage(self, off):
        if off is None:
            return None
        fmt = self.u16(off)
        if fmt == 1:
            return SimpleNamespace(glyphs=self.names(off + 4, self.u16(off + 2)))
        glyphs = []
        if fmt == 2:
            n = self.u16(off + 2)
            ranges = [struct.unpack_from(">HHH", self.d, off + 4 + 6 * i) for i in range(n)]
            ranges.sort(key=lambda r: r[2])
            name = self.name
            for start, end, _idx in ranges:
                glyphs.extend(name(g) for g in range(start, end + 1))
        return SimpleNamespace(glyphs=glyphs)

    def class_def(self, off):
        if off is None:
            return None
        fmt = self.u16(off)
        defs: Dict[str, int] = {}
        name = self.name
        if fmt == 1:
            start, n = self.u16(off + 2), self.u16(off + 4)
            for k, cls in enumerate(self.u16s(off + 6, n)):
                if cls:
                    defs[name(start + k)] = cls
        elif fmt == 2:
            n = self.u16(off + 2)
            for i in range(n):
                start, end, cls = struct.unpack_from(">HHH", self.d, off + 4 + 6 * i)
                if cls:
                    for g in range(start, end + 1):
                        defs[name(g)] = cls
        return SimpleNamespace(classDefs=defs)

    def off(self, base, at):
        """A 16-bit offset at `at`, relative to `base`; None when null."""
        o = self.u16(at)
        return base + o if o else None

    def offs(self, base, at, n):
        return [base + o if o else None for o in self.u16s(at, n)]

    def value_record(self, parent, at, fmt):
        """(ValueRecord or None, its size): the fields of `fmt` only."""
        if not fmt:
            return None, 0
        rec = SimpleNamespace()
        for bit, field in ((0x1, "XPlacement"), (0x2, "YPlacement"),
                           (0x4, "XAdvance"), (0x8, "YAdvance"),
                           (0x10, "XPlaDevice"), (0x20, "YPlaDevice"),
                           (0x40, "XAdvDevice"), (0x80, "YAdvDevice")):
            if fmt & bit:
                v = _I16(self.d, at)[0] if bit < 0x10 else _U16(self.d, at)[0]
                setattr(rec, field, v)
                at += 2
        return rec, 2 * bin(fmt & 0xFF).count("1")

    def anchor(self, off):
        if off is None:
            return None
        fmt, x, y = struct.unpack_from(">Hhh", self.d, off)
        a = SimpleNamespace(Format=fmt, XCoordinate=x, YCoordinate=y)
        if fmt == 2:
            a.AnchorPoint = self.u16(off + 6)
        return a

    def lookup_records(self, at, n):
        return [SimpleNamespace(SequenceIndex=s, LookupListIndex=li)
                for s, li in (struct.unpack_from(">HH", self.d, at + 4 * i)
                              for i in range(n))]

    # --- table heads ---

    def gdef(self):
        b = self.base
        version = _U32(self.d, b)[0]
        t = SimpleNamespace(Version=version)
        t.GlyphClassDef = self.class_def(self.off(b, b + 4))
        t.MarkAttachClassDef = self.class_def(self.off(b, b + 10))
        t.MarkGlyphSetsDef = None
        if version >= 0x00010002:
            sets = self.off(b, b + 12)
            if sets is not None:
                n = self.u16(sets + 2)
                covs = [sets + o for o in struct.unpack_from(">%dI" % n, self.d, sets + 4)]
                t.MarkGlyphSetsDef = SimpleNamespace(
                    MarkSetTableFormat=self.u16(sets),
                    Coverage=[self.coverage(c) for c in covs])
        return t

    def gsub_gpos(self, is_gsub):
        b = self.base
        t = SimpleNamespace(Version=_U32(self.d, b)[0])
        sl, fl, ll = self.off(b, b + 4), self.off(b, b + 6), self.off(b, b + 8)
        t.ScriptList = None if sl is None else self.script_list(sl)
        t.FeatureList = None if fl is None else self.feature_list(fl)
        t.LookupList = None
        if ll is not None:
            t.LookupList = SimpleNamespace(Lookup=_LazyLookups(
                self, self.offs(ll, ll + 2, self.u16(ll)), is_gsub))
        return t

    def lang_sys(self, off):
        if off is None:
            return None
        req, n = self.u16(off + 2), self.u16(off + 4)
        return SimpleNamespace(ReqFeatureIndex=req, FeatureCount=n,
                               FeatureIndex=self.u16s(off + 6, n))

    def script_list(self, off):
        records = []
        for i in range(self.u16(off)):
            at = off + 2 + 6 * i
            s = off + self.u16(at + 4)
            langs = []
            for k in range(self.u16(s + 2)):
                lat = s + 4 + 6 * k
                langs.append(SimpleNamespace(LangSysTag=self.tag(lat),
                                             LangSys=self.lang_sys(s + self.u16(lat + 4))))
            script = SimpleNamespace(DefaultLangSys=self.lang_sys(self.off(s, s)),
                                     LangSysRecord=langs)
            records.append(SimpleNamespace(ScriptTag=self.tag(at), Script=script))
        return SimpleNamespace(ScriptRecord=records)

    def feature_list(self, off):
        records = []
        for i in range(self.u16(off)):
            at = off + 2 + 6 * i
            f = off + self.u16(at + 4)
            n = self.u16(f + 2)
            feature = SimpleNamespace(FeatureParams=self.off(f, f), LookupCount=n,
                                      LookupListIndex=self.u16s(f + 4, n))
            records.append(SimpleNamespace(FeatureTag=self.tag(at), Feature=feature))
        return SimpleNamespace(FeatureRecord=records)

    def lookup(self, off, is_gsub):
        ltype, flag, n = struct.unpack_from(">HHH", self.d, off)
        lk = SimpleNamespace(LookupType=ltype, LookupFlag=flag, SubTableCount=n)
        subs = [off + o for o in self.u16s(off + 6, n)]
        if flag & 0x10:
            lk.MarkFilteringSet = self.u16(off + 6 + 2 * n)
        decode = self.gsub_subtable if is_gsub else self.gpos_subtable
        lk.SubTable = [decode(ltype, s) for s in subs]
        return lk

    def extension(self, off, is_gsub):
        fmt, etype = self.u16(off), self.u16(off + 2)
        inner = off + _U32(self.d, off + 4)[0]
        decode = self.gsub_subtable if is_gsub else self.gpos_subtable
        return SimpleNamespace(Format=fmt, ExtensionLookupType=etype,
                               ExtSubTable=decode(etype, inner))

    # --- GSUB ---

    def gsub_subtable(self, ltype, off):
        fmt = self.u16(off)
        sub = SimpleNamespace(Format=fmt)
        if ltype == 7:
            return self.extension(off, True)
        if ltype in (5, 6):
            return self.context(ltype == 6, off, "Sub", "SubstLookupRecord")
        if ltype == 8:
            sub.Coverage = self.coverage(self.off(off, off + 2))
            at = off + 4
            n = self.u16(at)
            sub.BacktrackCoverage = [self.coverage(c) for c in self.offs(off, at + 2, n)]
            at += 2 + 2 * n
            n = self.u16(at)
            sub.LookAheadCoverage = [self.coverage(c) for c in self.offs(off, at + 2, n)]
            at += 2 + 2 * n
            sub.Substitute = self.names(at + 2, self.u16(at))
            return sub
        glyphs = self.coverage(self.off(off, off + 2)).glyphs
        if ltype == 1:
            if fmt == 1:
                delta = _I16(self.d, off + 4)[0]
                tf = self.font
                sub.mapping = {g: tf.glyph_name((tf._name_to_gid.get(g, 0) + delta) % 65536)
                               for g in glyphs}
            else:
                sub.mapping = dict(zip(glyphs, self.names(off + 6, self.u16(off + 4))))
        elif ltype in (2, 3):
            seqs = []
            for s in self.offs(off, off + 6, self.u16(off + 4)):
                seqs.append(self.names(s + 2, self.u16(s)))
            if ltype == 2:
                sub.mapping = dict(zip(glyphs, seqs))
            else:
                sub.alternates = dict(zip(glyphs, seqs))
        elif ltype == 4:
            ligatures = {}
            for first, s in zip(glyphs, self.offs(off, off + 6, self.u16(off + 4))):
                ligs = []
                for lg in self.offs(s, s + 2, self.u16(s)):
                    n = self.u16(lg + 2)
                    ligs.append(SimpleNamespace(LigGlyph=self.name(self.u16(lg)),
                                                CompCount=n,
                                                Component=self.names(lg + 4, n - 1)))
                ligatures[first] = ligs
            sub.ligatures = ligatures
        return sub

    def context(self, chained, off, kind, rec_name):
        """(Chain)Context subtables of GSUB 5/6 and GPOS 7/8 under fontTools'
        names: kind "Sub" or "Pos" prefixes the rule set and rule names."""
        fmt = self.u16(off)
        sub = SimpleNamespace(Format=fmt)
        pre = ("Chain" + kind) if chained else kind
        if fmt in (1, 2):
            sub.Coverage = self.coverage(self.off(off, off + 2))
            at = off + 4
            if fmt == 2:
                if chained:
                    sub.BacktrackClassDef = self.class_def(self.off(off, at))
                    sub.InputClassDef = self.class_def(self.off(off, at + 2))
                    sub.LookAheadClassDef = self.class_def(self.off(off, at + 4))
                    at += 6
                else:
                    sub.ClassDef = self.class_def(self.off(off, at))
                    at += 2
            set_name = pre + ("RuleSet" if fmt == 1 else "ClassSet")
            rule_name = pre + ("Rule" if fmt == 1 else "ClassRule")
            values = self.names if fmt == 1 else self.u16s
            sets = []
            for s in self.offs(off, at + 2, self.u16(at)):
                if s is None:
                    sets.append(None)
                    continue
                rules = []
                for r in self.offs(s, s + 2, self.u16(s)):
                    rules.append(self.rule(r, chained, fmt, values, rec_name))
                sets.append(SimpleNamespace(**{rule_name: rules}))
            setattr(sub, set_name, sets)
            return sub
        if fmt == 3:
            if chained:
                at = off + 2
                lists = []
                for _ in range(3):
                    n = self.u16(at)
                    lists.append([self.coverage(c) for c in self.offs(off, at + 2, n)])
                    at += 2 + 2 * n
                sub.BacktrackCoverage, sub.InputCoverage, sub.LookAheadCoverage = lists
                setattr(sub, rec_name, self.lookup_records(at + 2, self.u16(at)))
            else:
                n, n_rec = self.u16(off + 2), self.u16(off + 4)
                sub.Coverage = [self.coverage(c) for c in self.offs(off, off + 6, n)]
                setattr(sub, rec_name, self.lookup_records(off + 6 + 2 * n, n_rec))
        return sub

    def rule(self, r, chained, fmt, values, rec_name):
        rule = SimpleNamespace()
        if chained:
            at = r
            n = self.u16(at)
            rule.Backtrack = values(at + 2, n)
            at += 2 + 2 * n
            n = self.u16(at)
            rule.Input = values(at + 2, n - 1)
            at += 2 + 2 * max(n - 1, 0)
            n = self.u16(at)
            rule.LookAhead = values(at + 2, n)
            at += 2 + 2 * n
            setattr(rule, rec_name, self.lookup_records(at + 2, self.u16(at)))
        else:
            n, n_rec = self.u16(r), self.u16(r + 2)
            setattr(rule, "Input" if fmt == 1 else "Class", values(r + 4, n - 1))
            setattr(rule, rec_name, self.lookup_records(r + 4 + 2 * max(n - 1, 0), n_rec))
        return rule

    # --- GPOS ---

    def gpos_subtable(self, ltype, off):
        if ltype == 9:
            return self.extension(off, False)
        if ltype in (7, 8):
            return self.context(ltype == 8, off, "Pos", "PosLookupRecord")
        fmt = self.u16(off)
        sub = SimpleNamespace(Format=fmt)
        if ltype == 1:
            sub.Coverage = self.coverage(self.off(off, off + 2))
            vf = self.u16(off + 4)
            sub.ValueFormat = vf
            if fmt == 1:
                sub.Value = self.value_record(off, off + 6, vf)[0]
            else:
                n = self.u16(off + 6)
                size = self.value_record(off, off + 8, vf)[1]
                sub.Value = [self.value_record(off, off + 8 + size * i, vf)[0]
                             for i in range(n)]
        elif ltype == 2:
            sub.Coverage = self.coverage(self.off(off, off + 2))
            vf1, vf2 = self.u16(off + 4), self.u16(off + 6)
            sub.ValueFormat1, sub.ValueFormat2 = vf1, vf2
            if fmt == 1:
                sets = []
                for s in self.offs(off, off + 10, self.u16(off + 8)):
                    recs = []
                    at = s + 2
                    for _ in range(self.u16(s)):
                        second = self.name(self.u16(at))
                        v1, n1 = self.value_record(s, at + 2, vf1)
                        v2, n2 = self.value_record(s, at + 2 + n1, vf2)
                        recs.append(SimpleNamespace(SecondGlyph=second, Value1=v1, Value2=v2))
                        at += 2 + n1 + n2
                    sets.append(SimpleNamespace(PairValueRecord=recs))
                sub.PairSet = sets
            else:
                sub.ClassDef1 = self.class_def(self.off(off, off + 8))
                sub.ClassDef2 = self.class_def(self.off(off, off + 10))
                c1, c2 = self.u16(off + 12), self.u16(off + 14)
                at = off + 16
                rows = []
                for _ in range(c1):
                    cols = []
                    for _ in range(c2):
                        v1, n1 = self.value_record(off, at, vf1)
                        v2, n2 = self.value_record(off, at + n1, vf2)
                        cols.append(SimpleNamespace(Value1=v1, Value2=v2))
                        at += n1 + n2
                    rows.append(SimpleNamespace(Class2Record=cols))
                sub.Class1Record = rows
        elif ltype == 3:
            sub.Coverage = self.coverage(self.off(off, off + 2))
            recs = []
            for i in range(self.u16(off + 4)):
                at = off + 6 + 4 * i
                recs.append(SimpleNamespace(EntryAnchor=self.anchor(self.off(off, at)),
                                            ExitAnchor=self.anchor(self.off(off, at + 2))))
            sub.EntryExitRecord = recs
        elif ltype in (4, 5, 6):
            first = {4: "Mark", 5: "Mark", 6: "Mark1"}[ltype]
            second = {4: "Base", 5: "Ligature", 6: "Mark2"}[ltype]
            setattr(sub, first + "Coverage", self.coverage(self.off(off, off + 2)))
            setattr(sub, second + "Coverage", self.coverage(self.off(off, off + 4)))
            n_cls = self.u16(off + 6)
            sub.ClassCount = n_cls
            setattr(sub, first + "Array", self.mark_array(self.off(off, off + 8)))
            arr = self.off(off, off + 10)
            if ltype == 5:
                attach = []
                for la in self.offs(arr, arr + 2, self.u16(arr)):
                    comps = []
                    for k in range(self.u16(la)):
                        at = la + 2 + 2 * n_cls * k
                        comps.append(SimpleNamespace(LigatureAnchor=[
                            self.anchor(a) for a in self.offs(la, at, n_cls)]))
                    attach.append(SimpleNamespace(ComponentRecord=comps))
                sub.LigatureArray = SimpleNamespace(LigatureAttach=attach)
            else:
                rec_name = "BaseRecord" if ltype == 4 else "Mark2Record"
                anchor_name = "BaseAnchor" if ltype == 4 else "Mark2Anchor"
                recs = []
                for k in range(self.u16(arr)):
                    at = arr + 2 + 2 * n_cls * k
                    recs.append(SimpleNamespace(**{anchor_name: [
                        self.anchor(a) for a in self.offs(arr, at, n_cls)]}))
                setattr(sub, second + "Array", SimpleNamespace(**{rec_name: recs}))
        return sub

    def mark_array(self, off):
        recs = []
        for i in range(self.u16(off)):
            at = off + 2 + 4 * i
            recs.append(SimpleNamespace(Class=self.u16(at),
                                        MarkAnchor=self.anchor(self.off(off, at + 2))))
        return SimpleNamespace(MarkRecord=recs)
