"""The port's OpenType reader: the parts of an sfnt font the text pipeline
reads, in numpy and struct, with no fontTools.

It stands in for fontTools' TTFont where figdraw_tpu's typefaces.py,
typeface_info.py and shaper.py use it, and gives the same values:

- the sfnt and TTC headers, WOFF 1.0 files (text/woff.py inflates them to
  the sfnt they wrap) and WOFF 2.0 files (text/woff2.py rebuilds theirs); head, hhea, maxp, name;
  the glyph order as TTFont.getGlyphOrder gives it: a 'CFF ' table's
  charset, else post names (format 1, the standard order; format 2, its
  names, duplicates renamed "name.1"; format 4, AGL names by code), else
  names from the Unicode cmaps (post format 3, no post table, format 1
  over 258 glyphs: _getGlyphNamesFromCmap's AGL names, uniXXXX or uXXXXX,
  ".altN" for a name used again, glyphNNNNN for the rest);
- cmap, the subtable fontTools' getBestCmap picks, formats 0, 2, 4, 6, 12
  and 13 (8 and 10 raise: fontTools has no reader for them either);
- hmtx, the last advance repeating past numberOfHMetrics;
- the legacy kern table, format 0, as {(left name, right name): value};
- glyf/loca, simple and composite glyphs, parsed per glyph on first use:
  glyph_path gives the value list of fontTools' DecomposingRecordingPen
  (implied on-curve points left implicit, contours that start off-curve
  rotated to end on-curve, all-off-curve contours ending in None, cubic
  contours (glyphDataFormat 1) as curveTo with implied on-curve midpoints,
  components decomposed through their 2x2 transform and offsets);
- CFF and CFF2 outlines (text/cff.py), preferred to glyf as fontTools'
  getGlyphSet prefers them, and a 'CFF ' table's charset as the glyph
  order;
- GDEF, GSUB (types 1-8) and GPOS (types 1-9), extensions included,
  decoded per lookup into SimpleNamespace objects under fontTools'
  attribute names (Coverage.glyphs in coverage-index order,
  ClassDef.classDefs as a dict without class 0, Value1/Value2 None for an
  empty value format), so the shaper reads them as it reads fontTools';
- variations: fvar axes; a user location normalized through fvar and avar
  (text/varstore.py); at a normalized location, glyf outlines moved by gvar
  (text/gvar.py) as fontTools' instanced glyph set draws them, CFF2
  charstrings blended by their VarStore, and advances with HVAR's deltas;
- VARC: a glyph in its Coverage drawn as fontTools' VARC glyph set draws
  it (text/varc.py), its components' locations moving glyf outlines
  through gvar even where the face's own location is empty.

A malformed table raises ValueError naming it where fontTools' reading of
the tables figdraw_tpu's load touches fails (its size checks and struct
formats, each read here bounded by the table or glyph it belongs to).

A location is applied as fontTools' getGlyphSet(location=...) applies it:
a non-empty normalized location instances every glyph (even at the
default, where the deltas are 0), an empty one or None draws the default
glyph set.
"""

from __future__ import annotations

import struct
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np

from .agl_data import UV2AGL
from .cff import CFFTable
from .gvar import Gvar, instance_coordinates
from .varc import VarcTable, emit
from .varstore import Avar, ItemVariationStore, normalize_location, ot_round, var_idx_map
from .woff import is_woff, woff_to_sfnt

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
_MORE_COMPONENTS, _HAVE_XY_SCALE, _HAVE_2X2, _HAVE_INSTRUCTIONS = 0x20, 0x40, 0x80, 0x100
_IDENTITY = (1, 0, 0, 1, 0, 0)


def _f2dot14(v: int) -> float:
    return v / 16384.0


def _ps_name_mapping(order: List[str]) -> List[str]:
    """fontTools' build_psNameMapping: an empty name becomes "glyph%05d",
    and a repeated name takes the first free ".N" suffix."""
    in_order = set(order)
    seen: Dict[str, int] = {}
    for gid, name in enumerate(order):
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


def collection_size(data: bytes) -> int:
    """The number of faces in a font file's bytes: a TTC/OTC header's
    count, else 1 (an sfnt, or a WOFF or WOFF2 file, which wraps one
    face)."""
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
    """One face of an sfnt (.ttf, .otf, or one face of a .ttc/.otc
    collection) or of a WOFF 1.0 or 2.0 file (.woff, unwrapped by
    text/woff.py; .woff2, rebuilt by text/woff2.py), read from its bytes.

    The tables the pipeline needs are read at construction (they are
    small); cmap, kern, name, GSUB, GPOS, GDEF and the variation tables on
    first use; glyf and gvar per glyph, charstrings per draw."""

    def __init__(self, data: bytes, face_index: int = 0):
        data = bytes(data)
        woff2 = data[:4] == b"wOF2"  # fontTools' WOFF2Reader checks no flavor
        if is_woff(data):
            data = woff_to_sfnt(data)
        self.data = data
        base = 0
        if data[:4] == b"ttcf":
            n_fonts = _U32(data, 8)[0]
            if not 0 <= face_index < n_fonts:
                raise IndexError(f"face {face_index} of a {n_fonts}-face collection")
            base = _U32(data, 12 + 4 * face_index)[0]
        if base + 12 > len(data):
            raise ValueError("not an OpenType face: the sfnt header runs past the file")
        if not woff2 and data[base: base + 4] not in (b"\x00\x01\x00\x00", b"OTTO", b"true"):
            raise ValueError("Not a TrueType or OpenType font (bad sfntVersion)")
        num_tables = _U16(data, base + 4)[0]
        if base + 12 + 16 * num_tables > len(data):
            raise ValueError("malformed sfnt table directory: it runs past the file")
        self.tables: Dict[str, Tuple[int, int]] = {}
        for i in range(num_tables):
            rec = base + 12 + 16 * i
            tag = data[rec : rec + 4].decode("latin1")
            _checksum, offset, length = struct.unpack_from(">III", data, rec + 4)
            self.tables[tag] = (offset, length)
        for tag in ("head", "hhea", "maxp", "hmtx"):
            if tag not in self.tables:
                raise ValueError(f"not an OpenType face: no '{tag}' table")

        # the sizes fontTools' decompilers need (head: 54 bytes or two zero
        # bytes more; hhea exactly 36; maxp 6 for version 0.5, 32 for 1.0)
        head, head_len = self._table("head", 54)
        if head_len > 54 and data[head + 54: head + head_len] != b"\0\0":
            raise ValueError("malformed 'head' table: bytes past its 54 other than two zeros")
        self.units_per_em = _U16(data, head + 18)[0]
        self.index_to_loc_format = _I16(data, head + 50)[0]
        hhea, hhea_len = self._table("hhea", 36)
        if hhea_len != 36:
            raise ValueError(f"malformed 'hhea' table: {hhea_len} bytes, not 36")
        self.ascent, self.descent, self.line_gap = struct.unpack_from(">hhh", data, hhea + 4)
        n_hmetrics = _U16(data, hhea + 34)[0]
        maxp, maxp_len = self._table("maxp", 6)
        if maxp_len != (6 if _U32(data, maxp)[0] == 0x00005000 else 32):
            raise ValueError(f"malformed 'maxp' table: {maxp_len} bytes for its version")
        self.num_glyphs = _U16(data, maxp + 4)[0]

        # advances and left side bearings; the last advance repeats
        n = self.num_glyphs
        n_h = min(n_hmetrics, n)
        hmtx, hmtx_len = self._table("hmtx")
        if hmtx_len < 4 * n_h + 2 * (n - n_h):
            raise ValueError(f"not enough 'hmtx' table data: expected {4 * n_h + 2 * (n - n_h)}"
                             f" bytes, got {hmtx_len}")
        if n > 0 and n_h == 0:
            raise ValueError("malformed 'hmtx' table: numberOfHMetrics is 0")
        metrics = np.frombuffer(data, dtype=">i2", count=2 * n_h, offset=hmtx).reshape(n_h, 2)
        self.advances = np.empty(n, np.int64)
        self.lsbs = np.empty(n, np.int64)
        self.advances[:n_h] = metrics[:, 0].view(">u2")
        self.lsbs[:n_h] = metrics[:, 1]
        if n > n_h:
            self.advances[n_h:] = self.advances[n_h - 1] if n_h else 0
            self.lsbs[n_h:] = np.frombuffer(data, dtype=">i2", count=n - n_h,
                                            offset=hmtx + 4 * n_h)

        self.axes = self.fvar_axes()
        self.cff: Optional[CFFTable] = None
        cff_tag = "CFF2" if "CFF2" in self.tables else "CFF "
        if cff_tag in self.tables:
            self.cff = CFFTable(data, *self.tables[cff_tag], cff_tag == "CFF2",
                                [a.axisTag for a in self.axes])
        if "CFF " in self.tables:
            # TTFont.getGlyphOrder: a 'CFF ' table's charset names the glyphs
            self.glyph_order: List[str] = (
                self.cff.glyph_names if cff_tag == "CFF " else
                CFFTable(data, *self.tables["CFF "], False).glyph_names)
        else:
            self.glyph_order = self._read_glyph_order()
        self._name_to_gid = {nm: i for i, nm in enumerate(self.glyph_order)}

        self._loca = None
        if self.cff is None and "glyf" in self.tables:
            self._loca = self._read_loca()
            self._check_gvar()
        self._glyphs: Dict[int, tuple] = {}
        self._cmap: Optional[Dict[int, str]] = None
        self._kern: Optional[Dict[Tuple[str, str], int]] = None
        self._names: Optional[List[NameRecord]] = None
        self._layout: Dict[str, object] = {}
        self._var_tables: Optional[tuple] = None
        self._hvar_instancers: Dict[tuple, object] = {}  # per location, as a glyph set's
        self._varc = None

    def __contains__(self, tag: str) -> bool:
        return tag in self.tables

    def _table(self, tag: str, least: int = 0) -> Tuple[int, int]:
        """(offset, length) of a table that lies within the file and holds
        at least `least` bytes (ValueError naming it otherwise: fontTools'
        reader asserts a table's whole length is read, and its struct
        formats need their bytes)."""
        off, length = self.tables[tag]
        if off + length > len(self.data):
            raise ValueError(f"malformed '{tag}' table: it runs past the end of the file")
        if length < least:
            raise ValueError(f"malformed '{tag}' table: {length} bytes, fewer than {least}")
        return off, length

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
        """TTFont.getGlyphOrder without a 'CFF ' table: the post table's
        names (format 1, the standard order; 2, its own names; 4, AGL names
        by code), else names from the Unicode cmaps: post format 3, no post
        table, or format 1 over more glyphs than its 258 names."""
        n = self.num_glyphs
        names = None
        if "post" in self.tables:
            post, length = self._table("post", 32)
            fmt = _U32(self.data, post)[0]
            if fmt == 0x00010000:
                names = STANDARD_GLYPH_ORDER[:n] if n <= len(STANDARD_GLYPH_ORDER) else None
            elif fmt == 0x00020000:
                names = self._post_format2(post + 32, post + length)
            elif fmt == 0x00040000:
                names = self._post_format4(post + 32, post + length)
            elif fmt != 0x00030000:
                raise ValueError(f"'post' table format {fmt / 65536:f} not supported")
        return self._names_from_cmap() if names is None else names

    def _post_format2(self, pos: int, end: int) -> List[str]:
        """post format 2 names, as fontTools' decode_format_2_0 gives them:
        a count past maxp's is maxp's, and an index past the names gives
        an empty name."""
        data = self.data
        n = self.num_glyphs
        if pos + 2 > end:
            raise ValueError("malformed 'post' table: no format 2 glyph count")
        count = min(_U16(data, pos)[0], n)
        if count == 0 or pos + 2 + 2 * count > end:
            raise ValueError("malformed 'post' table: format 2 indices cut short")
        indices = struct.unpack_from(">%dH" % count, data, pos + 2)
        pos += 2 + 2 * count
        extra = []
        for _ in range(max(indices) - 257):
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
        return _ps_name_mapping(order)

    def _post_format4(self, pos: int, end: int) -> List[str]:
        """post format 4 (decode_format_4_0): a code a glyph, 0xFFFF for
        none, named through the AGL or as uniXXXX."""
        if (end - pos) % 2:
            raise ValueError("malformed 'post' table: format 4 codes of an odd length")
        codes = struct.unpack_from(">%dH" % ((end - pos) // 2), self.data, pos)
        order = [""] * self.num_glyphs
        for gid, code in enumerate(codes[: self.num_glyphs]):
            if code != 0xFFFF:
                order[gid] = UV2AGL.get(code) or "uni%04X" % code
        return _ps_name_mapping(order)

    def _names_from_cmap(self) -> List[str]:
        """TTFont._getGlyphNamesFromCmap: glyph 0 is ".notdef"; a glyph a
        Unicode cmap subtable maps is named from its least code point (the
        AGL name, else uniXXXX or uXXXXX; a name used again takes ".altN"
        in glyph order); every other glyph is "glyphNNNNN"."""
        n = self.num_glyphs
        if n == 0:
            raise ValueError("a face of no glyphs has no name for glyph 0")
        least: Dict[int, int] = {}
        for pid, eid, fmt, sub in self._cmap_subtables():
            if not (pid == 0 or (pid == 3 and eid in (0, 1, 10))):
                continue
            if fmt == 14:
                continue  # variation sequences: an empty map in fontTools
            mapped: Dict[int, int] = {}
            for c, g in zip(*self._cmap_subtable(fmt, sub)):
                if g != 0:
                    mapped[c] = g
            for c, g in mapped.items():
                if g < n:
                    least[g] = min(least.get(g, c), c)
        order = [".notdef"] + ["glyph%.5d" % i for i in range(1, n)]
        uses: Dict[str, int] = {}
        for gid in sorted(least):
            code = least[gid]
            name = UV2AGL.get(code) or ("uni%04X" % code if code <= 0xFFFF else "u%X" % code)
            uses[name] = uses.get(name, 0) + 1
            order[gid] = name if uses[name] == 1 else "%s.alt%d" % (name, uses[name] - 1)
        return order

    # --- cmap ------------------------------------------------------------------

    def getBestCmap(self) -> Optional[Dict[int, str]]:  # noqa: N802 - fontTools' name
        """{codepoint: glyph name} of the first subtable in CMAP_PREFERENCES
        order (gid 0 left out), or None without a Unicode subtable; a face
        with no cmap table raises ValueError (fontTools' getBestCmap raises
        KeyError, so figdraw_tpu loads no such face)."""
        if "cmap" not in self.tables:
            raise ValueError("not an OpenType face figdraw_tpu loads: no 'cmap' table")
        if self._cmap is None:
            self._cmap = self._read_cmap()
        return self._cmap if self._cmap is not False else None

    def _cmap_subtables(self) -> List[Tuple[int, int, int, bytes]]:
        """(platform, encoding, format, bytes) of each cmap subtable in
        directory order, sliced from the table's bytes as fontTools' cmap
        decompile slices them (a signed offset; a subtable of zero length
        left out), each header checked as its decompileHeader checks it."""
        if "cmap" not in self.tables:
            return []
        off0, length = self._table("cmap")
        c = self.data[off0: off0 + length]
        if len(c) < 4:
            raise ValueError("malformed 'cmap' table: no header")
        out, seen = [], {}
        for i in range(_U16(c, 2)[0]):
            rec = c[4 + 8 * i: 12 + 8 * i]
            if len(rec) != 8:
                raise ValueError("malformed 'cmap' table: its encoding records run past it")
            pid, eid, off = struct.unpack(">HHl", rec)
            fmt = _U16(c[off: off + 2], 0)[0] if len(c[off: off + 2]) == 2 else None
            need = 8 if fmt in (8, 10, 12, 13) else 6 if fmt == 14 else 4
            head = c[off: off + need]
            if len(head) != need:
                raise ValueError("malformed 'cmap' table: a subtable header past its end")
            size = (_U32(head, 4)[0] if need == 8 else _U32(head, 2)[0] if need == 6
                    else _U16(head, 2)[0])
            if not size:
                continue
            sub = c[off: off + size]
            if fmt in (0, 2, 4, 6) and (len(sub) < 6 or len(sub) != size):
                raise ValueError(f"corrupt cmap table format {fmt}: {len(sub)} bytes, "
                                 f"its header says {size}")
            if fmt in (12, 13) and (len(sub) < 16 or
                                    not len(sub) == 16 + 12 * _U32(sub, 12)[0] == size):
                raise ValueError(f"corrupt cmap table format {fmt}: {len(sub)} bytes")
            if fmt == 14 and len(sub) < 10:
                raise ValueError("corrupt cmap table format 14: no header")
            if off in seen:  # fontTools shares the first one's map: decompiled now
                if fmt != 14:
                    self._cmap_subtable(*seen[off])
            else:
                seen[off] = (fmt, sub)
            out.append((pid, eid, fmt, sub))
        return out

    def _read_cmap(self):
        if "cmap" not in self.tables:
            return False
        subtables = {}
        for pid, eid, fmt, sub in self._cmap_subtables():
            subtables.setdefault((pid, eid), (fmt, sub))
        for key in CMAP_PREFERENCES:
            if key in subtables:
                chars, gids = self._cmap_subtable(*subtables[key])
                names = self.glyph_name
                return {c: names(g) for c, g in zip(chars, gids) if g != 0}
        return False

    def _cmap_subtable(self, fmt: int, sub: bytes):
        """A subtable's (codes, glyph ids) as fontTools decompiles its bytes:
        ValueError where its unpacking or asserts fail."""
        if fmt == 0:
            if len(sub) != 262:
                raise ValueError("Format 0 cmap subtable not 262 bytes")
            return list(range(256)), list(sub[6:262])
        if fmt == 4:
            if len(sub) < 14 or len(sub) % 2:
                raise ValueError("malformed cmap format 4 subtable")
            seg = _U16(sub, 6)[0] // 2
            words = np.frombuffer(sub, dtype=">u2", offset=14).astype(np.int64)
            end_code = words[:seg]
            start_code = words[seg + 1: 2 * seg + 1]
            id_delta = words[2 * seg + 1: 3 * seg + 1]
            range_off = words[3 * seg + 1: 4 * seg + 1]
            gia = words[4 * seg + 1:]
            chars, gids = [], []
            for i in range(len(start_code) - 1):  # the last segment (0xFFFF) is skipped
                if i >= min(len(end_code), len(id_delta), len(range_off)):
                    raise ValueError("malformed cmap format 4 subtable: its arrays cut short")
                codes = np.arange(start_code[i], end_code[i] + 1, dtype=np.int64)
                chars.extend(codes.tolist())
                if codes.size == 0:
                    continue
                if range_off[i] == 0:
                    g = (codes + id_delta[i]) & 0xFFFF
                else:
                    idx = codes + (range_off[i] // 2 - start_code[i] + i - len(range_off))
                    if (idx >= len(gia)).any() or (idx < -len(gia)).any():
                        raise ValueError("In format 4 cmap, an index into the glyph index "
                                         "array past its length")
                    raw = gia[idx]
                    g = np.where(raw != 0, (raw + id_delta[i]) & 0xFFFF, 0)
                gids.extend(g.tolist())
            return chars, gids
        if fmt == 6:
            if len(sub) < 10:
                raise ValueError("malformed cmap format 6 subtable")
            first, count = struct.unpack_from(">HH", sub, 6)
            body = sub[10: 10 + 2 * count]
            if len(body) % 2:
                raise ValueError("malformed cmap format 6 subtable: an odd byte")
            gids = list(struct.unpack(">%dH" % (len(body) // 2), body))
            return list(range(first, first + len(gids))), gids
        if fmt in (12, 13):
            # format 13 maps each group's whole range to its one glyph
            chars, gids = [], []
            for k in range(_U32(sub, 12)[0]):
                start, end, gid = struct.unpack_from(">III", sub, 16 + 12 * k)
                chars.extend(range(start, end + 1))
                if fmt == 12:
                    gids.extend(range(gid, gid + end - start + 1))
                else:
                    gids.extend([gid] * (end - start + 1))
            return chars, gids
        if fmt == 2:
            return self._cmap_format_2(sub)
        raise NotImplementedError(
            f"cmap subtable format {fmt} is not read by the port's OpenType "
            "reader (formats 0, 2, 4, 6, 12 and 13 are); fontTools 4.61.1 has no "
            "reader for formats 8 and 10 either, so figdraw_tpu cannot load such a "
            "face")

    @staticmethod
    def _cmap_format_2(sub: bytes):
        """cmap_format_2.decompile: a first byte picks a subHeader through
        subHeaderKeys; subHeader 0 maps the byte itself, any other maps a
        second byte; a glyph index that is not 0 gets idDelta added."""
        def unpack(fmt: str, at: int) -> tuple:
            if at < 0 or at + struct.calcsize(fmt) > len(sub):
                raise ValueError("malformed cmap format 2 subtable: a read past its end")
            return struct.unpack_from(fmt, sub, at)

        keys = [k // 8 for k in unpack(">256H", 6)]
        base = 6 + 512
        subs = []
        for k in range(max(keys) + 1):
            at = base + 8 * k
            first, count, delta, range_off = unpack(">HHhH", at)
            gia = unpack(">%dH" % count, at + 6 + range_off)
            subs.append((first, count, delta, gia))
        cmap: Dict[int, int] = {}
        for byte, k in enumerate(keys):
            first, count, delta, gia = subs[k]
            if k == 0:
                if not first <= byte < first + count:
                    continue
                codes = ((byte, gia[byte - first]),)
            else:
                codes = ((byte * 256 + first + i, gia[i]) for i in range(count))
            for code, gi in codes:
                if gi != 0:
                    cmap[code] = (gi + delta) % 0x10000
        return list(cmap), list(cmap.values())

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
        pos, length = self._table("fvar", 16)
        if _U32(data, pos)[0] != 0x00010000:
            raise ValueError("unsupported 'fvar' version")
        axes_off, _res, count, size, n_inst, inst_size = struct.unpack_from(">HHHHHH", data,
                                                                           pos + 4)
        # fontTools unpacks each axis (20 bytes) and instance (4 bytes and a
        # coordinate an axis) from its record's bytes within the table
        for k in range(count):
            at = axes_off + size * k
            if min(size, length - at) < 20:
                raise ValueError("malformed 'fvar' table: an axis record cut short")
        for k in range(n_inst):
            at = axes_off + size * count + inst_size * k
            if min(inst_size, length - at) < 4 + 4 * count:
                raise ValueError("malformed 'fvar' table: an instance record cut short")
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

    def normalize_location(self, location: Dict[str, float]) -> Dict[str, float]:
        """TTFont.normalizeLocation: a {tag: user value} location over
        fvar's axes (clamped, defaults filled in, other tags ignored), then
        avar's maps. Raises on a face without fvar."""
        if "fvar" not in self.tables:
            raise ValueError("Not a variable font")
        axes = {a.axisTag: (a.minValue, a.defaultValue, a.maxValue) for a in self.axes}
        out = normalize_location(location, axes)
        avar = self._variation_tables()[0]
        return avar.renormalize(out) if avar is not None else out

    def _variation_tables(self):
        """(avar, gvar, HVAR's store, HVAR's advance map), each None where
        the face has no such table, read on first use."""
        if self._var_tables is None:
            tags = [a.axisTag for a in self.axes]
            avar = gvar = store = adv_map = None
            if "avar" in self.tables and "fvar" in self.tables:
                avar = Avar(self.data, self.tables["avar"][0], tags)
            if "gvar" in self.tables and "fvar" in self.tables:
                gvar = Gvar(self.data, self.tables["gvar"][0], tags)
            if "HVAR" in self.tables and "fvar" in self.tables:
                pos, length = self._table("HVAR", 20)
                store_off, adv_off = struct.unpack_from(">II", self.data, pos + 4)
                store = ItemVariationStore(self.data, pos + store_off, tags, pos + length,
                                           "'HVAR' ItemVariationStore")
                if adv_off:
                    adv_map = var_idx_map(self.data, pos + adv_off, self.num_glyphs)
            self._var_tables = (avar, gvar, store, adv_map)
        return self._var_tables

    def advance_at(self, gid: int, location: Optional[Dict[str, float]]):
        """The advance a glyph set at a normalized location gives
        (_TTGlyph.width): hmtx's, plus HVAR's delta when the face has HVAR
        and the location is not empty."""
        width = int(self.advances[gid])
        if location:
            _avar, _gvar, store, adv_map = self._variation_tables()
            if store is not None:
                key = tuple(location.items())
                inst = self._hvar_instancers.get(key)
                if inst is None:
                    inst = self._hvar_instancers[key] = store.instancer(location)
                width += inst[gid if adv_map is None else adv_map[gid]]
        return width

    def phantom_advance(self, gid: int, location: Dict[str, float]) -> int:
        """The advance of a gvar instance's phantom points (otRound of right
        minus left), which fontTools sets on a glyph of an instanced glyph
        set without HVAR once the glyph is drawn."""
        coords = self._instance(gid, location)[0]
        return ot_round(coords[-3][0] - coords[-4][0])

    # --- outlines ------------------------------------------------------------------

    def _read_loca(self) -> np.ndarray:
        """loca as fontTools' glyf table reads it with its glyphs, when a
        glyph set is made: each glyph's data must lie within glyf (an entry
        before the one above it, or past glyf's end, is refused; one glyph
        between two entries past the end is empty)."""
        if "loca" not in self.tables:
            raise ValueError("a glyf face without a 'loca' table")
        loca, length = self._table("loca")
        glyf_len = self._table("glyf")[1]
        short = self.index_to_loc_format == 0
        if length % (2 if short else 4):
            raise ValueError(f"malformed 'loca' table: {length} bytes")
        offsets = np.frombuffer(self.data, dtype=">u2" if short else ">u4",
                                count=length // (2 if short else 4), offset=loca).astype(np.int64)
        if short:
            offsets *= 2
        start, end = offsets[:-1], offsets[1:]
        if ((end < start) | ((end > glyf_len) & (end != start))).any():
            raise ValueError("not enough 'glyf' table data")
        return offsets

    def _check_gvar(self) -> None:
        """fontTools' gvar decompile, which a glyf face's glyph set runs: its
        header, its axis count against fvar's, its shared tuples and a glyph
        count within the glyph order."""
        if "gvar" not in self.tables:
            return
        pos, length = self._table("gvar", 20)
        if "fvar" not in self.tables:
            raise ValueError("a 'gvar' table without 'fvar'")
        axis_count, shared, shared_off, glyph_count = struct.unpack_from(">HHIH", self.data,
                                                                         pos + 4)
        if axis_count != len(self.axes):
            raise ValueError("malformed 'gvar' table: its axis count is not fvar's")
        if shared and shared_off + 2 * axis_count * shared > length:
            raise ValueError("malformed 'gvar' table: its shared tuples run past it")
        if glyph_count > len(self.glyph_order):
            raise ValueError("malformed 'gvar' table: more glyphs than the face")

    def _glyph(self, gid: int) -> tuple:
        """The parsed glyf entry: ("empty",), ("simple", xs, ys, end_pts,
        flags, x_min) or ("composite", [(component gid, transform)],
        x_min)."""
        g = self._glyphs.get(gid)
        if g is not None:
            return g
        if self._loca is None:
            raise ValueError("a face with neither glyf/loca nor CFF outlines")
        if not 0 <= gid < min(self.num_glyphs, len(self._loca) - 1):
            raise ValueError(f"glyph {gid} is not in 'glyf' ({len(self._loca) - 1} entries, "
                             f"{self.num_glyphs} glyphs)")
        glyf = self.tables["glyf"][0]
        start, end = glyf + int(self._loca[gid]), glyf + int(self._loca[gid + 1])
        if end <= start:
            g = ("empty",)
        else:
            # fontTools decompiles a glyph from its own bytes: every read
            # below is bounded by them (_read_loca keeps them in the file)
            body = self.data[start:end]
            if len(body) < 10:
                raise ValueError(f"malformed 'glyf' glyph {gid}: no header")
            n_contours, x_min = struct.unpack_from(">hh", body)
            if n_contours >= 0:
                g = self._simple_glyph(body[10:], n_contours, x_min)
            elif n_contours == -1:
                g = self._composite_glyph(body[10:], x_min)
            else:  # fontTools takes it for a simple glyph of a negative count
                raise ValueError(f"malformed 'glyf' glyph {gid}: {n_contours} contours")
        self._glyphs[gid] = g
        return g

    @staticmethod
    def _simple_glyph(g: bytes, n_contours: int, x_min: int) -> tuple:
        """Glyph.decompileCoordinates on the bytes after the header: the
        instruction length signed, the flags' repeats held to the points,
        the coordinates' bytes whole (ValueError where fontTools' unpacking
        fails)."""
        if n_contours == 0:
            return ("simple", [], [], [], [], x_min)
        pos = 2 * n_contours
        if len(g) < pos + 2:
            raise ValueError("malformed 'glyf' glyph: its end points run past it")
        end_pts = list(struct.unpack_from(">%dH" % n_contours, g))
        pos += 2 + struct.unpack_from(">h", g, pos)[0]  # past the instructions
        n_points = end_pts[-1] + 1
        flags: List[int] = []
        while len(flags) < n_points:
            f = _byte_at(g, pos)
            pos += 1
            repeat = 1
            if f & _REPEAT:
                repeat = _byte_at(g, pos) + 1
                pos += 1
            if len(flags) + repeat > n_points:
                raise ValueError("malformed 'glyf' glyph: its flags repeat past its points")
            flags.extend([f] * repeat)
        x_len = sum(1 if f & _X_SHORT else 0 if f & _X_SAME else 2 for f in flags)
        y_len = sum(1 if f & _Y_SHORT else 0 if f & _Y_SAME else 2 for f in flags)
        xb, yb = g[pos: pos + x_len], g[pos + x_len: pos + x_len + y_len]
        if len(xb) != x_len or len(yb) != y_len:
            raise ValueError("malformed 'glyf' glyph: its coordinates run past it")
        xs = _coords(flags, xb, _X_SHORT, _X_SAME)
        ys = _coords(flags, yb, _Y_SHORT, _Y_SAME)
        keep = [f & (_ON_CURVE | 0x40 | _CUBIC) for f in flags]
        return ("simple", xs, ys, end_pts, keep, x_min)

    @staticmethod
    def _composite_glyph(g: bytes, x_min: int) -> tuple:
        """Glyph.decompileComponents on the bytes after the header, the
        instruction length's 2 bytes included."""
        comps = []
        pos, instructions = 0, False

        def read(fmt: str):
            nonlocal pos
            size = struct.calcsize(fmt)
            if pos + size > len(g):
                raise ValueError("malformed 'glyf' composite: a component runs past it")
            pos += size
            return struct.unpack_from(fmt, g, pos - size)

        while True:
            flags, gid = read(">HH")
            if flags & _ARG_WORDS:
                a, b = read(">hh" if flags & _ARGS_XY else ">HH")
            else:
                a, b = read(">bb" if flags & _ARGS_XY else ">BB")
            if not flags & _ARGS_XY:
                raise NotImplementedError(
                    "composite glyphs placed by point matching are not read by "
                    "the port's OpenType reader; fontTools 4.61.1 does not draw them "
                    "either (GlyphComponent.getComponentInfo raises AttributeError)")
            if flags & _HAVE_SCALE:
                s = _f2dot14(read(">h")[0])
                trans = (s, 0, 0, s, a, b)
            elif flags & _HAVE_XY_SCALE:
                sx, sy = read(">hh")
                trans = (_f2dot14(sx), 0, 0, _f2dot14(sy), a, b)
            elif flags & _HAVE_2X2:
                xx, xy, yx, yy = read(">hhhh")
                trans = (_f2dot14(xx), _f2dot14(xy), _f2dot14(yx), _f2dot14(yy), a, b)
            else:
                trans = (1, 0, 0, 1, a, b)
            instructions = instructions or bool(flags & _HAVE_INSTRUCTIONS)
            comps.append((gid, trans))
            if not flags & _MORE_COMPONENTS:
                if instructions:
                    read(">h")
                return ("composite", comps, x_min)

    def _instance(self, gid: int, location: Dict[str, float]):
        """glyf._getCoordinatesAndControls moved by gvar at `location`: the
        (N + 4, 2) float64 points (a simple glyph's points, or a
        composite's component offsets, then the four phantom points) and
        the parsed glyph."""
        g = self._glyph(gid)
        if g[0] == "simple":
            pts = list(zip(g[1], g[2]))
            ends, x_min = g[3], g[5]
        elif g[0] == "composite":
            pts = [trans[4:] for _cgid, trans in g[1]]
            ends, x_min = list(range(len(pts))), g[2]
        else:
            pts, ends, x_min = [], [], 0
        left = x_min - int(self.lsbs[gid])
        pts += [(left, 0), (left + int(self.advances[gid]), 0), (0, 0), (0, 0)]
        coords = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        gvar = self._variation_tables()[1]
        variations = gvar.variations(gid, len(coords))
        return instance_coordinates(coords, variations, location, ends), g

    def varc(self) -> Optional[VarcTable]:
        """The VARC table, read on first use; None without one."""
        if self._varc is None:
            self._varc = False
            if "VARC" in self.tables:
                self._varc = VarcTable(self.data, self.tables["VARC"][0],
                                       [a.axisTag for a in self.axes], self.num_glyphs)
        return self._varc or None

    def glyph_path(self, gid: int, location: Optional[Dict[str, float]] = None) -> list:
        """The glyph's outline as fontTools' DecomposingRecordingPen value
        list (font units, y up), drawn as TTFont.getGlyphSet(location=...)
        draws it: a glyph in VARC's Coverage as variable composites
        (text/varc.py), else CFF/CFF2 charstrings (blended at a non-empty
        normalized location), else glyf (a simple glyph at depth 0 shifted
        by its lsb minus its xMin; moved by gvar at a non-empty location,
        the face's or one a VARC component pushed)."""
        out: list = []
        self._draw_from_set(gid, (), _DrawState(location), out)
        return out

    def _draw_from_set(self, gid: int, chain: tuple, state: "_DrawState", out: list) -> None:
        """glyphSet[name].draw(pen) of the face's glyph set: the VARC glyph
        set when the face has VARC, which draws a glyph in its Coverage as
        VARC and passes any other to the outline glyph set. `chain` holds
        the pen's TransformPens, innermost first."""
        varc = self.varc()
        if varc is not None and gid in varc.coverage:
            if self.cff is not None:
                raise NotImplementedError(
                    "VARC glyphs over CFF or CFF2 outlines are not drawn by the port: "
                    "fontTools 4.61.1's CFF glyph set keeps the blend location of the "
                    "last VARC component it drew, so figdraw_tpu's outlines depend on "
                    "the order glyphs are drawn in")
            varc.draw(self, gid, chain, state, out)
        else:
            self._draw_outline(gid, chain, state, out)

    def _draw_outline(self, gid: int, chain: tuple, state: "_DrawState", out: list) -> None:
        """The outline glyph set's glyph (CFF/CFF2, else glyf) onto `out`
        through the pen chain."""
        if self.cff is None:
            self._draw_glyf(gid, chain, state, out)
            return
        inst = None
        if state.loc and self.cff.store is not None:
            inst = self.cff.store.instancer(state.loc)
        recorded = [] if chain else out
        self.cff.draw(gid, recorded, inst, self._name_to_gid.get)
        if chain:
            emit(recorded, chain, out)

    def _draw_glyf(self, gid: int, chain: tuple, state: "_DrawState", out: list) -> None:
        """_TTGlyphGlyf.draw: the glyph from glyf, or at a non-empty location
        _getGlyphInstance's glyph (points or component offsets from gvar);
        at depth 0 a simple glyph shifted by its lsb minus its xMin (an
        instance's recomputed ones); a composite's components through the
        face's glyph set (DecomposingPen.addComponent) one depth down, each
        transform composed through the pen chain's (TransformPen's
        addComponent)."""
        loc = state.loc
        instanced = bool(loc) and self._variation_tables()[1] is not None
        if instanced:
            coords, g = self._instance(gid, loc)
        else:
            g = self._glyph(gid)
        if g[0] == "empty":
            return
        if g[0] == "composite":
            state.depth += 1
            try:
                for k, (cgid, ctrans) in enumerate(g[1]):
                    if instanced:
                        x, y = coords[k].tolist()
                        ctrans = ctrans[:4] + (_maybe_int(x), _maybe_int(y))
                    for t in chain:
                        ctrans = _compose(t, ctrans)
                    sub = () if tuple(ctrans) == _IDENTITY else (ctrans,)
                    self._draw_from_set(cgid, sub, state, out)
            finally:
                state.depth -= 1
            return
        _, xs, ys, end_pts, flags, x_min = g
        top = state.depth == 0
        if instanced:
            pts = coords[:-4]
            if top and len(pts):
                x_min = ot_round(float(pts[:, 0].min()))
                offset = ot_round(x_min - float(coords[-4, 0])) - x_min
                if offset:
                    pts = pts + np.array([offset, 0.0])
            pts = [(_maybe_int(x), _maybe_int(y)) for x, y in pts.tolist()]
        else:
            offset = int(self.lsbs[gid]) - x_min if top else 0
            pts = list(zip([x + offset for x in xs] if offset else xs, ys))
        if not chain:
            _trace_contours(pts, end_pts, flags, out)
            return
        recorded: list = []
        _trace_contours(pts, end_pts, flags, recorded)
        emit(recorded, chain, out)


class _DrawState:
    """The glyph sets' drawing state for one glyph_path: the location both
    glyph sets draw at (VARC components push and pop it), the original one
    a reset component restarts from, and the glyf set's depth."""

    __slots__ = ("loc", "original", "depth")

    def __init__(self, location: Optional[Dict[str, float]]):
        self.original = dict(location) if location else {}
        self.loc = self.original
        self.depth = 0


def _maybe_int(v: float):
    """GlyphCoordinates' item: an integral float as an int."""
    return int(v) if v.is_integer() else v


def _compose(outer, inner):
    """fontTools' Transform(outer).transform(inner): inner applied first."""
    xx1, xy1, yx1, yy1, dx1, dy1 = inner
    xx2, xy2, yx2, yy2, dx2, dy2 = outer
    return (xx1 * xx2 + xy1 * yx2, xx1 * xy2 + xy1 * yy2,
            yx1 * xx2 + yy1 * yx2, yx1 * xy2 + yy1 * yy2,
            xx2 * dx1 + yx2 * dy1 + dx2, xy2 * dx1 + yy2 * dy1 + dy2)


def _mid(a, b):
    """fontTools' maybeInt((a + b) * 0.5)."""
    v = (a + b) * 0.5
    return int(v) if v == int(v) else v


def _byte_at(g: bytes, pos: int) -> int:
    """g[pos] with Python's indexing, as fontTools reads a glyph's flags;
    ValueError past its bytes."""
    if not -len(g) <= pos < len(g):
        raise ValueError("malformed 'glyf' glyph: its flags run past it")
    return g[pos]


def _coords(flags, b: bytes, short: int, same: int) -> list:
    """One axis of a simple glyph's coordinates from its bytes b, summed."""
    out, v, pos = [], 0, 0
    for f in flags:
        if f & short:
            d = b[pos]
            pos += 1
            v += d if f & same else -d
        elif not f & same:
            v += _I16(b, pos)[0]
            pos += 2
        out.append(v)
    return out


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
        if not contour:
            raise ValueError("an empty glyf contour (fontTools' Glyph.draw fails on one)")
        if 1 not in c_flags:
            if any(cu_flags) and not all(cu_flags):
                raise ValueError("a glyf contour mixes cubic and quadratic off-curves")
            if cu_flags and all(cu_flags):
                count = len(contour)
                if count % 2:
                    raise ValueError("Odd number of cubic off-curves undefined")
                last, first = contour[-1], contour[0]
                out.append(("moveTo", ((_mid(last[0], first[0]), _mid(last[1], first[1])),)))
                for i in range(0, count, 2):
                    p1, p2 = contour[i], contour[i + 1]
                    p4 = contour[i + 2 if i + 2 < count else 0]
                    out.append(("curveTo", (p1, p2, (_mid(p2[0], p4[0]),
                                                     _mid(p2[1], p4[1])))))
            else:
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
                    cubic = cu_flags[: next_on - 1]
                    if any(cubic) and not all(cubic):
                        raise ValueError("Mixed cubic and quadratic segment undefined")
                    if any(cubic):
                        count = next_on
                        if count < 3 or (count - 1) % 2:
                            raise ValueError("a cubic glyf segment needs an even "
                                             "number (at least two) of off-curves")
                        for i in range(0, count - 3, 2):
                            p1, p2, p4 = contour[i], contour[i + 1], contour[i + 2]
                            out.append(("curveTo", (p1, p2, (_mid(p2[0], p4[0]),
                                                             _mid(p2[1], p4[1])))))
                        out.append(("curveTo", tuple(contour[count - 3 : count])))
                    else:
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
