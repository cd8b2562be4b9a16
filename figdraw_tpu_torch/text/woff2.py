"""WOFF 2.0 for the port's OpenType reader: a .woff2 file turned back into
the sfnt it wraps, as fontTools 4.61.1's WOFF2Reader reads it
(ttLib/woff2.py: WOFF2Reader, WOFF2DirectoryEntry, WOFF2LocaTable,
WOFF2GlyfTable.reconstruct, WOFF2HmtxTable.reconstruct, UIntBase128 and
255UInt16), with the port's own Brotli decoder (utils/brotli.py):

- the 48-byte header and the table directory: a known tag's index or an
  arbitrary tag, UIntBase128 lengths (no leading zero byte, at most five
  bytes, under 2^32), a transformLength for a transformed table (0 for
  loca), the transform version (3 is glyf's and loca's null transform, 0
  every other table's);
- one Brotli stream for all the tables, whose size must be the sum of their
  lengths, and the file's length as the header states it; the metadata
  block decompressed to its stated size, as fontTools checks at load;
- the transformed glyf table: the nContour, nPoints, flag, glyph, composite,
  bbox and instruction streams, the triplet encoding of the points, the
  bbox bitmap (an explicit bbox where its bit is set, else the points'
  bounds; a composite must have one), and the overlap-simple bitmap (bit 6
  of a glyph's first flag);
- loca rebuilt from the glyphs, in the glyf table's indexFormat and of the
  size the directory states;
- the transformed hmtx table: left side bearings taken from each glyph's
  xMin where the flags say their array is absent, written as fontTools
  compiles hmtx (trailing advances equal to the last folded away);
- the null transforms, passed through.

The rebuilt glyphs are written plainly (each point its own flag, one or two
bytes a coordinate) and need not be fontTools' bytes: the outlines, bounds,
advances and side bearings read from them are. A WOFF2 collection (flavor
"ttcf") raises ValueError: fontTools' reader has no collection directory
either. Every fault fontTools raises on raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils import brotli
from .woff import _sfnt

WOFF2_SIGNATURE = b"wOF2"
KNOWN_TAGS = (
    "cmap", "head", "hhea", "hmtx", "maxp", "name", "OS/2", "post", "cvt ", "fpgm", "glyf",
    "loca", "prep", "CFF ", "VORG", "EBDT", "EBLC", "gasp", "hdmx", "kern", "LTSH", "PCLT",
    "VDMX", "vhea", "vmtx", "BASE", "GDEF", "GPOS", "GSUB", "EBSC", "JSTF", "MATH", "CBDT",
    "CBLC", "COLR", "CPAL", "SVG ", "sbix", "acnt", "avar", "bdat", "bloc", "bsln", "cvar",
    "fdsc", "feat", "fmtx", "fvar", "gvar", "hsty", "just", "lcar", "mort", "morx", "opbd",
    "prop", "trak", "Zapf", "Silf", "Glat", "Gloc", "Feat", "Sill")

_HEADER = struct.Struct(">4s4sIHHIIHHIIIII")  # 48 bytes
_GLYF_HEADER = struct.Struct(">HHHHIIIIIII")  # 36 bytes
OVERLAP_SIMPLE = 0x40  # a simple glyph's first flag: its contours may overlap
# a composite component's flags
ARG_1_AND_2_ARE_WORDS, WE_HAVE_A_SCALE, MORE_COMPONENTS = 0x0001, 0x0008, 0x0020
WE_HAVE_AN_X_AND_Y_SCALE, WE_HAVE_A_TWO_BY_TWO, WE_HAVE_INSTRUCTIONS = 0x0040, 0x0080, 0x0100


def _fail(what: str):
    raise ValueError(f"WOFF2 font: {what}")


def base128(data: bytes, at: int) -> tuple:
    """(value, next offset) of a UIntBase128 at data[at]."""
    if at >= len(data):
        _fail("not enough data to unpack UIntBase128")
    if data[at] == 0x80:
        _fail("UIntBase128 value must not start with leading zeros")
    value = 0
    for i in range(5):
        if at + i >= len(data):
            _fail("not enough data to unpack UIntBase128")
        code = data[at + i]
        if value & 0xFE000000:
            _fail("UIntBase128 value exceeds 2**32-1")
        value = (value << 7) | (code & 0x7F)
        if not code & 0x80:
            return value, at + i + 1
    _fail("UIntBase128-encoded sequence is longer than 5 bytes")


def u255(data: bytes, at: int) -> tuple:
    """(value, next offset) of a 255UInt16 at data[at]."""
    if at >= len(data):
        _fail("not enough data to unpack 255UInt16")
    code = data[at]
    if code == 253:
        if at + 3 > len(data):
            _fail("not enough data to unpack 255UInt16")
        return (data[at + 1] << 8) | data[at + 2], at + 3
    if code in (254, 255):
        if at + 2 > len(data):
            _fail("not enough data to unpack 255UInt16")
        return data[at + 1] + (506 if code == 254 else 253), at + 2
    return code, at + 1


def directory(data: bytes) -> tuple:
    """(header fields, [(tag, flags, origLength, length, transformed)], the
    offset past the directory) of a WOFF2 file."""
    if len(data) < _HEADER.size:
        _fail("not a WOFF2 font (not enough data)")
    head = _HEADER.unpack_from(data, 0)
    if head[0] != WOFF2_SIGNATURE:
        _fail("not a WOFF2 font (bad signature)")
    if head[1] == b"ttcf":
        _fail("a WOFF2 font collection (flavor 'ttcf'), which fontTools' reader does not "
              "read either")
    at, entries = _HEADER.size, []
    for _ in range(head[3]):
        if at >= len(data):
            _fail("can't read table 'flags': not enough data")
        flags = data[at]
        at += 1
        if flags & 0x3F == 0x3F:
            if at + 4 > len(data):
                _fail("can't read table 'tag': not enough data")
            tag = data[at: at + 4].decode("latin1")
            at += 4
        else:
            tag = KNOWN_TAGS[flags & 0x3F]
        orig, at = base128(data, at)
        version = flags >> 6
        transformed = version != 3 if tag in ("glyf", "loca") else version != 0
        length = orig
        if transformed:
            length, at = base128(data, at)
            if tag == "loca" and length != 0:
                _fail("the transformLength of the 'loca' table must be 0")
        entries.append((tag, flags, orig, length, transformed))
    return head, entries, at


def woff2_to_sfnt(data: bytes) -> bytes:
    """The sfnt a WOFF 2.0 file wraps, its tables decompressed and
    reconstructed."""
    data = bytes(data)
    head, entries, at = directory(data)
    (_sig, flavor, length, _n, _reserved, _sfnt_size, compressed_size, _major, _minor,
     meta_offset, meta_length, meta_orig, priv_offset, priv_length) = head
    total = sum(e[3] for e in entries)
    try:
        stream = brotli.decompress(data[at: at + compressed_size], total)
    except ValueError as err:
        _fail(f"the tables' {err}")
    if len(stream) != total:
        _fail(f"unexpected size for decompressed font data: expected {total}, found "
              f"{len(stream)}")
    if length != len(data):
        _fail("reported 'length' doesn't match the actual file size")
    if meta_length:
        raw = data[meta_offset: meta_offset + meta_length]
        if len(raw) != meta_length:
            _fail("the metadata block runs past the end")
        try:
            meta = brotli.decompress(raw, meta_orig)
        except ValueError as err:
            _fail(f"the metadata block's {err}")
        if len(meta) != meta_orig:
            _fail("the metadata block is cut or decompresses to another size")
    if priv_length and len(data[priv_offset: priv_offset + priv_length]) != priv_length:
        _fail("the private data block runs past the end")
    raw, offset = {}, 0
    for tag, _flags, _orig, size, transformed in entries:
        raw[tag] = (stream[offset: offset + size], transformed)
        offset += size
    tables = {tag: body for tag, (body, transformed) in raw.items() if not transformed}
    for tag, (_body, transformed) in raw.items():
        if transformed and tag not in ("glyf", "loca", "hmtx"):
            _fail(f"transform for table '{tag}' is unknown")
    glyf = None
    if "glyf" in raw and raw["glyf"][1]:
        glyf = _Glyf(raw["glyf"][0], tables)
        tables["glyf"], loca = glyf.compile()
        if "loca" in raw:
            if not raw["loca"][1]:
                _fail("a transformed glyf table beside an untransformed loca")
            orig = next(e[2] for e in entries if e[0] == "loca")
            if len(loca) != orig:
                _fail(f"reconstructed 'loca' table doesn't match original size: expected "
                      f"{orig}, found {len(loca)}")
            tables["loca"] = loca
    elif "loca" in raw and raw["loca"][1]:
        _fail("a transformed loca table beside an untransformed glyf")
    if "hmtx" in raw and raw["hmtx"][1]:
        xmins = glyf.xmins if glyf is not None else _stored_xmins(tables)
        tables["hmtx"] = _hmtx(raw["hmtx"][0], tables, xmins)
    return _sfnt(flavor, {tag.encode("latin1"): (_checksum(body), body)
                          for tag, body in tables.items()})


def _checksum(body: bytes) -> int:
    words = np.frombuffer(body + b"\0" * (-len(body) % 4), ">u4")
    return int(words.sum(dtype=np.uint64) & 0xFFFFFFFF)


class _Glyf:
    """A transformed glyf table (WOFF2GlyfTable.reconstruct)."""

    def __init__(self, data: bytes, tables: dict):
        if len(data) < _GLYF_HEADER.size:
            _fail("not enough 'glyf' data")
        (_version, options, self.num_glyphs, self.index_format, *sizes) = \
            _GLYF_HEADER.unpack_from(data, 0)
        at, streams = _GLYF_HEADER.size, []
        for size in sizes:
            streams.append(data[at: at + size])
            at += size
        self.overlap = None
        if options & 1:
            self.overlap = data[at: at + (self.num_glyphs + 7) // 8]
            at += (self.num_glyphs + 7) // 8
        if at != len(data):
            _fail(f"incorrect size of transformed 'glyf' table: expected {at}, received "
                  f"{len(data)} bytes")
        (ncontour, self.npoints, self.flags, self.glyph, self.composite, bbox,
         self.instructions) = streams
        bitmap_size = ((self.num_glyphs + 31) >> 5) << 2
        self.bbox_bitmap, self.bbox = bbox[:bitmap_size], bbox[bitmap_size:]
        if len(ncontour) != 2 * self.num_glyphs:
            _fail("the nContour stream does not hold one value a glyph")
        self.ncontours = np.frombuffer(ncontour, ">i2").astype(np.int64)
        if "maxp" in tables and len(tables["maxp"]) >= 6:
            if struct.unpack_from(">H", tables["maxp"], 4)[0] != self.num_glyphs:
                _fail(f"incorrect glyphOrder: the glyf table holds {self.num_glyphs} glyphs, "
                      "maxp another number")

    def _has_bbox(self, gid: int) -> bool:
        byte = gid >> 3
        return byte < len(self.bbox_bitmap) and bool(self.bbox_bitmap[byte] & (0x80 >> (gid & 7)))

    def compile(self) -> tuple:
        """(glyf bytes, loca bytes); sets self.xmins."""
        n = self.num_glyphs
        npoints, flag_at, glyph_at, comp_at, bbox_at, instr_at = self.npoints, 0, 0, 0, 0, 0
        # each flag's triplet bytes, and their running sum through the flag stream
        fl = np.frombuffer(self.flags, np.uint8).astype(np.int64) & 0x7F
        nbytes = _triplet_bytes(fl)
        before = np.concatenate([[0], np.cumsum(nbytes)])
        gstream = self.glyph
        simple = []  # (gid, first flag, points, first triplet byte, contour ends)
        records, xmins = [None] * n, [0] * n
        np_at = 0
        for gid in range(n):
            nc = int(self.ncontours[gid])
            if nc == 0:
                records[gid] = b""
                continue
            if nc == -1:
                records[gid], comp_at, glyph_at, instr_at, bbox_at = self._composite(
                    gid, comp_at, glyph_at, instr_at, bbox_at)
                xmins[gid] = struct.unpack_from(">h", records[gid], 2)[0]
                continue
            if nc < 0:
                _fail(f"glyph {gid} has {nc} contours")
            ends, end = [], -1
            for _c in range(nc):
                pts, np_at = u255(npoints, np_at)
                end += pts
                ends.append(end)
            count = ends[-1] + 1
            if count < 0 or flag_at + count > len(self.flags):
                _fail("not enough 'flagStream' data")
            used = int(before[flag_at + count] - before[flag_at])
            if glyph_at + used > len(gstream):
                _fail("the glyph stream runs out inside a glyph's triplets")
            simple.append((gid, flag_at, count, glyph_at, ends))
            flag_at += count
            glyph_at += used
            ilen, glyph_at = u255(gstream, glyph_at)
            instr = self.instructions[instr_at: instr_at + ilen]
            instr_at += ilen
            box = None
            if self._has_bbox(gid):
                if bbox_at + 8 > len(self.bbox):
                    _fail("the bbox stream runs out")
                box = struct.unpack_from(">hhhh", self.bbox, bbox_at)
                bbox_at += 8
            records[gid] = (instr, box)
        flat = _Points(self.glyph, fl, nbytes, simple, self.flags)
        for k, (gid, first, count, _g, ends) in enumerate(simple):
            instr, box = records[gid]
            if box is None:
                box = flat.bounds(k)
            overlap = self.overlap is not None and bool(
                self.overlap[gid >> 3] & (0x80 >> (gid & 7)))
            try:
                head = struct.pack(f">hhhhh{len(ends)}HH", len(ends), *box, *ends, len(instr))
            except struct.error:
                _fail(f"glyph {gid}'s bounds or contour ends past 16 bits")
            records[gid] = head + instr + flat.record(first, count, overlap)
            xmins[gid] = box[0]
        self.xmins = xmins
        return _glyf_and_loca(records, self.index_format)

    def _composite(self, gid, comp_at, glyph_at, instr_at, bbox_at) -> tuple:
        """A composite glyph's record: its components copied from the
        composite stream, its instructions, its bbox (which it must
        have)."""
        data, start, more, have_instr = self.composite, comp_at, True, False
        while more:
            if comp_at + 4 > len(data):
                _fail("the composite stream runs out")
            flags = struct.unpack_from(">H", data, comp_at)[0]
            size = 4 + (4 if flags & ARG_1_AND_2_ARE_WORDS else 2)
            size += (2 if flags & WE_HAVE_A_SCALE else 4 if flags & WE_HAVE_AN_X_AND_Y_SCALE
                     else 8 if flags & WE_HAVE_A_TWO_BY_TWO else 0)
            if comp_at + size > len(data):
                _fail("the composite stream runs out")
            comp_at += size
            more = bool(flags & MORE_COMPONENTS)
            have_instr = have_instr or bool(flags & WE_HAVE_INSTRUCTIONS)
        body = data[start: comp_at]
        if have_instr:
            ilen, glyph_at = u255(self.glyph, glyph_at)
            body += struct.pack(">H", ilen) + self.instructions[instr_at: instr_at + ilen]
            instr_at += ilen
        if not self._has_bbox(gid):
            _fail(f"no bbox values for composite glyph {gid}")
        if bbox_at + 8 > len(self.bbox):
            _fail("the bbox stream runs out")
        box = self.bbox[bbox_at: bbox_at + 8]
        return struct.pack(">h", -1) + box + body, comp_at, glyph_at, instr_at, bbox_at + 8


def _triplet_bytes(fl: np.ndarray) -> np.ndarray:
    """The glyph-stream bytes of each point's triplet, by its flag."""
    return np.where(fl < 84, 1, np.where(fl < 120, 2, np.where(fl < 124, 3, 4)))


class _Points:
    """Every simple glyph's points at once, in flag-stream order (the
    glyphs' flags follow one another from the stream's start): their
    deltas from the triplets, their coordinates, and their flags and
    coordinate bytes as a glyf table stores them (each point its own flag;
    a delta of 0 as the same flag and no byte, one under 256 as the short
    flag with the same flag for + and one byte, else two bytes)."""

    def __init__(self, glyph: bytes, fl: np.ndarray, nbytes: np.ndarray, simple: list,
                 flags: bytes):
        counts = [c for _g, _f, c, _s, _e in simple]
        total = sum(counts)
        f, nb = fl[:total], nbytes[:total]
        self.firsts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        # each point's first triplet byte: its glyph's start, then its own run
        starts = np.repeat(np.array([s for _g, _f, _c, s, _e in simple], np.int64), counts)
        run = np.cumsum(nb) - nb
        at = starts + run - np.repeat(run[self.firsts[:-1][np.array(counts) > 0]]
                                      if total else run[:0], [c for c in counts if c])
        g = np.frombuffer(glyph + b"\0" * 4, np.uint8).astype(np.int64)
        t0, t1, t2, t3 = g[at], g[at + 1], g[at + 2], g[at + 3]
        sx = np.where(f & 1, 1, -1)
        sy = np.where((f >> 1) & 1, 1, -1)
        b0, b84 = f - 20, f - 84
        classes = [f < 10, f < 20, f < 84, f < 120, f < 124]
        dx = np.select(classes, [0 * f, sx * ((((f - 10) & 14) << 7) + t0),
                                 sx * (1 + (b0 & 0x30) + (t0 >> 4)),
                                 sx * (1 + ((b84 // 12) << 8) + t0),
                                 sx * ((t0 << 4) + (t1 >> 4))], sx * ((t0 << 8) + t1))
        dy = np.select(classes, [sx * (((f & 14) << 7) + t0), 0 * f,
                                 sy * (1 + ((b0 & 0x0C) << 2) + (t0 & 0x0F)),
                                 sy * (1 + (((b84 % 12) >> 2) << 8) + t1),
                                 sy * (((t1 & 0x0F) << 8) + t2)], sy * ((t2 << 8) + t3))
        if total and max(np.abs(dx).max(), np.abs(dy).max()) > 32767:
            _fail("a point's delta past 16 bits")
        cx, cy = np.cumsum(dx), np.cumsum(dy)
        self.xs = cx - np.repeat(np.concatenate([[0], cx])[self.firsts[:-1]], counts)
        self.ys = cy - np.repeat(np.concatenate([[0], cy])[self.firsts[:-1]], counts)
        on = (np.frombuffer(flags[:total], np.uint8) >> 7) == 0
        fx, self.bx, self.px = _axis_bytes(dx, 0x02, 0x10)
        fy, self.by, self.py = _axis_bytes(dy, 0x04, 0x20)
        self.flag_bytes = (on.astype(np.uint8) | fx | fy).tobytes()

    def bounds(self, k: int) -> tuple:
        """(xMin, yMin, xMax, yMax) of simple glyph k's points."""
        a, b = self.firsts[k], self.firsts[k + 1]
        if a == b:
            return 0, 0, 0, 0
        x, y = self.xs[a:b], self.ys[a:b]
        return int(x.min()), int(y.min()), int(x.max()), int(y.max())

    def record(self, first: int, count: int, overlap: bool) -> bytes:
        """The flags and coordinates of a glyph's points."""
        flags = self.flag_bytes[first: first + count]
        if overlap and count:
            flags = bytes([flags[0] | OVERLAP_SIMPLE]) + flags[1:]
        return (flags + self.bx[self.px[first]: self.px[first + count]]
                + self.by[self.py[first]: self.py[first + count]])


def _axis_bytes(d: np.ndarray, short: int, same: int) -> tuple:
    """(flag bits, the bytes of every point, each point's first byte) of one
    axis' deltas."""
    is_short = (d != 0) & (np.abs(d) < 256)
    wide = (d != 0) & ~is_short
    bits = np.where(d == 0, same, np.where(is_short, short | np.where(d > 0, same, 0), 0))
    pos = np.concatenate([[0], np.cumsum(np.where(d == 0, 0, np.where(is_short, 1, 2)))])
    buf = np.zeros(int(pos[-1]), np.uint8)
    buf[pos[:-1][is_short]] = np.abs(d[is_short])
    w = d[wide].astype(">i2").view(np.uint8).reshape(-1, 2)
    buf[pos[:-1][wide]] = w[:, 0]
    buf[pos[:-1][wide] + 1] = w[:, 1]
    return bits.astype(np.uint8), buf.tobytes(), pos.tolist()


def _glyf_and_loca(records, index_format: int) -> tuple:
    """The glyf table of the records (each padded to an even length in the
    short loca format) and its loca table."""
    offsets, body = [0], bytearray()
    for rec in records:
        if index_format == 0 and len(rec) % 2:
            rec += b"\0"
        body += rec
        offsets.append(len(body))
    if index_format == 0:
        if offsets[-1] >= 0x20000:
            _fail("indexFormat is 0 but local offsets > 0x20000")
        loca = np.array(offsets, np.int64) // 2
        loca_bytes = loca.astype(">u2").tobytes()
    else:
        loca_bytes = np.array(offsets, np.int64).astype(">u4").tobytes()
    return bytes(body) or b"\0", loca_bytes


def _stored_xmins(tables: dict) -> list:
    """Each glyph's xMin from an untransformed glyf and loca (0 for an
    empty glyph)."""
    for tag in ("head", "maxp", "glyf", "loca"):
        if tag not in tables:
            _fail(f"a transformed hmtx table without '{tag}'")
    n = struct.unpack_from(">H", tables["maxp"], 4)[0]
    long_loca = struct.unpack_from(">h", tables["head"], 50)[0]
    loca = tables["loca"]
    if long_loca:
        offs = np.frombuffer(loca[: 4 * (n + 1)], ">u4").astype(np.int64)
    else:
        offs = np.frombuffer(loca[: 2 * (n + 1)], ">u2").astype(np.int64) * 2
    if len(offs) != n + 1:
        _fail("the loca table is short")
    glyf = tables["glyf"]
    return [struct.unpack_from(">h", glyf, int(offs[g]) + 2)[0] if offs[g + 1] > offs[g] else 0
            for g in range(n)]


def _hmtx(data: bytes, tables: dict, xmins: list) -> bytes:
    """A transformed hmtx table as fontTools' WOFF2HmtxTable reconstructs
    and compiles it."""
    if not data:
        _fail("an empty transformed 'hmtx' table")
    flags = data[0]
    if flags & 0xFC:
        _fail("Bits 2-7 of 'hmtx' flags are reserved")
    has_lsb, has_side = not flags & 1, not flags & 2
    if has_lsb and has_side:
        _fail("either bits 0 or 1 (or both) must set in transformed 'hmtx' flags")
    if "hhea" not in tables or len(tables["hhea"]) < 36:
        _fail("a transformed hmtx table without 'hhea'")
    n = len(xmins)
    nhm = min(struct.unpack_from(">H", tables["hhea"], 34)[0], n)
    at = 1

    def array(count: int, fmt: str) -> list:
        nonlocal at
        if len(data) - at < 2 * count:
            _fail("the transformed 'hmtx' table is short")
        vals = list(struct.unpack_from(f">{count}{fmt}", data, at))
        at += 2 * count
        return vals

    advances = array(nhm, "H")
    lsbs = array(nhm, "h") if has_lsb else xmins[:nhm]
    sides = array(n - nhm, "h") if has_side else xmins[nhm:]
    if at != len(data):
        _fail("too much 'hmtx' table data")
    if not advances:
        _fail("a transformed 'hmtx' table with no advance")
    metrics = [(advances[g], lsbs[g]) for g in range(nhm)] + [
        (advances[-1], s) for s in sides]
    last = metrics[-1][0]
    keep = len(metrics)
    while metrics[keep - 2][0] == last:
        keep -= 1
        if keep <= 1:
            keep = 1
            break
    out = struct.pack(f">{2 * keep}H", *[v & 0xFFFF for m in metrics[:keep] for v in m])
    return out + struct.pack(f">{len(metrics) - keep}h", *[m[1] for m in metrics[keep:]])
