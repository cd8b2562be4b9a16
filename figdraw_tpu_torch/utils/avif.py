"""The port's AVIF reader: an AVIF file to (H, W, 4) uint8 RGBA, as PIL
12.1.0's `Image.open(path).convert("RGBA")` returns it (figdraw_tpu
decodes through PIL; the port may not import it): a still image, or the
first frame of an image sequence. PIL reads AVIF through libavif 1.3.0
(AvifImagePlugin.py, its _avif module), whose decoder is dav1d and whose
YUV -> RGB conversion is libyuv's; each step is matched here.

The container is HEIF's ISO base media file format as libavif reads it.
The top-level boxes are walked as libavif walks them (`_top`): ftyp (an
`avif` or `avis` brand), meta and moov read whole, any other box stepped
over, and the walk stops once ftyp is read with a meta where an `avif`
brand asks for one and a moov where an `avis` brand does (a box after that
is never read). The source is then picked as libavif's
AVIF_DECODER_SOURCE_AUTO picks it: the tracks where the major brand is
`avis`, the primary item where it is `avif`, else the tracks where a moov
was read.

A still image is `meta` (FullBox) with `hdlr` (handler `pict`), `pitm`
(the primary item), `iloc` (versions 0-2, offset, length, base-offset and
index sizes 0/4/8, construction methods 0, the file, and 1, `idat`,
several extents joined in order), `iinf` / `infe` (versions 2 and 3),
`iref` (`auxl` names the alpha item, `prem` a premultiplied one) and
`iprp`: `ipco` properties and `ipma` associations (the essential bit, 7-
or 15-bit indices). The properties read are `ispe` (size), `pixi`, `av1C`
(profile, bit depth, monochrome, subsampling), `colr` (`nclx`; an ICC
`prof` or `rICC` is ignored, as PIL leaves the pixels alone), `auxC` (the
alpha URN), `a1op` (the operating point dav1d decodes), `lsel` (the
spatial layer asked for) with `a1lx` (the layers' sizes), and `clap`,
`irot` and `imir`, which PIL 12.1.0 does not apply to the pixels (it
reports the orientation as EXIF for ImageOps.exif_transpose), so they
are read and left unapplied here too. libavif's parse-time checks of
every property in ipco, used or not, are copied (`_check_property`), as
are its rules that a1op, lsel, clap, irot and imir be marked essential
and a1lx not. libavif holds pixi's depths to av1C's and neither to the
AV1 sequence header, nor av1C's profile, monochrome and subsampling
fields: the stream decides them.

A `grid` primary item (HEIF's ImageGrid: version 0, 16- or 32-bit output
sizes) is read as libavif 1.3.0 reads it: its tiles are the av01 items
whose `dimg` reference names it, in the reference's order, rows x columns
of them; the grid item gives ispe, pixi, colr and irot / imir, the first
tile its av1C (every tile's held equal, as every check libavif makes of a
grid before and after the decode: ValueError where PIL fails). An alpha
item may be a grid too. PIL sizes the image by the grid item's ispe and
reads libavif's rows of the grid's output width at that size (`decode_avif`
copies it). An `iovl` primary item fails as in PIL: libavif 1.3.0 reads no
overlay ("Missing or empty image item").

An image sequence (PIL's save_all) is read from its `moov` (`Track`):
each `trak`'s `tkhd` (track id, size in 16.16), `tref` (`auxl`, `prem`),
`edts` / `elst`, and `mdia` with `hdlr`, `mdhd` (the media timescale,
which PIL divides by) and `minf` / `stbl`: `stsd` (an `av01` sample entry
and its `av1C`, `colr`, `auxi`, `clap`, `a1op`, `lsel`, ...), `stsc`,
`stsz` (one size or a table), `stco` or `co64`, `stss` and `stts`, with
libavif's checks of each. The colour track is the first with an id, a
sample table with chunks, an av01 sample entry and no auxl reference; the
alpha track the first such whose auxl names it (and whose auxi, if any,
names alpha). Their first samples become the colour and alpha streams of
a `Still`, sized by each track's tkhd, so that `decode_avif` stays one
path.

utils/av1.py decodes the items' AV1 streams. An item (a tile, a track)
whose AV1 frame has another size than its `ispe` (its tkhd) is scaled to
that size before the colour conversion, plane by plane (the chroma planes
to half of it, rounded up), as libavif 1.3.0 scales it (avifImageScale
over libyuv's ScalePlane, av1.scale). A grid's tiles are then copied into
planes of its output size, the last column and row cropped, and the whole
image converted once, so that the chroma upsampling crosses the tile
seams as in libavif. The colr box's nclx (else the sequence header's
colour description) picks the YUV -> RGB conversion (av1.conversion); a
matrix and range libavif does not convert raise ValueError, as PIL
raises. A limited-range alpha is expanded to full range before the scale
(av1.alpha_range, libavif's avifLimitedToFullY at the alpha's depth), and
a premultiplied image (the colour's prem reference names its alpha) is
made straight after the conversion (av1.unattenuate, libyuv's
ARGBUnattenuate), as PIL asks libavif for straight alpha. Film grain is
synthesised in each AV1 frame before its scale to ispe and a grid's
assembly, as dav1d hands libavif the grained picture: every tile by its
own parameters, the alpha item too. An alpha item of another bit depth
than the colour item fails, as in libavif ("Decoding of alpha plane
failed" in PIL). A truncated or malformed file raises ValueError.

Refused with NotImplementedError naming AVIF, the feature and ROADMAP
item 1.3: alpha items on a grid's tiles (libavif builds an alpha grid of
them), a scale to ispe by libyuv's 3/4 or 3/8 filters, and the AV1
features utils/av1.py refuses (superres; a first sample that is not one
shown key frame).
"""

from __future__ import annotations

import struct
import time

import numpy as np

from . import av1

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
# an item's largest width or height (libavif's default decoder limit) and
# area (PIL's open raises DecompressionBombError past twice its
# MAX_IMAGE_PIXELS, 89478485)
DIMENSION_LIMIT, SIZE_LIMIT = 32768, 2 * 89478485
# the largest area of any item or grid (libavif's default imageSizeLimit;
# PIL's own limit above is on the image it returns)
LIBAVIF_SIZE_LIMIT = 16384 * 16384
# the property types libavif reads; an item with an essential property of
# another type is skipped (the primary item then is missing)
KNOWN_PROPERTIES = {b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir", b"pixi",
                    b"a1op", b"lsel", b"a1lx", b"clli"}
# the properties libavif requires an item to mark essential (a1lx it
# requires not to be)
ESSENTIAL_PROPERTIES = {b"a1op", b"lsel", b"clap", b"irot", b"imir"}


refuse = av1.refuse


def _boxes(data: bytes, start: int, end: int, top: bool = False):
    """(type, payload start, payload end) of the boxes in data[start:end];
    at the top level an `mdat` may claim more than the file holds (the
    items' extents are checked on their own), as libavif allows."""
    pos = start
    while pos < end:
        if pos + 8 > end:
            raise ValueError("AVIF: a truncated box header")
        size = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError("AVIF: a truncated box header")
            size = int.from_bytes(data[pos + 8:pos + 16], "big")
            head = 16
        elif size == 0:
            size = end - pos
        if top and kind == b"mdat" and size >= head and pos + size > end:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"AVIF: box {kind!r} runs past its parent")
        yield kind, pos + head, pos + size
        pos += size


class _Cursor:
    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def take(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise ValueError("AVIF: a truncated box")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def full(self, versions=(0,)) -> tuple:
        """A FullBox's version and flags; a version libavif does not read
        is an error there too."""
        v = self.uint(4)
        if v >> 24 not in versions:
            raise ValueError(f"AVIF: a box of version {v >> 24}")
        return v >> 24, v & 0xFFFFFF

    def cstring(self) -> bytes:
        end = self.data.find(b"\0", self.pos, self.end)
        if end < 0:
            end = self.end
        out = self.data[self.pos:end]
        self.pos = min(end + 1, self.end)
        return out


class Item:
    def __init__(self, item_id: int):
        self.id, self.type = item_id, b""
        self.extents, self.method = [], 0
        self.props = []  # (index, essential)


class Grid:
    """A derived `grid` item (HEIF's ImageGrid): rows x columns tiles, each
    an av01 item, laid out in raster order over an output of width x
    height, the last column and row cropped to it."""

    def __init__(self, rows: int, columns: int, width: int, height: int):
        self.rows, self.columns, self.width, self.height = rows, columns, width, height
        self.tiles = []  # each tile's AV1 stream, in raster order
        self.sizes = []  # each tile's ispe (width, height)
        self.layers = []  # each tile's (operating point, spatial layer or None)
        self.av1c = None  # the tiles' av1C fields, which libavif holds equal


class Still:
    """The parts of an AVIF still image that the decode needs."""

    def __init__(self):
        self.color = b""       # the primary item's AV1 stream (b"" for a grid)
        self.alpha = b""       # the alpha item's, or b"" (none, or a grid)
        self.grid = None       # the primary item's Grid where it is one
        self.alpha_grid = None  # the alpha item's Grid where it is one
        self.width = self.height = 0
        self.alpha_size = None  # the alpha item's ispe (width, height)
        self.av1c = None       # (profile, high bitdepth, twelve bit, mono, ssx, ssy)
        self.layers = (0, None)  # the colour item's a1op operating point and lsel layer
        self.alpha_layers = (0, None)
        self.alpha_av1c = None
        self.nclx = None       # (primaries, transfer, matrix, full range)
        self.rotation = 0      # irot, read and not applied (as PIL)
        self.mirror = None     # imir axis, read and not applied
        self.premultiplied = False  # the colour is premultiplied by the alpha (prem)
        self.track = None      # the colour Track where the image is a sequence's first frame


class Track:
    """A moov track as libavif 1.3.0 reads one (avifParseTrackBox): its
    id and size (tkhd), the track its `auxl`
    and `prem` references name (the first id of each), its media timescale
    (mdhd) and its sample table (stbl): chunk offsets (stco or co64),
    sample-to-chunk runs (first chunk, samples per chunk), the samples'
    sizes (stsz: one size for all, or a table) and the sample entries
    (format, [(property, payload start, end)])."""

    def __init__(self):
        self.id = self.width = self.height = 0
        self.aux_for = self.prem_by = 0
        self.timescale = 0
        self.has_table = False  # an stbl was read
        self.chunks, self.runs, self.sizes, self.entries = [], [], [], []
        self.all_size = 0

    def samples(self, file_size: int) -> list:
        """(offset, size) of every sample, with libavif's checks
        (avifCodecDecodeInputFillFromSampleTable): no chunk without samples,
        no sample past the size table, none past the file."""
        out, k = [], 0
        for index, offset in enumerate(self.chunks):
            per = next((n for first, n in reversed(self.runs) if first <= index + 1), 0)
            if per == 0:
                raise ValueError("AVIF: Sample table contains a chunk with 0 samples")
            for _ in range(per):
                size = self.all_size
                if not size:
                    if k >= len(self.sizes):
                        raise ValueError("AVIF: Truncated sample table")
                    size = self.sizes[k]
                if offset + size > file_size:
                    raise ValueError("AVIF: a sample runs past the file (libavif: Exceeded "
                                     "avifIO's sizeHint)")
                out.append((offset, size))
                offset += size
                k += 1
        return out

    def properties(self):
        """The properties of the track's first av01 sample entry, or None."""
        return next((props for fmt, props in self.entries if fmt == b"av01"), None)


VISUAL_SAMPLE_ENTRY = 78  # a VisualSampleEntry's fields before its child boxes


def _read_moov(data: bytes, start: int, end: int) -> list:
    tracks = [_read_trak(data, s, e) for kind, s, e in _boxes(data, start, end) if kind == b"trak"]
    if not tracks:
        raise ValueError("AVIF: Box[moov] has no [trak]")
    return tracks


def _versioned(c: _Cursor, versions=(0, 1)) -> int:
    v = c.uint(4) >> 24
    if v not in versions:
        raise ValueError(f"AVIF: a box of version {v}")
    return v


def _read_trak(data: bytes, start: int, end: int) -> Track:
    t = Track()
    seen = set()
    for kind, s, e in _boxes(data, start, end):
        c = _Cursor(data, s, e)
        if kind in (b"tkhd", b"edts"):
            if kind in seen:
                raise ValueError(f"AVIF: a second {kind.decode()} in a trak")
            seen.add(kind)
        if kind == b"tkhd":
            v = _versioned(c)
            c.take(16 if v else 8)  # creation and modification times
            track_id = c.uint(4)
            c.take(4 + (8 if v else 4) + 52)  # reserved, duration, layer .. matrix
            t.width, t.height = c.uint(4) >> 16, c.uint(4) >> 16
            if not t.width or not t.height:
                raise ValueError(f"AVIF: Track ID [{track_id}] has an invalid size")
            if (t.width > DIMENSION_LIMIT or t.height > DIMENSION_LIMIT
                    or t.width * t.height > LIBAVIF_SIZE_LIMIT):
                raise ValueError(f"AVIF: Track ID [{track_id}] dimensions are too large "
                                 f"[{t.width}x{t.height}]")
            t.id = track_id
        elif kind == b"meta":
            _read_meta(data, s, e)
        elif kind == b"mdia":
            for mk, ms, me in _boxes(data, s, e):
                if mk == b"hdlr":  # held as meta's, of any handler type
                    hc = _Cursor(data, ms, me)
                    _versioned(hc, (0,))
                    if hc.uint(4):
                        raise ValueError("AVIF: hdlr pre_defined is not 0")
                    hc.take(16)
                    if data.find(b"\0", hc.pos, me) < 0:
                        raise ValueError("AVIF: hdlr name is not null-terminated")
                elif mk == b"mdhd":
                    mc = _Cursor(data, ms, me)
                    v = _versioned(mc)
                    mc.take(16 if v else 8)
                    t.timescale = mc.uint(4)
                    mc.take(8 if v else 4)
                elif mk == b"minf":
                    for nk, ns, ne in _boxes(data, ms, me):
                        if nk == b"stbl":
                            if t.has_table:
                                raise ValueError("AVIF: Duplicate Box[stbl] for a single track")
                            t.has_table = True
                            _read_stbl(data, ns, ne, t)
        elif kind == b"tref":
            for rk, rs, re_ in _boxes(data, s, e):
                if rk in (b"auxl", b"prem"):
                    first = _Cursor(data, rs, re_).uint(4)  # the first id alone
                    if rk == b"auxl":
                        t.aux_for = first
                    else:
                        t.prem_by = first
        elif kind == b"edts":
            elst = [(s_, e_) for k_, s_, e_ in _boxes(data, s, e) if k_ == b"elst"]
            if len(elst) != 1:
                raise ValueError("AVIF: Box[edts] holds no [elst] or more than one")
            ec = _Cursor(data, *elst[0])
            v = ec.uint(1)
            if ec.uint(3) & 1:  # repeating: one entry of a nonzero duration
                if ec.uint(4) != 1:
                    raise ValueError("AVIF: Box[elst] contains an entry_count != 1")
                if v not in (0, 1):
                    raise ValueError(f"AVIF: Box[elst] has an unsupported version [{v}]")
                if not ec.uint(8 if v else 4):
                    raise ValueError("AVIF: Box[elst] Invalid value for segment_duration (0)")
    if b"tkhd" not in seen:
        raise ValueError("AVIF: Box[trak] does not contain a mandatory [tkhd] box")
    return t


def _read_stbl(data: bytes, start: int, end: int, t: Track) -> None:
    for kind, s, e in _boxes(data, start, end):
        c = _Cursor(data, s, e)
        if kind in (b"stco", b"co64"):
            _versioned(c, (0,))
            wide = 8 if kind == b"co64" else 4
            t.chunks += [c.uint(wide) for _ in range(c.uint(4))]
        elif kind == b"stsc":
            _versioned(c, (0,))
            for i in range(c.uint(4)):
                first, per, _desc = c.uint(4), c.uint(4), c.uint(4)
                if (i == 0 and first != 1) or (i and first <= t.runs[-1][0]):
                    raise ValueError("AVIF: Box[stsc] chunks do not begin with 1 and increase")
                t.runs.append((first, per))
        elif kind == b"stsz":
            _versioned(c, (0,))
            size, count = c.uint(4), c.uint(4)
            if size:
                t.all_size = size
            else:
                t.sizes += [c.uint(4) for _ in range(count)]
        elif kind == b"stss":
            _versioned(c, (0,))
            for _ in range(c.uint(4)):
                c.uint(4)
        elif kind == b"stts":
            _versioned(c, (0,))
            for _ in range(c.uint(4)):
                c.take(8)
        elif kind == b"stsd":
            _versioned(c, (0, 1))
            count = c.uint(4)
            pos = c.pos
            for _ in range(count):
                entry = next(_boxes(data, pos, e), None)
                if entry is None:
                    raise ValueError("AVIF: Box[stsd] holds fewer entries than its count")
                fmt, es, ee = entry
                props = []
                if fmt == b"av01":
                    if ee - es < VISUAL_SAMPLE_ENTRY:
                        raise ValueError("AVIF: Not enough bytes to parse VisualSampleEntry")
                    props = list(_boxes(data, es + VISUAL_SAMPLE_ENTRY, ee))
                    for prop in props:
                        _check_property(data, *prop)
                t.entries.append((fmt, props))
                pos = ee


def _parse_iloc(c: _Cursor, items: dict) -> None:
    version, _flags = c.full((0, 1, 2))
    sizes = c.uint(2)
    off_size, len_size, base_size = sizes >> 12, (sizes >> 8) & 15, (sizes >> 4) & 15
    index_size = sizes & 15 if version in (1, 2) else 0
    for s in (off_size, len_size, base_size, index_size):
        if s not in (0, 4, 8):
            raise ValueError("AVIF: an iloc field size other than 0, 4 or 8")
    count = c.uint(4 if version == 2 else 2)
    for _ in range(count):
        item = items.setdefault_item(c.uint(4 if version == 2 else 2))
        if version in (1, 2):
            item.method = c.uint(2) & 15
        c.uint(2)  # data reference index
        base = c.uint(base_size)
        for _e in range(c.uint(2)):
            c.uint(index_size)
            off = c.uint(off_size)
            length = c.uint(len_size)
            item.extents.append((base + off, length))


class _Items(dict):
    def setdefault_item(self, item_id: int) -> Item:
        if item_id not in self:
            self[item_id] = Item(item_id)
        return self[item_id]


def _item_size(item: Item) -> int:
    """The item's bytes as libavif counts them: its extents' lengths (an
    extent of length 0 holds nothing; libavif reads no "to the end")."""
    return sum(length for _off, length in item.extents)


def _item_bytes(data: bytes, item: Item, idat: bytes) -> bytes:
    src = data if item.method == 0 else idat
    if item.method not in (0, 1):
        raise ValueError(f"AVIF: iloc construction method {item.method}")
    out = bytearray()
    for off, length in item.extents:
        if off < 0 or length < 0 or off + length > len(src):
            raise ValueError("AVIF: an item extent runs past the file")
        out += src[off:off + length]
    return bytes(out)


def _top(data: bytes) -> tuple:
    """libavif 1.3.0's walk of the top-level boxes (avifParse): ftyp, meta
    and moov are read whole (a box past the file fails), any other box is
    stepped over (one that ends past the file fails at the next step, one
    of size 0 ends the walk), and the walk stops as soon as ftyp is read
    with a meta where an `avif` brand asks for one and a moov where an
    `avis` brand does: a box after that is never read. Returns (the major
    brand, the meta box's payload span or None, the tracks of the moov or
    None)."""
    pos, n = 0, len(data)
    major, meta, tracks = None, None, None
    needs_meta = needs_moov = False
    while pos < n:
        if pos + 8 > n:
            raise ValueError("AVIF: a truncated box header")
        size, kind, head = int.from_bytes(data[pos:pos + 4], "big"), data[pos + 4:pos + 8], 8
        if size == 1:
            if pos + 16 > n:
                raise ValueError("AVIF: a truncated box header")
            size, head = int.from_bytes(data[pos + 8:pos + 16], "big"), 16
        if kind in (b"ftyp", b"meta", b"moov"):
            end = n if size == 0 else pos + size
            if size and size < head or end > n:
                raise ValueError(f"AVIF: box {kind!r} runs past the file")
            start = pos + head
            if kind == b"ftyp":
                if major is not None or (end - start) < 8 or (end - start) % 4:
                    raise ValueError("AVIF: a second or malformed ftyp box")
                major = data[start:start + 4]
                brands = [major] + [data[i:i + 4] for i in range(start + 8, end, 4)]
                if b"avif" not in brands and b"avis" not in brands:
                    raise ValueError("AVIF: ftyp names no avif or avis brand")
                needs_meta, needs_moov = b"avif" in brands, b"avis" in brands
            elif kind == b"meta":
                if meta is not None:
                    raise ValueError("AVIF: a second meta box")
                meta = (start, end)
            else:
                if tracks is not None:
                    raise ValueError("AVIF: a second moov box")
                tracks = _read_moov(data, start, end)
        elif size == 0:
            break
        elif size < head:
            raise ValueError(f"AVIF: box {kind!r} runs past its parent")
        else:
            end = pos + size
        pos = end
        if major is not None and (meta or not needs_meta) and (tracks or not needs_moov):
            return major, meta, tracks
        if pos > n:
            raise ValueError(f"AVIF: box {kind!r} runs past the file")
    if major is None:
        raise ValueError("AVIF: no ftyp box")
    raise ValueError("AVIF: the file ends before its " + ("meta" if needs_meta and not meta
                                                          else "moov") + " box")


class _Meta:
    """A meta box as libavif's avifParseMetaBox reads it."""

    def __init__(self):
        self.items = _Items()
        self.props, self.primary, self.idat, self.handler = [], None, b"", b""
        self.refs = []  # (type, from, [to])


def _read_meta(data: bytes, ms: int, me: int) -> _Meta:
    c = _Cursor(data, ms, me)
    c.full()
    m = _Meta()
    items, refs = m.items, m.refs
    for kind, s, e in _boxes(data, c.pos, me):
        b = _Cursor(data, s, e)
        if kind == b"hdlr":
            b.full()
            if b.uint(4):
                raise ValueError("AVIF: hdlr pre_defined is not 0")
            m.handler = b.take(4)
            b.take(12)
            if data.find(b"\0", b.pos, e) < 0:
                raise ValueError("AVIF: hdlr name is not null-terminated")
        elif kind == b"pitm":
            version, _ = b.full((0, 1))
            m.primary = b.uint(2 if version == 0 else 4)
        elif kind == b"iloc":
            _parse_iloc(b, items)
        elif kind == b"idat":
            m.idat = data[s:e]
        elif kind == b"iinf":
            version, _ = b.full((0, 1))
            count = b.uint(2 if version == 0 else 4)
            entries = list(_boxes(data, b.pos, e))
            if count != sum(ik == b"infe" for ik, _s, _e in entries):
                raise ValueError("AVIF: iinf's entry count differs from its infe boxes")
            for ik, isrt, iend in entries:
                if ik != b"infe":
                    continue
                ib = _Cursor(data, isrt, iend)
                iv, _ = ib.full((2, 3))
                item = items.setdefault_item(ib.uint(2 if iv == 2 else 4))
                ib.uint(2)
                item.type = ib.take(4)
                for _s in range(2 if item.type == b"mime" else 1):  # item_name (content_type)
                    if data.find(b"\0", ib.pos, iend) < 0:
                        raise ValueError("AVIF: an infe string is not null-terminated")
                    ib.cstring()
        elif kind == b"iref":
            version, _ = b.full((0, 1))
            for rk, rs, re_ in _boxes(data, b.pos, e):
                rb = _Cursor(data, rs, re_)
                frm = rb.uint(2 if version == 0 else 4)
                to = [rb.uint(2 if version == 0 else 4) for _ in range(rb.uint(2))]
                if rk == b"dimg" and any(k == rk and f == frm for k, f, _t in refs):
                    raise ValueError("AVIF: Box[iinf] contains duplicate boxes of type 'dimg' "
                                     f"with the same from_item_ID value {frm}")
                refs.append((rk, frm, to))
        elif kind == b"iprp":
            for pk, ps, pe in _boxes(data, s, e):
                if pk == b"ipco":
                    m.props = list(_boxes(data, ps, pe))
                    for prop in m.props:
                        _check_property(data, *prop)
                elif pk == b"ipma":
                    pb = _Cursor(data, ps, pe)
                    version, flags = pb.full((0, 1))
                    for _ in range(pb.uint(4)):
                        item = items.setdefault_item(pb.uint(2 if version < 1 else 4))
                        for _a in range(pb.uint(1)):
                            if flags & 1:
                                v = pb.uint(2)
                                item.props.append((v & 0x7FFF, v >> 15))
                            else:
                                v = pb.uint(1)
                                item.props.append((v & 0x7F, v >> 7))
    if m.handler != b"pict":
        raise ValueError(f"AVIF: meta handler {m.handler!r}, not pict")
    return m


def _check_property(data: bytes, kind: bytes, s: int, e: int) -> None:
    """The checks libavif 1.3.0 makes of a property as it parses one (in
    ipco or a sample entry), used or not: each type it reads holds its
    fields (ispe, auxC and pixi as FullBoxes of version 0; auxC's URN
    null-terminated; colr's colour type, and nclx's 7 reserved bits zero;
    av1C's marker and version 1; pixi's one to four equal depths; irot's and
    imir's reserved bits zero; a1op an operating point of at most 31; lsel
    a layer below 4, or 0xFFFF: any; a1lx's reserved bits zero and three 16-
    or 32-bit layer sizes)."""
    c = _Cursor(data, s, e)
    if kind in (b"ispe", b"auxC", b"pixi"):
        c.full()
    if kind == b"ispe":
        c.take(8)
    elif kind == b"auxC":
        if data.find(b"\0", c.pos, e) < 0:
            raise ValueError("AVIF: auxC's URN is not null-terminated")
    elif kind == b"pixi":
        depths = c.take(c.uint(1))
        if not 0 < len(depths) <= 4 or depths.count(depths[0]) != len(depths):
            raise ValueError(f"AVIF: pixi depths {list(depths)}, which libavif does not read")
    elif kind == b"colr":
        colour = c.take(4)
        if colour == b"nclx":
            c.take(6)
            if c.uint(1) & 0x7F:
                raise ValueError("AVIF: colr nclx reserved bits set")
    elif kind == b"av1C":
        if c.take(4)[0] != 0x81:
            raise ValueError("AVIF: av1C's marker and version are not 1")
    elif kind in (b"irot", b"imir"):
        if c.uint(1) & (0xFC if kind == b"irot" else 0xFE):
            raise ValueError(f"AVIF: Box[{kind.decode()}] contains nonzero reserved bits")
    elif kind == b"pasp":
        c.take(8)
    elif kind == b"clli":
        c.take(4)
    elif kind == b"clap":
        c.take(32)
    elif kind == b"a1op":
        if c.uint(1) > 31:
            raise ValueError("AVIF: Box[a1op] contains an unsupported operating point")
    elif kind == b"lsel":
        layer = c.uint(2)
        if layer != 0xFFFF and layer >= 4:
            raise ValueError(f"AVIF: Box[lsel] contains an unsupported layer [{layer}]")
    elif kind == b"a1lx":
        large = c.uint(1)
        if large & 0xFE:
            raise ValueError("AVIF: Box[a1lx] has bits set in the reserved section")
        for _ in range(3):
            c.uint(4 if large else 2)


def parse(data: bytes) -> Still:
    """The image that PIL reads from an AVIF file: the primary item (and
    its alpha), or the first samples of the colour track (and its alpha
    track) of an image sequence, picked as libavif 1.3.0's
    AVIF_DECODER_SOURCE_AUTO picks: the track where the major brand is
    `avis`, the item where it is `avif`, else the track where a moov with a
    track was read."""
    major, meta_span, tracks = _top(data)
    meta = _read_meta(data, *meta_span) if meta_span else None
    if meta is not None:
        _check_items(data, meta)
    if major == b"avis" or (major != b"avif" and tracks):
        return _track_still(data, tracks)
    if meta is None:
        raise ValueError("AVIF: no meta box")
    return _item_still(data, meta)


def _check_items(data: bytes, meta: _Meta) -> None:
    """libavif's checks of every item as it parses (avifDecoderParse),
    used or not, whichever source it then decodes: each ipma index within
    ipco; an item it would decode (av01 or grid, with data, no unknown
    essential property, no thumbnail) has an ispe of a size it takes (an
    alpha item too: PIL's libavif decodes with its strict flags)."""
    props = meta.props
    thumbnails = {frm for rk, frm, _to in meta.refs if rk == b"thmb"}
    for it in meta.items.values():
        if any(index > len(props) for index, _essential in it.props):
            raise ValueError(f"AVIF: Box[ipma] for item ID [{it.id}] contains an illegal "
                             "property index")
        for index, essential in it.props:
            kind = props[index - 1][0] if index else b""
            if (kind in ESSENTIAL_PROPERTIES and not essential) or (kind == b"a1lx" and essential):
                raise ValueError(f"AVIF: item ID [{it.id}] has a {kind.decode()} property "
                                 f"{'not ' if not essential else ''}marked essential")
        if (it.type in (b"av01", b"grid") and _item_size(it) and it.id not in thumbnails
                and not _unsupported(it, props)):
            _ispe(data, next((props[i - 1][1:] for i, _e in it.props
                              if i and props[i - 1][0] == b"ispe"), None), LIBAVIF_SIZE_LIMIT)


def _unsupported(it: Item, props: list) -> bool:
    """An essential property of a type libavif does not read."""
    return any(essential and 0 < index <= len(props) and props[index - 1][0] not in
               KNOWN_PROPERTIES for index, essential in it.props)


def _ispe(data: bytes, span, area: int = SIZE_LIMIT) -> tuple:
    if span is None:
        raise ValueError("AVIF: an item without ispe")
    ic = _Cursor(data, *span)
    ic.full()
    w, h = ic.uint(4), ic.uint(4)
    if not (0 < w <= DIMENSION_LIMIT and 0 < h <= DIMENSION_LIMIT) or w * h > area:
        raise ValueError(f"AVIF: an ispe of {w}x{h}, past libavif's or PIL's limits")
    return w, h


def _av1c(data: bytes, span) -> tuple:
    if span is None:
        raise ValueError("AVIF: an av01 item without av1C")
    ps, pe = span
    if pe - ps < 4:
        raise ValueError("AVIF: a short av1C")
    if data[ps] != 0x81:
        raise ValueError("AVIF: av1C's marker and version are not 1")
    b1, b2 = data[ps + 1], data[ps + 2]
    return (b1 >> 5, (b2 >> 6) & 1, (b2 >> 5) & 1, (b2 >> 4) & 1, (b2 >> 3) & 1, (b2 >> 2) & 1)


def _nclx(data: bytes, span):
    """A colr box's nclx (primaries, transfer, matrix, full range), or None
    for an ICC profile."""
    ps, pe = span
    if data[ps:ps + 4] == b"nclx" and pe - ps >= 11:
        if data[ps + 10] & 0x7F:
            raise ValueError("AVIF: colr nclx reserved bits set")
        cp, tc, mc = struct.unpack(">HHH", data[ps + 4:ps + 10])
        return cp, tc, mc, data[ps + 10] >> 7
    return None


def _track_still(data: bytes, tracks: list) -> Still:
    """The first samples of an image sequence's colour track and its alpha
    track as libavif 1.3.0 picks them (avifDecoderReset with the tracks
    source): the colour track is the first with an id, a sample table with
    chunks, an av01 sample entry and no auxl reference; the alpha track the
    first such track whose auxl reference names it and whose auxi property,
    if it has one, names alpha. Each track's tkhd
    gives its size, the colour sample entry's colr its nclx; the colour is
    premultiplied where its prem reference names the alpha track."""
    def usable(t):
        return t.id and t.has_table and t.chunks and t.properties() is not None

    color = next((t for t in tracks if usable(t) and not t.aux_for), None)
    if color is None:
        raise ValueError("AVIF: Failed to find AV1 color track")
    def is_alpha(t):  # an auxi property, where there is one, names alpha
        for kind, s, e in t.properties():
            if kind == b"auxi":
                c = _Cursor(data, s, e)
                c.full()
                return c.cstring() in ALPHA_URNS
        return True

    alpha = next((t for t in tracks if usable(t) and t.aux_for == color.id and is_alpha(t)), None)
    out = Still()
    out.track = color
    props = {}
    for kind, s, e in color.properties():
        if kind == b"colr" and _nclx(data, (s, e)) is not None:
            if props.get(b"nclx"):
                raise ValueError("AVIF: Multiple colr boxes with colour type nclx found")
            props[b"nclx"] = (s, e)
        props.setdefault(kind, (s, e))
    out.av1c = _av1c(data, props.get(b"av1C"))
    if b"nclx" in props:
        out.nclx = _nclx(data, props[b"nclx"])
    out.width, out.height = color.width, color.height
    if color.width * color.height > SIZE_LIMIT:
        raise ValueError(f"AVIF: a {color.width}x{color.height} track, past PIL's limit")
    offset, size = color.samples(len(data))[0]
    out.color = data[offset:offset + size]
    if alpha is not None:
        offset, size = alpha.samples(len(data))[0]
        out.alpha = data[offset:offset + size]
        out.alpha_size = (alpha.width, alpha.height)
        config = next((se for k, *se in alpha.properties() if k == b"av1C"), None)
        out.alpha_av1c = _av1c(data, config) if config else None  # not required of the alpha
        out.premultiplied = color.prem_by == alpha.id
    if not color.timescale:  # PIL divides the first frame's timestamp by it
        raise ValueError("AVIF: a track of media timescale 0 (PIL: division by zero)")
    return out


def _item_still(data: bytes, meta: _Meta) -> Still:
    """The primary item (and its alpha) as libavif 1.3.0 reads it."""
    items, props, primary, idat, refs = meta.items, meta.props, meta.primary, meta.idat, meta.refs
    if primary is None or primary not in items:
        raise ValueError("AVIF: no primary item")
    item = items[primary]
    if item.type not in (b"av01", b"grid"):  # iovl among them: libavif 1.3.0 reads no overlay
        raise ValueError(f"AVIF: a primary item of type {item.type!r} (libavif: Missing or "
                         "empty image item)")
    if not _item_size(item):  # libavif skips an item without data
        raise ValueError("AVIF: an empty primary item (libavif: Missing or empty image item)")
    # libavif's dimg model: each tile names its grid and its place in the
    # grid's reference (a later reference overwrites an earlier one)
    dimg_of = {}
    for rk, frm, to in refs:
        if rk == b"dimg":
            for k, t in enumerate(to):
                dimg_of[t] = (frm, k)
    out = Still()

    def unsupported(it: Item) -> bool:
        return _unsupported(it, props)

    def item_props(it: Item) -> dict:
        found = {}
        for index, _essential in it.props:
            if index == 0:
                continue
            if index > len(props):
                raise ValueError("AVIF: an ipma index past ipco")
            pk, ps, pe = props[index - 1]
            found[pk] = (ps, pe)
        return found

    def av1c(span) -> tuple:
        return _av1c(data, span)

    def ispe(span, area: int = SIZE_LIMIT) -> tuple:
        return _ispe(data, span, area)

    def layers(it: Item, ip: dict) -> tuple:
        """An item's operating point (a1op), spatial layer (lsel, None for
        0xFFFF or none) and AV1 stream as libavif feeds dav1d: with a layer
        and an a1lx, the item's bytes up to that layer's end (libavif's
        avifCodecDecodeInputFillFromDecoderItem, with its checks)."""
        stream = _item_bytes(data, it, idat)
        op = data[ip[b"a1op"][0]] if b"a1op" in ip else 0
        layer = int.from_bytes(data[ip[b"lsel"][0]:ip[b"lsel"][0] + 2], "big") \
            if b"lsel" in ip else 0xFFFF
        if b"a1lx" in ip:
            lc = _Cursor(data, *ip[b"a1lx"])
            wide = 4 if lc.uint(1) & 1 else 2
            sizes, left = [], len(stream)
            for _ in range(3):
                n = lc.uint(wide)
                if n and n >= left:
                    raise ValueError(f"AVIF: a1lx layer index [{len(sizes)}] does not fit in "
                                     "item size")
                sizes.append(n or left)
                left -= sizes[-1]
                if not n:
                    break
            if left:
                sizes.append(left)
            if layer == 0xFFFF:
                return op, None, stream
            if layer >= len(sizes):
                raise ValueError(f"AVIF: lsel property requests layer index [{layer}] which "
                                 f"isn't present in a1lx property ([{len(sizes)}] layers)")
            stream = stream[:sum(sizes[:layer + 1])]
        return op, None if layer == 0xFFFF else layer, stream

    def pixi(span, config: tuple) -> None:
        """libavif's checks of pixi: one to four depths, all equal, equal to
        av1C's (12 for twelve_bit, else 10 for high_bitdepth, else 8; the
        stream's own depth is not held to them)."""
        if span is None:
            return
        xc = _Cursor(data, *span)
        xc.full()
        count = xc.uint(1)
        depths = [xc.uint(1) for _ in range(count)]
        if not 0 < count <= 4 or any(d != depths[0] for d in depths):
            raise ValueError(f"AVIF: pixi depths {depths}, which libavif does not read")
        want = 12 if config[2] else (10 if config[1] else 8)
        if depths[0] != want:
            raise ValueError(f"AVIF: pixi depths {depths} differ from av1C's {want}")

    def grid(g: Item) -> Grid:
        """A grid item's ImageGrid and its tiles, with libavif's checks of
        them before the decode; the tiles' shared av1C is the grid's."""
        payload = _item_bytes(data, g, idat)
        gc = _Cursor(payload, 0, len(payload))
        if gc.uint(1):
            raise ValueError("AVIF: Box[grid] has unsupported version")
        flags = gc.uint(1)
        rows, columns = gc.uint(1) + 1, gc.uint(1) + 1
        field = 4 if flags & 1 else 2
        w, h = gc.uint(field), gc.uint(field)
        if gc.pos != len(payload):
            raise ValueError("AVIF: Box[grid] holds more than its fields")
        if not w or not h:
            raise ValueError(f"AVIF: Grid box contains illegal dimensions: [{w} x {h}]")
        if w > DIMENSION_LIMIT or h > DIMENSION_LIMIT or w * h > LIBAVIF_SIZE_LIMIT:
            raise ValueError(f"AVIF: Grid box dimensions are too large: [{w} x {h}]")
        places = sorted((k, t) for t, (frm, k) in dimg_of.items() if frm == g.id)
        if [k for k, _t in places] != list(range(rows * columns)):
            raise ValueError(f"AVIF: a {columns}x{rows} grid with {len(places)} dimg items")
        out = Grid(rows, columns, w, h)
        tiles = [items.get(t) or Item(t) for _k, t in places]
        for t in tiles:
            if t.type != b"av01":
                raise ValueError(f"AVIF: Tile item ID {t.id} has an unknown item type {t.type!r}")
            if unsupported(t):
                raise ValueError("AVIF: Grid image contains tile with an unsupported property "
                                 "marked as essential")
        config = None
        for t in tiles:
            tp = item_props(t)
            if b"av1C" not in tp:
                raise ValueError(f"AVIF: grid tile item ID {t.id} is missing an av1C property")
            fields, at = av1c(tp[b"av1C"]), tp[b"av1C"][0]
            if config is None:
                out.av1c, config = fields, data[at + 1:at + 3]
            elif data[at + 1:at + 3] != config:
                raise ValueError(f"AVIF: The fields of the av1C property of tile item ID {t.id} "
                                 "differs from other tiles")
            out.sizes.append(ispe(tp.get(b"ispe"), LIBAVIF_SIZE_LIMIT))
            op, layer, stream = layers(t, tp)
            out.tiles.append(stream)
            out.layers.append((op, layer))
        return out

    if unsupported(item):
        raise ValueError("AVIF: the primary item has an unsupported essential property")
    p = item_props(item)
    out.width, out.height = ispe(p.get(b"ispe"))
    if item.type == b"grid":
        out.grid = grid(item)
        out.av1c = out.grid.av1c
    else:
        out.av1c = av1c(p.get(b"av1C"))
    pixi(p.get(b"pixi"), out.av1c)
    if b"colr" in p:
        out.nclx = _nclx(data, p[b"colr"])
    if b"irot" in p:
        out.rotation = data[p[b"irot"][0]] & 3
    if b"imir" in p:
        out.mirror = data[p[b"imir"][0]] & 1
    if out.grid is None:
        op, layer, out.color = layers(item, p)
        out.layers = (op, layer)

    def alpha_of(owner: int):
        """The alpha item of an item, as libavif finds it: the first auxl
        item of type av01 or grid, not skipped, with an alpha auxC."""
        for rk, frm, to in refs:
            if rk != b"auxl" or owner not in to or frm not in items:
                continue
            alpha = items[frm]
            # libavif skips an item with an unknown essential property, of
            # a type it does not decode or without data
            # (avifDecoderItemShouldBeSkipped)
            if unsupported(alpha) or alpha.type not in (b"av01", b"grid") or not _item_size(alpha):
                continue
            ap = item_props(alpha)
            aux = ap.get(b"auxC")
            if aux is None:
                continue
            ac = _Cursor(data, *aux)
            ac.full()
            if ac.cstring() in ALPHA_URNS:
                return alpha, ap
        return None, None

    alpha, ap = alpha_of(primary)
    if alpha is not None:
        if alpha.type == b"grid":
            out.alpha_grid = grid(alpha)
            out.alpha_av1c = out.alpha_grid.av1c
        else:
            out.alpha_av1c = av1c(ap.get(b"av1C"))
            op, layer, out.alpha = layers(alpha, ap)
            out.alpha_layers = (op, layer)
        pixi(ap.get(b"pixi"), out.alpha_av1c)
        out.alpha_size = ispe(ap.get(b"ispe"))
        # libavif's premByID: the last item that a prem reference from the
        # colour item names
        prem = [to[-1] for rk, frm, to in refs if rk == b"prem" and frm == primary and to]
        out.premultiplied = bool(prem) and prem[-1] == alpha.id
    elif out.grid is not None and any(alpha_of(t)[0] is not None
                                      for t, (frm, _k) in dimg_of.items() if frm == primary):
        raise refuse("alpha items on a grid's tiles")
    return out


def to_ispe(frame: av1.Frame, width: int, height: int, plain: bool = False) -> av1.Frame:
    """The frame itself where its size is the item's ispe, else a frame of
    its planes scaled to it as libavif scales them (each plane to its own
    size: each chroma plane by its own subsampling, rounded up)."""
    if (frame.width, frame.height) == (width, height):
        return frame
    planes = []
    for k, p in enumerate(frame.planes):
        if p is None:
            planes.append(None)
            continue
        sx, sy = (frame.ssx, frame.ssy) if k else (0, 0)
        planes.append(av1.scale(p, (frame.width + sx) >> sx, (frame.height + sy) >> sy,
                                (width + sx) >> sx, (height + sy) >> sy, plain=plain))
    return _with_planes(frame, tuple(planes), width, height)


def _with_planes(frame: av1.Frame, planes: tuple, width: int = None,
                 height: int = None) -> av1.Frame:
    """A frame like `frame` (its colour description, block info and stage
    ms) with other planes, of another size where one is given."""
    out = av1.Frame(planes, frame.width if width is None else width,
                    frame.height if height is None else height, frame.full_range, frame.matrix,
                    frame.mono, frame.ssx, frame.ssy, frame.primaries, frame.bit_depth,
                    frame.transfer)
    out.mi, out.cdef, out.lr, out.ms = frame.mi, frame.cdef, frame.lr, dict(frame.ms)
    out.grain = frame.grain
    return out


def assemble(frames: list, grid: Grid, alpha: bool = False) -> av1.Frame:
    """A grid's decoded tiles (each already at its ispe) as one frame of the
    grid's output size, as libavif 1.3.0 builds it: the first tile's size
    must cover the output with the last column and row overlapping it, be
    at least 64 and, where chroma is subsampled, even, as must the output;
    every tile must equal the first in size, depth, format, range and
    colour description (an alpha tile in size and depth); each is copied
    to its place, the last column and row cropped, each chroma plane by
    its own subsampling (half the size, rounded up). An alpha grid's tiles
    have no chroma, so no even sizes."""
    first = frames[0]
    tw, th, w, h = first.width, first.height, grid.width, grid.height
    if tw * grid.columns < w or th * grid.rows < h:
        raise ValueError("AVIF: Grid image tiles do not completely cover the image")
    if tw * (grid.columns - 1) >= w or th * (grid.rows - 1) >= h:
        raise ValueError("AVIF: Grid image tiles in the rightmost column and bottommost row do "
                         "not overlap the reconstructed image grid canvas")
    if tw < 64 or th < 64:
        raise ValueError(f"AVIF: Grid image tile width ({tw}) or height ({th}) cannot be "
                         "smaller than 64")
    ssx, ssy = (0, 0) if alpha or first.mono else (first.ssx, first.ssy)
    if (ssx and (w % 2 or tw % 2)) or (ssy and (h % 2 or th % 2)):
        raise ValueError("AVIF: Grid image width or height or tile width or height shall be "
                         "even if chroma is subsampled in that dimension")

    def key(f):  # an alpha tile carries no format, range or colour description
        return (f.width, f.height, f.bit_depth) + (() if alpha else (
            f.mono, f.ssx, f.ssy, f.full_range, f.primaries, f.transfer, f.matrix))
    dtype = first.planes[0].dtype
    n = 1 if alpha or first.mono else 3
    planes = [np.zeros(((h + sy) >> sy, (w + sx) >> sx), dtype)
              for sx, sy in [(0, 0)] + [(ssx, ssy)] * (n - 1)]
    for k, f in enumerate(frames):
        if key(f) != key(first):
            raise ValueError("AVIF: Grid image contains mismatched tiles")
        x, y = tw * (k % grid.columns), th * (k // grid.columns)
        cw, ch = min(tw, w - x), min(th, h - y)
        for c, plane in enumerate(planes):
            sx, sy = (ssx, ssy) if c else (0, 0)
            pw, ph = (cw + sx) >> sx, (ch + sy) >> sy
            plane[y >> sy:(y >> sy) + ph, x >> sx:(x >> sx) + pw] = f.planes[c][:ph, :pw]
    out = av1.Frame(tuple(planes) + (None,) * (3 - n), w, h, first.full_range, first.matrix,
                    first.mono, first.ssx, first.ssy, first.primaries, first.bit_depth,
                    first.transfer)
    out.ms = {k: sum(f.ms[k] for f in frames) for k in first.ms}
    return out


def decode_item(stream: bytes, grid, size: tuple, plain: bool = False,
                alpha: bool = False, layers: tuple = (0, None)) -> av1.Frame:
    """A colour or alpha item's frame at its size: a single item's AV1
    frame scaled to its ispe (`size`), or a grid's tiles, each scaled to
    its own ispe, assembled; ms holds the stages' host ms summed over the
    tiles and, for a grid, the assembly's."""
    def frame(t, s, ol):
        f = av1.decode(t, plain=plain, operating_point=ol[0], spatial_layer=ol[1])
        if alpha and not f.full_range:  # libavif expands it before the scale to ispe
            t0 = time.perf_counter()
            plane = av1.alpha_range(f.planes[0], f.width, f.height, f.bit_depth, plain)
            f = _with_planes(f, (plane,) + tuple(f.planes[1:]))
            f.ms["alpha range"] = (time.perf_counter() - t0) * 1e3
        return to_ispe(f, *s, plain)

    if grid is None:
        return frame(stream, size, layers)
    frames = [frame(t, s, ol) for t, s, ol in zip(grid.tiles, grid.sizes, grid.layers)]
    t0 = time.perf_counter()
    out = assemble(frames, grid, alpha)
    out.ms["assembly"] = (time.perf_counter() - t0) * 1e3
    return out


def decode_avif(data: bytes, plain: bool = False) -> np.ndarray:
    """An AVIF file's bytes to (H, W, 4) uint8 RGBA. `plain` runs the
    numpy twins of utils/av1.py's stages around the C++ tile syntax."""
    still = parse(data)
    color = decode_item(still.color, still.grid, (still.width, still.height), plain,
                        layers=still.layers)
    alpha = None
    if still.alpha or still.alpha_grid:
        a = decode_item(still.alpha, still.alpha_grid, still.alpha_size, plain, alpha=True,
                        layers=still.alpha_layers)
        if a.bit_depth != color.bit_depth:  # dav1d's alpha plane must match the colour's
            raise ValueError(f"AVIF: a {a.bit_depth}-bit alpha item on a {color.bit_depth}-bit "
                             "colour item (libavif: Decoding of alpha plane failed)")
        if a.width != color.width or a.height != color.height:
            raise ValueError("AVIF: the alpha and colour items differ in size")
        alpha = a.planes[0][: a.height, : a.width]
    # the colr box's nclx where there is one, else the sequence header's
    primaries, _transfer, matrix, full = still.nclx or (color.primaries, 2, color.matrix,
                                                        color.full_range)
    rgba = av1.to_rgba(color, alpha, full, matrix, primaries, plain=plain)
    if still.premultiplied and alpha is not None:  # PIL asks libavif for straight alpha
        rgba = av1.unattenuate(rgba, plain)
    if (color.width, color.height) == (still.width, still.height):
        return rgba
    # a grid whose ispe is not its output size: PIL's image has the ispe's
    # size and reads libavif's RGB (RGBA with alpha) rows of the output's
    # width as rows of the ispe's, failing where they run out
    c = 3 if alpha is None else 4
    need = still.width * still.height * c
    if need > rgba.shape[0] * rgba.shape[1] * c:
        raise ValueError(f"AVIF: a {still.width}x{still.height} ispe on a {color.width}x"
                         f"{color.height} grid (PIL: image file is truncated)")
    out = np.full((still.height, still.width, 4), 255, np.uint8)
    out[..., :c] = np.ascontiguousarray(rgba[..., :c]).reshape(-1)[:need].reshape(
        still.height, still.width, c)
    return out
