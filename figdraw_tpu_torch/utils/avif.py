"""The port's AVIF reader: an AVIF still image to (H, W, 4) uint8 RGBA, as
PIL 12.1.0's `Image.open(path).convert("RGBA")` returns it (figdraw_tpu
decodes through PIL; the port may not import it). PIL reads AVIF through
libavif 1.3.0 (AvifImagePlugin.py, its _avif module), whose decoder is
dav1d and whose YUV -> RGB conversion is libyuv's; each step is matched
here.

The container is HEIF's ISO base media file format as libavif reads a
still image: `ftyp` (an `avif` brand), then `meta` (FullBox) with `hdlr`
(handler `pict`), `pitm` (the primary item), `iloc` (versions 0-2, offset,
length, base-offset and index sizes 0/4/8, construction methods 0, the
file, and 1, `idat`, several extents joined in order), `iinf` / `infe`
(versions 2 and 3), `iref` (`auxl` names the alpha item) and `iprp`:
`ipco` properties and `ipma` associations (the essential bit, 7- or
15-bit indices). The properties read are `ispe` (size), `pixi`, `av1C`
(profile, bit depth, monochrome, subsampling), `colr` (`nclx`; an ICC
`prof` or `rICC` is ignored, as PIL leaves the pixels alone) and `auxC`
(the alpha URN). libavif holds pixi's depths to av1C's and neither to
the AV1 sequence header, nor av1C's profile, monochrome and subsampling
fields: the stream decides them. PIL 12.1.0 applies neither `irot` nor `imir` to the
pixels (it reports the orientation as EXIF for ImageOps.exif_transpose),
so they are read and left unapplied here too.

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

utils/av1.py decodes the items' AV1 streams. An item (or a tile) whose AV1
frame has another size than its `ispe` is scaled to ispe's size before the
colour conversion, plane by plane (the chroma planes to half of it, rounded
up), as libavif 1.3.0 scales it (avifImageScale over libyuv's ScalePlane,
av1.scale). A grid's tiles are then copied into planes of its output size,
the last column and row cropped, and the whole image converted once, so
that the chroma upsampling crosses the tile seams as in libavif. The colr
box's nclx (else the sequence header's colour description) picks the
YUV -> RGB conversion (av1.conversion); a matrix and range libavif does
not convert raise ValueError, as PIL raises. Refused with
NotImplementedError naming AVIF, the feature and the ROADMAP item: an
image sequence (`avis`, a `moov` track, which PIL reads instead of the
primary item), `clap` cropping, `a1op` / `lsel` layer selection, a
premultiplied alpha (`prem`), a limited-range alpha item, alpha items on
a grid's tiles (libavif builds an alpha grid of them), a scale to ispe by
libyuv's 3/4 or 3/8 filters, and the AV1 features utils/av1.py refuses
(superres). Film grain is synthesised in each AV1 frame before its scale
to ispe and a grid's assembly, as dav1d hands libavif the grained
picture: every tile by its own parameters, the alpha item too. An alpha
item of another bit depth than the colour item fails, as in libavif
("Decoding of alpha plane failed" in PIL). A truncated or malformed file
raises ValueError.
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
REFUSED_PROPERTIES = {b"clap": "clean-aperture cropping (clap)",
                      b"a1op": "operating point selection (a1op)",
                      b"lsel": "layer selection (lsel)"}


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
        self.alpha_av1c = None
        self.nclx = None       # (primaries, transfer, matrix, full range)
        self.rotation = 0      # irot, read and not applied (as PIL)
        self.mirror = None     # imir axis, read and not applied


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


def parse(data: bytes) -> Still:
    """The primary item (and its alpha) of an AVIF file."""
    top = list(_boxes(data, 0, len(data), top=True))
    if not top or top[0][0] != b"ftyp":
        raise ValueError("AVIF: no ftyp box first")
    if any(b[0] == b"moov" for b in top):  # PIL reads the track's first frame
        raise refuse("image sequences (avis)")
    metas = [b for b in top if b[0] == b"meta"]
    if not metas:
        raise ValueError("AVIF: no meta box")
    _kind, ms, me = metas[0]
    c = _Cursor(data, ms, me)
    c.full()
    items = _Items()
    props, primary, idat, handler = [], None, b"", b""
    refs = []  # (type, from, [to])
    for kind, s, e in _boxes(data, c.pos, me):
        b = _Cursor(data, s, e)
        if kind == b"hdlr":
            b.full()
            if b.uint(4):
                raise ValueError("AVIF: hdlr pre_defined is not 0")
            handler = b.take(4)
            b.take(12)
            if data.find(b"\0", b.pos, e) < 0:
                raise ValueError("AVIF: hdlr name is not null-terminated")
        elif kind == b"pitm":
            version, _ = b.full((0, 1))
            primary = b.uint(2 if version == 0 else 4)
        elif kind == b"iloc":
            _parse_iloc(b, items)
        elif kind == b"idat":
            idat = data[s:e]
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
                    props = list(_boxes(data, ps, pe))
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
    if handler != b"pict":
        raise ValueError(f"AVIF: meta handler {handler!r}, not pict")
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
        """An essential property of a type libavif does not read."""
        return any(essential and 0 < index <= len(props) and props[index - 1][0] not in
                   KNOWN_PROPERTIES for index, essential in it.props)

    def item_props(it: Item) -> dict:
        found = {}
        for index, _essential in it.props:
            if index == 0:
                continue
            if index > len(props):
                raise ValueError("AVIF: an ipma index past ipco")
            pk, ps, pe = props[index - 1]
            if pk in REFUSED_PROPERTIES:
                raise refuse(REFUSED_PROPERTIES[pk])
            found[pk] = (ps, pe)
        return found

    def av1c(span) -> tuple:
        if span is None:
            raise ValueError("AVIF: an av01 item without av1C")
        ps, pe = span
        if pe - ps < 4:
            raise ValueError("AVIF: a short av1C")
        if data[ps] != 0x81:
            raise ValueError("AVIF: av1C's marker and version are not 1")
        b1, b2 = data[ps + 1], data[ps + 2]
        return (b1 >> 5, (b2 >> 6) & 1, (b2 >> 5) & 1, (b2 >> 4) & 1, (b2 >> 3) & 1, (b2 >> 2) & 1)

    def ispe(span, area: int = SIZE_LIMIT) -> tuple:
        if span is None:
            raise ValueError("AVIF: an item without ispe")
        ic = _Cursor(data, *span)
        ic.full()
        w, h = ic.uint(4), ic.uint(4)
        if not (0 < w <= DIMENSION_LIMIT and 0 < h <= DIMENSION_LIMIT) or w * h > area:
            raise ValueError(f"AVIF: an ispe of {w}x{h}, past libavif's or PIL's limits")
        return w, h

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

    # libavif's checks of every item as it parses, used or not: each ipma
    # index within ipco; an item it would decode (av01 or grid, with data,
    # no unknown essential property, no thumbnail) has an ispe of a size it
    # takes (an alpha item too: PIL's libavif decodes with its strict flags)
    thumbnails = {frm for rk, frm, _to in refs if rk == b"thmb"}
    for it in items.values():
        if any(index > len(props) for index, _essential in it.props):
            raise ValueError(f"AVIF: Box[ipma] for item ID [{it.id}] contains an illegal "
                             "property index")
        if (it.type in (b"av01", b"grid") and _item_size(it) and it.id not in thumbnails
                and not unsupported(it)):
            ispe(next((props[i - 1][1:] for i, _e in it.props
                       if i and props[i - 1][0] == b"ispe"), None), LIBAVIF_SIZE_LIMIT)

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
            out.tiles.append(_item_bytes(data, t, idat))
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
        ps, pe = p[b"colr"]
        if data[ps:ps + 4] == b"nclx" and pe - ps >= 11:
            if data[ps + 10] & 0x7F:
                raise ValueError("AVIF: colr nclx reserved bits set")
            cp, tc, mc = struct.unpack(">HHH", data[ps + 4:ps + 10])
            out.nclx = (cp, tc, mc, data[ps + 10] >> 7)
    if b"irot" in p:
        out.rotation = data[p[b"irot"][0]] & 3
    if b"imir" in p:
        out.mirror = data[p[b"imir"][0]] & 1
    if out.grid is None:
        out.color = _item_bytes(data, item, idat)
    for rk, frm, to in refs:
        if rk == b"prem" and (frm == primary or primary in to):
            raise refuse("premultiplied alpha (prem)")

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
            out.alpha = _item_bytes(data, alpha, idat)
        pixi(ap.get(b"pixi"), out.alpha_av1c)
        out.alpha_size = ispe(ap.get(b"ispe"))
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
    out = av1.Frame(tuple(planes), width, height, frame.full_range, frame.matrix, frame.mono,
                    frame.ssx, frame.ssy, frame.primaries, frame.bit_depth)
    out.mi, out.cdef, out.lr, out.ms = frame.mi, frame.cdef, frame.lr, frame.ms
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
                alpha: bool = False) -> av1.Frame:
    """A colour or alpha item's frame at its size: a single item's AV1
    frame scaled to its ispe (`size`), or a grid's tiles, each scaled to
    its own ispe, assembled; ms holds the stages' host ms summed over the
    tiles and, for a grid, the assembly's."""
    if grid is None:
        return to_ispe(av1.decode(stream, plain=plain), *size, plain)
    frames = [to_ispe(av1.decode(t, plain=plain), *s, plain)
              for t, s in zip(grid.tiles, grid.sizes)]
    t0 = time.perf_counter()
    out = assemble(frames, grid, alpha)
    out.ms["assembly"] = (time.perf_counter() - t0) * 1e3
    return out


def decode_avif(data: bytes, plain: bool = False) -> np.ndarray:
    """An AVIF file's bytes to (H, W, 4) uint8 RGBA. `plain` runs the
    numpy twins of utils/av1.py's stages around the C++ tile syntax."""
    still = parse(data)
    color = decode_item(still.color, still.grid, (still.width, still.height), plain)
    alpha = None
    if still.alpha or still.alpha_grid:
        a = decode_item(still.alpha, still.alpha_grid, still.alpha_size, plain, alpha=True)
        if a.bit_depth != color.bit_depth:  # dav1d's alpha plane must match the colour's
            raise ValueError(f"AVIF: a {a.bit_depth}-bit alpha item on a {color.bit_depth}-bit "
                             "colour item (libavif: Decoding of alpha plane failed)")
        if a.width != color.width or a.height != color.height:
            raise ValueError("AVIF: the alpha and colour items differ in size")
        if not a.full_range:
            raise refuse("limited-range alpha")
        alpha = a.planes[0][: a.height, : a.width]
    # the colr box's nclx where there is one, else the sequence header's
    primaries, _transfer, matrix, full = still.nclx or (color.primaries, 2, color.matrix,
                                                        color.full_range)
    rgba = av1.to_rgba(color, alpha, full, matrix, primaries, plain=plain)
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
