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

utils/av1.py decodes the items' AV1 streams. An item whose AV1 frame has
another size than its `ispe` is scaled to ispe's size before the colour
conversion, plane by plane (the chroma planes to half of it, rounded up),
as libavif 1.3.0 scales it (avifImageScale over libyuv's ScalePlane,
av1.scale). The colr box's nclx (else the sequence header's colour
description) picks the YUV -> RGB conversion (av1.conversion); a matrix
and range libavif does not convert raise ValueError, as PIL raises. Refused with NotImplementedError naming AVIF, the feature and
the ROADMAP item: a derived primary item (`grid`, `iovl`), an image
sequence (`avis`, a `moov` track, which PIL reads instead of the primary
item), `clap` cropping, `a1op` / `lsel` layer selection, a premultiplied
alpha (`prem`), a limited-range alpha item, a scale to ispe by libyuv's
3/4 or 3/8 filters or of a 10- or 12-bit frame, and the AV1 features
utils/av1.py refuses (superres, film grain). An alpha item of another bit
depth than the colour item fails, as in libavif ("Decoding of alpha plane
failed" in PIL). A truncated or malformed file raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import av1

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
# an item's largest width or height (libavif's default decoder limit) and
# area (PIL's open raises DecompressionBombError past twice its
# MAX_IMAGE_PIXELS, 89478485)
DIMENSION_LIMIT, SIZE_LIMIT = 32768, 2 * 89478485
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


class Still:
    """The parts of an AVIF still image that the decode needs."""

    def __init__(self):
        self.color = b""       # the primary item's AV1 stream
        self.alpha = b""       # the alpha item's, or b""
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


def _item_bytes(data: bytes, item: Item, idat: bytes) -> bytes:
    src = data if item.method == 0 else idat
    if item.method not in (0, 1):
        raise ValueError(f"AVIF: iloc construction method {item.method}")
    out = bytearray()
    for off, length in item.extents:
        if length == 0:
            length = len(src) - off
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
    if item.type in (b"grid", b"iovl"):
        raise refuse(f"derived images ({item.type.decode()})")
    if item.type != b"av01":
        raise ValueError(f"AVIF: primary item of type {item.type!r}")
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

    def ispe(span) -> tuple:
        if span is None:
            raise ValueError("AVIF: an av01 item without ispe")
        ic = _Cursor(data, *span)
        ic.full()
        w, h = ic.uint(4), ic.uint(4)
        if not (0 < w <= DIMENSION_LIMIT and 0 < h <= DIMENSION_LIMIT) or w * h > SIZE_LIMIT:
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

    if unsupported(item):
        raise ValueError("AVIF: the primary item has an unsupported essential property")
    p = item_props(item)
    out.width, out.height = ispe(p.get(b"ispe"))
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
    out.color = _item_bytes(data, item, idat)
    for rk, frm, to in refs:
        if rk == b"prem" and (frm == primary or primary in to):
            raise refuse("premultiplied alpha (prem)")
    for rk, frm, to in refs:
        if rk != b"auxl" or primary not in to or frm not in items:
            continue
        alpha = items[frm]
        # libavif skips an item with an unknown essential property or of a
        # type it does not decode (avifDecoderItemShouldBeSkipped): no alpha
        if unsupported(alpha) or alpha.type not in (b"av01", b"grid"):
            continue
        if alpha.type == b"grid":
            raise refuse("derived images (grid)")
        ap = item_props(alpha)
        aux = ap.get(b"auxC")
        if aux is None:
            continue
        ac = _Cursor(data, *aux)
        ac.full()
        if ac.cstring() not in ALPHA_URNS:
            continue
        out.alpha_av1c = av1c(ap.get(b"av1C"))
        pixi(ap.get(b"pixi"), out.alpha_av1c)
        out.alpha_size = ispe(ap.get(b"ispe"))
        out.alpha = _item_bytes(data, alpha, idat)
        break
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
    return out


def decode_avif(data: bytes, plain: bool = False) -> np.ndarray:
    """An AVIF file's bytes to (H, W, 4) uint8 RGBA. `plain` runs the
    numpy twins of utils/av1.py's stages around the C++ tile syntax."""
    still = parse(data)
    color = to_ispe(av1.decode(still.color, plain=plain), still.width, still.height, plain)
    alpha = None
    if still.alpha:
        a = av1.decode(still.alpha, plain=plain)
        if a.bit_depth != color.bit_depth:  # dav1d's alpha plane must match the colour's
            raise ValueError(f"AVIF: a {a.bit_depth}-bit alpha item on a {color.bit_depth}-bit "
                             "colour item (libavif: Decoding of alpha plane failed)")
        a = to_ispe(a, *still.alpha_size, plain)
        if a.width != still.width or a.height != still.height:
            raise ValueError("AVIF: the alpha and colour items differ in size")
        if not a.full_range:
            raise refuse("limited-range alpha")
        alpha = a.planes[0][: a.height, : a.width]
    # the colr box's nclx where there is one, else the sequence header's
    primaries, _transfer, matrix, full = still.nclx or (color.primaries, 2, color.matrix,
                                                        color.full_range)
    return av1.to_rgba(color, alpha, full, matrix, primaries, plain=plain)
