"""The port's AVIF container reader (figdraw_tpu_torch/utils/avif.py)
against PIL 12.1.0's `Image.open(...).convert("RGBA")`, which reads AVIF
through libavif 1.3.0 as figdraw_tpu does: the stored fixture equal to
PIL and its digests; the HEIF boxes as libavif reads a still image, on
files PIL writes and on the same items re-muxed here (iloc versions 0-2,
field sizes 0/4/8, construction method 1 from idat, split extents, infe
version 3, 15-bit ipma indices, an alpha item named by auxl), each equal
to PIL's decode of the same bytes; irot / imir read and not applied, as
PIL; a grid primary item equal to PIL (tests/test_torch_avif_grid.py
holds the grids) and an iovl one raising ValueError as PIL fails; the
features outside the slice refused with NotImplementedError naming AVIF,
the feature, the path and the ROADMAP item (avis, clap, a1op, lsel,
prem); an AV1 frame of another size than its item's
ispe scaled to it as libavif scales it (libyuv's ScalePlane: the C++
scaler and its twin held to libavif's own avifImageScale, and PIL's
decodes of files whose ispe is patched), the 3/4 and 3/8 scales refused;
truncated and corrupt files raising or decoding as PIL does
(tools/avif_fuzz_agreement.py's cases, and the libavif and dav1d rules
they found); load_image of each stored fixture (PIL's default save, the
speed-2 CDEF file, the 4:4:4 file and the limited-range BT.709 4:2:2 file
with CDEF and loop restoration) against figdraw_tpu's (image, mips,
sidecar) and its frames against figdraw_tpu's block means, as of the three
made 10- and 12-bit from the CDEF, 4:4:4 and 4:2:2 files."""

import ctypes
import glob
import hashlib
import io
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import (
    AVIF_422_12_FILE_REFERENCE, AVIF_422_12_FIXTURE, AVIF_422_12_WALL_REFERENCE,
    AVIF_422_FILE_REFERENCE, AVIF_422_FIXTURE, AVIF_422_WALL_REFERENCE,
    AVIF_444_10_FILE_REFERENCE, AVIF_444_10_FIXTURE, AVIF_444_10_WALL_REFERENCE,
    AVIF_444_FILE_REFERENCE, AVIF_444_FIXTURE, AVIF_444_WALL_REFERENCE,
    AVIF_CDEF10_FILE_REFERENCE, AVIF_CDEF10_FIXTURE, AVIF_CDEF10_WALL_REFERENCE,
    AVIF_CDEF_FILE_REFERENCE, AVIF_CDEF_FIXTURE, AVIF_CDEF_WALL_REFERENCE, AVIF_FILE_REFERENCE,
    AVIF_FIXTURE, AVIF_GRAIN_422_10_FILE_REFERENCE, AVIF_GRAIN_422_10_FIXTURE,
    AVIF_GRAIN_422_10_WALL_REFERENCE, AVIF_GRAIN_FILE_REFERENCE, AVIF_GRAIN_FIXTURE,
    AVIF_GRAIN_WALL_REFERENCE, AVIF_WALL_REFERENCE, IMAGE_FIXTURE, IMAGE_FORMATS_REFERENCE,
)
from figdraw_tpu_torch.utils import av1, avif, imagefile
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import avif_fuzz_agreement as fuzz  # noqa: E402

torch.set_num_threads(1)

ROADMAP_ITEM = "Image formats other than PNG"


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _crop(w=130, h=96, alpha=False) -> np.ndarray:
    px = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))[200:200 + h, 300:300 + w].copy()
    if alpha:
        px[..., 3] = np.linspace(0, 255, w).astype(np.uint8)[None, :]
        return px
    return np.ascontiguousarray(px[..., :3])


def _pil_avif(px: np.ndarray, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(px).save(out, "AVIF", **kw)
    return out.getvalue()


def _same(data: bytes) -> np.ndarray:
    want = _pil(data)
    got = imagefile.decode_image(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


# --- a small HEIF writer: PIL's items re-muxed ----------------------------------------

def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def full(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags) + payload)


def _props(data: bytes) -> tuple:
    """PIL's file: (ipco children as bytes, each item's (id, type, property
    indices, stream), auxl reference or None)."""
    still = avif.parse(data)
    top = list(avif._boxes(data, 0, len(data), top=True))
    _k, ms, me = [b for b in top if b[0] == b"meta"][0]
    ipco, ipma = [], {}
    for kind, s, e in avif._boxes(data, ms + 4, me):
        if kind == b"iprp":
            for pk, ps, pe in avif._boxes(data, s, e):
                if pk == b"ipco":
                    ipco = [data[a - 8:b] for _kk, a, b in avif._boxes(data, ps, pe)]
                elif pk == b"ipma":
                    c = avif._Cursor(data, ps, pe)
                    _v, flags = c.full((0, 1))
                    for _ in range(c.uint(4)):
                        item = c.uint(2)
                        ipma[item] = [c.uint(2 if flags & 1 else 1) & (0x7FFF if flags & 1 else 0x7F)
                                      for _a in range(c.uint(1))]
    items = [(1, b"av01", ipma[1], still.color)]
    if still.alpha:
        items.append((2, b"av01", ipma[2], still.alpha))
    return ipco, items


def remux(data: bytes, iloc_version=0, sizes=(4, 4, 0, 0), method=0, split=1,
          infe_version=2, ipma_15bit=False, extra_props=(), primary_type=b"av01",
          refs=None, ftyp=b"avif\0\0\0\0avifmif1miafMA1B", moov=False) -> bytes:
    """PIL's file with its meta rebuilt: the given iloc version, field
    sizes (offset, length, base offset, index), construction method (1:
    the streams in idat), each stream split in `split` extents, infe
    version, 15-bit ipma indices, extra properties (kind, payload) on the
    primary item, the primary item's type and the iref children."""
    ipco, items = _props(data)
    for kind, payload in extra_props:
        ipco.append(box(kind, payload))
    n_extra = len(extra_props)
    off_size, len_size, base_size, index_size = sizes
    if refs is None:
        refs = [(b"auxl", 2, [1])] if len(items) > 1 else []
    head = box(b"ftyp", ftyp)
    hdlr = full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 12 + b"\0")
    pitm = full(b"pitm", 0, 0, struct.pack(">H", 1))
    infe = b"".join(full(b"infe", infe_version, 0,
                         (struct.pack(">H", i) if infe_version == 2 else struct.pack(">I", i))
                         + b"\0\0" + (primary_type if i == 1 else t) + b"\0")
                    for i, t, _p, _s in items)
    iinf = full(b"iinf", 0, 0, struct.pack(">H", len(items)) + infe)
    iref = full(b"iref", 0, 0, b"".join(
        box(k, struct.pack(">HH", f, len(to)) + b"".join(struct.pack(">H", t) for t in to))
        for k, f, to in refs)) if refs else b""
    assoc = b""
    for i, _t, props, _s in items:
        plist = list(props) + (list(range(len(ipco) - n_extra + 1, len(ipco) + 1)) if i == 1 else [])
        assoc += struct.pack(">HB", i, len(plist))
        for p in plist:
            assoc += struct.pack(">H", p | 0x8000) if ipma_15bit else bytes([p | 0x80])
    ipma = full(b"ipma", 0, 1 if ipma_15bit else 0, struct.pack(">I", len(items)) + assoc)
    iprp = box(b"iprp", box(b"ipco", b"".join(ipco)) + ipma)

    def sized(v, n):
        return v.to_bytes(n, "big") if n else b""

    def build(offsets):
        body = struct.pack(">H", (off_size << 12) | (len_size << 8) | (base_size << 4)
                           | (index_size if iloc_version else 0))
        body += struct.pack(">I" if iloc_version == 2 else ">H", len(items))
        for (i, _t, _p, stream), exts in zip(items, offsets):
            body += struct.pack(">I" if iloc_version == 2 else ">H", i)
            if iloc_version:
                body += struct.pack(">H", method)
            body += struct.pack(">H", 0) + sized(0, base_size) + struct.pack(">H", len(exts))
            for k, (o, ln) in enumerate(exts):
                if iloc_version and index_size:
                    body += sized(k, index_size)
                body += sized(o, off_size) + sized(ln, len_size)
        iloc = full(b"iloc", iloc_version, 0, body)
        parts = [hdlr, pitm, iloc, iinf] + ([iref] if iref else []) + [iprp]
        if method == 1:
            parts.append(box(b"idat", b"".join(s for _i, _t, _p, s in items)))
        return head + full(b"meta", 0, 0, b"".join(parts))

    def extents(base):
        out, pos = [], base
        for _i, _t, _p, stream in items:
            cuts = np.linspace(0, len(stream), split + 1).astype(int)
            out.append([(pos + int(a), int(b - a)) for a, b in zip(cuts[:-1], cuts[1:])])
            pos += len(stream)
        return out

    streams = b"".join(s for _i, _t, _p, s in items)
    meta = build(extents(0))
    if method == 1:
        out = meta
    else:
        base = len(meta) + 8
        meta = build(extents(base))
        out = meta + box(b"mdat", streams)
    if moov:
        out += box(b"moov", b"")
    return out


# --- the stored fixtures -----------------------------------------------------------

# each stored AVIF with figdraw_tpu's block means of its image-file scene
# and of its 480x270 photo wall
FIXTURES = {"q75": (AVIF_FIXTURE, AVIF_FILE_REFERENCE, AVIF_WALL_REFERENCE),
            "s2_cdef": (AVIF_CDEF_FIXTURE, AVIF_CDEF_FILE_REFERENCE, AVIF_CDEF_WALL_REFERENCE),
            "444": (AVIF_444_FIXTURE, AVIF_444_FILE_REFERENCE, AVIF_444_WALL_REFERENCE),
            "422_limited_cdef": (AVIF_422_FIXTURE, AVIF_422_FILE_REFERENCE,
                                 AVIF_422_WALL_REFERENCE),
            # the three made 10- and 12-bit (tests/test_torch_av1_depth.py)
            "s2_cdef_10bit": (AVIF_CDEF10_FIXTURE, AVIF_CDEF10_FILE_REFERENCE,
                              AVIF_CDEF10_WALL_REFERENCE),
            "444_10bit": (AVIF_444_10_FIXTURE, AVIF_444_10_FILE_REFERENCE,
                          AVIF_444_10_WALL_REFERENCE),
            "422_12bit": (AVIF_422_12_FIXTURE, AVIF_422_12_FILE_REFERENCE,
                          AVIF_422_12_WALL_REFERENCE),
            # film grain (tests/test_torch_av1_film_grain.py)
            "grain": (AVIF_GRAIN_FIXTURE, AVIF_GRAIN_FILE_REFERENCE, AVIF_GRAIN_WALL_REFERENCE),
            "grain_422_10bit": (AVIF_GRAIN_422_10_FIXTURE, AVIF_GRAIN_422_10_FILE_REFERENCE,
                                AVIF_GRAIN_422_10_WALL_REFERENCE)}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_stored_fixture_equals_pil_and_its_digests(fixture):
    path = FIXTURES[fixture][0]
    with open(path, "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        ref = json.load(fh)["files"][os.path.basename(path)]
    assert hashlib.sha256(data).hexdigest() == ref["sha256"]
    got = _same(data)
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["decoded_sha256"]
    assert list(got.shape) == ref["shape"] == [600, 800, 4]


def test_the_cdef_fixture_turns_on_both_post_filters():
    """PIL's speed-2 save with aom's CDEF: CDEF indices at its 64x64s and
    Wiener and self-guided restoration units (chip_smoke.py holds the
    card's decode of it to PIL's digest and its stages to their twins)."""
    with open(AVIF_CDEF_FIXTURE, "rb") as fh:
        frame = av1.decode(avif.parse(fh.read()).color)
    assert (frame.cdef >= 0).any()
    types = set(frame.lr[..., av1.L_TYPE].ravel().tolist())
    assert {av1.RESTORE_WIENER, av1.RESTORE_SGRPROJ} <= types


def test_fixture_boxes():
    """PIL's default save: ftyp avif, one av01 item of 800x600, av1C of
    profile 0, 8 bits, 4:2:0, colr nclx BT.709 primaries, sRGB transfer,
    BT.601 matrix, full range; no alpha (PIL drops an opaque one)."""
    with open(AVIF_FIXTURE, "rb") as fh:
        still = avif.parse(fh.read())
    assert (still.width, still.height) == (800, 600)
    assert still.av1c == (0, 0, 0, 0, 1, 1)
    assert still.nclx == (1, 13, 6, 1)
    assert not still.alpha and still.alpha_av1c is None


def test_alpha_item_is_read_through_auxl():
    data = _pil_avif(_crop(alpha=True))
    still = avif.parse(data)
    assert still.alpha and still.alpha_av1c[3] == 1  # monochrome
    got = _same(data)
    assert got[..., 3].min() == 0 and got[..., 3].max() == 255


# --- re-muxed items ----------------------------------------------------------------

@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("layout", [
    dict(iloc_version=0, sizes=(4, 4, 0, 0)),
    dict(iloc_version=0, sizes=(8, 8, 4, 0), split=3),
    dict(iloc_version=1, sizes=(4, 4, 0, 4), split=2),
    dict(iloc_version=2, sizes=(8, 4, 8, 8)),
    dict(iloc_version=1, sizes=(4, 4, 0, 0), method=1),
    dict(iloc_version=2, sizes=(4, 4, 0, 0), method=1, split=2),
    dict(infe_version=3),
    dict(ipma_15bit=True),
])
def test_remuxed_items_equal_pil(layout, alpha):
    data = remux(_pil_avif(_crop(61, 47, alpha=alpha)), **layout)
    _same(data)


def test_remux_round_trips_pils_file():
    src = _pil_avif(_crop(alpha=True))
    np.testing.assert_array_equal(_pil(remux(src)), _pil(src))


def test_irot_and_imir_are_not_applied():
    """PIL writes EXIF orientation 6 as irot (and others with imir) and
    returns the pixels unrotated, reporting the orientation as EXIF."""
    px = _crop()
    for orientation, rot, mirror in ((6, 3, None), (3, 2, None), (2, 0, 1), (5, 1, 0)):
        exif = Image.Exif()
        exif[0x0112] = orientation
        data = _pil_avif(px, exif=exif.tobytes())
        still = avif.parse(data)
        assert (still.rotation, still.mirror) == (rot, mirror)
        assert _same(data).shape == (96, 130, 4)


def test_icc_profile_is_ignored():
    from PIL import ImageCms

    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    _same(_pil_avif(_crop(), icc_profile=icc))


# --- refused features ---------------------------------------------------------------

def _refused(data: bytes, feature: str, tmp_path) -> None:
    path = str(tmp_path / "photo.avif")
    with open(path, "wb") as fh:
        fh.write(data)
    assert imagefile.format_of(data) == "AVIF"
    with pytest.raises(NotImplementedError,
                       match=rf"AVIF images with {feature}.*photo\.avif.*{ROADMAP_ITEM}"):
        imagefile.read_image(path)


# each case names what it once refused: clap, a1op, lsel, prem and a moov
# are read since utils/avif.py reads them as PIL does; each file now also
# has a 3/4 scale to its ispe (ROADMAP item 1.3, entry 10), which stays
# refused whatever the feature beside it
SCALE_REFUSAL = "an AV1 frame of another size than ispe"


@pytest.mark.parametrize("feature, kw", [
    pytest.param(SCALE_REFUSAL, dict(extra_props=[(b"clap", b"\0" * 32)]),
                 id="clean-aperture cropping-kw0"),
    pytest.param(SCALE_REFUSAL, dict(extra_props=[(b"a1op", b"\0")]),
                 id="operating point selection-kw1"),
    pytest.param(SCALE_REFUSAL, dict(extra_props=[(b"lsel", b"\0\0")]), id="layer selection-kw2"),
    pytest.param(SCALE_REFUSAL, dict(refs=[(b"auxl", 2, [1]), (b"prem", 1, [2])]),
                 id="premultiplied alpha-kw3"),
    pytest.param(SCALE_REFUSAL, dict(moov=True), id="image sequences-kw4"),
])
def test_features_outside_the_slice_are_refused(feature, kw, tmp_path):
    src = _pil_avif(_crop(96, 64, alpha=True))
    data = remux(src, **kw)
    if "moov" not in kw:  # the feature alone is read as PIL reads it
        _same(data)
    _refused(_with_ispe(data, 72, 48), feature, tmp_path)


@pytest.mark.parametrize("kind", ["grid", "iovl"])
def test_derived_primary_items(kind):
    """A grid primary item (libavif's own encoder writes one; PIL's save
    does not) decodes equal to PIL; the same file with its grid item
    renamed iovl fails in PIL (libavif 1.3.0 reads no overlay: "Missing or
    empty image item") and raises ValueError in the port."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_image_formats import Heif, avif_grid

    data = avif_grid(_crop(130, 96, alpha=True), 3, 2, (64, 64))
    if kind == "grid":
        assert avif.parse(data).grid is not None
        _same(data)
        return
    heif = Heif(data)
    heif.items[heif.primary]["type"] = b"iovl"
    data = heif.write()
    with pytest.raises(Exception, match="Missing or empty image item"):
        _pil(data)
    with pytest.raises(ValueError, match="Missing or empty image item"):
        imagefile.decode_image(data)


def test_pils_image_sequence_is_refused(tmp_path):
    """PIL's image sequence is read (tests/test_torch_avif_sequence.py);
    one whose tracks' size is 3/4 of its frames' stays refused, naming the
    scale (ROADMAP item 1.3, entry 10)."""
    from make_image_formats import with_track_size

    frames = [Image.fromarray(_crop(32, 24)), Image.fromarray(_crop(32, 24)[::-1].copy())]
    out = io.BytesIO()
    frames[0].save(out, "AVIF", save_all=True, append_images=frames[1:])
    _same(out.getvalue())
    _refused(with_track_size(out.getvalue(), 24, 18), SCALE_REFUSAL, tmp_path)


def test_pils_premultiplied_alpha_is_refused(tmp_path):
    """PIL's premultiplied alpha is read; with a 3/4 ispe the file stays
    refused, naming the scale."""
    data = _pil_avif(_crop(96, 64, alpha=True), alpha_premultiplied=True)
    _same(data)
    _refused(_with_ispe(data, 72, 48), SCALE_REFUSAL, tmp_path)


# --- an AV1 frame of another size than ispe -----------------------------------------

def _with_ispe(data: bytes, w: int, h: int) -> bytes:
    """The file with every ispe box set to w x h (PIL's items share one)."""
    out = bytearray(data)
    at = out.find(b"ispe")
    while at >= 0:
        out[at + 8:at + 16] = struct.pack(">II", w, h)
        at = out.find(b"ispe", at + 4)
    return bytes(out)


# ispe sizes over a 96x64 frame: the four the ROADMAP's probe tried, then
# each axis alone, odd sizes, exact halves, quarters and doubles, 1x1
ISPE_SIZES = [(80, 64), (96, 48), (128, 64), (96, 80), (61, 37), (97, 65), (33, 100),
              (48, 32), (24, 16), (192, 128), (191, 127), (200, 129), (1, 1)]


@pytest.mark.parametrize("kind", ["rgb", "alpha", "mono", "cdef", "444", "422"])
@pytest.mark.parametrize("size", ISPE_SIZES)
def test_a_frame_of_another_size_than_ispe_is_scaled_as_pil(size, kind):
    """libavif scales the decoded planes to the item's ispe before its
    colour conversion (the alpha item's plane too; each chroma plane by its
    own subsampling); the port equals PIL byte for byte with and without
    alpha, in 4:0:0, 4:4:4 and limited-range 4:2:2, with CDEF on."""
    kw = {"mono": dict(subsampling="4:0:0"),
          "cdef": dict(speed=2, advanced={"enable-cdef": "1"}),
          "444": dict(subsampling="4:4:4"),
          "422": dict(subsampling="4:2:2", range="limited")}.get(kind, {})
    data = _with_ispe(_pil_avif(_crop(96, 64, alpha=kind == "alpha"), **kw), *size)
    assert _same(data).shape == (size[1], size[0], 4)


@pytest.mark.parametrize("size", [(40000, 10), (14000, 14000), (0, 64)])
def test_an_ispe_past_the_limits_raises(size):
    """A side past libavif's 32768, an area past twice PIL's
    MAX_IMAGE_PIXELS, or an empty side: PIL raises on open, the port
    raises ValueError before it decodes or scales."""
    data = _with_ispe(_pil_avif(_crop(96, 64)), *size)
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError, match="ispe"):
        imagefile.decode_image(data)


@pytest.mark.parametrize("size", [(72, 48), (36, 24)])
def test_a_three_quarter_or_three_eighth_scale_is_refused(size, tmp_path):
    _refused(_with_ispe(_pil_avif(_crop(96, 64)), *size), "an AV1 frame of another size than ispe",
             tmp_path)


def _libavif():
    paths = glob.glob(os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                                   "pillow.libs", "libavif-*.so*"))
    if not paths:
        pytest.skip("no libavif beside PIL on this host")
    lib = ctypes.CDLL(paths[0])
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
    lib.avifImageAllocatePlanes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.avifImageScale.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                                   ctypes.c_void_p]
    lib.avifImageDestroy.argtypes = [ctypes.c_void_p]
    return lib


def _avif_scale(lib, plane: np.ndarray, dw: int, dh: int, depth: int = 8) -> np.ndarray:
    """libavif 1.3.0's avifImageScale of a 4:0:0 image of `depth` bits
    (uint16 samples past 8): its Y plane (avifImage: width, height, depth,
    format, range, chroma position, then the three plane pointers at byte
    24 and their row bytes at 48)."""
    h, w = plane.shape
    img = lib.avifImageCreate(w, h, depth, 4)
    assert lib.avifImageAllocatePlanes(img, 1) == 0

    def y_plane():
        raw = bytes((ctypes.c_uint8 * 56).from_address(img))
        return int.from_bytes(raw[24:32], "little"), int.from_bytes(raw[48:52], "little")

    dtype = np.uint8 if depth == 8 else np.uint16
    plane = np.ascontiguousarray(plane, dtype)
    ptr, stride = y_plane()
    for r in range(h):
        ctypes.memmove(ptr + r * stride, plane[r].ctypes.data, w * plane.itemsize)
    diag = ctypes.create_string_buffer(1024)
    assert lib.avifImageScale(img, dw, dh, diag) == 0
    ptr, stride = y_plane()
    out = np.frombuffer(bytes((ctypes.c_uint8 * (stride * dh)).from_address(ptr)), dtype)
    lib.avifImageDestroy(img)
    return out.reshape(dh, stride // plane.itemsize)[:, :dw]


def test_scale_and_its_twin_equal_libavifs_scale():
    """fd_av1_scale and scale_plain against libavif's own avifImageScale
    (PIL's libavif, through ctypes) on seeded planes over every path of
    libyuv's ScalePlane the port takes: vertical only, exact halves and
    quarters, box means, 2x linear and bilinear, bilinear up and down,
    point sampling of one-wide planes; the 3/4 and 3/8 scales refused."""
    lib = _libavif()
    rng = np.random.default_rng(26)
    refused = 0
    for trial in range(400):
        sw, sh = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        dw, dh = int(rng.integers(1, 140)), int(rng.integers(1, 140))
        k = trial % 10
        if k == 0:
            dw = sw
        elif k == 1:
            dh = sh
        elif k in (2, 3):
            dw, dh = max(1, sw // (2 * (k - 1))), max(1, sh // (2 * (k - 1)))
        elif k == 4:
            dw, dh = 2 * sw - (trial & 1), 2 * sh - ((trial >> 1) & 1)
        elif k == 5:
            dw = 2 * sw - (trial & 1)
        elif k == 6:
            sw = 1
        elif k == 7:
            sw, sh = 4 * int(rng.integers(1, 12)), 8 * int(rng.integers(1, 6))
            dw, dh = (3 * sw // 4, 3 * sh // 4) if trial & 1 else (3 * sw // 8, 3 * sh // 8)
        dw, dh = max(1, dw), max(1, dh)
        src = rng.integers(0, 256, (sh, sw), np.uint8)
        if trial % 3 == 0:
            src = np.clip(np.add.outer(np.arange(sh) * 5, np.arange(sw) * 3) + 20, 0, 255).astype(np.uint8)
        want = _avif_scale(lib, src, dw, dh)
        twin = av1.scale_plain(src, dw, dh)
        if twin is None:
            with pytest.raises(NotImplementedError, match="another size than ispe"):
                av1.scale(src, sw, sh, dw, dh)
            refused += 1
            continue
        np.testing.assert_array_equal(twin, want, err_msg=f"{sw}x{sh} to {dw}x{dh}")
        np.testing.assert_array_equal(av1.scale(src, sw, sh, dw, dh, plain=True), want)
    assert refused == 40  # every 3/4 and 3/8 trial


# --- truncated and corrupt files ----------------------------------------------------

def test_truncations_raise_value_error():
    data = _pil_avif(_crop(65, 65, alpha=True))
    for cut in list(range(0, 300, 7)) + list(range(300, len(data), max(1, len(data) // 40))):
        with pytest.raises((ValueError, NotImplementedError)):
            imagefile.decode_image(data[:cut])


def _patched(data: bytes, old: bytes, new: bytes, nth: int = 0) -> bytes:
    at = -1
    for _ in range(nth + 1):
        at = data.find(old, at + 1)
    assert at >= 0
    return data[:at] + new + data[at + len(old):]


@pytest.mark.parametrize("case", ["infe name", "av1C version", "alpha av1C type", "forbidden bit"])
def test_container_rules_found_by_the_corrupt_cases(case):
    """The four rules `--corrupt` found once CDEF was drawn (PERF.md): an
    infe item name without its terminator and an av1C of another marker or
    version fail in libavif (ValueError); an essential property of an
    unknown type makes libavif skip the item (the alpha item here: no
    alpha); dav1d reads past an OBU's forbidden bit."""
    src = _pil_avif(_crop(66, 40, alpha=True))
    if case == "infe name":
        data = _patched(src, b"Color\0", b"Color\4")
    elif case == "av1C version":
        at = src.find(b"av1C") + 4
        data = src[:at] + bytes([src[at] | 2]) + src[at + 1:]
    elif case == "alpha av1C type":
        data = _patched(src, b"av1C", b"!v1C", nth=1)
    else:
        still = avif.parse(src)
        at = src.find(still.color)
        data = src[:at] + bytes([src[at] | 0x80]) + src[at + 1:]
    if case in ("infe name", "av1C version"):
        with pytest.raises(Exception):
            _pil(data)
        with pytest.raises(ValueError):
            imagefile.decode_image(data)
        return
    got = _same(data)
    if case == "alpha av1C type":
        assert (got[..., 3] == 255).all()


@pytest.mark.parametrize("case", ["colour", "colour with alpha", "alpha", "iloc length size"])
def test_an_extent_of_length_zero_holds_nothing(case):
    """libavif 1.3.0 reads an iloc extent length of 0 as no bytes (not as
    "to the end of the file") and skips an item without data: an empty
    colour item is "Missing or empty image item", an empty alpha item
    leaves the image opaque. Found by `--grain --corrupt` (seed 2 index
    73: a bit flip set the iloc's length_size to 0)."""
    src = _pil_avif(_crop(64, 48, alpha=case in ("colour with alpha", "alpha")))
    at = src.find(b"iloc")
    if case == "iloc length size":  # v0, offset and length sizes 4: length_size 0
        data = src[:at + 8] + bytes([0x40]) + src[at + 9:]
    else:
        entry = at + 12 + 14 * (case == "alpha")  # v0: id, ref index, count, offset, length
        data = src[:entry + 10] + bytes(4) + src[entry + 14:]
    if case == "alpha":
        assert (_same(data)[..., 3] == 255).all()
        return
    with pytest.raises(Exception, match="Missing or empty image item"):
        _pil(data)
    with pytest.raises(ValueError, match="Missing or empty image item"):
        imagefile.decode_image(data)


@pytest.mark.parametrize("seed", range(2))
def test_corrupt_cases_raise_or_decode_as_pil(seed):
    """Seeded truncations and bit flips (tools/avif_fuzz_agreement.py
    --corrupt): the port raises ValueError or NotImplementedError, or
    decodes as PIL does; where PIL raises, the port raises too (the
    symbol decoder's overread past 14 bits, libavif's box checks)."""
    for _i, _options, data in fuzz.corrupt_cases(seed, 40):
        try:
            want = _pil(data)
        except Exception:  # noqa: BLE001 - PIL's own error
            want = None
        try:
            got = imagefile.decode_image(data)
        except (ValueError, NotImplementedError):
            continue
        assert want is not None
        np.testing.assert_array_equal(got, want)


# --- against the JAX package: load_image, the sidecar and the frames ----------------

@pytest.fixture(params=sorted(FIXTURES))
def avif_copies(request, tmp_path):
    """Each stored fixture copied twice (each package writes its own
    sidecar beside its file): (port path, jax path, the fixture's name)."""
    src = FIXTURES[request.param][0]
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(src)))
        shutil.copyfile(src, paths[-1])
    return paths + [request.param]


def test_load_image_gives_figdraw_tpus_image_mips_and_sidecar(avif_copies):
    """Cold (decode, bleed, chain, sidecar) and warm (the sidecar) in both
    packages: the same pixels, mips and sidecar bytes, whose digest
    chip_smoke.py holds the card to."""
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    port_path, jax_path, fixture = avif_copies
    jax_flippy()
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    with open(port_path, "rb") as fh:
        pil = _pil(fh.read())
    for _ in range(2):
        ref, jref = resources.load_image(port_path, bus=bus), jres.load_image(jax_path, bus=jbus)
        a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
        b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
        np.testing.assert_array_equal(a.image, np.asarray(b.image))
        np.testing.assert_array_equal(a.image, pil)
        assert len(a.mips) == len(b.mips) == 10
        for x, y in zip(a.mips, b.mips):
            np.testing.assert_array_equal(x, np.asarray(y))
        with open(port_path + ".flippy", "rb") as fh, open(jax_path + ".flippy", "rb") as jfh:
            sidecar = fh.read()
            assert sidecar == jfh.read()
        with open(IMAGE_FORMATS_REFERENCE) as fh:
            want = json.load(fh)["sidecar"][os.path.basename(FIXTURES[fixture][0])]
        assert hashlib.sha256(sidecar).hexdigest() == want
        ref.close()
        jref.close()
        resources.clear_image_cache(bus=bus)
        jres.clear_image_cache(bus=jbus)


def test_image_file_scene_from_avif_matches_jax(avif_copies):
    """The image-file scene with the AVIF loaded: within 1e-5 of
    figdraw_tpu's block means, which the stored reference holds (chip_smoke.py
    holds the card to it), and within 1/255 of its frame."""
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_image_file_frame

    from figdraw_tpu_torch.scenes import render_image_file

    port_path, jax_path, fixture = avif_copies
    want = jax_image_file_frame(jax_path, "1x")
    _ren, frame, ref = render_image_file(
        lambda ps: port.FigRenderer(atlas_size=512, device="cpu", pixel_scale=ps),
        port_path, "1x")
    got = frame.numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(FIXTURES[fixture][1])
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()


def test_photo_wall_from_avif_matches_jax(avif_copies):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import PHOTO_WALL_SMALL, make_loaded_photo_wall

    port_path, jax_path, fixture = avif_copies
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_path, w, h, n)
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(port_path, bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(FIXTURES[fixture][2])
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()
