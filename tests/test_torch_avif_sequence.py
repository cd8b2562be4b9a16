"""AVIF image sequences, premultiplied and limited-range alpha, and the
clap, a1op, lsel and a1lx properties in the port's reader
(figdraw_tpu_torch/utils/avif.py, utils/av1.py) against PIL 12.1.0's
`Image.open(...).convert("RGBA")`, which reads the first frame of a
sequence through libavif 1.3.0 as figdraw_tpu does.

PIL's save_all files (2 and 3 frames, RGB and RGBA, every subsampling, at
10 and 12 bits through tools/make_image_formats.py's avis_at_depth, with
film grain) decode equal to PIL byte for byte, as do the same samples in
other layouts (a chunk a sample, co64, one sample size for all, moov before
meta; the tool's Avis writes them). libavif's source rule is shown by a file
whose meta item and first track sample hold different pictures, under each
major brand. Each check libavif makes of the tracks and their sample
tables is shown by a file PIL refuses, on which the port raises ValueError.
The full sequence and frame headers that a track's key frame may carry
(timing and decoder model info, operating points with their layers, frame
ids, screen content tools, no order hint, a frame split into a frame
header and a tile group, OBU extension headers) are written by rewriting
the first sample (stream_variant) and decode equal to PIL, as do an a1op
and an lsel that select by those layers. Premultiplied alpha (PIL's
alpha_premultiplied, or a prem reference) and a limited-range alpha item
(limited_alpha) decode equal at 8, 10 and 12 bits, each C++ stage
(fd_av1_unattenuate, fd_av1_alpha_range) equal to its numpy twin. The
stored sequence and the files chip_smoke.py rewrites from it on the card
equal their stored digests, and its load_image, image-file scene and photo
wall equal figdraw_tpu's on the CPU."""

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import (
    AVIF_SEQUENCE_FILE_REFERENCE, AVIF_SEQUENCE_FIXTURE, AVIF_SEQUENCE_LIMITED_FILE_REFERENCE,
    AVIF_SEQUENCE_LIMITED_WALL_REFERENCE, AVIF_SEQUENCE_WALL_REFERENCE, IMAGE_FIXTURE,
    IMAGE_FORMATS_REFERENCE,
)
from figdraw_tpu_torch.utils import av1, avif, imagefile
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import avif_fuzz_agreement as fuzz  # noqa: E402
import make_image_formats as tool  # noqa: E402
from make_image_formats import Avis, Heif  # noqa: E402

torch.set_num_threads(1)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _same(data: bytes) -> np.ndarray:
    want = _pil(data)
    got = imagefile.decode_image(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _both_raise(data: bytes) -> None:
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError):
        imagefile.decode_image(data)


def _crops(n: int, w: int, h: int, alpha: bool, y: int = 200) -> list:
    """n crops of the PNG fixture, each moved 5 rows, with an alpha ramp."""
    src = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))
    out = []
    for k in range(n):
        px = src[y + 5 * k:y + 5 * k + h, 300:300 + w].copy()
        if alpha:
            px[..., 3] = np.linspace(0, 255, w).astype(np.uint8)[None, :]
        out.append(np.ascontiguousarray(px if alpha else px[..., :3]))
    return out


def _sequence(n: int = 2, w: int = 96, h: int = 64, alpha: bool = True, y: int = 200,
              **kw) -> bytes:
    frames = [Image.fromarray(px) for px in _crops(n, w, h, alpha, y)]
    out = io.BytesIO()
    frames[0].save(out, "AVIF", save_all=True, append_images=frames[1:], **kw)
    return tool.steady_times(out.getvalue())


def _still(px: np.ndarray, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(px).save(out, "AVIF", **kw)
    return out.getvalue()


@pytest.fixture(scope="module")
def seq() -> bytes:
    return _sequence()


# --- PIL's sequences --------------------------------------------------------------------

@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4", "4:2:2", "4:0:0"])
@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("frames", [2, 3])
def test_pils_sequences_equal_pil(frames, alpha, subsampling):
    data = _sequence(frames, alpha=alpha, subsampling=subsampling)
    still = avif.parse(data)
    assert still.track is not None and bool(still.alpha) == alpha
    _same(data)


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("depth", [10, 12])
def test_sequences_at_higher_depths_equal_pil(depth, alpha, subsampling):
    data = tool.avis_at_depth(_sequence(alpha=alpha, subsampling=subsampling), depth)
    assert av1.decode(avif.parse(data).color).bit_depth == depth
    _same(data)


@pytest.mark.parametrize("vector", [1, 2, 10])
def test_film_grain_on_the_first_sample_equals_pil(vector):
    data = _sequence(advanced={"film-grain-test": str(vector)})
    assert av1.grain_applies(av1.decode(avif.parse(data).color).grain)
    _same(data)


GRAIN = {"seed": 4321, "y": [(0, 20), (128, 70), (255, 30)], "cb": [(0, 40), (255, 20)],
         "cr": [(0, 10), (255, 50)], "csfl": 0, "scaling_shift": 9, "lag": 2,
         "ar_y": [3, -5, 10, 2, -1, 7, 4, -8, 6, 1, 0, 9],
         "ar_cb": [2, -3, 5, 1, 0, 4, -2, 3, 1, -1, 2, 0, 6],
         "ar_cr": [-2, 3, -5, 1, 2, 0, 3, -1, 4, 2, -3, 1, 5], "ar_shift": 7,
         "grain_scale_shift": 0, "cb_mult": 140, "cb_luma_mult": 180, "cb_offset": 20,
         "cr_mult": 100, "cr_luma_mult": 200, "cr_offset": -30, "overlap": 1, "clip": 1}


def test_rewritten_film_grain_of_the_first_sample_equals_pil():
    """The first sample's film_grain_params replaced (stream_with_grain on
    a sequence aom wrote with film grain): a full frame header's grain."""
    a = Avis(_sequence(advanced={"film-grain-test": "1"}))
    for t in a.tracks:
        t["samples"][0] = tool.stream_with_grain(t["samples"][0], GRAIN)
    for item in a.heif.items.values():
        item["data"] = tool.stream_with_grain(item["data"], GRAIN)
    data = a.write()
    assert av1.decode(avif.parse(data).color).grain[av1.G_NUM_Y] == 3
    _same(data)


# --- the source libavif picks -----------------------------------------------------------

def _two_pictures() -> Avis:
    """A sequence whose meta items hold another picture than its tracks'
    first samples (a still of another crop of the same size)."""
    a = Avis(_sequence())
    other = Heif(_still(_crops(1, 96, 64, True, y=400)[0]))
    for i, item in a.heif.items.items():
        item["data"] = other.items[i]["data"]
    return a


@pytest.mark.parametrize("major, compatible, order, source", [
    (b"avis", b"avifavismsf1iso8mif1miaf", "meta first", "track"),
    (b"avif", b"avifavismsf1iso8mif1miaf", "meta first", "item"),
    (b"mif1", b"avifavismif1", "meta first", "track"),
    (b"msf1", b"avifavismif1", "meta first", "track"),
    # no avis brand: the walk stops after meta, and a moov after it is
    # never read; a moov before it is
    (b"mif1", b"avifmif1", "meta first", "item"),
    (b"mif1", b"avifmif1", "moov first", "track"),
    (b"avif", b"avifmif1", "moov first", "item"),
    # no avif brand: the file needs no meta
    (b"avis", b"avismsf1", "no meta", "track"),
])
def test_the_major_brand_picks_the_source_as_libavif(major, compatible, order, source):
    a = _two_pictures()
    a.ftyp = major + bytes(4) + compatible
    if order == "no meta":
        a.heif = None
    data = a.write(share=False, order=(b"moov", b"meta") if order == "moov first"
                   else (b"meta", b"moov"))
    got = _same(data)
    track = _pil(_sequence())
    assert np.array_equal(got, track) == (source == "track")


def test_an_avif_brand_without_meta_fails_as_in_pil():
    a = Avis(_sequence())
    a.heif = None
    _both_raise(a.write())


# --- sample layouts ---------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["chunk a sample", "two chunks", "co64", "one sample size",
                                    "moov first", "no stss or stts", "no edts",
                                    "one colour sample", "one alpha sample", "no hdlr",
                                    "another handler"])
def test_sample_layouts_equal_pil(layout):
    a = Avis(_sequence(3))
    kw = {}
    if layout == "chunk a sample":
        kw["chunks"] = [1, 1, 1]
    elif layout == "two chunks":
        kw["chunks"] = [2, 1]
    elif layout == "co64":
        kw["co64"] = True
    elif layout == "one sample size":
        kw["default_size"] = True
    elif layout == "moov first":
        kw["order"] = (b"moov", b"meta")
    for t in a.tracks:
        if layout == "no stss or stts":
            t["stss"] = t["stts"] = None
        elif layout == "no edts":
            t["edts"] = None
    if layout.startswith("one ") and layout.endswith("sample"):
        k = 0 if "colour" in layout else 1
        a.tracks[k]["samples"] = a.tracks[k]["samples"][:1]
    if layout == "no hdlr":
        a.tracks[0]["hdlr"] = None
    elif layout == "another handler":
        a.tracks[0]["hdlr"] = a.tracks[0]["hdlr"].replace(b"pict", b"vide")
    data = a.write(**kw)
    if "co64" in kw:
        assert b"co64" in data and b"stco" not in data
    _same(data)


def _tkhd(a: Avis, k: int, w: int, h: int, version=None) -> None:
    t = a.tracks[k]
    b = bytearray(t["tkhd"])
    b[-8:] = struct.pack(">II", w << 16, h << 16)
    if version is not None:
        b[0] = version
    t["tkhd"] = bytes(b)


def _entry(a: Avis, k: int, edit) -> None:
    fmt, fields, props = a.tracks[k]["entry"]
    a.tracks[k]["entry"] = (fmt, fields, edit(props))


def _rename(props, old: bytes, new: bytes):
    return [(new if kind == old else kind, p) for kind, p in props]


def _stbl_edit(data: bytes, kind: bytes, edit) -> bytes:
    """The file with each `kind` box of the sample tables edited in place
    (edit(payload) -> payload of the same length)."""
    out = bytearray(data)

    def walk(start, end):
        for k, s, e in avif._boxes(data, start, end):
            if k in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
                walk(s, e)
            elif k == kind:
                out[s:e] = edit(data[s:e])

    _k, ms, me = next(b for b in avif._boxes(data, 0, len(data), top=True) if b[0] == b"moov")
    walk(ms - 8, me)
    return bytes(out)


@pytest.mark.parametrize("size", [(48, 32), (192, 128), (95, 63)])
def test_tracks_are_scaled_to_their_tkhd_size_as_libavif(size):
    a = Avis(_sequence())
    _tkhd(a, 0, *size)
    _tkhd(a, 1, *size)
    assert _same(a.write()).shape == (size[1], size[0], 4)


def _no_av1c(a):
    _entry(a, 0, lambda p: _rename(p, b"av1C", b"free"))


TRACK_FAILURES = {
    "alpha track of another size": lambda a: _tkhd(a, 1, 48, 32),
    "colour track of another size": lambda a: _tkhd(a, 0, 48, 32),
    "a track of size 0": lambda a: _tkhd(a, 0, 0, 64),
    "tkhd version 2": lambda a: _tkhd(a, 0, 96, 64, version=2),
    "media timescale 0 (PIL divides by it)":
        lambda a: a.tracks[0].update(mdhd=a.tracks[0]["mdhd"][:20] + bytes(4)
                                     + a.tracks[0]["mdhd"][24:]),
    "no mdhd": lambda a: a.tracks[0].update(mdhd=None),
    "mdhd version 2": lambda a: a.tracks[0].update(mdhd=b"\x02" + a.tracks[0]["mdhd"][1:]),
    "no av1C on the colour track": _no_av1c,
    "two nclx colr boxes": lambda a: _entry(a, 0, lambda p: p + [next(x for x in p
                                                                      if x[0] == b"colr")]),
    "a1op 32 in the sample entry": lambda a: _entry(a, 0, lambda p: p + [(b"a1op", b"\x20")]),
    "lsel 5 in the sample entry": lambda a: _entry(a, 0, lambda p: p + [(b"lsel", b"\0\5")]),
    "a short clap in the sample entry": lambda a: _entry(a, 0, lambda p: p + [(b"clap",
                                                                               bytes(8))]),
    "a short av1C": lambda a: _entry(a, 0, lambda p: [(k, v[:3] if k == b"av1C" else v)
                                                      for k, v in p]),
    "a sample entry under 78 bytes": lambda a: a.tracks[0].update(
        entry=(b"av01", a.tracks[0]["entry"][1][:40], [])),
    "two elst boxes": lambda a: a.tracks[0].update(edts=a.tracks[0]["edts"] * 2),
    "an elst of two entries": lambda a: a.tracks[0].update(
        edts=a.tracks[0]["edts"][:12] + b"\0\0\0\2" + a.tracks[0]["edts"][16:]),
}
# edits of the written bytes that keep every offset
BYTE_FAILURES = {
    "no tkhd": lambda d: d.replace(b"tkhd", b"free", 1),
    "a moov without trak": lambda d: d.replace(b"trak", b"free"),
    "a sample past the end of a cut file": lambda d: d[:-40],
}


@pytest.mark.parametrize("case", sorted(TRACK_FAILURES) + sorted(BYTE_FAILURES))
def test_track_checks_fail_as_in_pil(case):
    a = Avis(_sequence())
    if case in TRACK_FAILURES:
        TRACK_FAILURES[case](a)
        data = a.write()
    else:
        data = BYTE_FAILURES[case](a.write(order=(b"meta", b"moov")))
    _both_raise(data)


STBL_FAILURES = {
    "stsc not from chunk 1": (b"stsc", lambda p: p[:8] + b"\0\0\0\2" + p[12:]),
    "a chunk of no samples": (b"stsc", lambda p: p[:12] + b"\0\0\0\0" + p[16:]),
    "a sample table shorter than the chunks": (b"stsc", lambda p: p[:12] + b"\0\0\0\x09"
                                               + p[16:]),
    "a sample past the file": (b"stsz", lambda p: p[:12] + b"\0\1\0\0" + p[16:]),
    "stco version 1": (b"stco", lambda p: b"\1" + p[1:]),
    "stsz version 1": (b"stsz", lambda p: b"\1" + p[1:]),
    "stsc version 1": (b"stsc", lambda p: b"\1" + p[1:]),
    "stss version 1": (b"stss", lambda p: b"\1" + p[1:]),
    "stts version 1": (b"stts", lambda p: b"\1" + p[1:]),
    "stsd counting two entries": (b"stsd", lambda p: p[:4] + b"\0\0\0\2" + p[8:]),
    "stts counting entries past its box": (b"stts", lambda p: p[:4] + b"\0\0\0\x09" + p[8:]),
    "stss counting entries past its box": (b"stss", lambda p: p[:4] + b"\0\0\0\x09" + p[8:]),
}


@pytest.mark.parametrize("case", sorted(STBL_FAILURES))
def test_sample_table_checks_fail_as_in_pil(case, seq):
    kind, edit = STBL_FAILURES[case]
    _both_raise(_stbl_edit(seq, kind, edit))


def test_stsc_must_increase():
    a = Avis(_sequence(3))
    data = a.write(chunks=[1, 1, 1])
    _same(data)
    # the runs (1, 1), then chunk 1 again
    _both_raise(_stbl_edit(data, b"stsc", lambda p: p[:8] + p[8:20] + b"\0\0\0\1" + p[24:]))


TRACK_READS = {
    "no av1C on the alpha track": lambda a: _entry(a, 1, lambda p: _rename(p, b"av1C", b"free")),
    "no auxi on the alpha track": lambda a: _entry(a, 1, lambda p: _rename(p, b"auxi", b"free")),
    "an auxi that is not alpha": lambda a: _entry(a, 1, lambda p: [
        (k, v.replace(b"urn:", b"urx:") if k == b"auxi" else v) for k, v in p]),
    "a prem reference to another track": lambda a: a.tracks[0].update(tref=[(b"prem", [7])]),
    "a prem reference to the alpha track": lambda a: a.tracks[0].update(tref=[(b"prem", [2])]),
    "clap, a1op 5 and lsel 2 in the sample entry": lambda a: _entry(a, 0, lambda p: p + [
        (b"clap", struct.pack(">8I", 200, 1, 48, 1, 0, 1, 0, 1)), (b"a1op", b"\5"),
        (b"lsel", b"\0\2")]),
    "an elst that does not repeat": lambda a: a.tracks[0].update(
        edts=a.tracks[0]["edts"][:11] + b"\0" + a.tracks[0]["edts"][12:]),
}
# edits of the written bytes that keep every offset: boxes libavif reads
# as PIL's own, or never reads
BYTE_READS = {
    "stsd version 1": lambda d: _stbl_edit(d, b"stsd", lambda p: b"\1" + p[1:]),
    "a second moov after the first (never read)": lambda d: d.replace(b"mdat", b"moov", 1),
}


@pytest.mark.parametrize("case", sorted(TRACK_READS) + sorted(BYTE_READS))
def test_track_forms_read_as_pil(case):
    a = Avis(_sequence())
    if case in BYTE_READS:
        data = BYTE_READS[case](a.write())
    else:
        TRACK_READS[case](a)
        data = a.write()
    got = _same(data)
    if case == "an auxi that is not alpha":  # no alpha track: PIL's image is RGB
        assert Image.open(io.BytesIO(data)).mode == "RGB" and (got[..., 3] == 255).all()
    if case.startswith("a prem reference"):
        assert avif.parse(data).premultiplied == case.endswith("alpha track")


# --- the sequence and frame headers of a track's key frame ------------------------------

MODEL = dict(timing=1, units=1, scale=30, model=1, delay_len=10, decoding_tick=1, removal_len=8,
             presentation_len=6)
VARIANTS = {
    "timing info, equal picture interval": dict(timing=1, units=1, scale=30, equal=1, ticks=2,
                                                model=0),
    "timing info": dict(timing=1, units=1, scale=30, equal=0, model=0),
    "decoder model": dict(MODEL, equal=0, ops=[(0, 8, 0, (100, 200, 0), None)]),
    "operating points with idc": dict(MODEL, equal=1, ticks=2, display_delay=1, ops=[
        (0x103, 8, 1, (100, 200, 0), 3), (0x101, 4, 0, None, None), (0x102, 5, 0, (1, 2, 1), 9)]),
    "frame ids": dict(frame_ids=1, delta_id_len=5, extra_id_len=3),
    "screen content forced off": dict(choose_sct=0, sct=0),
    "no order hint": dict(order_hint=0),
    "split frame header": dict(split=True),
    "extension headers": dict(layer=(0, 0)),
    "extension headers, idc 0x101": dict(layer=(0, 0), ops=[(0x101, 8, 0, None, None)]),
    "temporal layer 1, idc 0x103": dict(layer=(1, 0), ops=[(0x103, 8, 0, None, None)]),
    "spatial layer 1, idc 0x301": dict(layer=(0, 1), ops=[(0x301, 8, 0, None, None)]),
    "spatial layer 1, idc 0": dict(layer=(0, 1)),
    "all of them": dict(MODEL, layer=(2, 0), split=True, equal=0, frame_ids=1, delta_id_len=7,
                        extra_id_len=2, ops=[(0x107, 8, 0, (100, 200, 0), None),
                                             (0x101, 8, 0, (3, 4, 0), None),
                                             (0x104, 8, 0, (5, 6, 1), None)]),
}


def _variant(data: bytes, **kw) -> bytes:
    """The file with every first sample and av01 item rewritten by
    stream_variant."""
    a = Avis(data)
    for t in a.tracks:
        t["samples"][0] = tool.stream_variant(t["samples"][0], **kw)
    for item in a.heif.items.values():
        item["data"] = tool.stream_variant(item["data"], **kw)
    return a.write()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sequence_header_variants_equal_pil(variant, seq):
    data = _variant(seq, **VARIANTS[variant])
    s = av1.parse_sequence(next(p for k, p in av1.obus(avif.parse(data).color)
                                if k == av1.OBU_SEQUENCE_HEADER))
    assert s.reduced == 0
    _same(data)


@pytest.mark.parametrize("case", ["a frame outside the operating point",
                                  "idc without a spatial layer", "idc without a temporal layer"])
def test_operating_point_failures_as_in_pil(case, seq):
    kw = {"a frame outside the operating point": dict(layer=(1, 0),
                                                      ops=[(0x101, 8, 0, None, None)]),
          "idc without a spatial layer": dict(ops=[(0x001, 8, 0, None, None)]),
          "idc without a temporal layer": dict(ops=[(0x100, 8, 0, None, None)])}[case]
    _both_raise(_variant(seq, **kw))


def _as_still(data: bytes) -> Heif:
    """The items of a sequence's meta as a still (brands avif, mif1,
    miaf: no moov needed)."""
    heif = Heif(data)
    heif.ftyp = b"avif" + bytes(4) + b"avifmif1miaf"
    return heif


@pytest.mark.parametrize("op, decodes", [(0, True), (1, False), (2, True), (9, True)])
def test_a1op_selects_an_operating_point_as_dav1d(op, decodes, seq):
    """Operating point 0 holds temporal layers 0-1, 1 layer 1 alone, 2 both;
    a frame of temporal layer 0: dropped at operating point 1, kept at the
    first where the stream has fewer points than asked (dav1d)."""
    data = _variant(seq, layer=(0, 0), ops=[(0x103, 8, 0, None, None), (0x102, 8, 0, None, None),
                                            (0x103, 8, 0, None, None)])
    heif = _as_still(data)
    heif.set_prop(heif.primary, b"a1op", bytes([op]), 1)
    if decodes:
        _same(heif.write())
    else:
        _both_raise(heif.write())


@pytest.mark.parametrize("frame_layer, lsel, decodes", [(0, 0, True), (1, 1, True), (1, 0, False),
                                                        (0, 2, False), (1, 0xFFFF, True)])
def test_lsel_asks_for_a_frame_of_its_spatial_layer(frame_layer, lsel, decodes, seq):
    data = _variant(seq, layer=(0, frame_layer))
    heif = _as_still(data)
    heif.set_prop(heif.primary, b"lsel", struct.pack(">H", lsel), 1)
    if decodes:
        _same(heif.write())
    else:
        _both_raise(heif.write())


# --- properties on items ----------------------------------------------------------------

def _clap(*v) -> bytes:
    return struct.pack(">8I", *(x & 0xFFFFFFFF for x in v))


@pytest.fixture(scope="module")
def still() -> bytes:
    return _still(_crops(1, 96, 64, True)[0])


PROPERTY_READS = {
    "clap 80x48": [(1, b"clap", _clap(80, 1, 48, 1, 0, 1, 0, 1), 1)],
    "clap past the image": [(1, b"clap", _clap(200, 1, 48, 1, 0, 1, 0, 1), 1)],
    "clap of denominator 0": [(1, b"clap", _clap(80, 0, 48, 1, 0, 1, 0, 1), 1)],
    "clap of a negative offset": [(1, b"clap", _clap(80, 1, 48, 1, -8, 1, 0, 1), 1)],
    "clap on the alpha item": [(2, b"clap", _clap(80, 1, 48, 1, 0, 1, 0, 1), 1)],
    "a1op 0": [(1, b"a1op", b"\0", 1)],
    "a1op 31": [(1, b"a1op", b"\x1f", 1)],
    "a1op 9 on the alpha item": [(2, b"a1op", b"\x09", 1)],
    "lsel 0": [(1, b"lsel", b"\0\0", 1)],
    "lsel 0xFFFF": [(1, b"lsel", b"\xff\xff", 1)],
    "lsel 0 on the alpha item": [(2, b"lsel", b"\0\0", 1)],
    "a1lx": [(1, b"a1lx", b"\0" + struct.pack(">3H", 10, 0, 0), 0)],
    "a1lx and lsel 0xFFFF": [(1, b"a1lx", b"\0" + struct.pack(">3H", 10, 0, 0), 0),
                             (1, b"lsel", b"\xff\xff", 1)],
    "an unused colr of another type": [(0, b"colr", b"abcd", 0)],
    "an ispe of 0x0 on no item": [(0, b"ispe", bytes(4) + struct.pack(">II", 0, 0), 0)],
}
PROPERTY_FAILURES = {
    "clap not essential": [(1, b"clap", _clap(80, 1, 48, 1, 0, 1, 0, 1), 0)],
    "a1op not essential": [(1, b"a1op", b"\0", 0)],
    "lsel not essential": [(1, b"lsel", b"\0\0", 0)],
    "irot not essential": [(1, b"irot", b"\1", 0)],
    "imir not essential": [(1, b"imir", b"\0", 0)],
    "a1op not essential on an Exif item": [(9, b"a1op", b"\0", 0)],
    "a1lx essential": [(1, b"a1lx", bytes(7), 1)],
    "a1op 32": [(1, b"a1op", b"\x20", 1)],
    "an unused a1op 32": [(0, b"a1op", b"\x20", 0)],
    "lsel 4": [(1, b"lsel", b"\0\4", 1)],
    "lsel 1 of a stream of one layer": [(1, b"lsel", b"\0\1", 1)],
    "lsel 1 on the alpha item": [(2, b"lsel", b"\0\1", 1)],
    "lsel 0 of an a1lx first layer of 10 bytes": [
        (1, b"a1lx", b"\0" + struct.pack(">3H", 10, 0, 0), 0), (1, b"lsel", b"\0\0", 1)],
    "lsel 2 past the a1lx layers": [(1, b"a1lx", b"\0" + struct.pack(">3H", 10, 0, 0), 0),
                                    (1, b"lsel", b"\0\2", 1)],
    "an a1lx layer past the item": [(1, b"a1lx", b"\0" + struct.pack(">3H", 60000, 0, 0), 0)],
    "a1lx reserved bits": [(1, b"a1lx", b"\2" + bytes(6), 0)],
    "a short clap": [(1, b"clap", bytes(31), 1)],
    "an unused av1C of marker 0": [(0, b"av1C", b"\x01\x00\x0c\x00", 0)],
    "an unused ispe of version 1": [(0, b"ispe", b"\1\0\0\0" + struct.pack(">II", 96, 64), 0)],
    "an unused pixi of version 1": [(0, b"pixi", b"\1\0\0\0\1\x08", 0)],
    "an unused pixi of five depths": [(0, b"pixi", b"\0\0\0\0\5" + b"\x08" * 5, 0)],
    "an unused auxC without its null": [(0, b"auxC", b"\0\0\0\0urn:abc", 0)],
    "an unused irot with reserved bits": [(0, b"irot", b"\4", 0)],
    "an unused imir with reserved bits": [(0, b"imir", b"\2", 0)],
    "an unused nclx with reserved bits": [(0, b"colr", b"nclx" + struct.pack(">HHH", 1, 13, 6)
                                           + b"\x81", 0)],
    "an unused short nclx": [(0, b"colr", b"nclx" + struct.pack(">HHH", 1, 13, 6), 0)],
    "an unused short pasp": [(0, b"pasp", b"\0\0\0\1", 0)],
    "an unused short clli": [(0, b"clli", b"\0\0", 0)],
}


def _with_props(data: bytes, props) -> bytes:
    """The still with each (item, kind, payload, essential) property: item
    0 leaves it in ipco unused, item 9 gives it to a new Exif item."""
    heif = Heif(data)
    for item, kind, payload, essential in props:
        if item == 0:
            heif.ipco.append((kind, payload))
        elif item not in heif.items:
            heif.ipco.append((kind, payload))
            heif.items[item] = {"type": b"Exif", "flags": 0, "name": b"", "data": b"x",
                                "props": [(len(heif.ipco), essential)]}
        else:
            heif.set_prop(item, kind, payload, essential)
    return heif.write()


@pytest.mark.parametrize("case", sorted(PROPERTY_READS))
def test_properties_read_as_if_absent(case, still):
    data = _with_props(still, PROPERTY_READS[case])
    np.testing.assert_array_equal(_same(data), _pil(still))


@pytest.mark.parametrize("case", sorted(PROPERTY_FAILURES))
def test_property_checks_fail_as_in_pil(case, still):
    _both_raise(_with_props(still, PROPERTY_FAILURES[case]))


# --- premultiplied and limited-range alpha ----------------------------------------------

def _at(data: bytes, depth: int, sequence: bool) -> bytes:
    if depth == 8:
        return data
    return tool.avis_at_depth(data, depth) if sequence else tool.avif_at_depth(data, depth)


@pytest.mark.parametrize("form", ["still", "sequence"])
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4", "4:0:0"])
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("kind", ["prem", "limited", "prem + limited"])
def test_premultiplied_and_limited_alpha_equal_pil(kind, depth, subsampling, form):
    px = _crops(1, 96, 64, True)[0]
    kw = {"subsampling": subsampling, "alpha_premultiplied": "prem" in kind}
    data = _sequence(**kw) if form == "sequence" else _still(px, **kw)
    data = _at(data, depth, form == "sequence")
    if "limited" in kind:
        data = tool.limited_alpha(data)
    still = avif.parse(data)
    assert still.premultiplied == ("prem" in kind)
    alpha = av1.decode(still.alpha)
    assert alpha.full_range == ("limited" not in kind) and alpha.bit_depth == depth
    _same(data)


@pytest.mark.parametrize("size", [(48, 32), (192, 128), (61, 37)])
@pytest.mark.parametrize("depth", [8, 10])
def test_limited_alpha_is_expanded_before_the_scale_to_ispe(size, depth):
    data = tool.limited_alpha(_at(_still(_crops(1, 96, 64, True)[0]), depth, False))
    out = bytearray(data)
    at = out.find(b"ispe")
    while at >= 0:
        out[at + 8:at + 16] = struct.pack(">II", *size)
        at = out.find(b"ispe", at + 4)
    _same(bytes(out))


@pytest.mark.parametrize("refs, premultiplied", [
    ([(b"prem", 1, [2])], True), ([(b"prem", 1, [2, 5])], False), ([(b"prem", 1, [5, 2])], True),
    ([(b"prem", 2, [1])], False), ([(b"prem", 1, [2]), (b"prem", 1, [3])], False)])
def test_prem_references_as_libavif_reads_them(refs, premultiplied, still):
    """libavif's premByID: the last item a prem reference from the colour
    item names, held to the alpha item's id."""
    heif = Heif(still)
    heif.refs += refs
    data = heif.write()
    assert avif.parse(data).premultiplied == premultiplied
    _same(data)


def test_unattenuate_equals_its_twin_and_libyuvs_rule():
    rng = np.random.default_rng(31)
    px = rng.integers(0, 256, (37, 256, 4), dtype=np.uint8)
    px[:, :, 3] = np.arange(256, dtype=np.uint8)[None, :]
    got = av1.unattenuate(px, plain=True)
    np.testing.assert_array_equal(got, av1.unattenuate_plain(px))
    a = px[..., 3:].astype(np.int64)
    ia = np.select([a == 0, a == 1, a == 255], [0, 0xFFFF, 256], 65536 // np.maximum(a, 1))
    v = (px[..., :3].astype(np.int64) * 257 * ia) >> 16
    # packuswb reads v as a signed word: alpha 1 over a colour from 128 up
    # gives 0 (a corrupt or lossy premultiplied colour above its alpha)
    want = np.where(v >= 32768, 0, np.minimum(255, v))
    np.testing.assert_array_equal(got[..., :3], want)
    assert (want[:, 1] == 0).any() and (want[:, 1] == 255).any()
    np.testing.assert_array_equal(got[..., 3], px[..., 3])
    np.testing.assert_array_equal(got[:, 255, :3], px[:, 255, :3])  # alpha 255: kept


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_alpha_range_equals_its_twin_and_libavifs_rule(depth):
    top = (1 << depth) - 1
    plane = np.arange(top + 1).astype(np.uint8 if depth == 8 else np.uint16)
    plane = np.tile(plane, (3, 1))
    got = av1.alpha_range(plane, plane.shape[1], 2, depth, plain=True)
    lo, hi = 16 << (depth - 8), 235 << (depth - 8)
    v = np.arange(top + 1)
    want = np.clip(np.trunc(((v - lo) * top + (hi - lo) // 2) / (hi - lo)), 0, top)
    np.testing.assert_array_equal(got[:2], np.tile(want, (2, 1)))
    np.testing.assert_array_equal(got[2], plane[2])  # past the height: kept
    if depth == 8:  # the 8-bit form in ROADMAP's probe
        np.testing.assert_array_equal(got[0], np.clip(((v - 16) * 255 + 109) // 219, 0, 255))


def test_the_stages_run_on_a_files_own_planes():
    """decode_avif's plain run (the twins beside the C++ stages) on a
    premultiplied 10-bit file with a limited-range alpha."""
    data = tool.limited_alpha(tool.avis_at_depth(_sequence(alpha_premultiplied=True), 10))
    np.testing.assert_array_equal(avif.decode_avif(data, plain=True), _pil(data))


# --- the stored sequence and the card's rewrites ----------------------------------------

def test_stored_sequence_and_its_rewrites_equal_their_digests():
    with open(AVIF_SEQUENCE_FIXTURE, "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        stored = json.load(fh)
    name = os.path.basename(AVIF_SEQUENCE_FIXTURE)
    assert hashlib.sha256(data).hexdigest() == stored["files"][name]["sha256"]
    assert avif.parse(data).track is not None and avif.parse(data).premultiplied
    rewrites = tool.card_rewrites(data)
    assert sorted(rewrites) == sorted(stored["rewrites"][name])
    for kind, d in rewrites.items():
        assert len(d) == len(data)
        got = _same(d)
        ref = stored["rewrites"][name][kind]
        assert hashlib.sha256(got.tobytes()).hexdigest() == ref["decoded_sha256"], kind
        assert list(got.shape) == ref["shape"]
    assert not avif.parse(rewrites["straight"]).premultiplied
    assert not av1.decode(avif.parse(rewrites["limited alpha"]).alpha).full_range
    assert avif.parse(rewrites["still"]).track is None
    assert avif.parse(rewrites["lsel"]).layers == (0, 0)


@pytest.fixture(params=["sequence", "limited"])
def sequence_copies(request, tmp_path):
    """The stored sequence, or its limited-alpha rewrite, copied twice
    (each package writes its own sidecar): (port path, jax path, scene
    reference, wall reference)."""
    with open(AVIF_SEQUENCE_FIXTURE, "rb") as fh:
        data = fh.read()
    refs = (AVIF_SEQUENCE_FILE_REFERENCE, AVIF_SEQUENCE_WALL_REFERENCE)
    if request.param == "limited":
        data = tool.card_rewrites(data)["limited alpha"]
        refs = (AVIF_SEQUENCE_LIMITED_FILE_REFERENCE, AVIF_SEQUENCE_LIMITED_WALL_REFERENCE)
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / "sequence.avif"))
        with open(paths[-1], "wb") as fh:
            fh.write(data)
    return paths + list(refs)


def test_load_image_of_the_sequence_gives_figdraw_tpus_image_and_mips(sequence_copies):
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    port_path, jax_path, _scene, _wall = sequence_copies
    jax_flippy()
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    ref, jref = resources.load_image(port_path, bus=bus), jres.load_image(jax_path, bus=jbus)
    a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
    b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
    np.testing.assert_array_equal(a.image, np.asarray(b.image))
    assert len(a.mips) == len(b.mips)
    for x, y in zip(a.mips, b.mips):
        np.testing.assert_array_equal(x, np.asarray(y))
    with open(port_path + ".flippy", "rb") as fh, open(jax_path + ".flippy", "rb") as jfh:
        assert fh.read() == jfh.read()
    ref.close()
    jref.close()


def test_image_file_scene_and_photo_wall_from_the_sequence_match_jax(sequence_copies):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_image_file_frame, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import (
        PHOTO_WALL_SMALL, make_loaded_photo_wall, render_image_file,
    )

    port_path, jax_path, scene_ref, wall_ref = sequence_copies
    want = jax_image_file_frame(jax_path, "1x")
    _ren, frame, ref = render_image_file(
        lambda ps: port.FigRenderer(atlas_size=512, device="cpu", pixel_scale=ps),
        port_path, "1x")
    got = frame.numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    np.testing.assert_allclose(np.load(scene_ref), block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - np.load(scene_ref)).max()) <= 1e-5
    ref.close()
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_path, w, h, n)
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(port_path, bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    np.testing.assert_allclose(np.load(wall_ref), block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - np.load(wall_ref)).max()) <= 1e-5
    ref.close()


# --- the agreement runs' cases ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["avis", "properties"])
def test_agreement_cases_equal_pil(mode):
    """The first cases of tools/avif_fuzz_agreement.py's --avis and
    --properties runs (the tool's own runs count 1200 of each)."""
    gen = fuzz.avis_cases(0, 8) if mode == "avis" else fuzz.property_cases(0, 12)
    for i, options, data in gen:
        assert fuzz.outcome(data)[0] == "equal", (i, options)  # equal, or both raise


# the corrupt cases where the agreement runs found the port and PIL apart,
# each repaired: an alpha track whose auxi names no alpha (0, 31: PIL's
# image is RGB), an unused pixi of version 64 (0, 191), stsd of version
# 128 (1, 180), an alpha track's hdlr with pre_defined set (2, 25), a
# premultiplied colour above its alpha of 1 (2, 167: libyuv's x86 rows
# pack it to 0); and an unused auxC without its null (--properties, 0, 53)
CORRUPT_CASES = [("avis", 0, 31), ("avis", 0, 191), ("avis", 1, 180), ("avis", 2, 25),
                 ("avis", 2, 167), ("properties", 0, 53)]


_CORRUPT = {}


@pytest.mark.parametrize("mode, seed, index", CORRUPT_CASES)
def test_corrupt_cases_found_by_the_agreement_runs(mode, seed, index):
    if (mode, seed) not in _CORRUPT:  # one seed's 12 written sources, once
        _CORRUPT[mode, seed] = [d for _i, _o, d in fuzz.corrupt_cases(seed, 200, **{mode: True})]
    data = _CORRUPT[mode, seed][index]
    assert fuzz.outcome(data, corrupt=True)[0] == "equal"


def test_agreement_cases_are_the_same_bytes_each_run():
    first = [d for _i, _o, d in fuzz.avis_cases(0, 3)]
    assert first == [d for _i, _o, d in fuzz.avis_cases(0, 3)]
