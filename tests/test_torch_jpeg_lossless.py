"""The port's lossless JPEG decoding (utils/jpeg.py: SOF3; csrc/
image_decode.cpp's fd_jpeg_lossless_scan and its plain twin
`lossless_scan_plain`) against PIL 12.1.0's `Image.open(...).convert("RGBA")`
through libjpeg-turbo 3.1.3, which figdraw_tpu decodes through.

Files come from the stored references (tools/make_image_formats.py), from
tools/jpeg_arith_lossless_writer.c (built with gcc into a temporary
directory, linked to PIL's libjpeg-turbo, which writes every lossless file
as RGB or grey at 1x1 sampling): seeded images through each predictor 1-7
with point transforms 0-7 and restarts every few rows; and from
`lossless_bytes` below, a small encoder of what that library does not write:
subsampled components (upsampled by replication), components in scans of
their own, no colour-space marker (RGB in lossless), Adobe CMYK and
YCbCr (which libjpeg refuses to convert), difference category 16, and a
restart interval that is not whole MCU rows (refused). Each equals PIL byte
for byte (or both refuse), and fd_jpeg_lossless_scan equals its plain twin
sample for sample. Also: the data's end without an EOI (libjpeg's
read-ahead of 57 bits decides), restart markers out of sequence, seeded
corrupt cases of tools/jpeg_fuzz_agreement.py, and the SOF3 crop through
load_image and the photo wall against figdraw_tpu's frame."""

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
    IMAGE_FIXTURE, IMAGE_FORMATS_DIR, IMAGE_FORMATS_REFERENCE, LOSSLESS_FIXTURE,
)
from figdraw_tpu_torch.utils import imagefile, jpeg
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import jpeg_fuzz_agreement  # noqa: E402
import make_image_formats  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    return make_image_formats.arith_lossless_writer(str(tmp_path_factory.mktemp("writer")))


def _image(w: int, h: int, seed: int, channels: int = 3) -> np.ndarray:
    """A w x h crop of the fixture with seeded noise."""
    base = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))[..., :channels]
    rng = np.random.default_rng(seed)
    y, x = rng.integers(0, 600 - h + 1), rng.integers(0, 800 - w + 1)
    img = base[y: y + h, x: x + w].astype(np.int64) + rng.integers(-40, 41, (h, w, channels))
    out = np.clip(img, 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


def _pil(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception:  # noqa: BLE001 - any PIL failure is a refusal
        return None


def _same_as_pil(data: bytes, plain: bool = True) -> None:
    """The port's decode (C++ through decode_image, and the plain twins on
    small images) equals PIL's, or both refuse."""
    want = _pil(data)
    if want is None:
        with pytest.raises((ValueError, NotImplementedError)):
            imagefile.decode_image(data)
        if plain:
            with pytest.raises((ValueError, NotImplementedError)):
                jpeg.decode_jpeg(data, plain=True)
        return
    got = imagefile.decode_image(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if plain and got.shape[0] * got.shape[1] <= 64 * 48:
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, plain=True), want)


# --- a small lossless encoder: what libjpeg-turbo's writer does not emit -------------

_CATEGORY_COUNTS = [0, 0, 0, 0, 17] + [0] * 11  # 17 symbols (0-16), 5 bits each


def _predict(psv, ra, rb, rc):
    return (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
            (ra + rb) >> 1)[psv - 1]


def _differences(p, psv, pt, first_rows):
    """The encoder's differences of one component's samples (mod 2^16);
    `first_rows` are the rows that restart the first-row rule."""
    p = p.astype(np.int64) >> pt
    d = np.zeros_like(p)
    for y in range(p.shape[0]):
        for x in range(p.shape[1]):
            if y in first_rows:
                pr = (1 << (8 - pt - 1)) if x == 0 else p[y, x - 1]
            elif x == 0:
                pr = p[y - 1, 0]
            else:
                pr = _predict(psv, p[y, x - 1], p[y - 1, x], p[y - 1, x - 1])
            d[y, x] = (p[y, x] - pr) & 0xFFFF
    return d


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v, k):
        self.acc, self.n = (self.acc << k) | v, self.n + k
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.n -= 8
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)

    def difference(self, v):
        v = int(v)
        v = v - 65536 if v >= 32768 else v
        if v == -32768:
            self.put(16, 5)  # category 16: 32768, no extra bits
            return
        s = abs(v).bit_length()
        self.put(s, 5)
        if s:
            self.put(v if v > 0 else v + (1 << s) - 1, s)


def lossless_bytes(planes, factors, width, height, psv=1, pt=0, restart=0, ids=(82, 71, 66),
                   adobe=0, interleave=True, sof_extra=b""):
    """A lossless JPEG of `planes` (each at its component's sampled size)
    with sampling `factors` [(H, V), ...], one interleaved scan (or one a
    component), restarts every `restart` MCUs (whole MCU rows of the scan,
    non-interleaved scans only with V 1) and an Adobe marker of transform
    `adobe` (None for none)."""
    n = len(planes)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    out = bytearray(b"\xff\xd8")
    if adobe is not None:
        seg = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe])
        out += b"\xff\xee" + struct.pack(">H", len(seg) + 2) + seg
    sof = struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([ids[i], factors[i][0] << 4 | factors[i][1], 0]) for i in range(n)) + sof_extra
    out += b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
    dht = bytes([0]) + bytes(_CATEGORY_COUNTS) + bytes(range(17))
    out += b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    for scan in ([list(range(n))] if interleave else [[i] for i in range(n)]):
        sos = bytes([len(scan)]) + b"".join(bytes([ids[i], 0]) for i in scan) + bytes([psv, 0, pt])
        out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
        inter = len(scan) > 1
        per_row = -(-width // hmax) if inter else planes[scan[0]].shape[1]
        mcu_rows = -(-height // vmax) if inter else planes[scan[0]].shape[0]
        rows_per_restart = restart // per_row if restart else 0
        diffs = {}
        for i in scan:
            v = factors[i][1] if inter else 1
            firsts = {0} | ({r * v for r in range(0, mcu_rows, rows_per_restart)}
                            if rows_per_restart else set())
            diffs[i] = _differences(planes[i], psv, pt, firsts)
        bits, count, rst = _Bits(), 0, 0
        for my in range(mcu_rows):
            for mx in range(per_row):
                if restart and count and count % restart == 0:
                    bits.flush()
                    bits.out += bytes([0xFF, 0xD0 + rst])
                    bits.acc = bits.n = 0
                    rst = (rst + 1) & 7
                count += 1
                for i in scan:
                    h, v = factors[i] if inter else (1, 1)
                    d = diffs[i]
                    for yy in range(v):
                        for xx in range(h):
                            y, x = my * v + yy, mx * h + xx
                            bits.difference(d[y, x] if y < d.shape[0] and x < d.shape[1] else 0)
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")


def _planes(factors, width, height, seed):
    rng = np.random.default_rng(seed)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    base = _image(width, height, seed)
    return [np.ascontiguousarray(base[::vmax // v, ::hmax // h, k % 3]
                                 if (h, v) != (hmax, vmax) else base[..., k % 3])
            + rng.integers(0, 2, (-(-height * v // vmax), -(-width * h // hmax))).astype(np.uint8)
            for k, (h, v) in enumerate(factors)]


# --- files libjpeg-turbo writes -------------------------------------------------------


def _cases():
    """Seeded writer cases: (id, width, height, channels, options)."""
    rng = np.random.default_rng(1803)
    out = []
    for i in range(21):
        psv, pt = i % 7 + 1, int(rng.integers(0, 8)) if i >= 14 else i // 7 * 2
        w, h = int(rng.integers(1, 70)), int(rng.integers(1, 50))
        channels = (3, 1, 3)[i % 3]
        opts = [f"lossless={psv},{pt}"]
        if rng.random() < 0.4:
            opts.append(f"restart_rows={int(rng.integers(1, 4))}")
        out.append((f"p{psv}-pt{pt}-{w}x{h}x{channels}", w, h, channels, opts))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_written_files_equal_pil(case, writer):
    _id, w, h, channels, opts = case
    data = make_image_formats.arith_lossless_jpeg(_image(w, h, w * 31 + h, channels), *opts,
                                                  writer=writer)
    assert b"\xff\xc3" in data
    want = _pil(data)
    assert want is not None and want.shape == (h, w, 4)
    _same_as_pil(data)


@pytest.mark.parametrize("case", CASES[::2], ids=[c[0] for c in CASES[::2]])
def test_lossless_scan_equals_lossless_scan_plain(case, writer):
    _id, w, h, channels, opts = case
    data = make_image_formats.arith_lossless_jpeg(_image(w, h, w * 31 + h, channels), *opts,
                                                  writer=writer)
    native, plain = jpeg.read_frame(data), jpeg.read_frame(data, plain=True)
    assert native.kind == jpeg.LOSSLESS
    for a, b in zip(native.components, plain.components):
        np.testing.assert_array_equal(a.samples, b.samples)


def _stored_lossless():
    return sorted(n for n in os.listdir(IMAGE_FORMATS_DIR)
                  if n.startswith("lossless_") and n.endswith(".jpg"))


@pytest.mark.parametrize("name", _stored_lossless())
def test_stored_files_equal_pil_and_their_digests(name):
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        ref = json.load(fh)["files"][name]
    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        data = fh.read()
    assert hashlib.sha256(data).hexdigest() == ref["sha256"]
    got = imagefile.decode_image(data, name)
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["decoded_sha256"]
    np.testing.assert_array_equal(got, _pil(data))
    assert jpeg.read_frame(data).kind == jpeg.LOSSLESS


# --- files of the small encoder -------------------------------------------------------

LAYOUTS = {
    "444": [(1, 1)] * 3,
    "h2": [(2, 1), (1, 1), (1, 1)],
    "h2v2": [(2, 2), (1, 1), (1, 1)],
    "v2": [(1, 2), (1, 1), (1, 1)],
    "h4": [(4, 1), (1, 1), (1, 1)],
    "mixed": [(2, 2), (1, 2), (2, 1)],
}


@pytest.mark.parametrize("psv", [1, 4, 7])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_subsampled_components_upsample_by_replication(layout, psv):
    """libjpeg's upsampling of a lossless frame has no fancy filter (its DCT
    scaling is 1): every sampled component is replicated."""
    factors = LAYOUTS[layout]
    w, h = 13 + psv, 9 + psv
    data = lossless_bytes(_planes(factors, w, h, psv), factors, w, h, psv=psv, pt=psv % 3)
    want = _pil(data)
    assert want is not None
    _same_as_pil(data)


@pytest.mark.parametrize("interleave", [True, False])
@pytest.mark.parametrize("restart_rows", [0, 1, 3])
def test_scans_and_restarts_equal_pil(interleave, restart_rows):
    factors = [(1, 1)] * 3
    w, h = 17, 11
    planes = _planes(factors, w, h, 7)
    data = lossless_bytes(planes, factors, w, h, psv=6, restart=w * restart_rows,
                          interleave=interleave)
    want = _pil(data)
    assert want is not None
    np.testing.assert_array_equal(want[..., :3], np.stack(planes, -1))
    _same_as_pil(data)
    native, plain = jpeg.read_frame(data), jpeg.read_frame(data, plain=True)
    for a, b in zip(native.components, plain.components):
        np.testing.assert_array_equal(a.samples, b.samples)


@pytest.mark.parametrize("ids,adobe,space", [
    ((1, 2, 3), None, "RGB"),  # no marker: libjpeg-turbo 3 takes RGB in lossless
    ((4, 5, 6), None, "RGB"),
    ((82, 71, 66), 1, "YCbCr"),  # refused: no colour conversion of a lossless frame
])
def test_colour_space_follows_libjpeg(ids, adobe, space):
    factors = [(1, 1)] * 3
    planes = _planes(factors, 11, 7, 3)
    data = lossless_bytes(planes, factors, 11, 7, ids=ids, adobe=adobe)
    assert jpeg.color_space(jpeg.read_frame(data)) == space
    _same_as_pil(data)


@pytest.mark.parametrize("adobe", [0, 2, None])
def test_four_components_as_cmyk(adobe):
    """Adobe CMYK decodes as PIL's inverted CMYK; YCCK (transform 2) is a
    conversion libjpeg refuses."""
    factors = [(1, 1)] * 4
    planes = _planes(factors, 9, 6, 4)
    planes.append(planes[0][::-1].copy())
    planes = planes[:4]
    _same_as_pil(lossless_bytes(planes, factors, 9, 6, ids=(1, 2, 3, 4), adobe=adobe))


def test_difference_category_16_is_32768():
    """A difference of 32768 (category 16, no extra bits): the samples
    wrap mod 2^16 before the point transform's shift."""
    factors = [(1, 1)]
    plane = np.zeros((4, 6), np.uint8)
    plane[:, ::2] = 255
    data = lossless_bytes([plane], factors, 6, 4, psv=1, adobe=None, ids=(1,))
    d = bytearray(data)
    # the same file with every third difference coded as category 16
    sos = d.index(b"\xff\xda")
    body = _Bits()
    for i in range(24):
        if i % 3 == 0:
            body.put(16, 5)
        else:
            body.difference(i * 5 - 60)
    body.flush()
    end = d.index(b"\xff\xd9")
    forced = bytes(d[: sos + 10]) + bytes(body.out) + b"\xff\xd9"
    assert end > sos
    want = _pil(forced)
    assert want is not None and len(np.unique(want[..., 0])) > 4
    _same_as_pil(forced)


def test_restart_interval_not_whole_rows_is_refused():
    factors = [(1, 1)]
    plane = _planes(factors, 11, 5, 9)[0]
    data = lossless_bytes([plane], factors, 11, 5, restart=11, adobe=None, ids=(1,))
    at = data.index(b"\xff\xdd")
    bad = data[: at + 4] + struct.pack(">H", 12) + data[at + 6:]
    assert _pil(bad) is None
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(bad)
    _same_as_pil(bad)


def test_difference_category_past_16_is_refused():
    factors = [(1, 1)]
    plane = _planes(factors, 6, 4, 2)[0]
    data = bytearray(lossless_bytes([plane], factors, 6, 4, adobe=None, ids=(1,)))
    at = data.index(b"\xff\xc4")
    data[at + 5 + 16 + 16] = 17  # the last symbol of the DC table
    _same_as_pil(bytes(data))
    assert _pil(bytes(data)) is None


@pytest.mark.parametrize("replacement", range(8))
def test_restart_markers_out_of_sequence_resync_as_libjpeg(replacement):
    """Restart markers of the stored crop (a restart every two rows)
    replaced by each RSTn: the rows after decode as libjpeg's
    jpeg_resync_to_restart leaves them, or as zeros where data ran out."""
    with open(os.path.join(IMAGE_FORMATS_DIR, "lossless_p4_rst2.jpg"), "rb") as fh:
        data = fh.read()
    spots = [i for i in range(len(data) - 1)
             if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    assert len(spots) >= 8
    for at in spots[::3]:
        bad = bytearray(data)
        bad[at + 1] = 0xD0 + replacement
        _same_as_pil(bytes(bad))


@pytest.mark.parametrize("tail", [b"\x00\x00", b"\xfd\xd9", b"", b"\xff"])
def test_end_without_eoi_follows_libjpegs_read_ahead(tail):
    """A file of one scan needs no EOI: PIL has every row once the scan is
    decoded, unless libjpeg's bit reader, which fills 57 bits at a time,
    asks for bytes past the end first (PIL then finds it truncated)."""
    for name in _stored_lossless():
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            data = fh.read()
        _same_as_pil(data[:-2] + tail, plain=len(data) < 3000)


# seed, index of tools/jpeg_fuzz_agreement.py's cases, and what they hold
LOSSLESS_FUZZ_CASES = [
    (0, 344, "a quantisation table selector past 3 in a lossless SOF"),
    (0, 590, "an SOS length that is not 6 + 2 * components"),
    (1, 397, "the EOI flipped to an SOF9 after the only scan"),
    (2, 15, "FF CB in the entropy data: a second frame header"),
    (2, 679, "the EOI's 0xFF flipped: the read-ahead decides"),
]


@pytest.mark.parametrize("case", LOSSLESS_FUZZ_CASES,
                         ids=[f"seed{c[0]}-{c[1]}" for c in LOSSLESS_FUZZ_CASES])
def test_fuzz_cases_equal_pil(case):
    seed, index, _why = case
    name, data = jpeg_fuzz_agreement.case(seed, index)
    assert name.startswith("lossless_")
    assert jpeg_fuzz_agreement.classify(data) in ("equal", "both_raise")
    _same_as_pil(data)


# --- against the JAX package: load_image and the photo wall ---------------------------


@pytest.fixture
def lossless_copies(tmp_path):
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(LOSSLESS_FIXTURE)))
        shutil.copyfile(LOSSLESS_FIXTURE, paths[-1])
    return paths


def test_load_image_gives_figdraw_tpus_image(lossless_copies):
    import figdraw_tpu.resources as jres

    from figdraw_tpu_torch import resources

    port_path, jax_path = lossless_copies
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    ref, jref = resources.load_image(port_path, bus=bus), jres.load_image(jax_path, bus=jbus)
    a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
    b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
    np.testing.assert_array_equal(a.image, np.asarray(b.image))
    assert a.image.shape == (168, 224, 4)
    for x, y in zip(a.mips, b.mips):
        np.testing.assert_array_equal(x, np.asarray(y))
    ref.close()
    jref.close()


def test_photo_wall_from_sof3_matches_jax(lossless_copies):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import (
        LOSSLESS_WALL_REFERENCE, PHOTO_WALL_SMALL, make_loaded_photo_wall,
    )

    port_path, jax_path = lossless_copies
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_path, w, h, n)
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(port_path, bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(LOSSLESS_WALL_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1.0 / 255.0
    ref.close()
