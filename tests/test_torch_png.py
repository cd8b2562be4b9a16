"""The port's PNG decoder (figdraw_tpu_torch/utils/png.py) against PIL's
`Image.open(...).convert("RGBA")`, which figdraw_tpu decodes through:
exact uint8 on every colour type and bit depth, tRNS on palettes, grey
and RGB, Adam7, split IDAT streams, each of the five row filters forced
(PNGs written here with zlib and struct), PNGs PIL writes, the repo's
fixture and random small images (hypothesis). The C++ unfilter against
its plain numpy/Python version; corrupt, truncated and non-PNG files
raise."""

import io
import json
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from figdraw_tpu_torch.scenes import IMAGE_FIXTURE, IMAGE_FIXTURE_REFERENCE
from figdraw_tpu_torch.utils import png

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
CASES = [(ct, d) for ct, ds in DEPTHS.items() for d in ds]


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples to (h, stride) bytes at `depth` bits a sample."""
    h, w, _c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    per = 8 // depth
    pad = np.zeros((h, -(-w // per) * per), np.uint8)
    pad[:, :w] = samples[..., 0]
    pad = pad.reshape(h, -1, per)
    out = np.zeros(pad.shape[:2], np.uint8)
    for k in range(per):
        out |= (pad[..., k] << (8 - depth * (k + 1))).astype(np.uint8)
    return out


def filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Filter each row with filters[y % len(filters)] (PNG spec 9.2)."""
    h, stride = rows.shape
    out = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        r = rows[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), r])[:stride]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev])[:stride]
        ft = filters[y % len(filters)]
        if ft == 0:
            f = r
        elif ft == 1:
            f = r - left
        elif ft == 2:
            f = r - prev
        elif ft == 3:
            f = r - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            f = r - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(ft)
        out += (f % 256).astype(np.uint8).tobytes()
        prev = r
    return bytes(out)


def encode(samples, ct, depth, plte=None, trns=None, interlace=0, filters=(0,),
           idat_parts=1) -> bytes:
    """A PNG of `samples` (h, w, channels) written with zlib and struct."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            raw += filter_rows(pack_rows(sub, depth), bpp, filters)
    z = zlib.compress(raw, 6)
    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ct, 0, 0,
                                                       interlace))
    out += chunk(b"tEXt", b"Comment\x00ancillary chunks are skipped")
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    step = max(1, -(-len(z) // idat_parts))
    for i in range(idat_parts):
        out += chunk(b"IDAT", z[i * step:(i + 1) * step])
    return out + chunk(b"IEND", b"")


def pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def random_png(rng, ct, depth, h, w, trns=False, **kw) -> bytes:
    c = CHANNELS[ct]
    plte = key = None
    if ct == 3:
        n = 1 << depth
        samples = rng.integers(0, n, (h, w, 1))
        # a palette shorter than the index range: PIL reads past it as black
        plte = rng.integers(0, 256, int(rng.integers(1, n + 1)) * 3).astype(np.uint8).tobytes()
        if trns:
            key = rng.integers(0, 256, int(rng.integers(1, n + 1))).astype(np.uint8).tobytes()
    else:
        samples = rng.integers(0, 1 << depth, (h, w, c))
        if trns and ct in (0, 2):
            pick = samples[rng.integers(h), rng.integers(w)]
            key = struct.pack(f">{c}H", *(int(v) for v in pick))
    return encode(samples, ct, depth, plte=plte, trns=key, **kw)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ct,depth", CASES, ids=[f"ct{c}-{d}bit" for c, d in CASES])
def test_every_colour_type_and_depth_matches_pil(ct, depth, interlace):
    rng = np.random.default_rng(ct * 100 + depth * 2 + interlace)
    for h, w in ((1, 1), (13, 11), (9, 33)):
        data = random_png(rng, ct, depth, h, w, interlace=interlace, filters=(0, 1, 2, 3, 4))
        got = png.decode_png(data)
        assert got.dtype == np.uint8 and got.shape == (h, w, 4)
        np.testing.assert_array_equal(got, pil_rgba(data))


@pytest.mark.parametrize("ct,depth", [(c, d) for c, d in CASES if c in (0, 2, 3)],
                         ids=[f"ct{c}-{d}bit" for c, d in CASES if c in (0, 2, 3)])
def test_trns_matches_pil(ct, depth):
    """tRNS on a palette (alpha a palette entry), on grey and on RGB (a key
    colour), PIL's byte cut of the key included."""
    rng = np.random.default_rng(7 + ct * 10 + depth)
    for interlace in (0, 1):
        for _ in range(4):
            data = random_png(rng, ct, depth, 12, 17, trns=True, interlace=interlace,
                              filters=(4, 3, 2, 1, 0))
            np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


def test_trns_keys_as_pil_reads_them():
    """The key semantics PIL 12 has, spelled out: a 2-bit grey key of 1 names
    no pixel (PIL compares it with the scaled value 85), a 1-bit key of 1
    names white, and a 16-bit grey key of 65535 names every sample of 255
    or more (its low byte against the clipped value)."""
    grey2 = encode(np.arange(4).reshape(1, 4, 1), 0, 2, trns=struct.pack(">H", 1))
    assert png.decode_png(grey2)[0, :, 3].tolist() == [255, 255, 255, 255]
    grey1 = encode(np.array([0, 1]).reshape(1, 2, 1), 0, 1, trns=struct.pack(">H", 1))
    assert png.decode_png(grey1)[0, :, 3].tolist() == [255, 0]
    grey16 = encode(np.array([5, 255, 300, 65535]).reshape(1, 4, 1), 0, 16,
                    trns=struct.pack(">H", 65535))
    assert png.decode_png(grey16)[0, :, 3].tolist() == [255, 0, 0, 0]
    for data in (grey2, grey1, grey16):
        np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ct,depth", [(6, 8), (2, 16), (0, 4), (4, 8)])
def test_each_row_filter_forced(filt, ct, depth):
    rng = np.random.default_rng(filt)
    data = random_png(rng, ct, depth, 21, 19, filters=(filt,))
    np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


@pytest.mark.parametrize("parts", [1, 2, 7, 64])
def test_split_idat(parts):
    rng = np.random.default_rng(parts)
    data = random_png(rng, 6, 8, 20, 20, interlace=parts % 2, filters=(1, 4), idat_parts=parts)
    np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA", "I;16"])
def test_pngs_pil_writes(mode, tmp_path):
    rng = np.random.default_rng(3)
    base = Image.fromarray(rng.integers(0, 256, (23, 31, 4), dtype=np.uint8), "RGBA")
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 65536, (23, 31), dtype=np.uint16))
    elif mode == "P":
        img = base.convert("RGB").quantize(colors=37)
    else:
        img = base.convert(mode)
    path = str(tmp_path / "x.png")
    img.save(path, optimize=mode == "P")
    np.testing.assert_array_equal(png.read_image(path),
                                  np.asarray(Image.open(path).convert("RGBA")))


def test_fixture_matches_pil_and_the_stored_digest():
    import hashlib

    got = png.read_image(IMAGE_FIXTURE)
    want = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))
    np.testing.assert_array_equal(got, want)
    with open(IMAGE_FIXTURE_REFERENCE) as fh:
        stored = json.load(fh)
    assert list(got.shape) == stored["shape"] == [600, 800, 4]
    assert hashlib.sha256(got.tobytes()).hexdigest() == stored["decoded_sha256"]


def test_fixture_rows_use_sub_up_and_paeth():
    """The fixture drives the sequential filters the C++ unfilter exists for."""
    with open(IMAGE_FIXTURE, "rb") as fh:
        _ihdr, _plte, _trns, stream = png._chunks(fh.read())
    raw = zlib.decompress(stream)
    filters = {raw[y * (800 * 4 + 1)] for y in range(600)}
    assert filters == {1, 2, 4}


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_unfilter_equals_its_plain_version(bpp):
    rng = np.random.default_rng(bpp)
    h, stride = 17, bpp * 13
    data = bytearray(rng.integers(0, 256, h * (stride + 1), dtype=np.uint8).tobytes())
    for y in range(h):
        data[y * (stride + 1)] = y % 5
    np.testing.assert_array_equal(png.unfilter(bytes(data), h, stride, bpp),
                                  png.unfilter_plain(bytes(data), h, stride, bpp))


def test_fixture_unfilters_equal():
    with open(IMAGE_FIXTURE, "rb") as fh:
        _ihdr, _plte, _trns, stream = png._chunks(fh.read())
    raw = zlib.decompress(stream)
    np.testing.assert_array_equal(png.unfilter(raw, 600, 3200, 4),
                                  png.unfilter_plain(raw, 600, 3200, 4))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), case=st.sampled_from(CASES),
       h=st.integers(1, 12), w=st.integers(1, 12), interlace=st.integers(0, 1),
       trns=st.booleans(), parts=st.integers(1, 3))
def test_random_small_images_match_pil(seed, case, h, w, interlace, trns, parts):
    rng = np.random.default_rng(seed)
    ct, depth = case
    filters = tuple(int(f) for f in rng.integers(0, 5, 4))
    data = random_png(rng, ct, depth, h, w, trns=trns, interlace=interlace,
                      filters=filters, idat_parts=parts)
    np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


def _valid() -> bytes:
    return random_png(np.random.default_rng(0), 6, 8, 8, 8, filters=(1, 4))


def test_bad_crc_raises():
    data = bytearray(_valid())
    data[40] ^= 0xFF  # the last byte of the tEXt chunk's type
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))


@pytest.mark.parametrize("cut", [9, 20, 33, 60, -13, -1])
def test_truncated_file_raises(cut):
    data = _valid()
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(data[:cut])


def test_truncated_image_data_raises():
    """A complete chunk list whose zlib stream stops early."""
    samples = np.random.default_rng(1).integers(0, 256, (16, 16, 4))
    raw = filter_rows(pack_rows(samples, 8), 4, (0,))
    z = zlib.compress(raw)[:-30]
    data = (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 16, 16, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", z) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="truncated|corrupt"):
        png.decode_png(data)


def test_bad_signature_and_filter_raise():
    data = bytearray(_valid())
    data[1] = ord("Q")
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(bytes(data))
    rows = pack_rows(np.zeros((2, 2, 4), np.uint8), 8)
    raw = bytes([0]) + rows[0].tobytes() + bytes([9]) + rows[1].tobytes()
    data = (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter"):
        png.decode_png(data)


@pytest.mark.parametrize("fmt", ["PPM", "SGI", "PCX", "DDS", "AVIF"])
def test_other_formats_raise_not_implemented(fmt, tmp_path):
    """Formats PIL reads that the port does not decode (JPEG, GIF, BMP,
    TIFF, WebP and AVIF decode since utils/imagefile.py: tests/test_torch_jpeg.py,
    test_torch_tiff.py, test_torch_webp.py, test_torch_avif.py and the others
    hold them to PIL), and an AVIF outside the port's slice (an image
    sequence, PIL's save_all, with its tracks' size 3/4 of its frames')."""
    path = str(tmp_path / f"x.{fmt.lower()}")
    extra = ({"save_all": True, "append_images": [Image.fromarray(np.full((8, 8, 3), 9, np.uint8))]}
             if fmt == "AVIF" else {})
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path, format=fmt, **extra)
    if fmt == "AVIF":
        import os
        import sys

        from torch_reference import REPO

        sys.path.insert(0, os.path.join(REPO, "tools"))
        from make_image_formats import with_track_size

        with open(path, "rb") as fh:
            data = with_track_size(fh.read(), 6, 6)
        with open(path, "wb") as fh:
            fh.write(data)
    with pytest.raises(NotImplementedError, match="Image formats other than PNG"):
        png.read_image(path)


def test_a_file_that_is_no_image_raises(tmp_path):
    path = str(tmp_path / "x.txt")
    with open(path, "w") as fh:
        fh.write("not an image at all")
    with pytest.raises(ValueError):
        png.read_image(path)
