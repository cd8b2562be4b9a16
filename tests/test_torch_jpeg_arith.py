"""The port's arithmetic-coded JPEG decoding (utils/jpeg.py: SOF9, SOF10 and
the DAC marker; csrc/image_decode.cpp's fd_jpeg_arith_scan and its plain
twin `arith_scan_plain`) against PIL 12.1.0's `Image.open(...).convert(
"RGBA")` through libjpeg-turbo 3.1.3, which figdraw_tpu decodes through.

Files come from the stored references (tools/make_image_formats.py) and
from tools/jpeg_arith_lossless_writer.c, built with gcc into a temporary
directory and linked to PIL's libjpeg-turbo: seeded images of several
sizes, sequential and progressive, 4:4:4 to 4:2:0 and other sampling,
grey and CMYK, restart intervals, DC conditioning L and U and AC
conditioning Kx other than libjpeg's defaults. Each equals PIL byte for
byte through `load_image`'s decoder, and fd_jpeg_arith_scan equals its
plain twin coefficient for coefficient. Also: the Qe table against the
library's own, the DAC errors, a Huffman stream relabelled SOF9, restart
markers out of sequence, seeded corrupt cases of tools/jpeg_fuzz_agreement.py,
and the SOF10 fixture through load_image and the image-file scene against
figdraw_tpu's (image, mips, sidecar, frames)."""

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
    ARITH_FIXTURE, IMAGE_FIXTURE, IMAGE_FORMATS_DIR, IMAGE_FORMATS_REFERENCE,
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
    """A w x h crop of the fixture with seeded noise (so that long
    magnitude categories and large DC differences occur)."""
    base = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))[..., :channels]
    rng = np.random.default_rng(seed)
    y, x = rng.integers(0, 600 - h + 1), rng.integers(0, 800 - w + 1)
    img = base[y: y + h, x: x + w].astype(np.int64)
    img = img + rng.integers(-60, 61, img.shape) * (rng.random(img.shape[:2]) < 0.5)[..., None]
    out = np.clip(img, 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


def _pil(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception:  # noqa: BLE001 - any PIL failure is a refusal
        return None


def _same_as_pil(data: bytes) -> None:
    """The port's decode (C++ through decode_image, and the plain twins on
    small images) equals PIL's, or both refuse."""
    want = _pil(data)
    if want is None:
        with pytest.raises((ValueError, NotImplementedError)):
            imagefile.decode_image(data)
        return
    got = imagefile.decode_image(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if got.shape[0] * got.shape[1] <= 64 * 48:
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, plain=True), want)


def _cases():
    """Seeded writer cases: (id, width, height, channels, options)."""
    rng = np.random.default_rng(2209)
    out = []
    samplings = ["1x1,1x1,1x1", "2x1,1x1,1x1", "2x2,1x1,1x1", "1x2,1x1,1x1", "4x1,1x1,1x1",
                 "2x2,1x2,1x1"]
    for i in range(24):
        w, h = int(rng.integers(1, 70)), int(rng.integers(1, 56))
        channels = (3, 3, 3, 1, 4)[i % 5]
        opts = ["arith", f"quality={int(rng.integers(5, 101))}"]
        if i % 2:
            opts.append("progressive")
        if channels == 3 and i % 3:
            opts += ["space=ycc", f"sampling={samplings[i % len(samplings)]}"]
        for t in (0, 1):
            if rng.random() < 0.6:
                lo = int(rng.integers(0, 5))
                opts.append(f"dc={t},{lo},{int(rng.integers(lo, 10))}")
            if rng.random() < 0.6:
                opts.append(f"ac={t},{int(rng.integers(1, 64))}")
        if rng.random() < 0.5:
            opts.append(f"restart={int(rng.integers(1, 6))}")
        out.append((f"{i}-{w}x{h}x{channels}-{'prog' if i % 2 else 'seq'}", w, h, channels, opts))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_written_files_equal_pil(case, writer):
    _id, w, h, channels, opts = case
    data = make_image_formats.arith_lossless_jpeg(_image(w, h, w * 97 + h, channels), *opts,
                                                  writer=writer)
    sof = b"\xff\xca" if "progressive" in opts else b"\xff\xc9"
    assert sof in data and b"\xff\xcc" in data
    want = _pil(data)
    assert want is not None and want.shape == (h, w, 4)
    _same_as_pil(data)


@pytest.mark.parametrize("case", CASES[:12], ids=[c[0] for c in CASES[:12]])
def test_arith_scan_equals_arith_scan_plain(case, writer):
    """fd_jpeg_arith_scan against arith_scan_plain: the same coefficients in
    every component after every scan."""
    _id, w, h, channels, opts = case
    data = make_image_formats.arith_lossless_jpeg(_image(w, h, w * 97 + h, channels), *opts,
                                                  writer=writer)
    native, plain = jpeg.read_frame(data), jpeg.read_frame(data, plain=True)
    assert native.arith and native.kind == (jpeg.PROGRESSIVE if "progressive" in opts
                                            else jpeg.SEQUENTIAL)
    for a, b in zip(native.components, plain.components):
        np.testing.assert_array_equal(a.coefs, b.coefs)


def _stored_arith():
    return sorted(n for n in os.listdir(IMAGE_FORMATS_DIR)
                  if n.startswith("arith_") and n.endswith(".jpg"))


@pytest.mark.parametrize("name", _stored_arith())
def test_stored_files_equal_pil_and_their_digests(name):
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        ref = json.load(fh)["files"][name]
    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        data = fh.read()
    assert hashlib.sha256(data).hexdigest() == ref["sha256"]
    got = imagefile.decode_image(data, name)
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["decoded_sha256"]
    np.testing.assert_array_equal(got, _pil(data))
    frame = jpeg.read_frame(data)
    assert frame.arith
    if "dac" in name:  # conditioning other than libjpeg's defaults was read
        assert not np.array_equal(frame.cond, jpeg.DAC_DEFAULT)


def test_stored_sof10_crop_scans_equal_plain():
    """The stored progressive crop with non-default DAC values: every scan's
    coefficients, C++ against plain (the AC refinement and the DC contexts
    with L and U other than 0 and 1)."""
    with open(os.path.join(IMAGE_FORMATS_DIR, "arith_dac_progressive_420.jpg"), "rb") as fh:
        data = fh.read()
    native, plain = jpeg.read_frame(data), jpeg.read_frame(data, plain=True)
    assert list(native.cond[:2]) == [3, 0] and list(native.cond[16:18]) == [4, 0]
    assert list(native.cond[32:34]) == [40, 1]
    for a, b in zip(native.components, plain.components):
        np.testing.assert_array_equal(a.coefs, b.coefs)
        assert a.coefs.any()


def test_qe_table_is_libjpegs():
    """jpeg.QE_TABLE (and the C++ copy, through the decodes above) against
    jaricom.c's jpeg_aritab as compiled into PIL's libjpeg-turbo."""
    import PIL

    lib = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                 "libjpeg-*.so*"))[0]
    with open(lib, "rb") as fh:
        blob = fh.read()
    at = blob.find(struct.pack("<qq", 0x5A1D0181, 0x2586020E))
    assert at >= 0
    table = np.array(struct.unpack_from("<114q", blob, at))
    np.testing.assert_array_equal(table, jpeg.QE_TABLE)
    src = open(os.path.join(REPO, "figdraw_tpu_torch", "csrc", "image_decode.cpp")).read()
    body = src[src.index("kQe[114] = {"): src.index("};", src.index("kQe[114] = {"))]
    assert [int(v, 16) for v in body.split("{")[1].replace(",", " ").split()] == table.tolist()


@pytest.mark.parametrize("dac,why", [(b"\x00\x21\x10", "odd length"),
                                     (b"\x20\x05", "index past 31"),
                                     (b"\x00\x12", "L above U")])
def test_malformed_dac_raises_as_libjpeg(dac, why, writer):
    data = make_image_formats.arith_lossless_jpeg(_image(16, 16, 1), "arith", writer=writer)
    at = data.index(b"\xff\xcc")
    n = struct.unpack_from(">H", data, at + 2)[0]
    bad = data[:at] + b"\xff\xcc" + struct.pack(">H", len(dac) + 2) + dac + data[at + 2 + n:]
    assert _pil(bad) is None, why
    with pytest.raises(ValueError, match="DAC"):
        jpeg.decode_jpeg(bad)


@pytest.mark.parametrize("progressive", [False, True])
def test_huffman_stream_relabelled_arithmetic_gives_what_pil_gives(progressive):
    """A Huffman stream under an SOF9 or SOF10 header is corrupt arithmetic
    data: the port gives PIL's pixels (or refuses where PIL does)."""
    buf = io.BytesIO()
    Image.fromarray(_image(40, 24, 5)).save(buf, "JPEG", quality=80, progressive=progressive)
    data = buf.getvalue()
    old, new = (b"\xff\xc2", b"\xff\xca") if progressive else (b"\xff\xc0", b"\xff\xc9")
    at = data.index(old)
    _same_as_pil(data[:at] + new + data[at + 2:])


@pytest.mark.parametrize("replacement", range(8))
def test_restart_markers_out_of_sequence_resync_as_libjpeg(replacement):
    """Each restart marker of the stored 4:4:4 crop (a restart every three
    MCUs) replaced in turn by RSTn: jpeg_resync_to_restart's choices
    (discard, scan on, or keep the marker and decode an empty interval)."""
    with open(os.path.join(IMAGE_FORMATS_DIR, "arith_dac_444_rst.jpg"), "rb") as fh:
        data = fh.read()
    spots = [i for i in range(len(data) - 1)
             if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    assert len(spots) > 8
    for at in spots[:: max(1, len(spots) // 6)]:
        bad = bytearray(data)
        bad[at + 1] = 0xD0 + replacement
        _same_as_pil(bytes(bad))


# seed, index of tools/jpeg_fuzz_agreement.py's cases, and what they hold
ARITH_FUZZ_CASES = [
    (0, 117, "an SOS length that is not 6 + 2 * components"),
    (0, 373, "an RST0 flipped to a second SOI inside a scan"),
    (0, 420, "a DAC marker flipped to an unknown marker code"),
    (0, 928, "FF 00 in the entropy data flipped to a marker libjpeg does not know"),
    (1, 772, "a DRI segment of length 5"),
    (2, 451, "an SOS flipped to SOI after a frame header"),
    (0, 180, "a restart marker replaced by a later one"),
    (0, 181, "a restart marker lost: the interval runs into the next"),
    (0, 1748, "a restart marker flipped to a JPGn code"),
    (3, 1492, "a restart marker flipped to SOI"),
]


@pytest.mark.parametrize("case", ARITH_FUZZ_CASES,
                         ids=[f"seed{c[0]}-{c[1]}" for c in ARITH_FUZZ_CASES])
def test_fuzz_cases_equal_pil(case):
    """Each case rebuilt from its seed and index: the port gives PIL's image
    byte for byte, or raises where PIL fails."""
    seed, index, _why = case
    _name, data = jpeg_fuzz_agreement.case(seed, index)
    assert jpeg_fuzz_agreement.classify(data) in ("equal", "both_raise")
    _same_as_pil(data)


def test_file_without_eoi_decodes_only_with_one_scan():
    """Once its only scan is decoded a sequential file has every row (PIL
    returns it without an EOI); a progressive file is read to its EOI first
    (PIL finds it truncated)."""
    for name, want_image in (("arith_420_q90.jpg", True), ("arith_dac_444_rst.jpg", True),
                             (os.path.basename(ARITH_FIXTURE), False)):
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            data = fh.read()
        for tail in (b"\x00\x00", b"\xfd\xd9"):
            bad = data[:-2] + tail
            assert (_pil(bad) is not None) == want_image, name
            _same_as_pil(bad)


# --- against the JAX package: load_image, the sidecar and the frames -------------


@pytest.fixture
def arith_copies(tmp_path):
    """The stored SOF10 fixture copied twice (each package writes its own
    sidecar beside its file)."""
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(ARITH_FIXTURE)))
        shutil.copyfile(ARITH_FIXTURE, paths[-1])
    return paths


def test_load_image_gives_figdraw_tpus_image_mips_and_sidecar(arith_copies):
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    port_path, jax_path = arith_copies
    jax_flippy()
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    ref, jref = resources.load_image(port_path, bus=bus), jres.load_image(jax_path, bus=jbus)
    a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
    b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
    np.testing.assert_array_equal(a.image, np.asarray(b.image))
    assert a.image.shape == (600, 800, 4) and len(a.mips) == len(b.mips)
    for x, y in zip(a.mips, b.mips):
        np.testing.assert_array_equal(x, np.asarray(y))
    with open(port_path + ".flippy", "rb") as fh, open(jax_path + ".flippy", "rb") as jfh:
        sidecar = fh.read()
        assert sidecar == jfh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:  # the digest chip_smoke.py holds the card to
        want = json.load(fh)["sidecar"][os.path.basename(ARITH_FIXTURE)]
    assert hashlib.sha256(sidecar).hexdigest() == want
    ref.close()
    jref.close()


def test_image_file_scene_from_sof10_matches_jax(arith_copies):
    """The image-file scene with the SOF10 fixture loaded: the port's
    render_frame on the CPU within 1/255 of figdraw_tpu's frame, which the
    stored block means hold (chip_smoke.py holds the card to them)."""
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_image_file_frame

    from figdraw_tpu_torch.scenes import ARITH_FILE_REFERENCE, render_image_file

    port_path, jax_path = arith_copies
    want = jax_image_file_frame(jax_path, "1x")
    _ren, frame, ref = render_image_file(
        lambda ps: port.FigRenderer(atlas_size=512, device="cpu", pixel_scale=ps),
        port_path, "1x")
    got = frame.numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(ARITH_FILE_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1.0 / 255.0
    ref.close()
