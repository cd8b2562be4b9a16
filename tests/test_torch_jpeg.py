"""The port's JPEG decoder (figdraw_tpu_torch/utils/jpeg.py, csrc/
image_decode.cpp) against PIL 12.1.0's `Image.open(...).convert("RGBA")`
through libjpeg-turbo 3.1.3, which figdraw_tpu decodes through: equal byte
for byte on files PIL writes here from the repo's fixture and seeded
numpy images (subsampling 4:4:4, 4:2:2 and 4:2:0; baseline, progressive
and optimized Huffman tables; qualities 1 to 100; 16-bit tables in an
SOF1 frame; restart intervals; grayscale, Adobe CMYK and YCCK, Adobe RGB;
sizes 1x1 to 801x599). Each C++ stage against its plain Python/numpy twin
(4:4:0 and 4:1:1, which PIL 12.1.0 cannot write, are held there only: not
checked against PIL). The stored files' digests, the errors, and
load_image of a JPEG against figdraw_tpu's (image, mips, sidecar, frames).

The IDCT is libjpeg-turbo's x86-64 SIMD form (16-bit lanes), which PIL
runs on x86-64: it equals jidctint.c with its range-limit table while
no intermediate leaves int16, and the quantiser tests past 8191 show the
two part there (jidctint.c would differ from PIL by up to 255) while the
port stays equal to PIL."""

import hashlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import (
    IMAGE_FIXTURE, IMAGE_FORMATS_DIR, IMAGE_FORMATS_REFERENCE, JPEG_FIXTURE,
)
from figdraw_tpu_torch.utils import image_lib, imagefile, jpeg
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
torch.set_num_threads(1)

SUBSAMPLING = ["4:4:4", "4:2:2", "4:2:0"]
KINDS = {"baseline": {}, "progressive": {"progressive": True}, "optimized": {"optimize": True}}
SIZES = [(1, 1), (7, 9), (17, 33), (801, 599)]


def _source(w: int, h: int) -> np.ndarray:
    """An RGB image of w x h: the fixture's RGB (edge-padded past 800x600)
    with seeded noise over its top-left 64x64, so every block has detail."""
    base = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGB"))
    img = np.pad(base, ((0, max(0, h - 600)), (0, max(0, w - 800)), (0, 0)), mode="edge")
    img = img[:h, :w].copy()
    rng = np.random.default_rng(w * 1000 + h)
    n = img[:64, :64]
    img[:64, :64] = np.clip(n.astype(int) + rng.integers(-40, 41, n.shape), 0, 255)
    return img


def _encode(img, mode="RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _same(data: bytes, plain: bool = False) -> None:
    got = jpeg.decode_jpeg(data, plain=plain)
    want = _pil(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("ss", SUBSAMPLING)
def test_decode_equals_pil(ss, kind, size):
    _same(_encode(_source(*size), subsampling=ss, quality=90, **KINDS[kind]))


@pytest.mark.parametrize("ss", SUBSAMPLING)
def test_every_quality_equals_pil(ss):
    img = _source(40, 24)
    for q in range(1, 101):
        _same(_encode(img, subsampling=ss, quality=q))
    _same(_encode(img, subsampling=ss, quality=1, progressive=True))


def test_sixteen_bit_tables_give_sof1_and_equal_pil():
    img = _source(96, 72)
    tables = [[200 + 7 * i for i in range(64)]] * 2
    data = _encode(img, qtables=tables)
    assert b"\xff\xc1" in data and b"\xff\xc0" not in data
    _same(data)
    _same(_encode(img, qtables=tables, progressive=True))


@pytest.mark.parametrize("top", [20000, 32767, 65535])
def test_quantisers_past_int16_lanes_equal_pil(top):
    """Quantisers past 8191 (PIL's encoder cannot honour them: its divisors
    are 16-bit) give coefficients whose IDCT leaves int16: there
    jidctint.c's C arithmetic differs from PIL (measured here: up to 255)
    and the port's 16-bit lane arithmetic does not."""
    img = _source(800, 600)
    tables = [[min(top, 100 + (top - 100) * i // 63) for i in range(64)]] * 2
    data = _encode(img, qtables=tables)
    _same(data)
    frame = jpeg.read_frame(data)
    c_code = [_islow_c(c.coefs, c.qt) for c in frame.components]
    lanes = [jpeg.idct(c.coefs, c.qt) for c in frame.components]
    worst = max(int(np.abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(c_code, lanes))
    assert 0 < worst <= 255


def _islow_c(coefs, qt):
    """jidctint.c with its range-limit table, in numpy (int64, no 16-bit
    lanes): the C code the SIMD form stands in for."""
    bh, bw = coefs.shape[:2]
    d = coefs.astype(np.int64).reshape(bh, bw, 8, 8) * qt.astype(np.int64).reshape(8, 8)

    def one_d(x):
        x = [x[..., j] for j in range(8)]
        z1 = (x[2] + x[6]) * 4433
        t2, t3 = z1 - x[6] * 15137, z1 + x[2] * 6270
        t0, t1 = (x[0] + x[4]) * 8192, (x[0] - x[4]) * 8192
        a10, a13, a11, a12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
        z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
        z5 = (z3 + z4) * 9633
        o0, o1, o2, o3 = o0 * 2446, o1 * 16819, o2 * 25172, o3 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
        o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
        return np.stack([a10 + o3, a11 + o2, a12 + o1, a13 + o0,
                         a13 - o0, a12 - o1, a11 - o2, a10 - o3], -1)

    ws = np.swapaxes((one_d(np.swapaxes(d, -1, -2)) + 1024) >> 11, -1, -2)
    v = ((one_d(ws) + (1 << 17)) >> 18) & 1023
    v = np.clip(np.where(v >= 512, v - 1024, v) + 128, 0, 255).astype(np.uint8)
    return v.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


@pytest.mark.parametrize("kw", [dict(restart_marker_rows=1, subsampling="4:4:4"),
                                dict(restart_marker_blocks=3),
                                dict(restart_marker_blocks=1, progressive=True),
                                dict(restart_marker_rows=2, subsampling="4:2:2",
                                     progressive=True)],
                         ids=["rows1_444", "blocks3", "blocks1_prog", "rows2_422_prog"])
def test_restart_intervals_equal_pil(kw):
    data = _encode(_source(133, 77), quality=80, **kw)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _same(data)
    _same(_encode(_source(21, 19), quality=80, **kw), plain=True)


@pytest.mark.parametrize("mode", ["L", "CMYK"])
@pytest.mark.parametrize("progressive", [False, True])
def test_grey_and_cmyk_equal_pil(mode, progressive):
    data = _encode(_source(121, 67), mode, quality=85, progressive=progressive)
    _same(data)
    if mode == "CMYK":  # PIL writes Adobe CMYK: transform 0, no JFIF
        frame = jpeg.read_frame(data)
        assert frame.adobe == 0 and not frame.jfif and jpeg.color_space(frame) == "CMYK"


def test_ycck_and_adobe_rgb_equal_pil():
    """A CMYK file with Adobe's transform flag set to 2 reads as YCCK (the
    same scans, colour-converted by ycck_cmyk_convert); keep_rgb writes
    Adobe transform 0 RGB, kept as RGB."""
    data = bytearray(_encode(_source(90, 70), "CMYK", quality=85))
    at = data.find(b"Adobe")
    data[at + 11] = 2
    assert jpeg.color_space(jpeg.read_frame(bytes(data))) == "YCCK"
    _same(bytes(data))
    rgb = _encode(_source(90, 70), quality=85, keep_rgb=True)
    assert jpeg.color_space(jpeg.read_frame(rgb)) == "RGB"
    _same(rgb)


@pytest.mark.parametrize("size", [(7, 9), (17, 33), (33, 17), (2, 3)], ids=str)
@pytest.mark.parametrize("kind", ["baseline", "progressive"])
def test_plain_decode_equals_pil(kind, size):
    """Every stage's plain twin, chained, also equals PIL."""
    for ss in SUBSAMPLING:
        _same(_encode(_source(*size), subsampling=ss, quality=70, **KINDS[kind]), plain=True)


@pytest.mark.parametrize("kind", ["baseline", "progressive", "grey", "cmyk_prog"])
def test_scan_equals_scan_plain(kind):
    """fd_jpeg_scan against scan_plain: the same coefficients, every
    component, on a 4:2:0 image with restarts."""
    mode = {"grey": "L", "cmyk_prog": "CMYK"}.get(kind, "RGB")
    data = _encode(_source(45, 37), mode, quality=60, restart_marker_blocks=2,
                   progressive=kind in ("progressive", "cmyk_prog"))
    native, plain = jpeg.read_frame(data), jpeg.read_frame(data, plain=True)
    for a, b in zip(native.components, plain.components):
        np.testing.assert_array_equal(a.coefs, b.coefs)
        assert a.coefs.any()


def test_idct_equals_idct_plain():
    rng = np.random.default_rng(7)
    coefs = rng.integers(-64, 65, (5, 7, 64)).astype(np.int16)
    coefs[..., 0] = rng.integers(-1024, 1024, (5, 7))
    coefs[0, 0, 8:] = 0  # the pass-1 shortcut
    coefs[1, 1] = rng.integers(-32768, 32768, 64)  # every lane overflows
    for qt in (rng.integers(1, 256, 64), rng.integers(1, 65536, 64), np.ones(64)):
        qt = qt.astype(np.uint16)
        np.testing.assert_array_equal(jpeg.idct(coefs, qt), jpeg.idct_plain(coefs, qt))


@pytest.mark.parametrize("ratio", [(2, 1), (2, 2), (1, 2), (4, 1), (1, 1), (4, 2), (3, 1)],
                         ids=["h2v1", "h2v2", "h1v2_440", "h4v1_411", "h1v1", "h4v2",
                              "h3v1"])
def test_upsample_equals_upsample_plain(ratio):
    """Each method of fd_jpeg_upsample against its numpy twin at narrow
    and odd component sizes (the fancy ones need more than 2 samples
    across). 4:4:0 (h1v2) and 4:1:1 (h4v1) are held here only: PIL
    12.1.0 cannot write them (subsampling="4:4:0" raises)."""
    rng = np.random.default_rng(3)
    hx, vy = ratio
    for cw, ch in ((1, 1), (2, 3), (3, 2), (5, 7), (17, 9)):
        comp = jpeg.Component(1, 4 // hx if hx <= 4 else 1, 2 // vy if vy <= 2 else 1, 0)
        comp.cw, comp.ch = cw, ch
        hmax, vmax = comp.h * hx, comp.v * vy
        method, gx, gy = jpeg.upsample_method(comp, hmax, vmax)
        assert (gx, gy) == (hx, vy)
        plane = rng.integers(0, 256, (-(-ch // 8) * 8, -(-cw // 8) * 8)).astype(np.uint8)
        ow, oh = cw * hx - (1 if cw * hx > 1 else 0), ch * vy
        np.testing.assert_array_equal(
            jpeg.upsample(plane, cw, ch, ow, oh, method, hx, vy),
            jpeg.upsample_plain(plane, cw, ch, ow, oh, method, hx, vy))


def test_upsample_methods_follow_jdsample():
    c = jpeg.Component(1, 1, 1, 0)
    for (cw, hmax, vmax), want in {(5, 2, 1): jpeg.H2V1, (2, 2, 1): jpeg.BOX,
                                   (5, 2, 2): jpeg.H2V2, (2, 2, 2): jpeg.BOX,
                                   (1, 1, 2): jpeg.H1V2, (5, 4, 1): jpeg.BOX,
                                   (5, 1, 1): jpeg.BOX}.items():
        c.cw = cw
        assert jpeg.upsample_method(c, hmax, vmax)[0] == want
    with pytest.raises(ValueError, match="integral"):
        jpeg.upsample_method(jpeg.Component(1, 2, 1, 0), 3, 1)


@pytest.mark.parametrize("kind", [jpeg.YCC_RGB, jpeg.YCC_INVERTED])
def test_color_equals_color_plain(kind):
    g = np.arange(256, dtype=np.uint8)
    y, cb, cr = (a.reshape(256, 256, 4) for a in np.meshgrid(g, g, g[::64], indexing="ij"))
    np.testing.assert_array_equal(jpeg.color(y, cb, cr, kind),
                                  jpeg.color_plain(y, cb, cr, kind))


def test_stored_files_match_their_digests():
    """figdraw_tpu_torch/reference/images against image_formats.json
    (tools/make_image_formats.py): each file's bytes, PIL's decode of it,
    and the port's decode equal to PIL's."""
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        stored = json.load(fh)["files"]
    assert sorted(stored) == sorted(os.listdir(IMAGE_FORMATS_DIR))
    total = 0
    for name, ref in stored.items():
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            data = fh.read()
        total += len(data)
        assert hashlib.sha256(data).hexdigest() == ref["sha256"], name
        pil = _pil(data)
        assert hashlib.sha256(pil.tobytes()).hexdigest() == ref["decoded_sha256"], name
        got = imagefile.decode_image(data, name)
        assert list(got.shape) == ref["shape"], name
        np.testing.assert_array_equal(got, pil, err_msg=name)
    assert total < 1 << 20


def test_stored_files_are_what_the_tool_writes():
    import sys

    from torch_reference import REPO

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_image_formats import image_files

    for name, data in image_files().items():
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            assert fh.read() == data, name


def _with_marker(data: bytes, old: bytes, new: bytes) -> bytes:
    at = data.find(old)
    assert at > 0
    return data[:at] + new + data[at + len(old):]


@pytest.mark.parametrize("sof,what", [(b"\xff\xcb", "arithmetic-coded lossless"),
                                      (b"\xff\xcd", "hierarchical arithmetic-coded"),
                                      (b"\xff\xc5", "hierarchical")])
def test_unported_coding_processes_raise(sof, what, tmp_path):
    """The processes PIL 12.1.0 cannot read either: arithmetic lossless
    (SOF11) and hierarchical (SOF5, SOF13). SOF9, SOF10 and SOF3 are read
    (tests/test_torch_jpeg_arith.py, test_torch_jpeg_lossless.py)."""
    data = _with_marker(_encode(_source(16, 16)), b"\xff\xc0", sof)
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as fh:
        fh.write(data)
    with pytest.raises(NotImplementedError,
                       match=rf"{what}.*Image formats other than PNG.*x\.jpg"):
        imagefile.read_image(path)


def test_twelve_bit_samples_raise():
    data = bytearray(_encode(_source(16, 16)))
    at = data.find(b"\xff\xc0")
    data[at + 4] = 12
    with pytest.raises(NotImplementedError, match="12-bit"):
        imagefile.decode_image(bytes(data))


@pytest.mark.parametrize("cut", [0.5, 0.9])
def test_truncated_files_raise(cut):
    data = _encode(_source(64, 48))
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(data[: int(len(data) * cut)])


def test_read_image_never_calls_pil(tmp_path, monkeypatch):
    """With PIL unimportable, read_image still decodes a JPEG (the port
    has no fallback to PIL)."""
    import sys

    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as fh:
        fh.write(_encode(_source(20, 12)))
    want = _pil(open(path, "rb").read())
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)
    np.testing.assert_array_equal(imagefile.read_image(path), want)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """The C++ helper does not build: read_image raises, never decodes
    through the plain twins."""
    import subprocess

    from figdraw_tpu_torch.utils import gxx

    def broken(*_a, **_k):
        raise subprocess.CalledProcessError(1, ["g++"], "", "error")

    monkeypatch.setattr(image_lib, "_lib", None)
    monkeypatch.setattr(gxx, "build", broken)
    with pytest.raises(subprocess.CalledProcessError):
        imagefile.decode_image(_encode(_source(8, 8)))


# --- libjpeg's Huffman reader at the end of the data, and its marker checks ------


def _pil_or_none(data: bytes):
    try:
        return _pil(data)
    except Exception:  # noqa: BLE001 - any PIL failure is a refusal
        return None


def _same_or_both_refuse(data: bytes, plain: bool = False) -> None:
    """The port gives PIL's image byte for byte, or refuses where PIL does."""
    want = _pil_or_none(data)
    for dec in (imagefile.decode_image,) + ((lambda d: jpeg.decode_jpeg(d, plain=True),)
                                           if plain else ()):
        if want is None:
            with pytest.raises((ValueError, NotImplementedError)):
                dec(data)
        else:
            np.testing.assert_array_equal(dec(data), want)


HUFFMAN_STORED = ["baseline_420_q90.jpg", "gray.jpg", "cmyk.jpg", "crop_797x599.jpg",
                  "restart_444.jpg"]


def _stored(name: str) -> bytes:
    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("tail", [b"\x00\x00", b"\xfd\xd9", b"", b"\xff"])
def test_huffman_end_without_eoi_follows_libjpegs_read_ahead(tail):
    """A file of one Huffman scan needs no EOI: PIL has every row once the
    scan is decoded, unless jdhuff.c's reader, which fills 57 bits at a time
    (and six bytes at a time on its fast path), asked for bytes past the
    end first (PIL then finds it truncated)."""
    for name in HUFFMAN_STORED:
        _same_or_both_refuse(_stored(name)[:-2] + tail)


@pytest.mark.parametrize("name", HUFFMAN_STORED)
def test_huffman_cuts_in_the_last_600_bytes_equal_pil(name):
    data = _stored(name)
    for k in range(1, 601):
        _same_or_both_refuse(data[:-k])


def test_fast_path_decides_where_the_read_ahead_ends():
    """A 136x82 crop whose EOI is replaced by zero bytes: decode_mcu_fast,
    taken while 512 bytes a block remain, leaves other bits buffered than
    the slow path would, and with three to six zero bytes PIL's libjpeg
    asks for a byte past the end (a reader without the fast path would
    return the image); with seven it has enough."""
    b = io.BytesIO()
    Image.open(IMAGE_FIXTURE).convert("RGB").crop((268, 233, 404, 315)).save(
        b, "JPEG", quality=77, subsampling="4:4:4")
    data = b.getvalue()
    for k in range(9):
        padded = data[:-2] + b"\0" * k
        assert (_pil_or_none(padded) is None) == (k < 7)
        _same_or_both_refuse(padded, plain=k in (6, 7))


def test_reads_of_65536_bytes_decide_the_fast_path():
    """A 206823-byte file (400x320 with seeded noise at q 95): PIL hands
    libjpeg the file in reads of 65536 bytes, and an MCU near a read's end
    takes the slow path, then the fast one again once the next read is
    there; that history decides where the read-ahead ends. PIL refuses the
    file with up to three zero bytes in place of its EOI and reads it with
    four (a reader fed the whole file at once would read it with none)."""
    rng = np.random.default_rng(2)
    base = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGB"))[:320, :400].astype(np.int64)
    noisy = np.clip(base + rng.integers(-50, 51, base.shape), 0, 255).astype(np.uint8)
    data = _encode(noisy, quality=95, subsampling="4:4:4")
    assert len(data) > 3 * jpeg.CHUNK
    for k in range(6):
        padded = data[:-2] + b"\0" * k
        assert (_pil_or_none(padded) is None) == (k < 4)
        _same_or_both_refuse(padded)


def test_stored_file_without_eoi_equals_pil():
    data = _stored("baseline_no_eoi.jpg")
    assert not data.endswith(b"\xff\xd9")
    _same_or_both_refuse(data, plain=True)
    _same_or_both_refuse(data[:-1])


# seed, index of `tools/jpeg_fuzz_agreement.py --huffman`'s cases, and what they hold
HUFFMAN_FUZZ_CASES = [
    (2, 286, "an RST3 flipped to DQT whose length runs past the end: its table number "
             "is refused before the data runs out"),
    (1, 1135, "a sequential scan's Ss of 8: libjpeg only warns, and builds both tables"),
    (1, 1142, "a scan naming component 3 twice"),
]


@pytest.mark.parametrize("case", HUFFMAN_FUZZ_CASES,
                         ids=[f"seed{c[0]}-{c[1]}" for c in HUFFMAN_FUZZ_CASES])
def test_huffman_fuzz_cases_equal_pil(case):
    seed, index, _why = case
    import jpeg_fuzz_agreement

    _name, data = jpeg_fuzz_agreement.case(seed, index, huffman=True)
    assert jpeg_fuzz_agreement.classify(data) in ("equal", "both_raise")
    _same_or_both_refuse(data)


def _segments(data: bytes) -> list:
    import make_image_formats

    return make_image_formats.jpeg_segments(data)


def test_missing_huffman_tables_are_the_standard_ones_when_sequential():
    """libjpeg's sequential Huffman decoder takes Annex K.3's tables for
    tables 0 and 1 a file leaves undefined (jstdhuff.c); the progressive
    decoder does not, and PIL refuses such a file."""
    for kw, refused in (({}, False), ({"progressive": True}, True)):
        data = _encode(_source(40, 24), quality=80, **kw)
        bare = b"".join(seg for code, seg in _segments(data) if code != 0xC4)
        assert (_pil_or_none(bare) is None) == refused
        _same_or_both_refuse(bare, plain=True)
    for key, table in jpeg.STD_HUFFMAN.items():  # PIL writes them when it does not optimise
        spec = bytes([16 * key[0] + key[1]]) + table
        assert spec in _encode(_source(16, 16), quality=80)


def test_refinement_scan_whose_al_is_not_ah_less_one_is_refused():
    import make_image_formats

    data = _encode(_source(40, 24), quality=80, progressive=True)
    segs = _segments(data)
    at = [i for i, (code, seg) in enumerate(segs)
          if code == 0xDA and make_image_formats.scan_params(seg)[3]][0]
    seg = bytearray(segs[at][1])
    k = 7 + 2 * seg[4]  # the Ah, Al byte
    seg[k] = (seg[k] & 0xF0) | (seg[k] >> 4)  # Al = Ah
    bad = b"".join(bytes(seg) if i == at else s for i, (_c, s) in enumerate(segs))
    assert _pil_or_none(bad) is None
    with pytest.raises(ValueError, match="progressive scan parameters"):
        jpeg.decode_jpeg(bad)


@pytest.mark.parametrize("hv", [0x41, 0x42, 0x24, 0x43, 0x44])
def test_interleaved_scan_of_more_than_ten_blocks_is_refused(hv):
    data = _encode(_source(40, 24), quality=80, subsampling="4:2:0")
    at = data.index(b"\xff\xc0") + 11  # the first component's sampling factors
    bad = data[:at] + bytes([hv]) + data[at + 1:]
    blocks = (hv >> 4) * (hv & 15) + 2
    assert (_pil_or_none(bad) is None) == (blocks > 10)
    _same_or_both_refuse(bad)


@pytest.mark.parametrize("ids", [(2, 1, 3), (1, 3, 2), (3, 2, 1), (1, 1, 3), (1, 2, 2),
                                 (3, 2, 3)])
def test_scan_components_out_of_frame_order_or_twice_are_refused(ids):
    """get_sos takes a scan's components in frame order, each once (it
    skips frame components whose scan slot is filled)."""
    data = _encode(_source(40, 24), quality=80, subsampling="4:4:4")
    at = data.index(b"\xff\xda") + 5
    bad = bytearray(data)
    for k, cid in enumerate(ids):
        bad[at + 2 * k] = cid
    assert _pil_or_none(bytes(bad)) is None
    with pytest.raises(ValueError, match="frame order"):
        jpeg.decode_jpeg(bytes(bad))


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_entropy_data_decodes_as_libjpeg(seed):
    """A bad Huffman code decodes as 0 after 17 bits, a marker in the data
    feeds zero bits and leaves the rest of the restart interval empty: PIL
    returns such an image, and so does the port."""
    rng = np.random.default_rng(seed)
    for name in ("baseline_420_q90.jpg", "restart_444.jpg", "small_progressive_rst.jpg"):
        data = bytearray(_stored(name))
        start = data.index(b"\xff\xda") + 20
        for _ in range(3):
            at = int(rng.integers(start, len(data) - 2))
            data[at] ^= 1 << int(rng.integers(8))
        _same_or_both_refuse(bytes(data), plain=name.startswith("small"))


# --- against the JAX package: load_image, the sidecar and the frames -------------


@pytest.fixture
def jpeg_copies(tmp_path):
    """The stored baseline JPEG copied twice (each package writes its own
    sidecar beside its file)."""
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(JPEG_FIXTURE)))
        shutil.copyfile(JPEG_FIXTURE, paths[-1])
    return paths


def test_load_image_gives_figdraw_tpus_image_mips_and_sidecar(jpeg_copies):
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    port_path, jax_path = jpeg_copies
    jax_flippy()
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    ref, jref = resources.load_image(port_path, bus=bus), jres.load_image(jax_path, bus=jbus)
    a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
    b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
    np.testing.assert_array_equal(a.image, np.asarray(b.image))
    assert a.image.shape == (600, 800, 4) and len(a.mips) == len(b.mips) == 10
    for x, y in zip(a.mips, b.mips):
        np.testing.assert_array_equal(x, np.asarray(y))
    with open(port_path + ".flippy", "rb") as fh, open(jax_path + ".flippy", "rb") as jfh:
        sidecar = fh.read()
        assert sidecar == jfh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:  # the digest chip_smoke.py holds the card to
        want = json.load(fh)["sidecar"][os.path.basename(JPEG_FIXTURE)]
    assert hashlib.sha256(sidecar).hexdigest() == want
    ref.close()
    jref.close()


def test_image_file_scene_from_jpeg_matches_jax(jpeg_copies):
    """The image-file scene with the JPEG loaded: the port's render_frame on
    the CPU within 1/255 of figdraw_tpu's frame, which the stored block
    means hold (chip_smoke.py holds the card to them)."""
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_image_file_frame

    from figdraw_tpu_torch.scenes import JPEG_FILE_REFERENCE, render_image_file

    port_path, jax_path = jpeg_copies
    want = jax_image_file_frame(jax_path, "1x")
    _ren, frame, ref = render_image_file(
        lambda ps: port.FigRenderer(atlas_size=512, device="cpu", pixel_scale=ps),
        port_path, "1x")
    got = frame.numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(JPEG_FILE_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1.0 / 255.0
    ref.close()


def test_photo_wall_from_jpeg_matches_jax(jpeg_copies):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import (
        JPEG_WALL_REFERENCE, PHOTO_WALL_SMALL, make_loaded_photo_wall,
    )

    port_path, jax_path = jpeg_copies
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_path, w, h, n)
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(port_path, bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(JPEG_WALL_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1.0 / 255.0
    ref.close()
