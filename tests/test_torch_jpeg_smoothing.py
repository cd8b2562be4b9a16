"""The block smoothing libjpeg-turbo 3.1.3 applies to a progressive JPEG whose
scans leave coefficients unrefined (jdcoefct.c smoothing_ok and
decompress_smooth_data, which PIL 12.1.0 leaves on), in the port
(utils/jpeg.py: smoothing_latch, smooth_geometry, smooth_plain; its C++
csrc/image_decode.cpp: fd_jpeg_smooth), against PIL's
`Image.open(...).convert("RGBA")`, which figdraw_tpu decodes through.

Incomplete files are built by dropping scans from progressive files PIL
writes (Huffman) and libjpeg-turbo writes through
tools/jpeg_arith_lossless_writer.c (arithmetic): the last AC refinement,
the chroma AC scans, the DC refinement, every scan that refines to Al 0,
and a final scan cut short by the EOI (its later iMCU rows read the latch
from before it). Each decodes equal to PIL byte for byte through the C++
helper and through the plain twins; fd_jpeg_smooth equals smooth_plain;
a complete file is never smoothed; the cases of
tools/jpeg_fuzz_agreement.py that smoothing decides are pinned; the stored
incomplete fixture through load_image, the image-file scene and the photo
wall against figdraw_tpu's."""

import io
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import IMAGE_FIXTURE, IMAGE_FORMATS_DIR, INCOMPLETE_FIXTURE
from figdraw_tpu_torch.utils import imagefile, jpeg
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import jpeg_fuzz_agreement  # noqa: E402
import make_image_formats  # noqa: E402
from make_image_formats import drop_scans, final_refinement, jpeg_segments  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    return make_image_formats.arith_lossless_writer(str(tmp_path_factory.mktemp("writer")))


def _pil(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception:  # noqa: BLE001 - any PIL failure is a refusal
        return None


def _same_as_pil(data: bytes, plain: bool = True) -> np.ndarray:
    want = _pil(data)
    assert want is not None
    got = imagefile.decode_image(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if plain:
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, plain=True), want)
    return got


def _crop(w: int, h: int, seed: int, channels: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGB"))
    y, x = int(rng.integers(150, 600 - h)), int(rng.integers(150, 800 - w))
    img = base[y: y + h, x: x + w]
    return img[..., 1] if channels == 1 else img


def _huffman(img: np.ndarray, subsampling: str, quality: int) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", progressive=True, quality=quality,
                              **({} if img.ndim == 2 else {"subsampling": subsampling}))
    return b.getvalue()


# which scans a case drops, and whether libjpeg then smooths the blocks
DROPS = {
    "last_ac_refinement": (lambda k, last, ids, ss, se, ah, al: k == last, True),
    "chroma_ac": (lambda k, last, ids, ss, se, ah, al: ss > 0 and ids[0] != 1, True),
    "dc_refinement": (lambda k, last, ids, ss, se, ah, al: ss == 0 and ah > 0, False),
    "final_refinements": (final_refinement, True),
}
SHAPES = [(37, 29, "4:2:0", 85), (48, 40, "4:4:4", 60), (17, 25, "4:2:2", 95), (9, 8, "4:2:0", 75)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}-{s[2]}")
@pytest.mark.parametrize("drop", list(DROPS))
def test_incomplete_huffman_progressive_equals_pil(drop, shape):
    w, h, sub, q = shape
    data = drop_scans(_huffman(_crop(w, h, w * h), sub, q), DROPS[drop][0])
    _same_as_pil(data)
    assert (jpeg.smoothing_latch(jpeg.read_frame(data)) is not None) == DROPS[drop][1]


@pytest.mark.parametrize("sampling", ["1x1,1x1,1x1", "2x2,1x1,1x1", "2x1,1x1,1x1"])
@pytest.mark.parametrize("drop", list(DROPS))
def test_incomplete_arithmetic_progressive_equals_pil(drop, sampling, writer):
    img = _crop(40, 27, len(sampling) + len(drop))
    data = make_image_formats.arith_lossless_jpeg(
        img, "arith", "progressive", "space=ycc", f"sampling={sampling}", writer=writer)
    data = drop_scans(data, DROPS[drop][0])
    _same_as_pil(data)
    assert (jpeg.smoothing_latch(jpeg.read_frame(data)) is not None) == DROPS[drop][1]


@pytest.mark.parametrize("coding", ["huffman", "arith"])
def test_grey_progressive_without_its_last_scan_equals_pil(coding, writer):
    img = _crop(45, 33, 5, channels=1)
    if coding == "huffman":
        data = _huffman(img, "", 80)
    else:
        data = make_image_formats.arith_lossless_jpeg(img, "arith", "progressive",
                                                      writer=writer)
    _same_as_pil(drop_scans(data, DROPS["last_ac_refinement"][0]))


@pytest.mark.parametrize("height", [17, 20, 24, 40, 41])
def test_edge_block_rows_follow_libjpeg(height):
    """A 4:2:0 luma of two iMCU rows whose last holds one block row counts
    its image_block_row with that row's own count (libjpeg then reads the
    row above for the row two above); heights 40 and 41 read a padding row
    below the last full iMCU row."""
    rng = np.random.default_rng(height)
    img = rng.integers(0, 256, (height, 40, 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(img).resize((40, height)))
    data = drop_scans(_huffman(img, "4:2:0", 50), DROPS["last_ac_refinement"][0])
    _same_as_pil(data)


@pytest.mark.parametrize("frac", [0.3, 0.7])
@pytest.mark.parametrize("which", [-1, -2, -5])
def test_final_scan_cut_short_reads_the_earlier_latch(which, frac):
    """A scan whose data the EOI cuts short leaves its later iMCU rows as
    the scans before it left them: those rows (past last_good_iMCU_row)
    smooth with the coef_bits from before the component's latest scan."""
    img = _crop(64, 56, 77)
    data = _huffman(img, "4:2:0", 80)
    segs = jpeg_segments(data)
    scans = [i for i, (code, _s) in enumerate(segs) if code == 0xDA]
    i = scans[which]
    seg = segs[i][1]
    head = 8 + 2 * seg[4]
    keep = head + int((len(seg) - head) * frac)
    cut = b"".join(s if k != i else s[:keep] for k, (_c, s) in enumerate(segs))
    _same_as_pil(cut)


def test_last_good_row_is_tracked_where_the_data_runs_out():
    img = _crop(64, 56, 77)
    data = _huffman(img, "4:2:0", 80)
    segs = jpeg_segments(data)
    last = [i for i, (code, _s) in enumerate(segs) if code == 0xDA][-1]
    seg = segs[last][1]
    cut = b"".join(s if k != last else s[: 10 + (len(seg) - 10) // 3]
                   for k, (_c, s) in enumerate(segs))
    frame, plain = jpeg.read_frame(cut), jpeg.read_frame(cut, plain=True)
    assert frame.last_good == plain.last_good < frame.mcuy - 1
    assert jpeg.read_frame(data).last_good == frame.mcuy - 1


def test_smooth_equals_smooth_plain():
    """fd_jpeg_smooth against smooth_plain on seeded coefficients, with
    both latches, DC interpolation (no AC scan reached) and not, each
    component geometry, and iMCU rows on both sides of last_good."""
    rng = np.random.default_rng(23)
    for case in range(12):
        c = jpeg.Component(1, 1 + case % 2, 1 + (case // 2) % 3, 0)
        c.place(int(rng.integers(1, 90)), int(rng.integers(1, 90)), 2, 3, 0, 0)
        mcuy = -(-c.nbh // c.v)
        coefs = rng.integers(-600, 600, (mcuy * c.v, c.nbw + 1, 64)).astype(np.int16)
        coefs[..., 1:][rng.random(coefs[..., 1:].shape) < 0.7] = 0
        qt = rng.integers(1, 200, 64).astype(np.uint16)
        bits = rng.integers(-1, 4, (2, 10)).astype(np.int32)
        if case % 3 == 0:
            bits[:, 1:] = -1
        rows, cols = jpeg.smooth_geometry(c, mcuy)
        last_good = int(rng.integers(-1, mcuy))
        np.testing.assert_array_equal(
            jpeg.smooth(coefs, qt, bits, rows, cols, c.v, last_good),
            jpeg.smooth_plain(coefs, qt, bits, rows, cols, c.v, last_good))


@pytest.mark.parametrize("name", ["progressive_422.jpg", "small_progressive_rst.jpg",
                                  "arith_progressive_rst.jpg",
                                  "arith_dac_progressive_420.jpg"])
def test_complete_progressive_files_are_never_smoothed(name):
    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        frame = jpeg.read_frame(fh.read())
    assert all((c.coef_bits == 0).all() for c in frame.components)
    assert jpeg.smoothing_latch(frame) is None


@pytest.mark.parametrize("name", ["progressive_incomplete_huff.jpg",
                                  "progressive_incomplete_arith.jpg"])
def test_stored_incomplete_files_are_smoothed_as_pil(name):
    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        data = fh.read()
    frame = jpeg.read_frame(data)
    latch = jpeg.smoothing_latch(frame)
    assert latch is not None
    _same_as_pil(data, plain=frame.width * frame.height <= 200 * 150)
    for c, bits in zip(frame.components, latch):
        rows, cols = jpeg.smooth_geometry(c, frame.mcuy)
        np.testing.assert_array_equal(
            jpeg.smooth(c.coefs, c.qt, bits, rows, cols, c.v, frame.mcuy),
            jpeg.smooth_plain(c.coefs, c.qt, bits, rows, cols, c.v, frame.mcuy))


# seed, index of tools/jpeg_fuzz_agreement.py's cases: arithmetic-coded
# progressive files whose corruption leaves coefficients unrefined
SMOOTHING_FUZZ_CASES = [(1, 1987), (2, 788), (3, 83), (3, 1075), (3, 1939), (4, 1140),
                        (4, 1267), (5, 69), (5, 787)]


@pytest.mark.parametrize("case", SMOOTHING_FUZZ_CASES, ids=[f"seed{s}-{i}" for s, i in
                                                           SMOOTHING_FUZZ_CASES])
def test_fuzz_cases_equal_pil(case):
    seed, index = case
    _name, data = jpeg_fuzz_agreement.case(seed, index)
    assert jpeg_fuzz_agreement.classify(data) == "equal"
    frame = jpeg.read_frame(data)
    assert jpeg.smoothing_latch(frame) is not None
    _same_as_pil(data, plain=frame.width * frame.height <= 64 * 48)


# --- against the JAX package: load_image, the image-file scene, the photo wall ----------


@pytest.fixture
def incomplete_copies(tmp_path):
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(INCOMPLETE_FIXTURE)))
        shutil.copyfile(INCOMPLETE_FIXTURE, paths[-1])
    return paths


def test_load_image_gives_figdraw_tpus_image_mips_and_sidecar(incomplete_copies):
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    port_path, jax_path = incomplete_copies
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
        assert fh.read() == jfh.read()
    ref.close()
    jref.close()


def test_image_file_scene_matches_jax(incomplete_copies):
    """The image-file scene from each package's load_image: the same atlas
    bytes, the frames within 1/255, and the stored block means
    chip_smoke.py holds the card to."""
    from torch_reference import block_means, image_file_scene_pair

    from figdraw_tpu_torch.scenes import INCOMPLETE_FILE_REFERENCE

    got, want, atlas, jatlas, refs = image_file_scene_pair(*incomplete_copies)
    assert atlas == jatlas
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(INCOMPLETE_FILE_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    for r in refs:
        r.close()


def test_photo_wall_matches_jax(incomplete_copies):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import (
        INCOMPLETE_WALL_REFERENCE, PHOTO_WALL_SMALL, make_loaded_photo_wall,
    )

    port_path, jax_path = incomplete_copies
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_path, w, h, n)
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(port_path, bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(INCOMPLETE_WALL_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1.0 / 255.0
    ref.close()
