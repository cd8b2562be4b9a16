"""The port's .flippy container, Snappy codec, alpha bleed and sidecar
cache (figdraw_tpu_torch/utils/flippy.py): the ten tests of
tests/test_flippy.py run on the port, then the two packages against each
other on the same images (sidecars equal byte for byte, each reading the
other's), the C codec against the plain Python decoder, and the rule
that no load path reaches that decoder or survives a missing toolchain."""

import ast
import hashlib
import inspect
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
from PIL import Image

from figdraw_tpu.utils import flippy as jfl
from figdraw_tpu_torch.scenes import IMAGE_FIXTURE, IMAGE_FIXTURE_REFERENCE
from figdraw_tpu_torch.utils import flippy as fl
from figdraw_tpu_torch.utils import gxx
from torch_reference import jax_flippy


@pytest.fixture(autouse=True, scope="module")
def _jax_snappy_loaded():
    """figdraw_tpu's codec loaded before its first use here (a worker
    building it concurrently would make it fall back to literal-only
    streams)."""
    jax_flippy()


# --- tests/test_flippy.py, on the port ------------------------------------------


def test_snappy_roundtrip():
    rng = np.random.default_rng(7)
    cases = [
        b"",
        b"x",
        b"hello world " * 500,
        rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),
        b"\x00" * 70_000 + b"abc" * 30_000,  # crosses the 64K fragment
    ]
    for data in cases:
        c = fl.snappy_compress(data)
        assert fl.snappy_uncompress(c) == data
        # the plain Python decoder reads the native encoder's output
        assert fl._py_uncompress(c) == data


def test_snappy_compresses():
    data = b"abcd" * 4096
    assert len(fl.snappy_compress(data)) < len(data) // 4


def test_snappy_rejects_garbage():
    with pytest.raises(ValueError):
        fl.snappy_uncompress(b"\xff\xff\xff\xff\xff\xff")


def test_flippy_file_roundtrip():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (64, 48, 4), dtype=np.uint8)
    f = fl.image_to_flippy(img, bleed=False)
    assert f.mipmaps[0].shape == (64, 48, 4)
    assert min(f.mipmaps[-1].shape[:2]) == 1
    assert f.width == 48 and f.height == 64
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "t.flippy")
        fl.save_flippy(f, p)
        g = fl.load_flippy(p)
    assert len(g.mipmaps) == len(f.mipmaps)
    for a, b in zip(f.mipmaps, g.mipmaps):
        assert np.array_equal(a, b)


def test_flippy_rejects_bad_header():
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "bad.flippy")
        with open(p, "wb") as fh:
            fh.write(b"nope" + b"\x00" * 16)
        with pytest.raises(IOError):
            fl.load_flippy(p)


def test_alpha_bleed():
    img = np.zeros((16, 16, 4), np.uint8)
    img[4:12, 4:12] = (200, 10, 10, 255)
    out = fl.alpha_bleed(img)
    assert out[0, 0, 3] == 0
    assert out[0, 0, 0] > 0  # red bled into the corner
    assert np.array_equal(out[5, 5], (200, 10, 10, 255))
    solid = np.full((8, 8, 4), 77, np.uint8)
    assert np.array_equal(fl.alpha_bleed(solid), solid)


def test_disk_cache_regenerates_on_mtime():
    img = np.zeros((16, 16, 4), np.uint8)
    img[4:12, 4:12] = (0, 255, 0, 255)
    with tempfile.TemporaryDirectory() as td:
        png = os.path.join(td, "x.png")
        Image.fromarray(img).save(png)
        fl.read_image_cached(png)
        sidecar = png + ".flippy"
        assert os.path.exists(sidecar)
        t1 = os.path.getmtime(sidecar)
        fl.read_image_cached(png)  # fresh sidecar: no rewrite
        assert os.path.getmtime(sidecar) == t1
        os.utime(png, (os.path.getmtime(png) + 5,) * 2)
        fl.read_image_cached(png)  # stale sidecar: regenerated
        assert os.path.getmtime(sidecar) > t1


def test_load_image_publishes_flippy_mips():
    from figdraw_tpu_torch import FigRenderer
    from figdraw_tpu_torch.resources import ImageMessageBus, load_image

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (32, 32, 4), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as td:
        png = os.path.join(td, "y.png")
        Image.fromarray(img).save(png)
        bus = ImageMessageBus()
        ref = load_image(png, bus=bus)
        assert os.path.exists(png + ".flippy")
        ren = FigRenderer(atlas_size=256, device="cpu")
        ren.ensure_image_message_subscription(bus)
        ren.process_image_messages()
        assert ref.id in ren.atlas.entries
        # the level-1 mip (16x16) came from the sidecar's chain
        assert (ref.id, 1) in ren.atlas.entries
        stored = fl.load_flippy(png + ".flippy")
        expect = ren.atlas._normalize(stored.mipmaps[1])
        got = ren.atlas._images[(ref.id, 1)]
        assert np.array_equal(np.asarray(got), np.asarray(expect))
        ref.close()


def test_reads_reference_flippy_files(monkeypatch):
    """tests/test_flippy.py's own test with the port's module in place of
    figdraw_tpu's: the Snappy decoder reads the reference's
    supersnappy-compressed assets where they are mounted, and skips as that
    test does where they are not."""
    import test_flippy

    monkeypatch.setattr(test_flippy, "fl", fl)
    test_flippy.test_reads_reference_flippy_files()


def test_mip_chain_shape_ladder_matches_pixie():
    img = np.zeros((100, 100, 4), np.uint8)
    img[..., 3] = 255
    f = fl.image_to_flippy(img, bleed=False)
    assert [m.shape[0] for m in f.mipmaps] == [100, 50, 25, 13, 7, 4, 2, 1]


# --- the two packages on the same images ------------------------------------------


def _fixture_copy(td: str, name: str = "fixture.png") -> str:
    path = os.path.join(td, name)
    shutil.copyfile(IMAGE_FIXTURE, path)
    return path


def test_fixture_sidecars_equal_byte_for_byte(tmp_path):
    port_png = _fixture_copy(str(tmp_path), "port.png")
    jax_png = _fixture_copy(str(tmp_path), "jax.png")
    a = fl.read_image_cached(port_png)
    b = jfl.read_image_cached(jax_png)
    with open(port_png + ".flippy", "rb") as fh:
        port_bytes = fh.read()
    with open(jax_png + ".flippy", "rb") as fh:
        jax_bytes = fh.read()
    assert port_bytes == jax_bytes
    with open(IMAGE_FIXTURE_REFERENCE) as fh:
        stored = json.load(fh)
    assert hashlib.sha256(port_bytes).hexdigest() == stored["sidecar_sha256"]
    assert len(a.mipmaps) == len(b.mipmaps) == 11
    for x, y in zip(a.mipmaps, b.mipmaps):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", range(4))
def test_random_images_give_equal_chains_and_sidecars(seed, tmp_path):
    """Random sizes (odd edges included) and alpha with holes: the bleed,
    the chain and the saved bytes equal figdraw_tpu's."""
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 70, 2))
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[..., 3] = np.where(rng.random((h, w)) < 0.3, 0, img[..., 3])
    np.testing.assert_array_equal(fl.alpha_bleed(img), jfl.alpha_bleed(img))
    a, b = fl.image_to_flippy(img), jfl.image_to_flippy(img)
    assert len(a.mipmaps) == len(b.mipmaps)
    for x, y in zip(a.mipmaps, b.mipmaps):
        np.testing.assert_array_equal(x, y)
    fl.save_flippy(a, str(tmp_path / "a.flippy"))
    jfl.save_flippy(b, str(tmp_path / "b.flippy"))
    assert (tmp_path / "a.flippy").read_bytes() == (tmp_path / "b.flippy").read_bytes()


def test_each_package_reads_the_others_sidecar(tmp_path):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    fl.save_flippy(fl.image_to_flippy(img), str(tmp_path / "port.flippy"))
    jfl.save_flippy(jfl.image_to_flippy(img), str(tmp_path / "jax.flippy"))
    for mine, theirs in ((fl.load_flippy(str(tmp_path / "jax.flippy")),
                          jfl.load_flippy(str(tmp_path / "jax.flippy"))),
                         (jfl.load_flippy(str(tmp_path / "port.flippy")),
                          fl.load_flippy(str(tmp_path / "port.flippy")))):
        assert len(mine.mipmaps) == len(theirs.mipmaps)
        for x, y in zip(mine.mipmaps, theirs.mipmaps):
            np.testing.assert_array_equal(x, y)


def test_the_c_codec_against_the_plain_decoder():
    """snappy_uncompress (C) and _py_uncompress (Python) on the fixture's
    raw bytes and on streams figdraw_tpu's encoder wrote."""
    from figdraw_tpu_torch.utils.png import read_image

    raw = read_image(IMAGE_FIXTURE).tobytes()
    for stream in (fl.snappy_compress(raw), jfl.snappy_compress(raw[:50_000])):
        assert fl.snappy_uncompress(stream) == fl._py_uncompress(stream)
    assert fl.snappy_uncompress(fl.snappy_compress(raw)) == raw
    assert fl.snappy_compress(raw) == jfl.snappy_compress(raw)


def test_no_load_path_reaches_the_plain_decoder():
    """_py_uncompress is the tests' reference only: no function of the
    module but itself names it."""
    tree = ast.parse(inspect.getsource(fl))
    callers = {fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
               for node in ast.walk(fn)
               if isinstance(node, ast.Name) and node.id == "_py_uncompress"}
    assert callers == set()


def test_a_stale_or_corrupt_sidecar_is_regenerated(tmp_path):
    png = _fixture_copy(str(tmp_path))
    fl.read_image_cached(png)
    with open(png + ".flippy", "r+b") as fh:
        fh.seek(40)
        fh.write(b"\xff" * 64)  # a mip's Snappy stream now fails
    os.utime(png + ".flippy", (os.path.getmtime(png) + 5,) * 2)
    f = fl.read_image_cached(png)
    np.testing.assert_array_equal(f.mipmaps[0], np.asarray(
        Image.open(IMAGE_FIXTURE).convert("RGBA")))
    with open(png + ".flippy", "rb") as fh:
        rewritten = fh.read()
    with open(IMAGE_FIXTURE_REFERENCE) as fh:
        assert hashlib.sha256(rewritten).hexdigest() == json.load(fh)["sidecar_sha256"]


def test_an_unwritable_directory_gives_the_chain_in_memory(tmp_path, monkeypatch):
    png = _fixture_copy(str(tmp_path))

    def refuse(flippy, path):
        raise PermissionError(f"read-only: {path}")

    monkeypatch.setattr(fl, "save_flippy", refuse)
    f = fl.read_image_cached(png)
    assert not os.path.exists(png + ".flippy")
    assert len(f.mipmaps) == 11


def test_a_missing_toolchain_raises(tmp_path, monkeypatch):
    """No g++: the codec's build raises, and read_image_cached (the load
    path of load_image) with it; nothing falls back to literal-only
    streams or to the Python decoder."""
    from figdraw_tpu_torch.resources import load_image

    png = _fixture_copy(str(tmp_path))
    monkeypatch.setattr(gxx, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(fl, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(FileNotFoundError):
        fl.read_image_cached(png)
    with pytest.raises(FileNotFoundError):
        load_image(png)
    with pytest.raises(FileNotFoundError):
        fl.snappy_compress(b"abc")
    assert not os.path.exists(png + ".flippy")
