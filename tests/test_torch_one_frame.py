"""FIGDRAW_TEST_ONE_FRAME on figdraw_tpu_torch (the twin of
tests/test_misc.py::test_one_frame_screenshot_env): the first frame a
renderer makes through render_frame or render_batch goes to the path as a
PNG, written with zlib and struct, and no later frame does. The PNG reads
back (with PIL, here only) as take_screenshot's bytes, and within one u8
level of the JAX package's PNG of the same scene."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import figdraw_tpu as jax_pkg
import figdraw_tpu_torch as port
from figdraw_tpu import config as jax_config
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu_torch import config as port_config
from figdraw_tpu_torch.renderer import write_png

torch.set_num_threads(1)

SIZE = (64, 48)


def _scene(pk, blue=255):
    renders = pk.new_renders()
    renders.add_root(0, pk.Fig(kind=pk.FigKind.nkRectangle, screen_box=pk.rect(0, 0, 64, 48),
                               fill=pk.fill(pk.rgba(0, 128, blue, 255))))
    renders.add_root(0, pk.Fig(kind=pk.FigKind.nkRectangle,
                               screen_box=pk.rect(8, 6, 20, 14),
                               fill=pk.fill(pk.rgba(250, 40, 10, 200)), corners=(5, 5, 5, 5)))
    return renders


def test_the_switch_reads_like_the_reference(monkeypatch, tmp_path):
    for value in (None, "", str(tmp_path / "x.png")):
        if value is None:
            monkeypatch.delenv("FIGDRAW_TEST_ONE_FRAME", raising=False)
        else:
            monkeypatch.setenv("FIGDRAW_TEST_ONE_FRAME", value)
        assert port_config.test_one_frame_path() == jax_config.test_one_frame_path()


def test_one_frame_screenshot_env(monkeypatch, tmp_path):
    out = str(tmp_path / "one_frame.png")
    monkeypatch.setenv("FIGDRAW_TEST_ONE_FRAME", out)
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    frame = ren.render_frame(_scene(port), port.vec2(*SIZE))
    img = np.asarray(Image.open(out))
    assert img.shape == (48, 64, 4) and img.dtype == np.uint8
    assert img[24, 32, 2] > 200  # the blue fill made it to disk
    np.testing.assert_array_equal(img, ren.take_screenshot(frame))
    # only the first frame writes
    os.remove(out)
    ren.render_frame(_scene(port, blue=0), port.vec2(*SIZE))
    ren.render_batch([_scene(port)], port.vec2(*SIZE))
    assert not os.path.exists(out)
    # the JAX package's PNG of the same scene
    jax_out = str(tmp_path / "jax_frame.png")
    monkeypatch.setenv("FIGDRAW_TEST_ONE_FRAME", jax_out)
    JaxRenderer(atlas_size=64, use_pallas=False).render_frame(_scene(jax_pkg),
                                                              jax_pkg.vec2(*SIZE))
    ref = np.asarray(Image.open(jax_out)).astype(int)
    assert ref.shape == img.shape
    assert np.abs(img.astype(int) - ref).max() <= 1


def test_render_batch_writes_its_last_frame_once(monkeypatch, tmp_path):
    out = str(tmp_path / "batch.png")
    monkeypatch.setenv("FIGDRAW_TEST_ONE_FRAME", out)
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    frames = ren.render_batch([_scene(port, blue=0), _scene(port)], port.vec2(*SIZE))
    img = np.asarray(Image.open(out))
    np.testing.assert_array_equal(img, ren.take_screenshot(frames[-1]))
    os.remove(out)
    ren.render_batch([_scene(port, blue=0)], port.vec2(*SIZE))
    ren.render_frame(_scene(port), port.vec2(*SIZE))
    assert not os.path.exists(out)


def test_no_path_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.delenv("FIGDRAW_TEST_ONE_FRAME", raising=False)
    monkeypatch.chdir(tmp_path)
    port.FigRenderer(atlas_size=64, device="cpu").render_frame(_scene(port),
                                                               port.vec2(*SIZE))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (48, 64), (5, 300)])
def test_write_png_reads_back_byte_for_byte(shape, tmp_path):
    rgba = np.random.default_rng(shape[1]).integers(0, 256, (*shape, 4), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    write_png(path, rgba)
    with Image.open(path) as im:
        assert im.mode == "RGBA" and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), rgba)


def test_write_png_refuses_what_is_not_rgba(tmp_path):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.uint8))
