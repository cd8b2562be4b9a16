"""The stored references of the example scenes chip_smoke.py holds the
port's tree frames to on the card (the card's machine has no jax):
`figdraw_tpu_torch/reference/example_<scene>_<form>_blocks8.npy`, the 8x8
block means of figdraw_tpu's frames of examples/layers_clip.py,
drawable_beziers.py, dashed_dotted_borders.py and msdf_star.py and of the
MTSDF scene at their own sizes, at pixel_scale=2 and at UI scale 2
(scenes.EXAMPLE_FORMS), written by tests/torch_reference.py.

Each stored array must be figdraw_tpu's frame today (it fails when they
drift: rewrite them with `JAX_PLATFORMS=cpu python tests/torch_reference.py
examples`), and the port's tree frame on the CPU must match it within
1/255, as chip_smoke.py requires of the card's.

Against the full JAX frame the port is held to 1/255 a pixel too, but for
the pixels `ops.raster.ambiguous_pixels` finds on a quad's uv clip edge or
a bezier stroke's evolute: there a fused multiply-add (XLA's) and ATen's
separate multiply and add decide a whole pixel's coverage apart, and
figdraw_tpu's own two paths (Pallas and XLA) differ by up to 0.18 at such
pixels of drawable_beziers. Every pixel past 1/255 must be one of them,
and they must be rare in the frame.
"""

import functools

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
from figdraw_tpu_torch.ops.raster import ambiguous_pixels
from figdraw_tpu_torch.scenes import (
    EXAMPLE_FORMS, EXAMPLE_SCENES, example_reference_path, render_example,
)
from torch_reference import block_means, jax_example_frame

torch.set_num_threads(1)

TOL = 1.0 / 255.0

CASES = [(name, form) for name in EXAMPLE_SCENES for form in EXAMPLE_FORMS]


@functools.lru_cache(maxsize=None)
def _jax_frame(name, form):
    return jax_example_frame(name, form)


@pytest.mark.parametrize("name,form", CASES, ids=[f"{n}-{f}" for n, f in CASES])
def test_stored_example_blocks_are_fresh(name, form):
    stored = np.load(example_reference_path(name, form))
    frame = _jax_frame(name, form)
    _make, (w, h) = EXAMPLE_SCENES[name]
    mult = 2 if form != "1x" else 1
    assert frame.shape == (h * mult, w * mult, 4)
    np.testing.assert_allclose(stored, block_means(frame), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(EXAMPLE_SCENES))
def test_port_example_frame_matches_jax(name):
    """The port's tree (made by its own scenes.py function) through the Python walk on
    the CPU: block means within 1/255 of the stored ones, pixels within
    1/255 of figdraw_tpu's frame but for ambiguous ones (module
    docstring), which are under 2% of a random sample of the frame."""
    ren, frame = render_example(
        lambda ps: port.FigRenderer(device="cpu", pixel_scale=ps), name, "1x")
    got = frame.numpy()
    err_blocks = float(np.abs(block_means(got)
                              - np.load(example_reference_path(name, "1x"))).max())
    assert err_blocks <= TOL, err_blocks
    make, (w, h) = EXAMPLE_SCENES[name]
    tape = ren.flatten(make(w, h), port.vec2(w, h))
    fields, modes = tape.fields[: tape.count], tape.modes[: tape.count]
    ys, xs = np.nonzero(np.abs(got - _jax_frame(name, "1x")).max(-1) > TOL)
    assert ambiguous_pixels(fields, modes, ys, xs).all(), list(zip(ys, xs))
    rng = np.random.RandomState(5)
    sample = ambiguous_pixels(fields, modes, rng.randint(0, h, 2000),
                              rng.randint(0, w, 2000))
    assert sample.mean() < 0.02, sample.mean()
