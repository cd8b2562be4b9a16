"""render_frame_with_overlays of figdraw_tpu_torch against figdraw_tpu's
(use_pallas=False) on the CPU: examples/overlay_3d.py's scene and numpy
pyramid (the port's copies in scenes.py, equal to the example's), its six
frames within 1/255 of figdraw_tpu's and of the stored block means
chip_smoke.py holds the card to, the grouping of layers at several
boundaries, a frame that starts at an overlay boundary, the shape check,
and the camera overlay composite (test_camera.py:275's scene with the view
composited as an overlay under the HUD): bit-equal to one walk of the
combined scene, as render_view + render_frame(clear_main=False) is."""

import os
import sys

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
import test_camera as jcam
from figdraw_tpu import vec2 as jax_vec2
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu_torch.renderer import blend_overlay
from figdraw_tpu_torch.scenes import (
    OVERLAY_FRAMES, OVERLAY_REFERENCE, OVERLAY_SIZE, make_overlay_scene,
    overlay_time, rasterize_pyramid,
)
from torch_reference import REPO, block_means, jax_overlay_frames, to_port

torch.set_num_threads(1)  # see tests/test_torch_render_frame.py

TOL = 1.0 / 255.0
W, H = OVERLAY_SIZE


@pytest.fixture(scope="module")
def example():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import overlay_3d
    finally:
        sys.path.remove(os.path.join(REPO, "examples"))
    return overlay_3d


@pytest.fixture(scope="module")
def jax_frames():
    return jax_overlay_frames(OVERLAY_FRAMES)


def test_pyramid_copy_equals_the_example(example):
    assert (example.W, example.H) == OVERLAY_SIZE
    for i in range(OVERLAY_FRAMES):
        np.testing.assert_array_equal(rasterize_pyramid(W, H, overlay_time(i)),
                                      example.rasterize_pyramid(W, H, t=0.35 + i * 0.5))


def test_overlay_scene_equals_the_example(example):
    from figdraw_tpu.nodesarray import from_renders as jax_from_renders
    from figdraw_tpu_torch.nodesarray import from_renders

    a = jax_from_renders(example.make_scene(W, H))
    b = from_renders(make_overlay_scene(W, H))
    assert [lvl for lvl, _ in a.sorted_pairs()] == [lvl for lvl, _ in b.sorted_pairs()]
    for (_, la), (_, lb) in zip(a.sorted_pairs(), b.sorted_pairs()):
        assert la.nodes[: la.count].tobytes() == lb.nodes[: lb.count].tobytes()


def test_overlay_frames_match_reference(jax_frames):
    ren = port.FigRenderer(atlas_size=128, device="cpu")
    scene = make_overlay_scene(W, H)
    stored = np.load(OVERLAY_REFERENCE)
    for i in range(OVERLAY_FRAMES):
        out = ren.render_frame_with_overlays(
            scene, port.vec2(W, H), {0: rasterize_pyramid(W, H, overlay_time(i))})
        assert tuple(out.shape) == (H, W, 4) and ren.last_frame is out
        assert np.abs(out.numpy() - jax_frames[i]).max() <= TOL, f"frame {i}"
        assert np.abs(block_means(out.numpy()) - stored[i]).max() <= TOL


def test_stored_overlay_blocks_are_fresh(jax_frames):
    """chip_smoke.py's overlay phase holds the card to these block means of
    figdraw_tpu's frames (tests/torch_reference.py frameloop writes them)."""
    stored = np.load(OVERLAY_REFERENCE)
    assert stored.shape == (OVERLAY_FRAMES, H // 8, W // 8, 4)
    np.testing.assert_allclose(stored, np.stack([block_means(f) for f in jax_frames]),
                               rtol=0, atol=1e-6)


def test_blend_overlay_matches_jax():
    from figdraw_tpu.renderer import _blend_overlay

    rng = np.random.RandomState(5)
    frame, over = (rng.rand(17, 23, 4).astype(np.float32) for _ in range(2))
    want = np.asarray(_blend_overlay(frame, over))
    got = blend_overlay(torch.from_numpy(frame), torch.from_numpy(over)).numpy()
    assert np.abs(got - want).max() <= 1e-6


def _layered(api):
    """Four layers (-2, 0, 3, 7), a translucent box each, in either
    package's Fig API."""
    r = api.new_renders()
    for k, lvl in enumerate((-2, 0, 3, 7)):
        r.add_root(lvl, api.Fig(kind=api.FigKind.nkRectangle,
                                screen_box=api.rect(10 + 20 * k, 8 + 12 * k, 60, 40),
                                corners=(6,) * 4,
                                fill=api.fill(api.rgba(40 + 50 * k, 200 - 40 * k, 90, 170))))
    return r


@pytest.mark.parametrize("bounds", [(0, 5), (-5,), (3, 100), (-10, 0, 8)])
def test_overlays_at_several_boundaries_match_jax(bounds):
    """Layers grouped at each boundary; a frame with nothing below its
    first boundary starts from the clear color; an overlay above every
    layer composites last."""
    import figdraw_tpu as japi

    rng = np.random.RandomState(len(bounds))
    overlays = {b: rng.rand(96, 160, 4).astype(np.float32) for b in bounds}
    ref = np.asarray(JaxRenderer(atlas_size=64, use_pallas=False)
                     .render_frame_with_overlays(_layered(japi), jax_vec2(160, 96),
                                                 overlays))
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    got = ren.render_frame_with_overlays(_layered(port), port.vec2(160, 96), overlays)
    assert np.abs(got.numpy() - ref).max() <= TOL
    # arrays group the same way as trees
    from figdraw_tpu_torch.nodesarray import from_renders

    arr = port.FigRenderer(atlas_size=64, device="cpu").render_frame_with_overlays(
        from_renders(_layered(port)), port.vec2(160, 96), overlays)
    assert np.abs(arr.numpy() - ref).max() <= TOL


def test_no_overlays_is_render_frame_and_a_wrong_shape_raises():
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    scene = _layered(port)
    plain = port.FigRenderer(atlas_size=64, device="cpu").render_frame(
        scene, port.vec2(160, 96))
    assert torch.equal(ren.render_frame_with_overlays(scene, port.vec2(160, 96), {}),
                       plain)
    with pytest.raises(ValueError, match="must match the frame"):
        ren.render_frame_with_overlays(scene, port.vec2(160, 96),
                                       {0: np.zeros((96, 161, 4), np.float32)})


def test_camera_overlay_composite():
    """test_camera.py:275's scene: a device-resident view composited as an
    overlay under the HUD layer equals one walk of the combined scene bit
    for bit (the view is opaque, so source-over gives it exactly), and the
    JAX package's frame within 1/255."""
    from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba
    from figdraw_tpu.nodesarray import from_renders

    size = port.vec2(352, 288)
    d, z = (9, -7), 2

    def hud_scene():
        r = new_renders()
        for n in jcam._hud_nodes():
            r.add_root(1, n)
        return from_renders(r)

    def combined():
        r = new_renders()
        tr = jcam._view_root(r, d, z)
        for i in range(24):
            r.add_child(0, tr, Fig(
                kind=FigKind.nkRectangle,
                screen_box=rect(6 + (i % 6) * 22, 8 + (i // 6) * 26, 30, 22),
                corners=(5,) * 4,
                fill=fill(rgba(50 + i * 8, (i * 37) % 255, 190, 150))))
        for n in jcam._hud_nodes():
            r.add_root(1, n)
        return from_renders(r)

    cam = port.FigRenderer(atlas_size=64, device="cpu")
    scene = cam.snapshot_scene(to_port(jcam.boxes_scene_view()), size)
    view = cam.render_view(scene, d, zoom=z)
    got = cam.render_frame_with_overlays(to_port(hud_scene()), size, {1: view})
    want = port.FigRenderer(atlas_size=64, device="cpu").render_frame(
        to_port(combined()), size)
    assert torch.equal(got, want)
    jr = JaxRenderer(atlas_size=64, use_pallas=False)
    jscene = jr.snapshot_scene(jcam.boxes_scene_view(), jax_vec2(352, 288))
    jview = np.asarray(jr.render_view(jscene, d, zoom=z))
    ref = np.asarray(jr.render_frame_with_overlays(hud_scene(), jax_vec2(352, 288),
                                                   {1: jview}))
    assert np.abs(got.numpy() - ref).max() <= TOL
