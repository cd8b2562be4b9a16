"""The image surface of figdraw_tpu_torch's FigRenderer (update_image,
remove_image, contains_image, rebuild_image_atlas, atlas_usage,
publish_atlas_usage, atlas_usage_snapshot) and its render-thread guard,
against figdraw_tpu on the CPU: the twins of tests/test_images.py:161,
:253, :269, :365 and :430, each run through both packages with the same
messages, so atlas entries, pixels, usage and frames compare (frames
within 1/255, atlas data exactly). The device atlas follows each change:
whole after a rebuild, by its dirty rectangles after an update in
place."""

import threading

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu.resources import (
    ImageMessageBus as JaxBus, clear_images as jax_clear_images,
    put_image as jax_put_image, replace_image as jax_replace_image,
)
from figdraw_tpu_torch.renderer import atlas_usage_snapshot
from figdraw_tpu_torch.resources import (
    ImageMessageBus, clear_images, put_image, replace_image,
)
from test_images import checker_image, render_image_node

torch.set_num_threads(1)  # see tests/test_torch_render_frame.py


def _pair(atlas_size=64):
    """(figdraw_tpu renderer, port renderer), each on a bus of its own."""
    jr = JaxRenderer(atlas_size=atlas_size, use_pallas=False)
    jb = JaxBus()
    jr.ensure_image_message_subscription(jb)
    pr = port.FigRenderer(atlas_size=atlas_size, device="cpu")
    pb = ImageMessageBus()
    pr.ensure_image_message_subscription(pb)
    return jr, jb, pr, pb


def _port_image_node(ren, image_id, w=64, h=64):
    """render_image_node's scene through the port: a 32x32 image at (8, 8)."""
    r = port.new_renders()
    r.add_root(0, port.Fig(kind=port.FigKind.nkImage, screen_box=port.rect(8, 8, 32, 32),
                           image=port.image_style(image_id)))
    ren.render_frame(r, port.vec2(w, h))
    return ren.take_screenshot()


def _same_atlas(jr, pr):
    assert jr.atlas.entries == pr.atlas.entries
    np.testing.assert_array_equal(jr.atlas.data, pr.atlas.data)


def test_replace_image_updates_pixels():
    jr, jb, pr, pb = _pair()
    jax_put_image(77, checker_image(), bus=jb)
    put_image(77, checker_image(), bus=pb)
    a = render_image_node(jr, 77)
    b = _port_image_node(pr, 77)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    solid = np.zeros((8, 8, 4), np.uint8)
    solid[:] = (10, 200, 30, 255)
    jax_replace_image(77, solid, bus=jb)
    replace_image(77, solid, bus=pb)
    a = render_image_node(jr, 77)
    b = _port_image_node(pr, 77)
    assert b[20, 20, 1] > 150 and b[20, 20, 0] < 60
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    _same_atlas(jr, pr)


def test_atlas_usage_snapshot():
    jr, jb, pr, pb = _pair()
    jax_put_image(7, checker_image(), bus=jb)
    put_image(7, checker_image(), bus=pb)
    render_image_node(jr, 7)
    _port_image_node(pr, 7)
    usage = pr.atlas_usage()
    assert usage.image_count >= 1
    assert usage.entry_count >= 2  # white + image
    assert 0.0 < usage.used_ratio <= 1.0
    want = jr.atlas_usage()
    for field in ("generation", "rebuild_count", "atlas_size", "atlas_area",
                  "used_area", "packed_area", "entry_count", "image_count",
                  "glyph_count", "generated_count", "unknown_count"):
        assert getattr(usage, field) == getattr(want, field), field
    assert usage.packed_ratio == want.packed_ratio
    snap = atlas_usage_snapshot()
    assert snap.snapshot_id > 0 and snap.entry_count == usage.entry_count
    pr.publish_atlas_usage()
    assert atlas_usage_snapshot().snapshot_id == snap.snapshot_id + 1


def test_atlas_grow_and_replay():
    jr, jb, pr, pb = _pair(atlas_size=32)
    for i in range(6):
        jax_put_image(100 + i, checker_image(16, 16), bus=jb)
        put_image(100 + i, checker_image(16, 16), bus=pb)
    jr.process_image_messages()
    pr.process_image_messages()
    assert pr.atlas.size > 32
    for i in range(6):
        assert pr.contains_image(100 + i)
    _same_atlas(jr, pr)
    # a rebuild replays the bus into a fresh atlas of at least the size asked
    jr.rebuild_image_atlas(256)
    pr.rebuild_image_atlas(256)
    assert pr.atlas.size == 256 and pr.atlas.rebuild_count == jr.atlas.rebuild_count
    for i in range(6):
        assert pr.contains_image(100 + i)
    _same_atlas(jr, pr)


def test_incremental_atlas_upload():
    """An image replaced at its own size ships only its region to the
    device; a rebuild ships the whole atlas; the device atlas equals the
    host's after each."""
    bus = ImageMessageBus()
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    ren.ensure_image_message_subscription(bus)
    frame0 = np.zeros((64, 64, 4), np.uint8)
    frame0[..., 0] = 10
    put_image(9001, frame0, bus=bus)
    ren.process_image_messages()
    full = ren._device_atlas().clone()
    assert ren.atlas_upload_bytes == ren.atlas.data.nbytes  # first: whole

    frame1 = np.zeros((64, 64, 4), np.uint8)
    frame1[..., 1] = 200
    replace_image(9001, frame1, bus=bus)
    ren.process_image_messages()
    dev = ren._device_atlas()
    assert ren.atlas_upload_bytes == 64 * 64 * 4 * 4  # one 64x64 f32 patch
    assert np.array_equal(dev.numpy(), ren.atlas.data)
    assert not torch.equal(dev, full)
    # nothing pending: no upload, the same tensor
    assert ren._device_atlas() is dev
    ren.rebuild_image_atlas()
    dev2 = ren._device_atlas()
    assert ren.atlas_upload_bytes == ren.atlas.data.nbytes
    assert np.array_equal(dev2.numpy(), ren.atlas.data)


def test_update_remove_contains_match_jax():
    jr, _jb, pr, _pb = _pair(atlas_size=64)
    for ren in (jr, pr):
        ren.put_image(5, checker_image())
        ren.put_image(6, checker_image(16, 16))
    assert pr.contains_image(5) and pr.contains_image(6)
    blue = np.zeros((8, 8, 4), np.uint8)
    blue[..., 2] = blue[..., 3] = 255
    for ren in (jr, pr):
        ren.update_image(5, blue)  # same size: in place
        ren.update_image(6, checker_image(8, 8))  # new size: repacked
        ren.remove_image(999)  # absent: no effect
    _same_atlas(jr, pr)
    a = render_image_node(jr, 5)
    b = _port_image_node(pr, 5)
    assert b[20, 20, 2] > 200 and np.abs(a.astype(int) - b.astype(int)).max() <= 1
    for ren in (jr, pr):
        ren.remove_image(5)
    assert not pr.contains_image(5) and pr.contains_image(6)
    assert jr.atlas.entries == pr.atlas.entries


def test_clear_images_removes_only_listed_ids():
    jr, jb, pr, pb = _pair(atlas_size=128)
    for i in (21, 22, 23):
        jax_put_image(i, checker_image(), bus=jb)
        put_image(i, checker_image(), bus=pb)
    pr.process_image_messages()
    jr.process_image_messages()
    assert all(pr.contains_image(i) for i in (21, 22, 23))
    jax_clear_images([21, 23], bus=jb)
    clear_images([21, 23], bus=pb)
    pr.process_image_messages()
    jr.process_image_messages()
    assert not pr.contains_image(21) and pr.contains_image(22)
    assert not pr.contains_image(23)
    assert jr.atlas.entries == pr.atlas.entries
    # a renderer subscribing later replays only the surviving image
    late = port.FigRenderer(atlas_size=128, device="cpu")
    late.ensure_image_message_subscription(pb)
    late.process_image_messages()
    assert late.contains_image(22) and not late.contains_image(21)


# --- the render-thread guard --------------------------------------------------------


def _boxes():
    r = port.new_renders()
    r.add_root(0, port.Fig(kind=port.FigKind.nkRectangle, screen_box=port.rect(4, 4, 20, 12),
                           fill=port.fill(port.rgba(200, 40, 40, 255))))
    return r


@pytest.mark.parametrize("entry", ["render_frame", "render_frame_async",
                                   "render_batch", "snapshot_scene"])
def test_a_second_thread_is_refused(monkeypatch, entry):
    """The first thread to render owns the renderer; every guarded entry
    point refuses another thread (renderer._assert_render_thread)."""
    monkeypatch.delenv("FIGDRAW_NO_THREAD_GUARD", raising=False)
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    ren.render_frame(_boxes(), port.vec2(32, 24))
    calls = {
        "render_frame": lambda: ren.render_frame(_boxes(), port.vec2(32, 24)),
        "render_frame_async": lambda: ren.render_frame_async(_boxes(), port.vec2(32, 24)),
        "render_batch": lambda: ren.render_batch([_boxes()], port.vec2(32, 24)),
        "snapshot_scene": lambda: ren.snapshot_scene(_boxes(), port.vec2(32, 24)),
    }
    errors = []

    def other():
        try:
            calls[entry]()
        except RuntimeError as exc:
            errors.append(str(exc))

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert errors and "two threads" in errors[0]
    calls[entry]()  # the owner still may


def test_the_guard_can_be_turned_off(monkeypatch):
    monkeypatch.setenv("FIGDRAW_NO_THREAD_GUARD", "1")
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    ren.render_frame(_boxes(), port.vec2(32, 24))
    out = []
    t = threading.Thread(target=lambda: out.append(
        ren.render_frame(_boxes(), port.vec2(32, 24))))
    t.start()
    t.join()
    assert out and tuple(out[0].shape) == (24, 32, 4)


def test_the_guard_matches_jax(monkeypatch):
    """Both packages refuse the same second thread with the same words."""
    monkeypatch.delenv("FIGDRAW_NO_THREAD_GUARD", raising=False)
    jr = JaxRenderer(atlas_size=64, use_pallas=False)
    pr = port.FigRenderer(atlas_size=64, device="cpu")
    jr._assert_render_thread()
    pr._assert_render_thread()
    msgs = []

    def other():
        for ren in (jr, pr):
            try:
                ren._assert_render_thread()
            except RuntimeError as exc:
                msgs.append(str(exc).split(";")[0])

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert len(msgs) == 2 and msgs[0] == msgs[1]
