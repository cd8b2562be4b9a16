"""render_frame_async of figdraw_tpu_torch (tests/test_async_pipeline.py's
twin) on the CPU: the walk on the caller's thread, upload and executor on
the renderer's worker thread, at most two frames in flight. Async frames
equal the synchronous loop's bit for bit and figdraw_tpu's within 1/255.
Two contracts the JAX package gets from its synchronous upload are pinned
here: the walk's pooled combo may be rewritten as soon as a frame's slot
is released, and a frame samples the atlas as of its own walk, not the
next frame's image update."""

import sys
import threading

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
from figdraw_tpu import vec2 as jax_vec2
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu_torch import native
from figdraw_tpu_torch.scenes import IMAGE_ID, make_image_panels_scene
from test_async_pipeline import _scene
from test_batch import clip_scene
from torch_reference import port_image_renderer, to_port

torch.set_num_threads(1)  # see tests/test_torch_render_frame.py

TOL = 1.0 / 255.0
SIZE = port.vec2(160, 128)


def _renderer():
    return port.FigRenderer(atlas_size=64, device="cpu")


def test_async_frames_match_sync():
    sync_r, async_r = _renderer(), _renderer()
    futures = [async_r.render_frame_async(to_port(_scene(f)), SIZE) for f in range(4)]
    frames = [f.result(timeout=60) for f in futures]
    jr = JaxRenderer(atlas_size=64, use_pallas=False)
    for f in range(4):
        assert torch.equal(frames[f], sync_r.render_frame(to_port(_scene(f)), SIZE))
        ref = np.asarray(jr.render_frame(_scene(f), jax_vec2(160, 128)))
        assert np.abs(frames[f].numpy() - ref).max() <= TOL


def test_async_then_sync_drains():
    """A sync render after async ones drains them first and gives the
    right frame."""
    r = _renderer()
    fut = r.render_frame_async(to_port(_scene(0)), SIZE)
    sync_frame = r.render_frame(to_port(_scene(1)), SIZE)
    assert fut.done() and not r._async_released
    ref = _renderer()
    ref.render_frame(to_port(_scene(0)), SIZE)
    assert torch.equal(sync_frame, ref.render_frame(to_port(_scene(1)), SIZE))
    assert torch.equal(fut.result(timeout=60), _renderer().render_frame(to_port(_scene(0)), SIZE))


def test_async_inflight_cap():
    """Never more than two frames in flight; many frames back to back stay
    right frame by frame."""
    r = _renderer()
    futs = []
    for f in range(7):
        futs.append((f, r.render_frame_async(to_port(_scene(f % 3)), SIZE)))
        assert len(r._async_released) <= 2
    ref = _renderer()
    expects = {f: ref.render_frame(to_port(_scene(f)), SIZE) for f in range(3)}
    for f, fut in futs:
        assert torch.equal(fut.result(timeout=60), expects[f % 3])


def test_async_exception_propagates():
    r = _renderer()
    orig = r._run_plan

    def boom(*a, **k):
        raise RuntimeError("injected execute failure")

    r._run_plan = boom
    fut = r.render_frame_async(to_port(_scene(0)), SIZE)
    with pytest.raises(RuntimeError, match="injected execute failure"):
        fut.result(timeout=60)
    r._run_plan = orig
    # the slot was released and the pipeline stays usable afterwards
    r.drain_async()
    out = r.render_frame_async(to_port(_scene(1)), SIZE).result(timeout=60)
    assert tuple(out.shape) == (128, 160, 4)
    assert torch.equal(out, _renderer().render_frame(to_port(_scene(1)), SIZE))


def test_async_mega_and_frames_that_do_not_clear():
    """A mega frame from the walk's pooled export, then frames that do not
    clear: each composites onto the frame before it, in submission order."""
    a, b = _renderer(), _renderer()
    size = port.vec2(224, 160)
    futs = [a.render_frame_async(to_port(clip_scene(0)), size),
            a.render_frame_async(to_port(_scene(1)), size, clear_main=False),
            a.render_frame_async(to_port(_scene(2)), size, clear_main=False)]
    want = [b.render_frame(to_port(clip_scene(0)), size),
            b.render_frame(to_port(_scene(1)), size, clear_main=False),
            b.render_frame(to_port(_scene(2)), size, clear_main=False)]
    for fut, w in zip(futs, want):
        assert torch.equal(fut.result(timeout=60), w)


def test_async_pool_rewritten_after_release_changes_no_frame():
    """Contract (a): once a frame's slot is released, the walk's pooled
    combo buffers it came from may be rewritten (here with garbage), and no
    frame changes."""
    r = _renderer()
    futs = []
    for f in range(4):
        futs.append(r.render_frame_async(to_port(_scene(f)), SIZE))
        r._async_released[-1].result(timeout=60)
        for key, entry in native._combo_pool.items():
            if key[0] == id(r):
                entry[0].fill(np.nan)
                entry[1].fill(np.nan)
    ref = _renderer()
    for f, fut in enumerate(futs):
        assert torch.equal(fut.result(timeout=60), ref.render_frame(to_port(_scene(f)), SIZE))


def test_async_image_update_lands_on_the_next_frame_only():
    """Contract (b): an image replaced between two async frames shows in the
    second only, even when the first has not run yet (its job is held
    until the second is queued)."""
    size = port.vec2(320, 200)
    scene = make_image_panels_scene(320, 200, 12, "images_11")
    red = np.zeros((64, 64, 4), np.uint8)
    red[..., 0] = red[..., 3] = 255
    r = port_image_renderer()
    gate = threading.Event()
    orig = r._run_plan

    def held(*a, **k):
        gate.wait(30)
        return orig(*a, **k)

    r._run_plan = held
    first = r.render_frame_async(scene, size)
    r.update_image(IMAGE_ID, red)
    second = r.render_frame_async(scene, size)
    gate.set()
    ref = port_image_renderer()
    before = ref.render_frame(scene, size)
    ref.update_image(IMAGE_ID, red)
    after = ref.render_frame(scene, size)
    assert torch.equal(first.result(timeout=60), before)
    assert torch.equal(second.result(timeout=60), after)
    assert not torch.equal(before, after)


def test_async_zero_size_returns_last_frame():
    r = _renderer()
    frame = r.render_frame(to_port(_scene(0)), SIZE)
    assert r.render_frame_async(to_port(_scene(1)), port.vec2(0, 10)).result(timeout=60) is frame


def test_async_stress_with_a_short_switch_interval():
    """The state the caller and the worker share (last_frame, the release
    futures, the device atlas and its copy-on-patch flag, the staging
    slots): 24 image frames, every third not clearing, an image update
    every fifth, under a 1 µs switch interval. Each frame equals the
    synchronous loop's with the same updates at the same points."""
    size = port.vec2(160, 100)
    scene = make_image_panels_scene(160, 100, 6, "images_11")
    tints = []
    for k in range(5):
        img = np.zeros((64, 64, 4), np.uint8)
        img[..., k % 3] = 60 + 40 * k
        img[..., 3] = 255
        tints.append(img)

    def drive(ren, render):
        out = []
        for f in range(24):
            if f % 5 == 4:
                ren.update_image(IMAGE_ID, tints[f // 5])
            out.append(render(ren, f))
        return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        a = port_image_renderer()
        futs = drive(a, lambda r, f: r.render_frame_async(scene, size,
                                                          clear_main=f % 3 != 2))
        got = [fut.result(timeout=120) for fut in futs]
    finally:
        sys.setswitchinterval(old)
    b = port_image_renderer()
    want = drive(b, lambda r, f: r.render_frame(scene, size, clear_main=f % 3 != 2))
    for f in range(24):
        assert torch.equal(got[f], want[f]), f"frame {f}"


@pytest.mark.parametrize("publish", ["load_image", "put_image"])
def test_async_image_published_between_frames(publish, tmp_path):
    """The atlas changing inside the frame loop: an image published on the
    renderer's bus (load_image of the PNG fixture through its .flippy
    chain, which grows the atlas from 256 to 2048, or a mipmapped
    put_image) between two async frames, the first held until the second
    is queued. Each frame equals render_frame's with the same publication
    at the same point, bit for bit."""
    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import make_loaded_photo_wall
    from torch_reference import fixture_copy

    size = port.vec2(320, 200)
    path = fixture_copy(str(tmp_path))
    first_scene = make_image_panels_scene(320, 200, 12, "images_scaled")

    def publish_on(ren) -> int:
        if publish == "load_image":
            return resources.load_image(path, bus=ren._bus).id
        rng = np.random.RandomState(9)
        resources.put_image(5151, rng.randint(0, 256, (96, 128, 4)).astype(np.uint8),
                            bus=ren._bus, mipmapped=True)
        return 5151

    r = port_image_renderer()
    gate = threading.Event()
    orig = r._run_plan

    def held(*a, **k):
        gate.wait(30)
        return orig(*a, **k)

    r._run_plan = held
    first = r.render_frame_async(first_scene, size)
    image_id = publish_on(r)
    second = r.render_frame_async(make_loaded_photo_wall(320, 200, 8, image_id), size)
    third = r.render_frame_async(first_scene, size)
    gate.set()
    ref = port_image_renderer()
    want = [ref.render_frame(first_scene, size)]
    ref_id = publish_on(ref)
    want.append(ref.render_frame(make_loaded_photo_wall(320, 200, 8, ref_id), size))
    want.append(ref.render_frame(first_scene, size))
    got = [f.result(timeout=120) for f in (first, second, third)]
    for f in range(3):
        assert torch.equal(got[f], want[f]), f"frame {f}"
    assert ref.atlas.size == (2048 if publish == "load_image" else 256)
    assert not torch.equal(got[0], got[1])
