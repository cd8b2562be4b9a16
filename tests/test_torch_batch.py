"""render_batch of figdraw_tpu_torch (tests/test_batch.py's twin) on the
CPU: the same scenes, built with figdraw_tpu's API and carried over by
`to_port`, batched by the port and rendered frame by frame by both
packages. Within the port a batched frame equals render_frame's bit for
bit, on every group kind (unrolled, rolled, mega, mega with the atlas),
across structure changes and image updates mid-sequence, past the walk
pool's two buffers; against figdraw_tpu each frame is within 1/255 a
channel. test_batch.py's two mesh cases wait for the port's multi-device
item (render_batch(mesh=...) raises here), and its power-of-two padding
case is replaced by the chunk bound: the port does not pad the frame
axis."""

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
from figdraw_tpu import vec2 as jax_vec2
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu_torch import executor, renderer as port_renderer
from figdraw_tpu_torch.nodesarray import to_renders
from figdraw_tpu_torch.scenes import (
    IMAGE_ID, make_blurred_cards_scene, make_image_panels_scene,
)
from test_batch import blur_scene, clip_scene, simple_scene
from torch_reference import (
    jax_clipped_scene, jax_image_renderer, port_image_renderer, to_port,
)

torch.set_num_threads(1)  # see tests/test_torch_render_frame.py

TOL = 1.0 / 255.0


def _groups(monkeypatch):
    """Record each group the port's render_batch runs: (kind, frames)."""
    seen = []
    real = port_renderer.run_batch

    def spy(run, batch, out, **const):
        seen.append(batch.count)
        return real(run, batch, out, **const)

    monkeypatch.setattr(port_renderer, "run_batch", spy)
    return seen


def _check_batch(scene_fn, size, frames, chunk=4, atlas_size=64, jax_too=True):
    """Batch the port's frames, then render each with render_frame on a
    second port renderer (bit for bit) and with figdraw_tpu (1/255)."""
    batch_r = port.FigRenderer(atlas_size=atlas_size, device="cpu")
    ref_r = port.FigRenderer(atlas_size=atlas_size, device="cpu")
    w, h = size
    out = batch_r.render_batch([to_port(scene_fn(f)) for f in range(frames)],
                               port.vec2(w, h), chunk=chunk)
    assert tuple(out.shape) == (frames, h, w, 4) and out.dtype == torch.float32
    jr = JaxRenderer(atlas_size=atlas_size, use_pallas=False)
    for f in range(frames):
        expect = ref_r.render_frame(to_port(scene_fn(f)), port.vec2(w, h))
        assert torch.equal(out[f], expect), f"frame {f}"
        if jax_too:
            ref = np.asarray(jr.render_frame(scene_fn(f), jax_vec2(w, h)))
            assert np.abs(out[f].numpy() - ref).max() <= TOL, f"frame {f}"
    assert torch.equal(batch_r.last_frame, out[-1])
    return out


def test_batch_simple_unrolled(monkeypatch):
    # 5 frames, chunk 4: a full group and a group of one, and 5 > the walk
    # pool's two buffers (each frame's combo is copied into the stack)
    groups = _groups(monkeypatch)
    _check_batch(simple_scene, (160, 128), 5)
    assert groups == [4, 1]


def test_batch_mega(monkeypatch):
    """The clip table takes the walk's mega export: a mega group."""
    groups = _groups(monkeypatch)
    _check_batch(clip_scene, (224, 160), 3)
    assert groups == [3]


def test_batch_blur_radii_vary(monkeypatch):
    """The blur radius is a per-frame device value: frames of different
    radii share a group."""
    groups = _groups(monkeypatch)
    _check_batch(blur_scene, (160, 128), 3)
    assert groups == [3]


def test_batch_mixed_structure(monkeypatch):
    """Structure changes mid-sequence split groups; order is preserved; a
    tree takes the Python walk into the same group as its arrays."""
    groups = _groups(monkeypatch)
    scenes = [to_port(simple_scene(0)), to_port(simple_scene(1)),
              to_port(clip_scene(0)), to_port(clip_scene(1)),
              to_renders(to_port(simple_scene(2)))]
    batch_r = port.FigRenderer(atlas_size=64, device="cpu")
    ref_r = port.FigRenderer(atlas_size=64, device="cpu")
    out = batch_r.render_batch(scenes, port.vec2(224, 160), chunk=4)
    assert tuple(out.shape) == (5, 160, 224, 4)
    rebuilt = [simple_scene(0), simple_scene(1), clip_scene(0), clip_scene(1),
               simple_scene(2)]
    jr = JaxRenderer(atlas_size=64, use_pallas=False)
    for f, sc in enumerate(rebuilt):
        expect = ref_r.render_frame(to_port(sc), port.vec2(224, 160))
        assert torch.equal(out[f], expect), f"frame {f}"
        ref = np.asarray(jr.render_frame(sc, jax_vec2(224, 160)))
        assert np.abs(out[f].numpy() - ref).max() <= TOL
    assert groups == [2, 2, 1]


@pytest.mark.parametrize("frames,chunk,want", [(7, 3, [3, 3, 1]), (3, 8, [3]),
                                               (4, 1, [1, 1, 1, 1])])
def test_batch_group_never_exceeds_chunk(monkeypatch, frames, chunk, want):
    """The power-of-two padding case's replacement: a group holds at most
    `chunk` frames and never more frames than were given."""
    groups = _groups(monkeypatch)
    _check_batch(simple_scene, (160, 128), frames, chunk=chunk, jax_too=False)
    assert groups == want


def test_batch_chunk_default_reads_the_env(monkeypatch):
    monkeypatch.setenv("FIGDRAW_BATCH_CHUNK", "2")
    groups = _groups(monkeypatch)
    r = port.FigRenderer(atlas_size=64, device="cpu")
    r.render_batch([to_port(simple_scene(f)) for f in range(5)], port.vec2(160, 128))
    assert groups == [2, 2, 1]


def test_batch_empty():
    r = port.FigRenderer(atlas_size=64, device="cpu")
    out = r.render_batch([], port.vec2(64, 48))
    assert tuple(out.shape) == (0, 48, 64, 4)
    assert r.last_frame is None


def test_batch_as_uint8_matches_screenshot():
    size = port.vec2(160, 128)
    batch_r = port.FigRenderer(atlas_size=64, device="cpu")
    ref_r = port.FigRenderer(atlas_size=64, device="cpu")
    out = batch_r.render_batch([to_port(simple_scene(f)) for f in range(3)], size,
                               as_uint8=True)
    assert out.dtype == torch.uint8
    for f in range(3):
        frame = ref_r.render_frame(to_port(simple_scene(f)), size)
        np.testing.assert_array_equal(out[f].numpy(), ref_r.take_screenshot(frame))


def test_batch_mesh_raises():
    """render_batch(mesh=) renders frames in parallel over a
    parallel.sharding.Mesh (tests/test_torch_sharding.py); a mesh that is no
    Mesh, or one of another device type than the renderer's, raises."""
    from figdraw_tpu_torch.parallel.sharding import FRAMES_AXIS, Mesh

    r = port.FigRenderer(atlas_size=64, device="cpu")
    with pytest.raises(ValueError, match="parallel.sharding.Mesh"):
        r.render_batch([to_port(simple_scene(0))], port.vec2(160, 128), mesh=object())
    with pytest.raises(ValueError, match="mesh of cuda devices"):
        r.render_batch([to_port(simple_scene(0))], port.vec2(160, 128),
                       mesh=Mesh((torch.device("cuda", 0),), FRAMES_AXIS))


# --- groups that sample the atlas ---------------------------------------------------


def test_batch_mega_atlas_cards(monkeypatch):
    """images_clipped's cards (12 at 320x200): the planner's megakernel plan
    with the atlas, one group, bit-equal to render_frame."""
    groups = _groups(monkeypatch)
    scenes = [make_image_panels_scene(320 + f, 200, 12, "images_clipped")
              for f in range(3)]
    a = port_image_renderer()
    out = a.render_batch(scenes, port.vec2(320, 200))
    b = port_image_renderer()
    for f, sc in enumerate(scenes):
        assert torch.equal(out[f], b.render_frame(sc, port.vec2(320, 200)))
    assert groups == [3]
    ref = np.asarray(jax_image_renderer().render_frame(
        jax_clipped_scene(12, 322.0, 200.0), jax_vec2(320, 200)))
    assert np.abs(out[2].numpy() - ref).max() <= TOL


def test_batch_rolled_blurred_cards(monkeypatch):
    """The blurred cards (10 at 320x200: 44 pass items with a blur and a
    backdrop) plan onto the rolled executor: a rolled group whose item
    tables and radii ride in the stack."""
    groups = _groups(monkeypatch)
    scenes = [make_blurred_cards_scene(320, 200, 10) for _ in range(2)]
    a = port_image_renderer()
    out = a.render_batch(scenes, port.vec2(320, 200))
    b = port_image_renderer()
    for f, sc in enumerate(scenes):
        assert torch.equal(out[f], b.render_frame(sc, port.vec2(320, 200)))
    assert groups == [2]


def test_batch_image_update_starts_new_group(monkeypatch):
    """An update_image between frames changes the device atlas: the frames
    before it keep the old pixels, the frames after it get the new ones,
    each equal to render_frame with the same update at the same point."""
    groups = _groups(monkeypatch)
    size = port.vec2(320, 200)
    red = np.zeros((64, 64, 4), np.uint8)
    red[..., 0] = red[..., 3] = 255

    def frames(ren):
        for f in range(4):
            if f == 2:
                ren.update_image(IMAGE_ID, red)
            yield make_image_panels_scene(320, 200, 12, "images_11")

    a = port_image_renderer()
    out = a.render_batch(frames(a), size)
    b = port_image_renderer()
    want = [b.render_frame(sc, size) for sc in frames(b)]
    for f in range(4):
        assert torch.equal(out[f], want[f]), f"frame {f}"
    assert groups == [2, 2]
    assert not torch.equal(out[1], out[2])


def test_batch_a_failing_group_raises_with_no_retry(monkeypatch):
    """A failure in a group's executor reaches the caller; no frame is
    rendered again another way."""
    singles = []
    r = port.FigRenderer(atlas_size=64, device="cpu")
    monkeypatch.setattr(r, "execute_plan", lambda *a, **k: singles.append(a))

    def boom(*a, **k):
        raise RuntimeError("injected batch failure")

    monkeypatch.setattr(port_renderer, "run_batch", boom)
    with pytest.raises(RuntimeError, match="injected batch failure"):
        r.render_batch([to_port(simple_scene(f)) for f in range(3)], port.vec2(160, 128))
    assert singles == []


def test_batch_stack_round_trips_buffers():
    """executor.BatchStack: each frame's buffers come back from the one
    upload in their shapes, dtypes and bits."""
    rng = np.random.RandomState(3)
    frames = [{"combo": rng.rand(5, 52).astype(np.float32),
               "items": rng.randint(-9, 9, (4, 4)).astype(np.int32),
               "radii": rng.rand(4).astype(np.float32)} for _ in range(3)]
    stack = executor.BatchStack(frames[0], 4)
    for fr in frames[1:]:
        stack.add(fr)
    up = stack.upload("cpu")
    assert tuple(up.shape) == (3, 5 * 52 + 16 + 4)
    for f, fr in enumerate(frames):
        got = stack.frame(up, f)
        for name, arr in fr.items():
            assert got[name].numpy().dtype == arr.dtype
            np.testing.assert_array_equal(got[name].numpy(), arr)
    with pytest.raises(ValueError):
        stack.add({"combo": np.zeros((6, 52), np.float32), "items": frames[0]["items"],
                   "radii": frames[0]["radii"]})


def test_batch_cold_glyph_in_a_later_frame(monkeypatch):
    """The atlas changing inside a batch: frames of text whose later frames
    hold a glyph no earlier frame drew (a cold miss rasterized into the
    atlas by the walk of that frame). The frames before it keep their
    group and atlas; each frame equals render_frame's on a second renderer
    bit for bit."""
    from figdraw_tpu_torch.scenes import make_text_scene
    from figdraw_tpu_torch.text.typefaces import bundled_font_path, load_typeface

    groups = _groups(monkeypatch)
    tid = load_typeface(bundled_font_path())
    ink = port.fill(port.rgba(20, 20, 30, 255))
    seeds = [0, 0, 1, 1, 2]  # the lines of seed s end in s, s + 1, s + 2

    def scenes():
        return [make_text_scene(tid, ink, s, 320, 80, lines=3)[0] for s in seeds]

    a = port.FigRenderer(atlas_size=256, device="cpu")
    out = a.render_batch(scenes(), port.vec2(320, 80))
    b = port.FigRenderer(atlas_size=256, device="cpu")
    want = [b.render_frame(sc, port.vec2(320, 80)) for sc in scenes()]
    for f in range(len(seeds)):
        assert torch.equal(out[f], want[f]), f"frame {f}"
    assert groups == [2, 2, 1]
    assert not torch.equal(out[1], out[2])
