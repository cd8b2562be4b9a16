"""The slice end to end on CPU tensors: images loaded from files and
generated SDFs through the port's render_frame, against figdraw_tpu.

- load_image of the repo's PNG fixture in both packages gives equal atlas
  entries and pixels (the image, its .flippy chain of mips);
- the image-file scene (examples/image_renderlist.py, the fixture loaded
  at 280 px) in each of scenes.EXAMPLE_FORMS, the MSDF star and the MTSDF
  scene, and the photo wall at 480x270 (12 panels of the loaded image)
  within 1/255 a channel of figdraw_tpu's frames (use_pallas=False);
- the stored references chip_smoke.py holds the card to are fresh
  (`JAX_PLATFORMS=cpu python tests/torch_reference.py images` rewrites
  them);
- load_image's host cache, its errors and the atlas's growth past one
  doubling."""

import json
import os

import numpy as np
import pytest
import torch

import figdraw_tpu as jax_pkg
import figdraw_tpu_torch as port
from figdraw_tpu_torch import resources
from figdraw_tpu_torch.ops.layout import QI_MODE
from figdraw_tpu_torch.plan import plan_execution
from figdraw_tpu_torch.scenes import (
    EXAMPLE_FORMS, IMAGE_FIXTURE_REFERENCE, PHOTO_WALL_REFERENCE, PHOTO_WALL_SIZE,
    PHOTO_WALL_SMALL, EXAMPLE_SCENES, example_reference_path, make_loaded_photo_wall,
    render_example, render_image_file,
)
from torch_reference import (
    block_means, fixture_copy, fixture_digests, jax_image_file_frame, jax_loaded_renderer,
    jax_photo_wall_frame,
)

torch.set_num_threads(1)

TOL = 1.0 / 255.0


@pytest.fixture
def fixture_png(tmp_path):
    return fixture_copy(str(tmp_path))


@pytest.fixture
def jax_png(tmp_path_factory):
    """A copy of the fixture of figdraw_tpu's own, for its sidecar."""
    return fixture_copy(str(tmp_path_factory.mktemp("jax")))


def _port_loaded(path, atlas_size=512, pixel_scale=1.0):
    ren = port.FigRenderer(atlas_size=atlas_size, device="cpu", pixel_scale=pixel_scale)
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    return ren, resources.load_image(path, bus=bus)


def test_load_image_gives_figdraw_tpus_atlas(fixture_png, jax_png):
    """Both packages load the fixture (each writes its sidecar once and
    reads it the second time): the same id, message chain, atlas entries
    and atlas pixels."""
    jpng = jax_png
    ren, ref = _port_loaded(fixture_png)
    jren, jref = jax_loaded_renderer(jpng)
    ren.process_image_messages()
    jren.process_image_messages()
    assert ref.id == resources.image_id_from_path(fixture_png)
    assert jref.id == jax_pkg.resources.image_id_from_path(jpng)

    def by_level(entries, image_id):  # the image's entries by mip level
        return {(0 if k == image_id else k[1] if isinstance(k, tuple) else k): v
                for k, v in entries.items()}

    assert ren.atlas.size == jren.atlas.size == 2048
    mine = by_level(ren.atlas.entries, ref.id)
    assert mine == by_level(jren.atlas.entries, jref.id)
    assert sorted(k for k in mine if isinstance(k, int)) == list(range(7))
    np.testing.assert_array_equal(ren.atlas.data, jren.atlas.data)
    ref.close()
    jref.close()


def test_a_second_load_reads_no_file(fixture_png, monkeypatch):
    """The host cache: a second load_image of a path publishes the cached
    pixels and chain; clear_image_cache and the final release of the last
    ImageRef empty it, and the next load reads the sidecar again."""
    from figdraw_tpu_torch.utils import flippy

    bus = resources.ImageMessageBus()
    sub = bus.subscribe()
    first = resources.load_image(fixture_png, bus=bus)
    reads = []
    real = flippy.read_image_cached
    monkeypatch.setattr(flippy, "read_image_cached", lambda p: reads.append(p) or real(p))
    second = resources.load_image(fixture_png, bus=bus)
    puts = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage]
    assert reads == [] and len(puts) == 2
    assert puts[1].image is puts[0].image and len(puts[1].mips) == 10
    assert all(a is b for a, b in zip(puts[0].mips, puts[1].mips))
    first.close()
    assert first.id in resources._image_cache  # one owner left
    second.close()
    assert first.id not in resources._image_cache and first.id not in resources._mip_cache
    third = resources.load_image(fixture_png, bus=bus)
    assert reads == [fixture_png]
    resources.clear_image_cache(bus=bus)
    assert third.id not in resources._image_cache
    third.close()


def test_put_replace_and_clears_keep_the_cache(fixture_png):
    bus = resources.ImageMessageBus()
    img = np.full((4, 4, 4), 9, np.uint8)
    resources.put_image(4242, img, bus=bus)
    assert resources._image_cache[4242] is img
    img2 = np.full((4, 4, 4), 7, np.uint8)
    resources.replace_image(4242, img2, bus=bus)
    assert resources._image_cache[4242] is img2
    resources.put_image(4243, img, bus=bus)
    resources.clear_images([4242], bus=bus)
    assert 4242 not in resources._image_cache and 4243 in resources._image_cache
    resources.clear_image(4243, bus=bus)
    assert 4243 not in resources._image_cache
    # a path's put pixels replace its loaded chain
    ref = resources.load_image(fixture_png, bus=bus)
    resources.put_image(ref.id, img, bus=bus)
    assert ref.id not in resources._mip_cache
    ref.close()


def test_load_image_without_the_flippy_cache(fixture_png):
    from PIL import Image

    bus = resources.ImageMessageBus()
    sub = bus.subscribe()
    ref = resources.load_image(fixture_png, bus=bus, flippy_cache=False)
    msg = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
    assert msg.mips is None and msg.mipmapped
    np.testing.assert_array_equal(msg.image, np.asarray(Image.open(fixture_png).convert("RGBA")))
    assert not os.path.exists(fixture_png + ".flippy")
    ref.close()


@pytest.mark.parametrize("ext", ["avif", "ppm"])
def test_load_image_of_another_format_raises(ext, tmp_path):
    """A format the port does not decode yet (JPEG decodes since
    utils/imagefile.py, WebP since utils/webp.py), or an AVIF outside the
    port's slice (an image sequence, PIL's save_all, with its tracks' size
    3/4 of its frames'): NotImplementedError naming the format, the path
    and the ROADMAP item, and no sidecar."""
    from PIL import Image

    path = str(tmp_path / f"photo.{ext}")
    extra = ({"save_all": True, "append_images": [Image.fromarray(np.full((8, 8, 3), 9, np.uint8))]}
             if ext == "avif" else {})
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path, **extra)
    if ext == "avif":
        import sys

        from torch_reference import REPO

        sys.path.insert(0, os.path.join(REPO, "tools"))
        from make_image_formats import with_track_size

        with open(path, "rb") as fh:
            data = with_track_size(fh.read(), 6, 6)
        with open(path, "wb") as fh:
            fh.write(data)
    for cache in (True, False):
        with pytest.raises(NotImplementedError,
                           match=r"(AVIF|PPM) images .*photo.*Image formats other than PNG"):
            resources.load_image(path, flippy_cache=cache)
    assert not os.path.exists(path + ".flippy")


def test_atlas_grows_past_one_doubling():
    """An 800x600 image into a 256 atlas: figdraw_tpu's atlas fails its
    rebuild assert there (it doubles once); the port's doubles until the
    image fits and ends as figdraw_tpu's does from 512."""
    from figdraw_tpu.atlas import Atlas as JAtlas
    from figdraw_tpu_torch.atlas import Atlas
    from figdraw_tpu_torch.utils.flippy import image_to_flippy
    from figdraw_tpu_torch.utils.png import read_image

    from figdraw_tpu_torch.scenes import IMAGE_FIXTURE

    chain = image_to_flippy(read_image(IMAGE_FIXTURE)).mipmaps
    a, j, j256 = Atlas(256), JAtlas(512), JAtlas(256)
    for atlas in (a, j, j256):
        atlas.put_image("white", np.ones((4, 4, 4), np.float32))
    a.put_image(1, chain[0], mipmapped=True, mips=chain[1:])
    j.put_image(1, chain[0], mipmapped=True, mips=chain[1:])
    with pytest.raises(AssertionError, match="overflow"):
        j256.put_image(1, chain[0], mipmapped=True, mips=chain[1:])
    assert a.size == j.size == 2048 and a.entries == j.entries
    np.testing.assert_array_equal(a.data, j.data)
    a.reset()  # a rebuild at the same size fits
    with pytest.raises(RuntimeError, match="overflow"):
        a._rebuild(512)  # a rebuild that is no growth raises on a misfit


@pytest.mark.parametrize("form", list(EXAMPLE_FORMS))
def test_image_file_frame_matches_jax(form, fixture_png, jax_png):
    want = jax_image_file_frame(jax_png, form)
    _ren, frame, ref = render_image_file(
        lambda ps: port.FigRenderer(atlas_size=512, device="cpu", pixel_scale=ps),
        fixture_png, form)
    got = frame.numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL
    stored = np.load(example_reference_path("image_file", form))
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= TOL
    ref.close()


def test_photo_wall_matches_jax(fixture_png, jax_png):
    """The photo wall at 480x270, 12 panels (4 clipped): the frame
    executor with a mask run; within 1/255 of figdraw_tpu's frame, which the
    stored block means hold."""
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_png, w, h, n)
    ren, ref = _port_loaded(fixture_png)
    scene = make_loaded_photo_wall(w, h, n, ref.id)
    got = ren.render_frame(scene, port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= TOL
    stored = np.load(PHOTO_WALL_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= TOL
    plan = plan_execution(ren.flatten(scene, port.vec2(w, h)))
    assert plan.mega_combo is None
    assert sum(1 for it in plan.structure if it[0] == "clear_mask") == 4
    ref.close()


def test_photo_wall_at_1080p_plans_onto_the_megakernel(fixture_png):
    """At 1920x1080 with 48 panels (12 clipped) the walked tape has more
    than 24 pass items and atlas quads: the megakernel with the atlas."""
    ren, ref = _port_loaded(fixture_png)
    ren.process_image_messages()
    w, h = PHOTO_WALL_SIZE
    plan = plan_execution(ren.flatten(make_loaded_photo_wall(w, h, 48, ref.id),
                                      port.vec2(w, h)))
    assert plan.mega_combo is not None and plan.mega_atlas
    assert len(plan.structure) > 24
    ref.close()


def test_stored_fixture_digests_are_fresh(tmp_path):
    with open(IMAGE_FIXTURE_REFERENCE) as fh:
        stored = json.load(fh)
    assert fixture_digests(str(tmp_path)) == stored


@pytest.mark.parametrize("name,modes", [("msdf_star", {13, 15}), ("mtsdf", {14, 15, 16})])
def test_sdf_scenes_draw_their_modes(name, modes):
    """The MSDF star draws modes 13 and 15, the MTSDF scene 14, 15 and 16:
    the atlas kernels' MSDF branch, as chip_smoke.py's image_files phase
    counts it on the card."""
    ren, _frame = render_example(lambda ps: port.FigRenderer(device="cpu", pixel_scale=ps),
                                 name, "1x")
    build, (w, h) = EXAMPLE_SCENES[name]
    tape = ren.flatten(build(w, h), port.vec2(w, h))
    base = set(((tape.modes[: tape.count, QI_MODE] % 256) % 128).tolist())
    assert modes <= base


@pytest.mark.parametrize("name", ["msdf_star", "mtsdf"])
def test_sdf_scene_frames_match_jax(name):
    from torch_reference import jax_example_frame

    _ren, frame = render_example(lambda ps: port.FigRenderer(device="cpu", pixel_scale=ps),
                                 name, "1x")
    assert float(np.abs(frame.numpy() - jax_example_frame(name, "1x")).max()) <= TOL
