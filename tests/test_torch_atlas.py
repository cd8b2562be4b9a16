"""Images and glyphs in figdraw_tpu_torch against figdraw_tpu on the CPU:
the atlas packer and the image bus, the image benchmark's scenes,
the atlas evaluator (modes 0 and 13-16, bilinear and nearest, with and
without the subpixel shift), K1-atlas's plain version against the Pallas
kernel's in-kernel 1:1 sampler in interpret mode, bench_images' variants
through render_frame at 480x270 with 25 panels, images_mixed's tile lists,
and bench_text's stored plan. Pixels within 1/255, evaluator values within
1e-5, integers and packing exactly."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_images
import figdraw_tpu_torch as port
from figdraw_tpu import vec2 as jax_vec2
from figdraw_tpu.atlas import Atlas as JaxAtlas, AtlasEntryMeta as JaxMeta
from figdraw_tpu.ops import quad_eval, raster_pallas
from figdraw_tpu.resources import (
    ImageMessageBus as JaxBus, clear_image as jax_clear_image,
    clear_image_cache as jax_clear_image_cache, put_image as jax_put_image,
    replace_image as jax_replace_image,
)
from figdraw_tpu_torch import executor
from figdraw_tpu_torch.atlas import Atlas, AtlasEntryMeta
from figdraw_tpu_torch.ops import raster
from figdraw_tpu_torch.ops.binning import bin_quads
from figdraw_tpu_torch.ops.quad_eval_planar import eval_quad_planar
from figdraw_tpu_torch.plan import atlas_from_jax, from_jax_plan, plan_execution
from figdraw_tpu_torch.resources import (
    ImageMessageBus, clear_image, clear_image_cache, put_image, replace_image,
)
from figdraw_tpu_torch.scenes import (
    IMAGE_ID, atlas_modes_tape, image_reference_path, load_text_plan,
    make_image_panels_scene, photo_image,
)
from torch_reference import (
    DEJAVU, IMAGE_H, IMAGE_N, IMAGE_W, block_means, jax_image_frame,
    jax_image_scene, text_fixture,
)

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

TOL = 1.0 / 255.0
BENCH_VARIANTS = ("sdf_control", "images_11", "images_scaled", "images_mixed")


# --- the atlas packer and the image bus ------------------------------------------


def _atlas_calls(atlas, meta_cls):
    """One sequence of packer calls (uint8, float, gray and RGB images, a
    mip chain, in-place and resizing updates, a removal, growth past the
    edge, a clear and a reset), with the packer's state after each."""
    rng = np.random.RandomState(3)
    states = []

    def state():
        states.append((dict(atlas.entries), atlas.data.tobytes(),
                       atlas.heights.tobytes(), atlas.size, atlas.generation,
                       atlas.entries_version, list(atlas.dirty_rects),
                       atlas.full_dirty, atlas.rebuild_count))

    atlas.put_image("white", np.ones((4, 4, 4), np.float32), meta_cls(kind="generated"))
    state()
    atlas.put_image(1, (rng.rand(20, 30, 4) * 255).astype(np.uint8))
    state()
    atlas.put_image(2, rng.rand(17, 9).astype(np.float32))
    state()
    atlas.put_image(3, (rng.rand(12, 40, 3) * 255).astype(np.uint8),
                    meta_cls(kind="image", image_id=3), mipmapped=True)
    state()
    atlas.update_image(1, (rng.rand(20, 30, 4) * 255).astype(np.uint8))
    state()
    atlas.update_image(2, rng.rand(10, 10, 4).astype(np.float32))
    state()
    atlas.remove(3)
    state()
    for k in range(6):  # past the 64 edge: doubles and repacks
        atlas.put_image(10 + k, rng.rand(24, 28, 4).astype(np.float32))
        state()
    atlas.clear()
    state()
    atlas.put_image(5, rng.rand(8, 8, 4).astype(np.float32))
    atlas.reset(minimum_size=300)
    state()
    return states


def test_atlas_packing_matches_reference():
    ours = _atlas_calls(Atlas(size=64, margin=4), AtlasEntryMeta)
    ref = _atlas_calls(JaxAtlas(size=64, margin=4), JaxMeta)
    assert len(ours) == len(ref)
    for step, (a, b) in enumerate(zip(ours, ref)):
        assert a == b, f"packer state differs after call {step}"
    assert ours[-1][3] == 512  # grew and reset to the minimum size's power


def test_image_bus_matches_reference():
    """The same publications through both packages' buses and renderers
    give the same atlas: a stale put is dropped, replace updates in place,
    clears remove, a cache clear restores the white texel, and a late
    subscriber gets the live images replayed."""
    from figdraw_tpu import FigRenderer as JaxRenderer

    rng = np.random.RandomState(5)
    imgs = [(rng.rand(16, 24, 4) * 255).astype(np.uint8) for _ in range(4)]
    jb, pb = JaxBus(), ImageMessageBus()
    jr = JaxRenderer(atlas_size=128, use_pallas=False)
    pr = port.FigRenderer(atlas_size=128, device="cpu")
    jr.ensure_image_message_subscription(jb)
    pr.ensure_image_message_subscription(pb)

    def same():
        jr.process_image_messages()
        pr.process_image_messages()
        pr._white_uv()
        jr._white_uv()
        assert pr.atlas.entries == jr.atlas.entries
        assert pr.atlas.data.tobytes() == jr.atlas.data.tobytes()

    for bus, put, rep in ((jb, jax_put_image, jax_replace_image),
                          (pb, put_image, replace_image)):
        put(1, imgs[0], bus=bus)
        put(1, imgs[1], bus=bus)  # the first put is stale when drained
        put(2, imgs[2], bus=bus, mipmapped=True)
        rep(2, imgs[3], bus=bus)
    same()
    assert pr.contains_image(1) and pr.contains_image((2, 1)) is False
    for bus, clear in ((jb, jax_clear_image), (pb, clear_image)):
        clear(1, bus=bus)
    same()
    assert not pr.contains_image(1) and pr.contains_image(2)
    late_j = JaxRenderer(atlas_size=128, use_pallas=False)
    late_p = port.FigRenderer(atlas_size=128, device="cpu")
    late_j.ensure_image_message_subscription(jb)
    late_p.ensure_image_message_subscription(pb)
    late_j.process_image_messages()
    late_p.process_image_messages()
    assert late_p.atlas.entries == late_j.atlas.entries and late_p.contains_image(2)
    for bus, clear in ((jb, jax_clear_image_cache), (pb, clear_image_cache)):
        clear(bus=bus)
    same()
    assert not pr.contains_image(2) and "__figdraw_white__" in pr.atlas.entries


def test_device_atlas_follows_the_host_atlas():
    """The renderer's device atlas: a whole upload first, dirty rects
    patched in place, a whole upload again after the atlas grows."""
    pr = port.FigRenderer(atlas_size=64, device="cpu")
    first = pr._device_atlas()
    assert tuple(first.shape) == (64, 64, 4)
    rng = np.random.RandomState(1)
    pr.put_image(9, rng.rand(8, 8, 4).astype(np.float32))
    patched = pr._device_atlas()
    assert patched is first  # copied into its slice, not re-uploaded
    np.testing.assert_array_equal(patched.numpy(), pr.atlas.data)
    pr.put_image(10, rng.rand(60, 60, 4).astype(np.float32))  # grows
    grown = pr._device_atlas()
    assert pr.atlas.size > 64 and tuple(grown.shape) == pr.atlas.data.shape
    np.testing.assert_array_equal(grown.numpy(), pr.atlas.data)
    assert not pr.atlas.dirty and not pr.atlas.dirty_rects


# --- the image scenes ---------------------------------------------------------------


@pytest.mark.parametrize("size", [(IMAGE_W, IMAGE_H, IMAGE_N), (1920, 1080, 400)])
@pytest.mark.parametrize("variant", BENCH_VARIANTS)
def test_image_scene_bytes_match_reference(variant, size, monkeypatch):
    w, h, n = size
    a = jax_image_scene(variant, monkeypatch, w, h, n).layers[0]
    b = make_image_panels_scene(w, h, n, variant).layers[0]
    assert a.count == b.count and a.root_ids == b.root_ids
    assert a.nodes[: a.count].tobytes() == b.nodes[: b.count].tobytes()
    np.testing.assert_array_equal(photo_image(), bench_images._photo_image())


# --- the atlas evaluator ---------------------------------------------------------


@pytest.mark.parametrize("pixelate,subpixel", [(False, False), (False, True),
                                               (True, False), (True, True)])
def test_atlas_eval_matches_quad_eval(pixelate, subpixel):
    """Every quad of the atlas modes tape over a 96x64 pixel grid, against
    figdraw_tpu's XLA evaluator run eagerly (op by op: no fused
    multiply-adds, so nearest sampling's texel-boundary ties fall alike)."""
    w, h = 96, 64
    fields, modes, n, atlas = atlas_modes_tape(w, h, 64, seed=11, n=35)
    py, px = np.mgrid[0:h, 0:w].astype(np.float32) + np.float32(0.5)
    jatlas = jnp.asarray(atlas)
    tatlas = torch.from_numpy(atlas)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    seen = set()
    for i in range(n):
        f = torch.from_numpy(fields[i])
        r, g, b, a = eval_quad_planar(
            lambda k, f=f: f[k], torch.tensor(int(modes[i, 0])), tpx, tpy,
            atlas=tatlas, pixelate=pixelate, subpixel_positioning=subpixel)
        rgb, ref_a = quad_eval.eval_quad(
            jnp.asarray(fields[i]), jnp.int32(modes[i, 0]), jnp.asarray(px),
            jnp.asarray(py), atlas=jatlas, subpixel_positioning=subpixel,
            pixelate=pixelate)
        got = np.stack([r.numpy(), g.numpy(), b.numpy(), a.numpy()], -1)
        ref = np.concatenate([np.asarray(rgb), np.asarray(ref_a)[..., None]], -1)
        covered = np.asarray(ref_a) > 0
        err = np.abs(got - ref)[covered].max(initial=0.0)
        assert err <= 1e-5, f"quad {i} mode {modes[i, 0]}: {err}"
        np.testing.assert_array_equal(a.numpy() > 0, covered)
        seen.add(int(modes[i, 0]) % 256)
    assert {0, 3, 13, 14, 15, 16} <= seen


def test_atlas_modes_without_atlas_stay_sdf_boxes():
    """A pass given no atlas evaluates atlas-mode quads as the SDF-only
    evaluator does (the reference's atlas=None)."""
    fields, modes, n, _atlas = atlas_modes_tape(96, 64, 64, seed=2, n=14)
    py, px = np.mgrid[0:64, 0:96].astype(np.float32) + np.float32(0.5)
    for i in range(n):
        f = torch.from_numpy(fields[i])
        *_rgb, a = eval_quad_planar(lambda k, f=f: f[k],
                                    torch.tensor(int(modes[i, 0])),
                                    torch.from_numpy(px), torch.from_numpy(py))
        _, ref_a = quad_eval.eval_quad(jnp.asarray(fields[i]), jnp.int32(modes[i, 0]),
                                       jnp.asarray(px), jnp.asarray(py))
        assert np.abs(a.numpy() - np.asarray(ref_a)).max() <= 1e-5


@pytest.mark.parametrize("size,th", [(64, 64), (256, 128)])
def test_plain_atlas_pass_matches_pallas_atlas11(size, th, monkeypatch):
    """K1-atlas's plain version on 1:1 mode-0 quads (with SDF boxes between)
    against the Pallas kernel's in-kernel window sampler in interpret mode,
    the quads marked by mark_atlas11 as FIGDRAW_ATLAS11=always marks them;
    an atlas of 64 is smaller than a tile."""
    monkeypatch.setenv("FIGDRAW_ATLAS11", "always")
    w, h = 256, 128
    fields, modes, n, atlas = atlas_modes_tape(w, h, size, seed=size, n=24,
                                               one_to_one=True)
    assert raster_pallas.mark_atlas11(fields, modes, n, size)
    assert (modes[:n, 0] & quad_eval.MODE_ATLAS11_BIT).any()
    rng = np.random.RandomState(4)
    planes = rng.rand(4, h, w).astype(np.float32)
    masks = np.ones((1, h, w), np.float32)
    tile_idx, tile_counts = bin_quads(torch.from_numpy(fields), 0, fields.shape[0],
                                      h // th, w // 128, th, 128)
    atlas_planes, real = raster_pallas.atlas_to_planes(jnp.asarray(atlas))
    ref = np.asarray(raster_pallas.draw_pass_planar_prebinned(
        jnp.asarray(fields), jnp.asarray(modes), jnp.int32(0), jnp.int32(n),
        jnp.asarray(tile_idx.numpy())[:, None, :], jnp.asarray(tile_counts.numpy()),
        jnp.asarray(planes), jnp.asarray(masks), tile_h=th,
        atlas_planes=atlas_planes, atlas_size=real))
    got = raster.draw_pass_planar_prebinned_plain(
        torch.from_numpy(fields), torch.from_numpy(modes),
        torch.tensor([0, n], dtype=torch.int32), tile_idx, tile_counts,
        torch.from_numpy(planes), torch.from_numpy(masks), tile_h=th,
        atlas=torch.from_numpy(atlas))
    assert np.abs(got.numpy() - ref).max() <= TOL
    assert np.abs(ref - planes).max() > 0.1


def test_cpu_tensors_take_the_plain_atlas_pass():
    fields, modes, n, atlas = atlas_modes_tape(256, 128, 64, seed=9, n=16)
    f = torch.from_numpy(fields)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], 2, 2, 64, 128)
    args = (f, torch.from_numpy(modes), torch.tensor([0, n], dtype=torch.int32),
            tile_idx, tile_counts, torch.rand(4, 128, 256), torch.ones(1, 128, 256))
    want = raster.draw_pass_planar_prebinned_plain(*args, tile_h=64,
                                                   atlas=torch.from_numpy(atlas))
    before = (raster.LAUNCHES, raster.ATLAS_LAUNCHES)
    out = raster.draw_pass_planar_prebinned(*args, tile_h=64,
                                            atlas=torch.from_numpy(atlas))
    assert (raster.LAUNCHES, raster.ATLAS_LAUNCHES) == before
    assert out is args[5]  # the target, updated in place
    np.testing.assert_array_equal(out.numpy(), want.numpy())


# --- bench_images' variants through render_frame ----------------------------------


def _port_image_renderer():
    ren = port.FigRenderer(atlas_size=256, device="cpu")
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    put_image(IMAGE_ID, photo_image(), bus=bus, mipmapped=True)
    return ren


@pytest.mark.parametrize("variant", BENCH_VARIANTS)
def test_image_variant_matches_reference(variant, monkeypatch):
    scene, jr, ref = jax_image_frame(variant, monkeypatch)
    pr = _port_image_renderer()
    ours = make_image_panels_scene(IMAGE_W, IMAGE_H, IMAGE_N, variant)
    size = port.vec2(IMAGE_W, IMAGE_H)
    before = (raster.LAUNCHES, raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES)
    got = pr.render_frame(ours, size)
    assert (raster.LAUNCHES, raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES) == before
    assert tuple(got.shape) == (IMAGE_H, IMAGE_W, 4)
    assert np.abs(got.numpy() - ref).max() <= TOL
    # the same atlas (six entries: white texel, the photo, three mips) and
    # the same tape
    assert pr.atlas.entries == jr.atlas.entries
    assert pr.atlas.data.tobytes() == jr.atlas.data.tobytes()
    pt = pr.flatten(ours, size)
    jt = jr.flatten(scene, jax_vec2(IMAGE_W, IMAGE_H))
    assert pt.combo.tobytes() == jt.combo.tobytes()
    assert [it[:3] for it in pt.structure_cache[0]] == [
        ("draw", -1, variant != "sdf_control")]
    assert got.numpy().std() > 0.05


def test_image_plan_runs_through_port_executor(monkeypatch):
    """figdraw_tpu's own plan and atlas through the port's frame executor."""
    scene, jr, ref = jax_image_frame("images_scaled", monkeypatch)
    jplan = jr._plan_execution(jr.flatten(scene, jax_vec2(IMAGE_W, IMAGE_H)))
    plan = from_jax_plan(jplan)
    assert plan.structure == (("draw", -1, True, False),)
    got = port.FigRenderer(device="cpu").execute_plan(
        plan, atlas=atlas_from_jax(jr.atlas.data)).numpy()
    assert np.abs(got - ref).max() <= TOL


def test_images_11_matches_pallas_atlas11(monkeypatch):
    """images_11's quads are all 1:1, so under FIGDRAW_ATLAS11=always
    figdraw_tpu samples them inside the Pallas kernel (interpret mode here)
    and the port's frame agrees with that path too."""
    monkeypatch.setenv("FIGDRAW_ATLAS11", "always")
    from figdraw_tpu import FigRenderer as JaxRenderer
    from figdraw_tpu.resources import ImageMessageBus as JaxBus_

    w, h, n = 256, 128, 4
    jr = JaxRenderer(atlas_size=256, use_pallas=True)
    bus = JaxBus_()
    jr.ensure_image_message_subscription(bus)
    jax_put_image(IMAGE_ID, bench_images._photo_image(), bus=bus, mipmapped=True)
    scene = jax_image_scene("images_11", monkeypatch, w, h, n)
    ref = np.asarray(jr.render_frame(scene, jax_vec2(w, h)))
    assert jr.use_pallas, "the JAX renderer fell back from Pallas"
    jplan = jr._plan_execution(jr.flatten(scene, jax_vec2(w, h)))
    assert jplan.atlas11_runs, "the 1:1 quads were not marked"
    got = _port_image_renderer().render_frame(
        make_image_panels_scene(w, h, n, "images_11"), port.vec2(w, h))
    assert np.abs(got.numpy() - ref).max() <= TOL


@pytest.mark.parametrize("variant", BENCH_VARIANTS)
def test_stored_image_blocks_match_jax(variant, monkeypatch):
    """chip_smoke.py holds the port's image frames on the card against these
    block means of figdraw_tpu's frames; they must stay its."""
    _scene, _jr, ref = jax_image_frame(variant, monkeypatch)
    stored = np.load(image_reference_path(variant))
    np.testing.assert_allclose(stored, block_means(ref), rtol=0, atol=1e-6)


class _Binned(Exception):
    pass


def test_images_mixed_binning_matches_prebin(monkeypatch):
    """The full-size images_mixed frame (1920x1080, 400 panels: images and
    drop-shadowed boxes in one run): the executor's tile lists equal
    raster_pallas.prebin's over that run."""
    pr = _port_image_renderer()
    pr.process_image_messages()
    tape = pr.flatten(make_image_panels_scene(1920, 1080, 400, "images_mixed"),
                      port.vec2(1920, 1080))
    plan = plan_execution(tape)
    assert plan.structure == (("draw", -1, True, False),)
    assert (tape.count, tape.combo_quads) == (1734, 2048)
    seen = {}

    def spy(*args, **kw):
        seen["lists"] = bin_quads(*args, **kw)
        raise _Binned

    monkeypatch.setattr(executor, "bin_quads", spy)
    run = executor.get_frame_executor(plan.structure, 1080, 1920, 1, False,
                                      plan.tile_h)
    with pytest.raises(_Binned):
        run(torch.from_numpy(plan.combo))
    idx, counts = seen["lists"]
    fields, modes = tape.fields, tape.modes
    ph = -(-1080 // plan.tile_h) * plan.tile_h
    ref_idx, ref_counts = raster_pallas.prebin(
        jnp.asarray(fields), jnp.int32(fields.shape[0]), ph, 1920,
        tile_h=plan.tile_h, tile_w=128, modes=jnp.asarray(modes),
        run_bounds=jnp.asarray(np.asarray(plan.bounds, np.int32)), n_runs=1)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx)[:, 0, :])


# --- bench_text's stored plan ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_text():
    if not os.path.exists(DEJAVU):
        pytest.skip(f"needs the DejaVu font at {DEJAVU}")
    return text_fixture()


def test_text_fixture_is_fresh(jax_text):
    """The stored plan, atlas and block means are figdraw_tpu's own today
    (tests/torch_reference.py rewrites them)."""
    arrays, _frame = jax_text
    from figdraw_tpu_torch.scenes import TEXT_REFERENCE

    with np.load(TEXT_REFERENCE) as z:
        assert sorted(z.files) == sorted(arrays)
        for key, want in arrays.items():
            if key == "blocks":
                np.testing.assert_allclose(z[key], want, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(z[key], want, err_msg=key)


def test_text_plan_matches_reference(jax_text):
    """The stored plan through the port's executor on the CPU: within 1/255
    of figdraw_tpu's whole frame."""
    _arrays, ref = jax_text
    plan, atlas, _blocks = load_text_plan()
    got = port.FigRenderer(device="cpu").execute_plan(
        plan, atlas=atlas_from_jax(atlas)).numpy()
    assert tuple(got.shape) == (800, 1200, 4)
    assert np.abs(got - ref).max() <= TOL


def test_text_plan_matches_stored_blocks():
    """The same without fontTools or the font: the port's frame of the
    stored plan against the stored block means, as chip_smoke.py holds it."""
    plan, atlas, blocks = load_text_plan()
    assert plan.structure == (("draw", -1, True, False),)
    assert (plan.tile_h, plan.combo.shape, plan.bounds) == (64, (2049, 52), [(0, 1899)])
    got = port.FigRenderer(device="cpu").execute_plan(
        plan, atlas=atlas_from_jax(atlas)).numpy()
    assert np.abs(block_means(got) - blocks).max() <= TOL


def test_text_nodes_name_their_roadmap_item(tmp_path):
    """Text has landed: a text row without a layout (no glyph rows) draws
    nothing, on the native walk, and what of text stays unported names its
    ROADMAP item: a variation location away from a variable face's
    default."""
    import test_shaping

    from figdraw_tpu_torch.basics import FigKind
    from figdraw_tpu_torch.text import typefaces as port_tf

    scene = make_image_panels_scene(128, 128, 1, "images_11")
    plain = port.FigRenderer(device="cpu").render_frame(scene, port.vec2(128, 128))
    lst = scene.layers[0]
    t = lst.add_root_raw()
    lst.nodes["kind"][t] = int(FigKind.nkText)
    got = port.FigRenderer(device="cpu").render_frame(scene, port.vec2(128, 128))
    assert torch.equal(got, plain)
    tf = port_tf.get_typeface(port_tf.load_typeface(test_shaping._build_var_font(tmp_path)))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, port item 'Text host pipeline'"):
        tf.glyph_path(tf.glyph_id(65), (port_tf.FontVariation("wght", 700),))
