"""Text scenes built and rendered by figdraw_tpu_torch's own text pipeline,
against figdraw_tpu and its stored references.

- bench_text's scene (scenes.make_text_scene: 1200x800, 36 lines of the
  bundled DejaVuSans at 15 px, atlas_size=512) through render_frame: the
  packed combo and the atlas equal figdraw_tpu's bench_text.build_scene
  through its renderer and the stored `text_1200x800.npz`, byte for byte;
  the frame is within 1/255 of the stored block means.
- The text table (scenes.make_text_table_scene: 180x6 clipped cells, a line
  of text each) through the Python walk: the tape, planned, is the stored
  `textclip_1200x800.npz` tape (figdraw_tpu's Python walk) byte for byte
  but the sign of zero (that walk snaps vertices to Python ints, the port's
  to floats as the C++ walk does: tests/test_torch_tree_walk.py), with the
  same atlas; at 480x270 its frame is within 1/255 of figdraw_tpu's.
- test_images.py's text cases (glyph clears, cache clears, RAII eviction)
  run a second time on the port (torch_twin).
- A text tree through the Python walk equals the native walk of the same
  arrays byte for byte, at 1x, pixel_scale=2 and UI scale 2, and a
  RenderFragments with text renders as figdraw_tpu's.
- Retained scenes with text (test_retained.py's text cases): a moved text
  root and relabelled reserved roots patch in place, a damage-clipped
  frame of a text scene equals the full one, bit for bit.
- The port's text pipeline runs with fontTools, PIL, jax and figdraw_tpu
  blocked from import.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import figdraw_tpu as jax_pkg
import figdraw_tpu_torch as port
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu_torch import scenes
from figdraw_tpu_torch.plan import pack_walked_tape, plan_execution
from figdraw_tpu_torch.text.typefaces import bundled_font_path, load_typeface
from torch_reference import REPO, block_means, jax_text_table_scene
from test_torch_retained import _partial_hits, _patch_hits
from torch_twin import assert_runs_on_port, case_id, port_twin, run_twin

torch.set_num_threads(1)

TOL = 1.0 / 255.0
W, H = scenes.TEXT_SIZE


def _ink(pk):
    return pk.fill(pk.rgba(20, 20, 30, 255))


@pytest.fixture(scope="module")
def bench_text():
    """(port scene, port renderer after one frame, the frame)."""
    tid = load_typeface(bundled_font_path())
    scene, n = scenes.make_text_scene(tid, _ink(port), 0)
    assert n == 2330
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    frame = ren.render_frame(scene, port.vec2(W, H)).numpy()
    return scene, ren, frame


def test_bench_text_equals_the_stored_reference(bench_text):
    scene, ren, frame = bench_text
    plan = ren._walk_plan(scene, port.vec2(W, H), True, port.Color(1, 1, 1, 1))
    with np.load(scenes.TEXT_REFERENCE) as z:
        assert np.array_equal(plan.combo.view(np.uint32), z["combo"].view(np.uint32))
        assert np.array_equal(ren.atlas.data, z["atlas"])
        assert list(plan.structure) == [tuple(s[:4]) for s in json.loads(str(z["structure"]))]
        assert np.abs(block_means(frame) - z["blocks"]).max() <= TOL


def test_bench_text_equals_the_jax_packages(bench_text):
    """figdraw_tpu's own bench_text.build_scene, walked by its renderer:
    the same combo and atlas, byte for byte."""
    sys.path.insert(0, REPO)
    import bench_text as jax_bench

    from figdraw_tpu.text.typefaces import load_typeface as jax_load

    scene, ren, _frame = bench_text
    jscene, n = jax_bench.build_scene(jax_load(bundled_font_path()), _ink(jax_pkg), 0)
    assert n == 2330
    jren = JaxRenderer(atlas_size=512, use_pallas=False)
    jtape = jren.flatten(jscene, jax_pkg.vec2(W, H))
    ptape = ren.flatten(scene, port.vec2(W, H))
    assert np.array_equal(np.asarray(ptape.combo).view(np.uint32),
                          np.asarray(jtape.combo).view(np.uint32))
    assert np.array_equal(ren.atlas.data, jren.atlas.data)
    for lst, jlst in zip(scene.layers.values(), jscene.layers.values()):
        assert lst.nodes[: lst.count].tobytes() == jlst.nodes[: jlst.count].tobytes()
        assert lst.text_view()[0].tobytes() == jlst.text_view()[0].tobytes()


def test_warm_frames_reuse_the_atlas(bench_text):
    """A second frame rasterizes nothing: every glyph block was stamped."""
    scene, ren, frame = bench_text
    version = ren.atlas.entries_version
    again = ren.render_frame(scene, port.vec2(W, H)).numpy()
    assert ren.atlas.entries_version == version
    assert np.array_equal(again, frame)


def _zero_sign_equal(a, b):
    """Byte equality of two f32 arrays, +0.0 and -0.0 taken as equal."""
    wa, wb = a.view(np.uint32), b.view(np.uint32)
    diff = wa != wb
    zeros = ((wa | wb) & np.uint32(0x7FFFFFFF)) == 0
    return not (diff & ~zeros).any(), int((diff & zeros).sum())


def test_text_table_equals_the_stored_tape():
    tree = scenes.make_text_table_scene()
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    tape = ren.flatten(tree, port.vec2(W, H))
    pack_walked_tape(tape)
    with np.load(scenes.TEXT_TABLE_REFERENCE) as z:
        assert tape.count == int(z["count"]) > 30000
        assert tape.combo.shape == z["combo"].shape
        same, signed_zeros = _zero_sign_equal(tape.combo, z["combo"])
        assert same
        assert signed_zeros > 0  # the known difference, and only it
        assert np.array_equal(ren.atlas.data, z["atlas"])
        stored, _atlas, _blocks = scenes.load_text_tape()
    plan, stored_plan = plan_execution(tape), plan_execution(stored)
    assert plan.mega_combo is not None and plan.mega_atlas
    assert plan.tile_h == stored_plan.tile_h and plan.n_masks == stored_plan.n_masks
    assert _zero_sign_equal(plan.mega_combo, stored_plan.mega_combo)[0]


def test_text_table_frame_equals_the_jax_packages():
    rows, cols, w, h = 14, 3, 480, 270
    jtree = jax_text_table_scene(rows, cols, float(w), float(h))
    ptree = scenes.make_text_table_scene(rows, cols, float(w), float(h))
    jren = JaxRenderer(atlas_size=256, use_pallas=False)
    want = np.asarray(jren.render_frame(jtree, jax_pkg.vec2(w, h)))
    pren = port.FigRenderer(atlas_size=256, device="cpu")
    got = pren.render_frame(ptree, port.vec2(w, h)).numpy()
    assert np.abs(got - want).max() <= TOL
    assert np.array_equal(pren.atlas.data, jren.atlas.data)
    # the array form through the native walk draws the same frame
    arr_frame = port.FigRenderer(atlas_size=256, device="cpu").render_frame(
        port.from_renders(ptree), port.vec2(w, h)).numpy()
    assert np.abs(arr_frame - want).max() <= TOL


IMAGE_CASES = [("test_images", fn, None) for fn in (
    "test_clear_font_glyphs_allows_regeneration",
    "test_clear_image_cache_recovers_and_regenerates",
    "test_image_ref_final_release_evicts")]


@pytest.mark.parametrize("case", IMAGE_CASES, ids=[case_id(c) for c in IMAGE_CASES])
def test_image_bus_text_twin(request, monkeypatch, case):
    assert_runs_on_port(port_twin("test_images"))
    run_twin(request, monkeypatch, case)


def test_glyph_and_font_messages():
    """PutGlyph keeps a key the atlas holds, ClearTypefaceGlyphs clears a
    typeface's glyphs, a FontRef's final release clears its font's."""
    from figdraw_tpu_torch.resources import (
        FontRef, ImageMessageBus, ImageMsg, ImageMsgKind, clear_typeface_glyphs,
    )

    bus = ImageMessageBus()
    ren = port.FigRenderer(atlas_size=128, device="cpu")
    ren.ensure_image_message_subscription(bus)
    glyph = np.ones((6, 5, 4), np.float32)
    for key, font_id in ((101, 7), (102, 8)):
        bus.publish(ImageMsg(kind=ImageMsgKind.PutGlyph, id=key, image=glyph,
                             font_id=font_id, typeface_id=70))
    bus.publish(ImageMsg(kind=ImageMsgKind.PutGlyph, id=101, image=glyph * 0.5,
                         font_id=7, typeface_id=70))
    ren.process_image_messages()
    x, y, _w, _h = ren.atlas.entries[101]
    assert ren.atlas.meta[101].kind == "glyph" and ren.atlas_usage().glyph_count == 2
    a, b = FontRef(7, bus=bus), FontRef(7, bus=bus)
    a.close()
    ren.process_image_messages()
    assert 101 in ren.atlas
    b.close()
    ren.process_image_messages()
    assert 101 not in ren.atlas and 102 in ren.atlas and not ren._font_owners
    clear_typeface_glyphs(70, bus=bus)
    ren.process_image_messages()
    assert 102 not in ren.atlas


# --- trees, fragments, retained scenes ---------------------------------------------------


def _text_tree(pk, w=240, h=90):
    tf = __import__(pk.__name__ + ".text.typefaces", fromlist=["x"])
    lay = __import__(pk.__name__ + ".text.layout", fromlist=["x"])
    tid = tf.load_typeface(bundled_font_path())
    f = tf.FigFont(typeface_id=tid, size=14.0, underline=True)
    tree = pk.new_renders()
    clip = tree.add_root(0, pk.Fig(kind=pk.FigKind.nkRectangle,
                                   screen_box=pk.rect(4, 4, 200, 60),
                                   fill=pk.fill(pk.rgba(240, 240, 250, 255)),
                                   corners=(6,) * 4, flags=pk.FigFlags.NfClipContent))
    tree.add_child(0, clip, pk.Fig(
        kind=pk.FigKind.nkText, screen_box=pk.rect(10.5, 10, 260, 24),
        text_layout=lay.typeset(pk.vec2(260, 24), [(f, _ink(pk), "Clipped text runs past")])))
    tree.add_root(0, pk.Fig(
        kind=pk.FigKind.nkText, screen_box=pk.rect(8, 64, 220, 22),
        text_layout=lay.typeset(pk.vec2(220, 22), [
            (tf.FigFont(typeface_id=tid, size=13.0), _ink(pk), "selected ligature office")]),
        flags=pk.FigFlags.NfSelectText, selection_range=(3, 12),
        fill=pk.fill(pk.rgba(90, 150, 255, 120))))
    return tree, (w, h)


@pytest.mark.parametrize("form", ["1x", "pixel2", "ui2"])
def test_text_tree_walks_equal_the_native_walk(form):
    pixel, ui, mult = {"1x": (1.0, 1.0, 1), "pixel2": (2.0, 1.0, 2),
                       "ui2": (1.0, 2.0, 1)}[form]
    tree, (w, h) = _text_tree(port)
    size = port.vec2(w * mult, h * mult)
    old = port.fig_ui_scale(), jax_pkg.fig_ui_scale()
    port.set_fig_ui_scale(ui)
    jax_pkg.set_fig_ui_scale(ui)
    try:
        arr = port.from_renders(tree)
        ren = port.FigRenderer(atlas_size=256, pixel_scale=pixel, device="cpu")
        native_tape = ren.flatten(arr, port.scaled(size))
        walked = ren.flatten(port.to_renders(arr), port.scaled(size))
        pack_walked_tape(walked)
        assert walked.count == native_tape.count > 40
        assert np.array_equal(walked.combo.view(np.uint32),
                              native_tape.combo.view(np.uint32))
        assert torch.equal(ren.render_frame(port.to_renders(arr), size),
                           ren.render_frame(arr, size))
        # and figdraw_tpu's frame of the same tree
        jtree, _ = _text_tree(jax_pkg)
        jren = JaxRenderer(atlas_size=256, use_pallas=False, pixel_scale=pixel)
        want = np.asarray(jren.render_frame(jtree, jax_pkg.vec2(w * mult, h * mult)))
        got = port.FigRenderer(atlas_size=256, pixel_scale=pixel, device="cpu") \
            .render_frame(tree, size).numpy()
        assert np.abs(got - want).max() <= TOL
    finally:
        port.set_fig_ui_scale(old[0])
        jax_pkg.set_fig_ui_scale(old[1])


def _fragments(pk):
    tf = __import__(pk.__name__ + ".text.typefaces", fromlist=["x"])
    lay = __import__(pk.__name__ + ".text.layout", fromlist=["x"])
    f = tf.FigFont(typeface_id=tf.load_typeface(bundled_font_path()), size=15.0)
    fragments = pk.RenderFragments()
    root = fragments.add_root(0, pk.Fig(
        kind=pk.FigKind.nkRectangle, screen_box=pk.rect(4, 4, 150, 100),
        fill=pk.fill(pk.rgba(230, 230, 240, 255)), corners=(8,) * 4,
        flags=pk.FigFlags.NfClipContent))
    child = pk.RenderList()
    c = child.add_root(pk.Fig(kind=pk.FigKind.nkTransform,
                              transform=pk.TransformStyle(translation=pk.vec2(12.0, 7.0))))
    child.add_child(c, pk.Fig(kind=pk.FigKind.nkText, screen_box=pk.rect(10, 20, 180, 24),
                              text_layout=lay.typeset(pk.vec2(180, 24),
                                                      [(f, _ink(pk), "fragment text")])))
    fragments.insert_children((0, root), child, 0)
    return fragments, (160, 120)


def test_fragments_with_text_equal_the_jax_packages():
    jf, (w, h) = _fragments(jax_pkg)
    pf, _ = _fragments(port)
    want = np.asarray(JaxRenderer(atlas_size=256, use_pallas=False)
                      .render_frame(jf, jax_pkg.vec2(w, h)))
    got = port.FigRenderer(atlas_size=256, device="cpu").render_frame(pf, port.vec2(w, h))
    assert np.abs(got.numpy() - want).max() <= TOL
    assert (got.numpy()[..., :3] < 0.5).any()


def _retained_text(label="retained", with_reserve=False):
    from figdraw_tpu_torch.text.layout import typeset
    from figdraw_tpu_torch.text.typefaces import FigFont

    f = FigFont(typeface_id=load_typeface(bundled_font_path()), size=16.0)

    def text_fig(s, box=(16, 16, 280, 60)):
        return port.Fig(kind=port.FigKind.nkText, screen_box=port.rect(*box),
                        text_layout=typeset(port.vec2(280, 60),
                                            [(f, port.fill(port.rgba(0, 0, 0, 255)), s)]))

    renders = port.new_renders()
    renders.add_root(0, port.Fig(kind=port.FigKind.nkRectangle,
                                 screen_box=port.rect(0, 0, 320, 200),
                                 fill=port.fill(port.rgba(250, 250, 250, 255))))
    t = renders.add_root(0, text_fig(label))
    return port.from_renders(renders), t, text_fig


SIZE = port.vec2(320, 200)


def test_patch_text_scene_move_text_root(monkeypatch):
    """test_retained.test_patch_text_scene_move_text_root's twin: moving a
    text root patches in place and views as a fresh snapshot."""
    arr, t, _ = _retained_text()
    ren = port.FigRenderer(atlas_size=256, device="cpu")
    scene = ren.snapshot_scene(arr, SIZE)
    stats = _patch_hits(monkeypatch)
    arr[0].set_box(t, 40, 90, 200, 60)
    ren.update_scene(scene, arr, dirty=[(0, t)])
    assert stats["ok"] == 1
    assert torch.equal(ren.render_view(scene),
                       ren.render_view(ren.snapshot_scene(arr, SIZE)))


def test_reserved_text_label_updates_patch_in_place(monkeypatch):
    """test_retained.test_reserved_text_label_updates_patch_in_place's twin:
    labels that shrink and grow within the reserve patch in place; growth
    beyond it takes a new snapshot; each view equals a fresh snapshot's."""
    arr, t, text_fig = _retained_text("42")
    ren = port.FigRenderer(atlas_size=256, device="cpu")
    for s in ("42", "7", "1337", "123456789012"):
        probe = port.new_renders()
        probe.add_root(0, text_fig(s))
        ren._ensure_packed_glyphs(port.from_renders(probe))
    scene = ren.snapshot_scene(arr, SIZE, reserve={(0, t): 10})
    stats = _patch_hits(monkeypatch)
    for label in ("7", "1337", "42"):
        arr[0].set_node(t, text_fig(label))
        ren.update_scene(scene, arr, dirty=[(0, t)])
        assert torch.equal(ren.render_view(scene),
                           ren.render_view(ren.snapshot_scene(arr, SIZE))), label
    assert stats["ok"] == 3
    arr[0].set_node(t, text_fig("123456789012"))
    ren.update_scene(scene, arr, dirty=[(0, t)])
    assert scene.snap_args[3] == {(0, t): 10}
    assert torch.equal(ren.render_view(scene),
                       ren.render_view(ren.snapshot_scene(arr, SIZE)))


def test_partial_render_text_scene(monkeypatch):
    """test_retained.test_partial_render_text_scene's twin: a damage-clipped
    frame of a text scene equals the full render bit for bit."""
    arr, t, _ = _retained_text()
    ren = port.FigRenderer(atlas_size=256, device="cpu")
    scene = ren.snapshot_scene(arr, SIZE)
    ren.render_view(scene)
    hits = _partial_hits(monkeypatch)
    arr[0].set_box(t, 30, 100, 200, 60)
    ren.update_scene(scene, arr, dirty=[(0, t)])
    got = ren.render_view(scene)
    assert hits["n"] == 1
    fresh = ren.render_view(ren.snapshot_scene(arr, SIZE))
    assert torch.equal(got, fresh)


def test_new_glyphs_in_a_patch_take_a_new_snapshot(monkeypatch):
    """A label edit that needs glyphs the atlas lacks grows the atlas, so
    update_scene takes a new snapshot (its rows would sample an older
    generation otherwise) and still views as a fresh one."""
    arr, t, text_fig = _retained_text("abc")
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    scene = ren.snapshot_scene(arr, SIZE)
    generation = ren.atlas.generation
    stats = _patch_hits(monkeypatch)
    arr[0].set_node(t, text_fig("XYZ WQ jumps"))
    ren.update_scene(scene, arr, dirty=[(0, t)])
    assert ren.atlas.generation != generation and stats["ok"] == 0
    assert torch.equal(ren.render_view(scene),
                       ren.render_view(ren.snapshot_scene(arr, SIZE)))


def test_text_pipeline_runs_without_fonttools_or_pil():
    """The card's machine has no fontTools and no PIL: the port's text
    scenes build, typeset, rasterize and render with both (and jax and
    figdraw_tpu) blocked from import."""
    code = r"""
import sys
for name in ("fontTools", "PIL", "jax", "figdraw_tpu"):
    sys.modules[name] = None
import numpy as np, torch
torch.set_num_threads(1)
import figdraw_tpu_torch as port
from figdraw_tpu_torch import scenes
from figdraw_tpu_torch.text.typefaces import bundled_font_path, load_typeface
from figdraw_tpu_torch.text.typeface_info import get_typeface_info
tid = load_typeface(bundled_font_path())
scene, n = scenes.make_text_scene(tid, port.fill(port.rgba(20, 20, 30, 255)), 0,
                                  w=400, h=120, lines=4)
frame = port.FigRenderer(atlas_size=256, device="cpu").render_frame(
    scene, port.vec2(400, 120)).numpy()
table = scenes.make_text_table_scene(4, 2, 300.0, 140.0, tid=tid)
frame2 = port.FigRenderer(atlas_size=256, device="cpu").render_frame(
    table, port.vec2(300, 140)).numpy()
info = get_typeface_info(tid)
assert n > 100 and (frame[..., 0] < 0.5).any() and (frame2[..., 0] < 0.5).any()
assert info.family == "DejaVu Sans" and info.glyph_count == 6253
assert not [m for m in sys.modules if m.split(".")[0] in ("fontTools", "PIL", "jax")
            and sys.modules[m] is not None]
print("ok", n)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().startswith("ok")
