"""Tree-form scenes through figdraw_tpu_torch's Python walk, against
figdraw_tpu and against the port's own native walk.

Each scene is built twice from the same numbers, once by each package's
own API (or, for the fuzz scenes, carried across as
port.to_renders(to_port(figdraw_tpu.nodesarray.from_renders(tree)))):

- the port's Python-walk tape equals the JAX Python walk's: items, modes
  and the quad fields as numbers, and bit for bit but for the sign of
  zero. (The JAX walk snaps vertices to Python ints, so an axis-aligned
  quad's zero edge term is +0.0 where the C++ walk writes -0.0; the port
  snaps to floats, as the C++ walk does. tape.TapeBackend._pos_quad);
- the port's Python walk of to_renders(from_renders(tree)) and its native
  walk of from_renders(tree) plan to the same packed combo, byte for byte,
  with the same structure, tile height and megakernel combo
  (tests/test_native_flatten.py's contract, with the plan's bytes), and the
  native export's structure cache and tile density agree with what the
  planner derives from a walked tape's rows;
- from_renders of the port's tree equals figdraw_tpu's node rows and ops
  byte for byte;
- the port's planner gives a walked tape the combo bytes, tile height,
  structure and megakernel combo figdraw_tpu's renderer gives the same
  tape;
- frames within 1/255 of figdraw_tpu's (use_pallas=False), also at
  pixel_scale=2 and at UI scale 2, for trees and for RenderFragments;
- a text node renders on every path, the Python walk's tape equal to the
  native walk's (tests/test_torch_text_scenes.py holds text to figdraw_tpu);
- the saturation cull of the native walk against test_hostcull.py's numpy
  reference on the port's Python-walk tape.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

import figdraw_tpu as jax_pkg
import figdraw_tpu_torch as port
from figdraw_tpu.nodesarray import from_renders as jax_from_renders
from figdraw_tpu.nodesarray import to_renders as jax_to_renders
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu.tape import BlurItem, ClearMaskItem, DrawItem
from figdraw_tpu.tape import Tape as JaxTape
from figdraw_tpu_torch import plan as port_plan
from torch_reference import REPO, to_port

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

TOL = 1.0 / 255.0


# --- the scenes, each built by either package's API -------------------------------


def _drawable_fig(pk, ops, weight=3.0, cap=None, join=None, draw_steps=0,
                  draw_aa=0.0):
    """tests/test_native_flatten.py's _drawable_fig."""
    cap = pk.StrokeCap.scAuto if cap is None else cap
    join = pk.StrokeJoin.sjAuto if join is None else join
    return pk.Fig(kind=pk.FigKind.nkDrawable, screen_box=pk.rect(10, 10, 200, 150),
                  draw_ops=tuple(ops), draw_steps=draw_steps, draw_aa=draw_aa,
                  draw_stroke=pk.RenderStroke(weight=weight,
                                              fill=pk.fill(pk.rgba(20, 40, 200, 255)),
                                              cap=cap, join=join))


def headline(pk):
    scenes = importlib.import_module(pk.__name__ + ".scenes")
    return scenes.make_render_tree(320.0, 240.0, 3, copies=4), (320, 240)


def masks_transforms(pk):
    """test_native_flatten.test_native_matches_python_masks_and_transforms."""
    renders = pk.new_renders()
    clip = renders.add_root(0, pk.Fig(
        kind=pk.FigKind.nkRectangle, screen_box=pk.rect(10, 10, 100, 80),
        corners=(9, 9, 9, 9), flags=pk.FigFlags.NfClipContent,
        fill=pk.fill(pk.rgba(200, 200, 200, 255))))
    renders.add_child(0, clip, pk.Fig(
        kind=pk.FigKind.nkRectangle, screen_box=pk.rect(0, 0, 300, 300),
        fill=pk.fill(pk.rgba(255, 0, 0, 128))))
    rm = renders.add_root(0, pk.Fig(
        kind=pk.FigKind.nkRectangle, screen_box=pk.rect(40, 30, 90, 70),
        corners=(5, 5, 5, 5), flags=pk.FigFlags.NfRectMaskContent,
        fill=pk.fill(pk.rgba(0, 0, 200, 200))))
    renders.add_child(0, rm, pk.Fig(
        kind=pk.FigKind.nkRectangle, screen_box=pk.rect(0, 0, 300, 300),
        fill=pk.fill(pk.rgba(0, 255, 0, 100)), rotation=15.0))
    tr = renders.add_root(0, pk.Fig(
        kind=pk.FigKind.nkTransform,
        transform=pk.TransformStyle(translation=pk.vec2(7.0, -3.0),
                                    matrix=pk.Mat3.scaling(1.5, 0.75))))
    renders.add_child(0, tr, pk.Fig(
        kind=pk.FigKind.nkRectangle, screen_box=pk.rect(20, 20, 40, 40),
        stroke=pk.RenderStroke(weight=3.0, fill=pk.fill(pk.rgba(0, 0, 0, 255))),
        fill=pk.fill(pk.rgba(255, 255, 0, 255))))
    return renders, (200, 150)


def drawable_lines_shapes(pk):
    """test_native_flatten.test_native_drawable_lines_and_shapes_parity."""
    renders = pk.new_renders()
    for i, cap in enumerate([pk.StrokeCap.scAuto, pk.StrokeCap.scRound,
                             pk.StrokeCap.scButt, pk.StrokeCap.scSquare]):
        renders.add_root(0, _drawable_fig(
            pk, [pk.drawable_line(pk.vec2(5 + i * 3, 7), pk.vec2(90, 60 + i * 9))],
            cap=cap))
    shapes = _drawable_fig(pk, [
        pk.drawable_circle(pk.vec2(40, 40), 17.25),
        pk.drawable_rect(pk.rect(70, 20, 50, 34), corners=(4, 4, 4, 4)),
        pk.drawable_ellipse(pk.vec2(60, 100), pk.vec2(30, 18)),
    ], weight=2.0)
    shapes.fill = pk.fill(pk.rgba(230, 120, 40, 180))
    renders.add_root(0, shapes)
    rot = _drawable_fig(pk, [pk.drawable_line(pk.vec2(0, 0), pk.vec2(80, 20))])
    rot.rotation = 30.0
    renders.add_root(0, rot)
    return renders, (320, 240)


def drawable_bezier_arc(pk):
    """test_native_flatten.test_native_drawable_bezier_arc_parity."""
    v = pk.vec2
    renders = pk.new_renders()
    quad = [v(5, 120), v(70, -40), v(150, 110)]
    cubic = [v(0, 0), v(40, 130), v(110, -60), v(160, 70)]
    add = lambda *a, **k: renders.add_root(0, _drawable_fig(pk, *a, **k))
    add([pk.drawable_bezier(quad)])
    add([pk.drawable_bezier(cubic)], cap=pk.StrokeCap.scButt,
        join=pk.StrokeJoin.sjBevel)
    add([pk.drawable_bezier(cubic)], cap=pk.StrokeCap.scSquare,
        join=pk.StrokeJoin.sjMiter)
    add([pk.drawable_bezier(cubic, steps=5)])
    add([pk.drawable_bezier(cubic)], draw_steps=3)
    add([pk.drawable_bezier([v(4, 4), v(120, 90)])], join=pk.StrokeJoin.sjMiter)
    add([pk.drawable_bezier([v(0, 0), v(50, 25), v(100, 50)])])
    add([pk.drawable_arc(v(80, 80), 45.0, 0.4, 4.0)])
    add([pk.drawable_arc(v(80, 80), 45.0, -0.3, -2.5, steps=4)],
        cap=pk.StrokeCap.scButt, join=pk.StrokeJoin.sjBevel)
    g2 = _drawable_fig(pk, [pk.drawable_bezier(quad)])
    g2.draw_stroke = pk.RenderStroke(weight=3.0, fill=pk.linear(
        pk.rgba(255, 0, 0, 255), pk.rgba(0, 0, 255, 255),
        axis=pk.FillGradientAxis.fgaY))
    renders.add_root(0, g2)
    g3 = _drawable_fig(pk, [pk.drawable_bezier(quad)])
    g3.draw_stroke = pk.RenderStroke(weight=3.0, fill=pk.linear(
        pk.rgba(255, 0, 0, 255), pk.rgba(0, 255, 0, 255), pk.rgba(0, 0, 255, 255),
        mid_pos=80))
    renders.add_root(0, g3)
    add([pk.drawable_bezier(quad)], draw_aa=2.0)
    return renders, (320, 240)


IMAGE_ID, SDF_ID = 321, 654


def _images():
    img = np.zeros((16, 16, 4), np.uint8)
    img[:8] = (255, 0, 0, 255)
    img[8:] = (0, 0, 255, 255)
    sdf = (np.ones((16, 16, 4)) * 0.6).astype(np.float32)
    return ((IMAGE_ID, img, True), (SDF_ID, sdf, False))


def images_msdf(pk):
    """test_native_flatten.test_native_image_and_msdf_parity: images 1:1,
    flipped, minified onto a mip level and trilinear, MSDF and MTSDF."""
    renders = pk.new_renders()
    lst = renders[0]
    lst.add_root(pk.Fig(kind=pk.FigKind.nkRectangle, screen_box=pk.rect(0, 0, 120, 90),
                        fill=pk.fill(pk.rgba(255, 255, 255, 255))))
    for box, flags in (((8, 8, 32, 32), 0), ((48, 8, 32, 32), pk.FigFlags.NfInvertY),
                       ((88, 8, 4, 4), 0), ((96, 8, 10, 10), 0)):
        lst.add_root(pk.Fig(kind=pk.FigKind.nkImage, screen_box=pk.rect(*box),
                            flags=flags, image=pk.image_style(IMAGE_ID)))
    lst.add_root(pk.Fig(kind=pk.FigKind.nkMsdfImage, screen_box=pk.rect(8, 48, 32, 32),
                        msdf_image=pk.MsdfImageStyle(
                            id=SDF_ID, fill=pk.fill(pk.rgba(0, 0, 0, 255)),
                            px_range=4.0)))
    lst.add_root(pk.Fig(kind=pk.FigKind.nkMtsdfImage, screen_box=pk.rect(48, 48, 32, 32),
                        mtsdf_image=pk.MsdfImageStyle(
                            id=SDF_ID, fill=pk.fill(pk.rgba(0, 0, 0, 255)),
                            px_range=4.0, stroke_weight=2.0)))
    return renders, (120, 90)


def _bench_clipmask_table(pk, kind):
    """bench_clipmask.make_table_scene at 12x6 cells, 320x200: the port's
    scenes.make_table_scene, figdraw_tpu's the benchmark's own function."""
    if pk is port:
        return port.scenes.make_table_scene(kind, 320.0, 200.0, 12, 6), (320, 200)
    sys.path.insert(0, REPO)
    import bench_clipmask

    rows, cols = bench_clipmask.ROWS, bench_clipmask.COLS
    bench_clipmask.ROWS, bench_clipmask.COLS = 12, 6
    try:
        return bench_clipmask.make_table_scene(kind, 320.0, 200.0), (320, 200)
    finally:
        bench_clipmask.ROWS, bench_clipmask.COLS = rows, cols


def rectmask_table(pk):
    return _bench_clipmask_table(pk, "rectmask")


def subclip_table(pk):
    return _bench_clipmask_table(pk, "subclip")


def borders(pk):
    """test_misc.test_border_figs_render's scene."""
    lst = pk.RenderList()
    lst.add_root(pk.fig_dashed_rounded_rect_border(
        pk.rect(10, 10, 60, 40), (8, 8, 8, 8), pk.fill(pk.rgba(200, 30, 30, 255)),
        weight=4.0, dash_length=8.0, gap_length=6.0))
    lst.add_root(pk.fig_dotted_rounded_rect_border(
        pk.rect(20, 20, 40, 25), (5, 5, 5, 5), pk.fill(pk.rgba(30, 30, 200, 255)),
        weight=4.0, gap_length=4.0))
    r = pk.new_renders()
    r.set_layer(0, lst)
    return r, (96, 64)


def _example(name):
    def build(pk):
        if pk is port:
            make, size = port.scenes.EXAMPLE_SCENES[name]
            return make(*size), size
        from torch_reference import jax_example_scene

        return jax_example_scene(name)

    return build


def _fuzz(seed):
    """tests/test_fuzz.py's random scene (clips, rect masks, shadows,
    gradients, drawables, rotations), carried across as arrays."""
    def build(pk):
        from tests.test_fuzz import random_scene

        arr = jax_from_renders(random_scene(seed))
        if pk is port:
            return port.to_renders(to_port(arr)), (200, 140)
        return jax_to_renders(arr), (200, 140)

    return build


SCENES = {
    "headline": headline,
    "masks_transforms": masks_transforms,
    "drawable_lines_shapes": drawable_lines_shapes,
    "drawable_bezier_arc": drawable_bezier_arc,
    "images_msdf": images_msdf,
    "rectmask_table": rectmask_table,
    "subclip_table": subclip_table,
    "borders": borders,
    "layers_clip": _example("layers_clip"),
    "drawable_beziers": _example("drawable_beziers"),
    "dashed_borders": _example("dashed_borders"),
    "fuzz_7": _fuzz(7),
    "fuzz_4242": _fuzz(4242),
}


def _jax_renderer(use_pallas=False, **kw):
    from figdraw_tpu.resources import ImageMessageBus, put_image

    ren = JaxRenderer(atlas_size=128, use_pallas=use_pallas, **kw)
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    for image_id, img, mip in _images():
        put_image(image_id, img, bus=bus, mipmapped=mip)
    ren.process_image_messages()
    return ren


def _port_renderer(**kw):
    from figdraw_tpu_torch.resources import ImageMessageBus, put_image

    ren = port.FigRenderer(atlas_size=128, device="cpu", **kw)
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    for image_id, img, mip in _images():
        put_image(image_id, img, bus=bus, mipmapped=mip)
    ren.process_image_messages()
    return ren


def _items(tape):
    out = []
    for it in tape.items:
        if hasattr(it, "start"):
            out.append(("draw", it.target, it.start, it.end))
        elif hasattr(it, "radius"):
            out.append(("blur", float(np.float32(it.radius))))
        else:
            out.append(("clear", it.index))
    return out


def _zero_canon(a):
    """f32 bits with -0.0 as +0.0."""
    a = np.array(a, np.float32)
    a[a == 0] = 0.0
    return a.view(np.uint32)


# --- tapes ------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENES))
def test_python_walk_matches_jax_walk(name):
    jtree, (w, h) = SCENES[name](jax_pkg)
    ptree, size = SCENES[name](port)
    assert size == (w, h)
    jt = _jax_renderer().flatten(jtree, jax_pkg.vec2(w, h))
    pt = _port_renderer().flatten(ptree, port.vec2(w, h))
    assert pt.structure_cache is None and pt.combo is None  # a walked tape
    assert (pt.count, pt.mask_count) == (jt.count, jt.mask_count)
    assert pt.count > 0
    assert _items(pt) == _items(jt)
    np.testing.assert_array_equal(pt.modes[: pt.count], jt.modes[: jt.count])
    pf, jf = pt.fields[: pt.count], jt.fields[: jt.count]
    assert np.array_equal(pf, jf)
    assert np.array_equal(_zero_canon(pf), _zero_canon(jf))
    assert pt.clear_color == jt.clear_color and pt.frame_size == jt.frame_size


@pytest.mark.parametrize("name", list(SCENES))
def test_python_walk_matches_native_walk(name):
    """to_renders(from_renders(tree)) through the Python walk and
    from_renders(tree) through the native walk: the same plan, byte for
    byte."""
    ptree, (w, h) = SCENES[name](port)
    arr = port.from_renders(ptree)
    ren_py, ren_nat = _port_renderer(), _port_renderer()
    py_tape = ren_py.flatten(port.to_renders(arr), port.vec2(w, h))
    nat_tape = ren_nat.flatten(arr, port.vec2(w, h))
    assert _items(py_tape) == _items(nat_tape)
    assert (py_tape.count, py_tape.mask_count) == (nat_tape.count, nat_tape.mask_count)
    py_plan, nat_plan = (port_plan.plan_execution(t) for t in (py_tape, nat_tape))
    assert py_tape.combo.tobytes() == nat_tape.combo.tobytes()
    assert py_plan.combo.tobytes() == nat_plan.combo.tobytes()
    assert py_plan.structure == nat_plan.structure
    assert (py_plan.bounds, py_plan.radii) == (nat_plan.bounds, nat_plan.radii)
    assert py_plan.tile_h == nat_plan.tile_h
    assert (py_plan.mega_combo is None) == (nat_plan.mega_combo is None)
    if py_plan.mega_combo is not None:
        assert py_plan.mega_combo.tobytes() == nat_plan.mega_combo.tobytes()
    # the native export's structure cache and density against what the
    # planner derives from the rows (test_native_flatten's structure-cache
    # and density cases)
    structure, bounds, radii, any_atlas, any_backdrop = nat_tape.structure_cache
    s2, b2, r2, is_atlas, is_bd = port_plan.tape_structure(
        nat_tape, nat_tape.modes[: nat_tape.count])
    assert structure == s2 and [tuple(b) for b in bounds] == b2 and radii == r2
    assert (any_atlas, any_backdrop) == (bool(is_atlas.any()), bool(is_bd.any()))
    assert port_plan.tile_h_from_density(*nat_tape.tile_density, h, w) == \
        port_plan.pick_tile_h(nat_tape.fields, nat_tape.count, h, w)


@pytest.mark.parametrize("name", ["headline", "masks_transforms", "drawable_bezier_arc"])
def test_walks_match_at_ui_scale_2(name):
    """test_native_flatten.test_native_ui_scale: at UI scale 2 (both
    packages' scales set, and restored) the port's Python walk equals the
    JAX Python walk's tape and, after the array round trip, the native
    walk's packed combo byte for byte."""
    jtree, (w, h) = SCENES[name](jax_pkg)
    ptree, _size = SCENES[name](port)
    old = (port.fig_ui_scale(), jax_pkg.fig_ui_scale())
    port.set_fig_ui_scale(2.0)
    jax_pkg.set_fig_ui_scale(2.0)
    try:
        jt = _jax_renderer().flatten(jtree, jax_pkg.vec2(2 * w, 2 * h))
        pt = _port_renderer().flatten(ptree, port.vec2(2 * w, 2 * h))
        arr = port.from_renders(ptree)
        py_tape = _port_renderer().flatten(port.to_renders(arr), port.vec2(2 * w, 2 * h))
        nat_tape = _port_renderer().flatten(arr, port.vec2(2 * w, 2 * h))
    finally:
        port.set_fig_ui_scale(old[0])
        jax_pkg.set_fig_ui_scale(old[1])
    assert _items(pt) == _items(jt) and pt.count == jt.count > 0
    assert np.array_equal(pt.fields[: pt.count], jt.fields[: jt.count])
    np.testing.assert_array_equal(pt.modes[: pt.count], jt.modes[: jt.count])
    assert (port_plan.plan_execution(py_tape).combo.tobytes()
            == port_plan.plan_execution(nat_tape).combo.tobytes())


@pytest.mark.parametrize("name", [n for n in SCENES if not n.startswith("fuzz")])
def test_from_renders_matches_jax(name):
    jtree, _size = SCENES[name](jax_pkg)
    ptree, _size = SCENES[name](port)
    ja, pa = jax_from_renders(jtree), port.from_renders(ptree)
    assert sorted(ja.layers) == sorted(pa.layers)
    for lvl, jl in ja.sorted_pairs():
        pl = pa.layers[lvl]
        assert pl.view().tobytes() == jl.view().tobytes()
        assert pl.root_ids == jl.root_ids
        (jo, jp), (po, pp) = jl.ops_view(), pl.ops_view()
        assert po.tobytes() == jo.tobytes() and pp.tobytes() == jp.tobytes()


def _as_jax_tape(pt):
    """The port's walked tape as a figdraw_tpu Tape (same rows and items)."""
    jt = JaxTape(capacity=max(pt.count, 1))
    jt.fields[: pt.count] = pt.fields[: pt.count]
    jt.modes[: pt.count] = pt.modes[: pt.count]
    jt.count = pt.count
    jt.mask_count = pt.mask_count
    jt.frame_size = pt.frame_size
    jt.clear_color = pt.clear_color
    for it in pt.items:
        if hasattr(it, "start"):
            jt.items.append(DrawItem(target=it.target, start=it.start, end=it.end))
        elif hasattr(it, "radius"):
            jt.items.append(BlurItem(radius=it.radius))
        else:
            jt.items.append(ClearMaskItem(index=it.index))
    return jt


@pytest.mark.parametrize("name", list(SCENES))
def test_plan_matches_jax_planner(name):
    """The port's planner on a walked tape against figdraw_tpu's
    renderer._plan_execution on the same tape (its Pallas route, which
    builds the megakernel combo of a long tape without atlas quads)."""
    ptree, (w, h) = SCENES[name](port)
    pt = _port_renderer().flatten(ptree, port.vec2(w, h))
    jplan = _jax_renderer(use_pallas=True)._plan_execution(_as_jax_tape(pt))
    plan = port_plan.plan_execution(pt)
    assert plan.combo.tobytes() == np.asarray(jplan.combo).tobytes()
    assert plan.tile_h == jplan.tile_h
    assert list(plan.structure) == [tuple(s[:4]) if s[0] == "draw" else tuple(s)
                                    for s in jplan.structure]
    assert [tuple(b) for b in plan.bounds] == [tuple(b) for b in jplan.bounds]
    assert [float(r) for r in plan.radii] == [float(r) for r in jplan.radii]
    if jplan.mega_combo is not None:
        assert plan.mega_combo.tobytes() == np.asarray(jplan.mega_combo).tobytes()
    if name == "subclip_table":
        assert plan.mega_combo is not None and jplan.mega_combo is not None


# --- frames -----------------------------------------------------------------------


def _frame_close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol, err
    return err


# the frames' scenes: each drives another stage of the walk and the plan
# (the blur and its backdrop, clip planes, the rect-mask path, the
# megakernel, transforms, drawables with caps, images from the atlas)
FRAME_SCENES = ["headline", "masks_transforms", "drawable_lines_shapes",
                "images_msdf", "rectmask_table", "subclip_table", "borders"]


@pytest.mark.parametrize("name", FRAME_SCENES)
def test_tree_frame_matches_jax(name):
    jtree, (w, h) = SCENES[name](jax_pkg)
    ptree, _size = SCENES[name](port)
    want = _jax_renderer().render_frame(jtree, jax_pkg.vec2(w, h))
    got = _port_renderer().render_frame(ptree, port.vec2(w, h))
    _frame_close(got, want)


@pytest.mark.parametrize("name", ["headline", "rectmask_table", "subclip_table"])
def test_tree_frame_equals_array_frame(name):
    """to_renders(from_renders(tree)) and from_renders(tree) render the same
    frame on the port: the Python walk's tape and the planner against the
    native walk (for the sub-clip table its own megakernel export), the
    same plain kernels. (The tree itself may differ from both by whole
    pixels: its float64 coordinates round to float32 in the arrays, which
    can move a ceil-snapped edge.)"""
    ptree, (w, h) = SCENES[name](port)
    arr = port.from_renders(ptree)
    a = _port_renderer().render_frame(port.to_renders(arr), port.vec2(w, h))
    b = _port_renderer().render_frame(arr, port.vec2(w, h))
    assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["pixel2", "ui2"])
def test_scaled_frame_matches_jax(form):
    """pixel_scale=2 into a frame of twice the size, and UI scale 2 (both
    packages' scales set alike, and restored), against figdraw_tpu."""
    jtree, (w, h) = SCENES["masks_transforms"](jax_pkg)
    ptree, _size = SCENES["masks_transforms"](port)
    ps, ui, mult = port.scenes.EXAMPLE_FORMS[form]
    old = (port.fig_ui_scale(), jax_pkg.fig_ui_scale())
    port.set_fig_ui_scale(ui)
    jax_pkg.set_fig_ui_scale(ui)
    try:
        want = _jax_renderer(pixel_scale=ps).render_frame(
            jtree, jax_pkg.vec2(w * mult, h * mult))
        ren = _port_renderer(pixel_scale=ps)
        got = ren.render_frame(ptree, port.vec2(w * mult, h * mult))
        # the array form through the native walk takes the same scales
        arr_frame = _port_renderer(pixel_scale=ps).render_frame(
            port.from_renders(ptree), port.vec2(w * mult, h * mult))
    finally:
        port.set_fig_ui_scale(old[0])
        jax_pkg.set_fig_ui_scale(old[1])
    assert tuple(got.shape) == (2 * h, 2 * w, 4)
    _frame_close(got, want)
    assert torch.equal(got, arr_frame)


def _fragments(pk):
    """A RenderFragments: a base tree with a transform root whose children
    come from a fragment, and a fragment of clipped boxes."""
    fragments = pk.RenderFragments()
    root = fragments.add_root(0, pk.Fig(
        kind=pk.FigKind.nkRectangle, screen_box=pk.rect(4, 4, 150, 100),
        fill=pk.fill(pk.rgba(230, 230, 240, 255)), corners=(8,) * 4,
        flags=pk.FigFlags.NfClipContent))
    child = pk.RenderList()
    c = child.add_root(pk.Fig(
        kind=pk.FigKind.nkTransform,
        transform=pk.TransformStyle(translation=pk.vec2(12.0, 7.0))))
    child.add_child(c, pk.Fig(
        kind=pk.FigKind.nkRectangle, screen_box=pk.rect(20, 20, 160, 30),
        fill=pk.fill(pk.rgba(200, 40, 40, 200)), corners=(6,) * 4))
    child.add_root(pk.Fig(
        kind=pk.FigKind.nkRectangle, screen_box=pk.rect(60, 50, 50, 70),
        fill=pk.fill(pk.rgba(40, 90, 220, 255)), rotation=20.0))
    fragments.insert_children((0, root), child, 0)
    return fragments, (160, 120)


def test_fragments_frame_matches_jax():
    jf, (w, h) = _fragments(jax_pkg)
    pf, _size = _fragments(port)
    want = _jax_renderer().render_frame(jf, jax_pkg.vec2(w, h))
    got = _port_renderer().render_frame(pf, port.vec2(w, h))
    _frame_close(got, want)
    jt = _jax_renderer().flatten(jf, jax_pkg.vec2(w, h))
    pt = _port_renderer().flatten(pf, port.vec2(w, h))
    assert _items(pt) == _items(jt) and pt.count == jt.count
    assert np.array_equal(pt.fields[: pt.count], jt.fields[: jt.count])


def test_snapshot_of_a_tree_views_like_its_frame():
    """snapshot_scene takes a tree through the Python walk (no root spans:
    no root_transforms, and update_scene takes a new snapshot)."""
    ptree, (w, h) = SCENES["headline"](port)
    ren = _port_renderer()
    scene = ren.snapshot_scene(ptree, port.vec2(w, h))
    assert scene.spans is None and scene.anim_spans is None
    view = ren.render_view(scene)
    assert torch.equal(view, _port_renderer().render_frame(ptree, port.vec2(w, h)))
    with pytest.raises(ValueError):
        ren.render_view(scene, root_transforms={0: (1, 0, 0, 1, 2, 0)})
    ren.update_scene(scene, ptree, dirty=[(0, 1)])
    assert torch.equal(ren.render_view(scene), view)


# --- text ---------------------------------------------------------------------------


def test_text_tree_raises_on_every_path():
    """Text has landed on every path: a text node with a layout renders
    through render_frame, flatten, snapshot_scene and from_renders, the
    Python walk's tape equal to the native walk's of the same arrays byte
    for byte; a text row without a layout draws nothing on either walk."""
    from figdraw_tpu_torch.text.layout import typeset
    from figdraw_tpu_torch.text.typefaces import FigFont, bundled_font_path, load_typeface

    renders = port.new_renders()
    renders.add_root(0, port.Fig(kind=port.FigKind.nkRectangle,
                                 screen_box=port.rect(0, 0, 60, 40),
                                 fill=port.fill(port.rgba(255, 255, 255, 255))))
    f = FigFont(typeface_id=load_typeface(bundled_font_path()), size=12.0)
    renders.add_root(0, port.Fig(kind=port.FigKind.nkText,
                                 screen_box=port.rect(4, 4, 50, 20),
                                 text_layout=typeset(port.vec2(50, 20), [
                                     (f, port.fill(port.rgba(0, 0, 0, 255)), "Ab")])))
    ren = _port_renderer()
    frame = ren.render_frame(renders, port.vec2(60, 40))
    assert (frame[..., 0] < 0.5).any()
    walked = ren.flatten(renders, port.vec2(60, 40))
    arr = port.from_renders(renders)
    native_tape = ren.flatten(arr, port.vec2(60, 40))
    port_plan.pack_walked_tape(walked)
    assert np.array_equal(walked.combo.view(np.uint32), native_tape.combo.view(np.uint32))
    scene = ren.snapshot_scene(arr, port.vec2(60, 40))
    assert torch.equal(ren.render_view(scene), ren.render_frame(arr, port.vec2(60, 40)))
    # a text row written column by column: no layout, nothing drawn
    raw = port.RendersArray()
    i = raw[0].add_root_raw()
    raw[0].nodes["kind"][i] = int(port.FigKind.nkText)
    blank = ren.render_frame(raw, port.vec2(60, 40))
    assert torch.equal(blank, ren.render_frame(port.to_renders(raw), port.vec2(60, 40)))
    assert torch.equal(blank, torch.ones_like(blank))


def test_all_kinds_native_and_rejection_path():
    """test_native_flatten.test_all_kinds_native_and_rejection_path: every
    FigKind is a native kind, and a row of an unknown kind value is refused
    (the port raises where figdraw_tpu falls back)."""
    from figdraw_tpu_torch.nodesarray import NATIVE_KINDS

    assert {int(k) for k in port.FigKind} <= NATIVE_KINDS
    renders = port.new_renders()
    renders.add_root(0, port.Fig(kind=port.FigKind.nkRectangle,
                                 screen_box=port.rect(0, 0, 4, 4)))
    arr = port.from_renders(renders)
    arr.layers[0].nodes[0]["kind"] = 99  # not a FigKind
    assert not arr.all_native_kinds()
    with pytest.raises(ValueError, match="native walk does not handle"):
        _port_renderer().render_frame(arr, port.vec2(4, 4))


# --- the saturation cull (test_hostcull.py) --------------------------------------------


def _dense_stack(pk, n_boxes, w=256, h=128):
    """test_hostcull._dense_stack_scene with either package's API."""
    lst = pk.RenderList()
    for i in range(n_boxes):
        lst.add_root(pk.Fig(kind=pk.FigKind.nkRectangle,
                            screen_box=pk.rect(-20.0 + (i % 7), -20.0 + (i % 11),
                                               w + 40.0, h + 40.0),
                            corners=(3,) * 4,
                            fill=pk.fill(pk.rgba((i * 37) % 255, (i * 91) % 255,
                                                 (i * 53) % 255, 155))))
    r = pk.new_renders()
    r.set_layer(0, lst)
    return r


def test_native_cull_matches_numpy_reference():
    """The native walk's drop decisions and compaction equal test_hostcull's
    numpy reference applied to the port's uncompacted Python-walk tape."""
    from tests.test_hostcull import MIN_QUADS, numpy_cull

    arr = port.from_renders(_dense_stack(port, 4200))
    culled = port.FigRenderer(atlas_size=64, device="cpu").flatten(
        arr, port.vec2(256, 128))
    py_tape = port.FigRenderer(atlas_size=64, device="cpu").flatten(
        port.to_renders(arr), port.vec2(256, 128))
    assert py_tape.count >= MIN_QUADS > culled.count
    rf, rm, ritems = numpy_cull(py_tape.fields[: py_tape.count],
                                py_tape.modes[: py_tape.count], py_tape.items,
                                256.0, 128.0)
    assert culled.count == rf.shape[0]
    np.testing.assert_array_equal(culled.fields[: culled.count], rf)
    np.testing.assert_array_equal(culled.modes[: culled.count], rm)
    assert ([(it.target, it.start, it.end) for it in culled.items if hasattr(it, "start")]
            == [(it.target, it.start, it.end) for it in ritems if hasattr(it, "start")])


def test_cull_preserves_pixels_and_small_scenes_untouched():
    """The culled frame of a deep translucent stack within one display
    quantum of the full one (flatten(cull=False)); under MIN_QUADS the cull
    leaves the tape as it is."""
    from tests.test_hostcull import MIN_QUADS

    size = port.vec2(256, 128)
    arr = port.from_renders(_dense_stack(port, 4200))
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    culled = ren.render_frame(arr, size).numpy()
    full = port.FigRenderer(atlas_size=64, device="cpu")
    full_frame = full.execute(full.flatten(arr, size, cull=False)).numpy()
    u8 = lambda x: (np.clip(x, 0, 1) * 255).round().astype(np.int32)
    assert np.abs(u8(culled) - u8(full_frame)).max() <= 1
    small = port.from_renders(_dense_stack(port, 200))
    t1 = port.FigRenderer(atlas_size=64, device="cpu").flatten(small, size)
    t0 = port.FigRenderer(atlas_size=64, device="cpu").flatten(small, size, cull=False)
    assert t0.count == t1.count < MIN_QUADS
    np.testing.assert_array_equal(t0.fields[: t0.count], t1.fields[: t1.count])


# --- render_view's root transforms as Mat3 and root_affine ------------------------------


def test_render_view_takes_mat3_and_root_affine():
    """On an animated snapshot of from_renders(tree): a {key: Mat3} and a
    {key: root_affine(...)} table give the view of the same (R, 6) table bit
    for bit, and the Mat3 view matches figdraw_tpu's render_view given the
    same Mat3s within 1/255."""
    from figdraw_tpu.geometry import Mat3 as JaxMat3

    jtree, (w, h) = SCENES["headline"](jax_pkg)
    ptree, _size = SCENES["headline"](port)
    ren = _port_renderer()
    scene = ren.snapshot_scene(port.from_renders(ptree), port.vec2(w, h), animate=True)
    keys = scene.animation_order()
    rows = {2: (1.0, 0.0, 12.0, 0.0, 1.0, -5.0), 5: (2.0, 0.0, -30.0, 0.0, 0.5, 40.0)}
    table = np.zeros((len(keys), 6), np.float32)
    table[:, 0] = table[:, 3] = 1.0
    for i, (a, b, tx, c, d, ty) in rows.items():
        table[i] = (a, b, c, d, tx, ty)
    bulk = ren.render_view(scene, (3.0, -2.0), root_transforms=table)
    mats = {keys[i]: port.Mat3(*r) for i, r in rows.items()}
    assert torch.equal(ren.render_view(scene, (3.0, -2.0), root_transforms=mats), bulk)
    aff = {keys[2]: port.root_affine((12.0, -5.0)),
           keys[5]: port.root_affine((-30.0, 40.0), scale=(2.0, 0.5))}
    assert torch.equal(ren.render_view(scene, (3.0, -2.0), root_transforms=aff), bulk)
    jren = _jax_renderer()
    jscene = jren.snapshot_scene(jax_from_renders(jtree), jax_pkg.vec2(w, h),
                                 animate=True)
    assert list(jscene.animation_order()) == keys
    want = jren.render_view(jscene, (3.0, -2.0), root_transforms={
        keys[i]: JaxMat3(*r) for i, r in rows.items()})
    _frame_close(bulk, want)


# --- RenderListArray.set_node in retained scenes -------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_set_node_patch_matches_fresh_snapshot(seed):
    """test_retained.py's fuzz case with all four of its edit kinds, the
    wholesale repack set_node(Fig) among them (its node carried across as
    figdraw_tpu's packed row, unpacked by the port): update_scene equals a
    new snapshot bit for bit whether an edit patched or not."""
    from figdraw_tpu.nodesarray import FIG_DTYPE, pack_fig
    from tests.test_fuzz import _rand_rect_fig, random_scene

    rng = np.random.default_rng(4200 + seed)
    arr = to_port(jax_from_renders(random_scene(int(rng.integers(0, 10_000)))))
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    size = port.vec2(200, 140)
    scene = ren.snapshot_scene(arr, size)
    lst = arr[0]
    roots = list(lst.root_ids)
    for _round in range(3):
        dirty = []
        for r in rng.choice(roots, size=min(3, len(roots)), replace=False):
            r = int(r)
            kind = int(rng.integers(0, 4))
            if kind == 0:
                lst.set_box(r, float(rng.uniform(-10, 180)), float(rng.uniform(-10, 120)),
                            float(rng.uniform(4, 80)), float(rng.uniform(4, 60)))
            elif kind == 1:
                lst.set_rotation(r, float(rng.uniform(-50, 50)))
            elif kind == 2:
                lst.set_solid_color(r, port.rgba(*rng.integers(0, 256, 4).tolist()))
            else:
                row = np.zeros((), FIG_DTYPE)
                pack_fig(row, _rand_rect_fig(rng, depth=2))
                node = port.nodesarray.unpack_fig(row)
                assert node.kind == port.FigKind.nkRectangle
                lst.set_node(r, node)
            dirty.append((0, r))
        ren.update_scene(scene, arr, dirty)
        got = ren.render_view(scene)
        want = ren.render_view(ren.snapshot_scene(arr, size))
        assert np.array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32)), _round


def test_render_list_array_takes_figs():
    """RenderListArray.add_root / add_child / set_node with Fig nodes give
    figdraw_tpu's rows byte for byte."""
    from figdraw_tpu.nodesarray import RenderListArray as JaxList

    def build(pk, lst_cls):
        lst = lst_cls(capacity=2)
        root = lst.add_root(pk.Fig(kind=pk.FigKind.nkRectangle,
                                   screen_box=pk.rect(1, 2, 30, 40), corners=(3,) * 4,
                                   fill=pk.fill(pk.rgba(9, 8, 7, 255)),
                                   flags=pk.FigFlags.NfClipContent))
        child = lst.add_child(root, pk.Fig(
            kind=pk.FigKind.nkDrawable, screen_box=pk.rect(0, 0, 20, 20),
            draw_ops=(pk.drawable_line(pk.vec2(1, 1), pk.vec2(9, 4)),
                      pk.drawable_bezier([pk.vec2(0, 0), pk.vec2(5, 9), pk.vec2(9, 0)])),
            draw_stroke=pk.RenderStroke(weight=2.0, fill=pk.fill(pk.rgba(1, 2, 3, 255)))))
        lst.add_root(pk.Fig(kind=pk.FigKind.nkTransform,
                            transform=pk.TransformStyle(matrix=pk.Mat3.scaling(2.0, 1.0))))
        lst.set_node(root, pk.Fig(kind=pk.FigKind.nkRectangle,
                                  screen_box=pk.rect(2, 3, 31, 41),
                                  fill=pk.linear(pk.rgba(1, 1, 1, 255),
                                                 pk.rgba(200, 9, 9, 255))))
        return lst, child

    jl, jc = build(jax_pkg, JaxList)
    pl, pc = build(port, port.RenderListArray)
    assert pc == jc and pl.root_ids == jl.root_ids
    assert pl.view().tobytes() == jl.view().tobytes()
    (jo, jp), (po, pp) = jl.ops_view(), pl.ops_view()
    assert po.tobytes() == jo.tobytes() and pp.tobytes() == jp.tobytes()
