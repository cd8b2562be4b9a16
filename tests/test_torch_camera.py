"""Device-resident scenes and the camera of figdraw_tpu_torch on the CPU
(snapshot_scene / render_view / render_views): the twins of
tests/test_camera.py's cases, on its scenes, at its sizes.

Within the port the contracts are bit-exact: an integer pan or a
power-of-two zoom of an integer scene equals render_frame of the scene
under the same nkTransform camera; pan 0 and zoom 1 equal the plain render;
render_views equals the render_view loop. Against the JAX package (its
default path, use_pallas=False) a view is within 1/255, the bound the port's
frames are held to everywhere, and the spans and resident rows of a
snapshot are equal."""

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
import test_camera as jcam
from figdraw_tpu import vec2 as jax_vec2
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu_torch.scene import from_jax_scene
from torch_reference import to_port

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

TOL = 1.0 / 255.0


def _ren():
    return port.FigRenderer(atlas_size=64, device="cpu")


def _equal(a, b):
    return np.array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))


def test_integer_pan_bit_exact_simple():
    size = port.vec2(176, 144)
    cam, ref = _ren(), _ren()
    scene = cam.snapshot_scene(to_port(jcam.boxes_scene()), size)
    assert scene.kind == "unrolled"
    for dx, dy in ((0, 0), (9, 0), (0, -7), (-13, 11)):
        view = cam.render_view(scene, (dx, dy))
        expect = ref.render_frame(to_port(jcam.boxes_scene(dx, dy)), size)
        assert _equal(view, expect), (dx, dy)


def test_view_matches_jax_and_snapshot_state_is_equal():
    """The JAX package's snapshot of the same scene holds the same rows and
    spans; its views are within 1/255 of the port's."""
    arr = jcam.boxes_scene()
    jr = JaxRenderer(atlas_size=64, use_pallas=False)
    jscene = jr.snapshot_scene(arr, jax_vec2(176, 144))
    pr = _ren()
    scene = pr.snapshot_scene(to_port(arr), port.vec2(176, 144))
    assert scene.kind == jscene.kind == "unrolled"
    assert (scene.n_quads, scene.n_pad) == (jscene.n_quads, jscene.n_pad)
    assert scene.spans == jscene.spans and scene.anim_spans == jscene.anim_spans
    assert scene.animation_order() == jscene.animation_order()
    assert (scene.combo_dev.numpy().tobytes()
            == np.asarray(jscene.combo_dev).tobytes())
    for pan, zoom in (((0, 0), 1.0), ((9, -7), 2.0), ((0.5, 0.25), 1.5)):
        got = pr.render_view(scene, pan, zoom).numpy()
        want = np.asarray(jr.render_view(jscene, pan, zoom))
        assert np.abs(got - want).max() <= TOL, (pan, zoom)


@pytest.mark.parametrize("animate", [False, True], ids=["mega", "rolled"])
def test_integer_pan_bit_exact_masks(animate):
    """Clip cells and their contents pan together on the megakernel layout
    and, with animate=True, on the rolled one."""
    size = port.vec2(192, 152)
    cam, ref = _ren(), _ren()
    scene = cam.snapshot_scene(to_port(jcam.clip_scene()), size, animate=animate)
    assert scene.kind == ("rolled" if animate else "mega")
    assert (scene.anim_spans is not None) == animate
    for dx, dy in ((6, 0), (-10, 8), (7, -5)):
        view = cam.render_view(scene, (dx, dy))
        expect = ref.render_frame(to_port(jcam.clip_scene(dx, dy)), size)
        assert _equal(view, expect), (dx, dy)


def test_pan_round_trip_and_outlives_pool():
    """pan(d) then pan(0) gives the first frame again (the resident rows are
    never written by a view), also after later flattens recycled the walk's
    combo pool."""
    size = port.vec2(176, 144)
    cam = _ren()
    scene = cam.snapshot_scene(to_port(jcam.boxes_scene()), size)
    resident = scene.combo_dev.clone()
    base = cam.render_view(scene, (0, 0))
    cam.render_view(scene, (31, -17))
    cam.render_frame(to_port(jcam.boxes_scene(3, 1)), size)
    cam.render_frame(to_port(jcam.boxes_scene(5, 2)), size)
    again = cam.render_view(scene, (0.0, 0.0))
    assert _equal(again, base)
    assert _equal(scene.combo_dev, resident)


def test_fractional_pan_moves_smoothly():
    size = port.vec2(176, 144)
    cam = _ren()
    scene = cam.snapshot_scene(to_port(jcam.boxes_scene()), size)
    a = cam.render_view(scene, (0.5, 0.25))
    b = cam.render_view(scene, (0.0, 0.0))
    assert bool(torch.isfinite(a).all()) and not _equal(a, b)
    one = cam.render_view(scene, (1.0, 0.0))
    assert _equal(one, _ren().render_frame(to_port(jcam.boxes_scene(1, 0)), size))


@pytest.mark.parametrize("scene_fn,kind,cams", [
    ("boxes_scene_view", "unrolled", (((0, 0), 2), ((9, -7), 2), ((-13, 11), 4))),
    ("rectmask_scene_view", "unrolled", (((4, -6), 2), ((-11, 3), 2))),
    ("clip_scene_view", "mega", (((5, -3), 2),)),
])
def test_integer_zoom_bit_exact(scene_fn, kind, cams):
    """Power-of-two zooms of integer axis-aligned scenes equal a walk under
    the same nkTransform camera: plain boxes, the rect-mask fast path (its
    screen->local rows scale by 1/z and the translations re-derive) and clip
    cells on the megakernel."""
    size = port.vec2(352, 288)
    build = getattr(jcam, scene_fn)
    cam, ref = _ren(), _ren()
    scene = cam.snapshot_scene(to_port(build()), size)
    assert scene.kind == kind
    for (dx, dy), z in cams:
        view = cam.render_view(scene, (dx, dy), zoom=z)
        expect = ref.render_frame(to_port(build((dx, dy), z)), size)
        assert _equal(view, expect), (dx, dy, z)


def test_fractional_zoom_smooth_and_unit_zoom_is_pan():
    size = port.vec2(176, 144)
    cam = _ren()
    scene = cam.snapshot_scene(to_port(jcam.boxes_scene()), size)
    pan_only = cam.render_view(scene, (5, -3))
    assert _equal(cam.render_view(scene, (5, -3), zoom=1.0), pan_only)
    frac = cam.render_view(scene, (5, -3), zoom=1.5)
    assert bool(torch.isfinite(frac).all()) and not _equal(frac, pan_only)


def test_camera_overlay_composite():
    """render_view, then render_frame(hud, clear_main=False) on top, equals
    one walk of the combined scene: a view is the renderer's last frame."""
    from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba
    from figdraw_tpu.nodesarray import from_renders

    size = port.vec2(352, 288)
    d, z = (9, -7), 2

    def hud_scene():
        r = new_renders()
        for n in jcam._hud_nodes():
            r.add_root(1, n)
        return to_port(from_renders(r))

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
        return to_port(from_renders(r))

    cam, ref = _ren(), _ren()
    scene = cam.snapshot_scene(to_port(jcam.boxes_scene_view()), size)
    cam.render_view(scene, d, zoom=z)
    view = cam.render_frame(hud_scene(), size, clear_main=False)
    assert _equal(view, ref.render_frame(combined(), size))


def test_snapshot_skips_viewport_cull():
    """snapshot_scene flattens with cull=False; spans need it."""
    size = port.vec2(176, 144)
    r = _ren()
    arr = to_port(jcam.boxes_scene())
    t_cull = r.flatten(arr, size, cull=True)
    t_nocull = r.flatten(arr, size, cull=False, record_spans=True)
    assert t_nocull.count >= t_cull.count
    assert t_cull.root_spans is None and len(t_nocull.root_spans) == 24
    with pytest.raises(ValueError, match="cull=False"):
        r.flatten(arr, size, cull=True, record_spans=True)


def test_render_views_matches_loop():
    """One preallocated stack, fractional views and per-view zooms included,
    equals the render_view loop."""
    size = port.vec2(176, 144)
    ren = _ren()
    scene = ren.snapshot_scene(to_port(jcam.boxes_scene()), size)
    pans = [(0, 0), (9, -7), (0.5, 0.25), (-13, 11), (3, 4)]
    zooms = [1.0, 2.0, 1.5, 1.0, 0.75]
    stack = ren.render_views(scene, pans, zooms)
    assert tuple(stack.shape) == (5, 144, 176, 4) and stack.dtype == torch.float32
    assert _equal(ren.last_frame, stack[-1])
    for i, (p, z) in enumerate(zip(pans, zooms)):
        assert _equal(stack[i], ren.render_view(scene, p, zoom=z)), i


def test_render_views_mega_scalar_zoom_u8():
    size = port.vec2(192, 152)
    ren = _ren()
    scene = ren.snapshot_scene(to_port(jcam.clip_scene_view()), size)
    assert scene.kind == "mega"
    pans = [(0, 0), (7, -5), (-3, 2)]
    stack = ren.render_views(scene, pans, zooms=2.0, as_uint8=True)
    assert stack.dtype == torch.uint8 and stack.shape[0] == 3
    for i, p in enumerate(pans):
        exp = ren.take_screenshot(ren.render_view(scene, p, zoom=2.0))
        assert np.array_equal(stack[i].numpy(), exp)


def test_render_views_of_a_scene_that_does_not_clear_chains_its_views():
    size = port.vec2(176, 144)
    ren = _ren()
    scene = ren.snapshot_scene(to_port(jcam.boxes_scene()), size, clear_main=False)
    assert scene.plan.has_init_frame
    ren.last_frame = None
    stack = ren.render_views(scene, [(0, 0), (40, 30)])
    ren.last_frame = None
    first = ren.render_view(scene, (0, 0))
    second = ren.render_view(scene, (40, 30))
    assert _equal(stack[0], first) and _equal(stack[1], second)
    assert not _equal(second, _ren().render_view(
        _ren().snapshot_scene(to_port(jcam.boxes_scene()), size, clear_main=False),
        (40, 30)))


@pytest.mark.parametrize("scene_fn,use_pallas,kind", [
    ("boxes_scene", False, "unrolled"), ("clip_scene", False, "rolled"),
    ("clip_scene", True, "mega")])
def test_from_jax_scene_round_trip(scene_fn, use_pallas, kind):
    """A snapshot taken by the JAX package, carried over as numpy, views in
    the port within 1/255 of the JAX package's own view."""
    arr = getattr(jcam, scene_fn)()
    jr = JaxRenderer(atlas_size=64, use_pallas=use_pallas)
    jscene = jr.snapshot_scene(arr, jax_vec2(192, 152))
    scene = from_jax_scene(jscene, "cpu")
    assert scene.kind == jscene.kind == kind
    assert (scene.n_quads, scene.n_pad) == (jscene.n_quads, jscene.n_pad)
    assert scene.spans == jscene.spans and scene.anim_spans == jscene.anim_spans
    assert scene.snap_args[0] == port.vec2(192, 152) and scene.snap_args[1] is True
    assert (scene.combo_dev.numpy().tobytes()
            == np.asarray(jscene.combo_dev).tobytes())
    pr = _ren()
    for pan, zoom in (((0, 0), 1.0), ((6, -4), 2.0)):
        got = pr.render_view(scene, pan, zoom).numpy()
        want = np.asarray(jr.render_view(jscene, pan, zoom))
        assert np.abs(got - want).max() <= TOL, (pan, zoom)
    if use_pallas:
        assert jr.use_pallas, "the JAX renderer fell back from Pallas"


def test_a_scene_on_another_device_is_refused():
    """render_view, render_views and update_scene run a scene only on the
    renderer's own device, and from_jax_scene has no default device: a scene
    never lands on the CPU, or on the plain versions, by omission."""
    size = port.vec2(192, 152)
    arr = to_port(jcam.boxes_scene())
    ren = _ren()
    scene = ren.snapshot_scene(arr, size)
    want = ren.render_view(scene)
    elsewhere = ren.snapshot_scene(arr, size)
    elsewhere.combo_dev = elsewhere.combo_dev.to("meta")
    for call in (lambda: ren.render_view(elsewhere),
                 lambda: ren.render_views(elsewhere, [(0, 0)]),
                 lambda: ren.update_scene(elsewhere, arr, [0])):
        with pytest.raises(ValueError, match="the scene lies on meta"):
            call()
    assert _equal(ren.render_view(scene), want)
    jscene = JaxRenderer(atlas_size=64, use_pallas=False).snapshot_scene(
        jcam.boxes_scene(), jax_vec2(192, 152))
    with pytest.raises(TypeError):
        from_jax_scene(jscene)
