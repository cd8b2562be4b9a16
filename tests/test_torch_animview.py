"""Per-root animation of a device-resident scene in figdraw_tpu_torch on the
CPU (render_view's root_transforms): the twins of tests/test_animview.py's
cases, on its scenes, at its sizes.

Within the port, integer translations and power-of-two scales of integer
axis-aligned roots equal render_frame of the scene with each root wrapped
in the same nkTransform, bit for bit; the identity table equals the plain
view; the resident rows are never written by an animation. Against the JAX
package (use_pallas=False) an animated view is within 1/255."""

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
import test_animview as janim
from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba, root_affine
from figdraw_tpu import vec2 as jax_vec2
from figdraw_tpu.basics import TransformStyle
from figdraw_tpu.geometry import Mat3
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu_torch.scene import affine6, from_jax_scene
from test_animview import S, T
from torch_reference import ensure_jax_native, to_port

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

TOL = 1.0 / 255.0


@pytest.fixture(autouse=True, scope="module")
def jax_walk():
    """figdraw_tpu's C++ walk loaded before any test here uses it
    (torch_reference.ensure_jax_native: a lost build race raises, never
    falls back to figdraw_tpu's Python walk)."""
    ensure_jax_native()


def _ren():
    return port.FigRenderer(atlas_size=64, device="cpu")


def _equal(a, b):
    return np.array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))


CASES = {
    # name: (scene function, frame size, snapshot's animate, kind, moves)
    "translate": ("boxes_roots", (208, 168), False, "unrolled",
                  {1: T(12, 0), 4: T(0, -10), 7: T(-9, 13), 10: T(25, 25)}),
    "pow2_scale": ("boxes_roots", (416, 352), False, "unrolled",
                   {0: S(2), 5: S(2, 16, 8), 9: S(0.5, 40, 120)}),
    "clip_roots": ("clip_roots", (224, 176), True, "rolled",
                   {0: T(14, 6), 4: T(-8, 10)}),
    "rect_mask_roots": ("rectmask_roots", (208, 168), False, "unrolled",
                        {1: T(10, -4), 6: T(-6, 12)}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_root_transforms_bit_exact(name):
    """Clip cells move with their contents (the span covers their mask-write
    quads; animate=True keeps the scene off the megakernel's layout), and
    rect-mask cells compose their screen->local rows with the inverse."""
    scene_fn, (w, h), animate, kind, moves = CASES[name]
    build = getattr(janim, scene_fn)
    size = port.vec2(w, h)
    anim, ref = _ren(), _ren()
    base, keys = build()
    scene = anim.snapshot_scene(to_port(base), size, animate=animate)
    assert scene.kind == kind
    wrapped, _ = build(wrap=moves)
    view = anim.render_view(
        scene, root_transforms={keys[i]: m for i, m in moves.items()})
    assert _equal(view, ref.render_frame(to_port(wrapped), size))


def test_animated_view_matches_jax():
    base, keys = janim.boxes_roots()
    moves = {keys[1]: T(12, 0), keys[5]: S(2, 16, 8),
             keys[7]: root_affine(rotate=17.0, center=(8 + 3 * 42 + 15, 44 + 12))}
    jr = JaxRenderer(atlas_size=64, use_pallas=False)
    jscene = jr.snapshot_scene(base, jax_vec2(208, 168))
    want = np.asarray(jr.render_view(jscene, (3, -2), 1.5, root_transforms=moves))
    pr = _ren()
    scene = pr.snapshot_scene(to_port(base), port.vec2(208, 168))
    assert scene.animation_order() == jscene.animation_order()
    got = pr.render_view(scene, (3, -2), 1.5, root_transforms=moves).numpy()
    assert np.abs(got - want).max() <= TOL
    carried = pr.render_view(from_jax_scene(jscene, "cpu"), (3, -2), 1.5,
                             root_transforms=moves).numpy()
    assert np.array_equal(carried, got)


def test_mega_mask_scene_requires_animate_flag():
    """A snapshot on the megakernel's layout with clip masks has no per-root
    row mapping: root_transforms refuses, and the animate=True snapshot of
    the same scene works."""
    size = port.vec2(224, 176)
    r = _ren()
    base, keys = janim.clip_roots()
    scene = r.snapshot_scene(to_port(base), size)
    assert scene.kind == "mega" and scene.animation_order() is None
    with pytest.raises(ValueError, match="animate=True"):
        r.render_view(scene, root_transforms={keys[0]: T(5, 5)})
    ok = r.snapshot_scene(to_port(base), size, animate=True)
    assert ok.kind == "rolled" and len(ok.animation_order()) == 9
    plain = r.render_view(scene)
    assert _equal(r.render_view(ok, root_transforms={}), plain)


def test_identity_table_is_plain_view_and_round_trip():
    size = port.vec2(208, 168)
    r = _ren()
    base, keys = janim.boxes_roots()
    scene = r.snapshot_scene(to_port(base), size)
    resident = scene.combo_dev.clone()
    plain = r.render_view(scene)
    assert _equal(r.render_view(scene, root_transforms={}), plain)
    n = len(scene.anim_order)
    bulk = np.zeros((n, 6), np.float32)
    bulk[:, 0] = bulk[:, 3] = 1.0
    assert _equal(r.render_view(scene, root_transforms=bulk), plain)
    moved = r.render_view(scene, root_transforms={keys[2]: T(30, 18)})
    assert not _equal(moved, plain)
    assert _equal(r.render_view(scene), plain)
    assert _equal(scene.combo_dev, resident)


def test_bulk_array_equals_dict_and_2x3_form():
    size = port.vec2(208, 168)
    r = _ren()
    base, keys = janim.boxes_roots()
    scene = r.snapshot_scene(to_port(base), size)
    moves = {keys[1]: T(7, -3), keys[8]: S(2, 4, 4)}
    via_dict = r.render_view(scene, root_transforms=moves)
    n = len(scene.anim_order)
    bulk = np.zeros((n, 6), np.float32)
    bulk[:, 0] = bulk[:, 3] = 1.0
    for k, m in moves.items():
        bulk[scene.anim_slot[(0, k)]] = m
    assert _equal(r.render_view(scene, root_transforms=bulk), via_dict)
    nested = {(0, keys[1]): [[1, 0, 7], [0, 1, -3]], keys[8]: [[2, 0, 4], [0, 2, 4]]}
    assert _equal(r.render_view(scene, root_transforms=nested), via_dict)
    assert np.array_equal(affine6([[1, 2, 5], [3, 4, 6]]),
                          np.asarray((1, 2, 3, 4, 5, 6), np.float32))
    with pytest.raises(ValueError, match="2x3"):
        affine6(np.zeros((3, 3)))


def test_anim_composes_with_camera_bit_exact():
    """An integer translation per root under an integer pan and a
    power-of-two zoom equals the walk of the roots wrapped in their
    transforms under the camera's: p'' = z (M p + t) + d."""
    size = port.vec2(416, 336)
    moves = {3: T(11, 7), 6: T(-5, 9)}
    anim, ref = _ren(), _ren()
    base, keys = janim.boxes_roots()
    scene = anim.snapshot_scene(to_port(base), size)
    view = anim.render_view(
        scene, pan=(9, -7), zoom=2,
        root_transforms={keys[i]: m for i, m in moves.items()})
    renders = new_renders()
    cam = renders.add_root(0, Fig(
        kind=FigKind.nkTransform,
        transform=TransformStyle(translation=jax_vec2(9.0, -7.0),
                                 matrix=Mat3.scaling(2.0, 2.0))))
    for i in range(12):
        f = Fig(kind=FigKind.nkRectangle,
                screen_box=rect(8 + (i % 4) * 42, 6 + (i // 4) * 38, 30, 24),
                corners=(5,) * 4,
                fill=fill(rgba(40 + i * 10, (i * 53) % 255, 180, 160)))
        if i in moves:
            a, b, c, d, tx, ty = [float(v) for v in moves[i]]
            tr = renders.add_child(0, cam, Fig(
                kind=FigKind.nkTransform,
                transform=TransformStyle(translation=jax_vec2(tx, ty),
                                         matrix=Mat3(a, b, 0.0, c, d, 0.0))))
            renders.add_child(0, tr, f)
        else:
            renders.add_child(0, cam, f)
    assert _equal(view, ref.render_frame(to_port(from_renders(renders)), size))


def test_rotation_matches_reflatten_closely():
    """A rotation keeps the baked vertex snapping (a walk snaps after the
    transform): a tiny mean error, larger deviations on few edge pixels."""
    size = port.vec2(208, 168)
    anim, ref = _ren(), _ren()
    base, keys = janim.boxes_roots()
    scene = anim.snapshot_scene(to_port(base), size)
    aff = root_affine(rotate=17.0, center=(8 + 42 + 15, 6 + 15))
    view = anim.render_view(scene, root_transforms={keys[1]: aff}).numpy()
    wrapped, _ = janim.boxes_roots(wrap={1: aff})
    expect = ref.render_frame(to_port(wrapped), size).numpy()
    diff = np.abs(view - expect)
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff > 0.1).mean() < 0.01, (diff > 0.1).mean()


def test_patch_then_animate():
    """update_scene, then an animated view: the patch lands in the
    snapshot's own space and the frame equals an animated view of a new
    snapshot of the edited scene."""
    size = port.vec2(208, 168)
    r, ref = _ren(), _ren()
    base, keys = janim.boxes_roots()
    arr = to_port(base)
    scene = r.snapshot_scene(arr, size)
    arr[0].set_solid_color(keys[5], port.rgba(255, 0, 0, 255))
    r.update_scene(scene, arr, dirty=[keys[5]])
    assert scene.pending_patch is not None
    moves = {keys[2]: T(16, 10)}
    view = r.render_view(scene, root_transforms=moves)
    assert scene.pending_patch is None and scene.last_view_frame is None
    fresh = ref.snapshot_scene(arr, size)
    assert _equal(view, ref.render_view(fresh, root_transforms=moves))


def test_unknown_root_key_raises():
    size = port.vec2(208, 168)
    r = _ren()
    base, _keys = janim.boxes_roots()
    scene = r.snapshot_scene(to_port(base), size)
    with pytest.raises(KeyError, match="no recorded span"):
        r.render_view(scene, root_transforms={9999: T(1, 1)})
    with pytest.raises(ValueError, match="slot order"):
        r.render_view(scene, root_transforms=np.zeros((3, 6), np.float32))


@pytest.mark.parametrize("copies", [4, 25])
def test_anim_table_is_bench_sceneanims(copies, monkeypatch):
    """scenes.box_tracks and scenes.anim_table against bench_sceneanim's, and
    the table through an animated view of the demo scene."""
    import bench_sceneanim

    from figdraw_tpu_torch.scenes import (
        anim_table, box_tracks, make_render_tree_array,
    )

    w, h = 640, 360
    monkeypatch.setattr(bench_sceneanim, "WIDTH", w)
    monkeypatch.setattr(bench_sceneanim, "HEIGHT", h)
    base = box_tracks(copies, 0, w, h)
    assert np.array_equal(base, bench_sceneanim._box_tracks(copies, 0))
    n_roots = 1 + 3 * copies + 3
    ident = np.zeros((n_roots, 6), np.float32)
    ident[:, 0] = ident[:, 3] = 1.0
    for frame in (1, 7):
        ref = bench_sceneanim._anim_table(copies, base, frame, ident.copy())
        got = anim_table(copies, base, frame, ident.copy(), w, h)
        assert np.array_equal(got, ref)
    if copies == 4:
        ren = _ren()
        scene = ren.snapshot_scene(make_render_tree_array(w, h, 0, copies=copies),
                                   port.vec2(w, h))
        assert scene.animation_order() == [(0, i) for i in range(n_roots)]
        still = ren.render_view(scene, root_transforms=ident)
        moved = ren.render_view(scene, root_transforms=got)
        assert _equal(still, ren.render_view(scene))
        assert bool(torch.isfinite(moved).all()) and not _equal(moved, still)
