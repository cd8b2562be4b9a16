"""Retained scenes of figdraw_tpu_torch on the CPU (update_scene on a
DeviceScene): the twins of tests/test_retained.py's cases that need no
text, no sharding and no set_node, on its scenes, at its size.

The contract is bit-exact within the port: after edits in place,
update_scene(scene, arr, dirty) renders the frame a new snapshot of the
edited scene renders, whether the rows were patched or the scene was
snapshot again, and a damage-clipped frame equals the full render. Against
the JAX package (use_pallas=False) a patched view is within 1/255, and the
inert rows are fd_pad_rows' bytes."""

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
import test_retained as jret
from figdraw_tpu import Fig, FigFlags, FigKind, fill, new_renders, rect, rgba
from figdraw_tpu import native as jax_native
from figdraw_tpu import vec2 as jax_vec2
from figdraw_tpu.basics import ShadowStyle
from figdraw_tpu.nodes import RenderShadow
from figdraw_tpu.nodesarray import from_renders, pack_fig
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu_torch import native, renderer as port_renderer
from figdraw_tpu_torch.ops.rows import DAMAGE_RECTS
from figdraw_tpu_torch.scene import from_jax_scene, merge_damage
from torch_reference import fresh_combo_pools, to_port

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

W, H = jret.W, jret.H
SIZE = port.vec2(W, H)
TOL = 1.0 / 255.0


def _ren():
    return port.FigRenderer(atlas_size=64, device="cpu")


def _equal(a, b):
    return np.array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))


def boxes_scene(n=40):
    arr, boxes = jret.boxes_scene(n)
    return to_port(arr), boxes


def _fresh_frame(ren, arr, pan=(0.0, 0.0), zoom=1.0):
    return ren.render_view(ren.snapshot_scene(arr, SIZE), pan, zoom)


def _patch_hits(monkeypatch):
    """Counts of walk_roots_packed's calls and of those that gave rows."""
    stats = {"calls": 0, "ok": 0}
    orig = native.walk_roots_packed

    def counting(*a, **k):
        stats["calls"] += 1
        out = orig(*a, **k)
        stats["ok"] += out is not None
        return out

    monkeypatch.setattr(native, "walk_roots_packed", counting)
    return stats


def _partial_hits(monkeypatch):
    """Count of damage-clipped frames (each asks for its spans once)."""
    stats = {"n": 0}
    orig = port_renderer.damage_spans

    def counting(*a, **k):
        stats["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(port_renderer, "damage_spans", counting)
    return stats


def _set_node(lst, i, fig):
    """nodesarray.set_node on the port's rows (the same bytes), through the
    JAX package's packer: repack a node, keeping its tree links."""
    parent, children = int(lst.nodes[i]["parent"]), int(lst.nodes[i]["child_count"])
    lst.nodes[i] = np.zeros((), lst.nodes.dtype)
    pack_fig(lst.nodes[i], fig, lst.ops_rows, lst.points_rows)
    lst.nodes[i]["parent"] = parent
    lst.nodes[i]["child_count"] = children


def _shadowed():
    return Fig(kind=FigKind.nkRectangle, screen_box=rect(5, 8, 26, 38),
               corners=(5,) * 4, fill=fill(rgba(10, 200, 10, 255)),
               shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=6.0,
                                     x=2, y=3, fill=fill(rgba(0, 0, 0, 120))),))


def test_patch_geometry_and_fill_exact(monkeypatch):
    arr, boxes = boxes_scene()
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    assert scene.spans is not None and scene.kind == "unrolled"
    stats = _patch_hits(monkeypatch)
    lst = arr[0]
    for k, b in enumerate(boxes[5:15]):
        lst.set_box(b, 5 + (b % 10) * 31, 20 + (b // 10) * 40, 26, 38)
        lst.set_rotation(b, -10.0 - k)
        lst.set_solid_color(b, port.rgba(250, 80 + 10 * k, 60, 200))
    ren.update_scene(scene, arr, dirty=[(0, b) for b in boxes[5:15]])
    assert stats["ok"] == 1, "expected the patch path"
    got = ren.render_view(scene, pan=(3.0, -2.0))
    assert _equal(got, _fresh_frame(ren, arr, pan=(3.0, -2.0)))


def test_patched_view_matches_jax():
    """The same edits through both packages, and through a snapshot carried
    over from the JAX package: frames within 1/255, patched rows equal."""
    jarr, boxes = jret.boxes_scene(20)
    arr = to_port(jarr)
    jr = JaxRenderer(atlas_size=64, use_pallas=False)
    jscene = jr.snapshot_scene(jarr, jax_vec2(W, H))
    pr = _ren()
    scene = pr.snapshot_scene(arr, SIZE)
    carried = from_jax_scene(jscene, "cpu")
    assert carried.atlas_generation == pr.atlas.generation
    for lst, color in ((jarr[0], rgba(250, 80, 60, 200)),
                       (arr[0], port.rgba(250, 80, 60, 200))):
        for b in boxes[3:7]:
            lst.set_box(b, 40 + b * 9, 60, 26, 38)
            lst.set_rotation(b, 25.0)
            lst.set_solid_color(b, color)
    dirty = [(0, b) for b in boxes[3:7]]
    jr.update_scene(jscene, jarr, dirty)
    pr.update_scene(scene, arr, dirty)
    pr.update_scene(carried, arr, dirty)
    assert carried.pending_patch is not None, "the carried scene snapshot again"
    want = np.asarray(jr.render_view(jscene, (2.0, 1.0)))
    got = pr.render_view(scene, (2.0, 1.0)).numpy()
    assert np.abs(got - want).max() <= TOL
    assert np.array_equal(pr.render_view(carried, (2.0, 1.0)).numpy(), got)
    assert scene.combo_dev.numpy().tobytes() == np.asarray(jscene.combo_dev).tobytes()


def test_patch_bare_int_dirty_means_layer_zero(monkeypatch):
    arr, boxes = boxes_scene(12)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    stats = _patch_hits(monkeypatch)
    arr[0].set_box(boxes[3], 100, 100, 26, 38)
    ren.update_scene(scene, arr, dirty=[boxes[3]])
    assert stats["ok"] == 1
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))


def test_patch_rect_mask_clip_root(monkeypatch):
    """An NfRectMaskContent clip root stays on the patch path: rect-mask
    state is local to its subtree."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(20, 20, 30, 255))))
    c = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(40, 40, 120, 80),
        flags=FigFlags.NfRectMaskContent, fill=fill(rgba(200, 200, 210, 255))))
    renders.add_child(0, c, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(-30, 20, 240, 30),
        fill=fill(rgba(255, 60, 60, 200))))
    arr = to_port(from_renders(renders))
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    stats = _patch_hits(monkeypatch)
    arr[0].set_box(c, 60, 55, 100, 70)
    ren.update_scene(scene, arr, dirty=[(0, c)])
    assert stats["ok"] == 1
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))


def test_structural_edit_falls_back_exact(monkeypatch):
    """An edit that adds a quad (a shadow) snapshots again: the walk gave
    rows, the span was too short. The new snapshot's spans patch again."""
    arr, boxes = boxes_scene(12)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    stats = _patch_hits(monkeypatch)
    lst = arr[0]
    _set_node(lst, boxes[0], _shadowed())
    ren.update_scene(scene, arr, dirty=[(0, boxes[0])])
    assert stats == {"calls": 1, "ok": 1} and scene.pending_patch is None
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))
    lst.set_rotation(boxes[0], 33.0)
    ren.update_scene(scene, arr, dirty=[(0, boxes[0])])
    assert stats["ok"] == 2 and scene.pending_patch is not None
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))


def test_plane_mask_dirty_root_falls_back_exact(monkeypatch):
    """A dirty root that allocates a plane mask (NfClipContent) is not
    patched: the roots that touch a plane have no patchable span, and a
    scratch walk with a plane gives no rows."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(20, 20, 30, 255))))
    c = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(60, 60, 120, 80), rotation=17.0,
        flags=FigFlags.NfClipContent, fill=fill(rgba(255, 255, 255, 30))))
    renders.add_child(0, c, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(-20, 10, 200, 30),
        fill=fill(rgba(255, 0, 0, 200))))
    arr = to_port(from_renders(renders))
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    assert (0, c) not in scene.spans and (0, c) in scene.anim_spans
    assert native.walk_roots_packed(arr, [(0, c)], 1.0, 1.0, ren.aa_factor,
                                    atlas=ren._walk_atlas()) is None
    arr[0].set_rotation(c, 40.0)
    ren.update_scene(scene, arr, dirty=[(0, c)])
    assert scene.pending_patch is None
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))


def test_dirty_none_resnapshots():
    arr, boxes = boxes_scene(8)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    arr[0].set_box(boxes[2], 150, 120, 26, 38)
    ren.update_scene(scene, arr)
    assert scene.pending_patch is None
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))


def test_patch_preserves_unrelated_rows_and_meta():
    """Only the dirty root's rows change in the resident buffer and in the
    plan's host rows; padding and the meta tail stay byte-identical."""
    arr, boxes = boxes_scene(16)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    before = scene.combo_dev.numpy().copy().view(np.int32)
    s, e = scene.spans[(0, boxes[4])]
    arr[0].set_box(boxes[4], 111, 77, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[4])])
    assert np.array_equal(scene.combo_dev.numpy().view(np.int32), before)  # deferred
    ren._flush_scene_patch(scene)
    after = scene.combo_dev.numpy().view(np.int32)
    changed = np.where((before != after).any(axis=1))[0]
    assert changed.size > 0 and changed.min() >= s and changed.max() < e
    assert np.array_equal(scene.plan.combo.view(np.int32), after)


def test_patch_multi_layer(monkeypatch):
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(10, 12, 16, 255))))
    a = renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(30, 30, 60, 60),
                                fill=fill(rgba(200, 60, 60, 200))))
    b = renders.add_root(1, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(60, 50, 80, 40), corners=(8,) * 4,
                                fill=fill(rgba(60, 200, 120, 180))))
    arr = to_port(from_renders(renders))
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    stats = _patch_hits(monkeypatch)
    arr[0].set_box(a, 45, 40, 60, 60)
    arr[1].set_box(b, 80, 70, 80, 40)
    ren.update_scene(scene, arr, dirty=[(0, a), (1, b)])
    assert stats["ok"] == 1
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))


def test_atlas_generation_change_falls_back():
    arr, boxes = boxes_scene(8)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    arr[0].set_rotation(boxes[0], 80.0)
    ren.atlas.generation += 1  # a rebuild between frames
    ren.update_scene(scene, arr, dirty=[(0, boxes[0])])
    assert scene.atlas_generation == ren.atlas.generation
    assert scene.pending_patch is None
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_retained_patch_matches_fresh_snapshot(seed):
    """Random scenes (clips, rect masks, shadows, gradients, drawables,
    rotations) with random value edits of random roots: update_scene equals
    a new snapshot whether an edit patched or not."""
    from tests.test_fuzz import random_scene

    rng = np.random.default_rng(4200 + seed)
    arr = to_port(from_renders(random_scene(int(rng.integers(0, 10_000)))))
    ren = _ren()
    size = port.vec2(200, 140)
    scene = ren.snapshot_scene(arr, size)
    lst = arr[0]
    roots = list(lst.root_ids)
    for _round in range(3):
        dirty = []
        for r in rng.choice(roots, size=min(3, len(roots)), replace=False):
            r = int(r)
            kind = int(rng.integers(0, 3))
            if kind == 0:
                lst.set_box(r, float(rng.uniform(-10, 180)), float(rng.uniform(-10, 120)),
                            float(rng.uniform(4, 80)), float(rng.uniform(4, 60)))
            elif kind == 1:
                lst.set_rotation(r, float(rng.uniform(-50, 50)))
            else:
                lst.set_solid_color(r, port.rgba(*rng.integers(0, 256, 4).tolist()))
            dirty.append((0, r))
        ren.update_scene(scene, arr, dirty)
        got = ren.render_view(scene)
        assert _equal(got, ren.render_view(ren.snapshot_scene(arr, size))), _round


def test_back_to_back_updates_and_flythrough_flush():
    """Two update_scene calls with no render between them merge on the host;
    render_views uploads the patch before its first view."""
    arr, boxes = boxes_scene(10)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    arr[0].set_box(boxes[1], 100, 30, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[1])])
    arr[0].set_solid_color(boxes[2], port.rgba(255, 0, 255, 255))
    ren.update_scene(scene, arr, dirty=[(0, boxes[2])])
    pans = [(0.0, 0.0), (4.0, 2.0), (-3.0, 7.0)]
    got = ren.render_views(scene, pans)
    assert scene.pending_patch is None
    fresh = ren.snapshot_scene(arr, SIZE)
    for i, p in enumerate(pans):
        assert _equal(got[i], ren.render_view(fresh, p)), i


def test_partial_render_bit_equals_full(monkeypatch):
    """With a camera that stands still, the damage-clipped frame (quads
    outside the edits' old and new bboxes dropped, the previous frame
    outside the rects) equals a full render of the edited scene."""
    arr, boxes = boxes_scene(30)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    cam = ((2.0, 1.0), 1.0)
    ren.render_view(scene, *cam)
    stats = _partial_hits(monkeypatch)
    lst = arr[0]
    for step in range(3):
        b = boxes[4 + step]
        lst.set_box(b, 30 + 17 * step, 40 + 9 * step, 26, 38)
        lst.set_rotation(b, 20.0 * step - 15)
        lst.set_solid_color(b, port.rgba(255, 80 * step, 120, 220))
        ren.update_scene(scene, arr, dirty=[(0, b)])
        prev = scene.last_view_frame.clone()
        got = ren.render_view(scene, *cam)
        assert stats["n"] == step + 1, "the damage-clipped path was not taken"
        assert got is scene.last_view_frame and got is ren.last_frame
        assert not _equal(got, prev)
        assert _equal(got, _fresh_frame(ren, arr, *cam)), step


def test_partial_skipped_on_camera_change(monkeypatch):
    arr, boxes = boxes_scene(12)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    ren.render_view(scene, (0.0, 0.0))
    stats = _partial_hits(monkeypatch)
    arr[0].set_box(boxes[2], 90, 90, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[2])])
    got = ren.render_view(scene, (5.0, 0.0))  # the camera moved
    assert stats["n"] == 0
    assert _equal(got, _fresh_frame(ren, arr, (5.0, 0.0)))
    arr[0].set_rotation(boxes[3], 66.0)
    ren.update_scene(scene, arr, dirty=[(0, boxes[3])])
    got = ren.render_view(scene, (5.0, 0.0))
    assert stats["n"] == 1
    assert _equal(got, _fresh_frame(ren, arr, (5.0, 0.0)))


def test_partial_refused_with_a_blur_or_without_a_clear(monkeypatch):
    """A blur's or a backdrop's halo reads pixels outside the rects, and a
    frame that does not clear composites onto the one before: both render
    in full."""
    from figdraw_tpu_torch.scenes import make_render_tree_array

    size = port.vec2(384, 216)
    ren = _ren()
    arr = make_render_tree_array(384, 216, 0, copies=4)
    scene = ren.snapshot_scene(arr, size)
    assert ("blur",) in scene.plan.structure
    ren.render_view(scene)
    stats = _partial_hits(monkeypatch)
    arr[0].set_box(2, 30, 40, 120, 90)
    ren.update_scene(scene, arr, dirty=[2])
    assert scene.pending_patch is not None
    got = ren.render_view(scene)
    assert stats["n"] == 0
    assert _equal(got, ren.render_view(ren.snapshot_scene(arr, size)))

    arr, boxes = boxes_scene(8)
    scene = ren.snapshot_scene(arr, SIZE, clear_main=False)
    ren.render_view(scene)
    arr[0].set_box(boxes[1], 90, 90, 26, 38)
    ren.update_scene(scene, arr, dirty=[boxes[1]])
    ren.render_view(scene)
    assert stats["n"] == 0


def test_partial_render_under_zoomed_camera(monkeypatch):
    arr, boxes = boxes_scene(16)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    cam = ((10.0, -6.0), 2.0)
    ren.render_view(scene, *cam)
    stats = _partial_hits(monkeypatch)
    arr[0].set_box(boxes[5], 60, 20, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[5])])
    got = ren.render_view(scene, *cam)
    assert stats["n"] == 1
    assert _equal(got, _fresh_frame(ren, arr, *cam))


def test_partial_accumulates_damage_across_updates(monkeypatch):
    arr, boxes = boxes_scene(16)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    ren.render_view(scene)
    stats = _partial_hits(monkeypatch)
    arr[0].set_box(boxes[1], 200, 30, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[1])])
    arr[0].set_box(boxes[9], 20, 150, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[9])])
    assert len(scene.pending_damage) == 2
    got = ren.render_view(scene)
    assert stats["n"] == 1
    assert _equal(got, _fresh_frame(ren, arr))


def test_back_to_back_same_root_newest_wins():
    """Editing a root again before a render merges on the host with no
    duplicate index: the newest rows win."""
    arr, boxes = boxes_scene(10)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    arr[0].set_box(boxes[1], 100, 30, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[1])])
    arr[0].set_box(boxes[1], 140, 60, 26, 38)
    arr[0].set_rotation(boxes[3], 50.0)
    ren.update_scene(scene, arr, dirty=[(0, boxes[1]), (0, boxes[3])])
    _rows, idx = scene.pending_patch
    assert np.unique(idx).size == idx.size
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))


def test_inert_rows_are_fd_pad_rows_bytes_and_reserve_takes_growth(monkeypatch):
    """snapshot_scene(reserve=...) ends a root's span in inert rows, byte for
    byte native.inert_quad_rows and the JAX package's, so an edit that adds
    quads patches in place up to the reserve; past it the scene snapshots
    again and keeps the reserve."""
    for n in (0, 1, 5):
        assert np.array_equal(native.inert_quad_rows(n).view(np.int32),
                              jax_native.inert_quad_rows(n, "packed").view(np.int32))
    arr, boxes = boxes_scene(10)
    ren = _ren()
    key = (0, boxes[0])
    plain = ren.snapshot_scene(arr, SIZE)
    scene = ren.snapshot_scene(arr, SIZE, reserve={key: 1})
    assert _equal(ren.render_view(scene), ren.render_view(plain))
    s, e = scene.spans[key]
    assert (e - s) - (plain.spans[key][1] - plain.spans[key][0]) == 1
    assert np.array_equal(scene.plan.combo[e - 1 : e].view(np.int32),
                          native.inert_quad_rows(1).view(np.int32))
    stats = _patch_hits(monkeypatch)
    lst = arr[0]
    _set_node(lst, boxes[0], _shadowed())  # one more quad: inside the reserve
    ren.update_scene(scene, arr, dirty=[key])
    assert stats["ok"] == 1 and scene.pending_patch is not None
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))
    two = _shadowed()
    two = Fig(kind=two.kind, screen_box=two.screen_box, corners=two.corners,
              fill=two.fill, shadows=two.shadows * 3)  # past the reserve
    _set_node(lst, boxes[0], two)
    ren.update_scene(scene, arr, dirty=[key])
    assert scene.pending_patch is None and scene.snap_args[3] == {key: 1}
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))


def test_shrinking_root_patches_without_reserve(monkeypatch):
    """A subtree that emits fewer quads than at the snapshot (its shadow
    removed) patches in place: the freed tail becomes inert rows."""
    arr, boxes = boxes_scene(10)
    ren = _ren()
    lst = arr[0]
    _set_node(lst, boxes[0], _shadowed())
    scene = ren.snapshot_scene(arr, SIZE)
    stats = _patch_hits(monkeypatch)
    _set_node(lst, boxes[0], Fig(
        kind=FigKind.nkRectangle, screen_box=rect(5, 8, 26, 38),
        corners=(5,) * 4, fill=fill(rgba(10, 200, 10, 255))))
    ren.update_scene(scene, arr, dirty=[(0, boxes[0])])
    assert stats["ok"] == 1 and scene.pending_patch is not None
    s, e = scene.spans[(0, boxes[0])]
    assert np.array_equal(scene.plan.combo[e - 1 : e].view(np.int32),
                          native.inert_quad_rows(1).view(np.int32))
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))


def test_partial_multi_rect_scattered_edits(monkeypatch):
    """Edits in opposite corners keep separate damage rects; more dirty
    roots than DAMAGE_RECTS merge greedily. All bit-exact."""
    arr, boxes = boxes_scene(40)
    ren = _ren()
    scene = ren.snapshot_scene(arr, SIZE)
    ren.render_view(scene)
    stats = _partial_hits(monkeypatch)
    lst = arr[0]
    lst.set_box(boxes[0], 2, 2, 26, 38)
    lst.set_box(boxes[39], 290, 158, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[0]), (0, boxes[39])])
    assert len(scene.pending_damage) == 2
    got = ren.render_view(scene)
    assert stats["n"] == 1
    assert _equal(got, _fresh_frame(ren, arr))
    dirty = [(0, b) for b in boxes[::5]]
    for b in boxes[::5]:
        lst.set_rotation(b, 25.0)
    ren.update_scene(scene, arr, dirty=dirty)
    assert len(scene.pending_damage) <= DAMAGE_RECTS
    assert _equal(ren.render_view(scene), _fresh_frame(ren, arr))
    assert stats["n"] == 2


def test_merge_damage_prefers_min_growth():
    rects = None
    for i in range(DAMAGE_RECTS):
        rects = merge_damage(rects, (i * 100.0, 0.0, i * 100.0 + 10, 10.0))
    assert len(rects) == DAMAGE_RECTS
    rects = merge_damage(rects, (12.0, 0.0, 20.0, 10.0))
    assert len(rects) == DAMAGE_RECTS
    assert (0.0, 0.0, 20.0, 10.0) in rects


def test_field_setters_match_the_jax_packages():
    """set_fill, set_stroke_fill, set_corners and set_transform_offset write
    the bytes figdraw_tpu's setters write."""
    from figdraw_tpu.fill import linear as jax_linear

    jarr, boxes = jret.boxes_scene(4)
    arr = to_port(jarr)
    b = boxes[1]
    c = [(18, 112, 64, 255), (40, 180, 90, 255), (78, 224, 188, 255)]
    jarr[0].set_fill(b, jax_linear(*(rgba(*v) for v in c), axis=2, mid_pos=140))
    arr[0].set_fill(b, port.linear(*(port.rgba(*v) for v in c),
                                   axis=port.FillGradientAxis.fgaDiagTLBR, mid_pos=140))
    jarr[0].set_stroke_fill(b, jax_linear(rgba(*c[0]), rgba(*c[1])))
    arr[0].set_stroke_fill(b, port.linear(port.rgba(*c[0]), port.rgba(*c[1])))
    jarr[0].set_fill(boxes[2], fill(rgba(1, 2, 3, 4)))
    arr[0].set_fill(boxes[2], port.fill(port.rgba(1, 2, 3, 4)))
    for lst in (jarr[0], arr[0]):
        lst.set_corners(b, (1, 2, 3, 4))
        lst.set_transform_offset(boxes[3], 5.5, -2.25)
    assert (jarr[0].nodes[: jarr[0].count].tobytes()
            == arr[0].nodes[: arr[0].count].tobytes())
    assert arr[7].count == 0 and 7 in arr.layers  # __getitem__ makes the layer


@pytest.mark.parametrize("n_boxes", [30, 300])
def test_build_grid_is_bench_retaineds(n_boxes, monkeypatch):
    import bench_retained

    from figdraw_tpu_torch.scenes import build_grid

    monkeypatch.setattr(bench_retained, "WIDTH", 640)
    monkeypatch.setattr(bench_retained, "HEIGHT", 360)
    jarr, jboxes = bench_retained.build_grid(n_boxes)
    arr, boxes = build_grid(n_boxes, 640, 360)
    assert boxes == jboxes and arr[0].root_ids == jarr[0].root_ids
    assert (arr[0].nodes[: arr[0].count].tobytes()
            == jarr[0].nodes[: jarr[0].count].tobytes())


def test_spans_and_reserved_tape_equal_the_jax_walks():
    """record_spans and reserve give the JAX walk's spans and bytes."""
    from figdraw_tpu.renderer import _bucket

    jarr, boxes = jret.boxes_scene(12)
    arr = to_port(jarr)
    reserve = {(0, boxes[2]): 3, (0, boxes[7]): 1}
    for res in (None, reserve):
        fresh_combo_pools()
        jt = jax_native.flatten_renders_array(
            jarr, W, H, 1.0, 1.0, 1.2, (1, 1, 1, 1), bucket=_bucket, cull=False,
            record_spans=True, reserve=res)
        pt = native.flatten_renders_array(
            arr, W, H, 1.0, 1.0, 1.2, (1, 1, 1, 1), cull=False, record_spans=True,
            reserve=res)
        assert pt.root_spans == jt.root_spans and len(pt.root_spans) == 13
        assert pt.combo.tobytes() == jt.combo.tobytes()
    s, e = pt.root_spans[(0, boxes[2])]
    assert np.array_equal(pt.combo[e - 3 : e].view(np.int32),
                          native.inert_quad_rows(3).view(np.int32))
    jrows = jax_native.walk_roots_packed(jarr, [(0, boxes[2]), (0, boxes[5])],
                                         1.0, 1.0, 1.2)
    prows = native.walk_roots_packed(arr, [(0, boxes[2]), (0, boxes[5])],
                                     1.0, 1.0, 1.2)
    assert prows[1] == jrows[1] and prows[0].tobytes() == jrows[0].tobytes()
    assert native.walk_roots_packed(arr, [(3, 0)], 1.0, 1.0, 1.2) is None
