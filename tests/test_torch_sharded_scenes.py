"""Device-resident scenes across several devices in figdraw_tpu_torch on
the CPU (ShardedFigRenderer.snapshot_scene, render_view, render_views,
update_scene; FigRenderer.render_views(mesh=)): the tier-1 twins of
tests/test_sharded_perf.py's camera and animation cases,
test_retained.py:296, :334 and :719 and test_camera.py:358, on their scenes
and sizes, with meshes of 2, 4 and 8 `cpu` entries.

The contract is JAX's: the row kernel runs on each device's rows before the
bands split, so a sharded view equals the sharded render of the
transformed scene bit for bit, a patched or damage-clipped view equals a
fresh snapshot's, render_views equals the render_view loop; against the
port's single-device views, within 1/255. A snapshot of figdraw_tpu's
ShardedFigRenderer (its unpacked 70-wide rows) comes over by
scene.from_jax_scene and is viewed and patched by both renderers of the
port. A mesh of two distinct CPU devices takes the copies a second card
would: the scene's rows kept on it between calls and patched or dropped
with the scene's."""

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
import test_retained as jret
import test_sharded_perf as jperf
from figdraw_tpu import vec2 as jax_vec2
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.parallel import sharding as jsh
from figdraw_tpu.scenes import make_render_tree
from figdraw_tpu_torch import native
from figdraw_tpu_torch.parallel import sharding
from figdraw_tpu_torch.parallel.sharding import FRAMES_AXIS, Mesh, ShardedFigRenderer
from figdraw_tpu_torch.scene import from_jax_scene
from torch_reference import to_port

torch.set_num_threads(1)  # see tests/test_torch_render_frame.py

CPU = torch.device("cpu")
W, H = 256, 192
SIZE = port.vec2(W, H)


def cpu_mesh(n, axis=sharding.ROWS_AXIS):
    return Mesh((CPU,) * n, axis)


def _u8(frame):
    return np.clip(np.round(np.asarray(frame) * 255.0), 0, 255).astype(np.int64)


def _words(t):
    return t.numpy().view(np.int32)


def cam_scene(d=(0, 0), z=1):
    return to_port(jperf._cam_scene(d, z))


def clip_cam_scene(d=(0, 0), z=1):
    return to_port(jperf._clip_cam_scene(d, z))


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_camera_is_the_sharded_rewalk_bit_for_bit(n):
    sr = ShardedFigRenderer(cpu_mesh(n), atlas_size=64)
    ref = ShardedFigRenderer(cpu_mesh(n), atlas_size=64)
    snap = sr.snapshot_scene(cam_scene(), SIZE)
    assert snap.replicas == {}  # one distinct device: no copies
    for (dx, dy), z in (((9, -7), 1), ((-13, 11), 2)):
        view = sr.render_view(snap, (dx, dy), zoom=z)
        expect = ref.render_frame(cam_scene((dx, dy), z), SIZE)
        assert np.array_equal(_words(view), _words(expect)), (dx, dy, z)
    one = port.FigRenderer(atlas_size=64, device="cpu")
    a = one.render_view(one.snapshot_scene(cam_scene(), SIZE), (9, -7), zoom=2)
    b = sr.render_view(snap, (9, -7), zoom=2)
    assert np.abs(_u8(a) - _u8(b)).max() <= 1


def test_sharded_camera_on_the_megakernel_is_bit_exact():
    sr = ShardedFigRenderer(cpu_mesh(4), atlas_size=64)
    ref = ShardedFigRenderer(cpu_mesh(4), atlas_size=64)
    snap = sr.snapshot_scene(clip_cam_scene(), SIZE)
    assert snap.kind == "mega"
    view = sr.render_view(snap, (5, -3), zoom=2)
    assert sr.last_plan_kind == "mega"
    expect = ref.render_frame(clip_cam_scene((5, -3), 2), SIZE)
    assert np.array_equal(_words(view), _words(expect))


def _anim_scene(moves=None):
    """test_sharded_perf.py's twelve boxes, the moved ones wrapped in
    nkTransforms; (port RendersArray, root keys)."""
    from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba
    from figdraw_tpu.basics import TransformStyle
    from figdraw_tpu.geometry import Mat3
    from figdraw_tpu.nodesarray import from_renders

    renders = new_renders()
    keys = []
    for i in range(12):
        f = Fig(kind=FigKind.nkRectangle,
                screen_box=rect(8 + (i % 4) * 42, 6 + (i // 4) * 38, 30, 24),
                corners=(5,) * 4,
                fill=fill(rgba(40 + i * 10, (i * 53) % 255, 180, 160)))
        if moves and i in moves:
            a, b, c, d, tx, ty = [float(v) for v in moves[i]]
            tr = renders.add_root(0, Fig(
                kind=FigKind.nkTransform,
                transform=TransformStyle(translation=jax_vec2(tx, ty),
                                         matrix=Mat3(a, b, 0.0, c, d, 0.0))))
            renders.add_child(0, tr, f)
            keys.append(tr)
        else:
            keys.append(renders.add_root(0, f))
    return to_port(from_renders(renders)), keys


def test_sharded_animation_is_the_sharded_rewalk_bit_for_bit():
    moves = {1: (1.0, 0.0, 0.0, 1.0, 12.0, -6.0), 7: (2.0, 0.0, 0.0, 2.0, 4.0, 8.0)}
    sr = ShardedFigRenderer(cpu_mesh(4), atlas_size=64)
    base, keys = _anim_scene()
    snap = sr.snapshot_scene(base, SIZE)
    table = {keys[i]: m for i, m in moves.items()}
    view = sr.render_view(snap, root_transforms=table)
    wrapped, _ = _anim_scene(moves)
    expect = ShardedFigRenderer(cpu_mesh(4), atlas_size=64).render_frame(wrapped, SIZE)
    assert np.array_equal(_words(view), _words(expect))
    one = port.FigRenderer(atlas_size=64, device="cpu")
    a = one.render_view(one.snapshot_scene(base, SIZE), root_transforms=table)
    assert np.abs(_u8(a) - _u8(view)).max() <= 1


def test_sharded_views_equal_the_render_view_loop():
    sr = ShardedFigRenderer(cpu_mesh(4), atlas_size=64)
    snap = sr.snapshot_scene(cam_scene(), SIZE)
    pans = [(3.0 * i, -2.0 * i) for i in range(5)]
    zooms = [1.0, 2.0, 1.5, 1.0, 0.75]
    stack = sr.render_views(snap, pans, zooms, chunk=2)
    assert tuple(stack.shape) == (5, H, W, 4)
    for i, (p, z) in enumerate(zip(pans, zooms)):
        assert torch.equal(stack[i], sr.render_view(snap, p, zoom=z)), i
    u8 = sr.render_views(snap, pans[:2], 2.0, as_uint8=True)
    assert u8.dtype == torch.uint8
    assert np.array_equal(u8[1].numpy(), _u8(sr.render_view(snap, pans[1], zoom=2.0)))


def test_frame_that_does_not_clear_starts_from_the_last_bands():
    """A frame that does not clear starts from the last frame's bands, the
    rows past the frame's height included (JAX's _last_padded): the blur
    near the bottom edge reads them, as JAX's sharded frames do."""
    jarr = from_renders(make_render_tree(256.0, 160.0, frame=1, copies=2))
    size = port.vec2(256, 160)
    sr = ShardedFigRenderer(cpu_mesh(4), atlas_size=64)
    jr = jsh.ShardedFigRenderer(jsh.default_mesh(4), atlas_size=64, use_pallas=False)
    for clear_main in (True, False, False):
        got = sr.render_frame(to_port(jarr), size, clear_main=clear_main)
        want = np.asarray(jr.render_frame(jarr, jax_vec2(256, 160), clear_main=clear_main))
        assert float(np.abs(got.numpy() - want).max()) <= 1.0 / 255.0


# --- retained scenes on the mesh -----------------------------------------------------


RW, RH = jret.W, jret.H
RSIZE = port.vec2(RW, RH)


def _patch_hits(monkeypatch):
    stats = {"calls": 0, "ok": 0}
    orig = native.walk_roots_packed

    def counting(*a, **k):
        stats["calls"] += 1
        out = orig(*a, **k)
        stats["ok"] += out is not None
        return out

    monkeypatch.setattr(native, "walk_roots_packed", counting)
    return stats


def test_sharded_update_scene_patches_in_place_and_falls_back(monkeypatch):
    """test_retained.py:296: the rows on every device patch in place and
    match a fresh sharded snapshot; a structural edit snapshots again,
    still exact."""
    import test_torch_retained as pret

    arr, boxes = jret.boxes_scene(24)
    arr = to_port(arr)
    ren = ShardedFigRenderer(cpu_mesh(2), atlas_size=64)
    scene = ren.snapshot_scene(arr, RSIZE)
    assert scene.spans is not None
    stats = _patch_hits(monkeypatch)
    lst = arr[0]
    for b in boxes[3:9]:
        lst.set_box(b, 5 + (b % 10) * 31, 25 + (b // 10) * 40, 26, 38)
        lst.set_solid_color(b, port.rgba(245, 190, 40, 210))
    ren.update_scene(scene, arr, dirty=[(0, b) for b in boxes[3:9]])
    assert stats["ok"] == 1
    got = ren.render_view(scene, pan=(2.0, 1.0))
    want = ren.render_view(ren.snapshot_scene(arr, RSIZE), pan=(2.0, 1.0))
    assert torch.equal(got, want)
    pret._set_node(lst, boxes[0], pret._shadowed())  # one more quad: a new snapshot
    ren.update_scene(scene, arr, dirty=[(0, boxes[0])])
    got = ren.render_view(scene)
    want = ren.render_view(ren.snapshot_scene(arr, RSIZE))
    assert torch.equal(got, want)


def test_sharded_patch_matches_the_single_device_patch():
    """test_retained.py:334: a patched sharded scene equals the patched
    single-device scene within 1/255."""
    arr, boxes = jret.boxes_scene(24)
    arr = to_port(arr)
    single = port.FigRenderer(atlas_size=64, device="cpu")
    sharded = ShardedFigRenderer(cpu_mesh(8), atlas_size=64)
    s1 = single.snapshot_scene(arr, RSIZE)
    s2 = sharded.snapshot_scene(arr, RSIZE)
    arr[0].set_rotation(boxes[7], 45.0)
    arr[0].set_box(boxes[7], 120, 60, 40, 50)
    single.update_scene(s1, arr, dirty=[(0, boxes[7])])
    sharded.update_scene(s2, arr, dirty=[(0, boxes[7])])
    assert np.abs(_u8(single.render_view(s1)) - _u8(sharded.render_view(s2))).max() <= 1


def test_sharded_damage_clipped_view_equals_the_full_one(monkeypatch):
    """test_retained.py:719: same-camera updates on the mesh take the
    damage clip (quads outside the rects dropped from each band's binning,
    the last frame's pixels outside them) and equal a fresh sharded
    snapshot bit for bit."""
    arr, boxes = jret.boxes_scene(20)
    arr = to_port(arr)
    ren = ShardedFigRenderer(cpu_mesh(4), atlas_size=64)
    scene = ren.snapshot_scene(arr, RSIZE)
    ren.render_view(scene, (1.0, 2.0))
    clipped = {"n": 0}
    orig = sharding.damage_spans

    def counting(*a, **k):
        clipped["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(sharding, "damage_spans", counting)
    lst = arr[0]
    for step in range(2):
        b = boxes[6 + step]
        lst.set_box(b, 40 + 30 * step, 60, 26, 38)
        lst.set_solid_color(b, port.rgba(20, 220, 180, 230))
        ren.update_scene(scene, arr, dirty=[(0, b)])
        got = ren.render_view(scene, (1.0, 2.0))
        want = ren.render_view(ren.snapshot_scene(arr, RSIZE), (1.0, 2.0))
        assert clipped["n"] == step + 1, "the damage clip was not taken"
        assert torch.equal(got, want), step


# --- frame-parallel views ------------------------------------------------------------


def test_render_views_over_a_mesh_equal_the_loop():
    """test_camera.py:358: each device renders whole views of a round; the
    views equal the render_view loop bit for bit, on the unrolled executor
    and the megakernel."""
    import test_camera as jcam

    size = port.vec2(176, 144)
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    scene = ren.snapshot_scene(to_port(jcam.boxes_scene()), size)
    pans = [(float(3 * i), float(-2 * i)) for i in range(11)]
    stack = ren.render_views(scene, pans, zooms=1.0, chunk=2,
                             mesh=cpu_mesh(4, FRAMES_AXIS))
    assert tuple(stack.shape) == (11, 144, 176, 4)
    for i, p in enumerate(pans):
        assert torch.equal(stack[i], ren.render_view(scene, p)), i
    mega = ren.snapshot_scene(to_port(jcam.clip_scene_view()), port.vec2(192, 152))
    assert mega.kind == "mega"
    u8 = ren.render_views(mega, pans[:3], zooms=2.0, as_uint8=True, chunk=1,
                          mesh=cpu_mesh(2, FRAMES_AXIS))
    for i, p in enumerate(pans[:3]):
        assert np.array_equal(u8[i].numpy(), ren.take_screenshot(ren.render_view(mega, p, 2.0)))


# --- a snapshot of figdraw_tpu's ShardedFigRenderer -------------------------------------


def test_a_jax_sharded_snapshot_is_viewed_and_patched_by_the_port():
    """from_jax_scene takes a scene figdraw_tpu's ShardedFigRenderer
    snapshot (unpacked 70-wide rows): both of the port's renderers view it
    as JAX's sharded renderer does (1/255) and as the port's own snapshot
    (bit for bit), and the port patches it."""
    jarr, boxes = jret.boxes_scene(24)
    jr = jsh.ShardedFigRenderer(jsh.default_mesh(4), atlas_size=64, use_pallas=False)
    jscene = jr.snapshot_scene(jarr, jax_vec2(RW, RH))
    assert np.asarray(jscene.combo_dev).shape[1] == 70
    jview = np.asarray(jr.render_view(jscene, (3.0, -2.0)))
    scene = from_jax_scene(jscene, CPU)
    assert scene.kind == "unrolled" and scene.spans
    sr = ShardedFigRenderer(cpu_mesh(4), atlas_size=64)
    view = sr.render_view(scene, (3.0, -2.0))
    assert float(np.abs(view.numpy() - jview).max()) <= 1.0 / 255.0
    arr = to_port(jarr)
    own = sr.render_view(sr.snapshot_scene(arr, RSIZE), (3.0, -2.0))
    assert torch.equal(view, own)
    one = port.FigRenderer(atlas_size=64, device="cpu")
    assert torch.equal(one.render_view(from_jax_scene(jscene, CPU), (3.0, -2.0)), own)
    arr[0].set_box(boxes[4], 150, 90, 40, 30)
    sr.update_scene(scene, arr, dirty=[(0, boxes[4])])
    assert torch.equal(sr.render_view(scene), sr.render_view(sr.snapshot_scene(arr, RSIZE)))


def test_a_jax_sharded_megakernel_snapshot_comes_over():
    jr = jsh.ShardedFigRenderer(jsh.default_mesh(2), atlas_size=64, use_pallas=True)
    jscene = jr.snapshot_scene(jperf._clip_cam_scene(), jax_vec2(W, H))
    assert jscene.kind == "mega"
    scene = from_jax_scene(jscene, CPU)
    assert scene.kind == "mega"
    sr = ShardedFigRenderer(cpu_mesh(2), atlas_size=64)
    got = sr.render_view(scene, (5, -3), zoom=2)
    want = sr.render_view(sr.snapshot_scene(clip_cam_scene(), SIZE), (5, -3), zoom=2)
    assert torch.equal(got, want)


# --- copies on a second device -------------------------------------------------------

# a mesh of two distinct CPU devices: torch compares cpu:1 unequal to a CPU
# tensor's device, so the scene's rows, the atlas and the parts of a round
# are copied as they are to a second card, and the copies' upkeep is checked
TWO = (CPU, torch.device("cpu", 1))


def test_render_views_keep_their_copies_until_a_patch():
    """FigRenderer.render_views over two distinct devices: the second
    device's copy of the rows is made once and kept between calls; a patch
    drops it, and the next views equal the patched scene's render_view loop
    bit for bit."""
    arr, boxes = jret.boxes_scene(24)
    arr = to_port(arr)
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    scene = ren.snapshot_scene(arr, RSIZE)
    mesh = Mesh(TWO, FRAMES_AXIS)
    pans = [(float(3 * i), float(-2 * i)) for i in range(5)]
    first = ren.render_views(scene, pans, chunk=2, mesh=mesh)
    assert set(scene.replicas) == {TWO[1]}
    rows = scene.replicas[TWO[1]][0]
    again = ren.render_views(scene, pans, chunk=2, mesh=mesh)
    assert scene.replicas[TWO[1]][0] is rows  # kept, not copied again
    assert torch.equal(first, again)
    for i, p in enumerate(pans):
        assert torch.equal(first[i], ren.render_view(scene, p)), i
    for b in boxes[3:7]:
        arr[0].set_box(b, 5 + (b % 10) * 31, 25 + (b // 10) * 40, 26, 38)
        arr[0].set_solid_color(b, port.rgba(245, 190, 40, 210))
    ren.update_scene(scene, arr, dirty=[(0, b) for b in boxes[3:7]])
    patched = ren.render_views(scene, pans, chunk=2, mesh=mesh)
    assert not torch.equal(patched, first)
    for i, p in enumerate(pans):
        assert torch.equal(patched[i], ren.render_view(scene, p)), i


def test_sharded_patch_reaches_every_copy_of_the_rows():
    """ShardedFigRenderer over two distinct devices: a patch goes into the
    rows on both, and the view equals a fresh sharded snapshot's bit for
    bit; each band's atlas copy is kept while the atlas is unchanged."""
    arr, boxes = jret.boxes_scene(24)
    arr = to_port(arr)
    ren = ShardedFigRenderer(Mesh(TWO), atlas_size=64)
    scene = ren.snapshot_scene(arr, RSIZE)
    assert set(scene.replicas) == {TWO[1]}
    for b in boxes[3:9]:
        arr[0].set_box(b, 5 + (b % 10) * 31, 25 + (b // 10) * 40, 26, 38)
        arr[0].set_solid_color(b, port.rgba(245, 190, 40, 210))
    ren.update_scene(scene, arr, dirty=[(0, b) for b in boxes[3:9]])
    got = ren.render_view(scene, pan=(2.0, 1.0))
    assert torch.equal(scene.replicas[TWO[1]][0], scene.combo_dev)
    want = ren.render_view(ren.snapshot_scene(arr, RSIZE), pan=(2.0, 1.0))
    assert torch.equal(got, want)
    atlases = ren._atlases()
    assert ren._atlases()[TWO[1]] is atlases[TWO[1]]
