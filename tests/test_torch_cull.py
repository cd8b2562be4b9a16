"""The tile rasterizer's per-block culling and its in-place contract, on the
CPU against figdraw_tpu.

csrc/raster.cu drops, per 16x16 block, every quad whose bbox widened by
CULL_MARGIN misses the block's pixel centers, skips the mask-plane read
where the fragment has no alpha or the plane is 0, and updates its target
in place. ops/raster.block_survivors states the cull in plain torch and
`_segment_walk(..., cull=True)` composites with it. Here, on the modes
scene (every SDF mode, elliptical corners, rect masks, backdrop), a small
headline, the images_clipped cards at 480x270 with the atlas (rolled) and
the 320x200 rect-mask table (a K3 run):

- the culled walk is bit-identical to the full walk, pass by pass;
- the premise: at every pixel center outside a segment quad's widened bbox
  in its binned tiles, its fragment alpha times its mask plane is exactly
  0 (alpha itself for quads that read plane 0; a bbox the walk clamped to
  its mask plane's support leaves alpha only where that plane is 0);
- the frames stay within 1/255 of the JAX package's;
- the wrappers write their target and nothing else, K3 in place into one
  plane of the mask stack even where its quads read that plane, and a
  frame never writes the caller's init_frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_clipmask
import figdraw_tpu_torch as port
from figdraw_tpu import FigRenderer as JaxRenderer, vec2 as jax_vec2
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.ops import raster_pallas
from figdraw_tpu.scenes import make_render_tree_array as jax_headline
from figdraw_tpu_torch.executor import get_frame_executor
from figdraw_tpu_torch.ops import raster
from figdraw_tpu_torch.ops.binning import bin_quads
from figdraw_tpu_torch.ops.layout import QF_BBOX_X0, QI_MASK, QI_MODE
from figdraw_tpu_torch.ops.quad_eval_planar import eval_quad_planar
from figdraw_tpu_torch.plan import plan_execution, plan_rolled
from figdraw_tpu_torch.resources import ImageMessageBus, put_image
from figdraw_tpu_torch.scenes import (
    IMAGE_ID, make_clip_table_scene, make_image_panels_scene,
    make_render_tree_array, modes_tape, photo_image,
)
from torch_reference import IMAGE_H, IMAGE_N, IMAGE_W, jax_image_frame

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

TOL = 1.0 / 255.0
M = raster.CULL_MARGIN


def test_block_survivors_rule():
    """A block survives when the widened bbox reaches one of its pixel
    centers: edges exactly CULL_MARGIN away from the first or last center
    keep it, anything farther drops it."""
    # tile at (128, 64); its block (1, 2) covers pixels x 160-175, y 80-95,
    # centers 160.5-175.5 and 80.5-95.5
    x0 = torch.tensor([128])
    y0 = torch.tensor([64])
    cases = [  # (bbox, survives block (1, 2))
        ((170.0, 85.0, 171.0, 86.0), True),  # inside
        ((175.5 + M, 85.0, 200.0, 86.0), True),  # starts at the margin
        ((175.5 + M + 0.01, 85.0, 200.0, 86.0), False),
        ((100.0, 85.0, 160.5 - M, 86.0), True),  # ends at the margin
        ((100.0, 85.0, 160.5 - M - 0.01, 86.0), False),
        ((170.0, 95.5 + M, 171.0, 120.0), True),
        ((170.0, 95.5 + M + 0.01, 171.0, 120.0), False),
        ((170.0, 0.0, 171.0, 80.5 - M - 0.01), False),
        ((float("nan"), 85.0, 171.0, 86.0), False),
    ]
    for bbox, want in cases:
        got = raster.block_survivors(torch.tensor([bbox], dtype=torch.float32),
                                     x0, y0, 64)
        assert got.shape == (1, 4, 8)
        assert bool(got[0, 1, 2]) == want, bbox
    # a 1x1 quad in the middle of block (1, 2) and the margin reach no other
    got = raster.block_survivors(torch.tensor([(167.0, 87.0, 168.0, 88.0)]),
                                 x0, y0, 64)
    assert got.sum() == 1


def _premise(args, kw, mask_target):
    """Evaluate every segment quad of every tile at the tile's pixel
    centers; assert fa = alpha * mask is exactly 0 outside the quad's
    widened bbox (alpha itself for plane-0 quads). Returns the number of
    quad-pixels checked and how many of them had alpha != 0 (clamped
    bboxes)."""
    fields, modes, bounds, tile_idx, tile_counts, target, masks = args[:7]
    backdrop = None if mask_target or len(args) < 8 else args[7]
    th = kw["tile_h"]
    _, ph, pw = target.shape
    ty, tx = ph // th, pw // 128
    j_lo, j_hi = raster.run_segments(bounds, tile_idx, tile_counts)
    depth = j_hi - j_lo
    t = torch.repeat_interleave(torch.arange(depth.numel()), depth)
    k = torch.arange(t.numel()) - torch.repeat_interleave(
        torch.cumsum(depth, 0) - depth, depth)
    q = tile_idx[t, j_lo[t] + k].long()
    py_t, px_t = raster.pixel_centers(ty, th, tx, 128, target.device)
    mask_t = raster.to_tiles(masks, ty, th, tx, 128)
    bd_t = None if backdrop is None else raster.to_tiles(backdrop, ty, th, tx, 128)
    checked = clamped = 0
    for s in range(0, q.numel(), 64):
        tb, qb = t[s : s + 64], q[s : s + 64]
        f = fields[qb]
        bd = None if bd_t is None else tuple(bd_t[tb].unbind(1))
        _r, _g, _b, alpha = eval_quad_planar(
            lambda c, f=f: f[:, c, None, None], modes[qb, QI_MODE, None, None],
            px_t[tb], py_t[tb], backdrop_planes=bd, atlas=kw.get("atlas"),
            pixelate=kw.get("pixelate", False),
            subpixel_positioning=kw.get("subpixel_positioning", False))
        mi = modes[qb, QI_MASK].long()
        fa = alpha * mask_t[tb, mi]
        bb = f[:, QF_BBOX_X0 : QF_BBOX_X0 + 4, None, None]
        inside = ((px_t[tb] >= bb[:, 0] - M) & (px_t[tb] <= bb[:, 2] + M)
                  & (py_t[tb] >= bb[:, 1] - M) & (py_t[tb] <= bb[:, 3] + M))
        outside = ~inside.expand_as(fa)
        assert bool((fa[outside] == 0).all())
        plane0 = (mi == 0)[:, None, None] & outside
        assert bool((alpha.expand_as(fa)[plane0] == 0).all())
        checked += int(outside.sum())
        clamped += int((alpha.expand_as(fa)[outside] != 0).sum())
    return checked, clamped


def _walks(args, kw, mask_target):
    """(full walk, culled walk) of one pass's arguments."""
    fields, modes, bounds, tile_idx, tile_counts, target, masks = args[:7]
    backdrop = None if mask_target or len(args) < 8 else args[7]
    flags = (kw.get("atlas"), kw.get("pixelate", False),
             kw.get("subpixel_positioning", False))
    return tuple(raster._segment_walk(
        fields, modes, bounds, tile_idx, tile_counts, target, masks, backdrop,
        kw["tile_h"], mask_target, *flags, cull=cull) for cull in (False, True))


class _Passes:
    """draw / draw_mask for the executor: each pass checks the premise and
    the culled walk against the full walk bit for bit, counts what the cull
    leaves, and returns the culled walk's planes."""

    def __init__(self):
        self.kinds, self.checked, self.clamped = [], 0, 0
        self.pairs = np.zeros(2, np.int64)

    def _run(self, mask_target, args, kw):
        full, culled = _walks(args, kw, mask_target)
        assert torch.equal(full, culled)
        checked, clamped = _premise(args, kw, mask_target)
        self.checked += checked
        self.clamped += clamped
        target = args[5]
        before, after, _blocks = raster.block_pairs(
            args[0], args[2], args[3], args[4], kw["tile_h"], *target.shape[1:])
        self.pairs += (before, after)
        self.kinds.append("mask" if mask_target else "frame")
        return culled

    def draw(self, *args, **kw):
        return self._run(False, args, kw)

    def draw_mask(self, *args, **kw):
        return self._run(True, args, kw)


def _culled_frame(ren, scene, w, h):
    """The scene's plan through the port's frame executor (its rolled form
    for a tape the port would send to the megakernel) with every pass
    checked by _Passes; (frame, passes, the same plan's frame through the
    executor's own passes)."""
    tape = ren.flatten(scene, port.vec2(w, h))
    plan = plan_execution(tape)
    if plan.mega_combo is not None:
        plan = plan_rolled(tape)
    default = ren.execute_plan(plan).clone()  # in-place wrappers
    run = get_frame_executor(plan.structure, plan.height, plan.width,
                             plan.n_masks, plan.has_init_frame, plan.tile_h,
                             rolled=plan.rolled_items is not None)
    passes = _Passes()
    frame = run(torch.from_numpy(plan.combo), None, atlas=ren._device_atlas(),
                pixelate=ren.pixelate, items=plan.rolled_items,
                radii=plan.rolled_radii, draw=passes.draw,
                draw_mask=passes.draw_mask)
    return frame, passes, default


def _port_image_renderer():
    ren = port.FigRenderer(atlas_size=256, device="cpu")
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    put_image(IMAGE_ID, photo_image(), bus=bus, mipmapped=True)
    return ren


def _jax_rectmask(w, h, monkeypatch):
    monkeypatch.setattr(bench_clipmask, "ROWS", 12)
    monkeypatch.setattr(bench_clipmask, "COLS", 6)
    scene = from_renders(bench_clipmask.make_table_scene("rectmask", float(w), float(h)))
    return np.asarray(JaxRenderer(atlas_size=64, use_pallas=True).render_frame(
        scene, jax_vec2(w, h)))


@pytest.mark.parametrize("scene", ["headline", "images_clipped", "rectmask"])
def test_culled_passes_are_bit_identical(scene, monkeypatch):
    if scene == "headline":
        w, h = 384, 216
        ren = port.FigRenderer(device="cpu")
        ours = make_render_tree_array(w, h, 0, copies=10)
        ref = np.asarray(JaxRenderer(atlas_size=64, use_pallas=True).render_frame(
            jax_headline(w, h, 0, copies=10), jax_vec2(w, h)))
        kinds = ["frame", "frame"]
    elif scene == "images_clipped":
        w, h = IMAGE_W, IMAGE_H
        ren = _port_image_renderer()
        ours = make_image_panels_scene(w, h, IMAGE_N, scene)
        ref = jax_image_frame(scene, monkeypatch)[2]
        kinds = ["frame"] + ["mask", "frame"] * IMAGE_N
    else:
        w, h = 320, 200
        ren = port.FigRenderer(device="cpu")
        ours = make_clip_table_scene("rectmask", w, h, 12, 6)
        ref = _jax_rectmask(w, h, monkeypatch)
        kinds = ["frame", "mask", "frame"]
    ren.process_image_messages()
    frame, passes, default = _culled_frame(ren, ours, w, h)
    assert passes.kinds == kinds
    assert torch.equal(frame, default)
    assert np.abs(frame.numpy() - ref).max() <= TOL
    # the checks are not vacuous: the cull drops pairs, and the premise saw
    # pixels outside the bboxes
    before, after = passes.pairs
    assert 0 < after < before
    assert passes.checked > 0
    if scene == "images_clipped":
        assert passes.clamped > 0  # image quads clamped to their card's clip


def _modes_args(th, mask_target, seed=0, w=256, h=128):
    fields, modes, n_live = modes_tape(w, h)
    rng = np.random.RandomState(seed + th)
    modes = modes.copy()
    modes[1:n_live:4, 1] = 1
    modes[2:n_live:5, 1] = 2
    masks = rng.rand(3, h, w).astype(np.float32)
    masks[0] = 1.0
    masks[1][:, : w // 3] = 0.0  # a plane with zeros: reads that give fa = 0
    ft, mt = torch.from_numpy(fields), torch.from_numpy(modes)
    tile_idx, tile_counts = bin_quads(ft, 0, fields.shape[0], h // th, w // 128,
                                      th, 128, modes=None if mask_target else mt)
    target = rng.rand(1 if mask_target else 4, h, w).astype(np.float32)
    args = [ft, mt, torch.tensor([2, n_live - 1], dtype=torch.int32), tile_idx,
            tile_counts, torch.from_numpy(target), torch.from_numpy(masks)]
    if not mask_target:
        args.append(torch.from_numpy(rng.rand(4, h, w).astype(np.float32)))
    return args


@pytest.mark.parametrize("th", [128, 64, 32])
@pytest.mark.parametrize("target", ["frame", "mask"])
def test_culled_walk_is_bit_identical_on_modes_scene(th, target):
    mask_target = target == "mask"
    args = _modes_args(th, mask_target)
    kw = dict(tile_h=th)
    full, culled = _walks(args, kw, mask_target)
    assert torch.equal(full, culled)
    assert _premise(args, kw, mask_target)[0] > 0
    before, after, blocks = raster.block_pairs(args[0], args[2], args[3], args[4],
                                               th, 128, 256)
    assert 0 < after < before and 0 < blocks <= 128
    fields, modes, bounds, tile_idx, tile_counts, tgt, masks = (
        a.numpy() for a in args[:7])
    jax_args = (jnp.asarray(fields), jnp.asarray(modes), jnp.int32(bounds[0]),
                jnp.int32(bounds[1]), jnp.asarray(tile_idx)[:, None, :],
                jnp.asarray(tile_counts), jnp.asarray(tgt), jnp.asarray(masks))
    if mask_target:
        ref = raster_pallas.draw_pass_mask_prebinned(*jax_args, tile_h=th)
    else:
        ref = raster_pallas.draw_pass_planar_prebinned(
            *jax_args, jnp.asarray(args[7].numpy()), tile_h=th)
    assert np.abs(culled.numpy() - np.asarray(ref)).max() <= TOL
    assert np.abs(np.asarray(ref) - tgt).max() > 0.1


@pytest.mark.parametrize("p", [1, 2])
def test_mask_pass_writes_only_its_plane(p):
    """K3 into masks[p : p + 1], a view of the stack, with quads that read
    plane p itself: the pass returns that view, plane p becomes what the
    plain version computes from the planes as they were, every other plane
    keeps its bits, and the JAX kernel (reading the stack before the pass)
    agrees."""
    args = _modes_args(64, True, seed=p)
    fields, modes = args[0], args[1]
    modes[3::3, QI_MASK] = p  # quads that read the plane being written
    masks = args[6]
    before = masks.clone()
    plane = masks[p : p + 1]
    want = raster.draw_pass_mask_prebinned_plain(*args[:5], plane.clone(), before,
                                                 tile_h=64)
    out = raster.draw_pass_mask_prebinned(*args[:5], plane, masks, tile_h=64)
    assert out is plane and out.data_ptr() == masks[p].data_ptr()
    assert torch.equal(masks[p : p + 1], want)
    for k in range(3):
        if k != p:
            assert torch.equal(masks[k], before[k])
    assert (masks[p] != before[p]).any()
    ref = raster_pallas.draw_pass_mask_prebinned(
        jnp.asarray(fields.numpy()), jnp.asarray(modes.numpy()),
        jnp.int32(args[2][0]), jnp.int32(args[2][1]),
        jnp.asarray(args[3].numpy())[:, None, :], jnp.asarray(args[4].numpy()),
        jnp.asarray(before[p : p + 1].numpy()), jnp.asarray(before.numpy()),
        tile_h=64)
    assert np.abs(masks[p : p + 1].numpy() - np.asarray(ref)).max() <= TOL


def test_frame_pass_writes_only_its_target():
    args = _modes_args(128, False)
    planes, masks, backdrop = args[5], args[6], args[7]
    keep = [t.clone() for t in (args[0], args[1], masks, backdrop)]
    want = raster.draw_pass_planar_prebinned_plain(*args[:5], planes.clone(),
                                                   *args[6:], tile_h=128)
    out = raster.draw_pass_planar_prebinned(*args, tile_h=128)
    assert out is planes and torch.equal(planes, want)
    for a, b in zip((args[0], args[1], masks, backdrop), keep):
        assert torch.equal(a, b)


def test_render_frame_leaves_init_frame_unchanged():
    """A frame that does not clear starts from the caller's frame (the
    renderer's last_frame, or init_frame given to the executor) and never
    writes it: the executor pads or expands it into planes of its own."""
    w, h = 256, 128  # whole tiles: no padding copies the frame
    ren = port.FigRenderer(device="cpu")
    first = ren.render_frame(make_render_tree_array(w, h, 0, copies=4), port.vec2(w, h))
    kept = first.clone()
    second = ren.render_frame(make_render_tree_array(w, h, 1, copies=4),
                              port.vec2(w, h), clear_main=False)
    assert torch.equal(first, kept) and not torch.equal(second, kept)
    assert ren.last_frame is second
    tape = ren.flatten(make_render_tree_array(w, h, 2, copies=4), port.vec2(w, h),
                       clear_main=False)
    plan = plan_execution(tape)
    assert plan.has_init_frame
    run = get_frame_executor(plan.structure, plan.height, plan.width,
                             plan.n_masks, True, plan.tile_h)
    init = second.clone()
    frame = run(torch.from_numpy(plan.combo), init)
    assert torch.equal(init, second) and not torch.equal(frame, second)
