"""figdraw_tpu_torch's CUDA kernels (K1, K1-atlas and K3 in csrc/raster.cu,
K4 and K4-atlas in csrc/mega.cu, the row transform in csrc/rows.cu, the
backdrop blur in csrc/blur.cu and the tile binning in csrc/binning.cu)
against their plain torch versions on an NVIDIA card, and the card's
machine building and running the host helpers of the frames' inputs (the
Brotli decoder of WOFF2 faces). Every
test here needs the card (marker `cuda`) and skips without one. The file
imports neither jax nor figdraw_tpu, so it also runs on a machine without
them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from figdraw_tpu_torch import FigRenderer, vec2
from figdraw_tpu_torch.executor import (
    get_frame_executor, get_mega_executor,
)
from figdraw_tpu_torch import executor
from figdraw_tpu_torch.ops import binning, blur, mega, raster, rows
from figdraw_tpu_torch.ops.binning import (
    MAX_RUNS, bin_quads, bin_quads_model, bin_quads_plain, decode_and_bin,
    decode_and_bin_plain, lists_equal, unpack_combo, unpack_combo_plain,
)
from figdraw_tpu_torch.ops.layout import PACKED_WIDTH, QF_WIDTH, QI_MODE, pack_fields_np
from figdraw_tpu_torch.plan import atlas_from_jax, plan_execution, plan_rolled
from figdraw_tpu_torch.resources import ImageMessageBus, put_image
from figdraw_tpu_torch.scenes import (
    FONT_TEXT_CASES, IMAGE_ID, atlas_modes_tape, binning_tape, load_text_tape, make_clip_table_scene,
    build_grid, make_image_panels_scene, make_render_tree_array, mega_modes_tape,
    modes_tape, photo_image,
)

TOL = 1.0 / 255.0

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA only")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("th", [128, 64, 32])
def test_raster_kernel_matches_plain(th, dev):
    w, h = 512, 256
    fields, modes, n_live = modes_tape(w, h)
    rng = np.random.RandomState(th)
    modes[1:n_live:5, 1] = 1  # some quads read the second mask plane
    f, m = torch.from_numpy(fields).to(dev), torch.from_numpy(modes).to(dev)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], h // th, w // 128, th,
                                      128, modes=m)
    planes, backdrop, mask1 = (torch.from_numpy(rng.rand(*s).astype(np.float32)).to(dev)
                               for s in ((4, h, w), (4, h, w), (1, h, w)))
    masks = torch.cat([torch.ones_like(mask1), mask1])
    bounds = torch.tensor([0, n_live], dtype=torch.int32, device=dev)
    args = (f, m, bounds, tile_idx, tile_counts, planes, masks, backdrop)
    planes0 = planes.clone()  # the kernel updates planes in place
    before = raster.LAUNCHES
    out = raster.draw_pass_planar_prebinned(*args, tile_h=th)
    assert raster.LAUNCHES == before + 1 and out is planes
    ref = raster.draw_pass_planar_prebinned_plain(
        f, m, bounds, tile_idx, tile_counts, planes0, masks, backdrop, tile_h=th)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= TOL
    assert float((out - planes0).abs().max()) > 0.1


def test_headline_frame_matches_plain_executor(dev):
    ren = FigRenderer(device="cuda")
    tape = ren.flatten(make_render_tree_array(1920, 1080, 5, copies=100),
                       vec2(1920, 1080))
    plan = plan_execution(tape)
    before = raster.LAUNCHES
    frame = ren.execute_plan(plan)
    assert raster.LAUNCHES == before + 2
    run = get_frame_executor(plan.structure, plan.height, plan.width,
                             plan.n_masks, plan.has_init_frame, plan.tile_h)
    ref = run(torch.from_numpy(plan.combo).to(dev), None,
              draw=raster.draw_pass_planar_prebinned_plain)
    torch.cuda.synchronize()
    assert tuple(frame.shape) == (1080, 1920, 4)
    assert float((frame - ref).abs().max()) <= TOL


def test_wrapper_rejects_bad_arguments(dev):
    fields, modes, n_live = modes_tape(256, 128)
    f, m = torch.from_numpy(fields).to(dev), torch.from_numpy(modes).to(dev)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], 1, 2, 128, 128, modes=m)
    planes = torch.zeros((4, 128, 256), device=dev)
    masks = torch.ones((1, 128, 256), device=dev)
    bounds = torch.tensor([0, n_live], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        raster.draw_pass_planar_prebinned(f, m.long(), bounds, tile_idx,
                                          tile_counts, planes, masks)
    with pytest.raises(ValueError, match="contiguous"):
        raster.draw_pass_planar_prebinned(f, m, bounds, tile_idx, tile_counts,
                                          planes.transpose(1, 2).contiguous().transpose(1, 2),
                                          masks)
    with pytest.raises(ValueError, match="is on"):
        raster.draw_pass_planar_prebinned(f.cpu(), m, bounds, tile_idx,
                                          tile_counts, planes, masks)


def _mask_args(th, dev, w=512, h=256):
    """K3's inputs: the modes tape (every SDF mode), three mask planes read
    by some quads, a seeded target plane and the binning."""
    fields, modes, n_live = modes_tape(w, h)
    rng = np.random.RandomState(th)
    modes[1:n_live:4, 1] = 1
    modes[2:n_live:5, 1] = 2
    f, m = torch.from_numpy(fields).to(dev), torch.from_numpy(modes).to(dev)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], h // th, w // 128, th, 128)
    masks = torch.from_numpy(rng.rand(3, h, w).astype(np.float32)).to(dev)
    masks[0] = 1.0
    target = torch.from_numpy(rng.rand(1, h, w).astype(np.float32)).to(dev)
    bounds = torch.tensor([3, n_live - 2], dtype=torch.int32, device=dev)
    return f, m, bounds, tile_idx, tile_counts, target, masks


@pytest.mark.parametrize("th", [128, 64, 32])
def test_mask_kernel_matches_plain(th, dev):
    args = _mask_args(th, dev)
    target0 = args[5].clone()  # the kernel updates the target in place
    before = raster.MASK_LAUNCHES
    out = raster.draw_pass_mask_prebinned(*args, tile_h=th)
    assert raster.MASK_LAUNCHES == before + 1 and out is args[5]
    ref = raster.draw_pass_mask_prebinned_plain(*args[:5], target0, args[6], tile_h=th)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (1, 256, 512) and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= TOL
    assert float((out - target0).abs().max()) > 0.1


@pytest.mark.parametrize("p", [1, 2])
def test_mask_kernel_in_place_reads_its_own_plane(p, dev):
    """K3 into masks[p : p + 1], a view of the stack, with quads that read
    plane p itself: each pixel's reads see the plane as it was before the
    pass, and every other plane keeps its bits."""
    f, m, bounds, tile_idx, tile_counts, _target, masks = _mask_args(64, dev)
    m[3::3, 1] = p
    before = masks.clone()
    plane = masks[p : p + 1]
    out = raster.draw_pass_mask_prebinned(f, m, bounds, tile_idx, tile_counts,
                                          plane, masks, tile_h=64)
    ref = raster.draw_pass_mask_prebinned_plain(
        f, m, bounds, tile_idx, tile_counts, before[p : p + 1].clone(), before,
        tile_h=64)
    torch.cuda.synchronize()
    assert out is plane
    assert float((masks[p : p + 1] - ref).abs().max()) <= TOL
    assert float((masks[p] - before[p]).abs().max()) > 0.1
    for k in range(masks.shape[0]):
        if k != p:
            assert torch.equal(masks[k], before[k])


def _mega_args(n_masks, th, dev, w=512, h=256, atlas_size=None):
    """The megakernel's inputs: scenes.mega_modes_tape (targets and mask
    reads out of range, targets of plane 0, clear sentinels with their
    plane's bbox union) and its binning. Returns (fields, modes, tile_idx,
    tile_counts, planes, atlas or None)."""
    fields, modes, atlas = mega_modes_tape(n_masks, n_masks * 1000 + th, w, h,
                                           atlas_size)
    assert (modes[:, QI_MODE] >> mega.MEGA_TARGET_SHIFT == 1).any()
    if atlas is not None:
        atlas = torch.from_numpy(atlas).to(dev)
    f, m = torch.from_numpy(fields).to(dev), torch.from_numpy(modes).to(dev)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], h // th, w // 128, th, 128)
    rng = np.random.RandomState(th)
    planes = torch.from_numpy(rng.rand(4, h, w).astype(np.float32)).to(dev)
    return f, m, tile_idx, tile_counts, planes, atlas


@pytest.mark.parametrize("n_masks,th", [(1, 128), (3, 128), (3, 64), (3, 32),
                                        (mega.MAX_PLANES, 64)])
def test_mega_kernel_matches_plain(n_masks, th, dev):
    """K4 against its plain version, in place: only the frame planes
    change, and the culled plain walk gives the full walk's planes."""
    *args, planes, _atlas = _mega_args(n_masks, th, dev)
    others = [t.clone() for t in args]
    before = (mega.LAUNCHES, mega.ATLAS_LAUNCHES)
    target = planes.clone()
    out = mega.draw_pass_mega(*args, target, n_masks, tile_h=th)
    assert (mega.LAUNCHES, mega.ATLAS_LAUNCHES) == (before[0] + 1, before[1])
    assert out is target
    ref = mega.draw_pass_mega_plain(*args, planes, n_masks, tile_h=th)
    culled = mega.draw_pass_mega_plain(*args, planes, n_masks, tile_h=th, cull=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= TOL
    assert float((culled - ref).abs().max()) <= 1e-6
    assert float((out - planes).abs().max()) > 0.1
    for a, b in zip(args, others):
        assert torch.equal(a, b)


@pytest.mark.parametrize("size,n_masks,th", [(64, 3, 64), (256, 1, 128),
                                             (256, 4, 32), (1024, 3, 64)])
def test_mega_atlas_kernel_matches_plain(size, n_masks, th, dev):
    """K4-atlas against its plain version on the atlas modes tape with
    targets, mask reads and clears: bilinear and nearest, with and without
    the subpixel shift; without the atlas the same tape is another frame."""
    *args, planes, atlas = _mega_args(n_masks, th, dev, atlas_size=size)
    for pixelate, subpixel in ((False, False), (False, True), (True, False)):
        kw = dict(tile_h=th, atlas=atlas, pixelate=pixelate,
                  subpixel_positioning=subpixel)
        before = (mega.LAUNCHES, mega.ATLAS_LAUNCHES)
        target = planes.clone()
        out = mega.draw_pass_mega(*args, target, n_masks, **kw)
        assert (mega.LAUNCHES, mega.ATLAS_LAUNCHES) == (before[0], before[1] + 1)
        assert out is target
        ref = mega.draw_pass_mega_plain(*args, planes, n_masks, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        assert float((out - ref).abs().max()) <= TOL
        assert float((out - planes).abs().max()) > 0.1
    boxes = mega.draw_pass_mega(*args, planes.clone(), n_masks, tile_h=th)
    assert float((boxes - ref).abs().max()) > 0.1


def test_mega_on_cpu_tensors_never_reaches_the_kernel(dev):
    *args, planes, atlas = (t.cpu() for t in _mega_args(3, 64, dev, atlas_size=64))
    before = (mega.LAUNCHES, mega.ATLAS_LAUNCHES)
    want = mega.draw_pass_mega_plain(*args, planes, 3, tile_h=64, atlas=atlas)
    out = mega.draw_pass_mega(*args, planes, 3, tile_h=64, atlas=atlas)
    assert (mega.LAUNCHES, mega.ATLAS_LAUNCHES) == before
    assert out is planes and torch.equal(out, want)


def test_mask_and_mega_wrappers_reject_bad_arguments(dev):
    f, m, bounds, tile_idx, tile_counts, target, masks = _mask_args(64, dev)
    with pytest.raises(ValueError, match="float32"):
        raster.draw_pass_mask_prebinned(f, m, bounds, tile_idx, tile_counts,
                                        target.double(), masks, tile_h=64)
    with pytest.raises(ValueError, match="contiguous"):
        raster.draw_pass_mask_prebinned(f, m, bounds, tile_idx, tile_counts,
                                        target, masks.transpose(1, 2).contiguous()
                                        .transpose(1, 2), tile_h=64)
    with pytest.raises(ValueError, match="is on"):
        raster.draw_pass_mask_prebinned(f, m.cpu(), bounds, tile_idx,
                                        tile_counts, target, masks, tile_h=64)
    with pytest.raises(ValueError, match="target planes"):
        raster.draw_pass_mask_prebinned(f, m, bounds, tile_idx, tile_counts,
                                        masks, masks, tile_h=64)
    f, m, tile_idx, tile_counts, planes, _atlas = _mega_args(3, 64, dev)
    with pytest.raises(ValueError, match="MAX_PLANES"):
        mega.draw_pass_mega(f, m, tile_idx, tile_counts, planes,
                            mega.MAX_PLANES + 1, tile_h=64)
    with pytest.raises(ValueError, match="int32"):
        mega.draw_pass_mega(f, m.long(), tile_idx, tile_counts, planes, 3,
                            tile_h=64)
    with pytest.raises(ValueError, match="is on"):
        mega.draw_pass_mega(f, m, tile_idx.cpu(), tile_counts, planes, 3,
                            tile_h=64)
    with pytest.raises(ValueError, match="contiguous"):
        mega.draw_pass_mega(f, m, tile_idx, tile_counts,
                            planes.transpose(1, 2).contiguous().transpose(1, 2),
                            3, tile_h=64)
    with pytest.raises(ValueError, match="aligned"):
        mega.draw_pass_mega(f.reshape(-1)[1 : 1 + (f.shape[0] - 1) * QF_WIDTH]
                            .reshape(-1, QF_WIDTH), m[:-1], tile_idx[:, :-1].contiguous(),
                            tile_counts, planes, 3, tile_h=64)
    atlas = torch.rand((64, 64, 4), device=dev)
    with pytest.raises(ValueError, match="atlas is on"):
        mega.draw_pass_mega(f, m, tile_idx, tile_counts, planes, 3, tile_h=64,
                            atlas=atlas.cpu())
    with pytest.raises(ValueError, match="atlas must be"):
        mega.draw_pass_mega(f, m, tile_idx, tile_counts, planes, 3, tile_h=64,
                            atlas=atlas[:, :32].contiguous())


@pytest.mark.parametrize("kind", ["rectmask", "subclip"])
def test_clip_table_matches_plain_executor(kind, dev):
    """The reduced clip table (12x6 at 320x200) through render_frame: K1 and
    K3 for the rect-mask table, K4 alone for the sub-clip one, and the same
    executor with the plain versions gives the same frame."""
    ren = FigRenderer(device="cuda")
    scene = make_clip_table_scene(kind, 320, 200, 12, 6)
    counts = (raster.LAUNCHES, raster.MASK_LAUNCHES, mega.LAUNCHES)
    frame = ren.render_frame(scene, vec2(320, 200))
    counts = tuple(b - a for a, b in zip(
        counts, (raster.LAUNCHES, raster.MASK_LAUNCHES, mega.LAUNCHES)))
    tape = ren.flatten(scene, vec2(320, 200))
    plan = plan_execution(tape)
    if kind == "rectmask":
        assert counts == (2, 1, 0)
        run = get_frame_executor(plan.structure, 200, 320, plan.n_masks, False,
                                 plan.tile_h)
        ref = run(torch.from_numpy(plan.combo).to(dev), None,
                  draw=raster.draw_pass_planar_prebinned_plain,
                  draw_mask=raster.draw_pass_mask_prebinned_plain)
    else:
        assert counts == (0, 0, 1)
        run = get_mega_executor(200, 320, plan.n_masks, False, plan.tile_h)
        ref = run(torch.from_numpy(plan.mega_combo).to(dev), None,
                  draw=mega.draw_pass_mega_plain)
    torch.cuda.synchronize()
    assert tuple(frame.shape) == (200, 320, 4)
    assert float((frame - ref).abs().max()) <= TOL


def _atlas_args(size, th, dev, w=512, h=256, seed=None):
    """K1-atlas's inputs: the atlas modes tape (modes 0 and 13-16 at 1:1,
    minified, scaled, rotated and flipped, SDF boxes between) on a seeded
    (size, size, 4) atlas, some quads reading a second mask plane, seeded
    planes and the binning."""
    fields, modes, n, atlas = atlas_modes_tape(w, h, size, seed=size if seed is None else seed)
    modes[1:n:4, 1] = 1
    rng = np.random.RandomState(size)
    f, m = torch.from_numpy(fields).to(dev), torch.from_numpy(modes).to(dev)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], h // th, w // 128, th, 128)
    planes, mask1 = (torch.from_numpy(rng.rand(*s).astype(np.float32)).to(dev)
                     for s in ((4, h, w), (1, h, w)))
    masks = torch.cat([torch.ones_like(mask1), mask1])
    bounds = torch.tensor([0, n], dtype=torch.int32, device=dev)
    return (f, m, bounds, tile_idx, tile_counts, planes, masks,
            torch.from_numpy(atlas).to(dev))


@pytest.mark.parametrize("size", [64, 256, 1024])
def test_atlas_kernel_matches_plain(size, dev):
    """K1-atlas and K3 with the atlas, bilinear and nearest, with and
    without the subpixel shift, on an atlas smaller than a tile (64), the
    image benchmark's (256) and a large one (1024)."""
    f, m, bounds, tile_idx, tile_counts, planes, masks, atlas = _atlas_args(size, 64, dev)
    for pixelate, subpixel in ((False, False), (False, True), (True, False)):
        kw = dict(tile_h=64, atlas=atlas, pixelate=pixelate,
                  subpixel_positioning=subpixel)
        # the kernels update their targets in place: each pass gets fresh
        # copies, and the plain versions the planes as they were
        target, stack = planes.clone(), masks.clone()
        before = (raster.LAUNCHES, raster.ATLAS_LAUNCHES)
        out = raster.draw_pass_planar_prebinned(f, m, bounds, tile_idx, tile_counts,
                                                target, masks, **kw)
        assert (raster.LAUNCHES, raster.ATLAS_LAUNCHES) == (before[0], before[1] + 1)
        ref = raster.draw_pass_planar_prebinned_plain(f, m, bounds, tile_idx,
                                                      tile_counts, planes, masks, **kw)
        mask_out = raster.draw_pass_mask_prebinned(f, m, bounds, tile_idx, tile_counts,
                                                   stack[1:], stack, **kw)
        mask_ref = raster.draw_pass_mask_prebinned_plain(f, m, bounds, tile_idx,
                                                         tile_counts, masks[1:], masks, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(mask_out).all())
        assert float((out - ref).abs().max()) <= TOL
        assert float((mask_out - mask_ref).abs().max()) <= TOL
        assert float((out - planes).abs().max()) > 0.1


def test_pixelate_on_minified_draws_matches_plain(dev):
    """Nearest sampling on draws minified by exactly 2 puts texel
    boundaries on pixel centers: a floor that rounded otherwise would pick
    another texel outright, so kernel and plain version agree to rounding."""
    f, m, bounds, tile_idx, tile_counts, planes, masks, atlas = _atlas_args(256, 128, dev, seed=7)
    minified = torch.arange(f.shape[0], device=dev) % 7 == 1
    m = torch.where(minified[:, None], m, torch.zeros_like(m))
    f = torch.where(minified[:, None], f, torch.zeros_like(f))
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], 2, 4, 128, 128)
    kw = dict(tile_h=128, atlas=atlas, pixelate=True)
    out = raster.draw_pass_planar_prebinned(f, m, bounds, tile_idx, tile_counts,
                                            planes.clone(), masks, **kw)
    ref = raster.draw_pass_planar_prebinned_plain(f, m, bounds, tile_idx, tile_counts,
                                                  planes, masks, **kw)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5
    assert float((out - planes).abs().max()) > 0.1


def test_wrappers_name_a_bad_atlas(dev):
    f, m, bounds, tile_idx, tile_counts, planes, masks, atlas = _atlas_args(64, 64, dev)
    args = (f, m, bounds, tile_idx, tile_counts, planes, masks)
    with pytest.raises(ValueError, match="atlas is on"):
        raster.draw_pass_planar_prebinned(*args, tile_h=64, atlas=atlas.cpu())
    with pytest.raises(ValueError, match="atlas must be torch.float32"):
        raster.draw_pass_planar_prebinned(*args, tile_h=64, atlas=atlas.double())
    with pytest.raises(ValueError, match="atlas must be"):
        raster.draw_pass_mask_prebinned(f, m, bounds, tile_idx, tile_counts,
                                        masks[1:], masks, tile_h=64,
                                        atlas=atlas[:, :32].contiguous())
    with pytest.raises(ValueError, match="atlas must be contiguous"):
        raster.draw_pass_mask_prebinned(f, m, bounds, tile_idx, tile_counts,
                                        masks[1:], masks, tile_h=64,
                                        atlas=atlas.transpose(0, 1))


def _image_renderer():
    ren = FigRenderer(atlas_size=256, device="cuda")
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    put_image(IMAGE_ID, photo_image(), bus=bus, mipmapped=True)
    return ren


def _counts():
    return (raster.LAUNCHES, raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES,
            mega.LAUNCHES, mega.ATLAS_LAUNCHES)


@pytest.mark.parametrize("variant", ["images_11", "images_mixed", "images_clipped"])
def test_image_frame_matches_plain_executor(variant, dev):
    """An image scene at 480x270 with 25 panels through render_frame: K1-atlas
    once a frame, or K4-atlas once for the clipped cards; the same executor
    with the plain versions gives the same frame, and so does, for the
    clipped cards, the rolled form of the frame executor (K1 once, K3 and
    K1-atlas per card)."""
    ren = _image_renderer()
    scene = make_image_panels_scene(480, 270, 25, variant)
    counts = _counts()
    frame = ren.render_frame(scene, vec2(480, 270))
    counts = tuple(b - a for a, b in zip(counts, _counts()))
    tape = ren.flatten(scene, vec2(480, 270))
    plan = plan_execution(tape)
    atlas = ren._device_atlas()
    plain = dict(draw=raster.draw_pass_planar_prebinned_plain,
                 draw_mask=raster.draw_pass_mask_prebinned_plain, atlas=atlas)
    if variant == "images_clipped":
        assert counts == (0, 0, 0, 0, 1) and plan.mega_atlas
        run = get_mega_executor(270, 480, plan.n_masks, False, plan.tile_h)
        ref = run(torch.from_numpy(plan.mega_combo).to(dev), None, atlas=atlas,
                  draw=mega.draw_pass_mega_plain)
        plan = plan_rolled(tape)
        counts = _counts()
        rolled = ren.execute_plan(plan).clone()
        assert tuple(b - a for a, b in zip(counts, _counts())) == (1, 25, 25, 0, 0)
        assert float((frame - rolled).abs().max()) <= TOL
    else:
        assert counts == (0, 1, 0, 0, 0)
        ref = None
    run = get_frame_executor(plan.structure, 270, 480, plan.n_masks, False,
                             plan.tile_h, rolled=plan.rolled_items is not None)
    by_pass = run(torch.from_numpy(plan.combo).to(dev), None, items=plan.rolled_items,
                  radii=plan.rolled_radii, **plain)
    torch.cuda.synchronize()
    assert tuple(frame.shape) == (270, 480, 4)
    assert float((frame - by_pass).abs().max()) <= TOL
    if ref is not None:
        assert float((frame - ref).abs().max()) <= TOL


def test_webp_image_file_frame_matches_plain_executor(dev, tmp_path):
    """The image-file scene (800x600) with the stored lossy WebP fixture
    loaded by load_image: K1-atlas once a frame, within 1/255 of the same
    executor with the plain versions, and within 1e-5 of figdraw_tpu's
    stored block means from the same file."""
    import shutil

    from figdraw_tpu_torch.scenes import (
        IMAGE_FILE_SIZE, WEBP_FILE_REFERENCE, WEBP_FIXTURE, make_image_file_scene,
        render_image_file,
    )

    path = str(tmp_path / "fixture_q90.webp")
    shutil.copyfile(WEBP_FIXTURE, path)
    ren, frame, ref = render_image_file(
        lambda ps: FigRenderer(atlas_size=512, device="cuda", pixel_scale=ps), path, "1x")
    scene = make_image_file_scene(*IMAGE_FILE_SIZE, ref.id)
    w, h = IMAGE_FILE_SIZE
    counts = _counts()
    frame = ren.render_frame(scene, vec2(w, h))
    assert tuple(b - a for a, b in zip(counts, _counts())) == (0, 1, 0, 0, 0)
    plan = plan_execution(ren.flatten(scene, vec2(w, h)))
    run = get_frame_executor(plan.structure, h, w, plan.n_masks, False, plan.tile_h)
    plain = run(torch.from_numpy(plan.combo).to(dev), None,
                draw=raster.draw_pass_planar_prebinned_plain,
                draw_mask=raster.draw_pass_mask_prebinned_plain, atlas=ren._device_atlas())
    torch.cuda.synchronize()
    assert float((frame - plain).abs().max()) <= TOL
    got = frame.cpu().numpy()
    blocks = got.reshape(h // 8, 8, w // 8, 8, 4).mean(axis=(1, 3))
    assert float(np.abs(blocks - np.load(WEBP_FILE_REFERENCE)).max()) <= 1e-5
    ref.close()


def _avif_image_file_frame(dev, tmp_path, fixture, reference):
    """The image-file scene (800x600) with a stored AVIF loaded by
    load_image: K1-atlas once a frame, within 1/255 of the same executor
    with the plain versions and within 1e-5 of figdraw_tpu's stored block
    means from the same file."""
    import shutil

    from figdraw_tpu_torch.scenes import IMAGE_FILE_SIZE, make_image_file_scene

    path = str(tmp_path / os.path.basename(fixture))
    shutil.copyfile(fixture, path)
    ren, ref = _loaded(path)
    w, h = IMAGE_FILE_SIZE
    scene = make_image_file_scene(w, h, ref.id)
    ren.render_frame(scene, vec2(w, h))
    counts = _counts()
    frame = ren.render_frame(scene, vec2(w, h))
    assert tuple(b - a for a, b in zip(counts, _counts())) == (0, 1, 0, 0, 0)
    plan = plan_execution(ren.flatten(scene, vec2(w, h)))
    run = get_frame_executor(plan.structure, h, w, plan.n_masks, False, plan.tile_h)
    plain = run(torch.from_numpy(plan.combo).to(dev), None,
                draw=raster.draw_pass_planar_prebinned_plain,
                draw_mask=raster.draw_pass_mask_prebinned_plain, atlas=ren._device_atlas())
    torch.cuda.synchronize()
    assert float((frame - plain).abs().max()) <= TOL
    blocks = frame.cpu().numpy().reshape(h // 8, 8, w // 8, 8, 4).mean(axis=(1, 3))
    assert float(np.abs(blocks - np.load(reference)).max()) <= 1e-5
    ref.close()


def _avif_photo_wall(dev, tmp_path, fixture, reference):
    """The 1080p photo wall of a stored AVIF: K4-atlas once a frame, within
    1/255 of the megakernel executor with its plain version; its 480x270
    wall within 1e-5 of figdraw_tpu's stored block means."""
    import shutil

    from figdraw_tpu_torch.scenes import (
        PHOTO_WALL_PANELS, PHOTO_WALL_SIZE, PHOTO_WALL_SMALL, make_loaded_photo_wall,
    )

    path = str(tmp_path / os.path.basename(fixture))
    shutil.copyfile(fixture, path)
    w, h = PHOTO_WALL_SIZE
    ren, ref = _loaded(path, atlas_size=256)
    scene = make_loaded_photo_wall(w, h, PHOTO_WALL_PANELS, ref.id)
    ren.render_frame(scene, vec2(w, h))
    counts = _counts()
    frame = ren.render_frame(scene, vec2(w, h))
    assert tuple(b - a for a, b in zip(counts, _counts())) == (0, 0, 0, 0, 1)
    plan = plan_execution(ren.flatten(scene, vec2(w, h)))
    assert plan.mega_atlas
    run = get_mega_executor(h, w, plan.n_masks, False, plan.tile_h)
    plain = run(torch.from_numpy(plan.mega_combo).to(dev), None, atlas=ren._device_atlas(),
                draw=mega.draw_pass_mega_plain)
    torch.cuda.synchronize()
    assert float((frame - plain).abs().max()) <= TOL
    sw, sh, sn = PHOTO_WALL_SMALL
    small, small_ref = _loaded(path, atlas_size=256)
    got = small.render_frame(make_loaded_photo_wall(sw, sh, sn, small_ref.id), vec2(sw, sh))
    bh, bw = sh // 8 * 8, sw // 8 * 8  # the whole 8x8 blocks (270 = 33 * 8 + 6)
    blocks = got.cpu().numpy()[:bh, :bw].reshape(bh // 8, 8, bw // 8, 8, 4).mean(axis=(1, 3))
    assert float(np.abs(blocks - np.load(reference)).max()) <= 1e-5
    ref.close()
    small_ref.close()


def test_cdef_avif_image_file_frame_on_k1_atlas(dev, tmp_path):
    """The speed-2 CDEF and loop restoration AVIF in the image-file scene."""
    from figdraw_tpu_torch.scenes import AVIF_CDEF_FILE_REFERENCE, AVIF_CDEF_FIXTURE

    _avif_image_file_frame(dev, tmp_path, AVIF_CDEF_FIXTURE, AVIF_CDEF_FILE_REFERENCE)


def test_cdef_avif_photo_wall_on_k4_atlas(dev, tmp_path):
    """The speed-2 CDEF AVIF on the 1080p photo wall."""
    from figdraw_tpu_torch.scenes import AVIF_CDEF_FIXTURE, AVIF_CDEF_WALL_REFERENCE

    _avif_photo_wall(dev, tmp_path, AVIF_CDEF_FIXTURE, AVIF_CDEF_WALL_REFERENCE)


def _chroma_avif(kind: str) -> tuple:
    """(file, scene reference, wall reference) of the stored 4:4:4 or
    limited-range BT.709 4:2:2 AVIF."""
    from figdraw_tpu_torch import scenes

    if kind == "444":
        return scenes.AVIF_444_FIXTURE, scenes.AVIF_444_FILE_REFERENCE, scenes.AVIF_444_WALL_REFERENCE
    return scenes.AVIF_422_FIXTURE, scenes.AVIF_422_FILE_REFERENCE, scenes.AVIF_422_WALL_REFERENCE


@pytest.mark.parametrize("kind", ["444", "422"])
def test_chroma_avif_decodes_to_its_digest(kind):
    """The stored 4:4:4 and 4:2:2 AVIFs on the card's host: the C++ decode
    (its stages held to their twins through the trace) and the conversion
    to PIL's stored digest."""
    import hashlib
    import json

    from figdraw_tpu_torch.scenes import IMAGE_FORMATS_REFERENCE
    from figdraw_tpu_torch.utils import av1, avif, imagefile

    path = _chroma_avif(kind)[0]
    with open(path, "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        want = json.load(fh)["files"][os.path.basename(path)]["decoded_sha256"]
    assert hashlib.sha256(imagefile.decode_image(data).tobytes()).hexdigest() == want
    still = avif.parse(data)
    frame = av1.decode(still.color, plain=True)
    assert (frame.ssx, frame.ssy) == ((0, 0) if kind == "444" else (1, 0))
    assert hashlib.sha256(avif.decode_avif(data, plain=True).tobytes()).hexdigest() == want


@pytest.mark.parametrize("kind", ["444", "422"])
def test_chroma_avif_image_file_frame_on_k1_atlas(dev, tmp_path, kind):
    fixture, scene_ref, _wall_ref = _chroma_avif(kind)
    _avif_image_file_frame(dev, tmp_path, fixture, scene_ref)


@pytest.mark.parametrize("kind", ["444", "422"])
def test_chroma_avif_photo_wall_on_k4_atlas(dev, tmp_path, kind):
    fixture, _scene_ref, wall_ref = _chroma_avif(kind)
    _avif_photo_wall(dev, tmp_path, fixture, wall_ref)


def _deep_avif(kind: str) -> tuple:
    """(file, scene reference, wall reference, bit depth) of a stored AVIF
    made 10- or 12-bit (the CDEF file and the 4:4:4 file at 10 bits, the
    limited-range 4:2:2 file at 12)."""
    from figdraw_tpu_torch import scenes

    return {"cdef10": (scenes.AVIF_CDEF10_FIXTURE, scenes.AVIF_CDEF10_FILE_REFERENCE,
                       scenes.AVIF_CDEF10_WALL_REFERENCE, 10),
            "444_10": (scenes.AVIF_444_10_FIXTURE, scenes.AVIF_444_10_FILE_REFERENCE,
                       scenes.AVIF_444_10_WALL_REFERENCE, 10),
            "422_12": (scenes.AVIF_422_12_FIXTURE, scenes.AVIF_422_12_FILE_REFERENCE,
                       scenes.AVIF_422_12_WALL_REFERENCE, 12)}[kind]


@pytest.mark.parametrize("kind", ["cdef10", "444_10", "422_12"])
def test_deep_avif_decodes_to_its_digest(kind):
    """The stored 10- and 12-bit AVIFs on the card's host: the C++ decode at
    their depth (its stages held to their twins through the trace) and the
    conversion to PIL's stored digest."""
    import hashlib
    import json

    from figdraw_tpu_torch.scenes import IMAGE_FORMATS_REFERENCE
    from figdraw_tpu_torch.utils import av1, avif, imagefile

    path, _scene_ref, _wall_ref, depth = _deep_avif(kind)
    with open(path, "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        want = json.load(fh)["files"][os.path.basename(path)]["decoded_sha256"]
    assert hashlib.sha256(imagefile.decode_image(data).tobytes()).hexdigest() == want
    frame = av1.decode(avif.parse(data).color, plain=True)
    assert frame.bit_depth == depth
    if kind != "444_10":
        assert all(frame.checked[k] for k in ("cdef", "wiener", "sgr")), frame.checked
    assert hashlib.sha256(avif.decode_avif(data, plain=True).tobytes()).hexdigest() == want


@pytest.mark.parametrize("kind", ["cdef10", "444_10", "422_12"])
def test_deep_avif_image_file_frame_on_k1_atlas(dev, tmp_path, kind):
    fixture, scene_ref, _wall_ref, _depth = _deep_avif(kind)
    _avif_image_file_frame(dev, tmp_path, fixture, scene_ref)


@pytest.mark.parametrize("kind", ["cdef10", "444_10", "422_12"])
def test_deep_avif_photo_wall_on_k4_atlas(dev, tmp_path, kind):
    fixture, _scene_ref, wall_ref, _depth = _deep_avif(kind)
    _avif_photo_wall(dev, tmp_path, fixture, wall_ref)


@pytest.mark.parametrize("name", ["fixture_grid.avif", "photo_grid_4032x3024.avif"])
def test_grid_avif_decodes_to_its_digest(name):
    """The stored grid AVIFs on the card's host: the fixture's 4x3 tiles
    with an alpha grid, and the 12 MP photo's 8x6 tiles cropped by the
    grid, decoded by the C++ helper to PIL's stored digest; the fixture's
    also through the numpy twins (its first tile's stages through the
    trace)."""
    import hashlib
    import json

    from figdraw_tpu_torch.scenes import IMAGE_FORMATS_DIR, IMAGE_FORMATS_REFERENCE
    from figdraw_tpu_torch.utils import av1, avif, imagefile

    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        want = json.load(fh)["files"][name]["decoded_sha256"]
    assert hashlib.sha256(imagefile.decode_image(data).tobytes()).hexdigest() == want
    still = avif.parse(data)
    assert still.grid is not None and not still.color
    if name == "fixture_grid.avif":
        assert still.alpha_grid is not None
        frame = av1.decode(still.grid.tiles[0], plain=True)
        assert all(frame.checked[k] for k in ("predict", "txfm", "lf")), frame.checked
        assert hashlib.sha256(avif.decode_avif(data, plain=True).tobytes()).hexdigest() == want


def test_grid_avif_image_file_frame_on_k1_atlas(dev, tmp_path):
    """The fixture as a grid with an alpha grid, in the image-file scene."""
    from figdraw_tpu_torch.scenes import AVIF_GRID_FILE_REFERENCE, AVIF_GRID_FIXTURE

    _avif_image_file_frame(dev, tmp_path, AVIF_GRID_FIXTURE, AVIF_GRID_FILE_REFERENCE)


def test_grid_avif_photo_wall_on_k4_atlas(dev, tmp_path):
    """The fixture as a grid with an alpha grid, on the 1080p photo wall."""
    from figdraw_tpu_torch.scenes import AVIF_GRID_FIXTURE, AVIF_GRID_WALL_REFERENCE

    _avif_photo_wall(dev, tmp_path, AVIF_GRID_FIXTURE, AVIF_GRID_WALL_REFERENCE)


def _grain_avif(kind: str) -> tuple:
    """(file, scene reference, wall reference) of a stored AVIF with film
    grain: aom's test vector 2 with a vignette alpha, and vector 4 at 4:2:2
    made 10-bit."""
    from figdraw_tpu_torch import scenes

    return {"grain": (scenes.AVIF_GRAIN_FIXTURE, scenes.AVIF_GRAIN_FILE_REFERENCE,
                      scenes.AVIF_GRAIN_WALL_REFERENCE),
            "grain_422_10": (scenes.AVIF_GRAIN_422_10_FIXTURE,
                             scenes.AVIF_GRAIN_422_10_FILE_REFERENCE,
                             scenes.AVIF_GRAIN_422_10_WALL_REFERENCE)}[kind]


@pytest.mark.parametrize("kind", ["grain", "grain_422_10"])
def test_grain_avif_decodes_to_its_digest(kind):
    """The stored film grain AVIFs on the card's host: the C++ decode (its
    film grain and every traced stage held to their twins) and the
    conversion to PIL's stored digest."""
    import hashlib
    import json

    from figdraw_tpu_torch.scenes import IMAGE_FORMATS_REFERENCE
    from figdraw_tpu_torch.utils import av1, avif, imagefile

    path = _grain_avif(kind)[0]
    with open(path, "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        want = json.load(fh)["files"][os.path.basename(path)]["decoded_sha256"]
    assert hashlib.sha256(imagefile.decode_image(data).tobytes()).hexdigest() == want
    frame = av1.decode(avif.parse(data).color)
    assert av1.grain_applies(frame.grain)
    assert hashlib.sha256(avif.decode_avif(data, plain=True).tobytes()).hexdigest() == want


@pytest.mark.parametrize("kind", ["grain", "grain_422_10"])
def test_grain_avif_image_file_frame_on_k1_atlas(dev, tmp_path, kind):
    fixture, scene_ref, _wall_ref = _grain_avif(kind)
    _avif_image_file_frame(dev, tmp_path, fixture, scene_ref)


@pytest.mark.parametrize("kind", ["grain", "grain_422_10"])
def test_grain_avif_photo_wall_on_k4_atlas(dev, tmp_path, kind):
    fixture, _scene_ref, wall_ref = _grain_avif(kind)
    _avif_photo_wall(dev, tmp_path, fixture, wall_ref)


def _card_rewrites():
    """tools/make_image_formats.py's card_rewrites (byte edits, no PIL)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    from make_image_formats import card_rewrites

    return card_rewrites


def _sequence_avif(kind: str, tmp_path) -> tuple:
    """(file, scene reference, wall reference) of the stored image sequence
    (premultiplied) or of its limited-alpha rewrite (tools/
    make_image_formats.py's card_rewrites), written under tmp_path."""
    from figdraw_tpu_torch import scenes

    if kind == "sequence":
        return (scenes.AVIF_SEQUENCE_FIXTURE, scenes.AVIF_SEQUENCE_FILE_REFERENCE,
                scenes.AVIF_SEQUENCE_WALL_REFERENCE)
    card_rewrites = _card_rewrites()

    with open(scenes.AVIF_SEQUENCE_FIXTURE, "rb") as fh:
        data = card_rewrites(fh.read())["limited alpha"]
    os.makedirs(tmp_path / "src", exist_ok=True)
    path = str(tmp_path / "src" / "sequence_limited_alpha.avif")
    with open(path, "wb") as fh:
        fh.write(data)
    return (path, scenes.AVIF_SEQUENCE_LIMITED_FILE_REFERENCE,
            scenes.AVIF_SEQUENCE_LIMITED_WALL_REFERENCE)


def test_sequence_avif_and_its_rewrites_decode_to_their_digests():
    """The stored image sequence on the card's host: its first frame to
    PIL's stored digest, fd_av1_unattenuate against unattenuate_plain on
    its RGBA, each card rewrite (straight, limited alpha, still, lsel) to
    its stored digest, and fd_av1_alpha_range against alpha_range_plain on
    the limited file's alpha plane."""
    import hashlib
    import json

    import numpy as np

    from figdraw_tpu_torch.scenes import AVIF_SEQUENCE_FIXTURE, IMAGE_FORMATS_REFERENCE
    from figdraw_tpu_torch.utils import av1, avif, imagefile

    card_rewrites = _card_rewrites()

    with open(AVIF_SEQUENCE_FIXTURE, "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        stored = json.load(fh)
    name = os.path.basename(AVIF_SEQUENCE_FIXTURE)
    px = imagefile.decode_image(data)
    assert hashlib.sha256(px.tobytes()).hexdigest() == stored["files"][name]["decoded_sha256"]
    assert np.array_equal(avif.decode_avif(data, plain=True), px)
    for kind, d in card_rewrites(data).items():
        got = hashlib.sha256(imagefile.decode_image(d).tobytes()).hexdigest()
        assert got == stored["rewrites"][name][kind]["decoded_sha256"], kind
    f = av1.decode(avif.parse(card_rewrites(data)["limited alpha"]).alpha)
    av1.alpha_range(f.planes[0], f.width, f.height, f.bit_depth, plain=True)


@pytest.mark.parametrize("kind", ["sequence", "limited"])
def test_sequence_avif_image_file_frame_on_k1_atlas(dev, tmp_path, kind):
    fixture, scene_ref, _wall_ref = _sequence_avif(kind, tmp_path)
    _avif_image_file_frame(dev, tmp_path, fixture, scene_ref)


@pytest.mark.parametrize("kind", ["sequence", "limited"])
def test_sequence_avif_photo_wall_on_k4_atlas(dev, tmp_path, kind):
    fixture, _scene_ref, wall_ref = _sequence_avif(kind, tmp_path)
    _avif_photo_wall(dev, tmp_path, fixture, wall_ref)


def test_text_table_matches_plain_executor(dev):
    """The stored table of text in clipped cells (1200x800) on the
    megakernel with the atlas: one K4-atlas launch, the frame the plain
    walk's and the rolled executor's, and figdraw_tpu's stored block means."""
    tape, atlas_np, blocks = load_text_tape()
    plan = plan_execution(tape)
    assert plan.mega_atlas
    atlas = atlas_from_jax(atlas_np, dev)
    ren = FigRenderer(device="cuda")
    counts = _counts()
    frame = ren.execute_plan(plan, atlas=atlas)
    assert tuple(b - a for a, b in zip(counts, _counts())) == (0, 0, 0, 0, 1)
    run = get_mega_executor(plan.height, plan.width, plan.n_masks, False,
                            plan.tile_h)
    ref = run(torch.from_numpy(plan.mega_combo).to(dev), None, atlas=atlas,
              draw=mega.draw_pass_mega_plain)
    rolled = FigRenderer(device="cuda").execute_plan(plan_rolled(tape), atlas=atlas)
    torch.cuda.synchronize()
    assert float((frame - ref).abs().max()) <= TOL
    assert float((frame - rolled).abs().max()) <= TOL
    got = frame.cpu().numpy()
    h, w = got.shape[0] // 8 * 8, got.shape[1] // 8 * 8
    means = got[:h, :w].reshape(h // 8, 8, w // 8, 8, 4).mean(axis=(1, 3))
    assert np.abs(means - blocks).max() <= TOL


def _seeded_combo(seed, dev, w=1920, h=1080, copies=20):
    """A real packed buffer (the headline scene's rows, then its meta tail)
    with seeded extras: rows with an empty bbox, NaN-patterned colour words
    and a table of per-root slots."""
    rng = np.random.RandomState(seed)
    ren = FigRenderer(device="cuda")
    tape = ren.flatten(make_render_tree_array(w, h, seed, copies=copies),
                       vec2(w, h), cull=False, record_spans=True)
    combo = tape.combo.copy()
    n = tape.combo_quads
    combo[rng.randint(0, tape.count, 5), 6:10] = (2e9, 2e9, -2e9, -2e9)
    words = combo[:, 16:22].view(np.uint32)
    words[rng.randint(0, tape.count, 8)] = 0xFFC00001  # a NaN with a payload
    roots = 7
    ridx = rng.randint(-1, roots, size=n).astype(np.int32)
    table = np.zeros((roots + 1, 6), np.float32)
    table[:, 0] = table[:, 3] = 1.0
    table[0] = (1, 0, 0, 1, 12, -9)
    table[1] = (2, 0, 0, 2, 4, 8)
    table[2] = (0.5, 0, 0, 0.25, -3, 5)
    table[3] = (0.9, 0.3, -0.3, 0.9, 2.5, 1.5)
    table[4] = (1.25, 0.1, 0.2, 0.8, -7.75, 3.125)
    rects = np.full((4, 4), (2e9, 2e9, -2e9, -2e9), np.float32)
    rects[0] = (100, 80, 400, 300)
    rects[1] = (900.5, 600.25, 1300, 900)
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(combo), n, t(table), t(ridx), t(rects)


@pytest.mark.parametrize("cam", [((0.0, 0.0), 1.0), ((9.0, -7.0), 2.0),
                                 ((0.5, 0.25), 1.5), ((-13.3, 11.7), 0.75)])
@pytest.mark.parametrize("stages", ["view", "anim", "damage", "all"])
def test_rows_kernel_matches_plain_bit_for_bit(cam, stages, dev):
    combo, n, table, ridx, rects = _seeded_combo(3, dev)
    d = torch.tensor(cam[0], dtype=torch.float32, device=dev)
    z = torch.tensor([cam[1]], dtype=torch.float32, device=dev)
    kw = {}
    if stages in ("anim", "all"):
        kw.update(table=table, ridx=ridx)
    if stages in ("damage", "all"):
        kw.update(rects=rects)
    before_combo = combo.clone()
    out = torch.empty_like(combo)
    before = rows.LAUNCHES
    got = rows.transform_rows(combo, n, d, z, out, **kw)
    assert rows.LAUNCHES == before + 1 and got is out
    ref = rows.transform_rows_plain(combo, n, d, z, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(combo.view(torch.int32), before_combo.view(torch.int32))
    # the meta tail and the integer lanes pass through untouched
    assert torch.equal(got[n:].view(torch.int32), combo[n:].view(torch.int32))
    for cols in (slice(16, 22), slice(50, 52)):
        assert torch.equal(got[:, cols].contiguous().view(torch.int32),
                           combo[:, cols].contiguous().view(torch.int32))
    if stages in ("anim", "all") or cam != ((0.0, 0.0), 1.0):
        assert not torch.equal(got.view(torch.int32), combo.view(torch.int32))


def test_rows_wrapper_rejects_bad_arguments(dev):
    combo, n, table, ridx, rects = _seeded_combo(4, dev, 640, 360, 5)
    d = torch.zeros(2, dtype=torch.float32, device=dev)
    z = torch.ones(1, dtype=torch.float32, device=dev)
    out = torch.empty_like(combo)
    before = rows.LAUNCHES
    bad = [
        dict(out=combo),  # in place
        dict(out=torch.empty_like(combo)[1:]),  # another shape
        dict(out=out.cpu()),  # a foreign device
        dict(d=d.cpu()),
        dict(z=z.double()),
        dict(table=table),  # without ridx
        dict(table=table, ridx=ridx.long()),
        dict(table=table[:, :5].contiguous(), ridx=ridx),
        dict(rects=rects[:2]),
        dict(n_quads=combo.shape[0] + 1),
    ]
    for change in bad:
        args = dict(combo=combo, n_quads=n, d=d, z=z, out=out)
        args.update(change)
        with pytest.raises(ValueError):
            rows.transform_rows(**args)
    # a misaligned buffer: one float into a larger allocation
    flat = torch.empty(combo.numel() + 1, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        rows.transform_rows(flat[1:].view_as(combo), n, d, z, out)
    with pytest.raises(ValueError):
        rows.transform_rows(combo[:, :51], n, d, z, out)
    assert rows.LAUNCHES == before


def test_rows_and_blur_on_cpu_tensors_never_reach_a_kernel(dev):
    combo, n, table, ridx, rects = _seeded_combo(5, dev, 640, 360, 5)
    combo, table, ridx, rects = (t.cpu() for t in (combo, table, ridx, rects))
    before = rows.LAUNCHES, blur.LAUNCHES
    out = rows.transform_rows(combo, n, torch.tensor([3.0, 1.0]), torch.tensor(2.0),
                              torch.empty_like(combo), table, ridx, rects)
    assert out.device.type == "cpu"
    planes = torch.rand(4, 64, 128)
    assert blur.backdrop_blur_planar(planes, 7.5).device.type == "cpu"
    assert (rows.LAUNCHES, blur.LAUNCHES) == before


# the last three are no multiple of the blocks' 128 x 8 (horizontal) and
# 64 x 48 (vertical) pixels; (1, 37, 53) takes the one-column vertical pass
@pytest.mark.parametrize("radius", [0.3, 0.5, 1.0, 7.5, 18.0, 64.0, 100.0])
@pytest.mark.parametrize("shape", [(4, 1152, 1920), (4, 128, 256), (1, 37, 53),
                                   (4, 1000, 1916), (2, 61, 132)])
def test_blur_kernel_matches_plain(radius, shape, dev):
    """The kernel equals the plain blur bit for bit: each pixel's arithmetic
    is the plain version's, one rounding a step."""
    rng = np.random.RandomState(int(radius * 10) + shape[1])
    planes = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
    planes0 = planes.clone()
    r = torch.tensor(radius, dtype=torch.float32, device=dev)
    before = blur.LAUNCHES
    got = blur.backdrop_blur_planar(planes, r)
    assert blur.LAUNCHES == before + 2
    ref = blur.backdrop_blur_planar_plain(planes, r)
    torch.cuda.synchronize()
    assert got.shape == planes.shape and got.data_ptr() != planes.data_ptr()
    assert torch.equal(planes, planes0)  # the input is not written
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, ref), float((got - ref).abs().max())
    if radius <= 0.5:
        assert torch.equal(got, planes)
    else:
        assert float((got - planes).abs().max()) > 1e-3


def test_blur_wrapper_rejects_bad_arguments(dev):
    planes = torch.rand(4, 128, 256, device=dev)
    before = blur.LAUNCHES
    with pytest.raises(ValueError):
        blur.backdrop_blur_planar(planes.double(), 3.0)
    with pytest.raises(ValueError):
        blur.backdrop_blur_planar(planes[:, :, ::2], 3.0)
    with pytest.raises(ValueError):
        blur.backdrop_blur_planar(planes[0], 3.0)
    with pytest.raises(ValueError):
        blur.backdrop_blur_planar(planes, torch.ones(2, device=dev))
    assert blur.LAUNCHES == before


def test_device_resident_scene_on_the_card(dev):
    """snapshot, view, animate and patch at 1080p: the integer pan equals
    render_frame of the shifted scene, the damage-clipped frame the full
    render, and each frame launches the row kernel once."""
    w, h = 1920, 1080
    size = vec2(w, h)
    ren = FigRenderer(device="cuda")
    arr, boxes = build_grid(300, w, h)
    lst = arr[0]
    scene = ren.snapshot_scene(arr, size)
    before = rows.LAUNCHES
    first = ren.render_view(scene)
    assert rows.LAUNCHES == before + 1
    assert torch.equal(first, ren.render_frame(arr, size))
    for f in range(3):
        dirty = []
        for k in range(8):
            b = boxes[(f * 8 + k) % len(boxes)]
            x, y, bw, bh = lst.nodes[b]["box"]
            lst.set_box(b, float(x), float((y + 3 + f) % h), float(bw), float(bh))
            dirty.append((0, b))
        ren.update_scene(scene, arr, dirty)
        assert scene.pending_patch is not None
        assert ren._partial_ok(scene, (0.0, 0.0, 1.0, scene.kind))
        clipped = ren.render_view(scene)
        assert torch.equal(clipped, ren.render_frame(arr, size)), f
    n = len(scene.animation_order())
    table = np.zeros((n, 6), np.float32)
    table[:, 0] = table[:, 3] = 1.0
    table[5] = (1, 0, 0, 1, 16, -8)
    moved = ren.render_view(scene, (3.0, 1.0), root_transforms=table)
    assert bool(torch.isfinite(moved).all()) and not torch.equal(moved, clipped)
    assert torch.equal(ren.render_view(scene), clipped)  # the base stays
    stack = ren.render_views(scene, [(0, 0), (6, -2)], [1.0, 1.5], as_uint8=True)
    assert stack.dtype == torch.uint8 and tuple(stack.shape) == (2, h, w, 4)
    assert np.array_equal(stack[0].cpu().numpy(), ren.take_screenshot(clipped))


def test_a_scene_on_another_device_is_refused(dev):
    """A renderer on the card refuses a scene that lies on the CPU, and the
    reverse, before anything runs: no plain version stands in for a kernel
    and no frame mixes devices."""
    size = vec2(256, 128)
    arr, boxes = build_grid(12, 256, 128)
    on_card, on_cpu = FigRenderer(device="cuda"), FigRenderer(device="cpu")
    counts = (rows.LAUNCHES, blur.LAUNCHES, raster.LAUNCHES)
    for ren, scene in ((on_card, on_cpu.snapshot_scene(arr, size)),
                       (on_cpu, on_card.snapshot_scene(arr, size))):
        with pytest.raises(ValueError, match="the scene lies on"):
            ren.render_view(scene)
        with pytest.raises(ValueError, match="the scene lies on"):
            ren.render_views(scene, [(0, 0)])
        with pytest.raises(ValueError, match="the scene lies on"):
            ren.update_scene(scene, arr, [(0, boxes[0])])
    assert (rows.LAUNCHES, blur.LAUNCHES, raster.LAUNCHES) == counts
    # the same renderer's own scene, whether it names the card's index or not
    own = on_card.snapshot_scene(arr, size)
    assert bool(torch.isfinite(FigRenderer(device="cuda:0").render_view(own)).all())


# (rows, live quads, sat, frame w, h, tile_h, window or None, modes, runs,
# window as device tensors): N from 1 to 32769, T up to 510 (1920x1080 at
# tile_h 32), with and without modes, 1-3 runs, windows
BIN_CASES = [
    (1, 1, False, 384, 256, 64, None, True, None, False),
    (255, 200, False, 384, 256, 32, (17, 240), True, [[0, 90], [90, 200]], True),
    (255, 200, False, 384, 256, 128, (17, 240), False, None, False),
    (1025, 706, False, 1920, 1080, 128, None, True, [[0, 703], [703, 706]], False),
    (1025, 1000, False, 1920, 1080, 128, None, False, None, False),
    (4096, 3900, True, 1920, 1080, 32, None, True,
     [[0, 1200], [1200, 2500], [2500, 3900]], False),
    (6144, 4323, True, 1200, 800, 64, None, True, [[0, 2000], [3000, 4323]], False),
    (6144, 6000, True, 1200, 800, 64, (100, 5900), True, None, True),
    (32769, 28006, True, 1920, 1080, 32, None, True, [[0, 28003], [28003, 28006]],
     False),
    (32769, 30000, False, 1920, 1080, 32, (0, 30000), False, None, False),
]


@pytest.mark.parametrize("case", range(len(BIN_CASES)))
def test_binning_kernel_matches_plain(case, dev):
    """Whole (T, N) lists and counts of the kernel equal bin_quads_plain's on
    the card, leaving out only the quads whose within-run above-stack lies
    within rounding of the saturation threshold (the model marks them)."""
    n, n_live, sat, w, h, th, window, with_modes, runs, on_device = BIN_CASES[case]
    f, m = binning_tape(n, n_live, 100 + case, sat=sat, w=w, h=h)
    start, end = window or (0, n)
    grid = (-(-h // th), -(-w // 128), th, 128)
    fd, md = torch.from_numpy(f).to(dev), torch.from_numpy(m).to(dev)
    kw = dict(modes=md if with_modes else None,
              run_bounds=None if runs is None else torch.tensor(runs, dtype=torch.int32,
                                                                  device=dev))
    s, e = ((torch.tensor(start, device=dev), torch.tensor(end, device=dev))
            if on_device else (start, end))
    before = binning.LAUNCHES
    got = bin_quads(fd, s, e, *grid, **kw)
    assert binning.LAUNCHES == before + 2  # the prepass and the tile kernel
    want = bin_quads_plain(fd, s, e, *grid, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == (grid[0] * grid[1], n) and got[0].dtype == torch.int32
    assert got[1].dtype == torch.int32
    _idx, _counts, border = bin_quads_model(f, start, end, *grid,
                                            modes=m if with_modes else None,
                                            run_bounds=runs)
    assert border.sum() <= 64  # few quads sit that close to the threshold
    assert lists_equal(got[0].cpu().numpy(), got[1].cpu().numpy(),
                       want[0].cpu().numpy(), want[1].cpu().numpy(), border)
    if with_modes and n > 1:
        plain_all = bin_quads_plain(fd, s, e, *grid)
        assert int(got[1].sum()) < int(plain_all[1].sum())  # the culls ran


@pytest.mark.parametrize("n_masks,th", [(1, 128), (3, 64), (3, 32), (4, 128)])
def test_binning_kernel_on_the_mega_clamps_tape(n_masks, th, dev):
    """The megakernel's lists (no culling) over a tape with clear sentinels
    and quads that target plane 0 equal the plain version's exactly, and
    the megakernel walks them to the same planes."""
    w, h = 512, 256
    fields, modes, _atlas = mega_modes_tape(n_masks, n_masks * 1000 + th, w, h)
    assert (modes[:, QI_MODE] & mega.MEGA_CLEAR_BIT).any()
    assert (modes[:, QI_MODE] >> mega.MEGA_TARGET_SHIFT == 1).any()
    f, m = torch.from_numpy(fields).to(dev), torch.from_numpy(modes).to(dev)
    got = bin_quads(f, 0, f.shape[0], h // th, w // 128, th, 128)
    want = bin_quads_plain(f, 0, f.shape[0], h // th, w // 128, th, 128)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    planes = torch.from_numpy(np.random.RandomState(th).rand(4, h, w)
                              .astype(np.float32)).to(dev)
    a = mega.draw_pass_mega(f, m, *got, planes.clone(), n_masks, tile_h=th)
    b = mega.draw_pass_mega(f, m, *want, planes.clone(), n_masks, tile_h=th)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["headline", "rectmask"])
def test_frames_with_the_binning_kernel_equal_the_plain_binnings(kind, dev, monkeypatch):
    """The executor's frames with the kernel's lists equal its frames with
    bin_quads_plain's, bit for bit (no quad of these scenes lies near the
    saturation threshold)."""
    if kind == "headline":
        scene, size = make_render_tree_array(1920, 1080, 3, copies=100), vec2(1920, 1080)
    else:
        scene, size = make_clip_table_scene("rectmask", 1200, 800, 180, 6), vec2(1200, 800)
    before = (binning.LAUNCHES, binning.DECODE_LAUNCHES, binning.PLAIN_DECODES,
              binning.PLAIN_BINNINGS)
    got = FigRenderer(device="cuda").render_frame(scene, size)
    # one front end: the front kernel and the tile kernel, nothing plain
    assert (binning.LAUNCHES, binning.DECODE_LAUNCHES, binning.PLAIN_DECODES,
            binning.PLAIN_BINNINGS) == (before[0] + 1, before[1] + 1, *before[2:])
    monkeypatch.setattr(executor, "decode_and_bin", decode_and_bin_plain)
    want = FigRenderer(device="cuda").render_frame(scene, size)
    torch.cuda.synchronize()
    assert (binning.LAUNCHES, binning.DECODE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)


def test_binning_wrapper_rejects_bad_arguments(dev):
    f, m = binning_tape(256, 200, 3)
    fd, md = torch.from_numpy(f).to(dev), torch.from_numpy(m).to(dev)
    grid = (0, 256, 2, 3, 128, 128)
    before = binning.LAUNCHES
    with pytest.raises(ValueError):
        bin_quads(fd.double(), *grid)
    with pytest.raises(ValueError):
        bin_quads(fd[:, :60], *grid)
    with pytest.raises(ValueError):
        bin_quads(fd[::2], *grid)
    with pytest.raises(ValueError):
        bin_quads(fd, *grid, modes=md.long())
    with pytest.raises(ValueError):
        bin_quads(fd, *grid, modes=md, run_bounds=torch.zeros(
            (MAX_RUNS + 1, 2), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        bin_quads(fd, *grid, modes=md, run_bounds=torch.tensor([[0, 256]]))
    with pytest.raises(ValueError):
        bin_quads(fd, torch.tensor([0, 1], device=dev), *grid[1:])
    with pytest.raises(ValueError):
        bin_quads(fd, 0, 256, 0, 3, 128, 128)
    assert binning.LAUNCHES == before


# --- the front end: the decode fused with the binning's terms, then the tiles ----


def _words(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1025, 32769])
def test_decode_kernel_equals_the_plain_decode_bit_for_bit(n, dev):
    """Random packed rows (every float lane random bits, NaN payloads and
    -0.0 included; colour words random bytes): the decode kernel's fields
    and modes equal the plain decode's as 32-bit words, alone and fused."""
    rng = np.random.RandomState(n)
    rows = torch.from_numpy(rng.randint(-2**31, 2**31, size=(n, PACKED_WIDTH),
                                        dtype=np.int64).astype(np.int32).view(np.float32)).to(dev)
    before = (binning.DECODE_LAUNCHES, binning.PLAIN_DECODES)
    f, m = unpack_combo(rows)
    assert (binning.DECODE_LAUNCHES, binning.PLAIN_DECODES) == (before[0] + 1, before[1])
    pf, pm = unpack_combo_plain(rows)
    torch.cuda.synchronize()
    assert f.shape == (n, QF_WIDTH) and m.dtype == torch.int32
    assert torch.equal(_words(f), _words(pf)) and torch.equal(m, pm)
    ff, fm, _idx, _counts = decode_and_bin(rows, 0, n, 3, 4, 64, 128, cull=True)
    torch.cuda.synchronize()
    assert torch.equal(_words(ff), _words(pf)) and torch.equal(fm, pm)


@pytest.mark.parametrize("case", range(len(BIN_CASES)))
def test_front_end_kernels_match_the_plain_front_end(case, dev):
    """decode_and_bin on the packed rows of BIN_CASES' tapes: fields and
    modes equal the plain decode's as words, and the whole lists and counts
    equal the plain binning's outside the borderline quads; two launches."""
    n, n_live, sat, w, h, th, window, with_modes, runs, on_device = BIN_CASES[case]
    f, m = binning_tape(n, n_live, 100 + case, sat=sat, w=w, h=h)
    rows_np = pack_fields_np(f, m)
    start, end = window or (0, n)
    grid = (-(-h // th), -(-w // 128), th, 128)
    rows = torch.from_numpy(rows_np).to(dev)
    kw = dict(cull=with_modes,
              run_bounds=None if runs is None else torch.tensor(runs, dtype=torch.int32,
                                                                  device=dev))
    s, e = ((torch.tensor(start, device=dev), torch.tensor(end, device=dev))
            if on_device else (start, end))
    before = (binning.LAUNCHES, binning.DECODE_LAUNCHES)
    got = decode_and_bin(rows, s, e, *grid, **kw)
    assert (binning.LAUNCHES, binning.DECODE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = decode_and_bin_plain(rows, s, e, *grid, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_words(got[0]), _words(want[0])) and torch.equal(got[1], want[1])
    fields = want[0].cpu().numpy()
    _idx, _counts, border = bin_quads_model(fields, start, end, *grid,
                                            modes=m if with_modes else None,
                                            run_bounds=runs)
    assert border.sum() <= 64
    assert lists_equal(got[2].cpu().numpy(), got[3].cpu().numpy(),
                       want[2].cpu().numpy(), want[3].cpu().numpy(), border)
    # and the binning of decoded fields agrees with the fused front end
    alone = bin_quads(got[0], s, e, *grid, modes=got[1] if with_modes else None,
                      run_bounds=kw["run_bounds"])
    torch.cuda.synchronize()
    assert torch.equal(alone[0], got[2]) and torch.equal(alone[1], got[3])


@pytest.mark.parametrize("cull", [False, True])
def test_front_end_past_the_staged_tiles(cull, dev):
    """More tiles than a front-kernel block stages in shared memory (80 x 60
    tiles of 128 x 32): the bits are ORed in device memory, and the lists
    still equal the plain front end's."""
    w, h, th = 80 * 128, 60 * 32, 32
    f, m = binning_tape(2048, 1900, 11, w=w, h=h)
    rows = torch.from_numpy(pack_fields_np(f, m)).to(dev)
    grid = (h // th, w // 128, th, 128)
    got = decode_and_bin(rows, 0, 2048, *grid, cull=cull)
    want = decode_and_bin_plain(rows, 0, 2048, *grid, cull=cull)
    torch.cuda.synchronize()
    assert torch.equal(_words(got[0]), _words(want[0])) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert int(got[3].sum()) > 0


def test_front_end_walks_every_quad_for_a_cover_outside_its_bbox(dev):
    """A quad whose cover rectangle reaches past its bbox (the walks never
    write one) covers tiles it does not meet: the front kernel flags it and
    the tile kernel's walk visits every quad of the run; the lists equal
    the plain front end's, with and without saturation."""
    from figdraw_tpu_torch.ops.binning import cover_ranges
    from figdraw_tpu_torch.ops.layout import QF_BBOX_X0, QF_BBOX_X1

    for n, sat in ((640, False), (4608, True)):
        f, m = binning_tape(n, n - 64, 7, sat=sat, w=1024, h=512)
        crng = cover_ranges(f, m, 8, 8, 64, 128)[0]
        for i in np.flatnonzero(crng[:, 0] < crng[:, 2])[:5]:
            cx = (f[i, QF_BBOX_X0] + f[i, QF_BBOX_X1]) * np.float32(0.5)
            f[i, QF_BBOX_X0], f[i, QF_BBOX_X1] = cx - np.float32(1), cx + np.float32(1)
        rows = torch.from_numpy(pack_fields_np(f, m)).to(dev)
        runs = torch.tensor([[0, n // 2], [n // 2, n]], dtype=torch.int32, device=dev)
        got = decode_and_bin(rows, 0, n, 8, 8, 64, 128, cull=True, run_bounds=runs)
        want = decode_and_bin_plain(rows, 0, n, 8, 8, 64, 128, cull=True, run_bounds=runs)
        torch.cuda.synchronize()
        fields = want[0].cpu().numpy()
        _idx, _counts, border = bin_quads_model(fields, 0, n, 8, 8, 64, 128, modes=m,
                                                run_bounds=runs.cpu().numpy())
        assert lists_equal(got[2].cpu().numpy(), got[3].cpu().numpy(),
                           want[2].cpu().numpy(), want[3].cpu().numpy(), border)


def test_front_end_phase_stops_launch_and_leave_the_counts(dev):
    """stop 1-4 (the phase timings) launch and return; stop 3 writes the
    counts the full run writes."""
    f, m = binning_tape(32769, 28006, 7, sat=True, w=1920, h=1080)
    rows = torch.from_numpy(pack_fields_np(f, m)).to(dev)
    args = (rows, 0, 32769, 34, 15, 32, 128)
    runs = torch.tensor([[0, 28003], [28003, 28006]], dtype=torch.int32, device=dev)
    full = decode_and_bin(*args, cull=True, run_bounds=runs)
    for stop in (1, 2, 3, 4):
        out = decode_and_bin(*args, cull=True, run_bounds=runs, stop=stop)
        torch.cuda.synchronize()
        if stop == 3:
            assert torch.equal(out[3], full[3])


def test_front_end_rejects_rows_it_does_not_take(dev):
    rows = torch.zeros((65, PACKED_WIDTH), dtype=torch.float32, device=dev)
    before = (binning.LAUNCHES, binning.DECODE_LAUNCHES)
    for bad in (rows.double(), rows[:, :50], rows[::2], rows.view(-1)[1:1 + 64 * 52]
                .view(64, 52)):
        with pytest.raises(ValueError):
            decode_and_bin(bad, 0, bad.shape[0], 2, 2, 64, 128)
        with pytest.raises(ValueError):
            unpack_combo(bad)
    with pytest.raises(ValueError):
        decode_and_bin(rows, 0, 65, 1, 40000, 64, 128)
    with pytest.raises(ValueError):
        decode_and_bin(rows, 0, 65, 2, 2, 64, 128, cull=True,
                       run_bounds=torch.tensor([[0, 65]]))
    assert (binning.LAUNCHES, binning.DECODE_LAUNCHES) == before


def test_batched_and_viewed_rows_reach_the_front_kernel(dev):
    """A batch group's frames and a resident view's rows are views the
    front kernel takes: render_batch and render_view launch it, no plain
    decode or binning runs, and the batch's frames equal render_frame's."""
    scenes = [make_render_tree_array(640, 360, f, copies=20) for f in range(3)]
    size = vec2(640, 360)
    ren = FigRenderer(device="cuda")
    before = (binning.DECODE_LAUNCHES, binning.PLAIN_DECODES, binning.PLAIN_BINNINGS)
    frames = ren.render_batch(scenes, size)
    snap = ren.snapshot_scene(scenes[0], size)
    view = ren.render_view(snap, (0.0, 0.0))
    torch.cuda.synchronize()
    assert (binning.DECODE_LAUNCHES - before[0], binning.PLAIN_DECODES,
            binning.PLAIN_BINNINGS) == (4, *before[1:])
    assert view.shape == frames[0].shape and bool(torch.isfinite(view).all())
    for f, scene in enumerate(scenes):
        assert torch.equal(frames[f], FigRenderer(device="cuda").render_frame(scene, size))


# --- tree-form scenes: the Python walk and the planner into the same kernels ------


def _tree_and_array_frames(tree, size):
    """The frame of to_renders(from_renders(tree)) through the Python walk
    and of from_renders(tree) through the native walk, each on a renderer
    of its own, with the kernel launches each made."""
    from figdraw_tpu_torch import from_renders, to_renders

    arr = from_renders(tree)
    out = []
    for scene in (to_renders(arr), arr):
        before = (raster.LAUNCHES, mega.LAUNCHES, blur.LAUNCHES)
        frame = FigRenderer(device="cuda").render_frame(scene, size)
        torch.cuda.synchronize()
        out.append((frame, tuple(a - b for a, b in zip(
            (raster.LAUNCHES, mega.LAUNCHES, blur.LAUNCHES), before))))
    return out


def test_tree_headline_on_the_card(dev):
    """bench.py's scene as a tree: the Python walk's frame equals the native
    walk's bit for bit, through K1 twice and the blur kernel once a pass,
    and the planned tape's frame matches the plain executor's."""
    from figdraw_tpu_torch import make_render_tree

    size = vec2(640, 360)
    tree = make_render_tree(640, 360, 2, copies=10)
    (py, py_n), (nat, nat_n) = _tree_and_array_frames(tree, size)
    assert py_n == nat_n == (2, 0, 2)
    assert torch.equal(py, nat)
    ren = FigRenderer(device="cuda")
    plan = plan_execution(ren.flatten(tree, size))
    run = get_frame_executor(plan.structure, plan.height, plan.width,
                             plan.n_masks, plan.has_init_frame, plan.tile_h)
    ref = run(torch.from_numpy(plan.combo).to(dev), None,
              draw=raster.draw_pass_planar_prebinned_plain)
    got = ren.execute_plan(plan)
    assert float((got - ref).abs().max()) <= TOL


def test_tree_subclip_table_on_the_card(dev):
    """bench_clipmask's sub-clip table as a tree: the planner's megakernel
    combo and the native walk's own mega export give the same frame bit for
    bit, one K4 launch each."""
    from figdraw_tpu_torch.scenes import make_table_scene

    tree = make_table_scene("subclip", 320.0, 200.0, 12, 6)
    (py, py_n), (nat, nat_n) = _tree_and_array_frames(tree, vec2(320, 200))
    assert py_n == nat_n == (0, 1, 0)
    assert torch.equal(py, nat)


def test_render_view_takes_mat3_and_root_affine(dev):
    """render_view's root_transforms as Mat3 and root_affine rows on an
    animated snapshot of from_renders(tree): bit-equal to the same view
    given the (R, 6) table."""
    from figdraw_tpu_torch import Mat3, from_renders, make_render_tree, root_affine

    size = vec2(640, 360)
    arr = from_renders(make_render_tree(640, 360, 1, copies=6))
    ren = FigRenderer(device="cuda")
    scene = ren.snapshot_scene(arr, size, animate=True)
    keys = scene.animation_order()
    table = np.zeros((len(keys), 6), np.float32)
    table[:, 0] = table[:, 3] = 1.0
    mats = {keys[2]: Mat3(1.0, 0.0, 12.0, 0.0, 1.0, -5.0),
            keys[5]: Mat3(2.0, 0.0, -30.0, 0.0, 0.5, 40.0)}
    for k, m in mats.items():
        table[keys.index(k)] = (m.a, m.b, m.c, m.d, m.tx, m.ty)
    bulk = ren.render_view(scene, (3.0, -2.0), root_transforms=table)
    assert torch.equal(ren.render_view(scene, (3.0, -2.0), root_transforms=mats), bulk)
    aff = {keys[2]: root_affine((12.0, -5.0)),
           keys[5]: root_affine((-30.0, 40.0), scale=(2.0, 0.5))}
    assert torch.equal(ren.render_view(scene, (3.0, -2.0), root_transforms=aff), bulk)


# --- the frame loop: render_batch, render_frame_async, the blurred cards ------------


def _image_renderer():
    ren = FigRenderer(atlas_size=256, device="cuda")
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    put_image(IMAGE_ID, photo_image(), bus=bus, mipmapped=True)
    return ren


@pytest.mark.parametrize("kind", ["headline", "subclip", "images_clipped", "blurred"])
def test_render_batch_equals_render_frame_on_the_card(kind, dev):
    """Each group kind (unrolled with the blur, mega, mega with the atlas,
    rolled with the atlas and a blur): every batched frame equals
    render_frame's bit for bit, and the group's kernels launch as the
    frames' own would."""
    from figdraw_tpu_torch.scenes import make_blurred_cards_scene

    w, h = (640, 360) if kind == "headline" else (320, 200)
    scenes = {
        "headline": lambda f: make_render_tree_array(w, h, f, copies=10),
        "subclip": lambda f: make_clip_table_scene("subclip", w, h, 12 + f, 6),
        "images_clipped": lambda f: make_image_panels_scene(w + f, h, 12, "images_clipped"),
        "blurred": lambda f: make_blurred_cards_scene(w, h, 10),
    }[kind]
    a, b = _image_renderer(), _image_renderer()
    before = (raster.LAUNCHES, mega.LAUNCHES + mega.ATLAS_LAUNCHES, blur.LAUNCHES)
    out = a.render_batch([scenes(f) for f in range(5)], vec2(w, h), chunk=3)
    torch.cuda.synchronize()
    batch_n = tuple(x - y for x, y in zip(
        (raster.LAUNCHES, mega.LAUNCHES + mega.ATLAS_LAUNCHES, blur.LAUNCHES), before))
    before = (raster.LAUNCHES, mega.LAUNCHES + mega.ATLAS_LAUNCHES, blur.LAUNCHES)
    for f in range(5):
        assert torch.equal(out[f], b.render_frame(scenes(f), vec2(w, h))), f"frame {f}"
    torch.cuda.synchronize()
    frame_n = tuple(x - y for x, y in zip(
        (raster.LAUNCHES, mega.LAUNCHES + mega.ATLAS_LAUNCHES, blur.LAUNCHES), before))
    assert batch_n == frame_n and any(batch_n)
    u8 = a.render_batch([scenes(0)], vec2(w, h), as_uint8=True)
    np.testing.assert_array_equal(u8[0].cpu().numpy(), b.take_screenshot(out[0]))


def test_render_frame_async_equals_sync_on_the_card(dev):
    """48 headline frames through the pipeline: never more than two in
    flight, each equal to the synchronous loop's, with the walk's pooled
    combos rewritten as soon as each frame's slot is released; then a job
    that raises and a frame after it."""
    from figdraw_tpu_torch import native

    w, h = 640, 360
    a, b = FigRenderer(device="cuda"), FigRenderer(device="cuda")
    futs = []
    for f in range(48):
        futs.append(a.render_frame_async(make_render_tree_array(w, h, f, copies=10),
                                         vec2(w, h)))
        assert len(a._async_released) <= 2
        if f % 3 == 0:
            a._async_released[-1].result()
            for key, entry in native._combo_pool.items():
                if key[0] == id(a):
                    entry[0].fill(np.nan)
                    entry[1].fill(np.nan)
    for f, fut in enumerate(futs):
        want = b.render_frame(make_render_tree_array(w, h, f, copies=10), vec2(w, h))
        assert torch.equal(fut.result(), want), f"frame {f}"
    real = a._run_plan

    def boom(*args, **kw):
        raise RuntimeError("injected")

    a._run_plan = boom
    with pytest.raises(RuntimeError, match="injected"):
        a.render_frame_async(make_render_tree_array(w, h, 0, copies=10), vec2(w, h)).result()
    a._run_plan = real
    again = a.render_frame_async(make_render_tree_array(w, h, 1, copies=10), vec2(w, h))
    assert torch.equal(again.result(), b.render_frame(
        make_render_tree_array(w, h, 1, copies=10), vec2(w, h)))


def test_async_image_update_lands_on_the_next_frame_only_on_the_card(dev):
    import threading

    size = vec2(320, 200)
    scene = make_image_panels_scene(320, 200, 12, "images_11")
    red = np.zeros((64, 64, 4), np.uint8)
    red[..., 0] = red[..., 3] = 255
    r = _image_renderer()
    gate, real = threading.Event(), r._run_plan

    def held(*args, **kw):
        gate.wait(30)
        return real(*args, **kw)

    r._run_plan = held
    first = r.render_frame_async(scene, size)
    r.update_image(IMAGE_ID, red)
    second = r.render_frame_async(scene, size)
    gate.set()
    ref = _image_renderer()
    before = ref.render_frame(scene, size)
    ref.update_image(IMAGE_ID, red)
    after = ref.render_frame(scene, size)
    assert torch.equal(first.result(), before) and torch.equal(second.result(), after)
    assert not torch.equal(before, after)


def test_blurred_cards_kernels_match_plain_on_the_card(dev):
    """The blurred cards (25 at 480x270) plan onto the rolled form through
    render_frame: K1-atlas, K3, the blur and the binning against their
    plain versions on the frame's own inputs."""
    from figdraw_tpu_torch.scenes import make_blurred_cards_scene

    ren = _image_renderer()
    ren.process_image_messages()
    scene = make_blurred_cards_scene(480, 270, 25)
    plan = plan_execution(ren.flatten(scene, vec2(480, 270)))
    assert plan.rolled_items is not None and ("blur",) in plan.structure
    before = (raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES, blur.LAUNCHES)
    got = ren.render_frame(scene, vec2(480, 270))
    torch.cuda.synchronize()
    n_atlas = sum(1 for it in plan.structure if it[0] == "draw" and it[1] == -1 and it[2])
    n_mask = sum(1 for it in plan.structure if it[0] == "draw" and it[1] >= 0)
    assert (raster.ATLAS_LAUNCHES - before[0], raster.MASK_LAUNCHES - before[1],
            blur.LAUNCHES - before[2]) == (n_atlas, n_mask, 2)
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h, rolled=True)
    combo = torch.from_numpy(plan.combo).to(dev)
    table = dict(items=plan.rolled_items, radii=plan.rolled_radii)
    ref = run(combo, None, atlas=ren._device_atlas(), **table,
              draw=raster.draw_pass_planar_prebinned_plain,
              draw_mask=raster.draw_pass_mask_prebinned_plain)
    assert float((got - ref).abs().max()) <= TOL
    real_blur, real_bin = executor.backdrop_blur_planar, executor.decode_and_bin
    blurs, bins = [], []

    def blur_both(planes, radius):
        out = real_blur(planes, radius)
        assert torch.equal(out, blur.backdrop_blur_planar_plain(planes, radius))
        blurs.append(1)
        return out

    def bin_both(*a, **k):
        out = real_bin(*a, **k)
        want = decode_and_bin_plain(*a, **k)
        assert torch.equal(out[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(out[1], want[1]) and torch.equal(out[3], want[3])
        bins.append(1)
        return out

    executor.backdrop_blur_planar, executor.decode_and_bin = blur_both, bin_both
    try:
        ren.render_frame(scene, vec2(480, 270))
        torch.cuda.synchronize()
    finally:
        executor.backdrop_blur_planar, executor.decode_and_bin = real_blur, real_bin
    assert blurs == [1] and bins == [1]


# --- text typeset and rasterized by the port, from the bundled font ---------------


def _block_means(frame):
    got = frame.cpu().numpy()
    h, w = got.shape[0] // 8 * 8, got.shape[1] // 8 * 8
    return got[:h, :w].reshape(h // 8, 8, w // 8, 8, 4).mean(axis=(1, 3))


def test_text_scene_typeset_by_the_port_matches_plain(dev):
    """bench_text's scene built by the port (its OpenType reader, shaper,
    typesetter and glyph raster) through render_frame on the card: the
    stored plan's combo and atlas byte for byte, one K1-atlas launch, the
    frame the plain executor's and figdraw_tpu's stored block means."""
    from figdraw_tpu_torch import Color, fill, rgba
    from figdraw_tpu_torch.scenes import TEXT_REFERENCE, make_text_scene
    from figdraw_tpu_torch.text.typefaces import bundled_font_path, load_typeface

    scene, _n = make_text_scene(load_typeface(bundled_font_path()),
                                fill(rgba(20, 20, 30, 255)), 0)
    ren = FigRenderer(atlas_size=512, device="cuda")
    plan = ren._walk_plan(scene, vec2(1200, 800), True, Color(1.0, 1.0, 1.0, 1.0))
    with np.load(TEXT_REFERENCE) as z:
        assert np.array_equal(plan.combo.view(np.uint32), z["combo"].view(np.uint32))
        assert np.array_equal(ren.atlas.data, z["atlas"])
        blocks = z["blocks"].copy()
    counts = _counts()
    frame = ren.render_frame(scene, vec2(1200, 800))
    assert tuple(b - a for a, b in zip(counts, _counts())) == (0, 1, 0, 0, 0)
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h)
    ref = run(torch.from_numpy(plan.combo).to(dev), None, atlas=ren._device_atlas(),
              draw=raster.draw_pass_planar_prebinned_plain)
    torch.cuda.synchronize()
    assert float((frame - ref).abs().max()) <= TOL
    assert np.abs(_block_means(frame) - blocks).max() <= TOL


def test_text_table_built_by_the_port_matches_plain(dev):
    """The text table walked and planned by the port on the megakernel with
    the atlas: one K4-atlas launch, the frame the plain walk's and the
    stored block means."""
    from figdraw_tpu_torch.scenes import TEXT_TABLE_REFERENCE, make_text_table_scene

    ren = FigRenderer(atlas_size=512, device="cuda")
    tape = ren.flatten(make_text_table_scene(), vec2(1200, 800))
    plan = plan_execution(tape)
    assert plan.mega_atlas
    counts = _counts()
    frame = ren.execute_plan(plan)
    assert tuple(b - a for a, b in zip(counts, _counts())) == (0, 0, 0, 0, 1)
    run = get_mega_executor(plan.height, plan.width, plan.n_masks, False, plan.tile_h)
    ref = run(torch.from_numpy(plan.mega_combo).to(dev), None, atlas=ren._device_atlas(),
              draw=mega.draw_pass_mega_plain)
    torch.cuda.synchronize()
    assert float((frame - ref).abs().max()) <= TOL
    with np.load(TEXT_TABLE_REFERENCE) as z:
        assert np.abs(_block_means(frame) - z["blocks"]).max() <= TOL


# --- images from files and generated SDFs -------------------------------------------


def _loaded(path, atlas_size=512, device="cuda"):
    """A renderer with the PNG at `path` loaded on a bus of its own:
    (renderer, ImageRef)."""
    from figdraw_tpu_torch.resources import load_image

    ren = FigRenderer(atlas_size=atlas_size, device=device)
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    return ren, load_image(path, bus=bus)


@pytest.fixture
def fixture_png(tmp_path):
    """The repo's PNG fixture copied where load_image may write its
    sidecar."""
    import shutil

    from figdraw_tpu_torch.scenes import IMAGE_FIXTURE

    path = str(tmp_path / "fixture.png")
    shutil.copyfile(IMAGE_FIXTURE, path)
    return path


def test_image_file_scene_on_the_card(dev, fixture_png):
    """The image-file scene with the fixture loaded through its .flippy
    chain: one K1-atlas launch, the frame the plain executor's and the
    stored block means of figdraw_tpu's."""
    from figdraw_tpu_torch.scenes import (
        IMAGE_FILE_SIZE, example_reference_path, make_image_file_scene,
    )

    ren, ref = _loaded(fixture_png)
    w, h = IMAGE_FILE_SIZE
    scene = make_image_file_scene(w, h, ref.id)
    ren.render_frame(scene, vec2(w, h))
    counts = _counts()
    frame = ren.render_frame(scene, vec2(w, h))
    assert tuple(b - a for a, b in zip(counts, _counts())) == (0, 1, 0, 0, 0)
    plan = plan_execution(ren.flatten(scene, vec2(w, h)))
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h)
    want = run(torch.from_numpy(plan.combo).to(dev), None, atlas=ren._device_atlas(),
               draw=raster.draw_pass_planar_prebinned_plain)
    torch.cuda.synchronize()
    assert float((frame - want).abs().max()) <= TOL
    assert np.abs(_block_means(frame) - np.load(example_reference_path("image_file", "1x"))
                  ).max() <= TOL
    ref.close()


@pytest.mark.parametrize("name", ["msdf_star", "mtsdf"])
def test_sdf_image_modes_on_the_card(name, dev):
    """The MSDF star (modes 13, 15) and the MTSDF scene (14, 15, 16): one
    K1-atlas launch each, the frame the plain executor's and the stored
    block means; the same tape through the megakernel with the atlas
    against its plain walk."""
    import dataclasses

    from figdraw_tpu_torch.plan import pack_mega_combo
    from figdraw_tpu_torch.scenes import EXAMPLE_SCENES, example_reference_path, render_example

    before = _counts()
    ren, frame = render_example(lambda ps: FigRenderer(device="cuda", pixel_scale=ps),
                                name, "1x")
    assert tuple(b - a for a, b in zip(before, _counts())) == (0, 1, 0, 0, 0)
    build, (w, h) = EXAMPLE_SCENES[name]
    tape = ren.flatten(build(w, h), vec2(w, h))
    plan = plan_execution(tape)
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h)
    want = run(torch.from_numpy(plan.combo).to(dev), None, atlas=ren._device_atlas(),
               draw=raster.draw_pass_planar_prebinned_plain)
    torch.cuda.synchronize()
    assert float((frame - want).abs().max()) <= TOL
    assert np.abs(_block_means(frame) - np.load(example_reference_path(name, "1x"))
                  ).max() <= TOL
    mplan = dataclasses.replace(plan, mega_combo=pack_mega_combo(tape), mega_atlas=True)
    mrun = get_mega_executor(mplan.height, mplan.width, mplan.n_masks, False, mplan.tile_h)
    combo = torch.from_numpy(mplan.mega_combo).to(dev)
    got = mrun(combo, None, atlas=ren._device_atlas())
    ref = mrun(combo, None, atlas=ren._device_atlas(), draw=mega.draw_pass_mega_plain)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= TOL
    assert float((got - frame).abs().max()) <= TOL


def test_photo_wall_on_the_card(dev, fixture_png):
    """The 1080p photo wall of the loaded image (48 panels, 12 clipped):
    the megakernel with the atlas once a frame, the frame its plain walk's;
    the 480x270 reduction against the stored block means."""
    from figdraw_tpu_torch.scenes import (
        PHOTO_WALL_REFERENCE, PHOTO_WALL_SMALL, make_loaded_photo_wall,
    )

    ren, ref = _loaded(fixture_png, atlas_size=256)
    scene = make_loaded_photo_wall(1920, 1080, 48, ref.id)
    ren.render_frame(scene, vec2(1920, 1080))
    counts = _counts()
    frame = ren.render_frame(scene, vec2(1920, 1080))
    assert tuple(b - a for a, b in zip(counts, _counts())) == (0, 0, 0, 0, 1)
    assert ren.atlas.size == 2048
    plan = plan_execution(ren.flatten(scene, vec2(1920, 1080)))
    run = get_mega_executor(plan.height, plan.width, plan.n_masks, False, plan.tile_h)
    want = run(torch.from_numpy(plan.mega_combo).to(dev), None, atlas=ren._device_atlas(),
               draw=mega.draw_pass_mega_plain)
    torch.cuda.synchronize()
    assert float((frame - want).abs().max()) <= TOL
    w, h, n = PHOTO_WALL_SMALL
    small, small_ref = _loaded(fixture_png, atlas_size=256)
    got = small.render_frame(make_loaded_photo_wall(w, h, n, small_ref.id), vec2(w, h))
    assert np.abs(_block_means(got) - np.load(PHOTO_WALL_REFERENCE)).max() <= TOL
    ref.close()
    small_ref.close()


# --- band origins: a frame split into row bands (parallel/sharding.py) --------------


@pytest.mark.parametrize("row0,th", [(540, 32), (270, 16), (96, 64)])
def test_tile_kernels_at_a_band_origin_match_plain(row0, th, dev):
    """The front end, K1 (with the backdrop), K3 and K1-atlas at a non-zero
    band origin against their plain versions: equal lists, planes within
    1/255, the band counters moving."""
    from figdraw_tpu_torch.ops.binning import list_differences

    w, h, bh = 512, 1080, 64
    fields, modes, n_live = modes_tape(w, h)
    rng = np.random.RandomState(row0)
    modes[1:n_live:5, 1] = 1
    rows = torch.from_numpy(pack_fields_np(fields, modes)).to(dev)
    n = rows.shape[0]
    counts = (binning.BAND_LAUNCHES, binning.BAND_DECODE_LAUNCHES)
    f, m, tile_idx, tile_counts = decode_and_bin(rows, 0, n, bh // th, w // 128, th, 128,
                                                 cull=True, row0=row0)
    assert (binning.BAND_LAUNCHES, binning.BAND_DECODE_LAUNCHES) == (counts[0] + 1,
                                                                     counts[1] + 1)
    ref = decode_and_bin_plain(rows, 0, n, bh // th, w // 128, th, 128, cull=True,
                               row0=row0)
    assert torch.equal(f.view(torch.int32), ref[0].view(torch.int32))
    diff = list_differences(tile_idx.cpu().numpy(), tile_counts.cpu().numpy(),
                            ref[2].cpu().numpy(), ref[3].cpu().numpy())
    assert diff["max_abs_err"] == 0 and tile_counts.sum() > 0
    planes, backdrop, mask1 = (torch.from_numpy(rng.rand(*s).astype(np.float32)).to(dev)
                               for s in ((4, bh, w), (4, bh, w), (1, bh, w)))
    masks = torch.cat([torch.ones_like(mask1), mask1])
    bounds = torch.tensor([0, n_live], dtype=torch.int32, device=dev)
    before = planes.clone()
    launches = raster.BAND_LAUNCHES
    out = raster.draw_pass_planar_prebinned(f, m, bounds, tile_idx, tile_counts, planes,
                                            masks, backdrop, tile_h=th, row0=row0)
    assert raster.BAND_LAUNCHES == launches + 1
    want = raster.draw_pass_planar_prebinned_plain(f, m, bounds, tile_idx, tile_counts,
                                                   before, masks, backdrop, tile_h=th,
                                                   row0=row0)
    target = masks[1:2].clone()
    k3 = raster.draw_pass_mask_prebinned(f, m, bounds, tile_idx, tile_counts, target,
                                         masks, tile_h=th, row0=row0)
    want_k3 = raster.draw_pass_mask_prebinned_plain(f, m, bounds, tile_idx, tile_counts,
                                                    masks[1:2], masks, tile_h=th, row0=row0)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= TOL
    assert float((out - before).abs().max()) > 0.1
    assert float((k3 - want_k3).abs().max()) <= TOL
    # K1-atlas at the origin on the atlas modes tape
    af, am, n_atlas, atlas = atlas_modes_tape(w, bh, 256, seed=row0)
    # the quads moved down into the band: their origins, bboxes and the
    # rect masks' centers (the rest of a row is relative to its origin)
    af[:n_atlas, [5, 7, 9]] += row0
    masked = af[:n_atlas, 54] >= 0
    af[:n_atlas][masked, 53] += row0
    af_t, am_t = torch.from_numpy(af).to(dev), torch.from_numpy(am).to(dev)
    a_idx, a_counts = bin_quads(af_t, 0, af.shape[0], bh // th, w // 128, th, 128,
                                row0=row0)
    atlas = torch.from_numpy(atlas).to(dev)
    whole = torch.tensor([0, af.shape[0]], dtype=torch.int32, device=dev)
    a_planes = torch.from_numpy(rng.rand(4, bh, w).astype(np.float32)).to(dev)
    a_before = a_planes.clone()
    ones = torch.ones((1, bh, w), device=dev)
    launches = raster.BAND_ATLAS_LAUNCHES
    got = raster.draw_pass_planar_prebinned(af_t, am_t, whole, a_idx, a_counts, a_planes,
                                            ones, atlas=atlas, tile_h=th, row0=row0)
    assert raster.BAND_ATLAS_LAUNCHES == launches + 1
    want_a = raster.draw_pass_planar_prebinned_plain(af_t, am_t, whole, a_idx, a_counts,
                                                     a_before, ones, atlas=atlas,
                                                     tile_h=th, row0=row0)
    torch.cuda.synchronize()
    assert float((got - want_a).abs().max()) <= TOL
    assert float((got - a_before).abs().max()) > 0.1


@pytest.mark.parametrize("atlas_size", [None, 256])
def test_mega_kernel_at_a_band_origin_matches_plain(atlas_size, dev):
    """K4 and K4-atlas at a non-zero origin against the plain walk; the
    band's rows equal the whole frame's."""
    n_masks, th, row0 = 3, 32, 128
    f, m, tile_idx, tile_counts, planes, atlas = _mega_args(n_masks, th, dev,
                                                            atlas_size=atlas_size)
    band_idx, band_counts = bin_quads(f, 0, f.shape[0], 2, 4, th, 128, row0=row0)
    band = planes[:, row0 : row0 + 64].clone()
    before = band.clone()
    counts = (mega.BAND_LAUNCHES, mega.BAND_ATLAS_LAUNCHES)
    out = mega.draw_pass_mega(f, m, band_idx, band_counts, band, n_masks, tile_h=th,
                              atlas=atlas, row0=row0)
    want = (counts[0] + (atlas is None), counts[1] + (atlas is not None))
    assert (mega.BAND_LAUNCHES, mega.BAND_ATLAS_LAUNCHES) == want
    ref = mega.draw_pass_mega_plain(f, m, band_idx, band_counts, before, n_masks,
                                    tile_h=th, atlas=atlas, row0=row0)
    whole = mega.draw_pass_mega(f, m, tile_idx, tile_counts, planes.clone(), n_masks,
                                tile_h=th, atlas=atlas)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= TOL
    assert float((out - whole[:, row0 : row0 + 64]).abs().max()) <= TOL


@pytest.mark.parametrize("n,rows,radius", [(4, 272, 18.0), (8, 96, 64.0)])
def test_banded_blur_kernel_matches_plain(n, rows, radius, dev):
    """X6: the two banded kernels over the bands of a mesh of one card, on
    the swap and the gather path, bit for bit with the plain version; two
    launches whatever the number of bands."""
    rng = np.random.RandomState(n)
    planes = torch.from_numpy(rng.rand(4, rows, 384).astype(np.float32)).to(dev)
    bh = rows // n
    bands = [planes[:, i * bh : (i + 1) * bh].contiguous() for i in range(n)]
    radii = [torch.tensor(radius, device=dev)] * n
    before = blur.BAND_LAUNCHES
    got = blur.banded_blur_planar(bands, radii)
    want = blur.banded_blur_planar_plain(bands, radii)
    torch.cuda.synchronize()
    assert blur.BAND_LAUNCHES == before + 2
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _tall_bands(n, pband, kh, pw, seed, dev):
    """n bands of pband rows, each the first pband rows of (4, kh, pw)
    planes on the card whose extra rows hold other values."""
    rng = np.random.RandomState(seed)
    planes = [torch.from_numpy(rng.rand(4, kh, pw).astype(np.float32)).to(dev)
              for _ in range(n)]
    return [p[:, :pband] for p in planes]


@pytest.mark.parametrize("n,pband,kh,radius", [
    (4, 272, 288, 17.3), (4, 272, 272, 13.7), (3, 80, 96, 0.4), (24, 48, 64, 17.3),
    (1, 120, 128, 13.7), (2, 72, 80, 100.0)])
def test_banded_blur_kernel_tall_planes_into_views(n, pband, kh, radius, dev):
    """X6 at non-dyadic radii (and the identity at r <= 0.5, the clamp past
    64) on bands that are the first pband rows of taller planes, written
    into the first pband rows of taller backdrops as the sharded executor
    calls it: bit for bit with the plain version, the backdrops' other rows
    and the inputs untouched, per-band radii that differ each taken."""
    bands = _tall_bands(n, pband, kh, 392, n * kh, dev)
    before = [b.clone() for b in bands]
    radii = [torch.tensor(radius + 0.7 * (i % 2), device=dev) for i in range(n)]
    backdrops = [torch.full((4, kh, 392), -1.0, device=dev) for _ in range(n)]
    out = [b[:, :pband] for b in backdrops]
    launches = blur.BAND_LAUNCHES
    got = blur.banded_blur_planar(bands, radii, out=out)
    assert blur.BAND_LAUNCHES == launches + 2
    want = blur.banded_blur_planar_plain(bands, radii)
    torch.cuda.synchronize()
    assert all(g is o for g, o in zip(got, out))
    for a, b in zip(got, want):
        assert torch.equal(a.contiguous().view(torch.int32), b.view(torch.int32))
    assert all(bool((b[:, pband:] == -1.0).all()) for b in backdrops)
    assert all(torch.equal(a, b) for a, b in zip(bands, before))


@pytest.mark.parametrize("pattern", [[0, 1, 0, 1], [0, 0, 1, 1], [0, 1, 2, 3]])
@pytest.mark.parametrize("pband,radius", [(272, 18.0), (272, 17.3), (48, 17.3)])
def test_banded_blur_kernel_halo_buffer_route(pattern, pband, radius, dev):
    """The route bands on several devices take, on one card: the bands
    grouped by stand-in keys, each group its own scratch and launches, the
    rows of a neighbour in another group copied into the scratch (one copy
    a neighbour edge, or a band on the gather path) and read from there by
    the vertical kernel; bit for bit with the plain version and with the
    plain passes through the same table."""
    n = len(pattern)
    bands = _tall_bands(n, pband, pband + 16, 256, pband, dev)
    radii = [torch.tensor(radius, device=dev)] * n
    groups = blur.band_table(pattern, pband)
    assert blur.copy_bytes(groups, 4, 256) > 0
    launches = blur.BAND_LAUNCHES
    got = blur.banded_blur_kernels(bands, radii, pattern)
    assert blur.BAND_LAUNCHES == launches + 2 * len(groups)
    want = blur.banded_blur_planar_plain(bands, radii)
    table = blur.banded_blur_table_plain(bands, radii, keys=pattern)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, table):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))


def test_whole_blur_keeps_its_results_beside_the_bands(dev):
    """X1 on (4, 1088, 1920) planes, whose kernels X6 shares, bit for bit
    with the plain blur at r = 18 and r = 17.3."""
    rng = np.random.RandomState(1088)
    planes = torch.from_numpy(rng.rand(4, 1088, 1920).astype(np.float32)).to(dev)
    for r in (18.0, 17.3):
        rt = torch.tensor(r, device=dev)
        got = blur.backdrop_blur_planar(planes, rt)
        want = blur.backdrop_blur_planar_plain(planes, rt)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_sharded_frames_on_one_card(dev):
    """ShardedFigRenderer over [cuda:0] * 4 renders the headline as
    FigRenderer does (1/255), and render_batch over a mesh of the card
    equals render_frame bit for bit."""
    from figdraw_tpu_torch.parallel.sharding import FRAMES_AXIS, Mesh, ShardedFigRenderer

    size = vec2(640, 360)
    sr = ShardedFigRenderer(Mesh((dev,) * 4), atlas_size=64)
    got = sr.render_frame(make_render_tree_array(640, 360, 3, copies=30), size)
    want = FigRenderer(device="cuda").render_frame(
        make_render_tree_array(640, 360, 3, copies=30), size)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL
    ren = FigRenderer(device="cuda")
    out = ren.render_batch([make_render_tree_array(640, 360, f, copies=30) for f in range(5)],
                           size, chunk=2, mesh=Mesh((dev,) * 2, FRAMES_AXIS))
    for f in range(5):
        assert torch.equal(out[f], ren.render_frame(
            make_render_tree_array(640, 360, f, copies=30), size))


# --- WOFF 2.0 faces, rebuilt through the port's Brotli decoder ----------------------

WOFF2_TEXT_CASES = [c for c in FONT_TEXT_CASES if c[0].endswith(".woff2")]


@pytest.mark.parametrize("case", WOFF2_TEXT_CASES, ids=[c[0] for c in WOFF2_TEXT_CASES])
def test_woff2_bench_text_on_the_card(case, dev):
    """bench_text from a WOFF2 face through render_frame on the card: one
    K1-atlas launch, the frame the plain executor's and within 1/255 of
    figdraw_tpu's stored block means."""
    from figdraw_tpu_torch import Color, fill, rgba
    from figdraw_tpu_torch.scenes import (
        font_blocks_path, font_case_key, font_text, make_text_scene,
    )
    from figdraw_tpu_torch.text.typefaces import FontVariation, bundled_font_path, load_typeface

    face, loc = case
    scene, _n = make_text_scene(load_typeface(bundled_font_path(face)),
                                fill(rgba(20, 20, 30, 255)), 0,
                                variations=tuple(FontVariation(t, v) for t, v in loc),
                                text=font_text(face)[0])
    ren = FigRenderer(atlas_size=512, device="cuda")
    plan = ren._walk_plan(scene, vec2(1200, 800), True, Color(1.0, 1.0, 1.0, 1.0))
    ren.render_frame(scene, vec2(1200, 800))
    counts = _counts()
    frame = ren.render_frame(scene, vec2(1200, 800))
    assert tuple(b - a for a, b in zip(counts, _counts())) == (0, 1, 0, 0, 0)
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h)
    ref = run(torch.from_numpy(plan.combo).to(dev), None, atlas=ren._device_atlas(),
              draw=raster.draw_pass_planar_prebinned_plain)
    torch.cuda.synchronize()
    assert float((frame - ref).abs().max()) <= 1e-5
    blocks = np.load(font_blocks_path(font_case_key(face, loc)))
    assert np.abs(_block_means(frame) - blocks).max() <= TOL


def test_woff2_text_table_on_the_card(dev):
    """The WOFF2 VF face's text table walked and planned by the port on the
    megakernel with the atlas: one K4-atlas launch, the frame the plain
    walk's and within 1/255 of figdraw_tpu's stored block means."""
    from figdraw_tpu_torch.scenes import (
        FONT_WOFF2_TABLE_CASE, font_blocks_path, font_case_key, make_text_table_scene,
    )
    from figdraw_tpu_torch.text.typefaces import FontVariation, bundled_font_path, load_typeface

    face, loc = FONT_WOFF2_TABLE_CASE
    tree = make_text_table_scene(180, 6, 1200.0, 800.0,
                                 tid=load_typeface(bundled_font_path(face)),
                                 variations=tuple(FontVariation(t, v) for t, v in loc))
    ren = FigRenderer(atlas_size=512, device="cuda")
    plan = plan_execution(ren.flatten(tree, vec2(1200, 800)))
    assert plan.mega_atlas
    counts = _counts()
    frame = ren.execute_plan(plan)
    assert tuple(b - a for a, b in zip(counts, _counts())) == (0, 0, 0, 0, 1)
    run = get_mega_executor(plan.height, plan.width, plan.n_masks, False, plan.tile_h)
    ref = run(torch.from_numpy(plan.mega_combo).to(dev), None, atlas=ren._device_atlas(),
              draw=mega.draw_pass_mega_plain)
    torch.cuda.synchronize()
    assert float((frame - ref).abs().max()) <= 1e-5
    blocks = np.load(font_blocks_path(font_case_key(face, loc)))
    assert np.abs(_block_means(frame) - blocks).max() <= TOL


def test_brotli_decoder_on_the_cards_host(dev):
    """fd_brotli_decompress, built on the card's machine, on each WOFF2
    face's stream: the stored size and sha256 (libbrotlidec's output) and
    decompress_plain's bytes."""
    import hashlib
    import json

    from figdraw_tpu_torch.scenes import FONTS_REFERENCE, WOFF2_FACES
    from figdraw_tpu_torch.text.typefaces import bundled_font_path
    from figdraw_tpu_torch.text.woff2 import directory
    from figdraw_tpu_torch.utils import brotli

    with open(FONTS_REFERENCE) as fh:
        refs = json.load(fh)["woff2"]
    for face in WOFF2_FACES:
        with open(bundled_font_path(face), "rb") as fh:
            data = fh.read()
        head, _entries, at = directory(data)
        stream = data[at: at + head[6]]
        got = brotli.decompress(stream)
        assert len(got) == refs[face]["bytes"]
        assert hashlib.sha256(got).hexdigest() == refs[face]["sha256"]
        assert got == brotli.decompress_plain(stream)
