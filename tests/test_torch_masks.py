"""Clip masks in figdraw_tpu_torch against figdraw_tpu on the CPU: the clip
benchmark's scene builders, the frame executor's binning (culling scoped to
the frame-target runs), the mask-plane pass K3 (plain version against the
Pallas kernel in interpret mode), the rect-mask table of bench_clipmask.py
through render_frame at 12x6 cells and 320x200, and twins of
test_raster.py's clip and rect-mask tests. Pixels within 1/255; combos and
tile lists exactly."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_clipmask
import figdraw_tpu_torch as port
from figdraw_tpu import FigRenderer as JaxRenderer, vec2 as jax_vec2
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.ops import raster_pallas
from figdraw_tpu_torch import executor
from figdraw_tpu_torch.basics import FigFlags, FigKind
from figdraw_tpu_torch.nodesarray import RenderListArray, RendersArray
from figdraw_tpu_torch.ops import raster
from figdraw_tpu_torch.ops.binning import bin_quads, decode_and_bin
from figdraw_tpu_torch.ops.layout import (
    PACKED_WIDTH, QF_AA, QF_BBOX_X0, QF_COLOR0, QF_INV_A, QF_INV_D, QF_ORG_X,
    QF_ORG_Y, QF_PARAMS, QF_RECT_PARAMS, QF_UVDU_X, QF_UVDV_Y, QF_WIDTH,
    pack_fields_np,
)
from figdraw_tpu_torch.plan import fill_meta, from_jax_plan, meta_rows, plan_execution
from figdraw_tpu_torch.scenes import make_clip_table_scene, modes_tape
from torch_reference import ensure_jax_native, fresh_combo_pools

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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reduced clip table of these tests and of chip_smoke.py's stored
# reference: 12 rows x 6 columns at 320x200 (the benchmark: 180 x 6 at
# 1200x800)
ROWS, COLS, W, H = 12, 6, 320, 200


def jax_table(kind, w=W, h=H, rows=ROWS, cols=COLS, monkeypatch=None):
    """bench_clipmask's scene in array form (its table size is a module
    global read at call time)."""
    monkeypatch.setattr(bench_clipmask, "ROWS", rows)
    monkeypatch.setattr(bench_clipmask, "COLS", cols)
    if kind == "noclip":
        return from_renders(bench_clipmask.make_nonclip_scene(float(w), float(h)))
    return from_renders(bench_clipmask.make_table_scene(kind, float(w), float(h)))


@pytest.mark.parametrize("size", [(ROWS, COLS, W, H), (180, 6, 1200, 800)])
@pytest.mark.parametrize("kind", ["noclip", "rectmask", "subclip"])
def test_clip_table_scene_bytes_match_reference(kind, size, monkeypatch):
    rows, cols, w, h = size
    a = jax_table(kind, w, h, rows, cols, monkeypatch).layers[0]
    b = make_clip_table_scene(kind, w, h, rows, cols).layers[0]
    assert a.count == b.count and a.root_ids == b.root_ids
    assert a.nodes[: a.count].tobytes() == b.nodes[: b.count].tobytes()


# --- the frame executor's binning ----------------------------------------------


def _quad(f, x, y, w, h, alpha=1.0):
    """An axis-aligned rounded-box fill (mode 3) in logical row f."""
    f[QF_INV_A], f[QF_INV_D] = 1.0 / w, 1.0 / h
    f[QF_ORG_X], f[QF_ORG_Y] = x, y
    f[QF_BBOX_X0 : QF_BBOX_X0 + 4] = (x, y, x + w, y + h)
    f[QF_UVDU_X] = f[QF_UVDV_Y] = 1.0
    f[QF_COLOR0 : QF_COLOR0 + 16] = np.tile((0.2, 0.4, 0.6, alpha), 4)
    f[QF_PARAMS : QF_PARAMS + 4] = (w / 2, h / 2, w / 2, h / 2)
    f[QF_AA] = 1.2
    f[QF_RECT_PARAMS + 2] = f[QF_RECT_PARAMS + 3] = -1.0


class _Binned(Exception):
    pass


def _executor_binning(monkeypatch, structure, combo, height, width, n_masks,
                      tile_h):
    """The tile lists the frame executor bins for this combo (the run stops
    right after the binning)."""
    seen = {}

    def spy(*args, **kw):
        seen["lists"] = decode_and_bin(*args, **kw)[2:]
        raise _Binned

    monkeypatch.setattr(executor, "decode_and_bin", spy)
    run = executor.get_frame_executor(structure, height, width, n_masks, False,
                                      tile_h)
    with pytest.raises(_Binned):
        run(torch.from_numpy(combo))
    return seen["lists"]


def _jax_prebin(fields, modes, bounds, frame_runs, ph, pw, tile_h):
    rb = [b for b, is_frame in zip(bounds, frame_runs) if is_frame]
    idx, counts = raster_pallas.prebin(
        jnp.asarray(fields), jnp.int32(fields.shape[0]), ph, pw, tile_h=tile_h,
        tile_w=128, modes=jnp.asarray(modes) if rb else None,
        run_bounds=jnp.asarray(np.asarray(rb, np.int32)) if rb else None,
        n_runs=len(rb))
    return np.asarray(idx)[:, 0, :], np.asarray(counts)


@pytest.mark.parametrize("n_pad", [64, 4096])  # 4096: the saturation tier
def test_frame_binning_culls_frame_runs_only(n_pad, monkeypatch):
    """A mask-write run whose second quad covers a whole tile opaquely keeps
    its first quad: only frame-target runs are occlusion- and
    saturation-culled, as figdraw_tpu's executor bins them."""
    fields = np.zeros((n_pad, QF_WIDTH), np.float32)
    modes = np.zeros((n_pad, 2), np.int32)
    modes[:5, 0] = 3
    _quad(fields[0], 10, 10, 60, 40)  # frame run [0, 1)
    _quad(fields[1], 20, 20, 30, 30)  # mask run [1, 3) into plane 1
    _quad(fields[2], -10, -10, 150, 150)  # covers tile 0 opaquely
    _quad(fields[3], 5, 5, 100, 50, alpha=0.5)  # frame run [3, 5), masked
    _quad(fields[4], 40, 30, 80, 60)
    modes[3:5, 1] = 1
    structure = (("draw", -1, False, False), ("clear_mask", 1),
                 ("draw", 1, False, False), ("draw", -1, False, False))
    bounds = [(0, 1), (1, 3), (3, 5)]
    combo = np.zeros((n_pad + meta_rows(3, 0, PACKED_WIDTH), PACKED_WIDTH),
                     np.float32)
    pack_fields_np(fields, modes, out=combo[:n_pad])
    fill_meta(combo[n_pad:].reshape(-1), bounds, [], (1.0, 1.0, 1.0, 1.0))

    idx, counts = _executor_binning(monkeypatch, structure, combo, 128, 256, 2,
                                    128)
    ref_idx, ref_counts = _jax_prebin(fields, modes, bounds,
                                      (True, False, True), 128, 256, 128)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert idx[0, : counts[0]].tolist()[:3] == [0, 1, 2]
    # binning the mask run as a frame run would have culled its first quad
    all_runs = bin_quads(torch.from_numpy(fields), 0, n_pad, 1, 2, 128, 128,
                         modes=torch.from_numpy(modes),
                         run_bounds=torch.tensor(bounds, dtype=torch.int32))
    assert 1 not in all_runs[0][0, : all_runs[1][0]].tolist()


def test_rectmask_table_binning_matches_prebin(monkeypatch):
    """The full-size rect-mask table (1200x800, 180x6: 6144 rows, so the
    saturation tier runs): the executor's tile lists equal
    raster_pallas.prebin's over the frame-target runs."""
    ren = port.FigRenderer(device="cpu")
    tape = ren.flatten(make_clip_table_scene("rectmask"), port.vec2(1200, 800))
    plan = plan_execution(tape)
    kinds = [(item[0], item[1] if item[0] != "blur" else None)
             for item in plan.structure]
    assert kinds == [("draw", -1), ("clear_mask", 1), ("draw", 1), ("draw", -1)]
    assert (tape.combo_quads, plan.n_masks, plan.tile_h) == (6144, 2, 64)
    idx, counts = _executor_binning(monkeypatch, plan.structure, plan.combo,
                                    800, 1200, plan.n_masks, plan.tile_h)
    fields, modes = tape.fields, tape.modes
    ref_idx, ref_counts = _jax_prebin(fields, modes, plan.bounds,
                                      (True, False, True), 832, 1280, 64)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)


# --- K3: the mask-plane pass -----------------------------------------------------


def _mask_inputs(th, seed=0):
    """The modes tape (every SDF mode), its binning, and seeded target and
    mask planes: three planes, some quads reading planes 1 and 2."""
    fields, modes, n_live = modes_tape(256, 128)
    rng = np.random.RandomState(seed)
    modes = modes.copy()
    modes[1:n_live:4, 1] = 1
    modes[2:n_live:5, 1] = 2
    masks = np.ones((3, 128, 256), np.float32)
    masks[1:] = rng.rand(2, 128, 256)
    target = rng.rand(1, 128, 256).astype(np.float32)
    tile_idx, tile_counts = bin_quads(torch.from_numpy(fields), 0,
                                      fields.shape[0], 128 // th, 2, th, 128)
    return fields, modes, n_live, target, masks, tile_idx, tile_counts


@pytest.mark.parametrize("th", [128, 64])
@pytest.mark.parametrize("run", ["whole", "segment"])
def test_plain_mask_pass_matches_pallas(th, run):
    fields, modes, n_live, target, masks, tile_idx, tile_counts = _mask_inputs(th)
    start, end = (0, n_live) if run == "whole" else (4, n_live - 5)
    ref = np.asarray(raster_pallas.draw_pass_mask_prebinned(
        jnp.asarray(fields), jnp.asarray(modes), jnp.int32(start),
        jnp.int32(end), jnp.asarray(tile_idx.numpy())[:, None, :],
        jnp.asarray(tile_counts.numpy()), jnp.asarray(target),
        jnp.asarray(masks), tile_h=th))
    got = raster.draw_pass_mask_prebinned_plain(
        torch.from_numpy(fields), torch.from_numpy(modes),
        torch.tensor([start, end], dtype=torch.int32), tile_idx, tile_counts,
        torch.from_numpy(target), torch.from_numpy(masks), tile_h=th)
    assert tuple(got.shape) == (1, 128, 256) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= TOL
    assert np.abs(ref - target).max() > 0.1  # the pass wrote the plane


def test_cpu_tensors_take_the_plain_mask_pass():
    fields, modes, n_live, target, masks, tile_idx, tile_counts = _mask_inputs(64)
    args = (torch.from_numpy(fields), torch.from_numpy(modes),
            torch.tensor([0, n_live], dtype=torch.int32), tile_idx, tile_counts,
            torch.from_numpy(target), torch.from_numpy(masks))
    want = raster.draw_pass_mask_prebinned_plain(*args, tile_h=64)
    before = raster.MASK_LAUNCHES
    out = raster.draw_pass_mask_prebinned(*args, tile_h=64)
    assert raster.MASK_LAUNCHES == before
    assert out is args[5]  # the target, updated in place
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    meta = torch.empty((1, 128, 128), device="meta")
    with pytest.raises(ValueError, match="no raster kernel"):
        raster.draw_pass_mask_prebinned(meta, meta, meta, meta, meta, meta, meta)


# --- the rect-mask table through render_frame ------------------------------------


@pytest.fixture(scope="module")
def jax_rectmask():
    """figdraw_tpu's rect-mask table frames, clearing and not (the second
    starts from the first), and its renderer."""
    mp = pytest.MonkeyPatch()
    scene = jax_table("rectmask", monkeypatch=mp)
    mp.undo()
    jr = JaxRenderer(atlas_size=64, use_pallas=True)
    first = np.asarray(jr.render_frame(scene, jax_vec2(W, H)))
    second = np.asarray(jr.render_frame(scene, jax_vec2(W, H), clear_main=False))
    assert jr.use_pallas, "the JAX renderer fell back from Pallas"
    return scene, jr, first, second


def test_rectmask_table_matches_reference(jax_rectmask):
    scene, jr, first, second = jax_rectmask
    pr = port.FigRenderer(device="cpu")
    ours = make_clip_table_scene("rectmask", W, H, ROWS, COLS)
    fresh_combo_pools()
    jt = jr.flatten(scene, jax_vec2(W, H))
    pt = pr.flatten(ours, port.vec2(W, H))
    assert pt.combo.tobytes() == jt.combo.tobytes()
    assert [it[0] for it in pt.structure_cache[0]] == ["draw", "clear_mask",
                                                       "draw", "draw"]
    before = (raster.LAUNCHES, raster.MASK_LAUNCHES)
    got = pr.render_frame(ours, port.vec2(W, H))
    assert (raster.LAUNCHES, raster.MASK_LAUNCHES) == before  # plain on CPU
    assert tuple(got.shape) == (H, W, 4)
    assert np.abs(got.numpy() - first).max() <= TOL
    again = pr.render_frame(ours, port.vec2(W, H), clear_main=False)
    assert np.abs(again.numpy() - second).max() <= TOL
    assert got.numpy().std() > 0.01  # not a blank frame


def test_jax_mask_plan_runs_through_port_executor(jax_rectmask):
    scene, jr, first, _second = jax_rectmask
    jplan = jr._plan_execution(jr.flatten(scene, jax_vec2(W, H)))
    plan = from_jax_plan(jplan)
    assert plan.mega_combo is None and plan.n_masks == 2
    got = port.FigRenderer(device="cpu").execute_plan(plan).numpy()
    assert np.abs(got - first).max() <= TOL


def test_stored_rectmask_blocks_match_jax(jax_rectmask):
    """chip_smoke.py holds the port's rect-mask table on the card against
    these block means of figdraw_tpu's frame; they must stay its."""
    blocks = jax_rectmask[2].reshape(H // 8, 8, W // 8, 8, 4).mean(axis=(1, 3))
    stored = np.load(os.path.join(REPO, "figdraw_tpu_torch", "reference",
                                  "cliptable_rectmask_320x200_blocks8.npy"))
    np.testing.assert_allclose(stored, blocks, rtol=0, atol=1e-6)


# --- twins of test_raster.py's clip tests ----------------------------------------


def _render_96x64(flags, corners):
    lst = RenderListArray()
    p = lst.add_root_raw()
    n = lst.nodes
    n["kind"][p] = int(FigKind.nkRectangle)
    n["box"][p] = (10, 10, 40, 30)
    n["corners"][p] = (corners,) * 4
    n["flags"][p] = int(flags)
    n["fill"]["c0"][p] = (200, 200, 200, 255)
    c = lst.add_child_raw(p)
    n["kind"][c] = int(FigKind.nkRectangle)
    n["box"][c] = (0, 0, 96, 64)
    n["fill"]["c0"][c] = (255, 0, 0, 255)
    scene = RendersArray()
    scene.set_layer(0, lst)
    ren = port.FigRenderer(device="cpu")
    ren.render_frame(scene, port.vec2(96, 64))
    return ren.take_screenshot().astype(np.float32)


def test_clip_mask():
    img = _render_96x64(FigFlags.NfClipContent, 12)
    # child red fills only inside the clip shape
    assert np.array_equal(img[25, 30], [255, 0, 0, 255])
    assert np.all(img[5, 5] == 255)  # outside clip: background
    # rounded clip corner: (11, 11) outside the radius-12 arc
    assert img[11, 11, 1] > 100  # not pure red


def test_rect_mask_fast_path():
    img = _render_96x64(FigFlags.NfRectMaskContent, 8)
    assert np.array_equal(img[25, 30], [255, 0, 0, 255])
    assert np.all(img[5, 70] == 255)
