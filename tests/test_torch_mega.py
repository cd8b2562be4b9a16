"""The megakernel path of figdraw_tpu_torch against figdraw_tpu on the CPU:
the walk's fast export (route and combo bytes), pack_mega_combo, the
megakernel K4 (plain version against the Pallas kernel in interpret mode,
with clear sentinels, K == 1 and out-of-range plane indices), the sub-clip
table of bench_clipmask.py through render_frame at 12x6 cells and 320x200,
and the JAX package's mega plans through the port. Pixels within 1/255;
combos and modes exactly."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_clipmask
import figdraw_tpu.executor as jex
import figdraw_tpu_torch as port
from figdraw_tpu import Fig, FigFlags, FigKind, fill, new_renders, rect, rgba
from figdraw_tpu import FigRenderer as JaxRenderer, vec2 as jax_vec2
from figdraw_tpu import native as jax_native
from figdraw_tpu import tape as jax_tape
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.ops import layout as jax_layout, raster_pallas
from figdraw_tpu.renderer import _bucket
from figdraw_tpu_torch import native, tape as port_tape
from figdraw_tpu_torch.executor import unpack_combo
from figdraw_tpu_torch.ops import mega
from figdraw_tpu_torch.ops.binning import bin_quads
from figdraw_tpu_torch.ops.layout import (
    PACKED_WIDTH, QF_BBOX_X0, QF_WIDTH, QI_MODE, pack_fields_np,
)
from figdraw_tpu_torch.plan import (
    bucket, from_jax_plan, pack_mega_combo, plan_execution,
)
from figdraw_tpu_torch.scenes import make_clip_table_scene, modes_tape
from torch_reference import ensure_jax_native, spy_mega_runs, to_port

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
ROWS, COLS, W, H = 12, 6, 320, 200  # as tests/test_torch_masks.py


def jax_table(kind, monkeypatch, rows=ROWS, cols=COLS, w=W, h=H):
    monkeypatch.setattr(bench_clipmask, "ROWS", rows)
    monkeypatch.setattr(bench_clipmask, "COLS", cols)
    return from_renders(bench_clipmask.make_table_scene(kind, float(w), float(h)))


def clip_table(rows=8, cols=6, w=256.0, h=200.0):
    """tests/test_mega.py's clip table: clipped cells, each with one rotated
    translucent child that spills over it."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(250, 250, 250, 255))))
    for r in range(rows):
        for c in range(cols):
            cell = renders.add_root(0, Fig(
                kind=FigKind.nkRectangle,
                screen_box=rect(4 + c * 40, 4 + r * 24, 36, 20),
                corners=(5, 5, 5, 5), flags=FigFlags.NfClipContent,
                fill=fill(rgba(200 - r * 9, 60 + c * 20, 120, 255)),
            ))
            renders.add_child(0, cell, Fig(
                kind=FigKind.nkRectangle, screen_box=rect(0, 0, 300, 300),
                fill=fill(rgba(30, 30, 220, 120)), rotation=10.0,
            ))
    return from_renders(renders)


def _scenes(name, monkeypatch):
    """(figdraw_tpu array scene, the port's, width, height)."""
    if name == "clip_table":
        a = clip_table()
        return a, to_port(a), 256, 200
    if name == "clip_table_12":
        a = clip_table(rows=12, h=300.0)
        return a, to_port(a), 256, 300
    if name == "subclip_full":
        a = jax_table("subclip", monkeypatch, 180, 6, 1200, 800)
        return a, make_clip_table_scene("subclip"), 1200, 800
    kind = name.split("_")[0]
    return (jax_table(kind, monkeypatch), make_clip_table_scene(kind, W, H, ROWS, COLS),
            W, H)


@pytest.mark.parametrize("name", ["clip_table", "clip_table_12", "subclip_small",
                                  "rectmask_small", "subclip_full"])
def test_flatten_fast_matches_reference(name, monkeypatch):
    a, b, w, h = _scenes(name, monkeypatch)
    ref = jax_native.flatten_fast(a, w, h, 1.0, 1.0, 1.2, (1, 1, 1, 1),
                                  min_items=24, bucket=_bucket)
    got = native.flatten_fast(b, w, h, 1.0, 1.0, 1.2, (1, 1, 1, 1))
    assert got[0] == ref[0] == ("tape" if name.startswith("rectmask") else "mega")
    if got[0] == "tape":
        assert got[1].combo.tobytes() == ref[1].combo.tobytes()
        return
    assert got[2:] == ref[2:]  # mask_count, density
    assert got[1].shape == ref[1].shape
    assert got[1][:-1].tobytes() == ref[1][:-1].tobytes()
    if name == "subclip_full":  # the benchmark's own export
        assert (got[1].shape, got[2]) == ((8193, 52), 2)


def _reference_combo(jt, fields, modes, clear_color):
    """figdraw_tpu's mega combo of a tape with logical rows (fields, modes):
    executor.pack_mega_modes' rows packed by its own packer and padded to
    their bucket, with the meta row (renderer._plan_execution's steps)."""
    mf, mm = jex.pack_mega_modes(jt, fields, modes)
    combo = np.zeros((_bucket(max(mf.shape[0], 1)) + 1, jax_layout.PACKED_WIDTH),
                     np.float32)
    jax_layout.pack_fields_np(mf, mm, out=combo[: mf.shape[0]])
    combo[-1, :4] = clear_color or (0.0, 0.0, 0.0, 0.0)
    return combo, mm


def _flattened(name, monkeypatch):
    """(figdraw_tpu's tape, the port's) of one scene."""
    a, b, w, h = _scenes(name, monkeypatch)
    jt = JaxRenderer(atlas_size=64, use_pallas=True).flatten(a, jax_vec2(w, h))
    pt = port.FigRenderer(device="cpu").flatten(b, port.vec2(w, h))
    return jt, pt


@pytest.mark.parametrize("name", ["clip_table", "subclip_small"])
def test_pack_mega_modes_matches_reference(name, monkeypatch):
    """The mode lanes of pack_mega_combo's rows (targets baked, clear
    sentinels spliced in) are executor.pack_mega_modes'."""
    jt, pt = _flattened(name, monkeypatch)
    _combo, ref_m = _reference_combo(jt, jt.fields[: jt.count], jt.modes[: jt.count],
                                     pt.clear_color)
    got = pack_mega_combo(pt)
    _f, got_m = unpack_combo(torch.from_numpy(got[: ref_m.shape[0]]))
    assert got_m.numpy().tobytes() == ref_m.tobytes()
    assert (ref_m[:, QI_MODE] & mega.MEGA_CLEAR_BIT).any()
    assert not got[ref_m.shape[0] : -1].any()  # padding to the bucket


_CLEAR_ITEMS = [("clear", 1), ("draw", 1, 0, 2), ("clear", 2), ("clear", 2),
                ("draw", 2, 2, 3), ("draw", -1, 3, 6), ("clear", 1), ("clear", 3)]


def _clear_tapes(items, n, clear_color=None):
    """A tape of `items` over n seeded rows, figdraw_tpu's and the port's
    (with the packed combo pack_mega_combo reads), and the rows."""
    rng = np.random.RandomState(3)
    fields = rng.rand(6, QF_WIDTH).astype(np.float32) * 50
    fields[:, QF_BBOX_X0 + 2 : QF_BBOX_X0 + 4] += 60
    fields[:, 16:40] = rng.randint(0, 256, (6, 24)) / np.float32(255.0)
    modes = np.stack([np.full(6, 3), np.array([0, 1, 1, 2, 0, 1])], 1).astype(np.int32)
    fields, modes = fields[:n], modes[:n]
    jt, pt = jax_tape.Tape(capacity=1), port_tape.Tape()
    for t, mod in ((jt, jax_tape), (pt, port_tape)):
        for it in items:
            t.items.append(mod.ClearMaskItem(index=it[1]) if it[0] == "clear"
                           else mod.DrawItem(target=it[1], start=it[2], end=it[3]))
    pt.count = n
    pt.combo = np.zeros((bucket(max(n, 1)) + 1, PACKED_WIDTH), np.float32)
    pack_fields_np(fields, modes, out=pt.combo[:n])
    pt.clear_color = clear_color
    return jt, pt, fields, modes


def test_pack_mega_modes_dead_and_repeated_clears():
    """Clears with no quad after them (a degenerate sentinel bbox) and two
    clears of one plane in a row (an empty segment)."""
    jt, pt, fields, modes = _clear_tapes(_CLEAR_ITEMS, 6)
    want, ref_m = _reference_combo(jt, fields, modes, None)
    got = pack_mega_combo(pt)
    assert got.tobytes() == want.tobytes()
    assert int(((ref_m[:, QI_MODE] & mega.MEGA_CLEAR_BIT) != 0).sum()) == 5


@pytest.mark.parametrize("name", ["clip_table", "clip_table_12", "subclip_small"])
def test_pack_mega_combo_is_the_packed_rows(name, monkeypatch):
    """The plan's mega combo, spliced on the tape's packed rows, is byte for
    byte figdraw_tpu's: executor.pack_mega_modes' rows, packed."""
    jt, pt = _flattened(name, monkeypatch)
    want, _m = _reference_combo(jt, jt.fields[: jt.count], jt.modes[: jt.count],
                                pt.clear_color)
    got = pack_mega_combo(pt)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert plan_execution(pt).mega_combo.tobytes() == want.tobytes()


def test_pack_mega_combo_dead_and_repeated_clears():
    """As test_pack_mega_modes_dead_and_repeated_clears with a clear color;
    and a tape of clears alone."""
    color = (0.25, 0.5, 0.75, 1.0)
    jt, pt, fields, modes = _clear_tapes(_CLEAR_ITEMS, 6, color)
    assert pack_mega_combo(pt).tobytes() == _reference_combo(
        jt, fields, modes, color)[0].tobytes()
    clears = [it for it in _CLEAR_ITEMS if it[0] == "clear"]
    # no quads (figdraw_tpu's packer takes no such tape): five sentinels
    # with degenerate bboxes, their planes in the mode lane
    _jt, pt, _fields, _modes = _clear_tapes(clears, 0, color)
    got = pack_mega_combo(pt)
    assert got.shape == (bucket(5) + 1, PACKED_WIDTH)
    assert tuple(got[-1, :4]) == color
    f, m = unpack_combo(torch.from_numpy(got[:-1]))
    assert not f.any() and not m[5:].any()
    assert m[:5, QI_MODE].tolist() == [
        mega.MEGA_CLEAR_BIT + ((it[1] + 1) << mega.MEGA_TARGET_SHIFT) for it in clears]


# --- K4: the megakernel ----------------------------------------------------------


def _mega_rows(n_masks, seed):
    """The modes tape (every SDF mode) with seeded targets and mask reads,
    some of them out of range, and clear sentinels spliced in, targeting
    planes 0 .. K+1."""
    fields, modes, n_live = modes_tape(256, 128)
    fields, modes = fields[:n_live], modes[:n_live].copy()
    rng = np.random.RandomState(seed)
    tgt = rng.randint(0, n_masks + 2, n_live)
    tgt[rng.rand(n_live) < 0.5] = 0  # half the quads draw into the frame
    modes[:, QI_MODE] += tgt << mega.MEGA_TARGET_SHIFT
    modes[:, 1] = rng.randint(-1, n_masks + 2, n_live)
    pos = np.sort(rng.choice(n_live, 6, replace=False))
    cf = np.zeros((6, QF_WIDTH), np.float32)
    x0 = rng.rand(6) * 200
    y0 = rng.rand(6) * 90
    cf[:, QF_BBOX_X0 : QF_BBOX_X0 + 4] = np.stack(
        [x0, y0, x0 + 20 + rng.rand(6) * 120, y0 + 10 + rng.rand(6) * 60], 1)
    cm = np.zeros((6, 2), np.int32)
    cm[:, QI_MODE] = mega.MEGA_CLEAR_BIT + (
        np.array([0, 1, 2, 3, 1, n_masks + 1]) << mega.MEGA_TARGET_SHIFT)
    fields = np.insert(fields, pos, cf, axis=0)
    modes = np.insert(modes, pos, cm, axis=0)
    n_pad = bucket(fields.shape[0])
    fields = np.concatenate([fields, np.zeros((n_pad - fields.shape[0], QF_WIDTH),
                                              np.float32)])
    modes = np.concatenate([modes, np.zeros((n_pad - modes.shape[0], 2), np.int32)])
    return fields, modes


@pytest.mark.parametrize("n_masks,th", [(1, 64), (3, 128), (3, 32)])
def test_plain_mega_matches_pallas(n_masks, th):
    fields, modes = _mega_rows(n_masks, seed=n_masks + th)
    planes = np.random.RandomState(th).rand(4, 128, 256).astype(np.float32)
    ref = np.asarray(raster_pallas.draw_pass_mega(
        jnp.asarray(fields), jnp.asarray(modes), jnp.asarray(planes), n_masks,
        tile_h=th))
    f, m = torch.from_numpy(fields), torch.from_numpy(modes)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], 128 // th, 2, th, 128)
    got = mega.draw_pass_mega_plain(f, m, tile_idx, tile_counts,
                                    torch.from_numpy(planes), n_masks, tile_h=th)
    assert tuple(got.shape) == (4, 128, 256) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= TOL
    assert np.abs(ref - planes).max() > 0.1  # the walk drew into the frame


def test_cpu_tensors_take_the_plain_mega():
    fields, modes = _mega_rows(3, seed=0)
    f, m = torch.from_numpy(fields), torch.from_numpy(modes)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], 2, 2, 64, 128)
    planes = torch.ones((4, 128, 256))
    want = mega.draw_pass_mega_plain(f, m, tile_idx, tile_counts, planes, 3,
                                     tile_h=64)
    assert torch.equal(planes, torch.ones((4, 128, 256)))  # the plain walk is pure
    before = (mega.LAUNCHES, mega.ATLAS_LAUNCHES)
    out = mega.draw_pass_mega(f, m, tile_idx, tile_counts, planes, 3, tile_h=64)
    assert (mega.LAUNCHES, mega.ATLAS_LAUNCHES) == before
    assert out is planes  # the wrapper works in place, on the CPU too
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    meta = torch.empty((4, 128, 128), device="meta")
    with pytest.raises(ValueError, match="no megakernel"):
        mega.draw_pass_mega(meta, meta, meta, meta, meta, 3)


# --- the sub-clip table through render_frame --------------------------------------


@pytest.fixture(scope="module")
def jax_subclip():
    """figdraw_tpu's sub-clip table frames, clearing and not (the second
    starts from the first)."""
    mp = pytest.MonkeyPatch()
    scene = jax_table("subclip", mp)
    mp.undo()
    jr = JaxRenderer(atlas_size=64, use_pallas=True)
    first = np.asarray(jr.render_frame(scene, jax_vec2(W, H)))
    second = np.asarray(jr.render_frame(scene, jax_vec2(W, H), clear_main=False))
    assert jr.use_pallas, "the JAX renderer fell back from Pallas"
    return scene, jr, first, second


def test_subclip_table_matches_reference(jax_subclip, monkeypatch):
    _scene, _jr, first, second = jax_subclip
    runs = spy_mega_runs(monkeypatch)
    pr = port.FigRenderer(device="cpu")
    ours = make_clip_table_scene("subclip", W, H, ROWS, COLS)
    got = pr.render_frame(ours, port.vec2(W, H))
    # the megakernel, three mask planes, no atlas (an SDF tape: K4)
    assert runs and runs[0][0][2] == 3 and not runs[0][1]
    assert tuple(got.shape) == (H, W, 4)
    assert np.abs(got.numpy() - first).max() <= TOL
    again = pr.render_frame(ours, port.vec2(W, H), clear_main=False)
    assert np.abs(again.numpy() - second).max() <= TOL
    assert got.numpy().std() > 0.01


def test_execute_builds_the_reference_mega_combo(jax_subclip):
    """A tape of more than 24 items through execute(): the port's plan packs
    the same mega combo as figdraw_tpu's and renders the same frame."""
    scene, jr, first, _second = jax_subclip
    jplan = jr._plan_execution(jr.flatten(scene, jax_vec2(W, H)))
    pr = port.FigRenderer(device="cpu")
    tape = pr.flatten(make_clip_table_scene("subclip", W, H, ROWS, COLS),
                      port.vec2(W, H))
    plan = plan_execution(tape)
    assert jplan.mega_combo is not None and plan.mega_combo is not None
    assert plan.mega_combo.tobytes() == jplan.mega_combo.tobytes()
    assert (plan.n_masks, plan.tile_h) == (jplan.n_masks, jplan.tile_h)
    assert np.abs(pr.execute(tape).numpy() - first).max() <= TOL


def test_jax_mega_plan_runs_through_port(jax_subclip):
    scene, jr, first, _second = jax_subclip
    jplan = jr._plan_execution(jr.flatten(scene, jax_vec2(W, H)))
    plan = from_jax_plan(jplan)
    assert plan.mega_combo is not None and len(plan.structure) > 24
    got = port.FigRenderer(device="cpu").execute_plan(plan).numpy()
    assert np.abs(got - first).max() <= TOL


def test_stored_subclip_blocks_match_jax(jax_subclip):
    """chip_smoke.py holds the port's sub-clip table on the card against
    these block means of figdraw_tpu's frame; they must stay its."""
    blocks = jax_subclip[2].reshape(H // 8, 8, W // 8, 8, 4).mean(axis=(1, 3))
    stored = np.load(os.path.join(REPO, "figdraw_tpu_torch", "reference",
                                  "cliptable_subclip_320x200_blocks8.npy"))
    np.testing.assert_allclose(stored, blocks, rtol=0, atol=1e-6)


def test_mega_pooled_buffer_reuse_is_clean():
    """The mega export reuses two pooled upload buffers per renderer: a big
    table, a small one and the big one again on one renderer give the
    frames of a fresh renderer (no stale rows or clear color leak)."""
    big = to_port(clip_table(rows=8))
    small = to_port(clip_table(rows=3))
    ren = port.FigRenderer(device="cpu")
    f_big1 = ren.render_frame(big, port.vec2(256, 200)).numpy()
    ren.render_frame(small, port.vec2(256, 200))
    f_big2 = ren.render_frame(big, port.vec2(256, 200)).numpy()
    np.testing.assert_array_equal(f_big1, f_big2)
    fresh = port.FigRenderer(device="cpu").render_frame(big, port.vec2(256, 200))
    np.testing.assert_array_equal(f_big2, fresh.numpy())
