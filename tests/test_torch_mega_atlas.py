"""The megakernel's atlas form (K4-atlas), its per-block culling and its
in-place contract, on the CPU against figdraw_tpu.

csrc/mega.cu samples the atlas in the one tile walk, drops per 16x16 block
every list entry (quad or clear sentinel) whose bbox widened by CULL_MARGIN
misses the block, and updates the frame in place. `draw_pass_mega_plain`
states all of it in plain torch (`atlas=`, `cull=True`). Here:

- the plain walk with the atlas against the Pallas megakernel with its
  in-kernel sampler in interpret mode (FIGDRAW_ATLAS11=always), on
  tests/test_mega.py's text-in-clip scene and its image scene, with K == 1
  and out-of-range planes too;
- the port's mega+atlas frames against figdraw_tpu's default (rolled)
  frames: the text-in-clip scene and the images_clipped cards at 480x270;
- the culled walk bit-identical to the full walk on the sub-clip table, the
  text-in-clip scene and images_clipped at tile_h 128 / 64 / 32, with the
  premises checked on a replay of the walk: fa = alpha x mask is exactly 0
  outside every widened bbox, and wherever a clear is dropped every entry
  that reads or writes its plane is dropped too;
- the wrapper writes the frame planes and nothing else; a frame never
  writes the caller's init_frame or last_frame;
- the stored text table (`reference/textclip_1200x800.npz`) is the JAX
  package's, and the port plans and renders it.

Pixels within 1/255; culled against full walks exactly.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
from figdraw_tpu import FigRenderer as JaxRenderer, vec2 as jax_vec2
from figdraw_tpu.ops import raster_pallas
from figdraw_tpu_torch import native
from figdraw_tpu_torch.basics import FigKind
from figdraw_tpu_torch.executor import get_mega_executor, unpack_combo
from figdraw_tpu_torch.nodesarray import RenderListArray, RendersArray
from figdraw_tpu_torch.ops import mega, raster
from figdraw_tpu_torch.ops.binning import bin_quads
from figdraw_tpu_torch.ops.layout import QF_BBOX_X0, QI_MASK, QI_MODE
from figdraw_tpu_torch.ops.quad_eval_planar import eval_quad_planar
from figdraw_tpu_torch.plan import (
    ROLLED_THRESHOLD, atlas_from_jax, from_jax_plan, plan_execution, plan_rolled,
)
from figdraw_tpu_torch.resources import ImageMessageBus, put_image
from figdraw_tpu_torch.scenes import (
    IMAGE_ID, TEXT_TABLE_REFERENCE, load_text_tape, make_clip_table_scene,
    make_image_panels_scene, mega_modes_tape, photo_image,
)
from torch_reference import (
    DEJAVU, IMAGE_H, IMAGE_N, IMAGE_W, block_means, jax_image_frame,
    jax_text_cells_scene, spy_mega_runs, text_table_fixture,
)

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

TOL = 1.0 / 255.0
M = raster.CULL_MARGIN
CELLS_W, CELLS_H = 360, 280  # test_mega.py's text-in-clip scene


def _need_font():
    if not os.path.exists(DEJAVU):
        pytest.skip(f"needs the DejaVu font at {DEJAVU}")


@pytest.fixture(scope="module")
def text_cells():
    """test_mega.py:159's scene through figdraw_tpu twice: the default path
    (the rolled executor) for its frame, and FIGDRAW_ATLAS11=always with
    Pallas for its mega+atlas plan, its atlas and that route's frame."""
    _need_font()
    scene = jax_text_cells_scene()
    size = jax_vec2(CELLS_W, CELLS_H)
    default = np.asarray(JaxRenderer(atlas_size=256, use_pallas=False)
                         .render_frame(scene, size))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FIGDRAW_ATLAS11", "always")
        jr = JaxRenderer(atlas_size=256, use_pallas=True)
        frame = np.asarray(jr.render_frame(scene, size))
        assert jr.use_pallas, "the JAX renderer fell back from Pallas"
        jplan = jr._plan_execution(jr.flatten(scene, size))
    assert jplan.mega_combo is not None and jplan.mega_atlas
    return jplan, np.array(jr.atlas.data), frame, default


@pytest.fixture(scope="module")
def image_rows():
    """test_mega.py:93's image scene (a line of text and a 1:1 image on a
    background) under FIGDRAW_ATLAS11=always: its frame run's rows with the
    1:1 marks, and the atlas."""
    _need_font()
    from figdraw_tpu import Fig, FigKind, fill, image_style, new_renders, rect, rgba
    from figdraw_tpu.resources import ImageMessageBus as JaxBus, put_image as jax_put
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    bus = JaxBus()
    img = (np.random.RandomState(0).rand(32, 32, 4) * 255).astype(np.uint8)
    img[..., 3] = 255
    jax_put(7501, img, bus=bus)
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 256, 128),
                            fill=fill(rgba(250, 250, 250, 255))))
    f = FigFont(typeface_id=load_typeface(DEJAVU), size=17.0)
    arr = typeset(jax_vec2(240, 40),
                  [(f, fill(rgba(20, 30, 160, 255)), "Atlas in Pallas AV fi")])
    renders.add_root(0, Fig(kind=FigKind.nkText, screen_box=rect(8, 8, 240, 40),
                            text_layout=arr))
    renders.add_root(0, Fig(kind=FigKind.nkImage, screen_box=rect(20, 60, 32, 32),
                            image=image_style(7501)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FIGDRAW_ATLAS11", "always")
        jr = JaxRenderer(atlas_size=256, use_pallas=True)
        jr.ensure_image_message_subscription(bus)
        jr.render_frame(renders, jax_vec2(256, 128))
        tape = jr.flatten(renders, jax_vec2(256, 128))
        jplan = jr._plan_execution(tape)
    assert jplan.atlas11_runs and jplan.mega_combo is None
    rows = np.asarray(jplan.combo, np.float32)[: tape.count]
    return rows, np.array(jr.atlas.data)


def _pallas_mega(fields, modes, planes, n_masks, th, atlas):
    """figdraw_tpu's megakernel with its in-kernel sampler, interpreted."""
    atlas_planes, real = raster_pallas.atlas_to_planes(jnp.asarray(atlas))
    return np.asarray(raster_pallas.draw_pass_mega(
        jnp.asarray(fields.numpy()), jnp.asarray(modes.numpy()),
        jnp.asarray(planes.numpy()), n_masks, tile_h=th,
        atlas_planes=atlas_planes, atlas_size=real))


def _pallas_mega_sdf(fields, modes, planes, n_masks, th):
    """figdraw_tpu's megakernel without an atlas, interpreted."""
    return np.asarray(raster_pallas.draw_pass_mega(
        jnp.asarray(fields.numpy()), jnp.asarray(modes.numpy()),
        jnp.asarray(planes.numpy()), n_masks, tile_h=th))


def _bbox_only_culled_walk(fields, modes, tile_idx, tile_counts, planes, n_masks,
                           th, atlas):
    """draw_pass_mega_plain(cull=True) with a copy of the cull rule that
    lacks the exception for plane-0 targets."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mega, "entry_survivors",
                   lambda bbox, raw, x0, y0, tile_h:
                   raster.block_survivors(bbox, x0, y0, tile_h))
        return mega.draw_pass_mega_plain(fields, modes, tile_idx, tile_counts,
                                         planes, n_masks, tile_h=th, atlas=atlas,
                                         cull=True)


def _plain_mega(fields, modes, planes, n_masks, th, atlas, **kw):
    _, ph, pw = planes.shape
    tile_idx, tile_counts = bin_quads(fields, 0, fields.shape[0], ph // th,
                                      pw // 128, th, 128)
    return mega.draw_pass_mega_plain(fields, modes, tile_idx, tile_counts, planes,
                                     n_masks, tile_h=th, atlas=atlas, **kw)


def _planes(h, w, th, seed):
    ph, pw = -(-h // th) * th, -(-w // 128) * 128
    return torch.from_numpy(np.random.RandomState(seed).rand(4, ph, pw)
                            .astype(np.float32))


# --- (a) the plain walk with the atlas against the Pallas megakernel ----------------


@pytest.mark.parametrize("th", [128, 64])
def test_plain_mega_atlas_matches_pallas_on_text_in_clip(text_cells, th):
    jplan, atlas, _frame, _default = text_cells
    plan = from_jax_plan(jplan)
    assert plan.mega_atlas and plan.mega_combo is not None
    assert len(plan.structure) > ROLLED_THRESHOLD and plan.rolled_items is None
    fields, modes = unpack_combo(torch.from_numpy(plan.mega_combo[:-1]))
    # glyph quads carry the TPU kernel's 1:1 mark; the port's evaluator
    # ignores it
    assert ((modes[:, QI_MODE] >> 13) & 1).any()
    planes = _planes(CELLS_H, CELLS_W, th, th)
    ref = _pallas_mega(fields, modes, planes, plan.n_masks, th, atlas)
    got = _plain_mega(fields, modes, planes, plan.n_masks, th, atlas_from_jax(atlas))
    assert np.abs(got.numpy() - ref).max() <= TOL
    # the atlas matters: without it the glyph quads are solid boxes
    boxes = _plain_mega(fields, modes, planes, plan.n_masks, th, None)
    assert np.abs(boxes.numpy() - ref).max() > 0.1


def test_plain_mega_atlas_matches_pallas_on_image_scene(image_rows):
    rows, atlas = image_rows
    fields, modes = unpack_combo(torch.from_numpy(rows.copy()))
    base = modes[:, QI_MODE] % 128
    marked = ((modes[:, QI_MODE] >> 13) & 1) == 1
    assert bool((base == 0).any()) and bool(marked[base == 0].all())
    planes = _planes(128, 256, 128, 5)
    ref = _pallas_mega(fields, modes, planes, 1, 128, atlas)
    got = _plain_mega(fields, modes, planes, 1, 128, atlas_from_jax(atlas))
    assert np.abs(got.numpy() - ref).max() <= TOL
    assert np.abs(ref - planes.numpy()).max() > 0.1


# --- (d) the clamps, with an atlas -----------------------------------------------------


@pytest.mark.parametrize("n_masks", [1, 2, 4])
def test_plain_mega_atlas_clamps_like_pallas(text_cells, n_masks):
    """The text-in-clip tape with seeded out-of-range mask reads, targets and
    clears, walked with K planes: K == 1 drops every write and clear and
    reads plane 0; reads clamp to [0, K-1], writes to [1, K-1]."""
    jplan, atlas, _frame, _default = text_cells
    plan = from_jax_plan(jplan)
    fields, modes = unpack_combo(torch.from_numpy(plan.mega_combo[:-1]))
    rng = np.random.RandomState(n_masks)
    m = modes.numpy().copy()
    live = np.nonzero(m[:, QI_MODE] != 0)[0]
    pick = live[rng.rand(live.size) < 0.2]
    m[pick, QI_MASK] = rng.randint(-1, n_masks + 2, pick.size)
    pick = live[rng.rand(live.size) < 0.1]
    m[pick, QI_MODE] = (m[pick, QI_MODE] & 0xFFFF) + (
        rng.randint(0, n_masks + 3, pick.size) << mega.MEGA_TARGET_SHIFT)
    modes = torch.from_numpy(m)
    planes = _planes(CELLS_H, CELLS_W, 64, n_masks)
    ref = _pallas_mega(fields, modes, planes, n_masks, 64, atlas)
    got = _plain_mega(fields, modes, planes, n_masks, 64, atlas_from_jax(atlas))
    assert np.abs(got.numpy() - ref).max() <= TOL
    assert np.abs(ref - planes.numpy()).max() > 0.1


# --- (b) the port's mega+atlas frames against figdraw_tpu's default frames ----------------


def test_text_in_clip_mega_atlas_frame_matches_default_route(text_cells, monkeypatch):
    jplan, atlas, frame, default = text_cells
    runs = spy_mega_runs(monkeypatch)
    before = (mega.LAUNCHES, mega.ATLAS_LAUNCHES, raster.ATLAS_LAUNCHES)
    got = port.FigRenderer(device="cpu").execute_plan(
        from_jax_plan(jplan), atlas=atlas_from_jax(atlas)).numpy()
    assert (mega.LAUNCHES, mega.ATLAS_LAUNCHES, raster.ATLAS_LAUNCHES) == before
    assert len(runs) == 1 and runs[0][1]  # the megakernel, with the atlas
    assert got.shape == (CELLS_H, CELLS_W, 4)
    assert np.abs(got - default).max() <= TOL  # figdraw_tpu's rolled route
    assert np.abs(got - frame).max() <= TOL  # figdraw_tpu's own mega+atlas
    assert got.std() > 0.01


def _port_image_renderer():
    ren = port.FigRenderer(atlas_size=256, device="cpu")
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    put_image(IMAGE_ID, photo_image(), bus=bus, mipmapped=True)
    return ren


def test_images_clipped_take_the_mega_atlas_route(monkeypatch):
    """render_frame on the clipped photo cards: the walk hands back a tape
    (it holds atlas quads), the plan is a mega plan with the atlas, and the
    frame is figdraw_tpu's default (rolled) frame."""
    _scene, _jr, ref = jax_image_frame("images_clipped", monkeypatch)
    runs = spy_mega_runs(monkeypatch)
    pr = _port_image_renderer()
    ours = make_image_panels_scene(IMAGE_W, IMAGE_H, IMAGE_N, "images_clipped")
    size = port.vec2(IMAGE_W, IMAGE_H)
    pr.process_image_messages()
    assert native.flatten_fast(ours, IMAGE_W, IMAGE_H, 1.0, 1.0, pr.aa_factor,
                               (1, 1, 1, 1), atlas=pr._walk_atlas())[0] == "tape"
    got = pr.render_frame(ours, size)
    assert len(runs) == 1 and runs[0][1] and runs[0][0][2] == 2
    assert np.abs(got.numpy() - ref).max() <= TOL
    # pixelate rides along to the walk
    px = _port_image_renderer()
    px.pixelate = True
    sharp = px.render_frame(ours, size)
    assert np.abs(sharp.numpy() - got.numpy()).max() > 0.01


# --- (c) the culled walk --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tape(name):
    """(fields, modes, atlas or None, n_masks, height, width) of a mega tape."""
    if name == "subclip":
        w, h = 320, 200
        _, combo, mask_count, _density = native.flatten_fast(
            make_clip_table_scene("subclip", w, h, 12, 6), w, h, 1.0, 1.0, 1.2,
            (1.0, 1.0, 1.0, 1.0))
        fields, modes = unpack_combo(torch.from_numpy(combo[:-1].copy()))
        return fields, modes, None, mask_count + 1, h, w
    if name == "images_clipped":
        ren = _port_image_renderer()
        ren.process_image_messages()
        plan = plan_execution(ren.flatten(
            make_image_panels_scene(IMAGE_W, IMAGE_H, IMAGE_N, name),
            port.vec2(IMAGE_W, IMAGE_H)))
        fields, modes = unpack_combo(torch.from_numpy(plan.mega_combo[:-1].copy()))
        return fields, modes, ren._device_atlas().clone(), plan.n_masks, IMAGE_H, IMAGE_W
    raise KeyError(name)


def _replay(fields, modes, tile_idx, tile_counts, planes, n_masks, th, atlas):
    """The full mega walk once more, step by step, asserting the cull's two
    premises on the way: (1) at every pixel center outside a quad's widened
    bbox in its binned tiles, fa = alpha x mask is exactly 0; (2) in every
    block where a clear sentinel is dropped, every later entry that reads
    or writes its plane, up to the plane's next kept clear there, is dropped
    too, so the stale plane is never observed. Returns (planes, quad-pixels
    checked, of those with alpha != 0, blocks where a clear was dropped)."""
    tw = 128
    _, ph, pw = planes.shape
    ty, tx = ph // th, pw // tw
    kmax = n_masks - 1
    carry = raster.to_tiles(planes, ty, th, tx, tw).clone()
    masks = torch.zeros((carry.shape[0], n_masks, th, tw))
    masks[:, 0] = 1.0
    stale = torch.zeros((carry.shape[0], n_masks, th // 16, tw // 16), dtype=torch.bool)
    py_t, px_t = raster.pixel_centers(ty, th, tx, tw, planes.device)
    x0_t, y0_t = raster.tile_origins(ty, th, tx, tw, planes.device)
    counts = tile_counts.long()
    checked = clamped = dropped = 0
    for k in range(int(counts.max())):
        act = torch.nonzero(counts > k).squeeze(1)
        qi = tile_idx[act, k].long()
        raw = modes[qi, QI_MODE]
        tgt = (raw >> mega.MEGA_TARGET_SHIFT) & 0xFFFF
        clear = (raw & mega.MEGA_CLEAR_BIT) != 0
        surv = mega.entry_survivors(fields[qi][:, QF_BBOX_X0 : QF_BBOX_X0 + 4],
                                    raw, x0_t[act], y0_t[act], th)
        if kmax > 0:
            ct, cp = act[clear], (tgt[clear] - 1).clamp(1, kmax)
            masks[ct, cp] = 0.0
            stale[ct, cp] = ~surv[clear]
            dropped += int((~surv[clear]).sum())
        draw = ~clear
        dt, qd, tg, sd = act[draw], qi[draw], tgt[draw], surv[draw]
        if dt.numel() == 0:
            continue
        f = fields[qd]
        fr, fg, fb, alpha = eval_quad_planar(
            lambda c, f=f: f[:, c, None, None],
            (raw[draw] & mega.MEGA_EVAL_MASK)[:, None, None], px_t[dt], py_t[dt],
            atlas=atlas)
        read = modes[qd, QI_MASK].long().clamp(0, kmax)
        fa = alpha * masks[dt, read]
        bb = f[:, QF_BBOX_X0 : QF_BBOX_X0 + 4, None, None]
        inside = ((px_t[dt] >= bb[:, 0] - M) & (px_t[dt] <= bb[:, 2] + M)
                  & (py_t[dt] >= bb[:, 1] - M) & (py_t[dt] <= bb[:, 3] + M))
        outside = ~inside.expand_as(fa)
        assert bool((fa[outside] == 0).all())
        checked += int(outside.sum())
        clamped += int((alpha.expand_as(fa)[outside] != 0).sum())
        assert not bool((sd & stale[dt, read]).any())
        inv = 1.0 - fa
        frame = tg == 0
        ft = dt[frame]
        dst = carry[ft]
        carry[ft] = torch.stack(
            (fr[frame] * fa[frame] + dst[:, 0] * inv[frame],
             fg[frame] * fa[frame] + dst[:, 1] * inv[frame],
             fb[frame] * fa[frame] + dst[:, 2] * inv[frame],
             fa[frame] + dst[:, 3] * inv[frame]), dim=1)
        if kmax > 0:
            mt, tk, fm, im = dt[~frame], tg[~frame] - 1, fa[~frame], inv[~frame]
            src, dstp = tk.clamp(0, kmax), tk.clamp(1, kmax)
            assert not bool((sd[~frame] & (stale[mt, src] | stale[mt, dstp])).any())
            masks[mt, dstp] = fm * fm + masks[mt, src] * im
    return raster.from_tiles(carry, ty, th, tx, tw), checked, clamped, dropped


def _check_culled_walk(fields, modes, atlas, n_masks, h, w, th):
    planes = _planes(h, w, th, th)
    _, ph, pw = planes.shape
    tile_idx, tile_counts = bin_quads(fields, 0, fields.shape[0], ph // th,
                                      pw // 128, th, 128)
    args = (fields, modes, tile_idx, tile_counts, planes, n_masks)
    full = mega.draw_pass_mega_plain(*args, tile_h=th, atlas=atlas)
    culled = mega.draw_pass_mega_plain(*args, tile_h=th, atlas=atlas, cull=True)
    assert torch.equal(full, culled)
    replayed, checked, clamped, dropped = _replay(
        fields, modes, tile_idx, tile_counts, planes, n_masks, th, atlas)
    assert torch.equal(full, replayed)
    before, after, blocks = mega.block_entries(fields, modes, tile_idx,
                                               tile_counts, th, ph, pw)
    # not vacuous: the cull drops entries, clears among them, and the
    # premise saw pixels outside the bboxes
    assert 0 < after < before and 0 < blocks <= (ph // 16) * (pw // 16)
    assert checked > 0 and dropped > 0
    assert float((full - planes).abs().max()) > 0.1
    return clamped


@pytest.mark.parametrize("th", [128, 64, 32])
@pytest.mark.parametrize("name", ["subclip", "images_clipped"])
def test_culled_mega_walk_is_bit_identical(name, th):
    clamped = _check_culled_walk(*_tape(name), th)
    # quads clamped to their clip's support have alpha outside their bbox,
    # where their plane is 0: the card's image, the table's spilling bars
    assert clamped > 0


@pytest.mark.parametrize("th", [128, 64, 32])
def test_culled_mega_walk_is_bit_identical_on_text_in_clip(text_cells, th):
    jplan, atlas, _frame, _default = text_cells
    plan = from_jax_plan(jplan)
    fields, modes = unpack_combo(torch.from_numpy(plan.mega_combo[:-1]))
    assert _check_culled_walk(fields, modes, atlas_from_jax(atlas), plan.n_masks,
                              CELLS_H, CELLS_W, th) > 0


@pytest.mark.parametrize("atlas_size", [None, 64])
@pytest.mark.parametrize("n_masks,th", [(1, 64), (2, 128), (3, 32), (4, 64)])
def test_culled_mega_walk_is_exact_under_the_clamps(n_masks, th, atlas_size):
    """A seeded tape with out-of-range reads, targets and clears, and with
    quads that target plane 0: the culled walk stays the full walk's, which
    on SDF tapes is the Pallas megakernel's (its in-kernel sampler takes
    only 1:1 quads, so the atlas tape has no Pallas frame)."""
    w, h = 256, 128
    fields, modes, atlas = mega_modes_tape(n_masks, 7 * n_masks + th, w, h, atlas_size)
    plane0 = modes[:, QI_MODE] >> mega.MEGA_TARGET_SHIFT == 1
    assert plane0.any() and (modes[plane0, QI_MODE] & mega.MEGA_CLEAR_BIT == 0).any()
    planes = _planes(h, w, th, th)
    f, m = torch.from_numpy(fields), torch.from_numpy(modes)
    atlas_t = None if atlas is None else torch.from_numpy(atlas)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], h // th, w // 128, th, 128)
    args = (f, m, tile_idx, tile_counts, planes, n_masks)
    full = mega.draw_pass_mega_plain(*args, tile_h=th, atlas=atlas_t)
    culled = mega.draw_pass_mega_plain(*args, tile_h=th, atlas=atlas_t, cull=True)
    assert torch.equal(full, culled)
    before, after, _blocks = mega.block_entries(f, m, tile_idx, tile_counts, th, h, w)
    assert 0 < after < before
    assert float((full - planes).abs().max()) > 0.1
    if atlas is None:
        ref = _pallas_mega_sdf(f, m, planes, n_masks, th)
        assert np.abs(culled.numpy() - ref).max() <= TOL


def test_a_plane0_target_is_never_culled():
    """Two squares 62 px apart in one tile. The first targets plane 0: the
    write clamp sends it to plane 1 with plane 0 as its source, so plane 1
    becomes 1 outside the square's bbox too. The second draws into the frame
    through plane 1, and shows only because of that. The cull keeps the
    first in every block; a copy of the rule without that exception loses
    the second square."""
    lst = RenderListArray()
    for x, color in ((8, (200, 40, 40, 255)), (70, (40, 40, 200, 255))):
        p = lst.add_root_raw()
        lst.nodes["kind"][p] = int(FigKind.nkRectangle)
        lst.nodes["box"][p] = (x, 8, 40, 40)
        lst.nodes["fill"]["c0"][p] = color
    scene = RendersArray()
    scene.set_layer(0, lst)
    w, h, th, n_masks = 128, 64, 64, 2
    tape = port.FigRenderer(device="cpu").flatten(scene, port.vec2(w, h))
    fields, modes = tape.fields, tape.modes
    assert tape.count == 2
    modes = modes.copy()
    modes[0, QI_MODE] += 1 << mega.MEGA_TARGET_SHIFT
    modes[1, QI_MASK] = 1
    f, m = torch.from_numpy(fields.copy()), torch.from_numpy(modes)
    planes = torch.zeros((4, h, w))
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], 1, 1, th, 128)
    args = (f, m, tile_idx, tile_counts, planes, n_masks)
    full = mega.draw_pass_mega_plain(*args, tile_h=th)
    culled = mega.draw_pass_mega_plain(*args, tile_h=th, cull=True)
    assert torch.equal(full, culled)
    assert float(full[3, 28, 90]) == 1.0 and float(full[3, 28, 28]) == 0.0
    assert np.abs(full.numpy() - _pallas_mega_sdf(f, m, planes, n_masks, th)).max() <= TOL
    before, after, blocks = mega.block_entries(f, m, tile_idx, tile_counts, th, h, w)
    assert after > before // 2 and blocks == (th // 16) * 8  # the first, everywhere
    bbox_only = _bbox_only_culled_walk(*args, th, None)
    assert float(bbox_only[3, 28, 90]) == 0.0


def test_block_entries_counts_the_lists():
    fields, modes, _atlas, _k, h, w = _tape("subclip")
    th = 64
    ph, pw = -(-h // th) * th, -(-w // 128) * 128
    tile_idx, tile_counts = bin_quads(fields, 0, fields.shape[0], ph // th,
                                      pw // 128, th, 128)
    before, after, blocks = mega.block_entries(fields, modes, tile_idx,
                                               tile_counts, th, ph, pw)
    assert before == int(tile_counts.sum()) * (th // 16) * 8
    n_clears = int(((modes[:, QI_MODE] & mega.MEGA_CLEAR_BIT) != 0).sum())
    # the viewport's clear and one per cell of the rows in view
    assert n_clears > 1 and (n_clears - 1) % 6 == 0
    assert 0 < after < before and blocks > 0


# --- (e) the in-place contract ---------------------------------------------------------------


def test_mega_wrapper_writes_only_the_frame_planes():
    fields, modes, atlas, n_masks, h, w = _tape("images_clipped")
    th = 64
    planes = _planes(h, w, th, 9)
    _, ph, pw = planes.shape
    tile_idx, tile_counts = bin_quads(fields, 0, fields.shape[0], ph // th,
                                      pw // 128, th, 128)
    others = (fields, modes, tile_idx, tile_counts, atlas)
    keep = [t.clone() for t in others]
    want = mega.draw_pass_mega_plain(fields, modes, tile_idx, tile_counts,
                                     planes.clone(), n_masks, tile_h=th, atlas=atlas)
    out = mega.draw_pass_mega(fields, modes, tile_idx, tile_counts, planes,
                              n_masks, tile_h=th, atlas=atlas)
    assert out is planes and torch.equal(planes, want)
    for a, b in zip(others, keep):
        assert torch.equal(a, b)


def test_mega_frame_leaves_init_frame_unchanged():
    """A mega frame that does not clear starts from the renderer's last
    frame, or the init_frame given to the executor, and never writes it."""
    w, h = 256, 128  # whole tiles: no padding copies the frame
    scene = make_clip_table_scene("subclip", w, h, 8, 4)
    ren = port.FigRenderer(device="cpu")
    assert native.flatten_fast(scene, w, h, 1.0, 1.0, 1.2, None)[0] == "mega"
    first = ren.render_frame(scene, port.vec2(w, h))
    kept = first.clone()
    second = ren.render_frame(scene, port.vec2(w, h), clear_main=False)
    assert torch.equal(first, kept) and ren.last_frame is second
    _, combo, mask_count, _density = native.flatten_fast(scene, w, h, 1.0, 1.0,
                                                         1.2, None)
    run = get_mega_executor(h, w, mask_count + 1, True, 64)
    init = torch.from_numpy(np.random.RandomState(1).rand(h, w, 4).astype(np.float32))
    before = init.clone()
    frame = run(torch.from_numpy(combo.copy()), init)
    assert torch.equal(init, before) and not torch.equal(frame, before)


# --- (f) the stored text table ----------------------------------------------------------------


@pytest.fixture(scope="module")
def text_table():
    _need_font()
    return text_table_fixture()


def test_stored_text_table_is_fresh(text_table):
    """chip_smoke.py runs `textclip_1200x800.npz` on the card, where the JAX
    package and fontTools are absent; it must stay figdraw_tpu's tape, atlas
    and frame (tests/torch_reference.py rewrites it)."""
    arrays, _frame = text_table
    with np.load(TEXT_TABLE_REFERENCE) as z:
        assert sorted(z.files) == sorted(arrays)
        for key, want in arrays.items():
            if key in ("blocks", "atlas"):
                np.testing.assert_allclose(z[key], want, rtol=0, atol=1e-6)
            elif key == "structure":
                assert json.loads(str(z[key])) == json.loads(str(want))
            else:
                assert z[key].tobytes() == np.asarray(want).tobytes(), key
    assert os.path.getsize(TEXT_TABLE_REFERENCE) < 1_000_000


def test_stored_text_table_plans_onto_the_mega_atlas_route(text_table):
    arrays, _frame = text_table
    tape, atlas, blocks = load_text_tape()
    plan = plan_execution(tape)
    assert (plan.height, plan.width) == (800, 1200) and plan.n_masks == 3
    assert plan.tile_h == int(arrays["tile_h"])  # figdraw_tpu's own choice
    assert plan.mega_combo is not None and plan.mega_atlas
    n_clears = sum(1 for item in plan.structure if item[0] == "clear_mask")
    assert len(plan.structure) > ROLLED_THRESHOLD and n_clears > 100
    fields, modes = unpack_combo(torch.from_numpy(plan.mega_combo[:-1]))
    assert int(((modes[:, QI_MODE] & mega.MEGA_CLEAR_BIT) != 0).sum()) == n_clears
    rolled = plan_rolled(tape)
    assert rolled.rolled_items.shape == (len(plan.structure), 4)
    # the frame, against figdraw_tpu's default (rolled) frame as stored
    got = port.FigRenderer(device="cpu").execute_plan(plan, atlas=atlas_from_jax(atlas))
    assert np.abs(block_means(got.numpy()) - blocks).max() <= TOL
    assert np.abs(got.numpy() - text_table[1]).max() <= TOL
