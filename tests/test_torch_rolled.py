"""The rolled executor of figdraw_tpu_torch against figdraw_tpu on the CPU:
tapes of more than 24 pass items. The port's own plans take it for a blur
or a backdrop (atlas runs go to the megakernel: tests/
test_torch_mega_atlas.py); a figdraw_tpu rolled plan keeps its route
through from_jax_plan, and plan.plan_rolled puts any tape on it.
test_mega.py's text-in-clip scene through figdraw_tpu's own plan and atlas,
the images_clipped cards at 480x270 with 25 panels through render_frame
(the megakernel) and through the rolled form, a blurred clip table, and
the item table against renderer._build_rolled_items, and the blurred
cards (scenes.make_blurred_cards_scene: the clipped cards under a backdrop
blur, a frosted panel and a second band of cards above it), which the
port's own planner sends to the rolled form through render_frame, against
figdraw_tpu's unrolled frame executor on its plan (its rolled executor
drops an atlas run's backdrop) and the stored block means chip_smoke.py
holds the card to. Pixels within 1/255; tables and rows exactly."""

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
from figdraw_tpu import vec2 as jax_vec2
from figdraw_tpu.renderer import _build_rolled_items
from figdraw_tpu_torch.basics import FigFlags, FigKind
from figdraw_tpu_torch.nodesarray import RenderListArray, RendersArray
from figdraw_tpu_torch.ops import raster
from figdraw_tpu_torch.plan import (
    ROLLED_THRESHOLD, atlas_from_jax, from_jax_plan, plan_execution, plan_rolled,
)
from figdraw_tpu_torch.resources import ImageMessageBus, put_image
from figdraw_tpu_torch.scenes import (
    BLURRED_REFERENCE, BLURRED_SMALL, IMAGE_ID, image_reference_path,
    make_blurred_cards_scene, make_image_panels_scene, photo_image,
)
from torch_reference import (
    DEJAVU, IMAGE_H, IMAGE_N, IMAGE_W, block_means, ensure_jax_native, fresh_combo_pools,
    jax_blurred_cards_scene, jax_clipped_scene, jax_image_frame, jax_image_renderer,
    jax_text_cells_scene, jax_unrolled_frame, port_image_renderer,
)

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


def _same_table(jax_plan, plan):
    """The port's item table is the JAX table's rows without its padding,
    which is ITEM_NOOP (0) rows up to a compile-cost bucket."""
    items, radii, _bucket = _build_rolled_items(jax_plan.structure,
                                                jax_plan.bounds, jax_plan.radii)
    n = len(plan.structure)
    np.testing.assert_array_equal(plan.rolled_items, items[:n])
    np.testing.assert_array_equal(plan.rolled_radii, radii[:n])
    assert not items[n:].any() and not radii[n:].any()


# --- test_mega.py's text in clipped cells --------------------------------------------


@pytest.fixture(scope="module")
def text_in_clip():
    """test_mega.py:159's scene (8x3 clipped cells of text at 360x280,
    DejaVuSans at 13 px) through figdraw_tpu's default path: its rolled
    plan, atlas and frame."""
    import os

    if not os.path.exists(DEJAVU):
        pytest.skip(f"needs the DejaVu font at {DEJAVU}")
    from figdraw_tpu import FigRenderer as JaxRenderer

    scene = jax_text_cells_scene()
    jr = JaxRenderer(atlas_size=256, use_pallas=False)
    frame = np.asarray(jr.render_frame(scene, jax_vec2(360, 280)))
    jplan = jr._plan_execution(jr.flatten(scene, jax_vec2(360, 280)))
    return jplan, np.array(jr.atlas.data), frame


def test_text_in_clip_runs_through_port_rolled_executor(text_in_clip):
    jplan, atlas, ref = text_in_clip
    assert jplan.rolled and jplan.mega_combo is None
    plan = from_jax_plan(jplan)
    assert len(plan.structure) > ROLLED_THRESHOLD and plan.rolled_items is not None
    _same_table(jplan, plan)
    before = (raster.LAUNCHES, raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES)
    got = port.FigRenderer(device="cpu").execute_plan(plan, atlas=atlas_from_jax(atlas))
    assert (raster.LAUNCHES, raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES) == before
    assert tuple(got.shape) == (280, 360, 4)
    assert np.abs(got.numpy() - ref).max() <= TOL
    assert got.numpy().std() > 0.01


# --- images_clipped through render_frame ------------------------------------------------


def _port_image_renderer():
    ren = port.FigRenderer(atlas_size=256, device="cpu")
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    put_image(IMAGE_ID, photo_image(), bus=bus, mipmapped=True)
    return ren


@pytest.fixture(scope="module")
def jax_clipped():
    mp = pytest.MonkeyPatch()
    try:
        return jax_image_frame("images_clipped", mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("size", [(IMAGE_W, IMAGE_H, IMAGE_N), (1920, 1080, 400)])
def test_clipped_scene_bytes_match_reference(size):
    w, h, n = size
    a = jax_clipped_scene(n, float(w), float(h)).layers[0]
    b = make_image_panels_scene(w, h, n, "images_clipped").layers[0]
    assert a.count == b.count and a.root_ids == b.root_ids
    assert a.nodes[: a.count].tobytes() == b.nodes[: b.count].tobytes()


def test_images_clipped_matches_reference(jax_clipped):
    scene, jr, ref = jax_clipped
    pr = _port_image_renderer()
    ours = make_image_panels_scene(IMAGE_W, IMAGE_H, IMAGE_N, "images_clipped")
    size = port.vec2(IMAGE_W, IMAGE_H)
    got = pr.render_frame(ours, size)
    assert tuple(got.shape) == (IMAGE_H, IMAGE_W, 4)
    assert np.abs(got.numpy() - ref).max() <= TOL
    # the same tape: per card a mask clear, the card into the mask plane,
    # and the card with its clipped image into the frame. The port sends it
    # to the megakernel with the atlas
    fresh_combo_pools()
    pt = pr.flatten(ours, size)
    jt = jr.flatten(scene, jax_vec2(IMAGE_W, IMAGE_H))
    assert pt.combo.tobytes() == jt.combo.tobytes()
    plan = plan_execution(pt)
    assert plan.mega_combo is not None and plan.mega_atlas
    assert plan.rolled_items is None
    assert plan.structure[:4] == (("draw", -1, False, False), ("clear_mask", 1),
                                  ("draw", 1, False, False), ("draw", -1, True, False))
    assert len(plan.structure) == 1 + 3 * IMAGE_N
    # the rolled form of the frame executor on the same tape: figdraw_tpu's
    # item table, and the same frame a pass per item
    rolled = plan_rolled(pt)
    assert rolled.mega_combo is None and not rolled.mega_atlas
    _same_table(jr._plan_execution(jt), rolled)
    before = (raster.LAUNCHES, raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES)
    by_item = pr.execute_plan(rolled)
    assert (raster.LAUNCHES, raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES) == before
    assert np.abs(by_item.numpy() - ref).max() <= TOL
    assert np.abs(by_item.numpy() - got.numpy()).max() <= 1e-5
    # frames that do not clear start from the last frame
    again = pr.render_frame(ours, size, clear_main=False)
    from figdraw_tpu import vec2

    ref2 = np.asarray(jr.render_frame(scene, vec2(IMAGE_W, IMAGE_H), clear_main=False))
    assert np.abs(again.numpy() - ref2).max() <= TOL


def test_stored_clipped_blocks_match_jax(jax_clipped):
    """chip_smoke.py's rolled phase holds the port's 480x270 frame against
    these block means of figdraw_tpu's frame; they must stay its."""
    stored = np.load(image_reference_path("images_clipped"))
    np.testing.assert_allclose(stored, block_means(jax_clipped[2]), rtol=0, atol=1e-6)


# --- a blur and a backdrop past the threshold --------------------------------------------


def _blurred_cells(n_cells: int):
    """n_cells clipped cards, then a backdrop blur and a panel over them:
    more than 24 items with a blur and a backdrop quad, no atlas."""
    lst = RenderListArray()
    bg = lst.add_root_raw()
    n = lst.nodes
    n["kind"][bg] = int(FigKind.nkRectangle)
    n["box"][bg] = (0, 0, 160, 120)
    n["fill"]["c0"][bg] = (240, 240, 250, 255)
    for i in range(n_cells):
        p = lst.add_root_raw()
        n = lst.nodes
        n["kind"][p] = int(FigKind.nkRectangle)
        n["box"][p] = (4 + (i % 5) * 30, 4 + (i // 5) * 24, 26, 20)
        n["corners"][p] = (5,) * 4
        n["flags"][p] = int(FigFlags.NfClipContent)
        n["fill"]["c0"][p] = (200 - 9 * i, 60 + 7 * i, 120, 255)
        c = lst.add_child_raw(p)
        n = lst.nodes
        n["kind"][c] = int(FigKind.nkRectangle)
        n["box"][c] = (n["box"][p][0] - 10, n["box"][p][1] + 6, 60, 10)
        n["fill"]["c0"][c] = (30, 30, 220, 160)
    b = lst.add_root_raw()
    lst.nodes["kind"][b] = int(FigKind.nkBackdropBlur)
    lst.nodes["box"][b] = (30, 20, 90, 60)
    lst.nodes["blur"][b] = 6.0
    o = lst.add_root_raw()
    lst.nodes["kind"][o] = int(FigKind.nkRectangle)
    lst.nodes["box"][o] = (30, 20, 90, 60)
    lst.nodes["fill"]["c0"][o] = (255, 255, 255, 90)
    scene = RendersArray()
    scene.set_layer(0, lst)
    return scene


def test_blurred_cells_run_rolled_and_match_reference():
    from figdraw_tpu import FigRenderer as JaxRenderer
    from figdraw_tpu.nodesarray import FIG_DTYPE, RenderListArray as JaxList
    from figdraw_tpu.nodesarray import RendersArray as JaxRenders

    scene = _blurred_cells(15)
    lst = scene.layers[0]
    jl = JaxList(capacity=lst.count)
    jl.nodes[: lst.count] = lst.nodes[: lst.count].view(FIG_DTYPE)
    jl.count = lst.count
    jl.root_ids = list(lst.root_ids)
    jscene = JaxRenders()
    jscene.set_layer(0, jl)
    jr = JaxRenderer(atlas_size=64, use_pallas=False)
    ref = np.asarray(jr.render_frame(jscene, jax_vec2(160, 120)))
    pr = port.FigRenderer(device="cpu")
    plan = plan_execution(pr.flatten(scene, port.vec2(160, 120)))
    assert plan.rolled_items is not None and ("blur",) in plan.structure
    assert any(item[0] == "draw" and item[3] for item in plan.structure)
    _same_table(jr._plan_execution(jr.flatten(jscene, jax_vec2(160, 120))), plan)
    got = pr.render_frame(scene, port.vec2(160, 120))
    assert np.abs(got.numpy() - ref).max() <= TOL


# --- the blurred cards: a long tape with a blur, through the planner --------------------


@pytest.mark.parametrize("size", [BLURRED_SMALL, (1920, 1080, 400)])
def test_blurred_cards_bytes_match_reference(size):
    w, h, n = size
    a = jax_blurred_cards_scene(n, float(w), float(h)).layers[0]
    b = make_blurred_cards_scene(w, h, n).layers[0]
    assert a.count == b.count == 2 + 2 * n + 2 * (n // 5)
    assert a.root_ids == b.root_ids
    assert a.nodes[: a.count].tobytes() == b.nodes[: b.count].tobytes()


@pytest.fixture(scope="module")
def jax_blurred():
    """figdraw_tpu's blurred cards at the stored size: (its renderer and
    scene, its unrolled frame)."""
    w, h, n = BLURRED_SMALL
    jr = jax_image_renderer()
    scene = jax_blurred_cards_scene(n, float(w), float(h))
    return jr, scene, jax_unrolled_frame(jr, scene, w, h)


def test_blurred_cards_take_the_rolled_form_and_match_reference(jax_blurred):
    jr, jscene, ref = jax_blurred
    w, h, n = BLURRED_SMALL
    pr = port_image_renderer()
    scene = make_blurred_cards_scene(w, h, n)
    pr.process_image_messages()
    fresh_combo_pools()
    tape = pr.flatten(scene, port.vec2(w, h))
    jt = jr.flatten(jscene, jax_vec2(w, h))
    assert tape.combo.tobytes() == jt.combo.tobytes()
    plan = plan_execution(tape)
    assert plan.rolled_items is not None and plan.mega_combo is None
    assert len(plan.structure) == 1 + 3 * n + 2 + 3 * (n // 5)
    assert ("blur",) in plan.structure
    backdrop = [it for it in plan.structure if it[0] == "draw" and it[3]]
    assert backdrop == [("draw", -1, False, True)]
    _same_table(jr._plan_execution(jt), plan)
    before = (raster.LAUNCHES, raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES)
    got = pr.render_frame(scene, port.vec2(w, h))
    assert (raster.LAUNCHES, raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES) == before
    assert np.abs(got.numpy() - ref).max() <= TOL
    assert np.abs(block_means(got.numpy()) - np.load(BLURRED_REFERENCE)).max() <= TOL


def test_stored_blurred_blocks_match_jax(jax_blurred):
    """chip_smoke.py's rolled phase holds the card's 480x270 frame to these
    block means (tests/torch_reference.py frameloop writes them)."""
    stored = np.load(BLURRED_REFERENCE)
    np.testing.assert_allclose(stored, block_means(jax_blurred[2]), rtol=0, atol=1e-6)
