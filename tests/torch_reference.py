"""figdraw_tpu's side of figdraw_tpu_torch's image, text and rolled tests,
and the stored references `chip_smoke.py` holds the port to on the card.

Built with the JAX package on the CPU, on its default path there
(FigRenderer(use_pallas=False): atlas runs on the XLA windowed evaluator,
long tapes on the rolled executor):

- `images_<variant>_480x270_blocks8.npy` (the variant without its
  `images_` prefix): 8x8 block means of bench_images'
  variants at 480x270 with 25 panels (and of `images_clipped`, built with
  the figdraw_tpu API);
- `text_1200x800.npz`: bench_text's frame (36 lines, DejaVuSans at 15 px,
  FigRenderer(atlas_size=512)) as its plan (combo, structure, bounds, tile
  height), the atlas its glyphs were packed into, and the frame's 8x8
  block means. The card's machine has no fontTools: the port's text phase
  runs this stored plan;
- `example_<scene>_<form>_blocks8.npy`: 8x8 block means of the scenes of
  examples/layers_clip.py (900x560), examples/drawable_beziers.py
  (760x560) and examples/dashed_dotted_borders.py (820x560), each built
  by the example's own make_scene and rendered at its own size (form
  `1x`), at pixel_scale=2 into a frame of twice the size (`pixel2`) and at
  UI scale 2 (`ui2`), by FigRenderer(use_pallas=True): Pallas in interpret
  mode on the CPU;
- `textclip_1200x800.npz`: a table of text in clipped cells, tests/
  test_mega.py's text-in-clip scene grown to bench_clipmask's table (1200x800,
  180 rows x 6 cells in a clipped viewport, each cell clipping a line of
  DejaVuSans at 13 px that spills over it), as its tape (the packed combo,
  pass structure, draw bounds, tile density), atlas and block means. The
  port plans the stored tape itself (`scenes.load_text_tape`).

- `blurred_cards_480x270_blocks8.npy`: 8x8 block means of the blurred
  cards (`scenes.make_blurred_cards_scene`: 25 clipped photo cards, a
  backdrop blur of radius 12 under a frosted panel, 5 cards above it) at
  480x270, built with the figdraw_tpu API (`jax_blurred_cards_scene`) and
  rendered by figdraw_tpu's unrolled frame executor on its own plan
  (`jax_unrolled_frame`; its rolled executor drops an atlas run's
  backdrop, executor.py:689);
- `overlay_3d_420x300_blocks8.npy`: (6, 37, 52, 4), 8x8 block means of
  examples/overlay_3d.py's six frames (its scene and pyramid at t = 0.35 +
  0.5 i) through figdraw_tpu's render_frame_with_overlays
  (FigRenderer(atlas_size=128, use_pallas=False), `jax_overlay_frames`).

Rewrite them all (needs jax, fontTools and the DejaVu font), only the
example scenes' (needs jax), or only the frame loop's two (needs jax):

    JAX_PLATFORMS=cpu python tests/torch_reference.py
    JAX_PLATFORMS=cpu python tests/torch_reference.py examples
    JAX_PLATFORMS=cpu python tests/torch_reference.py frameloop
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
# the reduced image scenes of the tests and of chip_smoke.py's references
# (the benchmark: 1920x1080 with 400 panels)
IMAGE_W, IMAGE_H, IMAGE_N = 480, 270, 25
TEXT_W, TEXT_H = 1200, 800
# bench_clipmask's table, with text in its cells
TABLE_W, TABLE_H, TABLE_ROWS, TABLE_COLS = 1200, 800, 180, 6

if REPO not in sys.path:
    sys.path.insert(0, REPO)


def block_means(frame, k: int = 8):
    """Means of the frame's k x k blocks; rows and columns past the last
    whole block (270 = 33 * 8 + 6) are left out."""
    h, w, c = frame.shape
    h, w = h // k * k, w // k * k
    return frame[:h, :w].reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))


def to_port(arr):
    """A figdraw_tpu RendersArray as the port's: the node rows are the same
    bytes, and the drawable side arrays (ops and bezier points) the rows
    index come along, so the native walk reads the same ops. Text side
    arrays do not: the port packs no text."""
    from figdraw_tpu_torch.nodesarray import OP_DTYPE, RenderListArray, RendersArray

    out = RendersArray()
    for lvl, lst in arr.sorted_pairs():
        p = RenderListArray(capacity=max(lst.count, 1))
        p.nodes[: lst.count] = lst.nodes[: lst.count]
        p.count = lst.count
        p.root_ids = list(lst.root_ids)
        ops, points = lst.ops_view()
        p.ops_rows = [np.frombuffer(ops.tobytes(), OP_DTYPE)] if ops.shape[0] else []
        p.points_rows = [tuple(float(v) for v in pt) for pt in points]
        out.set_layer(lvl, p)
    return out


def spy_mega_runs(monkeypatch):
    """Record the port renderer's megakernel frames: a list that gains, per
    frame, (get_mega_executor's arguments, whether the run got an atlas)."""
    from figdraw_tpu_torch import renderer as port_renderer

    runs = []
    orig = port_renderer.get_mega_executor

    def spy(*key):
        run = orig(*key)

        def recorded(combo, init_frame, atlas=None, **kw):
            runs.append((key, atlas is not None))
            return run(combo, init_frame, atlas=atlas, **kw)

        return recorded

    monkeypatch.setattr(port_renderer, "get_mega_executor", spy)
    return runs


def _jax_cards(lst, rng, n: int, x0: float, y0: float, x1: float, y1: float):
    """n of images_clipped's cards at seeded places in [x0, x1) x [y0, y1):
    a 104x104 rounded panel clipping a 96x96 image child at (x + 24, y +
    24)."""
    from figdraw_tpu import Fig, FigFlags, FigKind, fill, image_style, rect, rgba

    import bench_images

    for _ in range(n):
        x = float(rng.uniform(x0, x1))
        y = float(rng.uniform(y0, y1))
        panel = lst.add_root(Fig(
            kind=FigKind.nkRectangle, screen_box=rect(x, y, 104, 104),
            fill=fill(rgba(80, 80, 80, 255)), corners=(12,) * 4,
            flags=FigFlags.NfClipContent))
        lst.add_child(panel, Fig(kind=FigKind.nkImage,
                                 screen_box=rect(x + 24, y + 24, 96, 96),
                                 image=image_style(bench_images.IMG_ID)))


def _jax_clipped_list(n: int, w: float, h: float):
    from figdraw_tpu import Fig, FigKind, fill, rect, rgba
    from figdraw_tpu.nodes import RenderList

    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(30, 30, 30, 255))))
    _jax_cards(lst, np.random.RandomState(777), n, 0, 0, w - 120, h - 120)
    return lst


def _as_array(lst):
    from figdraw_tpu import new_renders
    from figdraw_tpu.nodesarray import from_renders

    renders = new_renders()
    renders.set_layer(0, lst)
    return from_renders(renders)


def jax_clipped_scene(n: int, w: float, h: float):
    """images_clipped with the figdraw_tpu API: bench_images.build_scene's
    panels, each clipping its content, with a 96x96 image child at
    (x + 24, y + 24)."""
    return _as_array(_jax_clipped_list(n, w, h))


def jax_blurred_cards_scene(n: int, w: float, h: float):
    """scenes.make_blurred_cards_scene with the figdraw_tpu API: the n
    clipped cards, a backdrop blur of radius 12 over the frosted panel
    (the lower 45% of the frame, inset by 8%), then n // 5 cards (seed
    778) inside the panel."""
    from figdraw_tpu import Fig, FigKind, fill, rect, rgba
    from figdraw_tpu.nodes import BackdropBlurStyle

    lst = _jax_clipped_list(n, w, h)
    px, py, pw, ph = w * 0.08, h * 0.5, w * 0.84, h * 0.45
    lst.add_root(Fig(kind=FigKind.nkBackdropBlur, screen_box=rect(px, py, pw, ph),
                     backdrop_blur=BackdropBlurStyle(blur=12.0),
                     corners=(16,) * 4, fill=fill(rgba(255, 255, 255, 70))))
    _jax_cards(lst, np.random.RandomState(778), n // 5, px, py,
               px + pw - 104, py + ph - 104)
    return _as_array(lst)


def jax_unrolled_frame(ren, scene, w: int, h: int) -> np.ndarray:
    """figdraw_tpu's frame of a long tape on its unrolled frame executor
    (use_pallas=False), which its planner would send to the rolled one:
    the plan's packed rows with the unrolled meta tail (draw bounds, blur
    radii, clear color) in place of the rolled one-row meta. Run eagerly
    (jax.disable_jit): compiling a pass per item takes three times as long
    on the CPU as running them op by op."""
    import jax
    import jax.numpy as jnp
    from figdraw_tpu import executor as jex
    from figdraw_tpu import vec2
    from figdraw_tpu.ops.layout import PACKED_WIDTH

    ren.process_image_messages()
    plan = ren._plan_execution(ren.flatten(scene, vec2(w, h)))
    assert plan.rolled and plan.mega_combo is None
    n = plan.combo.shape[0] - 1  # the rolled meta: one row, the clear color
    clear = plan.combo[n, :4].copy()
    rows = jex._meta_rows(len(plan.bounds), len(plan.radii), PACKED_WIDTH)
    combo = np.zeros((n + rows, PACKED_WIDTH), np.float32)
    combo[:n] = plan.combo[:n]
    jex.fill_meta(combo[n:].reshape(-1), plan.bounds, plan.radii, clear)
    structure = tuple(item[:4] for item in plan.structure)
    run = jex.get_frame_executor(structure, plan.height, plan.width, plan.n_masks,
                                 False, False, False, ren.pixelate,
                                 tile_h=plan.tile_h)
    with jax.disable_jit():
        return np.asarray(run(jnp.asarray(combo), jnp.zeros((1, 1, 4), jnp.float32),
                              jnp.asarray(ren.atlas.data)))


def jax_overlay_frames(frames: int = 6):
    """examples/overlay_3d.py's frames through figdraw_tpu's
    render_frame_with_overlays: (F, 300, 420, 4)."""
    from figdraw_tpu import vec2
    from figdraw_tpu.renderer import FigRenderer

    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import overlay_3d
    finally:
        sys.path.remove(os.path.join(REPO, "examples"))
    ren = FigRenderer(atlas_size=128, use_pallas=False)
    scene = overlay_3d.make_scene(overlay_3d.W, overlay_3d.H)
    out = []
    for i in range(frames):
        pyramid = overlay_3d.rasterize_pyramid(overlay_3d.W, overlay_3d.H,
                                               t=0.35 + i * 0.5)
        out.append(np.asarray(ren.render_frame_with_overlays(
            scene, vec2(overlay_3d.W, overlay_3d.H), {0: pyramid})))
    return np.stack(out)


def write_frameloop_references() -> None:
    from figdraw_tpu_torch.scenes import (
        BLURRED_REFERENCE, BLURRED_SMALL, OVERLAY_REFERENCE,
    )

    w, h, n = BLURRED_SMALL
    ren = jax_image_renderer()
    frame = jax_unrolled_frame(ren, jax_blurred_cards_scene(n, w, h), w, h)
    np.save(BLURRED_REFERENCE, block_means(frame).astype(np.float32))
    print(f"wrote {BLURRED_REFERENCE}")
    means = np.stack([block_means(f) for f in jax_overlay_frames()])
    np.save(OVERLAY_REFERENCE, means.astype(np.float32))
    print(f"wrote {OVERLAY_REFERENCE}")


def jax_image_scene(variant: str, monkeypatch, w: int = IMAGE_W,
                    h: int = IMAGE_H, n: int = IMAGE_N):
    """bench_images' scene in array form (its frame size is a module global
    read at call time), or images_clipped."""
    import bench_images

    if variant == "images_clipped":
        return jax_clipped_scene(n, float(w), float(h))
    monkeypatch.setattr(bench_images, "W", w)
    monkeypatch.setattr(bench_images, "H", h)
    return bench_images.build_scene(n, variant)


def jax_image_renderer():
    """figdraw_tpu's renderer as bench_images.main sets it up: a 256 atlas
    and the photo published mipmapped on a bus of its own."""
    from figdraw_tpu import FigRenderer
    from figdraw_tpu.resources import ImageMessageBus, put_image

    import bench_images

    ren = FigRenderer(atlas_size=256, use_pallas=False)
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    put_image(bench_images.IMG_ID, bench_images._photo_image(), bus=bus,
              mipmapped=True)
    return ren


def port_image_renderer(atlas_size: int = 256, device="cpu"):
    """figdraw_tpu_torch's renderer set up as jax_image_renderer: the photo
    (scenes.photo_image, bench_images' own) published mipmapped on a bus of
    its own."""
    from figdraw_tpu_torch import FigRenderer
    from figdraw_tpu_torch.resources import ImageMessageBus, put_image
    from figdraw_tpu_torch.scenes import IMAGE_ID, photo_image

    ren = FigRenderer(atlas_size=atlas_size, device=device)
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    put_image(IMAGE_ID, photo_image(), bus=bus, mipmapped=True)
    return ren


def jax_image_frame(variant: str, monkeypatch, w: int = IMAGE_W,
                    h: int = IMAGE_H, n: int = IMAGE_N):
    """(scene, renderer, frame) of figdraw_tpu's default path."""
    from figdraw_tpu import vec2

    scene = jax_image_scene(variant, monkeypatch, w, h, n)
    ren = jax_image_renderer()
    frame = np.asarray(ren.render_frame(scene, vec2(w, h)))
    return scene, ren, frame


def text_fixture():
    """bench_text's frame through figdraw_tpu: (the fixture's arrays, the
    (800, 1200, 4) frame)."""
    import bench_text
    from figdraw_tpu import FigRenderer, fill, rgba, vec2
    from figdraw_tpu.text.typefaces import load_typeface

    tid = load_typeface(DEJAVU)
    scene, _ = bench_text.build_scene(tid, fill(rgba(20, 20, 30, 255)), 0)
    ren = FigRenderer(atlas_size=512, use_pallas=False)
    frame = np.asarray(ren.render_frame(scene, vec2(TEXT_W, TEXT_H)))
    plan = ren._plan_execution(ren.flatten(scene, vec2(TEXT_W, TEXT_H)))
    arrays = dict(
        combo=np.asarray(plan.combo, np.float32),
        structure=np.array(json.dumps([list(item) for item in plan.structure])),
        bounds=np.asarray(plan.bounds, np.int32).reshape(-1, 2),
        radii=np.asarray(plan.radii, np.float32),
        tile_h=np.int32(plan.tile_h), height=np.int32(plan.height),
        width=np.int32(plan.width), n_masks=np.int32(plan.n_masks),
        has_init_frame=np.bool_(plan.has_init_frame),
        atlas=np.asarray(ren.atlas.data, np.float32),
        blocks=block_means(frame).astype(np.float32),
    )
    return arrays, frame


def _text_font(size: float):
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    return FigFont(typeface_id=load_typeface(DEJAVU), size=size)


def jax_text_cells_scene():
    """tests/test_mega.py:159's scene: 8x3 clipped cells at 360x280, each
    with a line of DejaVuSans at 13 px that spills over its cell."""
    from figdraw_tpu import Fig, FigFlags, FigKind, fill, rect, rgba, vec2
    from figdraw_tpu.nodes import RenderList, Renders
    from figdraw_tpu.text.layout import typeset

    f = _text_font(13.0)
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 360, 280),
                     fill=fill(rgba(248, 249, 251, 255))))
    for row in range(8):
        for col in range(3):
            cell = rect(8 + col * 116, 8 + row * 33, 110, 28)
            ci = lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=cell,
                                  corners=(5,) * 4, flags=FigFlags.NfClipContent,
                                  fill=fill(rgba(255, 255, 255, 255))))
            arr = typeset(vec2(140, 24), [(f, fill(rgba(30, 30, 40, 255)),
                                           f"cell r{row}c{col} spills wide")])
            lst.add_child(ci, Fig(kind=FigKind.nkText,
                                  screen_box=rect(cell.x + 4, cell.y + 5, 140, 20),
                                  text_layout=arr))
    scene = Renders()
    scene.set_layer(0, lst)
    return scene


def jax_text_table_scene(rows: int = TABLE_ROWS, cols: int = TABLE_COLS,
                         w: float = TABLE_W, h: float = TABLE_H):
    """The text-in-clip scene at bench_clipmask.make_table_scene's size and
    layout: a clipped viewport scrolled by 37 px over rows x cols rounded
    cells of 22 px, each clipping a 13 px line that runs past its right
    edge."""
    from figdraw_tpu import Fig, FigFlags, FigKind, fill, rect, rgba, vec2
    from figdraw_tpu.nodes import RenderList, Renders
    from figdraw_tpu.text.layout import typeset

    f = _text_font(13.0)
    margin, gap, cell_h, scroll_y = 22.0, 4.0, 22.0, 37.0
    viewport = rect(margin, margin, w - margin * 2, h - margin * 2)
    cell_w = (viewport.w - gap * (cols + 1)) / cols
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(248, 249, 251, 255))))
    vp = lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=viewport,
                          fill=fill(rgba(232, 235, 240, 255)), corners=(10,) * 4,
                          flags=FigFlags.NfClipContent))
    for row in range(rows):
        y = viewport.y + gap + row * (cell_h + gap) - scroll_y
        for col in range(cols):
            cell = rect(viewport.x + gap + col * (cell_w + gap), y, cell_w, cell_h)
            shade = 255 if (row + col) % 2 == 0 else 244
            ci = lst.add_child(vp, Fig(
                kind=FigKind.nkRectangle, screen_box=cell, corners=(4,) * 4,
                flags=FigFlags.NfClipContent,
                fill=fill(rgba(shade, shade, 255, 255))))
            arr = typeset(vec2(cell_w + 60, 20), [(
                f, fill(rgba(30, 30 + (row * 7) % 90, 40 + (col * 29) % 120, 255)),
                f"cell r{row}c{col} spills wide past its clip")])
            lst.add_child(ci, Fig(
                kind=FigKind.nkText,
                screen_box=rect(cell.x + 4, cell.y + 3, cell_w + 60, 20),
                text_layout=arr))
    scene = Renders()
    scene.set_layer(0, lst)
    return scene


def _density(fields: np.ndarray, tile_h: int = 128, tile_w: int = 128):
    """native/flatten.cpp fd_density on logical field rows: (quad-tile pair
    count over live quads, median live bbox height or -1)."""
    bw = fields[:, 8] - fields[:, 6]
    bh = fields[:, 9] - fields[:, 7]
    live = (bw > 0) & (bh > 0)
    if not live.any():
        return 0.0, -1.0
    pairs = ((np.floor(bw[live] / np.float32(tile_w)) + 1.0)
             * (np.floor(bh[live] / np.float32(tile_h)) + 1.0)).sum()
    return float(np.float32(pairs)), float(np.median(bh[live]))


def text_table_fixture(rows: int = TABLE_ROWS, cols: int = TABLE_COLS,
                       w: int = TABLE_W, h: int = TABLE_H, atlas_size: int = 512):
    """The text table through figdraw_tpu's default path (the rolled
    executor): (the tape's arrays as `textclip_1200x800.npz` stores them,
    the (h, w, 4) frame)."""
    from figdraw_tpu import FigRenderer, vec2

    scene = jax_text_table_scene(rows, cols, float(w), float(h))
    ren = FigRenderer(atlas_size=atlas_size, use_pallas=False)
    frame = np.asarray(ren.render_frame(scene, vec2(w, h)))
    tape = ren.flatten(scene, vec2(w, h))
    plan = ren._plan_execution(tape)
    assert plan.rolled and plan.mega_combo is None and not plan.radii
    density = tape.tile_density or _density(np.asarray(tape.fields[: tape.count]))
    arrays = dict(
        combo=np.asarray(plan.combo, np.float32),
        count=np.int32(tape.count),
        structure=np.array(json.dumps([list(item[:4]) for item in plan.structure])),
        bounds=np.asarray(plan.bounds, np.int32).reshape(-1, 2),
        density=np.asarray(density, np.float32),
        tile_h=np.int32(plan.tile_h), height=np.int32(plan.height),
        width=np.int32(plan.width), n_masks=np.int32(plan.n_masks),
        atlas=np.asarray(ren.atlas.data, np.float32),
        blocks=block_means(frame).astype(np.float32),
    )
    return arrays, frame


def jax_example_scene(name: str):
    """An example scene as its example builds it with the figdraw_tpu API
    (the last frame the example writes): (renders, (w, h))."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        if name == "layers_clip":
            import layers_clip

            return layers_clip.make_scene(layers_clip.W, layers_clip.H,
                                          slide=12.0), (layers_clip.W, layers_clip.H)
        if name == "drawable_beziers":
            import drawable_beziers

            return drawable_beziers.make_scene(), (drawable_beziers.W,
                                                   drawable_beziers.H)
        import dashed_dotted_borders

        return dashed_dotted_borders.make_scene(phase=5.0), (
            dashed_dotted_borders.W, dashed_dotted_borders.H)
    finally:
        sys.path.remove(os.path.join(REPO, "examples"))


def jax_example_frame(name: str, form: str) -> np.ndarray:
    """figdraw_tpu's frame of an example scene in one of
    scenes.EXAMPLE_FORMS, on its Pallas path (interpret mode on the CPU)."""
    from figdraw_tpu import fig_ui_scale, set_fig_ui_scale, vec2
    from figdraw_tpu.renderer import FigRenderer

    from figdraw_tpu_torch.scenes import EXAMPLE_FORMS

    pixel_scale, ui_scale, mult = EXAMPLE_FORMS[form]
    renders, (w, h) = jax_example_scene(name)
    ren = FigRenderer(use_pallas=True, pixel_scale=pixel_scale)
    old = fig_ui_scale()
    set_fig_ui_scale(ui_scale)
    try:
        return np.asarray(ren.render_frame(renders, vec2(w * mult, h * mult)))
    finally:
        set_fig_ui_scale(old)


def write_example_references() -> None:
    from figdraw_tpu_torch.scenes import (
        EXAMPLE_FORMS, EXAMPLE_SCENES, example_reference_path,
    )

    for name in EXAMPLE_SCENES:
        for form in EXAMPLE_FORMS:
            path = example_reference_path(name, form)
            np.save(path, block_means(jax_example_frame(name, form)).astype(np.float32))
            print(f"wrote {path}")


def main() -> None:
    from figdraw_tpu_torch.scenes import (
        IMAGE_VARIANTS, TEXT_REFERENCE, TEXT_TABLE_REFERENCE,
        image_reference_path,
    )

    if sys.argv[1:] == ["frameloop"]:
        write_frameloop_references()
        return
    write_example_references()
    if sys.argv[1:] == ["examples"]:
        return
    write_frameloop_references()

    with pytest.MonkeyPatch.context() as mp:
        for variant in IMAGE_VARIANTS:
            _scene, _ren, frame = jax_image_frame(variant, mp)
            path = image_reference_path(variant)
            np.save(path, block_means(frame).astype(np.float32))
            print(f"wrote {path}")
    arrays, _frame = text_fixture()
    np.savez_compressed(TEXT_REFERENCE, **arrays)
    print(f"wrote {TEXT_REFERENCE} ({os.path.getsize(TEXT_REFERENCE)} bytes)")
    arrays, _frame = text_table_fixture()
    np.savez_compressed(TEXT_TABLE_REFERENCE, **arrays)
    print(f"wrote {TEXT_TABLE_REFERENCE} "
          f"({os.path.getsize(TEXT_TABLE_REFERENCE)} bytes)")


if __name__ == "__main__":
    main()
