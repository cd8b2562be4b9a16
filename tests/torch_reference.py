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
  (FigRenderer(atlas_size=128, use_pallas=False), `jax_overlay_frames`);
- the example scenes `msdf_star` (examples/msdf_star.py, its star SDF made
  by figdraw_tpu.utils.sdfgen) and `mtsdf` (`jax_mtsdf_scene`) in each
  form, as the other examples (`jax_example_images` publishes their
  images);
- `image_fixture.json`: the sha256 of PIL's decode of the PNG fixture
  (tests/goldens/render_3d_overlay_gaussian.png) and of the .flippy sidecar
  figdraw_tpu's read_image_cached writes for it (`fixture_digests`);
- `example_image_file_<form>_blocks8.npy` and
  `photo_wall_480x270_blocks8.npy`: 8x8 block means of
  examples/image_renderlist.py's scene with the fixture loaded by
  figdraw_tpu's load_image (`jax_image_file_frame`) in each form, and of
  the photo wall of the loaded image at 480x270 with 12 panels
  (`jax_photo_wall_frame`), both FigRenderer(atlas_size=512,
  use_pallas=False).

Rewrite them all (needs jax, fontTools, PIL and the DejaVu font), only the
example scenes' (needs jax), only the frame loop's two (needs jax) or only
the image files' (needs jax and PIL):

    JAX_PLATFORMS=cpu python tests/torch_reference.py
    JAX_PLATFORMS=cpu python tests/torch_reference.py examples
    JAX_PLATFORMS=cpu python tests/torch_reference.py frameloop
    JAX_PLATFORMS=cpu python tests/torch_reference.py images
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


# figdraw_tpu's own builds of its walk (native.py's _build) and of its
# typesetter (text/native_typeset.py's _build), written here to a private
# name: those _builds write the library in place, so test workers that meet
# an empty native/build/ race, and a worker that opens a half-written
# library keeps _load_failed for the rest of its life
JAX_WALK_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-pthread",
                  "-shared", "-fPIC", "-std=c++17")
JAX_TYPESET_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared",
                     "-fPIC", "-std=c++17")


def _ensure_jax_library(module, flags):
    """module._load()'s library, loaded: when _load() returned None (a lost
    build race), build it with the package's own command under a private
    name, os.replace it onto module._LIB under an fcntl lock in its build
    directory, clear _load_failed and load again. Raises when that fails
    too: the tests never skip for it."""
    import fcntl
    import subprocess

    lib = module._load()
    if lib is not None:
        return lib
    os.makedirs(module._LIB_DIR, exist_ok=True)
    with open(os.path.join(module._LIB_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        module._load_failed = False
        lib = module._load()  # another worker may have replaced it meanwhile
        if lib is None:
            tmp = f"{module._LIB}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", *flags, "-o", tmp, module._SRC],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, module._LIB)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            module._load_failed = False
            lib = module._load()
    if lib is None:
        raise RuntimeError(f"figdraw_tpu's library {module._LIB} does not load")
    return lib


def ensure_jax_native(jax_native=None):
    """figdraw_tpu.native's walk library, loaded (_ensure_jax_library): the
    tests that hold the port to figdraw_tpu's C++ walk call it before they
    use that walk. jax_native: the module (default figdraw_tpu.native)."""
    if jax_native is None:
        from figdraw_tpu import native as jax_native
    return _ensure_jax_library(jax_native, JAX_WALK_FLAGS)


def ensure_jax_typeset():
    """figdraw_tpu.text.native_typeset's library, loaded
    (_ensure_jax_library), for the tests that hold the port's C typesetter
    to figdraw_tpu's build."""
    from figdraw_tpu.text import native_typeset as jax_nt

    flags = JAX_TYPESET_FLAGS + ("-I", os.path.dirname(jax_nt._SRC))
    return _ensure_jax_library(jax_nt, flags)


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


class _TmpFactory:
    """tmp_path_factory's mktemp over a plain directory, for the JAX shaping
    tests' module fixtures."""

    def __init__(self, root):
        self.root = root
        self.n = 0

    def mktemp(self, name):
        import pathlib

        self.n += 1
        path = pathlib.Path(self.root) / f"{name}{self.n}"
        path.mkdir(parents=True, exist_ok=True)
        return path


def _fea_font(path, family, names, cmap, fea, advances=None):
    """A FontBuilder font of square glyphs with `fea` compiled in."""
    from fontTools.feaLib.builder import addOpenTypeFeaturesFromString
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen

    fb = FontBuilder(1000, isTTF=True)
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap(cmap)
    glyf = {}
    for g in names:
        pen = TTGlyphPen(None)
        pen.moveTo((50, 0)); pen.lineTo((450, 0))
        pen.lineTo((450, 700)); pen.lineTo((50, 700)); pen.closePath()
        glyf[g] = pen.glyph()
    fb.setupGlyf(glyf)
    fb.setupHorizontalMetrics({g: ((advances or {}).get(g, 500), 50) for g in names})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": family, "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200)
    fb.setupPost()
    addOpenTypeFeaturesFromString(fb.font, fea)
    fb.font.save(str(path))
    return str(path)


def add_context_formats(path: str, gpos7: bool = False) -> None:
    """Append GSUB 5 subtables in formats 1, 2 and 3 and GSUB 6 and GPOS 8 in
    formats 1 and 2 (feaLib writes chained format 3 only) to the font at
    `path`, each applying lookup 0 of its table; gpos7 adds GPOS 7 in
    formats 1, 2 and 3 too. Both packages' shapers take a GPOS 7 lookup for
    an extension (shaper._unwrap) and raise AttributeError on it, so the
    shaping fonts leave it out."""
    from fontTools.ttLib import TTFont
    from fontTools.ttLib.tables import otTables as ot

    font = TTFont(path)

    def cov(glyphs):
        c = ot.Coverage()
        c.glyphs = list(glyphs)
        return c

    def cdef(classes):
        c = ot.ClassDef()
        c.classDefs = dict(classes)
        return c

    def rec(kind, seq, li):
        r = getattr(ot, kind)()
        r.SequenceIndex, r.LookupListIndex = seq, li
        return r

    def rule(cls, chained, values, rec_name, recs):
        r = getattr(ot, cls)()
        if chained:
            r.Backtrack, r.Input, r.LookAhead = values
        elif cls.endswith("ClassRule"):
            r.Class = values[1]
        else:
            r.Input = values[1]
        setattr(r, rec_name, recs)
        return r

    for tag, kind, rec_name in (("GSUB", "Sub", "SubstLookupRecord"),
                                ("GPOS", "Pos", "PosLookupRecord")):
        table = font[tag].table
        plain, chain = ("ContextSubst", "ChainContextSubst") if kind == "Sub" else (
            "ContextPos", "ChainContextPos")
        subs = []
        for chained, cls_name in ((False, plain), (True, chain)):
            if kind == "Pos" and not chained and not gpos7:
                continue
            pre = ("Chain" + kind) if chained else kind
            recs = [rec(rec_name, 0, 0)]
            st = getattr(ot, cls_name)()
            st.Format = 1
            st.Coverage = cov(["a", "b"])
            sets = []
            for first in ("a", "b"):
                rs = getattr(ot, pre + "RuleSet")()
                setattr(rs, pre + "Rule", [rule(pre + "Rule", chained,
                                                (["c"], ["x"], ["y"]), rec_name, recs)])
                sets.append(rs)
            setattr(st, pre + "RuleSet", sets)
            subs.append(st)
            st = getattr(ot, cls_name)()
            st.Format = 2
            st.Coverage = cov(["a", "b", "c"])
            classes = {"a": 1, "b": 1, "x": 2, "y": 2, "c": 3}
            if chained:
                st.BacktrackClassDef = cdef({"d": 1})
                st.InputClassDef = cdef(classes)
                st.LookAheadClassDef = cdef({"z": 1, "e": 2})
            else:
                st.ClassDef = cdef(classes)
            cs = getattr(ot, pre + "ClassSet")()
            setattr(cs, pre + "ClassRule", [rule(pre + "ClassRule", chained,
                                                 ([1], [2], [1, 2]), rec_name, recs)])
            setattr(st, pre + "ClassSet", [None, cs, None, None])
            subs.append(st)
            if not chained:
                st = getattr(ot, cls_name)()
                st.Format = 3
                st.Coverage = [cov(["a", "b"]), cov(["x", "y"])]
                setattr(st, rec_name, recs)
                subs.append(st)
        for st in subs:
            lookup = ot.Lookup()
            lookup.LookupType = ({"Sub": 5, "Pos": 7}[kind] if "Chain" not in type(st).__name__
                                 else {"Sub": 6, "Pos": 8}[kind])
            lookup.LookupFlag = 0
            lookup.SubTable = [st]
            table.LookupList.Lookup.append(lookup)
    font.save(path)


def shaping_font_paths(tmp_dir) -> dict:
    """The fonts figdraw_tpu's shaping tests build (tests/test_shaping.py,
    test_shaping_thai.py, test_shaping_use.py), by their own builders, and
    three more: cursive anchors (test_gpos_cursive_attachment's), GSUB and
    GPOS lookups in extension subtables (feaLib's useExtension), and chained
    contexts of glyph, class and coverage rules. {name: path}."""
    import pathlib

    import test_shaping
    import test_shaping_thai
    import test_shaping_use
    from figdraw_tpu.text.typefaces import get_typeface

    tmp = pathlib.Path(tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    factory = _TmpFactory(tmp)
    out = {
        "fea": test_shaping._build_fea_font(factory.mktemp("fea")),
        "multiple": test_shaping._build_multiple_subst_font(factory.mktemp("mult")),
        "mark_filter": test_shaping._build_mark_filter_font(factory.mktemp("filt")),
        "var": test_shaping._build_var_font(factory.mktemp("var")),
    }
    for name, mod, fixture in (("thai", test_shaping_thai, "thai_tid"),
                               ("thai_bare", test_shaping_thai, "bare_tid"),
                               ("khmer", test_shaping_use, "khmer_tid"),
                               ("myanmar", test_shaping_use, "myanmar_tid")):
        tid = getattr(mod, fixture)._get_wrapped_function()(factory)
        out[name] = get_typeface(tid).path
    abc = [".notdef", "a", "b", "c"]
    out["cursive"] = _fea_font(factory.mktemp("curs") / "curstest.ttf", "CursTest",
                               abc, {ord(c): c for c in "abc"}, """
        feature curs {
            position cursive a <anchor 0 100> <anchor 450 -100>;
            position cursive b <anchor 50 100> <anchor 450 -100>;
        } curs;
    """)
    names = [".notdef", "f", "i", "l", "f_i", "f_l", "A", "V", "acute"]
    out["extension"] = _fea_font(
        factory.mktemp("ext") / "exttest.ttf", "ExtTest", names,
        {ord(c): c for c in "filAV"} | {0x0301: "acute"}, """
        markClass [acute] <anchor 250 700> @TOP;
        lookup LIGS useExtension {
            sub f i by f_i;
            sub f l by f_l;
        } LIGS;
        lookup KERN useExtension {
            pos A V -70;
            pos [A V] [f i] -20;
        } KERN;
        lookup MARKS useExtension {
            pos base [A V f i l] <anchor 250 700> mark @TOP;
        } MARKS;
        feature liga { lookup LIGS; } liga;
        feature kern { lookup KERN; } kern;
        feature mark { lookup MARKS; } mark;
    """, advances={"acute": 0})
    names = [".notdef", "a", "b", "c", "d", "e", "x", "y", "z", "a.alt", "b.alt"]
    out["context"] = _fea_font(
        factory.mktemp("ctx") / "ctxtest.ttf", "CtxTest", names,
        {ord(c): c for c in "abcdexyz"}, """
        @LEFT = [a b c];
        @RIGHT = [x y z];
        lookup ALT { sub a by a.alt; sub b by b.alt; } ALT;
        lookup KERN1 { pos a -30; pos b -40; } KERN1;
        feature calt {
            sub a' lookup ALT x;
            sub b' lookup ALT y z;
            sub c d a' lookup ALT e;
            sub @LEFT b' lookup ALT @RIGHT;
        } calt;
        feature kern {
            pos a' lookup KERN1 [x y];
            pos @LEFT b' lookup KERN1 @RIGHT;
            pos [c d] [d e] a' lookup KERN1 [x] [y z];
        } kern;
    """)
    add_context_formats(out["context"])
    return out


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


def jax_mtsdf_scene(w: float = 280.0, h: float = 100.0):
    """scenes.make_mtsdf_scene with the figdraw_tpu API:
    test_images.py::test_mtsdf_and_annular_msdf_render's scene with each
    node's style set as its kind reads it, and an annular MTSDF ring."""
    from figdraw_tpu import Fig, FigKind, MsdfImageStyle, fill, new_renders, rect, rgba
    from figdraw_tpu.nodes import RenderList

    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(250, 250, 250, 255))))
    lst.add_root(Fig(kind=FigKind.nkMtsdfImage, screen_box=rect(10, 20, 64, 64),
                     mtsdf_image=MsdfImageStyle(id=98, fill=fill(rgba(20, 60, 200, 255)),
                                                px_range=4.0)))
    lst.add_root(Fig(kind=FigKind.nkMsdfImage, screen_box=rect(110, 20, 64, 64),
                     msdf_image=MsdfImageStyle(id=98, fill=fill(rgba(200, 40, 40, 255)),
                                               px_range=4.0, stroke_weight=2.0)))
    lst.add_root(Fig(kind=FigKind.nkMtsdfImage, screen_box=rect(200, 20, 64, 64),
                     mtsdf_image=MsdfImageStyle(id=98, fill=fill(rgba(30, 150, 60, 255)),
                                                px_range=4.0, stroke_weight=3.0)))
    r = new_renders()
    r.set_layer(0, lst)
    return r


def jax_example_images(name: str) -> list:
    """The (id, image) pairs an example scene draws, made by figdraw_tpu:
    msdf_star's star through figdraw_tpu.utils.sdfgen, test_images.py's
    synthetic MSDF circle for the MTSDF scene."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        if name == "msdf_star":
            import msdf_star
            from figdraw_tpu.utils.sdfgen import sdf_from_coverage

            return [(msdf_star.STAR_ID, sdf_from_coverage(msdf_star.star_coverage(),
                                                          px_range=msdf_star.PX_RANGE))]
        if name == "mtsdf":
            from test_images import synthetic_msdf

            return [(98, synthetic_msdf())]
        return []
    finally:
        sys.path.remove(os.path.join(REPO, "examples"))
        sys.path.remove(os.path.join(REPO, "tests"))


def jax_example_scene(name: str):
    """An example scene as its example builds it with the figdraw_tpu API
    (the last frame the example writes): (renders, (w, h))."""
    if name == "mtsdf":
        return jax_mtsdf_scene(), (280, 100)
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        if name == "msdf_star":
            import msdf_star

            return msdf_star.make_scene(), (msdf_star.W, msdf_star.H)
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

    from figdraw_tpu.resources import ImageMessageBus, put_image

    pixel_scale, ui_scale, mult = EXAMPLE_FORMS[form]
    renders, (w, h) = jax_example_scene(name)
    ren = FigRenderer(use_pallas=True, pixel_scale=pixel_scale)
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    for image_id, image in jax_example_images(name):
        put_image(image_id, image, bus=bus)
    old = fig_ui_scale()
    set_fig_ui_scale(ui_scale)
    try:
        return np.asarray(ren.render_frame(renders, vec2(w * mult, h * mult)))
    finally:
        set_fig_ui_scale(old)


def jax_image_file_scene(w: float, h: float, image_id: int):
    """scenes.make_image_file_scene with the figdraw_tpu API:
    examples/image_renderlist.py's scene with the image `image_id`."""
    from figdraw_tpu import Fig, FigKind, fill, image_style, new_renders, rect, rgba

    renders = new_renders()
    root = renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                                   fill=fill(rgba(30, 30, 30, 255))))
    renders.add_child(0, root, Fig(kind=FigKind.nkRectangle,
                                   screen_box=rect(40, 40, 320, 320), corners=(16,) * 4,
                                   fill=fill(rgba(80, 80, 80, 255))))
    renders.add_child(0, root, Fig(kind=FigKind.nkImage, screen_box=rect(60, 60, 280, 280),
                                   image=image_style(image_id)))
    return renders


def jax_photo_wall(w: float, h: float, n: int, image_id: int):
    """scenes.make_loaded_photo_wall with the figdraw_tpu API, in array
    form."""
    from figdraw_tpu import Fig, FigFlags, FigKind, fill, image_style, rect, rgba
    from figdraw_tpu.nodes import RenderList
    from figdraw_tpu_torch.scenes import PHOTO_WALL_EDGES

    rng = np.random.RandomState(777)
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(30, 30, 30, 255))))
    for i in range(n):
        s = float(PHOTO_WALL_EDGES[i % 4])
        ih = s * 0.75
        x = float(rng.uniform(0, max(1.0, w - s - 16)))
        y = float(rng.uniform(0, max(1.0, h - ih - 16)))
        clip = (i // 4) % 4 == 0
        box = rect(x, y, s, ih) if clip else rect(x, y, s + 16, ih + 16)
        panel = lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=box,
                                 fill=fill(rgba(80, 80, 80, 255)), corners=(12,) * 4,
                                 flags=FigFlags.NfClipContent if clip else 0))
        lst.add_child(panel, Fig(kind=FigKind.nkImage, screen_box=rect(x + 8, y + 8, s, ih),
                                 image=image_style(image_id)))
    return _as_array(lst)


def jax_loaded_renderer(path: str, pixel_scale: float = 1.0, atlas_size: int = 512):
    """figdraw_tpu's renderer (use_pallas=False) with the PNG at `path`
    loaded by its load_image (PIL, its .flippy sidecar beside the file) on
    a bus of its own: (renderer, ImageRef)."""
    from figdraw_tpu.renderer import FigRenderer
    from figdraw_tpu.resources import ImageMessageBus, load_image

    jax_flippy()
    ren = FigRenderer(atlas_size=atlas_size, use_pallas=False, pixel_scale=pixel_scale)
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    return ren, load_image(path, bus=bus)


def jax_image_file_frame(path: str, form: str) -> np.ndarray:
    """figdraw_tpu's frame of the image-file scene in one of
    scenes.EXAMPLE_FORMS, the image loaded from `path`."""
    from figdraw_tpu import fig_ui_scale, set_fig_ui_scale, vec2

    from figdraw_tpu_torch.scenes import EXAMPLE_FORMS, IMAGE_FILE_SIZE

    pixel_scale, ui_scale, mult = EXAMPLE_FORMS[form]
    (w, h) = IMAGE_FILE_SIZE
    ren, ref = jax_loaded_renderer(path, pixel_scale)
    old = fig_ui_scale()
    set_fig_ui_scale(ui_scale)
    try:
        return np.asarray(ren.render_frame(jax_image_file_scene(w, h, ref.id),
                                           vec2(w * mult, h * mult)))
    finally:
        set_fig_ui_scale(old)


def jax_photo_wall_frame(path: str, w: int, h: int, n: int) -> np.ndarray:
    from figdraw_tpu import vec2

    ren, ref = jax_loaded_renderer(path)
    return np.asarray(ren.render_frame(jax_photo_wall(w, h, n, ref.id), vec2(w, h)))


def jax_flippy():
    """figdraw_tpu.utils.flippy with its Snappy library loaded. It builds
    the library at first use in place (native/build/), so a test worker that
    loads it while another worker is still building it fails once and would
    write literal-only streams for the rest of the process: retry until the
    other build is done."""
    import time

    from figdraw_tpu.utils import flippy

    for _ in range(60):
        if flippy._load() is not None:
            return flippy
        flippy._load_failed = False
        time.sleep(0.5)
    raise RuntimeError("figdraw_tpu's Snappy library does not load")


def fixture_copy(tmp_dir: str) -> str:
    """The PNG fixture copied into tmp_dir (load_image writes its sidecar
    beside the file it reads)."""
    import shutil

    from figdraw_tpu_torch.scenes import IMAGE_FIXTURE

    path = os.path.join(tmp_dir, os.path.basename(IMAGE_FIXTURE))
    shutil.copyfile(IMAGE_FIXTURE, path)
    return path


def fixture_digests(tmp_dir: str) -> dict:
    """The fixture's sha256 digests: PIL's decode (`Image.open(...)
    .convert("RGBA")`) and the sidecar figdraw_tpu's read_image_cached
    writes for it."""
    import hashlib

    from PIL import Image

    read_image_cached = jax_flippy().read_image_cached
    path = fixture_copy(tmp_dir)
    pixels = np.asarray(Image.open(path).convert("RGBA"))
    read_image_cached(path)
    with open(path + ".flippy", "rb") as fh:
        sidecar = fh.read()
    return {"decoded_sha256": hashlib.sha256(pixels.tobytes()).hexdigest(),
            "shape": list(pixels.shape),
            "sidecar_sha256": hashlib.sha256(sidecar).hexdigest(),
            "sidecar_bytes": len(sidecar)}


def write_image_file_references() -> None:
    import tempfile

    from figdraw_tpu_torch.scenes import (
        EXAMPLE_FORMS, IMAGE_FIXTURE_REFERENCE, PHOTO_WALL_REFERENCE, PHOTO_WALL_SMALL,
        example_reference_path,
    )

    with tempfile.TemporaryDirectory() as td:
        with open(IMAGE_FIXTURE_REFERENCE, "w") as fh:
            json.dump(fixture_digests(td), fh, indent=1)
            fh.write("\n")
        print(f"wrote {IMAGE_FIXTURE_REFERENCE}")
        path = fixture_copy(td)
        for form in EXAMPLE_FORMS:
            out = example_reference_path("image_file", form)
            np.save(out, block_means(jax_image_file_frame(path, form)).astype(np.float32))
            print(f"wrote {out}")
        w, h, n = PHOTO_WALL_SMALL
        np.save(PHOTO_WALL_REFERENCE,
                block_means(jax_photo_wall_frame(path, w, h, n)).astype(np.float32))
        print(f"wrote {PHOTO_WALL_REFERENCE}")


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
    if sys.argv[1:] == ["images"]:
        write_image_file_references()
        return
    write_example_references()
    if sys.argv[1:] == ["examples"]:
        return
    write_frameloop_references()
    write_image_file_references()

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
