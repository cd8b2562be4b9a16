"""Rendering across several devices in figdraw_tpu_torch on the CPU
(figdraw_tpu_torch/parallel/sharding.py): the tier-1 twins of the JAX
package's sharded tests (tests/test_sharded_perf.py's frames,
test_misc.py:136 and :270, test_batch.py:158), at their small sizes.

Meshes of 2, 4 and 8 `cpu` entries stand against
figdraw_tpu.parallel.sharding.default_mesh(n) on conftest's 8 virtual CPU
devices: band geometry as JAX computes it; the tile lists of a band at a
non-zero origin equal raster_pallas.prebin(y_offset=) exactly; the plain
K1, K3 and K4 at a band origin equal the rows of a whole-frame pass bit
for bit and K1 / K3 stay within 1/255 of raster_ref with y_offset; the
banded blur is bit-equal to _banded_blur_planar inside its shard_map, on
the swap and the gather path; ShardedFigRenderer frames are within 1/255
of JAX's ShardedFigRenderer(use_pallas=False) and of the port's
FigRenderer, and where a rotated box's fringe past its bbox makes a
sharded frame differ from the one-device frame (in both packages, JAX's
Pallas kernels in interpret mode) the difference is within
chip_smoke.layout_fringe's bound; render_batch(mesh=) equals render_frame
bit for bit."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import figdraw_tpu_torch as port
import test_batch as jbatch
from figdraw_tpu import (
    BackdropBlurStyle, Fig, FigFlags, FigKind, fill, new_renders, rect, rgba,
    vec2 as jax_vec2,
)
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.ops import raster_pallas, raster_ref
from figdraw_tpu.parallel import sharding as jsh
from figdraw_tpu.scenes import make_render_tree
from figdraw_tpu_torch.ops import binning, blur, mega, raster
from figdraw_tpu_torch.ops.binning import bin_quads_model, bin_quads_plain, decode_and_bin_plain
from figdraw_tpu_torch.ops.layout import pack_fields_np
from figdraw_tpu_torch.parallel import sharding
from figdraw_tpu_torch.parallel.sharding import (
    FRAMES_AXIS, Mesh, ShardedFigRenderer, band_geometry, band_tiles,
)
from figdraw_tpu_torch.plan import plan_execution
from figdraw_tpu_torch.scenes import binning_tape, mega_modes_tape, modes_tape
from torch_reference import to_port

torch.set_num_threads(1)  # see tests/test_torch_render_frame.py

TOL = 1.0 / 255.0
CPU = torch.device("cpu")
DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"


def cpu_mesh(n, axis=sharding.ROWS_AXIS):
    return Mesh((CPU,) * n, axis)


def _u8(frame):
    return np.clip(np.round(np.asarray(frame) * 255.0), 0, 255).astype(np.int64)


# --- the mesh and the band geometry ----------------------------------------------


@pytest.mark.parametrize("n,height,width", [
    (2, 160, 256), (4, 160, 256), (8, 160, 256), (3, 1080, 1920), (24, 1080, 1920),
    (8, 7, 130), (1, 192, 256)])
def test_band_geometry_is_jaxs(n, height, width):
    want = (jsh._band_geometry(jsh.default_mesh(n), height, width)
            if n <= len(jax.devices()) else _jax_geometry(n, height, width))
    assert band_geometry(cpu_mesh(n), height, width) == want
    assert band_geometry(n, height, width) == want


def _jax_geometry(n, height, width):
    th, tw = jsh.SHARD_TILE_H, jsh.SHARD_TILE_W
    band = -(-height // n)
    pband = max(-(-band // th) * th, th)
    return n, th, tw, pband, pband * n, -(-width // tw) * tw


@pytest.mark.parametrize("pband,tile_h,want", [
    (272, 128, (32, 288)), (48, 128, (16, 48)), (400, 64, (64, 448)),
    (80, 32, (16, 80)), (8, 128, (16, 16)), (256, 128, (128, 256))])
def test_band_tiles_pad_a_band_by_an_eighth_at_most(pband, tile_h, want):
    got = band_tiles(pband, tile_h)
    assert got == want
    t, kh = got
    assert kh % t == 0 and t % 16 == 0 and kh >= pband
    assert kh - pband <= max(pband // 8, 8)


def test_mesh_of_mixed_types_raises():
    with pytest.raises(ValueError, match="one type"):
        Mesh((CPU, torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="at least one"):
        Mesh(())
    assert Mesh(("cuda",)).devices == (torch.device("cuda", 0),)
    assert cpu_mesh(3).shape == {"rows": 3} and cpu_mesh(3).distinct() == (CPU,)


def test_default_and_frames_mesh_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (sharding.default_mesh, sharding.frames_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(2)


def test_deal_gives_contiguous_blocks_in_order():
    got = sharding.deal(11, cpu_mesh(4))
    assert [(a, b) for _d, a, b in got] == [(0, 3), (3, 6), (6, 9), (9, 11)]
    assert [(a, b) for _d, a, b in sharding.deal(2, cpu_mesh(4))] == [
        (0, 1), (1, 2), (2, 2), (2, 2)]


# --- the front end at a band origin ---------------------------------------------------


def _prebin(f, m, ph, pw, row0, th, runs):
    idx, counts = raster_pallas.prebin(
        jnp.asarray(f), jnp.int32(f.shape[0]), ph, pw, y_offset=jnp.int32(row0),
        tile_h=th, tile_w=128, modes=None if m is None else jnp.asarray(m),
        run_bounds=None if runs is None else jnp.asarray(runs, jnp.int32),
        n_runs=0 if runs is None else len(runs))
    return np.asarray(idx)[:, 0, :], np.asarray(counts)


@pytest.mark.parametrize("row0,th", [(0, 8), (40, 8), (96, 8), (128, 64), (136, 32),
                                     (248, 8)])
@pytest.mark.parametrize("cull", [False, True])
def test_lists_at_a_band_origin_equal_prebin(row0, th, cull):
    """A band of a 384x256 frame at its origin: the plain binning, its
    kernel model and the plain front end give raster_pallas.prebin's lists
    with y_offset exactly, quads across the band's edges included."""
    n, n_live = 512, 400
    f, m = binning_tape(n, n_live, seed=row0 + th, w=384.0, h=256.0)
    ph = 64 if th == 8 else 2 * th
    runs = [[0, 150], [150, 151], [151, n_live]] if cull else None
    want = _prebin(f, m if cull else None, ph, 384, row0, th, runs)
    got = bin_quads_plain(torch.from_numpy(f), 0, n, ph // th, 3, th, 128,
                          modes=torch.from_numpy(m) if cull else None,
                          run_bounds=None if runs is None else torch.tensor(runs),
                          row0=row0)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    idx, counts, borderline = bin_quads_model(f, 0, n, ph // th, 3, th, 128,
                                              modes=m if cull else None,
                                              run_bounds=runs, row0=row0)
    assert not borderline.any()
    np.testing.assert_array_equal(counts, want[1])
    np.testing.assert_array_equal(idx, want[0])
    # the front end on the packed rows: prebin's lists of the decoded tape
    rows = torch.from_numpy(pack_fields_np(f, m))
    fr = decode_and_bin_plain(rows, 0, n, ph // th, 3, th, 128, cull=cull,
                              run_bounds=None if runs is None else torch.tensor(runs),
                              row0=row0)
    decoded = _prebin(fr[0].numpy(), fr[1].numpy() if cull else None, ph, 384, row0, th,
                      runs)
    np.testing.assert_array_equal(fr[3].numpy(), decoded[1])
    np.testing.assert_array_equal(fr[2].numpy(), decoded[0])
    # quads that straddle the band's top or bottom edge are in its lists
    y0, y1 = f[:n_live, 7], f[:n_live, 9]
    straddle = np.flatnonzero(((y0 < row0) & (y1 > row0))
                              | ((y0 < row0 + ph) & (y1 > row0 + ph)))
    live = np.concatenate([want[0][t, : want[1][t]] for t in range(want[1].size)])
    assert straddle.size and np.isin(straddle, live).any()


def test_band_origin_arguments_are_checked():
    f = torch.zeros((64, 68))
    for bad in (-8, 2.5, 1 << 24):
        with pytest.raises(ValueError, match="band origin"):
            binning.bin_quads(f, 0, 64, 1, 1, 16, 128, row0=bad)


# --- the raster kernels at a band origin --------------------------------------------


def _modes_frame(w=256, h=128):
    fields, modes, n_live = modes_tape(w, h)
    rng = np.random.RandomState(5)
    modes[1:n_live:5, 1] = 1  # some quads read the second mask plane
    return (torch.from_numpy(fields), torch.from_numpy(modes), n_live,
            torch.from_numpy(rng.rand(4, h, w).astype(np.float32)),
            torch.from_numpy(rng.rand(4, h, w).astype(np.float32)),
            torch.from_numpy(rng.rand(1, h, w).astype(np.float32)))


@pytest.mark.parametrize("row0,th", [(32, 32), (64, 16), (48, 16)])
def test_k1_and_k3_at_a_band_origin_are_the_rows_of_the_whole_pass(row0, th):
    """The plain K1 (with the backdrop) and K3 over a band equal the whole
    frame's pass on the band's rows bit for bit, and stay within 1/255 of
    raster_ref with y_offset (the JAX reference that bands a frame)."""
    f, m, n_live, planes, backdrop, mask1 = _modes_frame()
    w, h = 256, 128
    masks = torch.cat([torch.ones_like(mask1), mask1])
    bounds = torch.tensor([0, n_live], dtype=torch.int32)
    whole_bins = bin_quads_plain(f, 0, f.shape[0], h // th, 2, th, 128, modes=m)
    whole = raster.draw_pass_planar_prebinned_plain(
        f, m, bounds, *whole_bins, planes, masks, backdrop, tile_h=th)
    whole_k3 = raster.draw_pass_mask_prebinned_plain(
        f, m, bounds, *whole_bins, masks[1:2], masks, tile_h=th)
    bh = 32
    sl = slice(row0, row0 + bh)
    band_bins = bin_quads_plain(f, 0, f.shape[0], bh // th, 2, th, 128, modes=m, row0=row0)
    band = raster.draw_pass_planar_prebinned(
        f, m, bounds, *band_bins, planes[:, sl].clone(), masks[:, sl].contiguous(),
        backdrop[:, sl].contiguous(), tile_h=th, row0=row0)
    band_masks = masks[:, sl].clone()
    band_k3 = raster.draw_pass_mask_prebinned(
        f, m, bounds, *band_bins, band_masks[1:2], band_masks, tile_h=th, row0=row0)
    assert torch.equal(band, whole[:, sl])
    assert torch.equal(band_k3, whole_k3[:, sl])
    # raster_ref on the band, at its y_offset
    jf, jm = jnp.asarray(f.numpy()), jnp.asarray(m.numpy())
    ref = raster_ref.draw_pass_frame_range(
        jf, jm, 0, n_live, jnp.asarray(planes[:, sl].permute(1, 2, 0).numpy()),
        jnp.asarray(masks[:, sl].numpy()),
        backdrop=jnp.asarray(backdrop[:, sl].permute(1, 2, 0).numpy()),
        y_offset=float(row0))
    assert float(np.abs(np.asarray(ref) - band.permute(1, 2, 0).numpy()).max()) <= TOL
    ref_k3 = raster_ref.draw_pass_mask_range(
        jf, jm, 0, n_live, jnp.asarray(masks[1, sl].numpy()),
        jnp.asarray(masks[:, sl].numpy()), y_offset=float(row0))
    assert float(np.abs(np.asarray(ref_k3) - band_k3[0].numpy()).max()) <= TOL


@pytest.mark.parametrize("row0", [64, 96])
def test_k4_at_a_band_origin_is_the_rows_of_the_whole_walk(row0):
    """The plain megakernel over a band (culled, as the kernel walks) equals
    the whole frame's walk on the band's rows bit for bit, on the seeded
    tape whose entries drive every clamp, plane-0 targets included."""
    n_masks = 6
    fields, modes, _atlas = mega_modes_tape(n_masks, seed=row0, w=256, h=128)
    f, m = torch.from_numpy(fields), torch.from_numpy(modes)
    planes = torch.from_numpy(np.random.RandomState(row0).rand(4, 128, 256).astype(np.float32))
    whole_bins = bin_quads_plain(f, 0, f.shape[0], 4, 2, 32, 128)
    whole = mega.draw_pass_mega_plain(f, m, *whole_bins, planes, n_masks, tile_h=32,
                                      cull=True)
    sl = slice(row0, row0 + 32)
    band_bins = bin_quads_plain(f, 0, f.shape[0], 2, 2, 16, 128, row0=row0)
    band = mega.draw_pass_mega(f, m, *band_bins, planes[:, sl].clone(), n_masks,
                               tile_h=16, row0=row0)
    assert torch.equal(band, whole[:, sl])
    culled = mega.draw_pass_mega_plain(f, m, *band_bins, planes[:, sl].contiguous(),
                                       n_masks, tile_h=16, row0=row0)
    assert torch.equal(culled, band)
    before, after, _blocks = mega.block_entries(f, m, *band_bins, 16, 32, 256, row0=row0)
    assert after < before


# --- the banded blur (X6) ---------------------------------------------------------


def _jax_banded_sharded(planes, radius, n):
    """_banded_blur_planar inside its shard_map on default_mesh(n), jitted."""
    mesh = jsh.default_mesh(n)
    body = jsh.shard_map(
        lambda x, r: jsh._banded_blur_planar(x, r, n), mesh=mesh,
        in_specs=(P(None, jsh.ROWS_AXIS, None), P()),
        out_specs=P(None, jsh.ROWS_AXIS, None), check_rep=False)
    return np.asarray(jax.jit(body)(jnp.asarray(planes), jnp.float32(radius)))


def _jax_banded_ops(planes, radius, n):
    """The same function run op by op: vmap over the bands stands for the
    mesh axis (axis_index, ppermute and all_gather on ROWS_AXIS), under
    jax.disable_jit, so XLA fuses no multiply into an add."""
    rows = planes.shape[1]
    stacked = jnp.asarray(planes.reshape(4, n, rows // n, -1).transpose(1, 0, 2, 3))
    with jax.disable_jit():
        out = jax.vmap(lambda x: jsh._banded_blur_planar(x, jnp.float32(radius), n),
                       axis_name=jsh.ROWS_AXIS)(stacked)
    return np.asarray(out).transpose(1, 0, 2, 3).reshape(planes.shape)


@pytest.mark.parametrize("n,rows,radius", [
    (2, 160, 9.0), (4, 272, 18.0),  # the swap path
    (8, 160, 30.0), (8, 96, 64.0)])  # bands under the halo: gather
def test_banded_blur_is_jaxs_bit_for_bit(n, rows, radius):
    """The plain banded blur equals JAX's _banded_blur_planar run op by op
    bit for bit, on both paths and across the frame's bottom edge; the jitted
    shard_map differs from both by XLA's fused multiply-adds only (the
    tolerance of tests/test_torch_blur.py)."""
    rng = np.random.RandomState(n * rows)
    planes = rng.rand(4, rows, 128).astype(np.float32)
    # a bright edge across the frame's bottom rows and a band boundary
    planes[:, rows - 12 :, 30:90] = 1.0
    planes[:, rows // n - 3 : rows // n + 3, :] = 0.0
    band_h = rows // n
    bands = [torch.from_numpy(planes[:, i * band_h : (i + 1) * band_h].copy())
             for i in range(n)]
    radii = [torch.tensor(radius, dtype=torch.float32)] * n
    got = torch.cat(blur.banded_blur_planar(bands, radii), dim=1).numpy()
    want = _jax_banded_ops(planes, radius, n)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(got, _jax_banded_sharded(planes, radius, n), rtol=0,
                               atol=1e-5)
    # one band is the whole-frame blur
    if n == 2:
        single = blur.backdrop_blur_planar_plain(torch.from_numpy(planes), radius).numpy()
        assert np.array_equal(
            torch.cat(blur.banded_blur_planar(
                [torch.from_numpy(planes)], radii[:1]), 1).numpy(), single)


def test_banded_blur_raises_on_mixed_bands():
    a = torch.zeros((4, 8, 128))
    with pytest.raises(ValueError, match="same shape"):
        blur.banded_blur_planar([a, torch.zeros((4, 16, 128))], [1.0, 1.0])


# --- ShardedFigRenderer frames -------------------------------------------------------


def masks_blur_text_scene(pkg="figdraw_tpu"):
    """test_sharded_perf.py's clip masks, backdrop blur and glyph runs that
    straddle band boundaries, as a RendersArray of either package (text
    rows do not travel by to_port: each package typesets its own)."""
    import importlib

    api = importlib.import_module(pkg)
    Fig, FigKind, FigFlags, fill, rect, rgba = (api.Fig, api.FigKind, api.FigFlags,
                                                api.fill, api.rect, api.rgba)
    typeset = importlib.import_module(pkg + ".text.layout").typeset
    faces = importlib.import_module(pkg + ".text.typefaces")
    tid = faces.load_typeface(DEJAVU)
    renders = api.new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 256, 160),
                            fill=fill(rgba(250, 250, 250, 255))))
    clip = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(10, 10, 90, 120),
        corners=(12,) * 4, flags=FigFlags.NfClipContent,
        fill=fill(rgba(220, 220, 240, 255))))
    renders.add_child(0, clip, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, 300, 300),
        fill=fill(rgba(200, 40, 40, 160)), rotation=20.0))
    f = faces.FigFont(typeface_id=tid, size=18.0)
    arr = typeset(api.vec2(140, 120),
                  [(f, fill(rgba(0, 0, 0, 255)), "band AV spanning glyphs")])
    renders.add_root(0, Fig(kind=FigKind.nkText, screen_box=rect(110, 14, 140, 120),
                            text_layout=arr))
    renders.add_root(1, Fig(kind=FigKind.nkBackdropBlur, screen_box=rect(30, 60, 180, 60),
                            backdrop_blur=api.BackdropBlurStyle(blur=9.0),
                            fill=fill(rgba(255, 255, 255, 60))))
    return importlib.import_module(pkg + ".nodesarray").from_renders(renders)


def bottom_blur_scene():
    """Stripes under a backdrop blur that crosses the frame's bottom edge
    and a band boundary (the blur clamps at the padded height n pband)."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 256, 150),
                            fill=fill(rgba(240, 240, 240, 255))))
    for i in range(10):
        renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(4 + i * 25, 60 + (i % 4) * 20, 18, 90),
                                fill=fill(rgba(30 + i * 20, 80, 200 - i * 15, 255))))
    renders.add_root(1, Fig(kind=FigKind.nkBackdropBlur, screen_box=rect(20, 70, 200, 100),
                            backdrop_blur=BackdropBlurStyle(blur=12.0),
                            fill=fill(rgba(255, 255, 255, 40))))
    return from_renders(renders)


def clip_table_scene(rows=10, cols=4):
    """test_sharded_perf.py's sub-clip table (40 clipped cells; the first
    rows x cols of them): the megakernel's route."""
    from figdraw_tpu.nodes import RenderList, Renders

    def rect_fig(box, color, flags=0, corners=0):
        return Fig(kind=FigKind.nkRectangle, screen_box=box, fill=fill(color),
                   corners=(corners,) * 4, flags=flags)

    w, h = 320, 240
    lst = RenderList()
    lst.add_root(rect_fig(rect(0, 0, w, h), rgba(248, 249, 251, 255)))
    vp = lst.add_root(rect_fig(rect(20, 20, w - 40, h - 40), rgba(232, 235, 240, 255),
                               flags=FigFlags.NfClipContent, corners=10))
    for row in range(rows):
        for col in range(cols):
            cell = rect(24 + col * 70, 8 + row * 24, 64, 20)
            ci = lst.add_child(vp, rect_fig(cell, rgba(255, 255, 255, 255),
                                            flags=FigFlags.NfClipContent, corners=4))
            lst.add_child(ci, rect_fig(rect(cell.x - 6, cell.y + 4, cell.w + 12, 14),
                                       rgba(90, 120, 200, 220)))
    scene = Renders()
    scene.set_layer(0, lst)
    return from_renders(scene)


SCENES = {
    "headline": (lambda: from_renders(make_render_tree(256.0, 192.0, frame=4, copies=3)),
                 (256, 192), 64),
    "masks_blur_text": (masks_blur_text_scene, (256, 160), 256),
    "bottom_blur": (bottom_blur_scene, (256, 150), 64),
    "clip_table": (lambda: clip_table_scene(3, 3), (320, 240), 64),
}


def port_scene(name):
    if name == "masks_blur_text":
        return masks_blur_text_scene("figdraw_tpu_torch")
    return to_port(SCENES[name][0]())


def _jax_sharded(name, n):
    make, (w, h), atlas = SCENES[name]
    jr = jsh.ShardedFigRenderer(jsh.default_mesh(n), atlas_size=atlas, use_pallas=False)
    return np.asarray(jr.render_frame(make(), jax_vec2(w, h)))


@pytest.mark.parametrize("name,n", [
    ("headline", 4), ("masks_blur_text", 8), ("bottom_blur", 2), ("clip_table", 4)])
def test_sharded_frames_match_jax_and_one_device(name, n):
    make, (w, h), atlas = SCENES[name]
    sr = ShardedFigRenderer(cpu_mesh(n), atlas_size=atlas)
    got = sr.render_frame(port_scene(name), port.vec2(w, h))
    assert tuple(got.shape) == (h, w, 4) and got.device == CPU
    assert sr.uploads == 1  # one upload a distinct device
    if name == "clip_table":
        assert sr.last_plan_kind == "mega"
    want = _jax_sharded(name, n)
    assert float(np.abs(got.numpy() - want).max()) <= TOL
    one = port.FigRenderer(atlas_size=atlas, device="cpu").render_frame(
        port_scene(name), port.vec2(w, h))
    assert np.abs(_u8(got) - _u8(one)).max() <= 1


def jax_grid(n_boxes, w, h):
    """bench_retained.build_grid's scene (rounded, rotated, translucent
    boxes, a root each) on a w x h frame."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(24, 26, 34, 255))))
    cols = max(int((n_boxes * w / h) ** 0.5), 1)
    rows = (n_boxes + cols - 1) // cols
    cw, ch = w / cols, h / rows
    for i in range(n_boxes):
        r, c = divmod(i, cols)
        renders.add_root(0, Fig(
            kind=FigKind.nkRectangle,
            screen_box=rect(c * cw + 2, r * ch + 2, cw - 4, ch - 4),
            corners=(4,) * 4, rotation=(i * 7) % 23 - 11,
            fill=fill(rgba((i * 37) % 255, (i * 91) % 255, 200, 155))))
    return from_renders(renders)


def test_a_fringe_past_the_bbox_follows_the_tile_layout_in_both_packages():
    """A rotated box's antialiased fringe reaches past the bbox the walk
    gives it, and every renderer bins by bbox, so such pixels follow the
    tile layout. On bench_retained's grid (480x272, 600 boxes, 4 bands)
    JAX's ShardedFigRenderer (Pallas, 8-row tiles at each band origin)
    differs from its one-device renderer at such pixels, and the port's
    sharded frame (band_tiles at each origin) from its FigRenderer at
    others; at every pixel past 1/255 in either package the difference is
    within chip_smoke.layout_fringe's bound, the alpha of the quads the two
    layouts bin differently there, and there are at most FRINGE_CAP."""
    import chip_smoke
    from figdraw_tpu import FigRenderer as JaxRenderer
    from figdraw_tpu_torch.ops.binning import unpack_combo_plain
    from figdraw_tpu_torch.plan import meta_rows

    w, h, n = 480, 272, 4
    arr = jax_grid(600, w, h)
    one = np.asarray(JaxRenderer(atlas_size=64, use_pallas=True).render_frame(
        arr, jax_vec2(w, h)))
    jr = jsh.ShardedFigRenderer(jsh.default_mesh(n), atlas_size=64, use_pallas=True)
    banded = np.asarray(jr.render_frame(arr, jax_vec2(w, h)))
    assert jr.use_pallas, "JAX's sharded renderer left its Pallas kernels"

    ren = port.FigRenderer(atlas_size=64, device="cpu")
    size = port.vec2(w, h)
    plan = ren._walk_plan(to_port(arr), size, True, port.Color(1.0, 1.0, 1.0, 1.0))
    kinds = [item[0] for item in plan.structure]
    tail = meta_rows(kinds.count("draw"), kinds.count("blur"), plan.combo.shape[1])
    fields, modes = unpack_combo_plain(torch.from_numpy(plan.combo[:-tail]))
    port_one = ren.render_frame(to_port(arr), size).numpy()
    port_banded = ShardedFigRenderer(cpu_mesh(n), atlas_size=64).render_frame(
        to_port(arr), size).numpy()
    assert float(np.abs(port_one - one).max()) <= TOL  # the same one-device frame

    pband = band_geometry(n, h, w)[3]
    layouts = {"jax": (banded, jsh.SHARD_TILE_H, pband),
               "port": (port_banded, band_tiles(pband, plan.tile_h)[0], pband)}
    for who, (frame, th, pb) in layouts.items():
        diff = np.abs(frame - one).max(-1)
        ys, xs = np.nonzero(diff > TOL)
        assert 0 < len(ys) <= chip_smoke.FRINGE_CAP, (who, len(ys))
        bound = chip_smoke.layout_fringe(fields, modes, ys, xs,
                                         chip_smoke.tile_rows(ys, plan.tile_h),
                                         chip_smoke.tile_rows(ys, th, pb))
        assert (bound > 0).all() and (diff[ys, xs] <= bound + TOL).all(), (
            who, diff[ys, xs], bound)
        assert diff.max() > 0.1, who  # a fringe's alpha, not rounding


def test_sharded_megakernel_runs_one_walk_a_band(monkeypatch):
    """The sub-clip table takes the megakernel: one front end and one K4 a
    band, at each band's origin."""
    calls, fronts = [], []

    def spy(*a, **k):
        calls.append(k["row0"])
        return mega.draw_pass_mega(*a, **k)

    real_front = sharding.executor.decode_and_bin

    def front(*a, **k):
        fronts.append(k["row0"])
        return real_front(*a, **k)

    want = port.FigRenderer(atlas_size=64, device="cpu").render_frame(
        to_port(clip_table_scene()), port.vec2(320, 240))
    monkeypatch.setattr(sharding.executor, "decode_and_bin", front)
    sr = ShardedFigRenderer(cpu_mesh(4), atlas_size=64)
    ren = sr._flattener
    plan = ren._walk_plan(to_port(clip_table_scene()), port.vec2(320, 240), True,
                          port.Color(1.0, 1.0, 1.0, 1.0))
    assert plan.mega_combo is not None
    got = sr._run(plan, sr._upload(plan.mega_combo), draws=dict(draw=spy))
    assert calls == fronts == [0, 64, 128, 192]
    assert np.abs(_u8(got) - _u8(want)).max() <= 1


def test_execute_takes_a_tape():
    arr = to_port(clip_table_scene())
    sr = ShardedFigRenderer(cpu_mesh(2), atlas_size=64)
    tape = sr._flattener.flatten(arr, port.vec2(320, 240))
    assert plan_execution(tape).mega_combo is not None
    got = sr.execute(tape)
    want = port.FigRenderer(atlas_size=64, device="cpu").render_frame(arr, port.vec2(320, 240))
    assert np.abs(_u8(got) - _u8(want)).max() <= 1


# --- frame-parallel rendering ------------------------------------------------------


@pytest.mark.parametrize("scene,size,frames,chunk", [
    ("simple", (160, 128), 11, 2), ("clip", (224, 160), 5, 1), ("blur", (160, 128), 3, 4)])
def test_render_batch_over_a_mesh_equals_render_frame(scene, size, frames, chunk):
    make = {"simple": jbatch.simple_scene, "clip": jbatch.clip_scene,
            "blur": jbatch.blur_scene}[scene]
    fs = port.vec2(*size)
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    out = ren.render_batch([to_port(make(f)) for f in range(frames)], fs, chunk=chunk,
                           mesh=cpu_mesh(4, FRAMES_AXIS))
    assert tuple(out.shape) == (frames, size[1], size[0], 4)
    ref = port.FigRenderer(atlas_size=64, device="cpu")
    for f in range(frames):
        assert torch.equal(out[f], ref.render_frame(to_port(make(f)), fs)), f


def test_render_batch_mesh_of_another_device_type_raises():
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    with pytest.raises(ValueError, match="mesh of cuda devices"):
        ren.render_batch([to_port(jbatch.simple_scene(0))], port.vec2(160, 128),
                         mesh=Mesh((torch.device("cuda", 0),), FRAMES_AXIS))
