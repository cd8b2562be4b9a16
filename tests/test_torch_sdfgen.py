"""The port's SDF generation (figdraw_tpu_torch/utils/sdfgen.py) against
figdraw_tpu's: bit-equal float32 SDFs, and the MSDF image modes through
render_frame within 1/255 of figdraw_tpu's frames. Twins of
tests/test_images.py's test_sdf_from_coverage_circle,
test_generated_glyph_sdf_renders_scaled, test_msdf_mode_renders_circle and
test_mtsdf_and_annular_msdf_render, the last node for node (its MTSDF
node sets msdf_image, which an nkMtsdfImage does not read, in both
packages: scenes.make_mtsdf_scene draws all four modes)."""

import numpy as np
import pytest
import torch

import figdraw_tpu as jax_pkg
import figdraw_tpu_torch as port
from figdraw_tpu.utils import sdfgen as jsdf
from figdraw_tpu_torch.scenes import star_coverage, synthetic_msdf
from figdraw_tpu_torch.utils import sdfgen as sdf
from torch_reference import DEJAVU

torch.set_num_threads(1)

TOL = 1.0 / 255.0


def _circle(size=48, radius=15.0):
    yy, xx = np.mgrid[0:size, 0:size]
    d = np.sqrt((xx + 0.5 - size / 2) ** 2 + (yy + 0.5 - size / 2) ** 2)
    return np.clip(radius - d + 0.5, 0.0, 1.0), d


def test_sdf_from_coverage_circle():
    """The generated SDF matches the analytic circle distance away from
    the edges, and equals figdraw_tpu's bit for bit."""
    size, radius, px_range = 48, 15.0, 8.0
    coverage, d = _circle(size, radius)
    out = sdf.sdf_from_coverage(coverage, px_range=px_range)
    assert out.dtype == np.float32 and out.shape == (size, size, 4)
    assert out.tobytes() == jsdf.sdf_from_coverage(coverage, px_range=px_range).tobytes()
    got_sd = (out[..., 0] - 0.5) * px_range
    true_sd = radius - d
    sel = np.abs(true_sd) < px_range / 2 - 1
    assert np.abs(got_sd - true_sd)[sel].max() < 0.75


@pytest.mark.parametrize("case", ["star", "random", "padded", "empty", "full"])
def test_sdfs_are_bit_equal(case):
    rng = np.random.default_rng(5)
    pad = 0
    if case == "star":
        cov, px = star_coverage(), 8.0
    elif case == "random":
        cov, px = rng.random((23, 37)).astype(np.float32), 4.0
    elif case == "padded":
        cov, px, pad = _circle(20, 6.0)[0], 3.0, 4
    elif case == "empty":
        cov, px = np.zeros((9, 14), np.float32), 4.0
    else:
        cov, px = np.ones((9, 14), np.float32), 4.0
    a = sdf.sdf_from_coverage(cov, px_range=px, pad=pad)
    b = jsdf.sdf_from_coverage(cov, px_range=px, pad=pad)
    assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    mask = cov >= 0.5
    assert sdf.distance_transform(mask).tobytes() == jsdf.distance_transform(mask).tobytes()


def _glyph_sdfs():
    from figdraw_tpu.text.typefaces import get_typeface as jget, load_typeface as jload
    from figdraw_tpu_torch.text.typefaces import bundled_font_path, get_typeface, load_typeface

    tf = get_typeface(load_typeface(bundled_font_path()))
    jtf = jget(jload(DEJAVU))
    return (sdf.glyph_sdf(tf, tf.glyph_id(ord("O")), size=24.0, px_range=4.0),
            jsdf.glyph_sdf(jtf, jtf.glyph_id(ord("O")), size=24.0, px_range=4.0))


def _frame_pair(build, image_id, image, size, atlas_size):
    """The same scene (build(package)) with `image` published under
    image_id, rendered by the port on the CPU and by figdraw_tpu
    (use_pallas=False): (port frame, figdraw_tpu frame) as arrays."""
    out = []
    for pk in (port, jax_pkg):
        bus = pk.ImageMessageBus()
        if pk is port:
            ren = port.FigRenderer(atlas_size=atlas_size, device="cpu")
        else:
            ren = jax_pkg.FigRenderer(atlas_size=atlas_size, use_pallas=False)
        ren.ensure_image_message_subscription(bus)
        pk.put_image(image_id, image, bus=bus)
        frame = ren.render_frame(build(pk), pk.vec2(*size))
        out.append(np.asarray(frame.numpy() if pk is port else frame))
    return out


def test_generated_glyph_sdf_renders_scaled():
    """A glyph SDF through nkMsdfImage, crisp at 3x the raster size: the
    SDF and its offset equal figdraw_tpu's bit for bit, the frame within
    1/255 of figdraw_tpu's, and the big "O" ring is drawn with its hole."""
    (sdf_img, offset), (jimg, joffset) = _glyph_sdfs()
    assert offset == joffset and sdf_img.tobytes() == jimg.tobytes()
    h0, w0 = sdf_img.shape[:2]

    def build(pk):
        from figdraw_tpu_torch.nodes import RenderList as PL
        from figdraw_tpu.nodes import RenderList as JL

        lst = (PL if pk is port else JL)()
        lst.add_root(pk.Fig(kind=pk.FigKind.nkRectangle, screen_box=pk.rect(0, 0, 120, 120),
                            fill=pk.fill(pk.rgba(255, 255, 255, 255))))
        lst.add_root(pk.Fig(kind=pk.FigKind.nkMsdfImage,
                            screen_box=pk.rect(10, 10, w0 * 3, h0 * 3),
                            msdf_image=pk.MsdfImageStyle(id=777, fill=pk.fill(pk.rgba(0, 0, 0, 255)),
                                                         px_range=4.0)))
        r = pk.new_renders()
        r.set_layer(0, lst)
        return r

    got, want = _frame_pair(build, 777, sdf_img, (120, 120), 128)
    assert np.abs(got - want).max() <= TOL
    img = np.clip(np.round(got * 255), 0, 255).astype(np.uint8)
    dark = img[..., 0] < 100
    assert dark.sum() > 300
    ys, xs = np.nonzero(dark)
    assert img[int(ys.mean()), int(xs.mean()), 0] > 200


@pytest.mark.parametrize("stroke", [0.0, 2.0])
def test_msdf_mode_renders_circle(stroke):
    """The synthetic circle through nkMsdfImage, solid (mode 13) and
    annular (mode 15): within 1/255 of figdraw_tpu; a dark centre, or a
    hollow one for the ring."""
    def build(pk):
        from figdraw_tpu_torch.nodes import RenderList as PL
        from figdraw_tpu.nodes import RenderList as JL

        lst = (PL if pk is port else JL)()
        lst.add_root(pk.Fig(kind=pk.FigKind.nkMsdfImage, screen_box=pk.rect(16, 16, 32, 32),
                            msdf_image=pk.MsdfImageStyle(id=99, fill=pk.fill(pk.rgba(0, 0, 0, 255)),
                                                         px_range=4.0, stroke_weight=stroke)))
        r = pk.new_renders()
        r.set_layer(0, lst)
        return r

    got, want = _frame_pair(build, 99, synthetic_msdf(), (64, 64), 64)
    assert np.abs(got - want).max() <= TOL
    img = np.clip(np.round(got * 255), 0, 255).astype(np.uint8)
    if stroke:
        assert img[32, 32, 0] > 200  # hollow centre
    else:
        assert img[32, 32, 0] < 50  # centre: the glyph colour
        assert img[18, 18, 0] > 200  # the quad's corner: background


def test_mtsdf_and_annular_msdf_render():
    """test_images.py's scene node for node (its nkMtsdfImage sets
    msdf_image, so neither package draws it) within 1/255 of figdraw_tpu,
    with its assertions: the disc's pixel stays the background's, the ring's
    centre is background, the ring row holds red ink."""
    def build(pk):
        from figdraw_tpu_torch.nodes import RenderList as PL
        from figdraw_tpu.nodes import RenderList as JL

        lst = (PL if pk is port else JL)()
        lst.add_root(pk.Fig(kind=pk.FigKind.nkRectangle, screen_box=pk.rect(0, 0, 200, 100),
                            fill=pk.fill(pk.rgba(250, 250, 250, 255))))
        lst.add_root(pk.Fig(kind=pk.FigKind.nkMtsdfImage, screen_box=pk.rect(10, 20, 64, 64),
                            msdf_image=pk.MsdfImageStyle(id=98, fill=pk.fill(pk.rgba(20, 60, 200, 255)),
                                                         px_range=4.0)))
        lst.add_root(pk.Fig(kind=pk.FigKind.nkMsdfImage, screen_box=pk.rect(110, 20, 64, 64),
                            msdf_image=pk.MsdfImageStyle(id=98, fill=pk.fill(pk.rgba(200, 40, 40, 255)),
                                                         px_range=4.0, stroke_weight=2.0)))
        r = pk.new_renders()
        r.set_layer(0, lst)
        return r

    got, want = _frame_pair(build, 98, synthetic_msdf(), (200, 100), 64)
    assert np.abs(got - want).max() <= TOL
    ref = np.clip(np.round(got * 255), 0, 255).astype(np.uint8)
    assert ref[52, 42, 2] > 150
    assert (ref[52, 42, :3] == 250).all()  # the MTSDF node drew nothing
    cx = ref[52, 142]
    assert cx[0] > 200 and cx[1] > 200
    row = ref[52, 110:174]
    assert ((row[:, 0] > 150) & (row[:, 1] < 120)).any()
