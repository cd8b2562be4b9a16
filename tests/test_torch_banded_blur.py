"""The banded blur X6 of figdraw_tpu_torch on the CPU (ops/blur.py
`band_table`, `banded_blur_table_plain`, `banded_blur_planar(out=)`).

X6's kernels read a table that `band_table` builds: for each device (here
stand-in keys) the scratch layout of its bands' horizontal pass, the copies
of rows from bands on other devices, and each band's line in the plain
version's coordinates. These tests hold that table to what the plain banded
blur concatenates or gathers, run the table through the plain passes
(`banded_horizontal_plain`, `banded_vertical_plain`) bit for bit against
`banded_blur_planar_plain`, and pin why X6 is not X1 on the concatenated
bands: the plain banded blur (which equals JAX's `_banded_blur_planar` run
op by op, tests/test_torch_sharding.py) repeats the edge row above the
frame's top where X1's lerp reads row 1, and rounds its tap positions in
the extended band's coordinates."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from figdraw_tpu.parallel import sharding as jsh
from figdraw_tpu_torch import BackdropBlurStyle, Fig, FigKind, fill, new_renders, rect, rgba, vec2
from figdraw_tpu_torch.nodesarray import from_renders
from figdraw_tpu_torch.ops import blur
from figdraw_tpu_torch.parallel import sharding
from figdraw_tpu_torch.parallel.sharding import Mesh, ShardedFigRenderer

torch.set_num_threads(1)  # see tests/test_torch_render_frame.py

HALO = blur.BLUR_HALO
CPU = torch.device("cpu")

# device patterns over n bands, as stand-in keys: one device; contiguous
# halves ([a, a, b, b]); alternating ([a, b, a, b]); four devices dealt
# round robin ([a, b, c, d])
PATTERNS = {
    "one": lambda n: ["a"] * n,
    "halves": lambda n: ["ab"[i * 2 // n] for i in range(n)],
    "alternate": lambda n: ["ab"[i % 2] for i in range(n)],
    "four": lambda n: ["abcd"[i % 4] for i in range(n)],
}


def _origins(groups, pband):
    """For each group, the (band, row) whose horizontal pass each scratch
    row holds: the group's own slots, then the rows copied from other
    groups (which must be those groups' own rows)."""
    own = []
    for g in groups:
        rows = [None] * g.rows
        for i, slot in zip(g.bands, g.slots):
            rows[slot : slot + pband] = [(i, j) for j in range(pband)]
        own.append(rows)
    got = [list(rows) for rows in own]
    for k, g in enumerate(groups):
        for cp in g.copies:
            assert cp.src != k
            src = own[cp.src][cp.src_row : cp.src_row + cp.rows]
            assert None not in src and len(src) == cp.rows
            got[k][cp.dst_row : cp.dst_row + cp.rows] = src
    assert all(None not in rows for rows in got)
    return got


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 24])
@pytest.mark.parametrize("pband", [48, 272])  # under the halo: gather; over: swap
def test_band_table_resolves_the_plain_rows(n, pattern, pband):
    """Each band's line resolves, through the scratch, to the rows the plain
    version concatenates (its neighbours' halo rows or its own edge row
    repeated, swap path) or gathers (every band, gather path), at the
    plain version's coordinates; copies run only between different devices,
    one a neighbour edge (swap) or a band of another device (gather)."""
    keys = PATTERNS[pattern](n)
    groups = blur.band_table(keys, pband)
    assert [g.key for g in groups] == list(dict.fromkeys(keys))
    assert sorted(i for g in groups for i in g.bands) == list(range(n))
    origins = _origins(groups, pband)
    gather = n == 1 or HALO >= pband
    for k, g in enumerate(groups):
        assert all(keys[i] == g.key for i in g.bands)
        assert [line.band for line in g.lines] == list(g.bands)
        for line in g.lines:
            i = line.band
            got = [origins[k][t] for t in blur.line_rows(line)]
            if gather:
                want = [(b, j) for b in range(n) for j in range(pband)]
                assert (line.origin, line.n, line.radius) == (i * pband, n * pband, g.bands[0])
            else:
                top = ([(i - 1, pband - HALO + t) for t in range(HALO)] if i > 0
                       else [(i, 0)] * HALO)
                bot = ([(i + 1, t) for t in range(HALO)] if i < n - 1
                       else [(i, pband - 1)] * HALO)
                want = top + [(i, j) for j in range(pband)] + bot
                assert (line.origin, line.n, line.radius) == (HALO, pband + 2 * HALO, i)
            assert got == want
        if gather:
            edges = sum(keys[j] != g.key for j in range(n))
        else:
            edges = sum((i > 0 and keys[i - 1] != keys[i]) + (i < n - 1 and keys[i + 1] != keys[i])
                        for i in g.bands)
        assert len(g.copies) == edges
    if pattern == "one":
        assert blur.copy_bytes(groups, 4, 128) == 0


def _bands(n, pband, pw, seed, kh=None):
    """n bands of pband rows of a seeded frame (bright stripes across the
    band boundaries and the frame's bottom rows), each the first pband rows
    of (4, kh, pw) planes whose extra rows hold other values."""
    rng = np.random.RandomState(seed)
    frame = rng.rand(4, n * pband, pw).astype(np.float32)
    frame[:, n * pband - 12 :, pw // 4 : pw // 2] = 1.0
    frame[:, pband - 3 : pband + 3] = 0.0
    kh = kh or pband
    bands = []
    for i in range(n):
        planes = torch.from_numpy(rng.rand(4, kh, pw).astype(np.float32) * 7.0)
        planes[:, :pband] = torch.from_numpy(frame[:, i * pband : (i + 1) * pband])
        bands.append(planes[:, :pband])
    return frame, bands


def _equal(got, want):
    return all(torch.equal(a.view(torch.int32), b.contiguous().view(torch.int32))
               for a, b in zip(got, want))


@pytest.mark.parametrize("pattern", ["one", "alternate", "four"])
@pytest.mark.parametrize("radius", [18.0, 17.3, 13.7, 64.0])
@pytest.mark.parametrize("n,pband", [(4, 72), (8, 16)])  # swap, gather
def test_table_through_the_plain_passes_is_plain(n, pband, radius, pattern):
    """The plain twins of X6's passes, through band_table, equal
    banded_blur_planar_plain bit for bit on both paths, at dyadic and
    non-dyadic radii and over every device pattern."""
    _frame, bands = _bands(n, pband, 24, seed=n * pband + int(radius * 10))
    radii = [torch.tensor(radius)] * n
    want = blur.banded_blur_planar_plain(bands, radii)
    got = blur.banded_blur_table_plain(bands, radii, keys=PATTERNS[pattern](n))
    assert _equal(got, want)


@pytest.mark.parametrize("n,pband,kh", [(3, 72, 80), (6, 16, 32), (1, 40, 48)])
def test_taller_planes_and_out_views(n, pband, kh):
    """Bands that are the first pband rows of taller planes, blurred into
    the first pband rows of taller outputs (the sharded executor's backdrop
    views): the table route and banded_blur_planar(out=) write exactly the
    plain result there and leave the other rows and the inputs alone; per
    band radii that differ take each band's own (and, gathered, the device's
    first band's, as the plain version)."""
    _frame, bands = _bands(n, pband, 20, seed=kh, kh=kh)
    before = [b.clone() for b in bands]
    radii = [torch.tensor(9.0 + 4.3 * i) for i in range(n)]
    want = blur.banded_blur_planar_plain(bands, radii)
    for route in ("table", "planar"):
        backdrops = [torch.full((4, kh, 20), -1.0) for _ in range(n)]
        out = [b[:, :pband] for b in backdrops]
        got = (blur.banded_blur_table_plain(bands, radii, out=out)
               if route == "table" else blur.banded_blur_planar(bands, radii, out=out))
        assert all(g is o for g, o in zip(got, out))
        assert _equal(got, want)
        assert all(bool((b[:, pband:] == -1.0).all()) for b in backdrops)
    assert _equal(bands, before)


def _jax_banded_ops(planes, radius, n):
    """JAX's _banded_blur_planar run op by op (vmap over the bands stands for
    the mesh axis; tests/test_torch_sharding.py)."""
    rows = planes.shape[1]
    stacked = jnp.asarray(planes.reshape(4, n, rows // n, -1).transpose(1, 0, 2, 3))
    with jax.disable_jit():
        out = jax.vmap(lambda x: jsh._banded_blur_planar(x, jnp.float32(radius), n),
                       axis_name=jsh.ROWS_AXIS)(stacked)
    return np.asarray(out).transpose(1, 0, 2, 3).reshape(planes.shape)


@pytest.mark.parametrize("radius,rows_differ", [(18.0, "top"), (17.3, "most")])
def test_x6_is_not_x1_on_the_whole_frame(radius, rows_differ):
    """On a (4, 1088, 32) frame in 4 bands of 272 rows the banded blur
    differs from the whole-frame blur: at r = 18 only in the frame's top rows
    (a banded blur repeats row 0 above the frame, where X1's lerp takes its
    second texel at clamp(i0 + 1) = row 1), at r = 17.3 in most rows (the tap
    positions round differently at extended-band row 65 + j than at frame row
    272 i + j). The table route equals JAX's _banded_blur_planar all the
    same: bit for bit at r = 18, within 1e-6 at r = 17.3, where XLA's exp
    and torch's round some of the 17 weights an ulp apart."""
    n, pband = 4, 272
    frame, bands = _bands(n, pband, 32, seed=int(radius * 10))
    radii = [torch.tensor(radius)] * n
    got = torch.cat(blur.banded_blur_table_plain(bands, radii), dim=1).numpy()
    whole = blur.backdrop_blur_planar_plain(torch.from_numpy(frame), radius).numpy()
    rows = np.nonzero((got.view(np.int32) != whole.view(np.int32)).any(axis=(0, 2)))[0]
    if rows_differ == "top":
        assert len(rows) and rows.max() < radius
    else:
        assert len(rows) > n * pband // 2
    want = _jax_banded_ops(frame, radius, n)
    if radius == 18.0:
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("radius", [18.0, 17.3, 64.0])
def test_gather_path_is_the_whole_frame_blur(radius):
    """On the gather path (24 bands of 48 rows) every band reads the frame's
    own rows at the frame's coordinates, so the banded blur is the
    whole-frame blur bit for bit."""
    n, pband = 24, 48
    frame, bands = _bands(n, pband, 16, seed=int(radius))
    radii = [torch.tensor(radius)] * n
    got = torch.cat(blur.banded_blur_table_plain(bands, radii), dim=1).numpy()
    whole = blur.backdrop_blur_planar_plain(torch.from_numpy(frame), radius).numpy()
    assert np.array_equal(got.view(np.int32), whole.view(np.int32))


def test_the_kernel_route_takes_only_cards():
    """X6's kernel route raises on CPU bands (the CPU takes the plain
    version through banded_blur_planar), and a group's bands must share a
    device."""
    _frame, bands = _bands(2, 72, 8, seed=1)
    with pytest.raises(ValueError, match="on a card"):
        blur.banded_blur_kernels(bands, [1.0, 1.0], ["a", "b"])
    with pytest.raises(ValueError, match="several types"):
        blur.banded_blur_planar([bands[0], bands[1].to("meta")], [1.0, 1.0])


def _blur_scene():
    """Stripes under a backdrop blur that crosses band boundaries."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 256, 150),
                            fill=fill(rgba(240, 240, 240, 255))))
    for i in range(10):
        renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(4 + i * 25, 40 + (i % 4) * 20, 18, 90),
                                fill=fill(rgba(30 + i * 20, 80, 200 - i * 15, 255))))
    renders.add_root(1, Fig(kind=FigKind.nkBackdropBlur, screen_box=rect(20, 30, 200, 100),
                            backdrop_blur=BackdropBlurStyle(blur=12.0),
                            fill=fill(rgba(255, 255, 255, 40))))
    return from_renders(renders)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_executor_blurs_in_place(n, monkeypatch):
    """The sharded frame executor hands X6 each band's rows [0, pband) as
    views of its planes and the first pband rows of its backdrop as `out`
    (no copy of a band on the way in or out), and its frame is the one-device
    frame's within 1/255."""
    seen = []
    real = sharding.banded_blur_planar

    def spy(bands, radii, *a, out=None, **k):
        seen.append((bands, out))
        return real(bands, radii, *a, out=out, **k)

    monkeypatch.setattr(sharding, "banded_blur_planar", spy)
    scene = _blur_scene()
    sr = ShardedFigRenderer(Mesh((CPU,) * n), atlas_size=64)
    got = sr.render_frame(scene, vec2(256, 150))
    assert len(seen) == 1
    bands, out = seen[0]
    assert out is not None and len(out) == len(bands) == n
    for b, o in zip(bands, out):
        assert b._base is not None and o._base is not None
        assert b.shape == o.shape and b.data_ptr() != o.data_ptr()
    from figdraw_tpu_torch import FigRenderer

    want = FigRenderer(atlas_size=64, device="cpu").render_frame(scene, vec2(256, 150))
    assert float((got - want).abs().max()) <= 1.0 / 255.0
