"""ops/rows.py of figdraw_tpu_torch against figdraw_tpu.executor on the CPU:
`view_rows`, `animate_rows` and the damage clip of
`get_partial_patch_view_runner`, on seeded packed buffers with live, empty,
padded and meta rows.

Tolerances: int32 views equal for integer cameras and for integer
translations and power-of-two scales (every product and sum is exact or
rounded once in the same order); at most 1 ulp in the geometry columns
otherwise (XLA may fuse a multiply-add); every lane outside the geometry
columns, every dead row and the meta tail byte-identical always."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import figdraw_tpu.executor as jex
import figdraw_tpu_torch as port
from figdraw_tpu_torch.ops import rows
from figdraw_tpu_torch.scenes import make_clip_table_scene, make_render_tree_array

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

GEOMETRY = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 42, 43, 44, 46, 47, 48)
OTHER = [c for c in range(52) if c not in GEOMETRY]
ROOTS = 6


def _combo(kind, seed):
    """(combo, n_quads, live quad count): a real tape's packed rows (the
    rect-mask table fills the rect-mask columns, the headline scene has
    shadows, strokes and gradients) with seeded dead rows, NaN-patterned
    colour words and its own meta tail of bitcast draw bounds."""
    pr = port.FigRenderer(device="cpu")
    scene = (make_clip_table_scene("rectmask", 320, 200, 12, 6) if kind == "rectmask"
             else make_render_tree_array(384, 216, seed, copies=10))
    size = port.vec2(320, 200) if kind == "rectmask" else port.vec2(384, 216)
    tape = pr.flatten(scene, size, cull=False, record_spans=True)
    combo = tape.combo.copy()
    rng = np.random.RandomState(seed)
    dead = rng.choice(tape.count, 6, replace=False)
    combo[dead[:3], 6:10] = (2e9, 2e9, -2e9, -2e9)  # inert rows
    combo[dead[3:], 8] = combo[dead[3:], 6]  # zero-width bboxes
    words = combo[:, 16:22].view(np.uint32)
    words[rng.choice(tape.count, 8, replace=False), rng.randint(0, 6, 8)] = 0xFFC00001
    lanes = combo[:, 50:52].view(np.int32)
    lanes[rng.choice(tape.count, 4, replace=False), 1] = -1  # a NaN pattern
    return combo, tape.combo_quads, tape.count


def _ridx(n, seed):
    return np.random.RandomState(seed).randint(-1, ROOTS, size=n).astype(np.int32)


def _table(kind):
    t = np.zeros((ROOTS + 1, 6), np.float32)
    t[:, 0] = t[:, 3] = 1.0
    if kind == "exact":  # integer translations, power-of-two scales
        t[0] = (1, 0, 0, 1, 12, -9)
        t[1] = (2, 0, 0, 2, 4, 8)
        t[2] = (0.5, 0, 0, 0.25, -3, 5)
        t[3] = (4, 0, 0, 1, 0, 0)
    else:  # rotations, shears, fractions
        t[0] = (0.9, 0.3, -0.3, 0.9, 2.5, 1.5)
        t[1] = (1.25, 0.1, 0.2, 0.8, -7.75, 3.125)
        t[2] = (-1, 0, 0, 1, 300.5, 0)
        t[3] = (0.3, -0.7, 0.7, 0.3, 11.1, -4.9)
    return t


def _ordered(a):
    """float32 bit patterns as integers that order like the floats."""
    i = a.view(np.int32).astype(np.int64)
    return np.where(i < 0, np.int64(-0x80000000) - i, i)


def _assert_rows(got, ref, combo, n_quads, exact):
    got_i, ref_i, in_i = (a.view(np.int32) for a in (got, ref, combo))
    assert got.shape == ref.shape == combo.shape
    # lanes the transforms never touch, and the meta tail, are the input's
    assert np.array_equal(got_i[:, OTHER], in_i[:, OTHER])
    assert np.array_equal(got_i[n_quads:], in_i[n_quads:])
    assert np.array_equal(ref_i[:, OTHER], in_i[:, OTHER])
    if exact:
        assert np.array_equal(got_i, ref_i)
        return
    ulp = np.abs(_ordered(got[:, GEOMETRY]) - _ordered(ref[:, GEOMETRY]))
    assert ulp.max() <= 1, ulp.max()


CAMERAS = [((0.0, 0.0), 1.0, True), ((9.0, -7.0), 1.0, True),
           ((-13.0, 11.0), 2.0, True), ((5.0, 3.0), 4.0, True),
           ((4.0, -6.0), 0.5, True), ((0.5, 0.25), 1.5, False),
           ((-13.3, 11.7), 0.75, False), ((100.1, -50.9), 3.3, False)]


@pytest.mark.parametrize("kind", ["rectmask", "headline"])
@pytest.mark.parametrize("d,z,exact", CAMERAS)
def test_view_rows_matches_jax(kind, d, z, exact):
    combo, n, count = _combo(kind, 1)
    ref = np.asarray(jex.view_rows(jnp.asarray(combo), jnp.asarray(np.float32(d)),
                                   jnp.float32(z), n))
    got = rows.view_rows(torch.from_numpy(combo), d, z, n).numpy()
    _assert_rows(got, ref, combo, n, exact)
    dead = ~((combo[:n, 8] > combo[:n, 6]) & (combo[:n, 9] > combo[:n, 7]))
    assert dead.sum() >= 6 + (n - count)  # seeded dead rows and the padding
    assert np.array_equal(got.view(np.int32)[:n][dead], combo.view(np.int32)[:n][dead])
    if (d, z) != ((0.0, 0.0), 1.0):
        assert not np.array_equal(got[:n][~dead][:, 4:10], combo[:n][~dead][:, 4:10])


@pytest.mark.parametrize("kind", ["rectmask", "headline"])
@pytest.mark.parametrize("table_kind", ["exact", "general"])
def test_animate_rows_matches_jax(kind, table_kind):
    combo, n, _count = _combo(kind, 2)
    table, ridx = _table(table_kind), _ridx(n, 3)
    ref = np.asarray(jex.animate_rows(jnp.asarray(combo), jnp.asarray(table),
                                      jnp.asarray(ridx), n))
    got = rows.animate_rows(torch.from_numpy(combo), torch.from_numpy(table),
                            torch.from_numpy(ridx), n).numpy()
    _assert_rows(got, ref, combo, n, table_kind == "exact")
    still = ~((combo[:n, 8] > combo[:n, 6]) & (combo[:n, 9] > combo[:n, 7])
              & (ridx >= 0)) | (ridx >= 4)  # dead, in no span, or identity
    assert np.array_equal(got.view(np.int32)[:n][still],
                          combo.view(np.int32)[:n][still])
    assert not np.array_equal(got[:n][~still][:, 4:10], combo[:n][~still][:, 4:10])


def _jax_partial(combo, n, rects, d, z, height=40, width=64):
    """(the rows JAX's damage-clipped runner hands its executor, the pixels
    it takes from the new frame): get_partial_patch_view_runner run eagerly
    with a stand-in executor that records its rows and draws zeros over a
    previous frame of ones."""
    seen = {}

    def run(viewed):
        seen["rows"] = np.asarray(viewed)
        return jnp.zeros((height, width, 4), jnp.float32)

    packed = np.concatenate([combo[:1], np.zeros((1, 1), np.float32)], axis=1)
    with jax.disable_jit():
        ppv = jex.get_partial_patch_view_runner.__wrapped__(run, n, 1)
        frame, _ = ppv(jnp.asarray(combo), jnp.asarray(packed), jnp.asarray(rects),
                       jnp.asarray(np.float32(d)), jnp.float32(z),
                       jnp.ones((height, width, 4), jnp.float32))
    return seen["rows"], np.asarray(frame)[..., 0] == 0.0


@pytest.mark.parametrize("d,z,exact", [CAMERAS[0], CAMERAS[2], CAMERAS[4],
                                       CAMERAS[5], CAMERAS[7]])
def test_damage_clip_matches_jax(d, z, exact):
    combo, n, _count = _combo("headline", 4)
    rects = np.full((rows.DAMAGE_RECTS, 4), rows.EMPTY_BBOX, np.float32)
    rects[0] = (10, 8, 30, 20)
    rects[1] = (20.5, 6.25, 45, 31)
    ref, ref_pixels = _jax_partial(combo, n, rects, d, z)
    t = torch.from_numpy
    viewed = rows.view_rows(t(combo), d, z, n)
    got = rows.damage_clip_rows(viewed, t(rects), d, z, n).numpy()
    _assert_rows(got, ref, combo, n, exact)
    dropped = (got[:n, 6] == 2e9) & (viewed.numpy()[:n, 6] != 2e9)
    assert 0 < dropped.sum() < n
    # the pixels JAX's select takes from the new frame, as index ranges
    assert 0 < ref_pixels.sum() < ref_pixels.size or z >= 3
    from_spans = np.zeros_like(ref_pixels)
    spans = rows.damage_spans(rects, d, z, *ref_pixels.shape)
    for y0, y1, x0, x1 in spans:
        from_spans[y0:y1, x0:x1] = True
    assert np.array_equal(from_spans, ref_pixels) and len(spans) <= 2


@pytest.mark.parametrize("stages", ["view", "anim", "damage", "all"])
def test_transform_rows_on_cpu_composes_the_plain_versions(stages):
    combo, n, _count = _combo("rectmask", 5)
    t = torch.from_numpy
    d, z = torch.tensor([7.0, -3.0]), torch.tensor([2.0])
    table, ridx = t(_table("general")), t(_ridx(n, 6))
    rects = t(np.asarray([(10, 8, 90, 70)] + [rows.EMPTY_BBOX] * 3, np.float32))
    kw = {}
    expect = t(combo)
    if stages in ("anim", "all"):
        kw.update(table=table, ridx=ridx)
        expect = rows.animate_rows(expect, table, ridx, n)
    expect = rows.view_rows(expect, d, z, n)
    if stages in ("damage", "all"):
        kw.update(rects=rects)
        expect = rows.damage_clip_rows(expect, rects, d, z, n)
    src = t(combo.copy())
    out = torch.empty_like(src)
    before = rows.LAUNCHES
    got = rows.transform_rows(src, n, d, z, out, **kw)
    assert got is out and rows.LAUNCHES == before  # no kernel on the CPU
    assert np.array_equal(got.numpy().view(np.int32), expect.numpy().view(np.int32))
    assert np.array_equal(src.numpy().view(np.int32), combo.view(np.int32))


def test_view_then_inverse_view_round_trips_an_integer_scene():
    """pan d and zoom 2, then the inverse camera, give the input back bit for
    bit (the rect-mask translations up to the sign of a zero): nothing but
    the geometry of live rows ever moves."""
    combo, n, _count = _combo("rectmask", 7)
    there = rows.view_rows(torch.from_numpy(combo), (31.0, -17.0), 2.0, n)
    back = rows.view_rows(there, (-15.5, 8.5), 0.5, n).numpy()
    rest = [c for c in range(52) if c not in (44, 48)]
    assert np.array_equal(back.view(np.int32)[:, rest], combo.view(np.int32)[:, rest])
    assert np.array_equal(back[:n, [44, 48]], combo[:n, [44, 48]])
