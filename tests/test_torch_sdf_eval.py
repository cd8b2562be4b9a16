"""figdraw_tpu_torch quad evaluator against figdraw_tpu's
(quad_eval_planar.eval_quad_planar, its SDF branch) on one 32x32 tile, for
every SDF mode x fill mode x elliptical corners x rect mask, each case's
quad made from a seeded numpy draw. Tolerance atol 1e-5: the same
operations in the same order, rounded by XLA on one side and ATen on the
other.

One exception, in the bezier modes: XLA:CPU contracts multiply-adds into
FMAs (kx = kk * (abx*bbx + aby*bby) rounds 1 ulp apart from ATen's), and the
cubic solve's p = ky - kx^2 cancels catastrophically near the curve's
evolute, which can amplify that ulp some 500-fold. Pixels where |p| is
below 1% of kx^2 are held to the frame bound, 1/255, instead; every other
pixel to 1e-5."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from figdraw_tpu.ops.quad_eval_planar import eval_quad_planar as jax_eval
from figdraw_tpu_torch.ops.layout import (
    QF_AA, QF_COLOR0, QF_FACTORS, QF_INV_A, QF_INV_B, QF_INV_C, QF_INV_D,
    QF_MID_COLOR, QF_ORG_X, QF_ORG_Y, QF_PARAMS, QF_RADII, QF_RECT_MATX,
    QF_RECT_MATY, QF_RECT_PARAMS, QF_RECT_RADII, QF_STOP_COLOR, QF_WIDTH,
)
from figdraw_tpu_torch.ops.quad_eval_planar import eval_quad_planar

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

MODES = (3, 7, 8, 9, 11, 12, 17, 18, 19, 20, 21)
FILL_MODES = (0, 1, 2, 3, 4)
TILE = 32
# the tile's top-left pixel corner: at the frame origin, pixel coordinates
# stay below 32, where one f32 rounding step (~2e-6) keeps an AA edge's
# alpha well inside the tolerance whichever way each side rounds
X0, Y0 = 0.0, 0.0

CASES = list(itertools.product(MODES, FILL_MODES, (False, True), (False, True)))


def _u8(rng, n):
    return rng.randint(0, 256, size=n).astype(np.float32) / np.float32(255.0)


def _packed_radius(rng, top=4096):
    """One elliptical-corner radius word: 12+12-bit (x, y) fractions of the
    half extents, each below top/4095."""
    return float(rng.randint(0, top) + 4096 * rng.randint(0, top))


def _record(case_idx, mode, fm, elliptical, rect_mask):
    rng = np.random.RandomState(1000 + case_idx)
    f = np.zeros(QF_WIDTH, np.float32)
    qw, qh = rng.uniform(20.0, 44.0, size=2)
    theta = 0.0 if case_idx % 3 == 0 else rng.uniform(-0.6, 0.6)
    c, s = np.cos(theta), np.sin(theta)
    # forward affine p = org + u*E1 + v*E2 around a center inside the tile
    e1 = np.array([qw * c, qw * s])
    e2 = np.array([-qh * s, qh * c])
    center = np.array([X0 + rng.uniform(10, 22), Y0 + rng.uniform(10, 22)])
    org = center - 0.5 * (e1 + e2)
    inv = np.linalg.inv(np.stack([e1, e2], axis=1))
    f[QF_INV_A], f[QF_INV_B] = inv[0]
    f[QF_INV_C], f[QF_INV_D] = inv[1]
    f[QF_ORG_X], f[QF_ORG_Y] = org
    hx, hy = qw / 2, qh / 2
    if mode in (18, 19, 20):  # bezier control points A (params zw), B, C
        pts = rng.uniform(-0.5, 0.5, size=6) * np.array([hx, hy] * 3)
        if case_idx % 4 == 0:  # collinear control point: the segment branch
            pts[2:4] = 0.5 * (pts[0:2] + pts[4:6])
        f[QF_PARAMS : QF_PARAMS + 4] = (hx, hy, pts[0], pts[1])
        f[QF_RADII : QF_RADII + 4] = pts[2:6]
    else:
        shape = (hx, hy) if mode not in (7, 8, 21) else (hx - 6.0, hy - 6.0)
        if mode == 9:
            shape = rng.uniform(-4.0, 4.0, size=2)  # inset shadow offset
        f[QF_PARAMS : QF_PARAMS + 4] = (hx, hy, shape[0], shape[1])
        if elliptical:
            radii = [_packed_radius(rng) for _ in range(4)]
            radii[rng.randint(4)] = -rng.uniform(1.0, 8.0)  # circular corner
            if case_idx % 5 == 0:
                radii[0] = 16777215.0  # the fully round pill word
            if case_idx % 7 == 0:
                radii[1] = 2048.0 + 4096.0 * 2048.0  # equal axes
        else:
            radii = rng.uniform(0.0, min(hx, hy) * 0.6, size=4)
        f[QF_RADII : QF_RADII + 4] = radii
    f[QF_FACTORS] = rng.uniform(2.0, 12.0)
    f[QF_FACTORS + 1] = rng.uniform(0.05, 0.95) if fm else rng.uniform(0.0, 5.0)
    f[QF_AA] = 1.2
    colors = _u8(rng, 16)
    if (case_idx // 4) % 2 == 0:  # equal corners: the flat fill branch
        colors = np.tile(colors[:4], 4)
    f[QF_COLOR0 : QF_COLOR0 + 16] = colors
    f[QF_MID_COLOR : QF_MID_COLOR + 4] = _u8(rng, 4)
    f[QF_STOP_COLOR : QF_STOP_COLOR + 4] = _u8(rng, 4)
    if rect_mask:
        rc, rs = np.cos(0.2 * theta), np.sin(0.2 * theta)
        f[QF_RECT_PARAMS : QF_RECT_PARAMS + 4] = (
            center[0] + rng.uniform(-4, 4), center[1] + rng.uniform(-4, 4),
            hx * rng.uniform(0.7, 1.0), hy * rng.uniform(0.7, 1.0))
        # the mask's inverse transform: a small rotation about the center
        cx, cy = center
        f[QF_RECT_MATX : QF_RECT_MATX + 4] = (rc, rs, cx - rc * cx - rs * cy, 1.0)
        f[QF_RECT_MATY : QF_RECT_MATY + 4] = (-rs, rc, cy + rs * cx - rc * cy,
                                              1.0 if elliptical else 0.0)
        f[QF_RECT_RADII : QF_RECT_RADII + 4] = (
            [_packed_radius(rng, 1024) for _ in range(4)] if elliptical
            else rng.uniform(0.0, 6.0, size=4))
    else:
        f[QF_RECT_PARAMS + 2] = -1.0
        f[QF_RECT_PARAMS + 3] = -1.0
    packed = mode + 128 * int(elliptical) + 256 * fm
    return f, packed


def _pixels():
    iy, ix = np.meshgrid(np.arange(TILE, dtype=np.float32),
                         np.arange(TILE, dtype=np.float32), indexing="ij")
    return X0 + ix + 0.5, Y0 + iy + 0.5


def _cubic_ill_conditioned(f):
    """Pixels where sd_bezier's p = ky - kx^2 cancels to under 1% of kx^2
    (computed in float64 from the record)."""
    px, py = (a.astype(np.float64) for a in _pixels())
    g = f.astype(np.float64)
    rx, ry = px - g[QF_ORG_X], py - g[QF_ORG_Y]
    u = g[QF_INV_A] * rx + g[QF_INV_B] * ry
    v = g[QF_INV_C] * rx + g[QF_INV_D] * ry
    posx = (u - 0.5) * 2.0 * g[QF_PARAMS]
    posy = (v - 0.5) * 2.0 * g[QF_PARAMS + 1]
    ax_, ay_ = g[QF_PARAMS + 2], g[QF_PARAMS + 3]
    bx_, by_, cx_, cy_ = g[QF_RADII : QF_RADII + 4]
    abx, aby = bx_ - ax_, by_ - ay_
    bbx, bby = ax_ - 2.0 * bx_ + cx_, ay_ - 2.0 * by_ + cy_
    kk = 1.0 / max(bbx * bbx + bby * bby, 1e-6)
    kx = kk * (abx * bbx + aby * bby)
    dx, dy = ax_ - posx, ay_ - posy
    ky = kk * (2.0 * (abx * abx + aby * aby) + (dx * bbx + dy * bby)) / 3.0
    return np.abs(ky - kx * kx) < 0.01 * kx * kx


@pytest.fixture(scope="module")
def jax_eval_tile():
    px, py = (jnp.asarray(a) for a in _pixels())

    @jax.jit
    def run(f, mode, bd):
        return jax_eval(lambda k: f[k], mode, px, py,
                        backdrop_planes=(bd[0], bd[1], bd[2], bd[3]))

    return run


@pytest.mark.parametrize("case_idx", range(len(CASES)),
                         ids=[f"mode{m}-fill{fm}-{'ell' if e else 'circ'}-"
                              f"{'rectmask' if r else 'nomask'}"
                              for m, fm, e, r in CASES])
def test_eval_matches_reference(case_idx, jax_eval_tile):
    mode, fm, elliptical, rect_mask = CASES[case_idx]
    f, packed = _record(case_idx, mode, fm, elliptical, rect_mask)
    bd = np.random.RandomState(case_idx).rand(4, TILE, TILE).astype(np.float32)
    ref = [np.asarray(v) for v in
           jax_eval_tile(jnp.asarray(f), jnp.int32(packed), jnp.asarray(bd))]
    px, py = (torch.from_numpy(a) for a in _pixels())
    ft = torch.from_numpy(f)
    bdt = torch.from_numpy(bd)
    got = eval_quad_planar(lambda k: ft[k], torch.tensor(packed, dtype=torch.int32),
                           px, py, backdrop_planes=tuple(bdt))
    well = (np.ones((TILE, TILE), bool) if mode not in (18, 19, 20)
            else ~_cubic_ill_conditioned(f))
    for ch, (g, r) in enumerate(zip(got, ref)):
        g = np.broadcast_to(g.numpy(), r.shape)
        np.testing.assert_allclose(g[well], r[well], rtol=0, atol=1e-5,
                                   err_msg=f"channel {'rgba'[ch]}")
        np.testing.assert_allclose(g, r, rtol=0, atol=1.0 / 255.0,
                                   err_msg=f"channel {'rgba'[ch]}")
    assert well.mean() > 0.95
    # the case must put some coverage on the tile, or it checks little
    assert ref[3].max() > 0.0
