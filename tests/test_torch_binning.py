"""figdraw_tpu_torch tile binning against figdraw_tpu's (binning.bin_quads):
tile_idx and tile_counts must be EXACTLY equal — the keys are unique, so the
port's argsort gives the reference's lists. Covers plain binning, opaque
occlusion, run-scoped culling and the saturation tier past SAT_MIN_QUADS."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from figdraw_tpu.ops.binning import bin_quads as jax_bin_quads
from figdraw_tpu_torch.ops.binning import SAT_MIN_QUADS, bin_quads
from figdraw_tpu_torch.ops.layout import (
    QF_AA, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, QF_COLOR0,
    QF_INV_B, QF_MID_COLOR, QF_PARAMS, QF_RADII, QF_RECT_PARAMS,
    QF_STOP_COLOR, QF_WIDTH,
)

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

W, H = 384, 256


def _random_tape(n, n_live, seed, sat=False):
    """Seeded random quads in logical layout: bboxes, rounded-box shape
    params, corner radii (some elliptical-packed), u8 alphas, a mix of
    covers (big opaque or constant-alpha axis-aligned rects) and
    disqualified ones (rotated, mask-read, rect-masked, non-fill modes)."""
    rng = np.random.RandomState(seed)
    f = np.zeros((n, QF_WIDTH), np.float32)
    m = np.zeros((n, 2), np.int32)
    big = rng.rand(n_live) < (0.6 if sat else 0.15)
    cw = np.where(big, rng.uniform(200, 500, n_live), rng.uniform(4, 150, n_live))
    ch = np.where(big, rng.uniform(160, 400, n_live), rng.uniform(4, 150, n_live))
    cx = rng.uniform(-40, W + 40, n_live)
    cy = rng.uniform(-40, H + 40, n_live)
    f[:n_live, QF_BBOX_X0] = cx - cw / 2
    f[:n_live, QF_BBOX_X1] = cx + cw / 2
    f[:n_live, QF_BBOX_Y0] = cy - ch / 2
    f[:n_live, QF_BBOX_Y1] = cy + ch / 2
    f[:n_live, QF_PARAMS + 2] = cw / 2
    f[:n_live, QF_PARAMS + 3] = ch / 2
    f[:n_live, QF_AA] = 1.2
    f[:n_live, QF_RECT_PARAMS + 2] = np.where(rng.rand(n_live) < 0.05, 30.0, -1.0)
    f[:n_live, QF_INV_B] = np.where(rng.rand(n_live) < 0.05, 0.01, 0.0)
    ell = rng.rand(n_live) < 0.3
    radii = rng.randint(0, 24, size=(n_live, 4)).astype(np.float32)
    packed = (rng.randint(0, 4096, size=(n_live, 4))
              + 4096 * rng.randint(0, 4096, size=(n_live, 4))).astype(np.float32)
    packed[:, 0] = np.where(rng.rand(n_live) < 0.2, -5.0, packed[:, 0])
    f[:n_live, QF_RADII : QF_RADII + 4] = np.where(ell[:, None], packed, radii)
    if sat:
        alpha = rng.choice([155, 200, 255], size=n_live)
    else:
        alpha = np.where(rng.rand(n_live) < 0.5, 255, rng.randint(0, 256, n_live))
    a = (alpha / 255.0).astype(np.float32)
    for c in range(4):
        f[:n_live, QF_COLOR0 + 4 * c + 3] = a
    fm = np.where(rng.rand(n_live) < 0.2, rng.randint(1, 5, n_live), 0)
    f[:n_live, QF_MID_COLOR + 3] = np.where(rng.rand(n_live) < 0.5, a, 0.5)
    f[:n_live, QF_STOP_COLOR + 3] = a
    mode = np.where(rng.rand(n_live) < 0.85, 3, rng.choice([7, 9, 12], n_live))
    m[:n_live, 0] = mode + 128 * ell + 256 * fm
    m[:n_live, 1] = np.where(rng.rand(n_live) < 0.05, 1, 0)
    return f, m


def _both(f, m, start, end, tiles_y, tiles_x, th, tw, with_modes, runs):
    jr = jax_bin_quads(
        jnp.asarray(f), jnp.int32(start), jnp.int32(end), tiles_y, tiles_x, th, tw,
        modes=jnp.asarray(m) if with_modes else None,
        run_bounds=None if runs is None else jnp.asarray(runs, jnp.int32),
        n_runs=0 if runs is None else len(runs),
    )
    pr = bin_quads(
        torch.from_numpy(f), start, end, tiles_y, tiles_x, th, tw,
        modes=torch.from_numpy(m) if with_modes else None,
        run_bounds=None if runs is None else torch.tensor(runs, dtype=torch.int32),
    )
    return (np.asarray(jr[0]), np.asarray(jr[1])), (pr[0].numpy(), pr[1].numpy())


def _assert_equal(jr, pr):
    assert pr[0].dtype == np.int32 and pr[1].dtype == np.int32
    np.testing.assert_array_equal(pr[1], jr[1])
    np.testing.assert_array_equal(pr[0], jr[0])


@pytest.mark.parametrize("th", [128, 64, 32])
@pytest.mark.parametrize("case", ["plain", "window", "occlusion", "runs"])
def test_binning_matches_reference_exactly(th, case):
    n, n_live = 512, 400
    f, m = _random_tape(n, n_live, seed=th + len(case))
    tiles_y, tiles_x = H // th, W // 128
    start, end = (37, 301) if case == "window" else (0, n)
    runs = [[0, 150], [150, 151], [151, n_live]] if case == "runs" else None
    jr, pr = _both(f, m, start, end, tiles_y, tiles_x, th, 128,
                   with_modes=case in ("occlusion", "runs"), runs=runs)
    _assert_equal(jr, pr)
    if case in ("occlusion", "runs"):
        _plain_j, plain_p = _both(f, m, start, end, tiles_y, tiles_x, th, 128,
                                  with_modes=False, runs=None)
        assert (pr[1] < plain_p[1]).any(), "occlusion culled nothing"


def test_run_bounds_keep_earlier_runs():
    """A cover in a later run truncates only its own run."""
    n, n_live = 256, 200
    f, m = _random_tape(n, n_live, seed=3)
    # an opaque full-frame cover ends run 0... and another opens run 1
    for row in (99, 150):
        f[row, QF_BBOX_X0], f[row, QF_BBOX_Y0] = -50, -50
        f[row, QF_BBOX_X1], f[row, QF_BBOX_Y1] = W + 50, H + 50
        f[row, QF_PARAMS + 2], f[row, QF_PARAMS + 3] = W / 2 + 50, H / 2 + 50
        f[row, QF_RADII : QF_RADII + 4] = 4.0
        f[row, QF_COLOR0 + 3 : QF_COLOR0 + 16 : 4] = 1.0
        f[row, QF_RECT_PARAMS + 2] = -1.0
        f[row, QF_INV_B] = 0.0
        m[row] = (3, 0)
    runs = [[0, 120], [120, n_live]]
    jr, pr = _both(f, m, 0, n, 2, 3, 128, 128, with_modes=True, runs=runs)
    _assert_equal(jr, pr)
    for t in range(6):
        lst = pr[0][t, : pr[1][t]]
        assert lst.min() == 99  # run 0 keeps its own cover and above
        assert (lst >= 150).sum() == (lst > 120).sum()  # run 1 starts at its cover


@pytest.mark.parametrize("with_runs", [False, True])
def test_saturation_tier_matches_reference_exactly(with_runs):
    n = 4096 + 512  # padded rows past SAT_MIN_QUADS
    n_live = 4300
    assert n >= SAT_MIN_QUADS
    f, m = _random_tape(n, n_live, seed=17, sat=True)
    runs = [[0, 2000], [2000, n_live]] if with_runs else None
    jr, pr = _both(f, m, 0, n, 2, 3, 128, 128, with_modes=True, runs=runs)
    _assert_equal(jr, pr)
    _pj, plain = _both(f, m, 0, n, 2, 3, 128, 128, with_modes=False, runs=None)
    # the translucent stack saturates: most of each tile's list is dropped
    assert (pr[1] * 4 < plain[1]).all(), (pr[1], plain[1])
