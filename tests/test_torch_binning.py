"""figdraw_tpu_torch tile binning against figdraw_tpu's (binning.bin_quads):
tile_idx and tile_counts must be EXACTLY equal — the keys are unique, so the
port's argsort gives the reference's lists. Covers plain binning, opaque
occlusion, run-scoped culling and the saturation tier past SAT_MIN_QUADS,
windows, a mask run between frame runs and a 1080p tape at tile_h 32; the
numpy model of the kernel's decomposition (ops/binning.bin_quads_model) is
held to the same lists. The kernel itself (csrc/binning.cu) runs only on
the card: tests/test_torch_cuda.py holds it to bin_quads_plain there."""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from figdraw_tpu.ops.binning import bin_quads as jax_bin_quads
from figdraw_tpu_torch.ops import binning
from figdraw_tpu_torch.ops.binning import (
    SAT_MIN_QUADS, bin_quads, bin_quads_model, bin_quads_plain, list_differences,
    lists_equal,
)
from figdraw_tpu_torch.ops.layout import (
    QF_AA, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, QF_COLOR0, QF_INV_B,
    QF_PARAMS, QF_RADII, QF_RECT_PARAMS, QF_WIDTH, QI_WIDTH,
)
from figdraw_tpu_torch.scenes import binning_tape

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

W, H = 384, 256


def _random_tape(n, n_live, seed, sat=False):
    """Seeded random quads in logical layout (scenes.binning_tape on a
    W x H frame): bboxes, rounded-box shape params, corner radii (some
    elliptical-packed), u8 alphas, a mix of covers (big opaque or
    constant-alpha axis-aligned rects) and disqualified ones (rotated,
    mask-read, rect-masked, non-fill modes)."""
    return binning_tape(n, n_live, seed, sat=sat, w=W, h=H)


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


# name: (rows, live quads, seed, sat, frame w, h, window, tile_h, modes, runs)
CASES = {
    "plain": (512, 400, 64 + 5, False, W, H, (0, 512), 64, False, None),
    "occlusion": (512, 400, 128 + 9, False, W, H, (0, 512), 128, True, None),
    "runs": (512, 400, 32 + 4, False, W, H, (0, 512), 32, True,
             [[0, 150], [150, 151], [151, 400]]),
    "window_occlusion": (512, 400, 41, False, W, H, (37, 301), 64, True, None),
    "window_runs": (512, 400, 42, False, W, H, (37, 301), 64, True,
                    [[0, 150], [150, 151], [151, 400]]),
    "saturation": (4608, 4300, 17, True, W, H, (0, 4608), 128, True, None),
    "sat_window": (4608, 4300, 43, True, W, H, (300, 4000), 128, True, None),
    "sat_three_runs": (4608, 4300, 44, True, W, H, (0, 4608), 128, True,
                       [[0, 1500], [1500, 2900], [2900, 4300]]),
    # [1500, 2500) is a mask run: in no frame run, so never culled
    "sat_mask_run_between": (4608, 4300, 45, True, W, H, (0, 4608), 128, True,
                             [[0, 1500], [2500, 4300]]),
    "hd_tile32_4096": (4096, 3900, 46, True, 1920, 1080, (0, 4096), 32, True,
                       [[0, 3000], [3000, 3900]]),
}


def _case(name):
    n, n_live, seed, sat, w, h, (start, end), th, with_modes, runs = CASES[name]
    f, m = binning_tape(n, n_live, seed, sat=sat, w=w, h=h)
    return f, m, (start, end, -(-h // th), -(-w // 128), th, 128), with_modes, runs


@pytest.mark.parametrize("case", ["window_occlusion", "window_runs", "sat_window",
                                  "sat_three_runs", "sat_mask_run_between",
                                  "hd_tile32_4096"])
def test_more_binning_cases_match_reference_exactly(case):
    f, m, grid, with_modes, runs = _case(case)
    jr, pr = _both(f, m, *grid, with_modes=with_modes, runs=runs)
    _assert_equal(jr, pr)
    _pj, plain = _both(f, m, *grid, with_modes=False, runs=None)
    assert (pr[1] < plain[1]).any(), "the culls dropped nothing"
    if case == "sat_mask_run_between":
        # every quad of the mask run that meets a tile stays in its list
        for t in range(pr[0].shape[0]):
            live = pr[0][t, : pr[1][t]]
            mask_run = plain[0][t, : plain[1][t]]
            mask_run = mask_run[(mask_run >= 1500) & (mask_run < 2500)]
            assert np.isin(mask_run, live).all()


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_decomposition_model_matches_reference_exactly(case):
    """One lower bound per tile and run, then an ordered compaction with no
    sort, gives the JAX reference's lists and counts exactly; no quad of
    these tapes lies near the saturation threshold."""
    f, m, grid, with_modes, runs = _case(case)
    jr, _pr = _both(f, m, *grid, with_modes=with_modes, runs=runs)
    idx, counts, borderline = bin_quads_model(
        f, *grid, modes=m if with_modes else None, run_bounds=runs)
    assert not borderline.any()
    assert idx.dtype == np.int32 and counts.dtype == np.int32
    np.testing.assert_array_equal(counts, jr[1])
    np.testing.assert_array_equal(idx, jr[0])


def test_lists_equal_leaves_out_only_the_borderline_quads():
    ident = np.arange(8, dtype=np.int32)[None, :]
    # quad 3 kept by one binning and cut by the other: the same permutation
    # (the rest follow ascending), one count apart
    kept4, kept3 = np.array([4], np.int32), np.array([3], np.int32)
    border = np.zeros((1, 8), bool)
    assert not lists_equal(ident, kept4, ident, kept3)
    assert not lists_equal(ident, kept4, ident, kept3, border)
    border[0, 3] = True
    assert lists_equal(ident, kept4, ident, kept3, border)
    # a quad out of order outside the borderline ones is a difference
    swapped = ident.copy()
    swapped[0, [1, 2]] = swapped[0, [2, 1]]
    assert not lists_equal(ident, kept4, swapped, kept4, border)
    assert lists_equal(ident, kept4, ident, kept4, border)


def test_list_differences_counts_what_differs_outside_the_borderline_quads():
    ident = np.arange(8, dtype=np.int32)[None, :]
    kept4, kept3 = np.array([4], np.int32), np.array([3], np.int32)
    same = list_differences(ident, kept4, ident, kept4)
    assert same == {"compared": 8, "differing": 0, "count_delta": 0, "max_abs_err": 0.0}
    swapped = ident.copy()
    swapped[0, [1, 5]] = swapped[0, [5, 1]]
    d = list_differences(ident, kept4, swapped, kept3)
    assert (d["differing"], d["count_delta"], d["max_abs_err"]) == (2, 1, 4.0)
    border = np.zeros((1, 8), bool)
    border[0, 3] = True  # quad 3, kept by one and cut by the other, left out
    d = list_differences(ident, kept4, ident, kept3, border)
    assert d == {"compared": 7, "differing": 0, "count_delta": 0, "max_abs_err": 0.0}
    d = list_differences(ident, kept4, np.arange(9, dtype=np.int32)[None, :], kept4)
    assert d["max_abs_err"] == float("inf") and d["compared"] == 0


@pytest.mark.parametrize("heavy_run", [False, True])
def test_the_saturation_border_grows_with_the_stack_the_plain_version_carries(heavy_run):
    """Quad 0's within-run stack lies 0.003 above the threshold. Alone that
    is outside SAT_BORDER; under a later run of 400 opaque covers the plain
    version's float32 suffix sums carry ~9600, and the border widens with
    them, so quad 0 becomes borderline in every tile. The model's lists
    equal the JAX package's either way."""
    n, w, h = SAT_MIN_QUADS, 384, 256
    f = np.zeros((n, QF_WIDTH), np.float32)
    m = np.zeros((n, QI_WIDTH), np.int32)
    alpha = np.float32(1.0 - 2.0 ** (-10.997 / 11))
    rows = list(range(12)) + (list(range(12, 412)) if heavy_run else [])
    for row in rows:  # full-frame rounded rects: every tile is covered
        f[row, [QF_BBOX_X0, QF_BBOX_Y0, QF_BBOX_X1, QF_BBOX_Y1]] = -50, -50, w + 50, h + 50
        f[row, QF_PARAMS + 2], f[row, QF_PARAMS + 3] = w / 2 + 50, h / 2 + 50
        f[row, QF_RADII : QF_RADII + 4] = 4.0
        f[row, QF_AA] = 1.0
        f[row, QF_RECT_PARAMS + 2] = -1.0
        f[row, QF_COLOR0 + 3 : QF_COLOR0 + 16 : 4] = alpha if row < 12 else 1.0
        m[row] = (3, 0)
    runs = [[0, 12], [12, 412]]
    grid = (0, n, 2, 3, 128, 128)
    idx, counts, border = bin_quads_model(f, *grid, modes=m, run_bounds=runs)
    assert border[:, 0].all() == heavy_run and int(border.sum()) == (6 if heavy_run else 0)
    jr, _pr = _both(f, m, *grid, with_modes=True, runs=runs)
    np.testing.assert_array_equal(counts, jr[1])
    np.testing.assert_array_equal(idx, jr[0])


def test_cpu_tensors_take_the_plain_binning():
    f, m, grid, _with_modes, runs = _case("sat_three_runs")
    args = (torch.from_numpy(f), *grid)
    kw = dict(modes=torch.from_numpy(m), run_bounds=torch.tensor(runs, dtype=torch.int32))
    before = binning.LAUNCHES
    got, want = bin_quads(*args, **kw), bin_quads_plain(*args, **kw)
    assert binning.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bin_quads_on_a_meta_tensor_raises():
    fields = torch.empty((64, 68), dtype=torch.float32, device="meta")
    before = binning.LAUNCHES
    with pytest.raises(ValueError):
        bin_quads(fields, 0, 64, 2, 2, 64, 128)
    assert binning.LAUNCHES == before


def test_no_silent_route_from_a_cuda_tensor_to_the_plain_version():
    """bin_quads reaches bin_quads_plain only from its CPU branch, never
    falls back from a failed build or launch (no try), and refuses every
    device other than the CPU and CUDA."""
    fn = ast.parse(inspect.getsource(binning)).body
    (wrapper,) = [node for node in fn
                  if isinstance(node, ast.FunctionDef) and node.name == "bin_quads"]
    assert not [n for n in ast.walk(wrapper) if isinstance(n, ast.Try)]
    calls = [n for n in ast.walk(wrapper) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "bin_quads_plain"]
    assert len(calls) == 1
    test_of = lambda node: ast.unparse(node.test).replace("'", '"')
    cpu_branch = [n for n in wrapper.body if isinstance(n, ast.If)
                  and test_of(n) == 'fields.device.type == "cpu"']
    assert len(cpu_branch) == 1
    assert calls[0] in list(ast.walk(cpu_branch[0]))
    assert isinstance(cpu_branch[0].body[0], ast.Return) and not cpu_branch[0].orelse
    refuse = [n for n in wrapper.body if isinstance(n, ast.If)
              and test_of(n) == 'fields.device.type != "cuda"']
    assert refuse and isinstance(refuse[0].body[0], ast.Raise)
    assert "ValueError" in ast.unparse(refuse[0].body[0])
    # the kernel's launch raises when its C entry point reports an error
    assert "raise RuntimeError" in ast.unparse(wrapper)
