"""figdraw_tpu_torch's frame front end (ops/binning.decode_and_bin: the wire
decode and the tile binning, csrc/binning.cu on the card) against
figdraw_tpu's `executor.unpack_combo_device` + `ops.binning.bin_quads`:

- the plain front end equals JAX's exactly on the executors' own calls:
  fields and modes as 32-bit words, lists and counts, on a headline tape
  with its frame runs, the rect-mask table past SAT_MIN_QUADS (the
  saturation tier), a megakernel combo (no culling) and a rolled table;
- the numpy model of the redesigned kernels (int16 tile ranges that set
  each quad's bit in the tiles it meets, bounds from the covers among a
  tile's bits) equals JAX's lists on tapes with NaN, +-inf, -0.0, exact
  tile edges and values past int16, at tile_h 32 / 64 / 128;
- the int16 ranges equal the float tests they replace, quad by quad and
  tile by tile;
- the wrappers route CPU tensors to the plain versions and nothing else.

The kernels run only on the card: tests/test_torch_cuda.py holds them to
the plain versions there."""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from figdraw_tpu import executor as jax_executor
from figdraw_tpu.ops.binning import bin_quads as jax_bin_quads
import figdraw_tpu_torch as port
from figdraw_tpu_torch import executor
from figdraw_tpu_torch.ops import binning
from figdraw_tpu_torch.ops.binning import (
    SAT_MIN_QUADS, bin_quads_model, cover_ranges, cover_terms, decode_and_bin,
    decode_and_bin_plain, overlap_bits, tile_ranges, unpack_combo,
    unpack_combo_plain,
)
from figdraw_tpu_torch.ops.layout import (
    PACKED_WIDTH, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, pack_fields_np,
)
from figdraw_tpu_torch.plan import meta_rows, plan_execution, plan_rolled
from figdraw_tpu_torch.scenes import (
    binning_tape, make_clip_table_scene, make_render_tree_array,
)
from figdraw_tpu_torch.tape import FRAME_TARGET

torch.set_num_threads(1)


def _jax_front(rows, start, end, grid, cull, runs):
    """JAX's unpack_combo_device + bin_quads on packed rows (numpy)."""
    jf, jm = jax_executor.unpack_combo_device(jnp.asarray(rows))
    idx, counts = jax_bin_quads(
        jf, jnp.int32(start), jnp.int32(end), *grid, modes=jm if cull else None,
        run_bounds=None if runs is None else jnp.asarray(runs, jnp.int32),
        n_runs=0 if runs is None else len(runs))
    return [np.asarray(a) for a in (jf, jm, idx, counts)]


def _executor_call(name):
    """(packed rows, grid, cull, frame runs) of the executor's front-end
    call on one of the benchmark paths, at a size the CPU runs in seconds."""
    ren = port.FigRenderer(device="cpu")
    if name == "headline":
        tape = ren.flatten(make_render_tree_array(384, 216, 0, copies=10),
                           port.vec2(384, 216))
    elif name == "rolled":
        tape = ren.flatten(make_clip_table_scene("rectmask", 600, 400, 30, 6),
                           port.vec2(600, 400))
    else:
        tape = ren.flatten(make_clip_table_scene(name, 1200, 800, 180, 6),
                           port.vec2(1200, 800))
    plan = plan_rolled(tape) if name == "rolled" else plan_execution(tape)
    th = plan.tile_h
    grid = (-(-plan.height // th), -(-plan.width // 128), th, 128)
    if plan.mega_combo is not None:
        return plan.mega_combo[:-1], grid, False, None
    if plan.rolled_items is not None:
        return plan.combo[:-1], grid, False, None
    draws = [it for it in plan.structure if it[0] == "draw"]
    n = plan.combo.shape[0] - meta_rows(len(draws), len(plan.radii), PACKED_WIDTH)
    runs = [list(b) for b, it in zip(plan.bounds, draws) if it[1] == FRAME_TARGET]
    return plan.combo[:n], grid, bool(runs), runs or None


@pytest.mark.parametrize("name", ["headline", "rectmask", "subclip", "rolled"])
def test_the_plain_front_end_equals_the_reference(name):
    rows, grid, cull, runs = _executor_call(name)
    n = rows.shape[0]
    if name == "rectmask":
        assert n >= SAT_MIN_QUADS and cull  # the saturation tier
    jf, jm, jidx, jcounts = _jax_front(rows, 0, n, grid, cull, runs)
    before = (binning.LAUNCHES, binning.DECODE_LAUNCHES, binning.PLAIN_DECODES,
              binning.PLAIN_BINNINGS)
    f, m, idx, counts = decode_and_bin(
        torch.from_numpy(rows), 0, n, *grid, cull=cull,
        run_bounds=None if runs is None else torch.tensor(runs, dtype=torch.int32))
    assert (binning.LAUNCHES, binning.DECODE_LAUNCHES, binning.PLAIN_DECODES,
            binning.PLAIN_BINNINGS) == (before[0], before[1], before[2] + 1, before[3] + 1)
    np.testing.assert_array_equal(f.numpy().view(np.int32), jf.view(np.int32))
    np.testing.assert_array_equal(m.numpy(), jm)
    assert idx.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert (jcounts > 0).any()
    # the tile kernel's decomposition on the front kernel's own terms
    midx, mcounts, border = bin_quads_model(jf, 0, n, *grid, modes=jm if cull else None,
                                            run_bounds=runs)
    assert not border.any()
    np.testing.assert_array_equal(mcounts, jcounts)
    np.testing.assert_array_equal(midx, jidx)


def _edge_tape(n, seed, w, h, th, sat):
    """binning_tape's quads with bboxes snapped to tile edges (and half a
    pixel off them), some at -0.0, NaN, +-inf, and far past what int16 tile
    indices hold, in the packed wire layout (colours u8, as the walks
    write them)."""
    f, m = binning_tape(n, n - n // 8, seed, sat=sat, w=w, h=h)
    rng = np.random.RandomState(seed + 1)
    live = n - n // 8
    snap = rng.rand(live) < 0.4
    for col, size in ((QF_BBOX_X0, 128), (QF_BBOX_X1, 128), (QF_BBOX_Y0, th),
                      (QF_BBOX_Y1, th)):
        edge = (np.round(f[:live, col] / size) * size
                + rng.choice([0.0, 0.5, -0.5, 0.0], live)).astype(np.float32)
        f[:live, col] = np.where(snap, edge, f[:live, col])
    odd = rng.choice(live, 48, replace=False)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e7, -1e7, 4.5e6,
                         32767.0 * 128, -32768.0 * 32, 3e38, -3e38], np.float32)
    for j, i in enumerate(odd):
        f[i, QF_BBOX_X0 + j % 4] = specials[j % len(specials)]
    f[odd[:4], QF_BBOX_X0] = -0.0  # quads from the frame's left edge
    f[odd[4:8], QF_BBOX_Y1] = np.inf
    rows = pack_fields_np(f, m)
    return rows, unpack_combo_plain(torch.from_numpy(rows))[0].numpy(), m


@pytest.mark.parametrize("th", [32, 64, 128])
@pytest.mark.parametrize("culls", ["none", "occlusion", "runs", "saturation"])
def test_the_tile_kernel_model_equals_the_reference_on_edge_values(th, culls):
    w, h = 1024, 512
    sat = culls == "saturation"
    n = 4608 if sat else 640
    rows, f, m = _edge_tape(n, th + len(culls), w, h, th, sat)
    grid = (h // th, w // 128, th, 128)
    runs = [[0, n // 3], [n // 3, n // 2], [n // 2 + 7, n]] if culls in ("runs",
                                                                        "saturation") else None
    cull = culls != "none"
    _jf, _jm, jidx, jcounts = _jax_front(rows, 0, n, grid, cull, runs)
    idx, counts, border = bin_quads_model(f, 0, n, *grid, modes=m if cull else None,
                                          run_bounds=runs)
    assert not border.any()
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(idx, jidx)
    # a window inside the rows as well
    _jf, _jm, jidx, jcounts = _jax_front(rows, 37, n - 50, grid, cull, runs)
    idx, counts, _border = bin_quads_model(f, 37, n - 50, *grid, modes=m if cull else None,
                                           run_bounds=runs)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(idx, jidx)
    if cull:
        assert (jcounts < _jax_front(rows, 0, n, grid, False, None)[3]).any()


@pytest.mark.parametrize("th", [32, 64, 128])
def test_tile_ranges_equal_the_float_tests(th):
    """Quad by quad and tile by tile, membership in the int16 ranges is the
    float32 comparison bin_quads_plain makes: the bbox overlap, and the
    cover test of the quads that can cover."""
    w, h = 1024, 512
    rows, f, m = _edge_tape(640, th, w, h, th, False)
    tiles_y, tiles_x = h // th, w // 128
    rng = tile_ranges(f, tiles_y, tiles_x, th, 128)
    crng, lt, opaque = cover_ranges(f, m, tiles_y, tiles_x, th, 128)
    cov, a_min = cover_terms(f, m)
    assert rng.dtype == crng.dtype == np.int16
    tx = np.arange(tiles_x, dtype=np.float32) * np.float32(128)
    ty = np.arange(tiles_y, dtype=np.float32) * np.float32(th)
    with np.errstate(invalid="ignore"):
        hit_x = (f[:, None, QF_BBOX_X0] < tx + 128) & (f[:, None, QF_BBOX_X1] > tx)
        hit_y = (f[:, None, QF_BBOX_Y0] < ty + th) & (f[:, None, QF_BBOX_Y1] > ty)
        cov_x = (cov[:, None, 0] <= tx + np.float32(0.5)) & (
            cov[:, None, 1] >= tx + np.float32(128 - 0.5))
        cov_y = (cov[:, None, 2] <= ty + np.float32(0.5)) & (
            cov[:, None, 3] >= ty + np.float32(th - 0.5))
    xs, ys = np.arange(tiles_x), np.arange(tiles_y)
    in_x = (xs >= rng[:, :1]) & (xs <= rng[:, 2:3])
    in_y = (ys >= rng[:, 1:2]) & (ys <= rng[:, 3:4])
    meets = hit_x[:, None, :] & hit_y[:, :, None]
    np.testing.assert_array_equal(in_x[:, None, :] & in_y[:, :, None], meets)
    # the bits the front kernel scatters are the same (tile, quad) pairs
    np.testing.assert_array_equal(overlap_bits(rng, tiles_y, tiles_x),
                                  meets.reshape(len(f), -1).T)
    cin = (((xs >= crng[:, :1]) & (xs <= crng[:, 2:3]))[:, None, :]
           & ((ys >= crng[:, 1:2]) & (ys <= crng[:, 3:4]))[:, :, None])
    np.testing.assert_array_equal(cin, cov_x[:, None, :] & cov_y[:, :, None])
    assert meets.any() and cin.any() and not meets.all()
    # the quads' covers lie inside their bboxes: the walk reads the overlap bits
    assert not (cin & ~meets).any()
    covering = cin.any(axis=(1, 2))
    np.testing.assert_array_equal(opaque, covering & (a_min >= 1.0))
    assert (lt[~covering] == 0).all()


def test_a_cover_outside_its_bbox_is_still_found():
    """A quad whose cover rectangle reaches past its bbox (the walks never
    write one) covers tiles it does not meet: the model, like the kernel,
    then walks every quad of the run, and still equals JAX."""
    rows, f, m = _edge_tape(640, 7, 1024, 512, 64, False)
    crng = cover_ranges(f, m, 8, 8, 64, 128)[0]
    i = int(np.flatnonzero(crng[:, 0] < crng[:, 2])[0])  # covers two tiles or more
    cx = (f[i, QF_BBOX_X0] + f[i, QF_BBOX_X1]) * np.float32(0.5)
    # a thin bbox about the same center: the same cover rectangle
    f[i, QF_BBOX_X0], f[i, QF_BBOX_X1] = cx - np.float32(1.0), cx + np.float32(1.0)
    rows = pack_fields_np(f, m)
    grid = (8, 8, 64, 128)
    crng = cover_ranges(f, m, *grid)[0]
    rng = tile_ranges(f, *grid)
    assert crng[i, 0] < rng[i, 0] or crng[i, 2] > rng[i, 2]
    _jf, _jm, jidx, jcounts = _jax_front(rows, 0, 640, grid, True, None)
    idx, counts, _border = bin_quads_model(f, 0, 640, *grid, modes=m)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(idx, jidx)


def test_cpu_tensors_take_the_plain_front_end():
    rows, grid, cull, runs = _executor_call("headline")
    args = (torch.from_numpy(rows), 0, rows.shape[0], *grid)
    kw = dict(cull=cull, run_bounds=torch.tensor(runs, dtype=torch.int32))
    before = (binning.LAUNCHES, binning.DECODE_LAUNCHES)
    got, want = decode_and_bin(*args, **kw), decode_and_bin_plain(*args, **kw)
    assert (binning.LAUNCHES, binning.DECODE_LAUNCHES) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    f, m = unpack_combo(torch.from_numpy(rows))
    assert torch.equal(f, got[0]) and torch.equal(m, got[1])
    assert executor.unpack_combo is unpack_combo


def test_the_front_end_on_a_meta_tensor_raises():
    rows = torch.empty((64, PACKED_WIDTH), dtype=torch.float32, device="meta")
    before = (binning.LAUNCHES, binning.DECODE_LAUNCHES)
    with pytest.raises(ValueError):
        decode_and_bin(rows, 0, 64, 2, 2, 64, 128)
    with pytest.raises(ValueError):
        unpack_combo(rows)
    assert (binning.LAUNCHES, binning.DECODE_LAUNCHES) == before


@pytest.mark.parametrize("name,plain", [("decode_and_bin", "decode_and_bin_plain"),
                                        ("unpack_combo", "unpack_combo_plain")])
def test_no_silent_route_from_a_cuda_tensor_to_the_plain_version(name, plain):
    """The wrapper reaches its plain version only from its CPU branch,
    never falls back from a failed build or launch (no try), refuses every
    device other than the CPU and CUDA, and raises when the launch fails."""
    fn = ast.parse(inspect.getsource(binning)).body
    (wrapper,) = [node for node in fn
                  if isinstance(node, ast.FunctionDef) and node.name == name]
    assert not [n for n in ast.walk(wrapper) if isinstance(n, ast.Try)]
    calls = [n for n in ast.walk(wrapper) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == plain]
    assert len(calls) == 1
    test_of = lambda node: ast.unparse(node.test).replace("'", '"')
    cpu_branch = [n for n in wrapper.body if isinstance(n, ast.If)
                  and test_of(n) == 'rows.device.type == "cpu"']
    assert len(cpu_branch) == 1
    assert calls[0] in list(ast.walk(cpu_branch[0]))
    assert isinstance(cpu_branch[0].body[0], ast.Return) and not cpu_branch[0].orelse
    refuse = [n for n in wrapper.body if isinstance(n, ast.If)
              and test_of(n) == 'rows.device.type != "cuda"']
    assert refuse and isinstance(refuse[0].body[0], ast.Raise)
    assert "raise RuntimeError" in ast.unparse(wrapper)


def test_the_executors_call_the_front_end_once():
    """Every executor form decodes and bins in one decode_and_bin call."""
    src = inspect.getsource(executor)
    assert src.count("decode_and_bin(") == 2  # the frame (and rolled) and mega executors
    assert "bin_quads(" not in src and "unpack_combo(" not in src


def test_batch_buffers_start_at_16_byte_boundaries():
    """A batch stack lays its buffers out in whole 16-byte units, so every
    frame's combo rows are a view the front kernel takes."""
    buffers = {"combo": np.ones((9, PACKED_WIDTH), np.float32),
               "items": np.arange(15, dtype=np.int32).reshape(5, 3),
               "radii": np.ones(3, np.float32)}
    stack = executor.BatchStack(buffers, 4)
    for _ in range(2):
        stack.add(buffers)
    up = stack.upload(torch.device("cpu"))
    assert up.shape[1] % 4 == 0
    for f in range(3):
        frame = stack.frame(up, f)
        for name, arr in buffers.items():
            assert frame[name].data_ptr() % 16 == 0
            np.testing.assert_array_equal(frame[name].numpy(), arr)
