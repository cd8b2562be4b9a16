"""figdraw_tpu_torch tile rasterizer: the plain torch version against
figdraw_tpu's Pallas kernel (raster_pallas.draw_pass_planar_prebinned, in
interpret mode here) on a 256x128 frame at tile heights 128 and 64, within
1/255, and the wrapper's device dispatch. tests/test_torch_cuda.py holds the
CUDA kernel against the plain version on a machine with a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from figdraw_tpu.ops import raster_pallas
from figdraw_tpu_torch.ops import raster
from figdraw_tpu_torch.ops.binning import bin_quads
from figdraw_tpu_torch.scenes import modes_tape

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

W, H = 256, 128


def _inputs(th, seed=0):
    """The modes tape (every SDF mode the kernel evaluates, padded to its
    bucket), its binning, and seeded frame / mask / backdrop planes."""
    fields, modes, n_live = modes_tape(W, H)
    rng = np.random.RandomState(seed)
    planes = rng.rand(4, H, W).astype(np.float32)
    backdrop = rng.rand(4, H, W).astype(np.float32)
    masks = np.ones((2, H, W), np.float32)
    masks[1] = rng.rand(H, W)
    # a few quads read the second mask plane
    modes = modes.copy()
    modes[1:n_live:5, 1] = 1
    ft, mt = torch.from_numpy(fields), torch.from_numpy(modes)
    tile_idx, tile_counts = bin_quads(ft, 0, fields.shape[0], H // th, W // 128,
                                      th, 128, modes=mt)
    return fields, modes, n_live, planes, masks, backdrop, tile_idx, tile_counts


@pytest.mark.parametrize("th", [128, 64])
@pytest.mark.parametrize("run", ["whole", "segment"])
def test_plain_raster_matches_pallas(th, run):
    fields, modes, n_live, planes, masks, backdrop, tile_idx, tile_counts = _inputs(th)
    start, end = (0, n_live) if run == "whole" else (5, n_live - 3)
    ref = raster_pallas.draw_pass_planar_prebinned(
        jnp.asarray(fields), jnp.asarray(modes), jnp.int32(start), jnp.int32(end),
        jnp.asarray(tile_idx.numpy())[:, None, :], jnp.asarray(tile_counts.numpy()),
        jnp.asarray(planes), jnp.asarray(masks), jnp.asarray(backdrop), tile_h=th,
    )
    got = raster.draw_pass_planar_prebinned_plain(
        torch.from_numpy(fields), torch.from_numpy(modes),
        torch.tensor([start, end], dtype=torch.int32), tile_idx, tile_counts,
        torch.from_numpy(planes), torch.from_numpy(masks),
        torch.from_numpy(backdrop), tile_h=th,
    )
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    diff = np.abs(got.numpy() - ref)
    assert diff.max() <= 1.0 / 255.0, diff.max()
    # the run changed the frame (the check is not vacuous)
    assert np.abs(ref - planes).max() > 0.1


def test_cpu_tensors_take_the_plain_version():
    fields, modes, n_live, planes, masks, backdrop, tile_idx, tile_counts = _inputs(64)
    args = (torch.from_numpy(fields), torch.from_numpy(modes),
            torch.tensor([0, n_live], dtype=torch.int32), tile_idx, tile_counts,
            torch.from_numpy(planes), torch.from_numpy(masks),
            torch.from_numpy(backdrop))
    want = raster.draw_pass_planar_prebinned_plain(*args, tile_h=64)
    before = raster.LAUNCHES
    out = raster.draw_pass_planar_prebinned(*args, tile_h=64)
    assert raster.LAUNCHES == before  # no kernel ran
    assert out is args[5]  # the target, updated in place
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_other_devices_raise():
    t = torch.empty((4, 128, 128), device="meta")
    with pytest.raises(ValueError, match="no raster kernel"):
        raster.draw_pass_planar_prebinned(
            t, t, t, t, t, t, t, None, tile_h=128)
