"""figdraw_tpu_torch's CUDA kernels against their plain torch versions on an
NVIDIA card. Every test here needs the card (marker `cuda`) and skips
without one. The file imports neither jax nor figdraw_tpu, so it also runs
on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from figdraw_tpu_torch import FigRenderer, vec2
from figdraw_tpu_torch.executor import get_frame_executor
from figdraw_tpu_torch.ops import raster
from figdraw_tpu_torch.ops.binning import bin_quads
from figdraw_tpu_torch.plan import plan_execution
from figdraw_tpu_torch.scenes import make_render_tree_array, modes_tape

TOL = 1.0 / 255.0

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA only")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("th", [128, 64, 32])
def test_raster_kernel_matches_plain(th, dev):
    w, h = 512, 256
    fields, modes, n_live = modes_tape(w, h)
    rng = np.random.RandomState(th)
    modes[1:n_live:5, 1] = 1  # some quads read the second mask plane
    f, m = torch.from_numpy(fields).to(dev), torch.from_numpy(modes).to(dev)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], h // th, w // 128, th,
                                      128, modes=m)
    planes, backdrop, mask1 = (torch.from_numpy(rng.rand(*s).astype(np.float32)).to(dev)
                               for s in ((4, h, w), (4, h, w), (1, h, w)))
    masks = torch.cat([torch.ones_like(mask1), mask1])
    bounds = torch.tensor([0, n_live], dtype=torch.int32, device=dev)
    args = (f, m, bounds, tile_idx, tile_counts, planes, masks, backdrop)
    before = raster.LAUNCHES
    out = raster.draw_pass_planar_prebinned(*args, tile_h=th)
    assert raster.LAUNCHES == before + 1
    ref = raster.draw_pass_planar_prebinned_plain(*args, tile_h=th)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= TOL
    assert float((out - planes).abs().max()) > 0.1


def test_headline_frame_matches_plain_executor(dev):
    ren = FigRenderer(device="cuda")
    tape = ren.flatten(make_render_tree_array(1920, 1080, 5, copies=100),
                       vec2(1920, 1080))
    plan = plan_execution(tape)
    before = raster.LAUNCHES
    frame = ren.execute_plan(plan)
    assert raster.LAUNCHES == before + 2
    run = get_frame_executor(plan.structure, plan.height, plan.width,
                             plan.n_masks, plan.has_init_frame, plan.tile_h)
    ref = run(torch.from_numpy(plan.combo).to(dev), None,
              draw=raster.draw_pass_planar_prebinned_plain)
    torch.cuda.synchronize()
    assert tuple(frame.shape) == (1080, 1920, 4)
    assert float((frame - ref).abs().max()) <= TOL


def test_wrapper_rejects_bad_arguments(dev):
    fields, modes, n_live = modes_tape(256, 128)
    f, m = torch.from_numpy(fields).to(dev), torch.from_numpy(modes).to(dev)
    tile_idx, tile_counts = bin_quads(f, 0, f.shape[0], 1, 2, 128, 128, modes=m)
    planes = torch.zeros((4, 128, 256), device=dev)
    masks = torch.ones((1, 128, 256), device=dev)
    bounds = torch.tensor([0, n_live], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        raster.draw_pass_planar_prebinned(f, m.long(), bounds, tile_idx,
                                          tile_counts, planes, masks)
    with pytest.raises(ValueError, match="contiguous"):
        raster.draw_pass_planar_prebinned(f, m, bounds, tile_idx, tile_counts,
                                          planes.transpose(1, 2).contiguous().transpose(1, 2),
                                          masks)
    with pytest.raises(ValueError, match="is on"):
        raster.draw_pass_planar_prebinned(f.cpu(), m, bounds, tile_idx,
                                          tile_counts, planes, masks)
