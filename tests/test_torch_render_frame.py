"""The figdraw_tpu_torch slice as a whole, against figdraw_tpu on the CPU:
render_frame on the headline scene (reduced to 384x216, 30 boxes, the same
draw → blur → draw-with-backdrop structure), the JAX package's own plan
through the port's executor, the host copies pinned to the reference, the
explicit device, and the package importing without jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
from figdraw_tpu import FigRenderer as JaxRenderer, vec2 as jax_vec2
from figdraw_tpu.scenes import make_render_tree_array as jax_scene
from figdraw_tpu_torch.plan import from_jax_plan
from figdraw_tpu_torch.scenes import make_render_tree_array
from torch_reference import fresh_combo_pools

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)

W, H, COPIES = 384, 216, 10
TOL = 1.0 / 255.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def renderers():
    return JaxRenderer(atlas_size=64, use_pallas=True), port.FigRenderer(device="cpu")


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_render_frame_matches_reference(frame, renderers):
    jr, pr = renderers
    a = jax_scene(W, H, frame, copies=COPIES)
    b = make_render_tree_array(W, H, frame, copies=COPIES)
    la, lb = a.layers[0], b.layers[0]
    assert la.nodes[: la.count].tobytes() == lb.nodes[: lb.count].tobytes()
    fresh_combo_pools()
    jt = jr.flatten(a, jax_vec2(W, H))
    pt = pr.flatten(b, port.vec2(W, H))
    assert jt.combo.shape == pt.combo.shape
    assert jt.combo.tobytes() == pt.combo.tobytes()
    ref = np.asarray(jr.render_frame(a, jax_vec2(W, H)))
    assert jr.use_pallas, "the JAX renderer fell back from Pallas"
    got = pr.render_frame(b, port.vec2(W, H))
    assert tuple(got.shape) == (H, W, 4) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= TOL
    shot_j, shot_p = jr.take_screenshot(), pr.take_screenshot()
    assert shot_p.dtype == np.uint8 and shot_p.shape == (H, W, 4)
    assert np.abs(shot_j.astype(int) - shot_p.astype(int)).max() <= 1


def test_jax_plan_runs_through_port_executor(renderers):
    jr, pr = renderers
    a = jax_scene(W, H, 3, copies=COPIES)
    jplan = jr._plan_execution(jr.flatten(a, jax_vec2(W, H)))
    plan = from_jax_plan(jplan)
    assert plan.structure == (("draw", -1, False, False), ("blur",),
                              ("draw", -1, False, True))
    assert (plan.height, plan.width, plan.n_masks) == (H, W, 1)
    got = pr.execute_plan(plan).numpy()
    ref = np.asarray(jr.render_frame(a, jax_vec2(W, H)))
    assert np.abs(got - ref).max() <= TOL


def test_frame_without_clear_starts_from_last_frame(renderers):
    jr, pr = renderers
    a = jax_scene(W, H, 4, copies=COPIES)
    b = make_render_tree_array(W, H, 4, copies=COPIES)
    ref = np.asarray(jr.render_frame(a, jax_vec2(W, H), clear_main=False))
    got = pr.render_frame(b, port.vec2(W, H), clear_main=False).numpy()
    assert np.abs(got - ref).max() <= TOL


def test_stored_reference_blocks_match_jax():
    """chip_smoke.py holds the port's frame on the card against these block
    means of figdraw_tpu's render; they must stay figdraw_tpu's."""
    jr = JaxRenderer(atlas_size=64, use_pallas=True)
    f = np.asarray(jr.render_frame(jax_scene(W, H, 0, copies=COPIES), jax_vec2(W, H)))
    blocks = f.reshape(H // 8, 8, W // 8, 8, 4).mean(axis=(1, 3))
    stored = np.load(os.path.join(REPO, "figdraw_tpu_torch", "reference",
                                  "headline_384x216_f0_blocks8.npy"))
    np.testing.assert_allclose(stored, blocks, rtol=0, atol=1e-6)


def test_host_copies_match_reference():
    from figdraw_tpu import executor as jex
    from figdraw_tpu import nodesarray as jna
    from figdraw_tpu import renderer as jren
    from figdraw_tpu.ops import quad_eval
    from figdraw_tpu_torch import nodesarray, plan
    from figdraw_tpu_torch.ops import quad_eval_planar

    for name in ("FILL_DTYPE", "SHADOW_DTYPE", "FIG_DTYPE", "GLYPH_DTYPE",
                 "TRECT_DTYPE", "OP_DTYPE"):
        assert getattr(nodesarray, name) == getattr(jna, name), name
    assert plan.QUAD_BUCKETS == jren.QUAD_BUCKETS
    assert plan.ROLLED_THRESHOLD == jex.ROLLED_THRESHOLD
    for n in (1, 64, 65, 706, 2049, 5000, 70000, 200000):
        assert plan.bucket(n) == jren._bucket(n)
    for nd, nb in ((0, 0), (2, 1), (12, 11), (30, 3)):
        assert plan.meta_rows(nd, nb, 52) == jex._meta_rows(nd, nb, 52)
        bounds = [(i, i + 3) for i in range(nd)]
        radii = [float(r) + 0.5 for r in range(nb)]
        m_port = np.zeros(2 * nd + nb + 4, np.float32)
        m_ref = np.zeros_like(m_port)
        plan.fill_meta(m_port, bounds, radii, (0.1, 0.2, 0.3, 0.4))
        jex.fill_meta(m_ref, bounds, radii, (0.1, 0.2, 0.3, 0.4))
        assert m_port.tobytes() == m_ref.tobytes()
    for dens in ((2854.0, 153.0), (100.0, 30.0), (9000.0, 200.0),
                 (20000.0, 150.0), (10.0, -1.0)):
        for hw in ((1080, 1920), (216, 384), (128, 256)):
            assert plan.tile_h_from_density(*dens, *hw) == jex.tile_h_from_density(*dens, *hw)
    for name in dir(quad_eval_planar):
        if name.startswith("MODE_"):
            assert getattr(quad_eval_planar, name) == getattr(quad_eval, name), name


def _clipped_cells(n):
    """n clipped cells, each with a red child spilling over it."""
    from figdraw_tpu_torch.basics import FigFlags, FigKind
    from figdraw_tpu_torch.nodesarray import RenderListArray

    lst = RenderListArray()
    for i in range(n):
        p = lst.add_root_raw()
        lst.nodes["kind"][p] = int(FigKind.nkRectangle)
        lst.nodes["box"][p] = (4 + 30 * (i % 3), 4 + 20 * (i // 3), 26, 16)
        lst.nodes["flags"][p] = int(FigFlags.NfClipContent)
        lst.nodes["fill"]["c0"][p] = (200, 200, 200, 255)
        c = lst.add_child_raw(p)
        lst.nodes["kind"][c] = int(FigKind.nkRectangle)
        lst.nodes["box"][c] = (0, 0, 96, 64)
        lst.nodes["fill"]["c0"][c] = (255, 0, 0, 255)
    return lst


def test_masked_scene_names_its_roadmap_item():
    """Clip masks, the atlas and text render now: a text row in a clipped
    cell renders as figdraw_tpu renders the same rows (a row without a
    layout draws nothing)."""
    from figdraw_tpu.nodesarray import FIG_DTYPE, RenderListArray, RendersArray as JR
    from figdraw_tpu_torch.basics import FigKind
    from figdraw_tpu_torch.nodesarray import RendersArray

    lst = _clipped_cells(1)
    t = lst.add_child_raw(0)
    lst.nodes["kind"][t] = int(FigKind.nkText)
    lst.nodes["box"][t] = (8, 8, 40, 12)
    scene = RendersArray()
    scene.set_layer(0, lst)
    got = port.FigRenderer(device="cpu").render_frame(scene, port.vec2(96, 64))
    jl = RenderListArray(capacity=lst.count)
    jl.nodes[: lst.count] = lst.nodes[: lst.count].view(FIG_DTYPE)
    jl.count, jl.root_ids = lst.count, list(lst.root_ids)
    jscene = JR()
    jscene.set_layer(0, jl)
    want = np.asarray(JaxRenderer(atlas_size=64, use_pallas=False).render_frame(
        jscene, jax_vec2(96, 64)))
    assert np.abs(got.numpy() - want).max() <= TOL


def test_rolled_scene_names_its_roadmap_item():
    """More than 24 pass items with a backdrop blur: the rolled executor's
    scene, not the megakernel's. It has landed: the scene renders through
    the rolled plan as figdraw_tpu renders it."""
    from figdraw_tpu.nodesarray import FIG_DTYPE, RenderListArray, RendersArray as JR
    from figdraw_tpu_torch.basics import FigKind
    from figdraw_tpu_torch.nodesarray import RendersArray
    from figdraw_tpu_torch.plan import plan_execution

    lst = _clipped_cells(10)
    b = lst.add_root_raw()
    lst.nodes["kind"][b] = int(FigKind.nkBackdropBlur)
    lst.nodes["box"][b] = (10, 10, 50, 30)
    lst.nodes["blur"][b] = 6.0
    scene = RendersArray()
    scene.set_layer(0, lst)
    ren = port.FigRenderer(device="cpu")
    tape = ren.flatten(scene, port.vec2(96, 64))
    assert len(tape.structure_cache[0]) > 24
    plan = plan_execution(tape)
    assert plan.rolled_items is not None and plan.mega_combo is None
    got = ren.render_frame(scene, port.vec2(96, 64)).numpy()
    jl = RenderListArray(capacity=lst.count)
    jl.nodes[: lst.count] = lst.nodes[: lst.count].view(FIG_DTYPE)
    jl.count, jl.root_ids = lst.count, list(lst.root_ids)
    jscene = JR()
    jscene.set_layer(0, jl)
    ref = np.asarray(JaxRenderer(atlas_size=64, use_pallas=False).render_frame(
        jscene, jax_vec2(96, 64)))
    assert np.abs(got - ref).max() <= TOL


def test_cuda_renderer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.FigRenderer(device="cuda")


def test_imports_and_renders_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'fontTools', 'PIL'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "import figdraw_tpu_torch as port\n"
        "from figdraw_tpu_torch.scenes import make_render_tree_array\n"
        "r = port.FigRenderer(device='cpu')\n"
        "f = r.render_frame(make_render_tree_array(128, 128, 0, copies=2), port.vec2(128, 128))\n"
        "assert tuple(f.shape) == (128, 128, 4) and bool(f.isfinite().all())\n"
        "assert r.take_screenshot().std() > 0\n"
        "from figdraw_tpu_torch.scenes import make_clip_table_scene\n"
        "from figdraw_tpu_torch import native\n"
        "t = make_clip_table_scene('subclip', 160, 120, 4, 3)\n"
        "assert native.flatten_fast(t, 160, 120, 1, 1, 1.2, None)[0] == 'mega'\n"
        "f = r.render_frame(t, port.vec2(160, 120))\n"
        "assert tuple(f.shape) == (120, 160, 4) and bool(f.isfinite().all())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('figdraw_tpu', 'jax'))\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads above
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
