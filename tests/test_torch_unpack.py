"""figdraw_tpu_torch wire decode against figdraw_tpu: the packed upload
unpacks to BIT-identical fields and modes (executor.unpack_combo_device),
and the port's copy of the packed layout packs and unpacks like the
reference's."""

import numpy as np
import pytest
import torch

from figdraw_tpu import executor as jax_executor
from figdraw_tpu.ops import layout as jax_layout
from figdraw_tpu_torch.executor import unpack_combo
from figdraw_tpu_torch.ops import layout

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)


def _random_packed(n, seed):
    """A random tape in the packed wire layout: arbitrary f32 geometry,
    u8-quantized colors (the walks' contract), random mode lanes."""
    rng = np.random.RandomState(seed)
    fields = rng.uniform(-500.0, 2000.0, size=(n, layout.QF_WIDTH)).astype(np.float32)
    fields[:, 16:40] = rng.randint(0, 256, size=(n, 24)).astype(np.float32) / np.float32(255.0)
    modes = np.stack([rng.randint(0, 1 << 14, size=n),
                      rng.randint(0, 8, size=n)], axis=1).astype(np.int32)
    return layout.pack_fields_np(fields, modes), fields, modes


def _headline_combo():
    import figdraw_tpu_torch as port
    from figdraw_tpu_torch.scenes import make_render_tree_array

    ren = port.FigRenderer(device="cpu")
    tape = ren.flatten(make_render_tree_array(384, 216, 0, copies=10),
                       port.vec2(384, 216))
    return tape.combo[: tape.combo_quads].copy()


def _assert_bit_exact(rows):
    jf, jm = jax_executor.unpack_combo_device(rows)
    pf, pm = unpack_combo(torch.from_numpy(rows))
    np.testing.assert_array_equal(
        np.asarray(jf).view(np.uint32), pf.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jm), pm.numpy())
    assert pf.dtype == torch.float32 and pm.dtype == torch.int32


def test_unpack_headline_combo_bit_exact():
    rows = _headline_combo()
    assert rows.shape == (128, layout.PACKED_WIDTH)
    _assert_bit_exact(rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unpack_random_tape_bit_exact(seed):
    rows, fields, modes = _random_packed(777, seed)
    _assert_bit_exact(rows)
    # and the decode is the exact inverse of the packer
    pf, pm = unpack_combo(torch.from_numpy(rows))
    np.testing.assert_array_equal(pf.numpy().view(np.uint32), fields.view(np.uint32))
    np.testing.assert_array_equal(pm.numpy(), modes)


def test_layout_copy_matches_reference():
    names = [k for k in dir(jax_layout) if k.startswith(("QF_", "QI_", "PACKED_"))]
    assert names
    for k in names:
        assert getattr(layout, k) == getattr(jax_layout, k), k
    rows, fields, modes = _random_packed(300, 5)
    ref = jax_layout.pack_fields_np(fields, modes)
    np.testing.assert_array_equal(rows.view(np.uint32), ref.view(np.uint32))
    pf, pm = layout.unpack_fields_np(rows)
    jf, jm = jax_layout.unpack_fields_np(rows)
    np.testing.assert_array_equal(pf.view(np.uint32), jf.view(np.uint32))
    np.testing.assert_array_equal(pm, jm)
