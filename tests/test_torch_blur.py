"""figdraw_tpu_torch backdrop blur against figdraw_tpu's
(blur.backdrop_blur_planar) on the same seeded planes. Tolerance 1e-5: both
sum the same 17 taps in the same order in float32, but exp and the
multiply-adds round in XLA and ATen separately."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from figdraw_tpu.ops.blur import backdrop_blur_planar as jax_blur
from figdraw_tpu_torch.ops import blur
from figdraw_tpu_torch.ops.blur import backdrop_blur_planar

# one intra-op thread: the suite runs a pytest-xdist worker per core, and
# torch's spinning thread pools, oversubscribed, slow these tests a
# hundredfold
torch.set_num_threads(1)


@pytest.mark.parametrize("radius", [0.0, 0.3, 1.0, 3.0, 7.5, 18.0, 64.0, 100.0])
def test_blur_matches_reference(radius):
    rng = np.random.RandomState(int(radius * 10) + 11)
    planes = rng.rand(4, 72, 136).astype(np.float32)
    # a hard edge, so the taps' interpolation and edge clamping both show
    planes[:, :, 60:] *= 0.1
    ref = np.asarray(jax_blur(jnp.asarray(planes), jnp.float32(radius)))
    got = backdrop_blur_planar(torch.from_numpy(planes),
                               torch.tensor(radius, dtype=torch.float32)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if radius <= 0.5:
        np.testing.assert_array_equal(got, planes)


def test_cpu_tensors_take_the_plain_blur():
    """On a CPU tensor the wrapper is the plain version and launches
    nothing; the input is not written and a float radius is taken."""
    planes = torch.from_numpy(np.random.RandomState(5).rand(4, 40, 72).astype(np.float32))
    before, launches = planes.clone(), blur.LAUNCHES
    got = backdrop_blur_planar(planes, 7.5)
    assert blur.LAUNCHES == launches and torch.equal(planes, before)
    assert torch.equal(got, blur.backdrop_blur_planar_plain(
        planes, torch.tensor(7.5, dtype=torch.float32)))
    assert got.data_ptr() != planes.data_ptr()
