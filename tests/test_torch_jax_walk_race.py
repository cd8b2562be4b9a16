"""torch_reference.ensure_jax_native under the build race it repairs.

figdraw_tpu/native.py builds its walk library in place at first use. On a
checkout whose native/build/ is empty, test workers that start together race
to build it, and a worker that opens a half-written library keeps
`_load_failed` for good: the port's tests that compare with figdraw_tpu's C++
walk then failed in that worker. Here six processes load the walk of a
scratch copy of figdraw_tpu with no library built, all at one moment, through
ensure_jax_native; every one of them must end with the library loaded.
"""

import os
import shutil
import subprocess
import sys
import time

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKERS = 6

_LOADER = """
import sys, time
sys.path[:0] = [{scratch!r}, {tests!r}]
import figdraw_tpu.native as n
assert n.__file__.startswith({scratch!r}), n.__file__
from torch_reference import ensure_jax_native
time.sleep(max(0.0, {start!r} - time.time()))
lib = ensure_jax_native(n)
print("loaded", lib.fd_fig_struct_size() == n.FIG_DTYPE.itemsize)
"""


def test_six_workers_all_load_the_walk(tmp_path):
    scratch = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "figdraw_tpu"), os.path.join(scratch, "figdraw_tpu"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(scratch, "native"))
    shutil.copy(os.path.join(REPO, "native", "flatten.cpp"), os.path.join(scratch, "native"))
    assert not os.path.exists(os.path.join(scratch, "native", "build"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    # the importing takes a few seconds; all six start the load together
    code = _LOADER.format(scratch=scratch, tests=TESTS, start=time.time() + 20.0)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=scratch, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(WORKERS)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[-2:] == ["loaded", "True"], (out, err)
    assert os.path.exists(os.path.join(scratch, "native", "build", "libfigdraw_flatten.so"))
