"""figdraw_tpu_torch.config against figdraw_tpu.config (tests/test_config.py's
twin for what the port reads): FIGDRAW_UI_SCALE and its alias HDI set the
global UI scale, FIGDRAW_DATA_DIR the asset root, FIGDRAW_BATCH_CHUNK
render_batch's group bound, with the JAX package's precedence and
parsing. The rasterizer and text switches have no
counterpart in the port. Every case restores both packages' scales."""

import os
import subprocess
import sys

import pytest

import figdraw_tpu as jax_pkg
import figdraw_tpu_torch as port
from figdraw_tpu import config as jax_config
from figdraw_tpu.text import typefaces as jax_typefaces
from figdraw_tpu_torch import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restored():
    scales = (port.fig_ui_scale(), jax_pkg.fig_ui_scale())
    dirs = (port_config.fig_data_dir(), jax_typefaces.fig_data_dir())
    yield
    port.set_fig_ui_scale(scales[0])
    jax_pkg.set_fig_ui_scale(scales[1])
    port_config.set_fig_data_dir(dirs[0])
    jax_typefaces.set_fig_data_dir(dirs[1])


@pytest.mark.parametrize("env,want", [
    ({"FIGDRAW_UI_SCALE": "2"}, 2.0),
    ({"HDI": "1.5"}, 1.5),
    ({"FIGDRAW_UI_SCALE": "1.25", "HDI": "3"}, 1.25),  # the primary name wins
    ({"FIGDRAW_UI_SCALE": "not-a-number"}, None),  # ignored: the scale stays
    ({}, None),
])
def test_ui_scale_env(monkeypatch, restored, env, want):
    for name in ("FIGDRAW_UI_SCALE", "HDI", "FIGDRAW_DATA_DIR"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    port.set_fig_ui_scale(0.75)
    jax_pkg.set_fig_ui_scale(0.75)
    port_config.apply_startup_env()
    jax_config.apply_startup_env()
    assert port.fig_ui_scale() == jax_pkg.fig_ui_scale()
    assert port.fig_ui_scale() == (0.75 if want is None else want)


def test_data_dir_env(monkeypatch, restored, tmp_path):
    monkeypatch.delenv("FIGDRAW_UI_SCALE", raising=False)
    monkeypatch.delenv("HDI", raising=False)
    monkeypatch.setenv("FIGDRAW_DATA_DIR", str(tmp_path))
    port_config.apply_startup_env()
    jax_config.apply_startup_env()
    assert port_config.fig_data_dir() == jax_typefaces.fig_data_dir() == str(tmp_path)


def test_package_import_applies_env():
    """Importing the package reads the environment once, as figdraw_tpu's
    import does."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, FIGDRAW_UI_SCALE="1.5", OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c",
         "import figdraw_tpu_torch as p; print(p.fig_ui_scale())"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert float(res.stdout.strip().splitlines()[-1]) == 1.5


@pytest.mark.parametrize("value", [None, "4", "0", "-3", "not-a-number", "12"])
def test_batch_chunk_env(monkeypatch, value):
    """FIGDRAW_BATCH_CHUNK, render_batch's group bound, parses and clamps as
    figdraw_tpu's (test_config.py's test_batch_chunk_parses_and_clamps)."""
    if value is None:
        monkeypatch.delenv("FIGDRAW_BATCH_CHUNK", raising=False)
    else:
        monkeypatch.setenv("FIGDRAW_BATCH_CHUNK", value)
    assert port_config.batch_chunk() == jax_config.batch_chunk()
