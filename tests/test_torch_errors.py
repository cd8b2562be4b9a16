"""Device errors in figdraw_tpu_torch (the intent of tests/test_fallback.py,
which pins the JAX package's fallback chain): the port has none. A failed
nvcc build raises with the compiler's message; a failure inside a frame's
executor reaches the caller of render_frame, render_batch (with no
per-frame retry), render_frame_async's Future and
render_frame_with_overlays; and a read of the sources finds no `except`
on those paths that could swallow a kernel or build error. A scene the
JAX package sends from its native walk to its Python walk renders here on
the native walk, within 1/255 of its frame."""

import ast
import inspect
import os
import stat

import numpy as np
import pytest
import torch

import figdraw_tpu_torch as port
from figdraw_tpu_torch import executor, renderer as port_renderer
from figdraw_tpu_torch.ops import blur, nvcc
from test_async_pipeline import _scene
from torch_reference import to_port

torch.set_num_threads(1)  # see tests/test_torch_render_frame.py

SIZE = port.vec2(160, 128)


def _fake_nvcc(tmp_path, message: str) -> str:
    path = tmp_path / "nvcc"
    path.write_text(f"#!/bin/sh\necho '{message}' >&2\nexit 2\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_a_failed_nvcc_build_raises_with_the_compilers_message(monkeypatch, tmp_path):
    msg = "blur.cu(12): error: identifier undefined"
    monkeypatch.setattr(nvcc, "_nvcc", lambda: _fake_nvcc(tmp_path, msg))
    monkeypatch.setattr(nvcc, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="identifier undefined") as info:
        nvcc.build("figdraw_blur", ("blur.cu",))
    assert "nvcc failed on csrc/blur.cu" in str(info.value)
    assert not [p for p in os.listdir(tmp_path / "build") if p.endswith(".so")]
    # the kernel's loader passes it on and stays unbuilt: the next call
    # builds again, it does not fall back
    monkeypatch.setattr(blur, "_lib", None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="identifier undefined"):
            blur.load()
    assert blur._lib is None


def test_no_compiler_raises(monkeypatch):
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc._nvcc()


class _Injected(RuntimeError):
    pass


@pytest.fixture
def failing_binning(monkeypatch):
    """Every executor run fails at its binning, as a kernel launch would."""
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise _Injected("injected kernel failure")

    monkeypatch.setattr(executor, "decode_and_bin", boom)
    return calls


def test_render_frame_raises(failing_binning):
    with pytest.raises(_Injected):
        port.FigRenderer(atlas_size=64, device="cpu").render_frame(to_port(_scene(0)), SIZE)
    assert len(failing_binning) == 1


def test_a_batch_raises_with_no_per_frame_retry(failing_binning):
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    with pytest.raises(_Injected):
        ren.render_batch([to_port(_scene(f)) for f in range(3)], SIZE)
    assert len(failing_binning) == 1  # the group's first frame, and nothing after


def test_an_async_frame_raises_at_its_result(failing_binning):
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    fut = ren.render_frame_async(to_port(_scene(0)), SIZE)
    with pytest.raises(_Injected):
        fut.result()
    assert len(failing_binning) == 1


def test_an_overlay_frame_raises(failing_binning):
    ren = port.FigRenderer(atlas_size=64, device="cpu")
    with pytest.raises(_Injected):
        ren.render_frame_with_overlays(to_port(_scene(0)), SIZE,
                                       {5: np.zeros((128, 160, 4), np.float32)})
    assert len(failing_binning) == 1


def _function(module, qualname: str) -> ast.AST:
    tree = ast.parse(inspect.getsource(module))
    parts = qualname.split(".")
    nodes = tree.body
    for i, name in enumerate(parts):
        found = [n for n in nodes if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                 and n.name == name]
        assert found, qualname
        node = found[0]
        nodes = node.body
    return node


@pytest.mark.parametrize("module,qualname", [
    (port_renderer, "FigRenderer.render_frame"),
    (port_renderer, "FigRenderer._walk_plan"),
    (port_renderer, "FigRenderer.execute_plan"),
    (port_renderer, "FigRenderer._run_plan"),
    (port_renderer, "FigRenderer.render_frame_async"),
    (port_renderer, "FigRenderer.drain_async"),
    (port_renderer, "FigRenderer.render_batch"),
    (port_renderer, "FigRenderer._dispatch_batch"),
    (port_renderer, "FigRenderer.render_frame_with_overlays"),
    (port_renderer, "_Staging.upload"),
    (executor, "run_batch"),
    (executor, "BatchStack"),
    (executor, "get_frame_executor"),
    (executor, "get_mega_executor"),
])
def test_no_except_on_the_frame_paths(module, qualname):
    """No handler on these paths could catch a kernel or build error and
    carry on: a `try` there has a `finally` (the async job releases its
    slot) and no `except`."""
    node = _function(module, qualname)
    for t in ast.walk(node):
        if isinstance(t, ast.Try):
            assert not t.handlers, f"{qualname} catches: {ast.unparse(t.handlers[0])}"
            assert t.finalbody


def test_a_cuda_renderer_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.FigRenderer(device="cuda")


def test_a_drawable_array_renders_on_the_native_walk():
    """test_fallback.py's drawable scene: the JAX package sends it from its
    native walk to its Python walk; the port's native walk draws it, within
    1/255 of the JAX frame."""
    import figdraw_tpu as japi
    from figdraw_tpu.nodes import RenderList, drawable_line
    from figdraw_tpu.nodesarray import from_renders
    from figdraw_tpu.renderer import FigRenderer as JaxRenderer

    r = japi.new_renders()
    lst = RenderList()
    lst.add_root(japi.Fig(kind=japi.FigKind.nkDrawable, screen_box=japi.rect(0, 0, 64, 48),
                          draw_stroke=japi.RenderStroke(
                              weight=3.0, fill=japi.fill(japi.rgba(0, 0, 255, 255))),
                          draw_ops=(drawable_line(japi.vec2(5, 5), japi.vec2(50, 40)),)))
    r.set_layer(0, lst)
    arr = from_renders(r)
    jr = JaxRenderer(atlas_size=64, use_pallas=False)
    ref = np.asarray(jr.render_frame(arr, japi.vec2(64, 48)))
    got = port.FigRenderer(atlas_size=64, device="cpu").render_frame(
        to_port(arr), port.vec2(64, 48))
    assert (np.clip(np.round(got.numpy() * 255), 0, 255)[..., 2] > 180).sum() > 20
    assert np.abs(got.numpy() - ref).max() <= 1.0 / 255.0
