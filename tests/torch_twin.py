"""Running figdraw_tpu's own tests a second time on figdraw_tpu_torch.

port_twin(name) compiles tests/<name>.py with its `figdraw_tpu` imports
pointed at `figdraw_tpu_torch` into a module of its own, so the twin builds
its scenes and fonts with the port's API from the same numbers and makes the
same assertions. twin_cases lists a file's tests (parametrized ones
expanded), and run_twin runs one with its fixtures: the file's own fixtures
are called from the twin module (once per module, like their module scope),
pytest's (tmp_path, monkeypatch, ...) come from the running test's request.
A twin renders on the CPU: its FigRenderer forces device="cpu" and drops
the JAX package's use_pallas switch.
"""

import ast
import inspect
import os
import re
import sys
import types

from _pytest.fixtures import FixtureFunctionDefinition

TESTS = os.path.dirname(os.path.abspath(__file__))
_IMPORT = re.compile(r"^(\s*)(from|import) figdraw_tpu\b(?!_torch)", re.M)


def port_twin(name: str) -> types.ModuleType:
    """tests/<name>.py with its figdraw_tpu imports pointed at the port."""
    mod_name = f"_port_twin_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = os.path.join(TESTS, name + ".py")
    with open(path) as fh:
        src = _IMPORT.sub(r"\1\2 figdraw_tpu_torch", fh.read())
    mod = types.ModuleType(mod_name)
    mod.__file__ = path
    sys.modules[mod_name] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def test_names(name: str, skip=()):
    """The test functions of tests/<name>.py, in file order."""
    with open(os.path.join(TESTS, name + ".py")) as fh:
        tree = ast.parse(fh.read())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
            and n.name not in skip]


test_names.__test__ = False  # a helper, not a test


def twin_cases(name: str, skip=()):
    """[(name, test, params or None)] for tests/<name>.py, a case per
    parameter set of a parametrized test (one-name parametrize marks)."""
    twin = port_twin(name)
    out = []
    for fn in test_names(name, skip):
        marks = [m for m in getattr(getattr(twin, fn), "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append((name, fn, None))
            continue
        (mark,) = marks
        argname, values = mark.args[0], mark.args[1]
        for v in values:
            out.append((name, fn, {argname: v}))
    return out


def case_id(case) -> str:
    name, fn, params = case
    return f"{name}::{fn}" + ("" if params is None else
                              "[" + ",".join(f"{k}={v}" for k, v in params.items()) + "]")


def _fixture(twin, name: str, request):
    obj = twin.__dict__.get(name)
    if not isinstance(obj, FixtureFunctionDefinition):
        return request.getfixturevalue(name)
    cache = twin.__dict__.setdefault("_twin_fixtures", {})
    if name not in cache:
        func = obj._get_wrapped_function()
        args = {p: _fixture(twin, p, request)
                for p in inspect.signature(func).parameters}
        value = func(**args)
        if inspect.isgenerator(value):
            value = next(value)
        cache[name] = value
    return cache[name]


def cpu_renderer_class():
    """The port's FigRenderer on the CPU, taking (and ignoring) the JAX
    package's use_pallas."""
    import figdraw_tpu_torch as port

    class CpuFigRenderer(port.renderer.FigRenderer):
        def __init__(self, *args, use_pallas=None, device="cpu", **kw):
            super().__init__(*args, device="cpu", **kw)

    return CpuFigRenderer


def run_twin(request, monkeypatch, case) -> None:
    """Run one twin case with its fixtures, on the CPU."""
    import figdraw_tpu_torch as port

    name, fn, params = case
    twin = port_twin(name)
    cls = cpu_renderer_class()
    monkeypatch.setattr(port, "FigRenderer", cls)
    monkeypatch.setattr(port.renderer, "FigRenderer", cls)
    if "FigRenderer" in twin.__dict__:
        monkeypatch.setattr(twin, "FigRenderer", cls)
    func = getattr(twin, fn)
    kwargs = {}
    for p in inspect.signature(func).parameters:
        kwargs[p] = params[p] if params and p in params else _fixture(twin, p, request)
    func(**kwargs)


def assert_runs_on_port(twin) -> None:
    """Nothing the twin names comes from the JAX package."""
    assert not [k for k, v in vars(twin).items()
                if getattr(v, "__module__", "").split(".")[0] == "figdraw_tpu"]
