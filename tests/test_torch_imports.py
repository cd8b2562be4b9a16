"""figdraw_tpu_torch and chip_smoke.py import nothing of JAX or of the JAX
package figdraw_tpu, and nothing of fontTools or PIL (the card's machine has
neither; the text pipeline reads fonts with the port's own OpenType reader):
every module of the port imports in a process where `jax`, `figdraw_tpu`,
`fontTools` and `PIL` cannot be imported, and no source file of the port or
the smoke script names any of them in an import statement, at any depth
(the smoke script and the port import some modules inside functions)."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "figdraw_tpu_torch")
SOURCES = sorted(
    os.path.relpath(os.path.join(root, name), REPO)
    for root, _dirs, names in os.walk(PORT)
    for name in names if name.endswith(".py")
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "figdraw_tpu", "fontTools", "PIL")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_no_jax(path):
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'figdraw_tpu', 'fontTools', 'PIL'):\n"
        "    sys.modules[name] = None\n"
        "import figdraw_tpu_torch\n"
        "names = ['figdraw_tpu_torch'] + [m.name for m in pkgutil.walk_packages(\n"
        "    figdraw_tpu_torch.__path__, 'figdraw_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m, v in sys.modules.items()\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'figdraw_tpu', 'fontTools', 'PIL')\n"
        "       and v is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    # the package and every module under it (ops/ and its modules included)
    assert int(res.stdout.strip().splitlines()[-1]) >= len(SOURCES) - 1
