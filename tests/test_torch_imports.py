"""The port stands alone: no file of ``eegan_tpu_torch/`` and neither
``chip_smoke.py`` nor ``chip_variants.py`` imports JAX, flax or the JAX
package (``eegan_tpu``).
Checked on the source (AST), so an import inside a function counts too."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "eegan_tpu")


def _port_files():
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py",
                                             "chip_variants.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "eegan_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_files_are_found():
    files = _port_files()
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert "chip_smoke.py" in rel and "chip_variants.py" in rel
    assert os.path.join("eegan_tpu_torch", "ops", "affine.py") in rel
    assert len(files) > 15


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
