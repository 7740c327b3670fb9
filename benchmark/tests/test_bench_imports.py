"""What the benchmark may import: nothing of JAX or of the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), none of the repository's root scripts, and in the reference
nothing of the port either."""

import ast
import subprocess
import sys
import types

from benchmark import harness, run

ROOT_SCRIPTS = {p.stem for p in harness.ROOT.glob("*.py")}


def imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    return sorted((harness.HERE / sub).rglob("*.py"))


def test_no_file_imports_jax_the_jax_package_or_a_root_script():
    for path in sources():
        found = imports(path)
        assert not found & set(harness.FORBIDDEN), path
        assert not found & ROOT_SCRIPTS, path


def test_the_reference_imports_nothing_of_the_port():
    for sub in ("reference",):
        for path in sources(sub):
            assert "eegan_tpu_torch" not in imports(path), path
    for name in ("opcount.py", "counts.py", "weights.py", "inputs.py",
                 "check.py", "trace.py"):
        assert "eegan_tpu_torch" not in imports(harness.HERE / name), name


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("eegan_tpu_torch", "eegan_tpu_torch.ops", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "eegan_tpu.models",
                        types.ModuleType("eegan_tpu.models"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["eegan_tpu", "jaxlib"]


def test_the_port_and_the_benchmark_load_no_jax():
    code = ("import sys; import benchmark.run, benchmark.drivers.train, "
            "benchmark.drivers.generate, eegan_tpu_torch.training.steps, "
            "eegan_tpu_torch.models.factory; from benchmark import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.strip() == "[]"


def test_no_result_without_a_card(capsys):
    rc = run.main(["--workload", "bird-train-b32", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""
