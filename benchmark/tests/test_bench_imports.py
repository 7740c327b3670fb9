"""What the benchmark may import: nothing of JAX or of the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), none of the repository's root scripts, in the reference
nothing of the port either, and the reference only in the architectures
and ``calibrate.py``: the drivers reach it through a cell's
architecture."""

import ast
import subprocess
import sys
import types

from benchmark import harness, run

ROOT_SCRIPTS = {p.stem for p in harness.ROOT.glob("*.py")}


def modules(path):
    """Every module ``path`` imports, by its whole dotted name (``from a
    import b`` gives ``a`` and ``a.b``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                package = path.relative_to(harness.ROOT).parent.parts
                up = package[:len(package) - node.level + 1]
                base = ".".join([*up, base] if base else up)
            names.add(base)
            names |= {f"{base}.{a.name}" for a in node.names}
    return names


def imports(path):
    return {m.split(".")[0] for m in modules(path)}


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


def test_only_the_architectures_and_calibrate_import_the_reference():
    allowed = {harness.HERE / "calibrate.py"}
    for sub in ("architectures", "reference", "tests"):
        allowed |= set(sources(sub))
    for path in sources():
        found = {m for m in modules(path)
                 if m == "benchmark.reference"
                 or m.startswith("benchmark.reference.")}
        assert path in allowed or not found, (path, found)
    assert any("benchmark.reference.eegan" in modules(path)
               for path in sources("architectures"))


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
            "benchmark.drivers.generate, benchmark.drivers.train_mesh, "
            "benchmark.architectures.eegan, benchmark.reference.eegan_mesh, "
            "benchmark.calibrate, eegan_tpu_torch.training.steps, "
            "eegan_tpu_torch.parallel.mesh, "
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
