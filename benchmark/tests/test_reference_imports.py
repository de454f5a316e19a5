"""What the reference and the harness import, by top-level module name."""

import ast
import pathlib
import subprocess
import sys
import types

from benchmark import run

BENCH = pathlib.Path(__file__).resolve().parents[1]
REPO = BENCH.parent


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program_or_jax():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        names = top_level_imports(f)
        assert names <= {"__future__", "contextlib", "math", "typing",
                         "numpy", "torch", "benchmark"}, (f, names)
        mods = {n.module for n in ast.walk(ast.parse(f.read_text()))
                if isinstance(n, ast.ImportFrom) and n.module}
        assert all(m == "benchmark.reference" or
                   m.startswith("benchmark.reference.") or
                   m.split(".")[0] != "benchmark" for m in mods), (f, mods)


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    """A tiny cell run end to end in a fresh process, then the harness's
    own check of ``sys.modules`` by whole top-level names."""
    code = (
        "import pathlib, torch\n"
        "from benchmark import run\n"
        "from benchmark.tests import tiny\n"
        f"root = tiny.tree(pathlib.Path({str(tmp_path)!r}))\n"
        "line = run.run_cell('tiny_omg', 9, 0.0, False,"
        " device=torch.device('cpu'), root=root)\n"
        "assert line['correct'], line\n"
        "print('FORBIDDEN', run.forbidden_modules())\n"
        "import sys; print('TORCH_PORT', 'omg_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
    assert "TORCH_PORT True" in out.stdout


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    for name in ("jaxlib", "omg_tpu.models", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "omg_tpu_torch_extra",
                        types.ModuleType("omg_tpu_torch_extra"))
    found = run.forbidden_modules()
    assert {"jaxlib", "omg_tpu.models", "flax.linen"} <= set(found)
    assert not any(m.startswith("omg_tpu_torch") for m in found)
