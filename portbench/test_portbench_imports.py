"""No module of the benchmark imports JAX or the JAX package, and the
yardstick imports nothing of the port: a static scan comparing each
imported module's top-level name whole (``repro_torch`` begins with
``repro``)."""
import ast
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: the reference and its model files, the counts, the
# dataset, the comparison, the trace arithmetic and the constants take
# nothing from the program
YARDSTICK = ("reference", "counts", "dataset", "compare", "devtrace", "h100",
             "stages")


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_yardstick_and_the_readers_import_nothing_of_the_port():
    readers = sorted((HERE / "metrics").glob("*.py"))
    models = sorted((HERE / "models").glob("*.py"))
    assert readers and models
    for path in [HERE / f"{m}.py" for m in YARDSTICK] + readers + models:
        assert "repro_torch" not in top_level_imports(path), path


def test_the_run_refuses_by_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro" in harness.forbidden_modules()
