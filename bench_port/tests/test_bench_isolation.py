"""No module of the benchmark imports JAX or the JAX package (compared by whole
top-level module name: `langsplat_tpu_torch` is not `langsplat_tpu`), and the plain
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "langsplat_tpu"}


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") ==
              "import_module" and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def sources(under: Path) -> list[Path]:
    return sorted(p for p in under.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(BENCH / "reference"):
        tops = imported_tops(path)
        assert "langsplat_tpu_torch" not in tops, path
        assert tops <= {"__future__", "math", "typing", "numpy", "torch", "bench_port"}, \
            (path, tops)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert not node.module.startswith("bench_port.") or \
                    node.module.startswith("bench_port.reference"), (path, node.module)


def test_a_run_loads_no_jax_module():
    """Import what a run imports (the harness, every driver and metric reader), then
    list the loaded modules whose top-level name is forbidden."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import bench_port.run, bench_port.harness as h, bench_port.trace\n"
        "import bench_port.drivers.train, bench_port.drivers.render\n"
        "import pathlib\n"
        "for p in sorted(pathlib.Path(%r).glob('*.py')): h.metric_reader(p.stem)\n"
        "print(h.loaded_forbidden())\n") % (str(ROOT), str(BENCH / "metrics"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
