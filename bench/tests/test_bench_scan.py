"""The benchmark stands apart: no module under ``bench/`` imports JAX or
the JAX package (``repro``; compared by whole top-level names, since the
port's ``repro_torch`` begins with it), the plain reference imports nothing
of the port, and nothing reads the JAX package's benchmark."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_scan_sees_every_part():
    parts = {p.relative_to(BENCH).parts[0] for p in FILES}
    assert {"run.py", "harness.py", "drivers", "metrics", "reference",
            "tests"} <= parts


def test_no_jax_and_no_jax_package():
    found = {str(p.relative_to(BENCH)): sorted(set(_roots(p)) & FORBIDDEN)
             for p in FILES}
    assert not {k: v for k, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_port():
    for p in sorted((BENCH / "reference").rglob("*.py")):
        roots = set(_roots(p))
        assert "repro_torch" not in roots, p
        assert roots <= {"__future__", "typing", "torch", "bench"}, (p, roots)


def test_nothing_reads_the_jax_package_benchmark():
    for p in FILES:
        if p.name == Path(__file__).name:
            continue
        assert "benchmarks" not in set(_roots(p)), p
        assert "BENCH_scadles" not in p.read_text(), p
