"""No module of the benchmark imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and the
plain reference imports nothing of the program either."""
import ast
import sys

from bench.tests.smoke import ROOT

BENCH = ROOT / "bench"
JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    bad = {str(p.relative_to(ROOT)): sorted(set(_imports(p)) & JAX)
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    for p in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in set(_imports(p)), p


def test_the_process_check_compares_whole_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    try:
        import run as bench_run
    finally:
        sys.path.remove(str(BENCH))
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    assert "repro" not in bench_run.loaded_forbidden() or \
        "repro" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro" in bench_run.loaded_forbidden()
