"""No module that the benchmark runs imports JAX or the JAX package, and the
plain references import nothing of the program. Names are compared by the
whole top-level name: `robocheck_tpu_torch` is the program, `robocheck_tpu`
the JAX package."""
import ast

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "robocheck_tpu"}


def _top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _run_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_nothing_the_benchmark_runs_imports_jax():
    files = _run_files()
    assert len(files) > 10
    for path in files:
        assert not (_top_names(path) & FORBIDDEN), path


def test_the_references_import_nothing_of_the_program():
    for path in (BENCH / "ref").rglob("*.py"):
        assert "robocheck_tpu_torch" not in _top_names(path), path
        assert not (_top_names(path) & FORBIDDEN), path


def test_the_whole_name_is_compared():
    from harness import cli

    assert "robocheck_tpu" in cli.FORBIDDEN
    assert "robocheck_tpu_torch".split(".")[0] not in cli.FORBIDDEN
