"""Nothing under portbench/ imports JAX or the JAX package (top-level names
compared whole: the port's ``repro_torch`` begins with ``repro``), and
nothing reads the JAX package's harness."""

import ast

from pb.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
HARNESS = "bench" + "marks/"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_no_jax_package():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_no_read_of_the_jax_harness():
    for f in BENCH_DIR.rglob("*"):
        if f.is_file() and f.suffix in (".py", ".json", ".sh"):
            assert HARNESS not in f.read_text(), f


def test_run_refuses_a_jax_module(monkeypatch):
    import sys

    import run

    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert run.loaded_forbidden() == ["jax"]
