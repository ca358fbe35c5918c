"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (whole names, so
    ``repro_torch`` is not ``repro``)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_module_loads_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert "repro_torch" not in names and "portbench" not in names, path


def test_top_level_names_are_compared_whole():
    from portbench import run
    assert not {"repro_torch", "jaxtyping"} & set(run.FORBIDDEN)
