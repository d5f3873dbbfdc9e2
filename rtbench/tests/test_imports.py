"""No module of the benchmark imports JAX or the JAX package, with the
top-level names compared whole (the program's name begins with the JAX
package's); the reference and its inputs import nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "rt_tpu"}
# the modules whose numbers the check trusts: nothing of the program
PLAIN = ("reference.py", "inputs.py", "counts.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", PLAIN)
def test_reference_imports_nothing_of_the_program(name):
    names = top_level_imports(BENCH / name)
    assert "rt_tpu_torch" not in names
    assert names <= {"__future__", "math", "numpy", "torch"}


def test_names_compared_whole():
    from rtbench.core import forbidden_modules

    assert forbidden_modules({"rt_tpu_torch": 1, "rt_tpu_torch.ops": 1, "jaxtyping": 1}) == []
    assert forbidden_modules({"rt_tpu.scene": 1, "jax.numpy": 1}) == ["jax", "rt_tpu"]
