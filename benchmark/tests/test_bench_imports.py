"""No module of the benchmark imports JAX or the JAX package, and the
reference (with the inputs it reads) imports nothing of the program.
Top-level module names are compared whole: the port's name begins with
the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gaussianeditor_tpu"}
PROGRAM = "gaussianeditor_tpu_torch"


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "scene.py"])
def test_reference_imports_nothing_of_the_program(name):
    assert PROGRAM not in top_level_imports(BENCH / name)


def test_the_names_are_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import gaussianeditor_tpu_torch.ops\nimport jaxtyping\n"
                 "from gaussianeditor_tpu_torch import testing\n")
    assert top_level_imports(p) == {PROGRAM, "jaxtyping"}
    assert not top_level_imports(p) & FORBIDDEN


def test_at_most_eight_code_files():
    code = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(code) <= 8
