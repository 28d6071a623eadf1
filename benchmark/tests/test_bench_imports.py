"""No module of the benchmark imports JAX or the JAX package, its
extension modules (`benchmark/ext/`) included, and the reference (with
the inputs it reads) imports nothing of the program. Top-level module
names are compared whole: the port's name begins with the JAX
package's."""

import ast
import subprocess
import sys
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


@pytest.mark.parametrize("path", MODULES, ids=lambda p: (
    f"ext/{p.name}" if p.parent.name == "ext" else p.name))
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


def test_extension_modules_load_no_jax():
    """Every module of `benchmark/ext/`, as the harness loads them, in a
    fresh interpreter: nothing of JAX or the JAX package in
    `sys.modules` after."""
    code = ("import sys; from benchmark import ext; ext.load(); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert not set(ast.literal_eval(out.stdout.strip().splitlines()[-1])) \
        & FORBIDDEN


def test_at_most_eight_code_files():
    """The harness's own modules; a configuration's extension module
    under `ext/` is its own file."""
    code = list(BENCH.glob("*.py"))
    assert len(code) <= 8
