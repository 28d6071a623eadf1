"""The port imports neither JAX nor the JAX package: checked in the source
(AST) and in a fresh interpreter's `sys.modules`."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gaussianeditor_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussianeditor_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py", ROOT / "probe_backward.py",
                          ROOT / "probe_b2_b4.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_fresh_interpreter_stays_clean():
    modules = [
        "gaussianeditor_tpu_torch." + str(p.relative_to(PORT).with_suffix(""))
        .replace(os.sep, ".").replace(".__init__", "")
        for p in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'gaussianeditor_tpu_torch.ops.render' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(ROOT),
                   env=env, timeout=120)
