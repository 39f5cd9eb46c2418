"""The port's copy of the serving simulator stays the reference's code.

`src/repro_torch/core/serving/` copies `src/repro/core/serving/`: only its
imports (`repro_torch.` for `repro.`) and some docstrings differ. Each
module's syntax tree, docstrings removed and the port's imports read as
the reference's, must equal the reference's, so the two cannot drift
apart unnoticed. The copy must also pass the serving stack's own lint
(`python -m tools.lint`), linted with `benchmarks/` as the CI tree is:
the `shard_update` events that `engine.py` handles are pushed there.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "src" / "repro" / "core" / "serving"
PORT = REPO / "src" / "repro_torch" / "core" / "serving"
MODULES = sorted(p.stem for p in REF.glob("*.py"))


class _Normalise(ast.NodeTransformer):
    """Drop docstrings; read `repro_torch` in an import as `repro`."""

    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = _strip

    def visit_ImportFrom(self, node):
        if node.module and (node.module == "repro_torch" or node.module.startswith("repro_torch.")):
            node.module = "repro" + node.module[len("repro_torch"):]
        return node


def _tree(path: Path) -> str:
    return ast.dump(_Normalise().visit(ast.parse(path.read_text())), include_attributes=False)


def test_the_copy_has_every_module_and_a_package_file():
    assert len(MODULES) == 14
    assert sorted(p.stem for p in PORT.glob("*.py")) == sorted(MODULES + ["__init__"])


@pytest.mark.parametrize("module", MODULES)
def test_module_is_the_reference_but_for_imports_and_docstrings(module):
    assert _tree(PORT / f"{module}.py") == _tree(REF / f"{module}.py")


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_the_port_only(module):
    for node in ast.walk(ast.parse((PORT / f"{module}.py").read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("repro"):
            assert node.module.startswith("repro_torch."), node.module


def test_the_copy_passes_the_serving_lint():
    r = subprocess.run(
        [sys.executable, "-m", "tools.lint", "src/repro_torch/core/serving", "benchmarks"],
        capture_output=True, text=True, cwd=str(REPO),
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "simlint: 0 finding(s)" in r.stdout
