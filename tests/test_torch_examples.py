"""The port's copies of the two serving examples stay the reference's code.

`src/repro_torch/launch/{elastic_scaling,multi_cell}.py` copy
`examples/{elastic_scaling,multi_cell}.py` onto the port's serving
simulator (entry points live in the package: tier-1 lints `benchmarks/`
and the examples stay `repro`'s). Each module's syntax tree, docstrings
removed and the port's imports read as the reference's, equals the
example's (`test_torch_serving_source`'s normalisation); the copies import
nothing of `repro`; and one scenario of each prints the same lines in
both packages: the cascade ranking of `elastic_scaling` and the skewed
fleet with spillover of `multi_cell` (analytic latency curves, a seeded
arrival process: the simulators are the same code, so the same bits).
"""
import ast
import contextlib
import importlib
import importlib.util
import io
from pathlib import Path

import pytest

from test_torch_serving_source import _tree

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = {"elastic_scaling": ("ranking", ("cascade",), {}),
            "multi_cell": ("skewed_fleet", (), {"spillover": True})}


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_the_copy_is_the_example_but_for_imports_and_docstrings(name):
    assert _tree(REPO / "src" / "repro_torch" / "launch" / f"{name}.py") == \
        _tree(REPO / "examples" / f"{name}.py")


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_the_copy_imports_the_port_only(name):
    tree = ast.parse((REPO / "src" / "repro_torch" / "launch" / f"{name}.py").read_text())
    modules = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    modules += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert modules and all(m.startswith("repro_torch.") for m in modules
                           if m.split(".")[0] in ("repro", "repro_torch")), modules
    assert any(m.startswith("repro_torch.core.serving.") for m in modules)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_a_scenario_prints_the_same_lines_in_both_packages(name):
    fn, args, kwargs = EXAMPLES[name]
    printed = []
    for module in (_reference(name), importlib.import_module(f"repro_torch.launch.{name}")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            getattr(module, fn)(*args, **kwargs)
        printed.append(out.getvalue())
    assert printed[0] and printed[0].count("p99=") >= 1
    assert printed[0] == printed[1]
