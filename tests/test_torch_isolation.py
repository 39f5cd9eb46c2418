"""The port imports neither JAX nor anything of `repro`.

In a fresh interpreter: import every module of `repro_torch` and the
modules `chip_smoke.py` imports, then check `sys.modules`. Also scan the
port's sources and `chip_smoke.py` for such imports."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_PROBE = r"""
import importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)  # runs its imports; main() only runs under __main__
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_load_no_jax_and_no_repro():
    r = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO / "chip_smoke.py")],
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, cwd=str(REPO),
    )
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20  # the walk reached the whole package


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_has_no_jax_or_repro_import(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, hits
