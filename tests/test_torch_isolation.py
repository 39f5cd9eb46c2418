"""The port imports neither JAX nor anything of `repro`, nor `msgpack`.

In a fresh interpreter: import every module of `repro_torch` and the
modules `chip_smoke.py` imports, then check `sys.modules`. Also scan the
port's sources and `chip_smoke.py` for such imports. (The card's machine
has no JAX and no `msgpack`: the port's checkpoints write their manifest
with their own codec.)"""
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
             if m.split(".")[0] in ("jax", "repro", "msgpack"))
print(len(names), bad)
print(" ".join(names))
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
    walked = set(r.stdout.splitlines()[1].split())
    # the serving simulator's modules, which need its package file to be walked
    assert {"repro_torch.core.serving.engine", "repro_torch.core.serving.federation"} <= walked
    assert {"repro_torch.training.checkpoint", "repro_torch.training.fault_tolerance",
            "repro_torch.core.caching", "repro_torch.launch.compress_and_serve"} <= walked
    assert {"repro_torch.models.recsys.din", "repro_torch.models.recsys.autoint",
            "repro_torch.configs.din", "repro_torch.configs.autoint",
            "repro_torch.launch.quickstart", "repro_torch.data.pipeline"} <= walked
    assert {"repro_torch.models.layers", "repro_torch.models.moe",
            "repro_torch.models.transformer", "repro_torch.distributed.expert_parallel",
            "repro_torch.configs.yi_6b", "repro_torch.configs.olmoe_1b_7b",
            "repro_torch.configs.shapes"} <= walked
    assert {"repro_torch.models.gnn.irreps", "repro_torch.models.gnn.nequip",
            "repro_torch.models.gnn.sampler", "repro_torch.configs.nequip"} <= walked
    assert {"repro_torch.distributed.sharding", "repro_torch.distributed.grad_compression",
            "repro_torch.launch.mesh"} <= walked
    assert {"repro_torch.distributed.collectives", "repro_torch.launch.cells"} <= walked
    assert {"repro_torch.launch.dryrun", "repro_torch.launch.hlo_stats",
            "repro_torch.launch.analysis", "repro_torch.kernels.work"} <= walked
    assert {"repro_torch.launch.elastic_scaling", "repro_torch.launch.multi_cell"} <= walked


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)|from\s+repro(\.|\s)"
    r"|import\s+msgpack\b|from\s+msgpack\b)",
    re.MULTILINE,
)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_has_no_jax_or_repro_import(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, hits
