"""The dry run (`launch/dryrun.py`) against `repro`'s, on the CPU.

Parity: the rank tests' reduced yi_6b- and olmoe-shaped LM cells
(`test_torch_lm_ranks_train._desc`: 2 layers, D 512, f32; train, prefill
and decode at small sizes of their shapes' kinds) and fm, din, autoint and
dien's recsys cells as configured (train and serve at 512 examples), on the
(1, 1) and (2, 2) meshes. The port traces each cell on a fake process group
of 1 or 4 ranks (rank 0's blocks, fake tensors); `repro` jits the same cell
on as many forced CPU devices (`torch_ranks.Reference`; its subprocess puts
the smaller shapes into `repro.configs.shapes.FAMILY_SHAPES`, which edits
no file) and reads `hlo_stats.analyze` of the compiled HLO. The port's dot
flops equal `repro`'s within rel 1e-6, less three gaps, each asserted to
the flop by formula (`_gap`; PERF.md §6 has the ops):

- DIEN serve: the AUGRU's recurrence h @ wh, dots in `repro`'s scan and a
  hand-written kernel in the port (its work goes under `kernels`): the
  port counts 6·B·T·g² fewer, B the rank's rows.
- DIEN train: the gradient of the initial state of each of the two GRUs
  (the interest extractor's and the AUGRU's plain backward), [B, 3g] @
  [3g, g] at step 0, which XLA's loop computes and eager autograd skips
  (h0 needs no gradient): 2·6·B·g² fewer.
- olmoe decode across ranks: the port's `moe_ffn_tp` routes the whole
  batch on every rank; XLA splits the router's product by rows and by its
  contraction: 2·E·(B·D − (B/dp)·(D/tp)) more a layer.

Each rank's `argument_bytes` equals the bytes of its blocks under the cell's
`in_specs`. The command line writes a record with `repro`'s keys (but the
two XLA-only ones, `raw_cost_analysis` and `hlo_bytes`) and refuses
NequIP's cell and an LM layout that runs on one rank only with `.err.json`
and exit 1. `analysis.model_flops_lm` and `mfu_ratio` equal `repro`'s.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_ranks  # noqa: E402
import torch_workers  # noqa: E402,F401
from repro.configs.base import get_config as repro_config  # noqa: E402
from repro.launch import analysis as repro_analysis  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.shapes import FAMILY_SHAPES  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.hlo_stats import COLL_KINDS  # noqa: E402
from test_torch_lm_ranks_train import _desc  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MESHES = [(1, 1), (2, 2)]
REL = 1e-6
LM_SHAPES = {"train": ("train_4k", {"seq_len": 32, "global_batch": 8}),
             "prefill": ("prefill_32k", {"seq_len": 32, "global_batch": 4}),
             "decode": ("decode_32k", {"seq_len": 64, "global_batch": 8})}
REC_SHAPES = {"train": "train_batch", "serve": "serve_p99"}
REC_BATCH = 512
DEADLINE_S = 240


def _cases():
    out = []
    for short in ("yi", "olmoe"):
        desc = _desc(short)
        for kind, (name, size) in LM_SHAPES.items():
            out.append({"id": f"{desc['arch']}:{kind}", "family": "lm", "arch": desc["arch"],
                        "over": desc["over"], "shape_name": name,
                        "shape": {"name": name, "kind": kind, **size}})
    for arch in ("fm", "din", "autoint", "dien"):
        for kind, name in REC_SHAPES.items():
            out.append({"id": f"{arch}:{kind}", "family": "recsys", "arch": arch, "over": {},
                        "shape_name": name,
                        "shape": {"name": name, "kind": kind, "batch": REC_BATCH}})
    return out


CASES = _cases()

PORT = r"""
import json, math, sys
import torch
from repro_torch.configs import shapes
from repro_torch.configs.base import get_config
from repro_torch.distributed.sharding import block_slices
from repro_torch.launch import dryrun
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import axis_names, make_mesh

cases, mesh_shape = json.loads(sys.argv[1]), tuple(json.loads(sys.argv[2]))
dryrun.start_fake_group(math.prod(mesh_shape))
mesh = make_mesh(mesh_shape, axis_names(mesh_shape), "cpu")
coord = tuple(mesh.get_coordinate())


def block_bytes(tree, specs):
    if isinstance(tree, dict):
        return sum(block_bytes(v, specs[k]) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(block_bytes(v, s) for v, s in zip(tree, specs))
    sl = block_slices(tree.shape, specs, mesh, coord)
    return math.prod(s.stop - s.start for s in sl) * tree.element_size()


out = {}
for c in cases:
    cls = {"lm": shapes.LMShape, "recsys": shapes.RecSysShape}[c["family"]]
    cell = build_cell(c["arch"], c["shape_name"], mesh, cfg=get_config(c["arch"], **c["over"]),
                      shape=cls(**c["shape"]))
    t = dryrun.trace(cell, mesh, torch.device("cpu"))
    out[c["id"]] = {"flops": t["stats"]["flops"], "collectives": t["stats"]["collectives"],
                    "kernels": t["stats"]["kernels"],
                    "argument_bytes": t["memory"]["argument_bytes"],
                    "block_bytes": block_bytes(cell.args, cell.in_specs)}
print(json.dumps(out))
"""

REFERENCE = r"""
import json, sys
import jax, numpy as np
from repro.configs import shapes
from repro.launch.cells import build_cell
from repro.launch.hlo_stats import analyze
from repro.launch.mesh import compat_make_mesh

cases, mesh_shape = json.loads(sys.argv[1]), tuple(json.loads(sys.argv[2]))
mesh = compat_make_mesh(mesh_shape, ("data", "model"),
                        devices=jax.devices()[:int(np.prod(mesh_shape))])
out = {}
for c in cases:
    cls = {"lm": shapes.LMShape, "recsys": shapes.RecSysShape}[c["family"]]
    # a smaller shape of the registered kind, in this process only
    shapes.FAMILY_SHAPES[c["family"]][c["shape_name"]] = cls(**c["shape"])
    cell = build_cell(c["arch"], c["shape_name"], mesh, overrides=c["over"])
    with mesh:
        hlo = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                      out_shardings=cell.out_shardings).lower(*cell.args).compile().as_text()
    st = analyze(hlo)
    out[c["id"]] = {"flops": st["flops"], "collectives": st["collectives"]}
print(json.dumps(out))
"""


def _counts(cases) -> dict:
    """{mesh: (port's records, repro's)} for every case, the four
    subprocesses at once."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(REPO / "src"),
           "HOME": os.environ.get("HOME", "/tmp")}
    arg = json.dumps(cases)
    refs = {m: torch_ranks.Reference(REFERENCE, [arg, json.dumps(m)], n_devices=4,
                                     timeout=DEADLINE_S) for m in MESHES}
    ports = {m: subprocess.Popen([sys.executable, "-c", PORT, arg, json.dumps(m)], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for m in MESHES}
    out = {}
    try:
        for m in MESHES:
            stdout, stderr = ports[m].communicate(timeout=DEADLINE_S)
            assert ports[m].returncode == 0, stderr
            out[m] = (json.loads(stdout.splitlines()[-1]), json.loads(refs[m].wait()))
    finally:
        for m in MESHES:
            refs[m].kill()
            if ports[m].poll() is None:
                ports[m].kill()
                ports[m].communicate()
    return out


@pytest.fixture(scope="module")
def counts():
    return _counts(CASES)


def _gap(case, mesh) -> float:
    """The port's dot flops less `repro`'s, by formula (the module's
    docstring)."""
    dp, tp = mesh
    kind = case["shape"]["kind"]
    if case["arch"] == "dien":
        cfg = get_config("dien")
        B, T, g = case["shape"]["batch"] // dp, cfg.seq_len, cfg.gru_dim
        return -6 * B * T * g * g if kind == "serve" else -2 * 6 * B * g * g
    if case["arch"] == "olmoe_1b_7b" and kind == "decode":
        cfg = get_config(case["arch"], **case["over"])
        B, D, E = case["shape"]["global_batch"], cfg.d_model, cfg.n_experts
        layers = cfg.n_layers // cfg.moe_interleave
        return layers * 2 * E * (B * D - (B // dp) * (D // tp))
    return 0


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("case", CASES, ids=lambda c: c["id"])
def test_dot_flops_equal_repros_on_the_same_mesh(counts, case, mesh):
    port, ref = (side[case["id"]] for side in counts[mesh])
    gap = _gap(case, mesh)
    assert abs(port["flops"] - ref["flops"] - gap) <= REL * ref["flops"], \
        (port["flops"], ref["flops"], gap)
    if case["arch"] == "dien" and case["shape"]["kind"] == "serve":
        # the gap is the kernel's recurrence: its work less 16 elementwise ops a unit and step
        cfg = get_config("dien")
        rows_steps = case["shape"]["batch"] // mesh[0] * cfg.seq_len
        assert port["kernels"]["augru"]["flops"] - 16 * cfg.gru_dim * rows_steps == -gap
    assert port["argument_bytes"] == port["block_bytes"]


def _run_cli(tmp_path, *args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                             "--device", "cpu", "--results", str(tmp_path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


REPRO_KEYS = {"cell", "mesh", "n_chips", "optimizer", "tag", "meta", "flops", "bytes_accessed",
              "collectives", "collective_counts", "top_computations", "memory", "timings"}


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    runs = {"fm": _run_cli(tmp, "--arch", "fm", "--shape", "serve_p99", "--mesh", "single"),
            "nequip": _run_cli(tmp, "--arch", "nequip", "--shape", "molecule", "--mesh", "single"),
            "tp": _run_cli(tmp, "--arch", "yi_6b", "--shape", "train_4k", "--mesh", "single",
                           "--overrides", '{"train_layout": "tp"}', "--tag", "tp")}
    done = {}
    for k, p in runs.items():
        stdout, stderr = p.communicate(timeout=DEADLINE_S)
        done[k] = (p.returncode, stdout, stderr)
    return tmp, done


def test_the_command_line_writes_a_record_with_repros_keys(cli):
    tmp, done = cli
    rc, stdout, stderr = done["fm"]
    assert rc == 0, stderr
    rec = json.loads((tmp / "fm__serve_p99__single.json").read_text())
    assert REPRO_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    assert set(rec["collectives"]) == set(COLL_KINDS) | {"total"}
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256 and rec["device"] == "cpu"
    assert rec["kernels"]["embedding_bag"]["calls"] >= 1
    assert rec["kernels"]["fm_interaction"]["calls"] == 1
    assert rec["peak_bytes"] == rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
    assert rec["fits"] and rec["roofline"]["n_chips"] == 256
    assert stdout.startswith("OK fm:serve_p99 [16x16]")


@pytest.mark.parametrize("which,name,refusal", [
    ("nequip", "nequip__molecule__single.err.json", "runs on a mesh of one rank"),
    ("tp", "yi_6b__train_4k__single__tp.err.json", "ValueError"),
])
def test_a_cell_that_refuses_its_mesh_writes_err_json(cli, which, name, refusal):
    tmp, done = cli
    rc, stdout, _ = done[which]
    assert rc == 1 and stdout.startswith("FAIL")
    err = json.loads((tmp / name).read_text())
    assert refusal in err["error"]
    assert not (tmp / name.replace(".err.json", ".json")).exists()


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_cell("fm", "serve_p99", False, "adamw")


@pytest.mark.parametrize("arch", ["yi_6b", "chatglm3_6b", "command_r_35b", "olmoe_1b_7b",
                                  "llama4_maverick_400b_a17b"])
@pytest.mark.parametrize("shape", sorted(FAMILY_SHAPES["lm"]))
def test_model_flops_and_mfu_ratio_equal_repros(arch, shape):
    s = FAMILY_SHAPES["lm"][shape]
    tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
    mine = analysis.model_flops_lm(get_config(arch), tokens, s.kind)
    theirs = repro_analysis.model_flops_lm(repro_config(arch), tokens, s.kind)
    assert mine == theirs > 0
    assert analysis.mfu_ratio(mine / 256, 1.234e12) == repro_analysis.mfu_ratio(theirs / 256,
                                                                                 1.234e12)


# yi_6b-shaped at its registry shapes with the config's KV chunk of 1,024
# (`python tests/test_torch_dryrun.py`; too slow for tier-1)
REGISTRY_CASES = [{**c, "id": c["id"] + "@registry",
                   "over": {k: v for k, v in c["over"].items() if k != "q_chunk"},
                   "shape": {**c["shape"], **{k: getattr(FAMILY_SHAPES["lm"][c["shape_name"]], k)
                                              for k in ("seq_len", "global_batch")}}}
                  for c in CASES if c["arch"] == "yi_6b" and c["shape"]["kind"] != "decode"]


def main() -> None:
    """Print, for every case (and `REGISTRY_CASES`) on each mesh, the port's
    and `repro`'s dot flops and collective bytes a device by kind, as a
    markdown table (PERF.md's)."""
    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
    print("| case | mesh | port flops | repro flops | gap by formula | port AG / AR / RS / A2A / "
          "CP | repro AG / AR / RS / A2A / CP |\n|---|---|---|---|---|---|---|")
    runs = _counts(CASES + REGISTRY_CASES)
    for c in CASES + REGISTRY_CASES:
        for m in MESHES:
            port, ref = (side[c["id"]] for side in runs[m])
            colls = [" / ".join(f"{x['collectives'][k]:.4g}" for k in kinds) for x in (port, ref)]
            print(f"| {c['id']} | {m[0]}x{m[1]} | {port['flops']:.7g} | {ref['flops']:.7g} | "
                  f"{_gap(c, m):.7g} | {colls[0]} | {colls[1]} |")


if __name__ == "__main__":
    main()
