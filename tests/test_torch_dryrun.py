"""The dry run (`launch/dryrun.py`) against `repro`'s, on the CPU.

Parity: the rank tests' reduced yi_6b- and olmoe-shaped LM cells
(`test_torch_lm_ranks_train._desc`: 2 layers, D 512, f32; train, prefill
and decode at small sizes of their shapes' kinds), fm, din, autoint and
dien's recsys cells as configured (train and serve at 512 examples), and
NequIP's two kinds reduced as `test_torch_gnn_ranks` reduces them (2
layers, 8 channels; molecule: 16 molecules, full_graph_sm: 480 nodes,
1,440 edges, 16 features), on the (1, 1) and (2, 2) meshes. The port
traces each cell on a fake process group of 1 or 4 ranks (rank 0's
blocks, fake tensors); `repro` jits the same cell
on as many forced CPU devices (`torch_ranks.Reference`; its subprocess puts
the smaller shapes into `repro.configs.shapes.FAMILY_SHAPES`, which edits
no file) and reads `hlo_stats.analyze` of the compiled HLO. The port's dot
flops equal `repro`'s within rel 1e-6, less four gaps, each asserted to
the flop by formula (`_gap`; PERF.md §6 has the ops). The LM's other
layouts join them: yi's int8 prefill and decode, its Megatron train step
(`train_layout="tp"`) and olmoe's whole-batch MoE (`moe_impl="gspmd"`)
train and prefill, the last three with gaps of their own below:

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
- NequIP (L ≥ 2 layers of C channels; E edges and N nodes a rank, the
  graph split over "data"): the port counts 1062·E·C·L + 1548·E·C +
  56·N·C² + 144·E − 828·E·L fewer. (a) 1062·E·C a layer: the coupling
  paths' 3×3 products (`_p121`, `_p122`, `_p221`, `_p222`: `irreps._mm3`
  and elementwise sums in the port, no dot), which XLA holds as dots
  batched over the edges, forward, remat recompute and gradient. (b)
  1548·E·C and 56·N·C²: `repro`'s scan transposes every layer whole,
  where eager autograd skips the gradient of an op whose inputs need none
  (the first layer's zero l ≥ 1 features) or whose output reaches no loss
  (the last layer's l ≥ 1 outputs): there the 774·E·C of `to_matrix`,
  `to_vec5` and `_p122`'s Levi-Civita product, and 16·N·C² (the first
  layer's self_1 and self_2 input gradients), 32·N·C² (the last layer's
  self_1 and self_2) and 8·N·C² (its gate). (c) 144·E − 828·E·L: the
  edges' own `to_matrix(Y_2)` (4 paths) and Levi-Civita product of Y_1,
  which the port computes in each path of each layer, forward and
  recompute (2·L·(4·90 + 54)·E), and XLA hoists out of the layer loop and
  computes once ((90 + 54)·E).
- yi's Megatron train step at (dp, tp), T the rank's B/dp·S tokens: the
  cross entropy's three products over the vocabulary, which XLA takes on
  every row of the table on each rank (it gathers the table for the
  chunked scan) and the port on its rows (the vocabulary-parallel CE):
  6·T·D·V·(1 − 1/tp) fewer; the attention (its two products of
  2·(B/dp)·H·S²·hd a layer, counted forward, in remat's recompute and
  twice backward), which each rank of "model" computes whole in the port
  and XLA splits over "model": 4·L·2·2·(B/dp)·H·S²·hd·(1 − 1/tp) more.
- olmoe under `moe_impl="gspmd"` (train and prefill, B·S tokens of the
  whole batch): the router's product, which the port takes on the whole
  batch on every rank and XLA on the rank's rows over "data":
  L·2·B·S·D·E·(1 − 1/dp) more, four times in a train step.
(These two read off the compiled HLO's dots at (2, 2).)

Each rank's `argument_bytes` equals the bytes of its blocks under the cell's
`in_specs`. The command line writes a record with `repro`'s keys (but the
two XLA-only ones, `raw_cost_analysis` and `hlo_bytes`), NequIP's
molecule cell on 16x16 among them (its collectives all-gathers and
reduce-scatters) and yi_6b's train step under `train_layout="tp"`, and
refuses FM's adam8bit step (a 0-d leaf) with `.err.json` and exit 1. `analysis.model_flops_lm` and `mfu_ratio` equal `repro`'s.
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
from repro_torch.configs.shapes import FAMILY_SHAPES, GNNShape  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
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
GNN_OVER = {"n_layers": 2, "d_hidden": 8}
GNN_CASE_SHAPES = {"molecule": {"name": "molecule", "n_nodes": 30, "n_edges": 64, "d_feat": None,
                           "kind": "batched_small", "graph_batch": 16},
              "full_graph_sm": {"name": "full_graph_sm", "n_nodes": 480, "n_edges": 1440,
                                "d_feat": 16, "kind": "full_batch"}}
DEADLINE_S = 240


def _cases():
    out = []
    for short in ("yi", "olmoe"):
        desc = _desc(short)
        for kind, (name, size) in LM_SHAPES.items():
            out.append({"id": f"{desc['arch']}:{kind}", "family": "lm", "arch": desc["arch"],
                        "over": desc["over"], "shape_name": name,
                        "shape": {"name": name, "kind": kind, **size}})
    # the LM's other layouts
    for short, over, kinds in (("yi", {"train_layout": "tp"}, ("train",)),
                               ("yi", {"int8_serve": True}, ("prefill", "decode")),
                               ("olmoe", {"moe_impl": "gspmd"}, ("train", "prefill"))):
        desc = _desc(short)
        for kind in kinds:
            name, size = LM_SHAPES[kind]
            out.append({"id": f"{desc['arch']}:{kind}:{next(iter(over))}", "family": "lm",
                        "arch": desc["arch"], "over": {**desc["over"], **over},
                        "shape_name": name, "shape": {"name": name, "kind": kind, **size}})
    for arch in ("fm", "din", "autoint", "dien"):
        for kind, name in REC_SHAPES.items():
            out.append({"id": f"{arch}:{kind}", "family": "recsys", "arch": arch, "over": {},
                        "shape_name": name,
                        "shape": {"name": name, "kind": kind, "batch": REC_BATCH}})
    for name, shape in GNN_CASE_SHAPES.items():
        out.append({"id": f"nequip:{name}", "family": "gnn", "arch": "nequip", "over": GNN_OVER,
                    "shape_name": name, "shape": shape})
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
    cls = {"lm": shapes.LMShape, "recsys": shapes.RecSysShape, "gnn": shapes.GNNShape}[c["family"]]
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
    cls = {"lm": shapes.LMShape, "recsys": shapes.RecSysShape, "gnn": shapes.GNNShape}[c["family"]]
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
    cfg = get_config(case["arch"], **case["over"])
    B, S = case["shape"].get("global_batch"), case["shape"].get("seq_len")
    # a train step counts each product forward, again in remat's
    # recompute, and twice in the backward
    uses = 4 if getattr(cfg, "remat", False) else 3
    if case["family"] == "lm" and cfg.moe_impl == "gspmd" and kind in ("train", "prefill"):
        layers = cfg.n_layers // cfg.moe_interleave
        router = layers * 2 * B * S * cfg.d_model * cfg.n_experts
        return router * (1 - 1 / dp) * (uses if kind == "train" else 1)
    if case["family"] == "lm" and cfg.train_layout == "tp" and kind == "train":
        H, hd, V = cfg.n_heads, cfg.resolved_head_dim, cfg.vocab_size
        attention = cfg.n_layers * 2 * 2 * (B // dp) * H * S * S * hd
        return (uses * attention - 6 * (B * S // dp) * cfg.d_model * V) * (1 - 1 / tp)
    if case["arch"] == "nequip":
        cfg = get_config("nequip", **case["over"])
        meta = build_cell("nequip", case["shape_name"], AbstractMesh((1, 1), ("data", "model")),
                          cfg=cfg, shape=GNNShape(**case["shape"])).meta
        N, E, C, L = meta["nodes"] // dp, meta["edges"] // dp, cfg.d_hidden, cfg.n_layers
        return -(1062 * E * C * L + 1548 * E * C + 56 * N * C * C + 144 * E - 828 * E * L)
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
                           "--overrides", '{"train_layout": "tp"}', "--tag", "tp"),
            "fm_a8": _run_cli(tmp, "--arch", "fm", "--shape", "train_batch", "--mesh", "single",
                              "--optimizer", "adam8bit", "--tag", "a8")}
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


def test_nequips_cell_writes_a_record_of_gathers_and_reduce_scatters(cli):
    """NequIP's molecule cell on 16x16: each rank all-gathers the node
    blocks (positions, each layer's features) and reduce-scatters the
    messages' sums and the gathers' gradients over "data"."""
    tmp, done = cli
    rc, stdout, stderr = done["nequip"]
    assert rc == 0, stderr
    assert not (tmp / "nequip__molecule__single.err.json").exists()
    rec = json.loads((tmp / "nequip__molecule__single.json").read_text())
    assert REPRO_KEYS <= set(rec)
    assert rec["mesh"] == "16x16" and rec["meta"]["kind"] == "train"
    counts = rec["collective_counts"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0, counts
    assert rec["collectives"]["all-gather"] > 0 and rec["collectives"]["reduce-scatter"] > 0
    assert rec["kernels"]["embedding_bag"]["calls"] == 1  # the species of this rank's nodes
    assert stdout.startswith("OK nequip:molecule [16x16]")


def test_the_megatron_train_layout_writes_a_record(cli):
    """yi_6b's train_4k under `train_layout="tp"` on 16x16: a record of its
    dot flops, with no all-gather or reduce-scatter (the weights' blocks
    stay in place), only the all-reduces of Megatron's products, the
    vocabulary-split lookup and cross entropy, and the gradients' sums."""
    tmp, done = cli
    rc, stdout, stderr = done["tp"]
    assert rc == 0, stderr
    assert not (tmp / "yi_6b__train_4k__single__tp.err.json").exists()
    rec = json.loads((tmp / "yi_6b__train_4k__single__tp.json").read_text())
    assert REPRO_KEYS <= set(rec) and rec["meta"]["kind"] == "train"
    assert rec["flops"] > 0 and rec["collectives"]["all-reduce"] > 0
    assert rec["collectives"]["all-gather"] == rec["collectives"]["reduce-scatter"] == 0
    assert stdout.startswith("OK yi_6b:train_4k [16x16]")


@pytest.mark.parametrize("which,name,refusal", [
    ("fm_a8", "fm__train_batch__single__a8.err.json", "ValueError"),
])
def test_a_cell_that_refuses_its_mesh_writes_err_json(cli, which, name, refusal):
    """FM's step under adam8bit: its 0-d bias has no last axis to block,
    and both packages refuse it."""
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
