"""The five recsys archs across gloo ranks against `repro`'s jitted functions
on the same meshes, on the CPU.

`repro` subprocesses on 4 forced CPU devices
(`--xla_force_host_platform_device_count=4`, which the pytest process never
sets), one a mesh, jit each case with the `in_shardings` that
`repro.launch.cells._rec_cell` gives it, on (data, model) = (1, 4), (2, 2),
(4, 1) and (pod, data, model) = (2, 1, 2): `serve` (8 requests),
`retrieval` (one query against 512 candidates), `loss` with its gradients
(8 labelled examples, `RECSYS_RULES`: the batch over (pod, data), the
tables' rows over "model"), and one AdamW step of the train cell. The port
runs the same cases through `launch/cells.build_cell` on the same meshes of
4 gloo ranks (`torch_ranks.recsys_rank`, one spawn for the four), each
rank on its blocks of the same inputs. The inputs are numpy from a seed:
the parameters the port's `init_params` draws at `param_defs`' shapes
(the packages' defs are equal, `test_torch_sharding`), carried into
`repro` as numpy, its `quantize_tree` making the int8 tables, and the
port's `prune_tree` (equal to `repro`'s, `test_torch_pruning`) the
pruned tower; drawing them with `jax.random` leaf by leaf took 15 s.

The cases: every arch at vocabularies cut to 1,000 and (taobao_ssa, DIN,
DIEN) a history of 8; quantized tables (`quantize_tree(..., weights=False)`,
the cell's int8 {"q","s"} tables, their scales split by rows too) served
for FM, DIN and taobao_ssa (`repro` raises for DIEN and AutoInt);
`serve_full_mesh` (the serve batch over every mesh dim, so the lookup
gathers the ids over "model" and reduce-scatters the rows) for FM with
quantized tables, as `tests/test_cells.py`'s variant, and for taobao_ssa;
taobao_ssa with the C2 window 4 (serve and step) and with a tower pruned
in 128-tiles (`prune_tree(..., structured=True)`; the port serves it
through the block-pruned kernel's plain version).

Tolerances, of the largest |value| of `repro`'s whole output (`_scale`:
of all the gradients, or of a step's moment tree): the forward (serve,
retrieval) 1e-6, AutoInt's retrieval 1e-5 (`FWD_TOL_AT`); the loss,
gradients, and the step's moments and metrics 1e-5, as `test_torch_moe`
holds the one-group path. The step's updated parameters follow the port's
AdamW rule (`test_torch_optimizer`): every element within 2·lr, at most
`ADAM_FLIP_SHARE` of them further than `ADAM_ATOL`. AdamW's first step
moves an element by ±lr by its gradient's sign, and where the gradient is
0 in exact arithmetic (DIN's attn_bout) the sign is rounding noise, which
the two packages round differently (measured: DIN's attn_bout, 2·lr apart;
DIEN's near-zero gradient elements).
Each mesh's forward is also held to the port's one-rank forward (no
rules) on the whole tables and the rank's block of the batch (or of the
candidates): equal to the bit. (Against the one-rank forward of the whole
batch a rank's block can differ in the last bit, 3e-8 at 4 ranks along
"data": the CPU's matrix products round a block of rows and the whole
batch's rows differently.)
"""
import dataclasses
import json
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_ranks  # noqa: E402
import torch_workers  # noqa: E402,F401
from repro.core.quantization import quantize_tree  # noqa: E402
from repro_torch.configs.base import get_config, with_attn_window  # noqa: E402
from repro_torch.configs.shapes import RecSysShape  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.distributed.sharding import P, PartitionSpec, block_slices  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, axis_names  # noqa: E402
from repro_torch.models.common import from_numpy_tree, init_params, to_numpy_tree  # noqa: E402
from repro_torch.models.recsys import api  # noqa: E402
from repro_torch.training.optimizer import adamw  # noqa: E402
from test_torch_expert_parallel_ranks import CHEAP_XLA  # noqa: E402
from test_torch_optimizer import ADAM_ATOL, ADAM_FLIP_SHARE  # noqa: E402

FWD_TOL = 1e-6
# AutoInt's retrieval scores are logits out of three attention layers over
# 39 fields, no sigmoid to flatten them: 3.2e-6 measured on every mesh
# (and by the port at one rank: its blocks are the mesh's bits)
FWD_TOL_AT = {("autoint", "retrieval", ""): 1e-5}
TRAIN_TOL = 1e-5
LR = 1e-4  # the cells' AdamW
MESHES = [(1, 4), (2, 2), (4, 1), (2, 1, 2)]
ARCHS = ("taobao_ssa", "fm", "din", "dien", "autoint")
SEQ = 8  # history length of the sequence archs
B, N_CAND = 8, 512
SHAPES = {"serve": RecSysShape("serve_p99", B, "serve"),
          "retrieval": RecSysShape("retrieval_cand", 1, "retrieval", N_CAND),
          "grad": RecSysShape("train_batch", B, "train"),
          "step": RecSysShape("train_batch", B, "train")}
SHAPE_NAMES = {"serve": "serve_p99", "retrieval": "retrieval_cand", "grad": "train_batch",
               "step": "train_batch"}

# (arch, kind, variant): variant "" | "quantized" | "full_mesh" | "c2" | "pruned"
CASES = ([(a, k, "") for a in ARCHS for k in ("serve", "retrieval", "grad", "step")]
         + [(a, "serve", "quantized") for a in ("fm", "din", "taobao_ssa")]
         + [("fm", "serve", "full_mesh"), ("taobao_ssa", "serve", "full_mesh"),
            ("taobao_ssa", "serve", "c2"), ("taobao_ssa", "step", "c2"),
            ("taobao_ssa", "serve", "pruned")])
WINDOW = 4


def _desc(arch, variant):
    """What both packages build their config from."""
    over = {"seq_len": SEQ} if arch in ("taobao_ssa", "din", "dien") else {}
    if variant == "quantized" or (variant, arch) == ("full_mesh", "fm"):
        over["quantized"] = True
    if variant == "full_mesh":
        over["serve_full_mesh"] = True
    return {"arch": arch, "over": over, "window": WINDOW if variant == "c2" else 0}


def _port_cfg(desc):
    cfg = get_config(desc["arch"])
    cfg = dataclasses.replace(
        cfg, fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, 1000)) for f in cfg.fields),
        **desc["over"])
    return with_attn_window(cfg, desc["window"]) if desc["window"] else cfg


def _batch(cfg, n, rng, label):
    if cfg.interaction in ("fm", "self_attn"):
        b = {"sparse_idx": np.stack([rng.integers(0, f.vocab, n) for f in cfg.fields], 1)}
    else:
        v, L = {f.name: f.vocab for f in cfg.fields}, cfg.seq_len
        b = {"user": rng.integers(0, v["user"], n), "item": rng.integers(0, v["item"], n),
             "category": rng.integers(0, v["category"], n),
             "hist_item": rng.integers(0, v["item"], (n, L)),
             "hist_category": rng.integers(0, v["category"], (n, L)),
             "hist_len": rng.integers(1, L + 1, n)}
    b = {k: x.astype(np.int32) for k, x in b.items()}
    if label:
        b["label"] = rng.integers(0, 2, n).astype(np.float32)
    return b


def _params(arch, variant):
    """The whole numpy params of a case (`repro`'s tree; the port's adds
    the pruned tower's block masks)."""
    desc = _desc(arch, variant)
    cfg = _port_cfg(desc)
    params = to_numpy_tree(init_params(api.param_defs(cfg), torch.Generator().manual_seed(
        ARCHS.index(arch)), "cpu"))
    if cfg.quantized:
        params = jax.tree.map(np.asarray, quantize_tree(jax.tree.map(jnp.asarray, params),
                                                        weights=False))
    if variant == "pruned":
        pruned = pruning.prune_tree(from_numpy_tree(params, "cpu"), 0.5, structured=True)
        return to_numpy_tree(pruned), to_numpy_tree(pruning.with_block_masks(pruned))
    return params, params


def _inputs(i, arch, kind, variant):
    """(the case's whole numpy arguments for the port's cell, for `repro`'s)."""
    cfg = _port_cfg(_desc(arch, variant))
    rng = np.random.default_rng(100 + i)
    params, port_params = _params(arch, variant)
    if kind == "retrieval":
        query = _batch(cfg, 1, rng, label=False)
        if cfg.interaction in ("fm", "self_attn"):
            cand_field = max(range(len(cfg.fields)), key=lambda j: cfg.fields[j].vocab)
            cand = rng.integers(0, cfg.fields[cand_field].vocab, N_CAND).astype(np.int32)
        else:
            v = {f.name: f.vocab for f in cfg.fields}
            cand = rng.integers(0, v["item"], N_CAND).astype(np.int32)
            query["cand_category"] = rng.integers(0, v["category"], N_CAND).astype(np.int32)
        return (port_params, query, cand), (params, query, cand)
    batch = _batch(cfg, B, rng, label=kind != "serve")
    if kind == "step":
        state = to_numpy_tree(adamw(1e-4).init(from_numpy_tree(params, "cpu")))
        return (port_params, state, batch), (params, state, batch)
    return (port_params, batch), (params, batch)


_REFERENCE = r"""
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import RecSysConfig, get_config
from repro.configs.shapes import RecSysShape
from repro.distributed.sharding import RECSYS_RULES, adapt_rules
from repro.launch.cells import _rec_cell
from repro.launch.mesh import compat_make_mesh
from repro.models.recsys import api


@dataclasses.dataclass(frozen=True)
class Windowed(RecSysConfig):
    attn_window: int = 0


def make_cfg(desc):
    cfg = get_config(desc["arch"])
    cfg = dataclasses.replace(
        cfg, fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, 1000)) for f in cfg.fields),
        **desc["over"])
    if desc["window"]:
        cfg = Windowed(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(RecSysConfig)},
                       attn_window=desc["window"])
    return cfg


def stretch(tree, sh):
    if isinstance(tree, dict):
        return {k: stretch(v, sh[k] if isinstance(sh, dict) else sh) for k, v in tree.items()}
    return sh


def flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat(f"{prefix}/{k}", tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for j, v in enumerate(tree):
            flat(f"{prefix}/{j}", v, out)
    else:
        out[prefix] = np.asarray(tree)


with open(sys.argv[1], "rb") as f:
    cases = pickle.load(f)
shape = tuple(json.loads(sys.argv[3]))
names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
mesh = compat_make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])
rules = adapt_rules(RECSYS_RULES, mesh)
out = {}
for i, case in enumerate(cases):
    cfg = make_cfg(case["desc"])
    kind = case["kind"]
    cell = _rec_cell(cfg, RecSysShape(**case["shape"]), mesh, rules,
                     case.get("optimizer", "adamw"))
    args = jax.tree.map(jnp.asarray, case["args"])
    shardings = (stretch(case["args"][0], cell.in_shardings[0]),) + tuple(cell.in_shardings[1:])
    if kind == "grad":
        fn = jax.value_and_grad(lambda p, b: api.loss(p, b, cfg, rules), has_aux=True)
        (loss, _), grads = jax.jit(fn, in_shardings=(shardings[0], shardings[2]))(*args)
        res = (loss, grads)
    else:
        res = jax.jit(cell.fn, in_shardings=shardings, out_shardings=cell.out_shardings)(*args)
    flat(str(i), res, out)
np.savez(sys.argv[2], **out)
"""


def _flat(prefix, tree, out):
    if isinstance(tree, PartitionSpec):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flat(f"{prefix}/{k}", tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for j, v in enumerate(tree):
            _flat(f"{prefix}/{j}", v, out)
    else:
        out[prefix] = tree
    return out


def _case_id(c):
    return f"{c[0]}-{c[1]}" + (f"-{c[2]}" if c[2] else "")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through `repro` (a subprocess per mesh) and the port (4
    gloo ranks per mesh), the two at once."""
    tmp = tmp_path_factory.mktemp("recsys_ranks")
    port_cases, ref_cases = [], []
    for i, (arch, kind, variant) in enumerate(CASES):
        desc = _desc(arch, variant)
        port_args, ref_args = _inputs(i, arch, kind, variant)
        shape = SHAPES[kind]
        port_cases.append({"arch": arch, "shape_name": SHAPE_NAMES[kind], "shape": shape,
                           "cfg": _port_cfg(desc), "kind": kind, "args": port_args})
        ref_cases.append({"desc": desc, "kind": kind, "args": ref_args,
                          "shape": dataclasses.asdict(shape)})
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(ref_cases, f)
    refs = [torch_ranks.Reference(_REFERENCE, [tmp / "cases.pkl", tmp / f"ref{m}.npz",
                                               json.dumps(list(mesh))], 4, CHEAP_XLA)
            for m, mesh in enumerate(MESHES)]
    try:
        ranks = torch_ranks.run_ranks(torch_ranks.recsys_rank, 4, tmp, MESHES, port_cases)
        port = {mesh: [r[mesh] for r in ranks] for mesh in MESHES}
        for ref in refs:
            ref.wait()
    finally:
        for ref in refs:
            ref.kill()
    ref = {mesh: dict(np.load(tmp / f"ref{m}.npz")) for m, mesh in enumerate(MESHES)}
    return port_cases, ref, port


def _scale(ref, key, kind):
    """The largest |value| of the tree `key` lies in, where a leaf of it
    can be 0 in exact arithmetic and hold only rounding noise (a bias
    before a softmax, DIN's attn_bout): all of a case's gradients
    ("<case>/1/..." of "grad"), each of a step's moments ("<case>/1/m/...",
    "<case>/1/v/..."); else of `key` alone."""
    parts = key.split("/")
    depth = {"grad": 2, "step": 3}.get(kind, len(parts)) if parts[1:2] == ["1"] else len(parts)
    prefix = "/".join(parts[:depth])
    return max(float(np.max(np.abs(v))) for k, v in ref.items()
               if k == prefix or k.startswith(prefix + "/"))


def _rel(ref, got, scale):
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref.astype(np.float64) - got)) / max(scale, 1e-30))


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
@pytest.mark.parametrize("case", range(len(CASES)), ids=[_case_id(c) for c in CASES])
def test_recsys_across_ranks_matches_repro_on_the_same_mesh(case, mesh, runs):
    port_cases, ref, port = runs
    c = port_cases[case]
    amesh = AbstractMesh(mesh, axis_names(mesh))
    cell = build_cell(c["arch"], c["shape_name"], amesh, cfg=c["cfg"], shape=c["shape"])
    if c["kind"] == "grad":
        p_specs = torch_ranks.spec_tree(c["args"][0], cell.in_specs[0])
        out_specs = (P(), p_specs)
    else:
        out_specs = cell.out_specs
    specs = _flat(str(case), out_specs, {})
    ranks = [r[case] for r in port[mesh]]
    assert len({r["coord"] for r in ranks}) == len(ranks)
    tol = (FWD_TOL_AT.get(CASES[case], FWD_TOL) if c["kind"] in ("serve", "retrieval")
           else TRAIN_TOL)
    errs, n, n_far = {}, 0, 0
    for r in ranks:
        got = _flat(str(case), r["out"], {})
        assert set(got) == set(specs), (sorted(got), sorted(specs))
        for key, spec in specs.items():
            whole = ref[mesh][key]
            blk = whole[block_slices(whole.shape, spec, amesh, r["coord"])]
            if c["kind"] == "step" and key.startswith(f"{case}/0/"):  # the updated params
                d = np.abs(blk.astype(np.float64) - got[key])
                assert d.max() <= 2 * LR, (key, d.max())
                n, n_far = n + d.size, n_far + int((d > ADAM_ATOL).sum())
                continue
            errs[key] = max(errs.get(key, 0.0),
                            _rel(blk, np.asarray(got[key]), _scale(ref[mesh], key, c["kind"])))
        if "one_rank" in r:
            assert np.array_equal(r["one_rank"], r["out"]), (
                r["coord"], np.max(np.abs(r["one_rank"] - r["out"])))
    print(json.dumps({"case": _case_id(CASES[case]), "mesh": mesh, "worst": max(errs.values())}))
    bad = {k: e for k, e in errs.items() if e > tol}
    assert not bad, bad
    assert n_far <= ADAM_FLIP_SHARE * n, (n_far, n)
