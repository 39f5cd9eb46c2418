"""NequIP across gloo ranks against `repro` jitted on the same meshes, on
the CPU.

A reduced NequIP (2 layers, `d_hidden` 8, `l_max` 2, 8 RBFs, remat on as
configured) at two of the cells' kinds: `molecule` (16 molecules of 30
atoms and 64 edges, species, `energy_loss`) and `full_graph_sm` (a
`random_graph` of 480 nodes at degree 3, 16 features, 7 classes,
`node_class_loss`), each padded as `launch/cells._pad512` pads it (to 512
nodes, and 1,024 / 1,536 edges), the padding masked, and some real edges
(and, in `molecule`, nodes) masked too. Meshes (data, model) = (1, 4),
(2, 2), (4, 1) and (pod, data, model) = (2, 1, 2) under `GNN_RULES` (nodes
and edges over (pod, data)), and `full_mesh_graph` (nodes and edges over
every mesh dim) with and without `hoist_gathers` on (1, 4) and (2, 2).

`repro` subprocesses on 4 forced CPU devices (`torch_ranks.Reference`),
one a mesh, jit under the mesh each case's forward, its loss with every
gradient and one AdamW step of `repro.launch.cells._gnn_cell`'s `fn`, with
the cell's `in_shardings`. The port runs the same cases on 4 gloo ranks
(`torch_ranks.gnn_rank`, one spawn for all the meshes) through
`launch/cells.build_cell`, each rank on its blocks of the same numpy
inputs (the parameters the port's `init_params` draws).

Tolerances, each beside what these inputs measured (the ranks add the
partial sums of a node's messages, of the losses' sums and of each
gradient in another order than one rank does, and `repro`'s XLA in
another again):

- the forward's block, of the largest |output| of `repro`'s: `FWD_REL`
  1e-5 (measured up to 2.3e-7); against the port's one-rank forward of
  the whole graph, the same bound (measured up to 6.1e-8);
- the loss, relative: `LOSS_REL` 1e-5 (measured up to 1.2e-7);
- every gradient leaf, of the leaf's largest |g| in `repro`'s: `GRAD_REL`
  1e-5 (measured up to 7.7e-7); a leaf the algebra gives no gradient at 2
  layers (`self_1`, `self_2`) is 0 in both;
- the step's moments and metrics, of each tree's largest |value|:
  `GRAD_REL` (measured up to 2.8e-7); its parameters under the port's
  AdamW rule (`tests/test_torch_optimizer.py`: within 2·lr, at most
  `ADAM_FLIP_SHARE` further than `ADAM_ATOL`);
- two steps on the same mesh from the same start: the same bits.
"""
import dataclasses
import json
import pickle

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_ranks  # noqa: E402
import torch_workers  # noqa: E402,F401
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.shapes import GNNShape  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.distributed.sharding import block_slices  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, axis_names  # noqa: E402
from repro_torch.models.common import from_numpy_tree, init_params, to_numpy_tree  # noqa: E402
from repro_torch.models.gnn import nequip  # noqa: E402
from repro_torch.training.optimizer import adamw  # noqa: E402
from test_torch_expert_parallel_ranks import CHEAP_XLA  # noqa: E402
from test_torch_optimizer import ADAM_ATOL, ADAM_FLIP_SHARE  # noqa: E402

FWD_REL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-5
LR = 1e-4  # the cells' AdamW
SMALL = {"n_layers": 2, "d_hidden": 8, "l_max": 2, "n_rbf": 8}
MESHES = [(1, 4), (2, 2), (4, 1), (2, 1, 2)]
FULL_MESH = [(1, 4), (2, 2)]
KINDS = ("molecule", "full_graph_sm")
SHAPES = {"molecule": GNNShape("molecule", n_nodes=30, n_edges=64, d_feat=None,
                               kind="batched_small", graph_batch=16),
          "full_graph_sm": GNNShape("full_graph_sm", n_nodes=480, n_edges=1440, d_feat=16,
                                    kind="full_batch")}
N_CLASSES = {"molecule": 1, "full_graph_sm": 7}
# (mesh, kind, overrides)
CASES = ([(m, k, {}) for m in MESHES for k in KINDS]
         + [(m, k, {"full_mesh_graph": True, "hoist_gathers": h})
            for m in FULL_MESH for k in KINDS for h in (False, True)])


def _cfg(over):
    return dataclasses.replace(get_config("nequip"), **SMALL, **over)


def _pad(a, n, fill):
    """`a` padded along dim 0 to `n` rows of `fill`."""
    extra = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, extra])


def _graph(kind):
    """The kind's whole numpy graph at the cell's padded sizes, the padding
    masked (its nodes at random positions)."""
    rng = np.random.default_rng(7)
    cell = build_cell("nequip", kind, AbstractMesh((1, 1), ("data", "model")),
                      cfg=_cfg({}), shape=SHAPES[kind])
    N, E = cell.meta["nodes"], cell.meta["edges"]
    if kind == "molecule":
        s = SHAPES[kind]
        g = synthetic.molecule_batch(s.graph_batch, s.n_nodes, s.n_edges, seed=1)
        n = g["positions"].shape[0]
        g["node_mask"] = rng.uniform(size=n) > 0.05
        g["graph_ids"] = _pad(g["graph_ids"], N, 0)
        g["species"] = _pad(g["species"], N, 0)
    else:
        g = synthetic.random_graph(480, 3, d_feat=16, n_classes=7, seed=1)
        n = g["positions"].shape[0]
        g["label_mask"] = rng.uniform(size=n) > 0.5
        g["labels"] = _pad(g["labels"], N, 0)
        g["features"] = _pad(g["features"], N, 0.0)
    g["positions"] = np.concatenate(
        [g["positions"], rng.normal(size=(N - n, 3)).astype(np.float32) * 2.0])
    for k in ("node_mask", "label_mask"):
        if k in g:
            g[k] = _pad(g[k], N, False)
    e = g["edge_src"].shape[0]
    g["edge_mask"] = _pad(rng.uniform(size=e) > 0.1, E, False)
    g["edge_src"] = _pad(g["edge_src"], E, 0)
    g["edge_dst"] = _pad(g["edge_dst"], E, 0)
    assert set(g) == set(cell.args[2]), (sorted(g), sorted(cell.args[2]))
    return g


def _params(kind):
    defs = nequip.param_defs(_cfg({}), d_feat=SHAPES[kind].d_feat, n_classes=N_CLASSES[kind])
    return to_numpy_tree(init_params(defs, torch.Generator().manual_seed(KINDS.index(kind)),
                                     "cpu"))


_REFERENCE = r"""
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config
from repro.configs.shapes import GNNShape
from repro.distributed.sharding import GNN_RULES, adapt_rules
from repro.launch.cells import _full_mesh_axes, _gnn_cell
from repro.launch.mesh import compat_make_mesh
from repro.models.gnn import nequip


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
out = {}
for case in cases:
    cfg = get_config("nequip", **case["over"])
    rules = adapt_rules(GNN_RULES, mesh)
    if cfg.full_mesh_graph:
        full = _full_mesh_axes(mesh)
        rules = {**rules, "nodes": full, "edges": full}
    cell = _gnn_cell(cfg, GNNShape(**case["shape"]), mesh, adapt_rules(GNN_RULES, mesh), "adamw")
    loss = nequip.energy_loss if "energies" in case["graph"] else nequip.node_class_loss

    def run(p, s, g):
        fwd = nequip.forward(p, g, cfg, rules)
        (value, _), grads = jax.value_and_grad(lambda p, b: loss(p, b, cfg, rules),
                                               has_aux=True)(p, g)
        return fwd, value, grads, cell.fn(p, s, g)

    args = jax.tree.map(jnp.asarray, (case["params"], case["state"], case["graph"]))
    with mesh:
        res = jax.jit(run, in_shardings=cell.in_shardings)(*args)
    flat(case["id"], res, out)
np.savez(sys.argv[2], **out)
"""


def _case_id(c):
    mesh, kind, over = c
    tag = ("+full_mesh" if over.get("full_mesh_graph") else "") + (
        "+hoist" if over.get("hoist_gathers") else "")
    return f"{'x'.join(map(str, mesh))}-{kind}{tag}"


def _flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(f"{prefix}/{k}", tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for j, v in enumerate(tree):
            _flat(f"{prefix}/{j}", v, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through `repro` (a subprocess per mesh) and the port (4
    gloo ranks), the two at once."""
    tmp = tmp_path_factory.mktemp("gnn_ranks")
    graphs = {k: _graph(k) for k in KINDS}
    params = {k: _params(k) for k in KINDS}
    state = {k: to_numpy_tree(adamw(LR).init(from_numpy_tree(params[k], "cpu"))) for k in KINDS}
    port_cases, refs = [], []
    for m, mesh in enumerate(MESHES):
        mine = [(i, c) for i, c in enumerate(CASES) if c[0] == mesh]
        ref_cases = [{"id": _case_id(c), "over": {**SMALL, **c[2]},
                      "shape": dataclasses.asdict(SHAPES[c[1]]), "params": params[c[1]],
                      "state": state[c[1]], "graph": graphs[c[1]]} for _, c in mine]
        with open(tmp / f"cases{m}.pkl", "wb") as f:
            pickle.dump(ref_cases, f)
        refs.append(torch_ranks.Reference(_REFERENCE, [tmp / f"cases{m}.pkl", tmp / f"ref{m}.npz",
                                                       json.dumps(list(mesh))], 4, CHEAP_XLA))
    for mesh, kind, over in CASES:
        port_cases.append({"mesh": mesh, "cfg": _cfg(over), "shape_name": kind,
                           "shape": SHAPES[kind], "params": params[kind],
                           "graph": graphs[kind]})
    try:
        ranks = torch_ranks.run_ranks(torch_ranks.gnn_rank, 4, tmp, port_cases)
        for ref in refs:
            ref.wait()
    finally:
        for ref in refs:
            ref.kill()
    ref = {}
    for m in range(len(MESHES)):
        ref.update(np.load(tmp / f"ref{m}.npz"))
    return ranks, ref


def _rel(ref, got, scale):
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref.astype(np.float64) - got), initial=0.0) / max(scale, 1e-30))


def _largest(tree_keys, ref):
    return max(float(np.max(np.abs(ref[k]), initial=0.0)) for k in tree_keys)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[_case_id(c) for c in CASES])
def test_nequip_across_ranks_matches_repro_on_the_same_mesh(case, runs):
    ranks, ref = runs
    mesh, kind, over = CASES[case]
    cid = _case_id(CASES[case])
    amesh = AbstractMesh(mesh, axis_names(mesh))
    cell = build_cell("nequip", kind, amesh, cfg=_cfg(over), shape=SHAPES[kind])
    node_spec = cell.in_specs[2]["positions"]
    fwd = ref[f"{cid}/0"]
    fwd_scale = float(np.max(np.abs(fwd)))
    worst = {"fwd": 0.0, "one_rank": 0.0, "loss": 0.0, "grad": 0.0, "moments": 0.0}
    coords = set()
    n = n_far = 0
    for rank in ranks:
        r = rank[case]
        coords.add(r["coord"])
        blk = fwd[block_slices(fwd.shape, node_spec, amesh, r["coord"])]
        worst["fwd"] = max(worst["fwd"], _rel(blk, r["out"], fwd_scale))
        worst["one_rank"] = max(worst["one_rank"], _rel(r["one_rank"], r["out"], fwd_scale))
        loss = float(ref[f"{cid}/1"])
        worst["loss"] = max(worst["loss"], abs(r["loss"] - loss) / abs(loss))
        for key, g in _flat(f"{cid}/2", r["grads"], {}).items():
            worst["grad"] = max(worst["grad"], _rel(ref[key], g, float(np.max(np.abs(ref[key]))))
                                if np.any(ref[key]) else float(np.max(np.abs(g))))
        got = _flat(f"{cid}/3", r["step"], {})
        assert set(got) == {k for k in ref if k.startswith(f"{cid}/3/")}
        for key, x in got.items():
            if key.startswith(f"{cid}/3/0/"):  # the updated params: AdamW's rule
                d = np.abs(ref[key].astype(np.float64) - x)
                assert d.max() <= 2 * LR, (key, d.max())
                n, n_far = n + d.size, n_far + int((d > ADAM_ATOL).sum())
            else:  # each moment tree, and the metrics, of its largest |value|
                tree = "/".join(key.split("/")[:4])
                scale = _largest([k for k in ref if k.startswith(tree + "/") or k == tree], ref)
                worst["moments"] = max(worst["moments"], _rel(ref[key], x, scale))
        assert r["step_repeats"], r["coord"]
    assert len(coords) == len(ranks)
    print(json.dumps({"case": cid, **worst}))
    assert worst["fwd"] <= FWD_REL and worst["one_rank"] <= FWD_REL, worst
    assert worst["loss"] <= LOSS_REL, worst
    assert worst["grad"] <= GRAD_REL and worst["moments"] <= GRAD_REL, worst
    assert n_far <= ADAM_FLIP_SHARE * n, (n_far, n)
