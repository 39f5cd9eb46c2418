"""`repro_torch.launch.cells` against `repro.launch.cells`, on the CPU.

Every cell of `all_cells()` (the 40 assigned (arch, shape) pairs), the
paper's taobao_ssa at its four shapes (which `build_cell` builds and
`all_cells` leaves out) and the variant cells of `tests/test_cells.py`,
each on both production meshes as an abstract mesh (`repro`'s on
`jax.sharding.AbstractMesh`): the name, `meta` and `donate` equal
`repro`'s, every arg lies on the "meta" device (no storage) with
`repro`'s shape and dtype, and the specs of every arg and output equal
`repro`'s shardings' specs, leaf for leaf. An LM cell's `fn` under
`train_layout="tp"` or `int8_serve`, and a train cell's under adam8bit,
refuse a mesh of two gloo ranks and name why; NequIP's molecule cell's
`fn` runs on the (2, 1) mesh of two gloo ranks (the graph split by nodes
and edges; `tests/test_torch_gnn_ranks.py` holds it against `repro`).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

import torch_ranks  # noqa: E402
import torch_workers  # noqa: E402,F401
from repro.launch import cells as jcells  # noqa: E402
from repro_torch.configs.shapes import RECSYS_SHAPES  # noqa: E402
from repro_torch.distributed.sharding import PartitionSpec  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import PRODUCTION_SHAPES, AbstractMesh  # noqa: E402

MESHES = {"16x16": PRODUCTION_SHAPES[False], "2x16x16": PRODUCTION_SHAPES[True]}
# tests/test_cells.py's variant cells: (arch, shape, overrides)
VARIANTS = [
    ("autoint", "serve_bulk", {"quantized": True, "serve_full_mesh": True}),
    ("llama4_maverick_400b_a17b", "train_4k", {"pad_vocab": True}),
    ("llama4_maverick_400b_a17b", "train_4k", {"flash_remat": True, "capacity_factor": 1.0}),
    ("nequip", "ogb_products", {"full_mesh_graph": True, "hoist_gathers": True}),
    ("yi_6b", "decode_32k", {"int8_serve": True}),
    ("yi_6b", "train_4k", {"train_layout": "tp"}),
]
CELLS = ([(a, s, None) for a, s in cells.all_cells()]
         + [("taobao_ssa", s, None) for s in RECSYS_SHAPES] + VARIANTS)


def _leaves(tree):
    """A port tree's leaves in `jax.tree.leaves` order: dicts by sorted
    key, tuples in order; a PartitionSpec is a leaf."""
    if isinstance(tree, PartitionSpec) or not isinstance(tree, (dict, tuple, list)):
        return [tree]
    items = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else list(tree)
    return [leaf for item in items for leaf in _leaves(item)]


def _canon(spec):
    """A spec as a plain tuple, a one-name tuple entry as the name, trailing
    Nones dropped."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in tuple(spec)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def test_exactly_40_cells_as_repros():
    got = cells.all_cells()
    assert got == jcells.all_cells()
    assert len(got) == 40 and len({a for a, _ in got}) == 10


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape,overrides", CELLS,
                         ids=[f"{a}:{s}" + ("+" + "+".join(o) if o else "") for a, s, o in CELLS])
def test_cell_equals_repros(arch, shape, overrides, mesh):
    dims, names = MESHES[mesh]
    jcell = jcells.build_cell(arch, shape, JaxAbstractMesh(dims, names), overrides=overrides)
    cell = cells.build_cell(arch, shape, AbstractMesh(dims, names), overrides=overrides)
    assert (cell.name, cell.meta, tuple(cell.donate)) == (jcell.name, jcell.meta,
                                                          tuple(jcell.donate))
    args, jargs = _leaves(cell.args), jax.tree.leaves(jcell.args)
    assert len(args) == len(jargs)
    for a, j in zip(args, jargs):
        assert a.device.type == "meta"
        assert (tuple(a.shape), str(a.dtype).split(".")[-1]) == (tuple(j.shape),
                                                                 np.dtype(j.dtype).name)
    for mine, theirs in ((cell.in_specs, jcell.in_shardings),
                         (cell.out_specs, jcell.out_shardings)):
        specs, jspecs = _leaves(mine), jax.tree.leaves(theirs)
        assert [_canon(s) for s in specs] == [_canon(j.spec) for j in jspecs]


@pytest.mark.parametrize("case", range(6), ids=["tp_train", "int8_prefill", "int8_decode",
                                                  "int8_long", "adam8bit_lm", "adam8bit_ssa"])
def test_lm_layouts_and_adam8bit_cells_run_on_two_ranks(case, two_rank_cells):
    """The cells that refused a mesh of more than one rank until the LM's
    Megatron train layout, its int8 serving and adam8bit were split across
    ranks: each `fn` runs on the (1, 2) mesh (cut to a small size,
    `torch_ranks._small_cell`), every output finite, and both ranks of a
    train step return the same loss. (Each layout is held against `repro`
    on the same mesh in `test_torch_lm_ranks_layouts` and
    `test_torch_adam8bit_ranks`.)"""
    ranks = [r[case] for r in two_rank_cells]
    assert all(r["finite"] for r in ranks), ranks
    if TWO_RANK_CELLS[case][1] in ("train_4k", "train_batch"):
        assert ranks[0]["loss"] == ranks[1]["loss"] and np.isfinite(ranks[0]["loss"])


TWO_RANK_CELLS = [("yi_6b", "train_4k", "adamw", {"train_layout": "tp"}),
                  ("yi_6b", "prefill_32k", "adamw", {"int8_serve": True}),
                  ("yi_6b", "decode_32k", "adamw", {"int8_serve": True}),
                  ("yi_6b", "long_500k", "adamw", {"int8_serve": True}),
                  ("yi_6b", "train_4k", "adam8bit", None),
                  ("taobao_ssa", "train_batch", "adam8bit", None)]


@pytest.fixture(scope="module")
def two_rank_cells(tmp_path_factory):
    return torch_ranks.run_ranks(torch_ranks.cell_run_rank, 2,
                                 tmp_path_factory.mktemp("two_rank_cells"), TWO_RANK_CELLS)


def test_nequip_cell_runs_on_two_ranks(tmp_path):
    """NequIP's molecule cell's `fn` on the (2, 1) mesh: each rank holds
    half of the nodes and edges, its forward block is the one-rank
    forward's block of the whole graph within 1e-5 of the largest |output|,
    and both take the same step (the loss and the norm of the whole
    graph's gradient), finite, the params' shapes kept."""
    ranks = torch_ranks.run_ranks(torch_ranks.gnn_cell_rank, 2, tmp_path, (2, 1))
    assert [r["coord"] for r in ranks] == [(0, 0), (1, 0)]
    scale = max(float(np.abs(r["one_rank"]).max()) for r in ranks)
    for r in ranks:  # the rank's block of the forward, as the one-rank call gives it
        assert np.abs(r["out"] - r["one_rank"]).max() <= 1e-5 * scale, r["coord"]
    assert all(r["finite"] and r["same_shapes"] for r in ranks)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert set(ranks[0]["metrics"]) == {"mse", "grad_norm", "loss"}
    assert ranks[0]["metrics"]["loss"] > 0 and ranks[0]["metrics"]["grad_norm"] > 0
