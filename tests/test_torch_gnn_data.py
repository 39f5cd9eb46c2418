"""The GNN family's data on the port's side: `data/synthetic.{random_graph,
molecule_batch}` give `repro`'s arrays bit for bit from the same seed, and
`models/gnn/sampler.py` is `repro`'s sampler: its syntax tree, docstrings
removed, equals the reference's, and from the same numpy generator it
draws the same neighbours and subgraphs."""
import ast
from pathlib import Path

import numpy as np
import pytest

from repro.data import synthetic as jdata
from repro.models.gnn import sampler as jsampler
from repro_torch.data import synthetic as tdata
from repro_torch.models.gnn import sampler

REPO = Path(__file__).resolve().parents[1]


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n,deg,d_feat,n_classes,seed", [
    (512, 8, None, 7, 0), (512, 8, None, 7, 3), (300, 4, 33, 41, 1), (2708, 4, 1433, 7, 0)])
def test_random_graph_is_repros(n, deg, d_feat, n_classes, seed):
    _equal(jdata.random_graph(n, deg, d_feat=d_feat, n_classes=n_classes, seed=seed),
           tdata.random_graph(n, deg, d_feat=d_feat, n_classes=n_classes, seed=seed))


@pytest.mark.parametrize("n_graphs,seed", [(4, 0), (128, 0), (7, 9)])
def test_molecule_batch_is_repros(n_graphs, seed):
    _equal(jdata.molecule_batch(n_graphs, seed=seed), tdata.molecule_batch(n_graphs, seed=seed))


def _tree(path: Path) -> str:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree, include_attributes=False)


def test_the_samplers_source_is_repros_but_for_docstrings():
    rel = Path("models") / "gnn" / "sampler.py"
    assert _tree(REPO / "src" / "repro_torch" / rel) == _tree(REPO / "src" / "repro" / rel)


def _graph(N, E, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    return src, dst


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_and_neighbour_draws_are_repros(seed):
    src, dst = _graph(60, 200, seed)
    a, b = jsampler.CSRGraph.from_edges(src, dst, 60), sampler.CSRGraph.from_edges(src, dst, 60)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    nodes = np.arange(60)  # some isolated: they self-loop
    np.testing.assert_array_equal(a.sample_neighbors(nodes, 5, np.random.default_rng(seed)),
                                  b.sample_neighbors(nodes, 5, np.random.default_rng(seed)))


@pytest.mark.parametrize("n_seeds,fanout", [(8, (3, 2)), (16, (15, 10)), (5, (4,))])
def test_sampled_subgraphs_are_repros(n_seeds, fanout):
    src, dst = _graph(100, 400, n_seeds)
    seeds = np.random.default_rng(1).integers(0, 100, n_seeds)
    ref = jsampler.sample_subgraph(jsampler.CSRGraph.from_edges(src, dst, 100), seeds, fanout,
                                   np.random.default_rng(7))
    out = sampler.sample_subgraph(sampler.CSRGraph.from_edges(src, dst, 100), seeds, fanout,
                                  np.random.default_rng(7))
    _equal(ref, out)
    assert sampler.subgraph_sizes(n_seeds, fanout) == jsampler.subgraph_sizes(n_seeds, fanout) \
        == (out["node_ids"].shape[0], out["edge_src"].shape[0])


def test_minibatch_lgs_sampled_shape():
    """1,024 seeds at fanout (15, 10): 169,984 nodes and 168,960 edges."""
    assert sampler.subgraph_sizes(1024, (15, 10)) == (169_984, 168_960)
