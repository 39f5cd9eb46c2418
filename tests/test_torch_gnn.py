"""The port's NequIP (`repro_torch.models.gnn.nequip`) against `repro`'s on
the CPU, at a small size: 2 layers of 8 channels (l_max 2, 8 RBFs, cutoff
5 as configured) on `random_graph`s of 40 nodes and 160 edges and on
`molecule_batch`es of 4 molecules, from `repro`'s parameters carried into
the port (the losses, gradients, AdamW steps and remat are
`tests/test_torch_gnn_train.py`'s). Tolerances, each measured on these
inputs:

- `radial_basis`: the centres (`jnp.linspace`, through
  `models/layers.jnp_linspace`) and the exponent's argument are `repro`'s
  bits; `exp` and `cos` are XLA's own approximations, which part from
  torch's in the last bit (809 of 8,000 and 52 of 1,000 elements of one
  draw), so the values are held within `RBF_ATOL`, 2 ulp at 1 (measured
  1.2e-7).
- `forward` against jitted `repro` (both `hoist_gathers` branches,
  species or features, with and without `edge_mask`): within `FWD_REL` of
  the largest output (measured up to 1.7e-7 over all eight combinations:
  f32 sums in another order).
- The fixed-order scatter (`scatter_sum`, and `gather`'s backward) is the
  in-order f32 sum of each segment to the bit and repeats its bits; it
  equals `index_add_` within `SCATTER_REL` of a segment's Σ|row| (measured
  0 here: the CPU's `index_add_` adds in order too; the card's adds with
  atomics, `tests/test_torch_cuda.py`).
- Invariance of the port's model under rotations (hypothesis, within
  `ROT_TOL`, `repro`'s own test's 5e-4; measured up to 1.3e-8 on outputs
  of up to 0.042) and translations (`repro`'s 1e-5 absolute).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

hypothesis = pytest.importorskip("hypothesis")  # optional test dep (see pyproject [test])
from hypothesis import given, settings, strategies as st  # noqa: E402
from scipy.spatial.transform import Rotation  # noqa: E402

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro.models.gnn import nequip as jnequip  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.models.common import from_numpy_tree, init_params, tree_leaves  # noqa: E402
from repro_torch.models.gnn import nequip  # noqa: E402
from repro_torch.models.layers import jnp_linspace  # noqa: E402

RBF_ATOL = 2.4e-7
FWD_REL = 1e-5
SCATTER_REL = 1e-6
ROT_TOL = 5e-4
SMALL = dict(n_layers=2, d_hidden=8)


def _cfgs(**over):
    return (dataclasses.replace(jax_get_config("nequip"), **SMALL, **over),
            dataclasses.replace(get_config("nequip"), **SMALL, **over))


def _graph(kind, seed=1):
    """numpy inputs: "species" / "features" random graphs (7 classes) with
    "+mask" an edge mask and a label mask; "molecule" 4 molecules, "+mask"
    a node mask."""
    rng = np.random.default_rng(seed + 100)
    if kind.startswith("molecule"):
        g = jdata.molecule_batch(4, seed=seed)
        if kind.endswith("+mask"):
            g["node_mask"] = rng.uniform(size=g["species"].shape) > 0.1
        return g
    g = jdata.random_graph(40, 4, d_feat=6 if kind.startswith("features") else None,
                           n_classes=7, seed=seed)
    if kind.endswith("+mask"):
        g["edge_mask"] = rng.uniform(size=g["edge_src"].shape) > 0.2
        g["label_mask"] = rng.uniform(size=g["labels"].shape) > 0.5
    return g


def _params(jcfg, kind, seed=0):
    """(repro params, the same carried into the port)."""
    n_classes = 1 if kind.startswith("molecule") else 7
    d_feat = 6 if kind.startswith("features") else None
    jp = jax_init_params(jnequip.param_defs(jcfg, d_feat=d_feat, n_classes=n_classes),
                         jax.random.key(seed))
    return jp, from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def _jb(g):
    return {k: jnp.asarray(v) for k, v in g.items()}


def _tb(g):
    return {k: torch.from_numpy(np.array(v)) for k, v in g.items()}


def _losses(kind):
    return (jnequip.energy_loss, nequip.energy_loss) if kind.startswith("molecule") else \
        (jnequip.node_class_loss, nequip.node_class_loss)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(a)).max(),
                                                                   1e-30))


def test_config_and_param_layout_are_repros():
    jcfg, tcfg = jax_get_config("nequip"), get_config("nequip")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg) and tcfg.family == "gnn"
    for d_feat, n_classes in ((None, 7), (1433, 7), (602, 41), (None, 1)):
        ref = jax.tree.map(lambda d: d.shape, jnequip.param_defs(jcfg, d_feat, n_classes),
                           is_leaf=lambda x: hasattr(x, "shape"))
        out = nequip.param_defs(tcfg, d_feat, n_classes)
        assert [(p, d.shape) for p, d in tree_leaves(out)] == \
            [(p, ref_shape) for p, ref_shape in tree_leaves(ref)]


def test_radial_basis_is_repros_but_for_the_last_bit_of_exp_and_cos():
    jcfg, tcfg = jax_get_config("nequip"), get_config("nequip")
    d = np.abs(np.random.default_rng(0).normal(size=1000) * 3).astype(np.float32)
    d[:5] = [0.0, 5.0, 6.0, 1e-12, 4.999]
    mu = jnp_linspace(tcfg.cutoff, tcfg.n_rbf, "cpu")
    np.testing.assert_array_equal(mu.numpy(), np.asarray(
        jax.jit(lambda: jnp.linspace(0.0, jcfg.cutoff, jcfg.n_rbf))()))
    assert not torch.equal(mu, torch.linspace(0.0, tcfg.cutoff, tcfg.n_rbf))  # index 5
    arg = jax.jit(lambda x: -(jcfg.n_rbf / jcfg.cutoff) * jnp.square(
        x[:, None] - jnp.linspace(0.0, jcfg.cutoff, jcfg.n_rbf)[None]))(jnp.asarray(d))
    dt = torch.from_numpy(d)
    np.testing.assert_array_equal(
        (-(tcfg.n_rbf / tcfg.cutoff) * torch.square(dt[:, None] - mu[None])).numpy(),
        np.asarray(arg))
    ref = np.asarray(jax.jit(lambda x: jnequip.radial_basis(x, jcfg))(jnp.asarray(d)))
    out = nequip.radial_basis(dt, tcfg).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=RBF_ATOL)
    assert np.all(out[2] == 0.0) and np.all(ref[2] == 0.0)  # beyond the cutoff


@pytest.mark.parametrize("hoist,kind", [(False, "species"), (False, "features+mask"),
                                        (True, "species+mask"), (True, "features")])
def test_forward_matches_jitted_repro(kind, hoist, gnn_rules):
    jcfg, tcfg = _cfgs(hoist_gathers=hoist)
    jp, tp = _params(jcfg, kind)
    g = _graph(kind)
    ref = jax.jit(lambda p, b: jnequip.forward(p, b, jcfg, gnn_rules))(jp, _jb(g))
    with torch.no_grad():
        out = nequip.forward(tp, _tb(g), tcfg)
    assert out.shape == (40, 7) and torch.isfinite(out).all()
    assert _rel(ref, out.numpy()) <= FWD_REL


@pytest.mark.parametrize("M,n,inner", [(500, 37, (3,)), (64, 200, (4, 5)), (1, 3, ()),
                                       (300, 1, (2,))])
def test_the_fixed_order_scatter_is_the_in_order_sum_and_index_adds_within_rounding(
        M, n, inner):
    rng = np.random.default_rng(M + n)
    ids = rng.integers(0, n, M).astype(np.int32)
    rows = rng.normal(size=(M,) + inner).astype(np.float32)
    seg = eb_ops.segments(torch.from_numpy(ids), n)
    out = nequip.scatter_sum(torch.from_numpy(rows), seg)
    ordered = np.zeros((n,) + inner, np.float32)
    for m in range(M):  # each segment's terms from the first to the last
        ordered[ids[m]] = ordered[ids[m]] + rows[m]
    np.testing.assert_array_equal(out.numpy(), ordered)
    assert torch.equal(out, nequip.scatter_sum(torch.from_numpy(rows), seg))
    ref = torch.zeros((n,) + inner).index_add_(0, torch.from_numpy(ids).long(),
                                               torch.from_numpy(rows))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=SCATTER_REL * np.abs(rows).sum(0).max())
    # gather's backward is this scatter; scatter's backward is the gather
    x = torch.from_numpy(rng.normal(size=(n,) + inner).astype(np.float32)).requires_grad_(True)
    y = nequip.gather(x, seg)
    assert torch.equal(y, x.detach()[torch.from_numpy(ids).long()])
    (dx,) = torch.autograd.grad(y, x, torch.from_numpy(rows))
    assert torch.equal(dx, out)
    r = torch.from_numpy(rows).requires_grad_(True)
    dy = torch.from_numpy(rng.normal(size=(n,) + inner).astype(np.float32))
    (dr,) = torch.autograd.grad(nequip.scatter_sum(r, seg), r, dy)
    assert torch.equal(dr, dy[torch.from_numpy(ids).long()])


def test_the_species_lookup_is_the_embedding_bag_op():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, "species")
    out = nequip.forward({**tp, "species": tp["species"].requires_grad_(True)},
                         _tb(_graph("species")), tcfg)
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    assert "_EmbeddingBagBackward" in {type(f).__name__ for f in seen}


def _rotation_graph(seed):
    rng = np.random.default_rng(seed)
    N, E = 16, 40
    return {"positions": (rng.normal(size=(N, 3)) * 2).astype(np.float32),
            "edge_src": rng.integers(0, N, E).astype(np.int32),
            "edge_dst": rng.integers(0, N, E).astype(np.int32),
            "species": rng.integers(0, 8, N).astype(np.int32)}


@settings(deadline=None, max_examples=5)
@given(seed=st.integers(0, 1000))
def test_model_rotation_invariance(seed):
    tcfg = get_config("nequip")
    params = init_params(nequip.param_defs(tcfg, n_classes=3), torch.Generator().manual_seed(0),
                         "cpu")
    g = _tb(_rotation_graph(seed))
    R = torch.from_numpy(Rotation.random(random_state=seed).as_matrix().astype(np.float32))
    with torch.no_grad():
        out1 = nequip.forward(params, g, tcfg)
        out2 = nequip.forward(params, {**g, "positions": g["positions"] @ R.T}, tcfg)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=ROT_TOL, atol=ROT_TOL)


def test_translation_invariance_and_the_cutoff_kills_long_edges():
    tcfg = get_config("nequip")
    params = init_params(nequip.param_defs(tcfg, n_classes=2), torch.Generator().manual_seed(0),
                         "cpu")
    g = _tb(_rotation_graph(0))
    with torch.no_grad():
        out1 = nequip.forward(params, g, tcfg)
        out2 = nequip.forward(params, {**g, "positions": g["positions"] + 5.0}, tcfg)
        np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-4, atol=1e-5)
        far = {"positions": torch.tensor([[0.0, 0, 0], [100.0, 0, 0], [1.0, 0, 0]]),
               "edge_src": torch.tensor([1], dtype=torch.int32),
               "edge_dst": torch.tensor([0], dtype=torch.int32),
               "species": torch.tensor([1, 2, 3], dtype=torch.int32)}
        out_far = nequip.forward(params, far, tcfg)
        out_none = nequip.forward(params, {**far, "edge_mask": torch.tensor([False])}, tcfg)
    np.testing.assert_allclose(out_far.numpy(), out_none.numpy(), rtol=1e-4, atol=1e-5)
