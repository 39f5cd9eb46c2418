"""The port's irrep algebra (`repro_torch.models.gnn.irreps`) against
`repro.models.gnn.irreps`, on the CPU.

- Every coupling path, in `path_list()`'s order, `spherical_harmonics`
  (zero displacements, a self-loop's, included), `to_matrix` / `to_vec5`
  and `rotate_features` on the same numpy inputs as jitted `repro`:
  within `ATOL` absolute on values of O(1) to O(4) (measured up to
  2.4e-7: f32 sums of 3 to 9 products in another order; five of the
  fifteen paths, the elementwise ones, are the same bits).
- Each of the port's paths is equivariant under random rotations, with
  hypothesis as `tests/test_gnn.py` checks `repro`'s: within `EQUIV_TOL`
  (measured up to 7.2e-7 over 30 rotations; `repro`'s test allows 2e-4).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

hypothesis = pytest.importorskip("hypothesis")  # optional test dep (see pyproject [test])
from hypothesis import given, settings, strategies as st  # noqa: E402
from scipy.spatial.transform import Rotation  # noqa: E402

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)
from repro.models.gnn import irreps as jirreps  # noqa: E402
from repro_torch.models.gnn import irreps  # noqa: E402

ATOL = 1e-6
EQUIV_TOL = 1e-5
PATHS = [(lf, ls, lo) for lf, ls, lo, _ in jirreps.path_list()]


def _rng_feats(seed, E=48, C=6):
    rng = np.random.default_rng(seed)
    feats = {l: rng.normal(size=(E, C, irreps.DIM[l])).astype(np.float32) for l in (0, 1, 2)}
    vec = rng.normal(size=(E, 3)).astype(np.float32)
    vec[:4] = 0.0  # self-loops: the norm is clipped at 1e-9
    return feats, vec


def _rotation(seed):
    return Rotation.random(random_state=seed).as_matrix().astype(np.float32)


def test_the_port_has_repros_paths_in_repros_order():
    assert [(lf, ls, lo) for lf, ls, lo, _ in irreps.path_list()] == PATHS
    assert irreps.N_PATHS == jirreps.N_PATHS == 15 and irreps.DIM == jirreps.DIM
    np.testing.assert_array_equal(irreps._Q, np.asarray(jirreps.Q))


@pytest.mark.parametrize("path", PATHS, ids=str)
def test_each_coupling_path_matches_repro(path):
    feats, vec = _rng_feats(sum(path))
    sh = jax.jit(jirreps.spherical_harmonics)(jnp.asarray(vec))
    fj = jirreps.PATHS[path[:2]][path[2]]
    ft = irreps.PATHS[path[:2]][path[2]]
    a, b = feats[path[0]], np.array(sh[path[1]])[:, None, :]  # [E,C,d1] x [E,1,d2]
    ref = np.asarray(jax.jit(fj)(jnp.asarray(a), jnp.asarray(b)))
    out = ft(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert out.shape == ref.shape == (a.shape[0], a.shape[1], irreps.DIM[path[2]])
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_p101_takes_the_first_column_of_a_width_one_b_and_p111_broadcasts_as_jnp_cross():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 4, 3)).astype(np.float32)
    for b in (rng.normal(size=(5, 1, 1)), rng.normal(size=(5, 4, 3)), rng.normal(size=(5, 1, 3))):
        b = b.astype(np.float32)
        np.testing.assert_array_equal(irreps._p101(torch.from_numpy(a), torch.from_numpy(b)),
                                      np.asarray(jirreps._p101(jnp.asarray(a), jnp.asarray(b))))
    b = rng.normal(size=(5, 1, 3)).astype(np.float32)
    np.testing.assert_allclose(irreps._p111(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jnp.cross(a, b)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_spherical_harmonics_match_repro_and_vanish_for_a_zero_displacement(seed):
    _, vec = _rng_feats(seed)
    ref = jax.jit(jirreps.spherical_harmonics)(jnp.asarray(vec))
    out = irreps.spherical_harmonics(torch.from_numpy(vec))
    for l in (0, 1, 2):
        np.testing.assert_allclose(out[l].numpy(), np.asarray(ref[l]), rtol=0, atol=ATOL)
    assert float(out[1][:4].abs().max()) == 0.0 and float(out[2][:4].abs().max()) < 1e-7


def test_matrix_and_vec5_round_trip_and_match_repro():
    t = np.random.default_rng(0).normal(size=(10, 5)).astype(np.float32)
    m = irreps.to_matrix(torch.from_numpy(t))
    np.testing.assert_allclose(m.numpy(), np.asarray(jirreps.to_matrix(jnp.asarray(t))),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(irreps.to_vec5(m).numpy(), t, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), m.transpose(-1, -2).numpy(), atol=1e-6)
    np.testing.assert_allclose(torch.diagonal(m, dim1=-2, dim2=-1).sum(-1).numpy(), 0.0,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_rotate_features_matches_repro(seed):
    feats, _ = _rng_feats(seed)
    R = _rotation(seed)
    ref = jirreps.rotate_features({l: jnp.asarray(f) for l, f in feats.items()}, jnp.asarray(R))
    out = irreps.rotate_features({l: torch.from_numpy(f) for l, f in feats.items()},
                                 torch.from_numpy(R))
    for l in (0, 1, 2):
        np.testing.assert_allclose(out[l].numpy(), np.asarray(ref[l]), rtol=0, atol=ATOL)


@settings(deadline=None, max_examples=20)
@given(seed=st.integers(0, 100_000))
def test_all_cg_paths_equivariant(seed):
    """Every coupling path commutes with rotations (the NequIP invariant)."""
    rng = np.random.default_rng(seed)
    R = torch.from_numpy(_rotation(seed))
    feats = {l: torch.from_numpy(rng.normal(size=(3, 2, irreps.DIM[l])).astype(np.float32))
             for l in (0, 1, 2)}
    vecs = torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32))
    sh, shR = irreps.spherical_harmonics(vecs), irreps.spherical_harmonics(vecs @ R.T)
    featsR = irreps.rotate_features(feats, R)
    for lf, ls, lo, fn in irreps.path_list():
        a = fn(feats[lf], sh[ls][:, None, :])
        b = fn(featsR[lf], shR[ls][:, None, :])
        aR = irreps.rotate_features({lo: a}, R)[lo]
        np.testing.assert_allclose(aR.numpy(), b.numpy(), rtol=0, atol=EQUIV_TOL,
                                   err_msg=f"path ({lf},{ls})->{lo} not equivariant")
