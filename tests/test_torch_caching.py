"""The port's resident hot-row tier (`repro_torch.core.caching`) against
`repro.core.caching`, on the CPU.

- `repro`'s contract (`tests/test_kernels.py`), inside the port: the
  cached lookup is bitwise the port's uncached
  `models/recsys/embedding.embedding_bag` for resident-only, mixed and
  miss-only lookups, weighted or not, sum or mean, and on int8 tables.
- Against `repro`'s `cached_embedding_bag` on the same inputs: within 1e-6
  relative to the sum of the terms' magnitudes, Σ_j |w_j·row_j| (`segment_sum`
  adds a bag's rows in another order than the port's reduce, which moves a
  sum of 6 f32 terms by at most ~6 ulps of that magnitude; relative to the
  sum itself a cancelling bag would allow no reordering), and exactly for
  bags of one.
- `hot_ids`, the resident rows and `residency_mask` equal `repro`'s.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)
from repro.core import caching as jax_caching  # noqa: E402
from repro.data.synthetic import zipf_id_stream  # noqa: E402
from repro_torch.core import caching  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.models.recsys.embedding import embedding_bag  # noqa: E402

V, D, B, NNZ = 400, 32, 16, 6
RTOL = 1e-6


def _table(seed=3):
    return np.random.default_rng(seed).normal(size=(V, D)).astype(np.float32)


def _int8_table(seed=5):
    rng = np.random.default_rng(seed)
    return {"q": rng.integers(-127, 128, (200, 16)).astype(np.int8),
            "s": rng.uniform(0.01, 0.1, 200).astype(np.float32)}


def _cases(res_ids, stream, nnz=NNZ):
    return {
        "resident_only": np.random.default_rng(0).choice(res_ids, (B, nnz)),
        "mixed": np.asarray(stream[: B * nnz]).reshape(B, nnz),
        "miss_only": np.setdiff1d(np.arange(V), res_ids)[: B * nnz].reshape(B, nnz),
    }


def _assert_reordered_sum(out, ref, magnitude):
    """|out − ref| <= RTOL · Σ_j |w_j·row_j|, elementwise."""
    d = np.abs(out.numpy() - np.asarray(ref))
    assert (d <= RTOL * magnitude).all(), float((d / magnitude).max())


def _magnitude(rows, idx, w, combiner="sum"):
    """Σ_j |w_j·row_j| of each bag ([B, d]), divided as the combiner divides."""
    terms = np.abs(rows[idx])
    if w is not None:
        terms = terms * np.abs(w)[..., None]
    out = terms.sum(axis=1)
    if combiner == "mean":
        out = out / (np.maximum(w.sum(axis=1), 1)[:, None] if w is not None else idx.shape[1])
    return out


def _both(table):
    """The table in both packages' forms."""
    if isinstance(table, dict):
        return {k: jnp.asarray(v) for k, v in table.items()}, \
            {k: torch.from_numpy(v) for k, v in table.items()}
    return jnp.asarray(table), torch.from_numpy(table)


@pytest.mark.parametrize("nnz", [NNZ, 1])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_cached_embedding_bag_matches_the_uncached_lookup_exactly(weighted, combiner, nnz):
    table = torch.from_numpy(_table())
    stream = zipf_id_stream(4000, V, 1.2, seed=7)
    res_ids = caching.hot_ids(stream, 64)
    resident = caching.build_resident_table(table, res_ids)
    w = (torch.from_numpy(np.random.default_rng(4).uniform(size=(B, nnz)).astype(np.float32))
         if weighted else None)
    for name, idx in _cases(res_ids, stream, nnz).items():
        idx = torch.from_numpy(idx.astype(np.int32))
        out = caching.cached_embedding_bag(table, resident, idx, mask=w, combiner=combiner)
        ref = embedding_bag(table, idx, mask=w, combiner=combiner)
        assert torch.equal(out, ref), name
        hits = caching.residency_mask(resident, idx)
        assert {"resident_only": bool(hits.all()), "miss_only": not bool(hits.any())}.get(
            name, 0 < int(hits.sum()) < idx.numel()), name


@pytest.mark.parametrize("nnz", [NNZ, 1])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_cached_embedding_bag_matches_repro(weighted, combiner, nnz):
    jt, tt = _both(_table())
    stream = zipf_id_stream(4000, V, 1.2, seed=7)
    res_ids = caching.hot_ids(stream, 64)
    jres, tres = jax_caching.build_resident_table(jt, res_ids), \
        caching.build_resident_table(tt, res_ids)
    np.testing.assert_array_equal(tres.rows.numpy(), np.asarray(jres.rows))
    np.testing.assert_array_equal(tres.slot_of.numpy(), np.asarray(jres.slot_of))
    w = np.random.default_rng(4).uniform(size=(B, nnz)).astype(np.float32) if weighted else None
    for name, idx in _cases(res_ids, stream, nnz).items():
        idx = idx.astype(np.int32)
        ref = jax_caching.cached_embedding_bag(
            jt, jres, jnp.asarray(idx), mask=None if w is None else jnp.asarray(w),
            combiner=combiner)
        out = caching.cached_embedding_bag(
            tt, tres, torch.from_numpy(idx), mask=None if w is None else torch.from_numpy(w),
            combiner=combiner)
        if nnz == 1:
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref), err_msg=name)
        else:
            _assert_reordered_sum(out, ref, _magnitude(_table(), idx, w, combiner))


def test_cached_embedding_bag_int8_table():
    """The int8 layout dequantizes identically through the resident tier
    (rows cached dequantized) and the fallback path."""
    jt, tt = _both(_int8_table())
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 200, (8, 5)).astype(np.int32)
    resident = caching.build_resident_table(tt, np.arange(32, dtype=np.int64))
    assert resident.rows.dtype == torch.float32 and resident.n_resident == 32
    for w in (None, rng.uniform(size=(8, 5)).astype(np.float32)):
        tw = None if w is None else torch.from_numpy(w)
        out = caching.cached_embedding_bag(tt, resident, torch.from_numpy(idx), mask=tw)
        assert torch.equal(out, embedding_bag(tt, torch.from_numpy(idx), mask=tw))
        ref = jax_caching.cached_embedding_bag(
            jt, jax_caching.build_resident_table(jt, np.arange(32, dtype=np.int64)),
            jnp.asarray(idx), mask=None if w is None else jnp.asarray(w))
        rows = _int8_table()["q"].astype(np.float32) * _int8_table()["s"][:, None]
        _assert_reordered_sum(out, ref, _magnitude(rows, idx, w))
    hits = caching.residency_mask(resident, torch.from_numpy(idx))
    assert 0 < int(hits.sum()) < idx.size  # genuinely mixed hit/miss
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jax_caching.residency_mask(
        jax_caching.build_resident_table(jt, np.arange(32, dtype=np.int64)),
        jnp.asarray(idx))))


def test_an_empty_tier_misses_everything():
    table = torch.from_numpy(_table())
    resident = caching.build_resident_table(table, np.zeros(0, np.int64))
    idx = torch.from_numpy(np.arange(B * NNZ, dtype=np.int32).reshape(B, NNZ))
    assert resident.n_resident == 0 and not bool(caching.residency_mask(resident, idx).any())
    assert torch.equal(caching.cached_embedding_bag(table, resident, idx),
                       embedding_bag(table, idx))


@pytest.mark.parametrize("capacity", [0, 1, 64, 10_000])
def test_hot_ids_equal_repros(capacity):
    stream = zipf_id_stream(4000, V, 1.2, seed=7)
    np.testing.assert_array_equal(caching.hot_ids(stream, capacity),
                                  jax_caching.hot_ids(stream, capacity))
    ties = np.array([5, 3, 5, 3, 9, 1, 1])  # 5, 3, 1 twice: by id within a tie
    np.testing.assert_array_equal(caching.hot_ids(ties, 2), [1, 3])


def test_residency_mask_and_its_hit_count_equal_repros():
    jt, tt = _both(_table())
    stream = zipf_id_stream(4000, V, 1.2, seed=7)
    res_ids = caching.hot_ids(stream, 64)
    idx = stream[:4096 // 16 * 16].reshape(-1, 16).astype(np.int32)
    ours = caching.residency_mask(caching.build_resident_table(tt, res_ids), torch.from_numpy(idx))
    ref = jax_caching.residency_mask(jax_caching.build_resident_table(jt, res_ids),
                                     jnp.asarray(idx))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert int(ours.sum()) == int(ref.sum())


def test_the_cpu_path_launches_no_kernel():
    """On the CPU the tier and the lookup run the plain versions (on the
    card: `tests/test_torch_cuda.py`)."""
    table = torch.from_numpy(_table())
    before = bag_ops.launches
    resident = caching.build_resident_table(table, np.arange(8))
    caching.cached_embedding_bag(table, resident, torch.zeros((B, NNZ), dtype=torch.int32))
    assert bag_ops.launches == before
