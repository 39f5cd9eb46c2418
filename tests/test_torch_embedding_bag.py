"""The port's EmbeddingBag (plain version, wrapper and model-level functions)
against `repro`'s Pallas kernel in interpret mode and its jnp oracle.

Tolerance: rtol=atol=1e-5 where a bag sums more than one row (the two
packages sum in different orders); exact where every bag is one row.
The Hopper kernel itself is held against the plain version on the card
by `test_torch_cuda.py`.
"""
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.embedding_bag.embedding_bag import embedding_bag as jax_kernel  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref  # noqa: E402
from repro.models.recsys import embedding as jax_emb  # noqa: E402
from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.models.recsys import embedding as emb  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(4, 5, 16), (16, 10, 32), (8, 1, 64), (32, 1, 16), (32, 1, 64)]


def _inputs(B, nnz, d, seed=0, V=500):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V, (B, nnz)).astype(np.int32)
    w = rng.uniform(size=(B, nnz)).astype(np.float32)
    return table, idx, w


def _check(ref, out, nnz):
    if nnz == 1:
        np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    else:
        np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,nnz,d", SHAPES)
@pytest.mark.parametrize("weighted", [True, False])
def test_plain_version_matches_pallas_kernel(B, nnz, d, weighted):
    table, idx, w = _inputs(B, nnz, d)
    if not weighted:
        w = np.ones_like(w)
    ref = jax_kernel(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), interpret=True)
    t_w = torch.from_numpy(w) if weighted else None
    out = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx), t_w)
    _check(ref, out, nnz)
    _check(jax_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)), out, nnz)


@pytest.mark.parametrize("B,nnz,d", SHAPES)
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_model_embedding_bag_matches_jax(B, nnz, d, combiner, masked):
    table, idx, _ = _inputs(B, nnz, d, seed=1)
    mask = (np.random.default_rng(2).random((B, nnz)) < 0.6) if masked else None
    ref = jax_emb.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                None if mask is None else jnp.asarray(mask), combiner)
    out = emb.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                            None if mask is None else torch.from_numpy(mask), combiner)
    if nnz == 1 and combiner == "sum":
        _check(ref, out, nnz)
    else:
        np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5, atol=1e-5)


def test_take_rows_f32_is_exact_and_int8_within_1e7():
    table, _, _ = _inputs(1, 1, 64, seed=3, V=1024)
    rows = np.random.default_rng(4).integers(0, 1000, (6, 20)).astype(np.int32)
    ref = jax_emb._take_rows(jnp.asarray(table), jnp.asarray(rows))
    out = emb._take_rows(torch.from_numpy(table), torch.from_numpy(rows))
    assert out.shape == (6, 20, 64)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())

    from repro.core.quantization import quantize_table as jax_quantize_table

    q = {k: np.array(v) for k, v in jax_quantize_table(jnp.asarray(table)).items()}
    ref = jax_emb._take_rows({k: jnp.asarray(v) for k, v in q.items()}, jnp.asarray(rows))
    out = emb._take_rows({k: torch.from_numpy(v) for k, v in q.items()}, torch.from_numpy(rows))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=0, atol=1e-7)


def test_wrapper_on_cpu_takes_plain_path_and_counts_nothing():
    table, idx, w = _inputs(8, 3, 16)
    before = ops.launches
    out = ops.embedding_bag_op(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w))
    assert ops.launches == before
    ref = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", ["f32_idx", "3d_table", "noncontig_table", "f64_table",
                                  "weights_shape", "empty_bag", "width_not_multiple_of_4",
                                  "misaligned_table"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    table = torch.randn(50, 16)
    idx = torch.randint(0, 50, (4, 3), dtype=torch.int32)
    w = None
    expect = (TypeError, ValueError)
    if case == "f32_idx":
        idx = idx.float()
    elif case == "3d_table":
        table = table.reshape(50, 4, 4)
    elif case == "noncontig_table":
        table = torch.randn(16, 50).t()
    elif case == "f64_table":
        table = table.double()
    elif case == "weights_shape":
        w = torch.ones(4, 2)
    elif case == "empty_bag":
        idx = idx[:, :0].contiguous()
    elif case == "width_not_multiple_of_4":
        table = torch.randn(50, 10)
    elif case == "misaligned_table":
        table = torch.randn(50 * 16 + 1)[1:].view(50, 16)
    with pytest.raises(expect):
        ops.embedding_bag_op(table, idx, w)


def test_importing_the_kernel_modules_needs_no_nvcc(tmp_path):
    """With no nvcc on PATH and no CUDA_HOME, every kernel module imports."""
    code = (
        "import shutil; assert shutil.which('nvcc') is None; "
        "import repro_torch.kernels._build, repro_torch.kernels.embedding_bag.ops, "
        "repro_torch.kernels.embedding_bag.embedding_bag, repro_torch.models.recsys.embedding"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO / "src"), "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("quantized", [False, True])
def test_unified_lookup_matches_jax(quantized, rec_rules):
    from repro.configs.base import FieldSpec as JField, RecSysConfig as JConfig
    from repro.core.quantization import quantize_table as jax_quantize_table
    from repro_torch.configs.base import FieldSpec, RecSysConfig

    vocabs = (30, 200, 7)
    jcfg = JConfig("u", "recsys", "fm", 16, tuple(JField(f"f{i}", v) for i, v in enumerate(vocabs)))
    tcfg = RecSysConfig("u", "recsys", "fm", 16, tuple(FieldSpec(f"f{i}", v) for i, v in enumerate(vocabs)))
    np.testing.assert_array_equal(jax_emb.unified_offsets(jcfg), emb.unified_offsets(tcfg))
    table, _, _ = _inputs(1, 1, 16, seed=5, V=256)
    rng = np.random.default_rng(6)
    sparse = np.stack([rng.integers(0, v, 12) for v in vocabs], axis=1).astype(np.int32)
    jt = jnp.asarray(table)
    tt = torch.from_numpy(table)
    if quantized:
        jt = jax_quantize_table(jt)
        tt = {k: torch.from_numpy(np.array(v)) for k, v in jt.items()}
    ref = jax_emb.unified_lookup(jt, jnp.asarray(sparse), jcfg, rec_rules)
    out = emb.unified_lookup(tt, torch.from_numpy(sparse), tcfg)
    assert out.shape == (12, 3, 16)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=0, atol=0 if not quantized else 1e-7)
