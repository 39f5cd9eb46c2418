"""The port's compressible-linear reps and PTQ against `repro`'s, on the CPU.

Every rep's `linear`, `weight_view` and `nbytes` on the same numpy weights
and inputs, to 1e-5; `quantize_tree` and `model_bytes` on the same
JAX-initialised ranker tree: the same tree structure, bit-equal `q` and
`s`, equal byte counts.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import lightweight as jlw  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro_torch.core import lightweight as tlw  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.models.common import to_numpy_tree  # noqa: E402
from torch_parity import jax_params, small_configs, to_numpy, to_torch_params  # noqa: E402

D_IN, D_OUT = 32, 48
REPS = ["dense", "masked", "lowrank", "grouped", "dwsep", "int8", "int8_mask"]


def _rep(kind, rng):
    w = rng.normal(size=(D_IN, D_OUT)).astype(np.float32)
    mask = (rng.random((D_IN, D_OUT)) < 0.5).astype(np.float32)
    if kind == "dense":
        return w
    if kind == "masked":
        return {"w": w, "mask": mask}
    if kind == "lowrank":
        return {"a": rng.normal(size=(D_IN, 8)).astype(np.float32),
                "b": rng.normal(size=(8, D_OUT)).astype(np.float32)}
    if kind == "grouped":
        return {"gw": rng.normal(size=(4, D_IN // 4, D_OUT // 4)).astype(np.float32)}
    if kind == "dwsep":
        return {"dw": rng.normal(size=(3, D_IN)).astype(np.float32), "pw": w}
    q = {k: np.array(v) for k, v in jq.quantize_weight(jnp.asarray(w)).items()}
    if kind == "int8_mask":
        q["mask"] = mask
    return q


def _both(rep):
    if isinstance(rep, dict):
        return ({k: jnp.asarray(v) for k, v in rep.items()},
                {k: torch.from_numpy(v.copy()) for k, v in rep.items()})
    return jnp.asarray(rep), torch.from_numpy(rep.copy())


@pytest.mark.parametrize("kind", REPS)
def test_linear_weight_view_nbytes_match_jax(kind):
    rng = np.random.default_rng(REPS.index(kind))
    jrep, trep = _both(_rep(kind, rng))
    x = rng.normal(size=(3, 10, D_IN)).astype(np.float32)  # [B, L, d_in]: dwsep needs a seq axis
    ref = jlw.linear(jrep, jnp.asarray(x))
    out = tlw.linear(trep, torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5, atol=1e-5)
    assert tlw.nbytes(trep) == jlw.nbytes(jrep)
    if kind != "dwsep":  # no dense view in either package
        np.testing.assert_allclose(np.asarray(jlw.weight_view(jrep)),
                                   tlw.weight_view(trep).numpy(), rtol=1e-5, atol=1e-5)
    else:
        with pytest.raises(ValueError):
            tlw.weight_view(trep)


def test_low_rank_and_grouped_constructors_match_jax():
    rng = np.random.default_rng(9)
    w = rng.normal(size=(D_IN, D_OUT)).astype(np.float32)
    jr = jlw.low_rank_factorize(jnp.asarray(w), 8)
    tr = tlw.low_rank_factorize(torch.from_numpy(w), 8)
    # singular-vector signs may differ: compare the product
    np.testing.assert_allclose(np.asarray(jr["a"] @ jr["b"]), (tr["a"] @ tr["b"]).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jlw.to_grouped(jnp.asarray(w), 4)["gw"]),
                                  tlw.to_grouped(torch.from_numpy(w), 4)["gw"].numpy())


@pytest.fixture(scope="module")
def ranker_trees():
    jcfg, _ = small_configs()
    jp = jax_params(jcfg, seed=1)
    return jp, to_torch_params(jp)


def test_quantize_tree_is_bit_equal_to_jax(ranker_trees):
    jp, tp = ranker_trees
    ref = to_numpy(jq.quantize_tree(jp))
    out = to_numpy_tree(tq.quantize_tree(tp))
    flat_r, tree_r = jax.tree_util.tree_flatten_with_path(ref)
    flat_o, tree_o = jax.tree_util.tree_flatten_with_path(out)
    assert tree_r == tree_o
    for (path, a), (_, b) in zip(flat_r, flat_o):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # tables are per-row int8, weights per-column int8, `pos` stays f32
    assert out["tables"]["item"]["q"].dtype == np.int8
    assert out["tables"]["item"]["s"].shape == (out["tables"]["item"]["q"].shape[0],)
    assert out["enc0"]["wq"]["s"].shape == (out["enc0"]["wq"]["q"].shape[1],)
    assert out["pos"].dtype == np.float32


def test_model_bytes_match_jax(ranker_trees):
    jp, tp = ranker_trees
    assert tq.model_bytes(tp) == jq.model_bytes(jp)
    assert tq.model_bytes(tq.quantize_tree(tp)) == jq.model_bytes(jq.quantize_tree(jp))
    assert tq.model_bytes(tq.quantize_tree(tp)) < 0.30 * tq.model_bytes(tp)


def test_fake_quant_and_dequantize_match_jax():
    rng = np.random.default_rng(11)
    w = rng.normal(size=(20, 12)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jq.fake_quant(jnp.asarray(w))),
                               tq.fake_quant(torch.from_numpy(w)).numpy(), rtol=1e-6, atol=1e-6)
    for fn in ("quantize_weight", "quantize_table"):
        jrep = getattr(jq, fn)(jnp.asarray(w))
        trep = getattr(tq, fn)(torch.from_numpy(w))
        np.testing.assert_array_equal(np.asarray(jrep["q"]), trep["q"].numpy())
        np.testing.assert_array_equal(np.asarray(jq.dequantize(jrep)), tq.dequantize(trep).numpy())
