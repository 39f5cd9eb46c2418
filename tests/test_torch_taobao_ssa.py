"""The ported taobao_ssa ranker against `repro`'s, on the CPU at a small size.

Same JAX-initialised parameters (carried through numpy), same numpy
batches; `quantized` is made by each package's own `quantize_tree` from the
same parameters. Tolerance atol 1e-5: both sides are f32, with different
matmul backends and summation orders.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quantization import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.data.synthetic import taobao_batches  # noqa: E402
from repro.models.recsys import api as jax_api  # noqa: E402
from repro.models.recsys import taobao_ssa as jax_ssa  # noqa: E402
from repro_torch.core.quantization import quantize_tree  # noqa: E402
from repro_torch.models.recsys import api  # noqa: E402
from repro_torch.models.recsys import taobao_ssa  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_params, jnp_batch, small_configs, to_torch_params, torch_batch,
)

ATOL = 1e-5


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = small_configs()
    jp = jax_params(jcfg, seed=3)
    tp = to_torch_params(jp)
    variants = {
        "baseline": (jp, tp),
        "quantized": (jax_quantize_tree(jp), quantize_tree(tp)),
    }
    batch = next(taobao_batches(jcfg, 16, 1, seed=5))
    return jcfg, tcfg, variants, batch


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_serve_matches_jax(world, variant, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants[variant]
    ref = jax_api.serve(jp, jnp_batch(batch), jcfg, rec_rules)
    out = api.serve(tp, torch_batch(batch), tcfg)
    assert out.shape == (16,) and out.dtype == torch.float32
    _close(ref, out)


@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_logits_and_attention_probs_match_jax(world, variant, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants[variant]
    ref_lg, ref_attn = jax_ssa.logits_and_attn(jp, jnp_batch(batch), jcfg, rec_rules,
                                               collect_attn=True)
    lg, attn = taobao_ssa.logits_and_attn(tp, torch_batch(batch), tcfg, collect_attn=True)
    _close(ref_lg, lg)
    assert len(attn) == len(ref_attn) == tcfg.n_attn_layers
    for r, a in zip(ref_attn, attn):
        assert a.shape == (16, tcfg.n_heads, tcfg.seq_len, tcfg.seq_len)
        _close(r, a)


@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_retrieval_matches_jax(world, variant, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants[variant]
    rng = np.random.default_rng(7)
    query = {k: batch[k][:1] for k in ("user", "hist_item", "hist_category", "hist_len")}
    query["cand_category"] = rng.integers(0, 1000, 50).astype(np.int32)
    cand = rng.integers(0, 1000, 50).astype(np.int32)
    ref = jax_api.retrieval(jp, jnp_batch(query), jax.numpy.asarray(cand), jcfg, rec_rules)
    out = api.retrieval(tp, torch_batch(query), torch.from_numpy(cand), tcfg)
    assert out.shape == (50,)
    _close(ref, out)


@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_loss_matches_jax(world, variant, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants[variant]
    ref, ref_aux = jax_api.loss(jp, jnp_batch(batch), jcfg, rec_rules)
    out, aux = api.loss(tp, torch_batch(batch), tcfg)
    assert out.ndim == 0 and set(aux) == set(ref_aux) == {"bce"}
    _close(ref, out)


@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_nearly_all_keys_masked(world, variant, rec_rules):
    """hist_len = 1: every query attends to one key; the pool averages one row."""
    jcfg, tcfg, variants, batch = world
    jp, tp = variants[variant]
    b = dict(batch, hist_len=np.ones_like(batch["hist_len"]))
    ref_lg, ref_attn = jax_ssa.logits_and_attn(jp, jnp_batch(b), jcfg, rec_rules,
                                               collect_attn=True)
    lg, attn = taobao_ssa.logits_and_attn(tp, torch_batch(b), tcfg, collect_attn=True)
    _close(ref_lg, lg)
    for r, a in zip(ref_attn, attn):
        _close(r, a)
        # all the mass on key 0
        np.testing.assert_allclose(a[..., 0].numpy(), 1.0, atol=1e-6)


def test_param_tree_round_trips(world):
    from repro_torch.models.common import param_count, to_numpy_tree

    jcfg, tcfg, variants, _ = world
    for jp, tp in variants.values():
        back = to_numpy_tree(tp)
        flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        for (_, a), (_, b) in zip(flat_j, flat_t):
            assert a.shape == b.shape and np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)
    # padded tables: 1000 rows -> 1024, as `_pad_rows` gives
    assert variants["baseline"][1]["tables"]["user"].shape == (1024, 16)
    from repro.models.common import param_count as jax_param_count

    assert param_count(api.param_defs(tcfg)) == jax_param_count(jax_api.param_defs(jcfg))
