"""The ported FM model and FM interaction kernel against `repro`'s, on the
CPU at a small size.

Same JAX-initialised parameters (carried through numpy), same numpy
batches from `criteo_batches`; `quantized` is made by each package's own
`quantize_tree` from the same parameters. Tolerances:

- the model (serve, logits, loss, retrieval): atol 1e-5, both sides f32
  with different summation orders;
- the interaction alone on N(0, 1) inputs: the JAX kernel test's
  rtol 1e-4, atol 1e-3, for the cancellation in (Σe)² − Σe².
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quantization import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.data.synthetic import criteo_batches  # noqa: E402
from repro.kernels.fm_interaction.fm_interaction import fm_interaction_kernel  # noqa: E402
from repro.kernels.fm_interaction.ref import fm_interaction_ref as jax_fm_ref  # noqa: E402
from repro.models.recsys import api as jax_api  # noqa: E402
from repro.models.recsys import fm as jax_fm  # noqa: E402
from repro_torch.core.quantization import quantize_tree  # noqa: E402
from repro_torch.kernels.fm_interaction import ops  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref  # noqa: E402
from repro_torch.models.common import init_params, param_count, to_numpy_tree  # noqa: E402
from repro_torch.models.recsys import api, fm  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_params, jnp_batch, reduced_pair, to_torch_params, torch_batch,
)

ATOL = 1e-5


def _e(B, F, k, seed=0):
    return np.random.default_rng(seed).normal(size=(B, F, k)).astype(np.float32)


@pytest.mark.parametrize("B,F,k", [(256, 39, 10), (512, 39, 10), (512, 8, 16)])
def test_plain_version_matches_pallas_kernel(B, F, k):
    e = _e(B, F, k)
    out = fm_interaction_ref(torch.from_numpy(e))
    ref = fm_interaction_kernel(jnp.asarray(e), bb=256, interpret=True)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(jax_fm_ref(jnp.asarray(e))), out.numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("B", [1, 37, 300])
def test_wrapper_at_ragged_batch_matches_ref_and_counts_nothing(B):
    """`repro`'s wrapper falls back to its ref at a B that 256 does not
    divide; the port's takes any B (here on the CPU: the plain version)."""
    e = _e(B, 39, 10, seed=B)
    before = ops.launches
    out = ops.fm_interaction_op(torch.from_numpy(e))
    assert ops.launches == before and out.shape == (B,)
    np.testing.assert_allclose(np.asarray(jax_fm_ref(jnp.asarray(e))), out.numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("case", ["f64", "2d", "noncontig", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    e = torch.randn(8, 39, 10)
    if case == "f64":
        e = e.double()
    elif case == "2d":
        e = e[:, 0]
    elif case == "noncontig":
        e = e.transpose(1, 2)
    elif case == "empty":
        e = e[:0]
    with pytest.raises((TypeError, ValueError)):
        ops.fm_interaction_op(e)


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = reduced_pair("fm")
    jp = jax_params(jcfg, seed=3)
    tp = to_torch_params(jp)
    variants = {
        "baseline": (jp, tp),
        "quantized": (jax_quantize_tree(jp), quantize_tree(tp)),
    }
    batch = next(criteo_batches(jcfg, 16, 1, seed=5))
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
def test_logits_match_jax(world, variant, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants[variant]
    _close(jax_fm.logits(jp, jnp_batch(batch), jcfg, rec_rules),
           fm.logits(tp, torch_batch(batch), tcfg))


@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_loss_matches_jax(world, variant, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants[variant]
    ref, ref_aux = jax_api.loss(jp, jnp_batch(batch), jcfg, rec_rules)
    out, aux = api.loss(tp, torch_batch(batch), tcfg)
    assert out.ndim == 0 and set(aux) == set(ref_aux) == {"bce"}
    _close(ref, out)


def test_retrieval_matches_jax(world, rec_rules):
    """`baseline` only: `repro`'s FM retrieval gathers candidate rows with a
    bare `jnp.take` (`fm.py:73,75`), which an int8 table cannot take."""
    jcfg, tcfg, variants, batch = world
    jp, tp = variants["baseline"]
    cand_vocab = max(f.vocab for f in tcfg.fields)
    cand = np.random.default_rng(7).integers(0, cand_vocab, 50).astype(np.int32)
    query = {"sparse_idx": batch["sparse_idx"][:1]}
    ref = jax_api.retrieval(jp, jnp_batch(query), jnp.asarray(cand), jcfg, rec_rules)
    out = api.retrieval(tp, torch_batch(query), torch.from_numpy(cand), tcfg)
    assert out.shape == (50,)
    _close(ref, out)


def test_param_tree_round_trips_with_0d_bias(world):
    """The 0-d `bias` stays 0-d through `init_params`, `from_numpy_tree`
    and `quantize_tree`; the int8 reps of quantized FM cross bit-equal."""
    jcfg, tcfg, variants, _ = world
    for jp, tp in variants.values():
        assert tp["bias"].shape == () and tp["bias"].dtype == torch.float32
        back = to_numpy_tree(tp)
        flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        for (_, a), (_, b) in zip(flat_j, flat_t):
            assert a.shape == b.shape and np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)
    q = variants["quantized"][1]
    assert set(q["table"]) == set(q["linear"]) == {"q", "s"} and q["linear"]["q"].shape[1] == 1
    fresh = init_params(api.param_defs(tcfg), torch.Generator().manual_seed(0), "cpu")
    assert fresh["bias"].shape == () and float(fresh["bias"]) == 0.0
    from repro.models.common import param_count as jax_param_count

    assert param_count(api.param_defs(tcfg)) == jax_param_count(jax_api.param_defs(jcfg))
    # padded unified rows: Σ vocab of the reduced config, up to a multiple of 512
    rows = -(-tcfg.table_rows() // 512) * 512
    assert fresh["table"].shape == (rows, 10) and fresh["linear"].shape == (rows, 1)
