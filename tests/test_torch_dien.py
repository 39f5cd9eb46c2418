"""The ported DIEN model and AUGRU kernel against `repro`'s, on the CPU at a
small size (vocabs <= 1000, widths as configured, L=20).

Same JAX-initialised parameters (carried through numpy), same numpy
batches from `taobao_batches`. Tolerance atol 1e-5 throughout: both sides
are f32 with different matmul backends and summation orders, and every
GRU state lies in (-1, 1). DIEN is served as `baseline` only: `repro`
cannot serve a quantized DIEN (pinned below).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quantization import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.data.synthetic import taobao_batches  # noqa: E402
from repro.kernels.augru.augru import augru as jax_augru  # noqa: E402
from repro.kernels.augru.ref import augru_ref as jax_augru_ref  # noqa: E402
from repro.models.recsys import api as jax_api  # noqa: E402
from repro.models.recsys import dien as jax_dien  # noqa: E402
from repro_torch.kernels.augru import ops  # noqa: E402
from repro_torch.kernels.augru.ref import augru_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.models.recsys import api, dien  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_params, jnp_batch, reduced_pair, to_torch_params, torch_batch,
)

ATOL = 1e-5


def _augru_inputs(B, T, g, seed=0):
    rng = np.random.default_rng(seed)
    zx = rng.normal(size=(B, T, 3 * g)).astype(np.float32)
    wh = (rng.normal(size=(g, 3 * g)) * 0.3).astype(np.float32)
    h0 = (rng.normal(size=(B, g)) * 0.1).astype(np.float32)
    att = rng.uniform(size=(B, T)).astype(np.float32)
    mask = rng.uniform(size=(B, T)) > 0.2
    return zx, wh, h0, att, mask


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("B,T,g", [(128, 20, 16), (256, 50, 32)])
def test_plain_version_matches_pallas_kernel(B, T, g):
    args = _augru_inputs(B, T, g)
    ref = jax_augru(*map(jnp.asarray, args), bb=128, interpret=True)
    out = augru_ref(*map(torch.from_numpy, args))
    _close(ref, out)


@pytest.mark.parametrize("B", [1, 37])
def test_wrapper_at_ragged_batch_matches_ref_and_counts_nothing(B):
    """`repro`'s wrapper falls back to its ref at a B that 128 does not
    divide; the port's takes any B (here on the CPU: the plain version)."""
    args = _augru_inputs(B, 20, 108, seed=B)
    before = ops.launches
    out = ops.augru_op(*map(torch.from_numpy, args))
    assert ops.launches == before and out.shape == (B, 108)
    _close(jax_augru_ref(*map(jnp.asarray, args)), out)


@pytest.mark.parametrize("case", ["f64_zx", "float_mask", "wh_shape", "att_shape", "noncontig_zx"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    zx, wh, h0, att, mask = map(torch.from_numpy, _augru_inputs(4, 6, 8))
    if case == "f64_zx":
        zx = zx.double()
    elif case == "float_mask":
        mask = mask.float()
    elif case == "wh_shape":
        wh = wh[:, :16].contiguous()
    elif case == "att_shape":
        att = att[:, :5].contiguous()
    elif case == "noncontig_zx":
        zx = zx.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        ops.augru_op(zx, wh, h0, att, mask)


def test_plain_version_matches_repro_dien_augru_scan():
    """The kernel's function is DIEN's stage 2: `repro`'s `_run_gru` with
    attention, from the input projection, equals the port's plain version."""
    rng = np.random.default_rng(3)
    B, T, g, du = 6, 12, 16, 10
    p = {"augru_wx": (rng.normal(size=(du, 3 * g)) * 0.3).astype(np.float32),
         "augru_wh": (rng.normal(size=(g, 3 * g)) * 0.3).astype(np.float32),
         "augru_b": (rng.normal(size=(3 * g,)) * 0.1).astype(np.float32)}
    xs = rng.normal(size=(B, T, du)).astype(np.float32)
    att = rng.uniform(size=(B, T)).astype(np.float32)
    mask = rng.uniform(size=(B, T)) > 0.3
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    h_model, _ = jax_dien._run_gru(jp, "augru", jnp.asarray(xs), jnp.asarray(mask), g,
                                   att=jnp.asarray(att))
    zx = torch.from_numpy(xs) @ torch.from_numpy(p["augru_wx"]) + torch.from_numpy(p["augru_b"])
    out = ops.augru_op(zx, torch.from_numpy(p["augru_wh"]), torch.zeros(B, g),
                       torch.from_numpy(att), torch.from_numpy(mask))
    _close(h_model, out)


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = reduced_pair("dien", seq_len=20)
    jp = jax_params(jcfg, seed=3)
    tp = to_torch_params(jp)
    batch = next(taobao_batches(jcfg, 16, 1, seed=5))
    return jcfg, tcfg, jp, tp, batch


def test_run_gru_states_match_jax(world, rec_rules):
    jcfg, tcfg, jp, tp, batch = world
    hist_j = jax_dien._behaviour_emb(jp, jnp_batch(batch), jcfg, rec_rules, hist=True)
    hist_t = dien._behaviour_emb(tp, torch_batch(batch), tcfg, hist=True)
    _close(hist_j, hist_t, atol=0)  # gathers are exact
    L = hist_t.shape[1]
    mask = np.arange(L)[None] < batch["hist_len"][:, None]
    h_j, hs_j = jax_dien._run_gru(jp, "gru1", hist_j, jnp.asarray(mask), jcfg.gru_dim)
    h_t, hs_t = dien._run_gru(tp, "gru1", hist_t, torch.from_numpy(mask), tcfg.gru_dim)
    assert hs_t.shape == (16, L, 108)
    _close(hs_j, hs_t)
    _close(h_j, h_t)


def test_serve_matches_jax(world, rec_rules):
    jcfg, tcfg, jp, tp, batch = world
    ref = jax_api.serve(jp, jnp_batch(batch), jcfg, rec_rules)
    out = api.serve(tp, torch_batch(batch), tcfg)
    assert out.shape == (16,) and out.dtype == torch.float32
    _close(ref, out)


@pytest.mark.parametrize("hist_len", ["drawn", "one"])
def test_logits_match_jax(world, hist_len, rec_rules):
    """Also at hist_len = 1: every attention row puts all its mass on step 0."""
    jcfg, tcfg, jp, tp, batch = world
    if hist_len == "one":
        batch = dict(batch, hist_len=np.ones_like(batch["hist_len"]))
    _close(jax_dien.logits(jp, jnp_batch(batch), jcfg, rec_rules),
           dien.logits(tp, torch_batch(batch), tcfg))


def test_loss_matches_jax(world, rec_rules):
    jcfg, tcfg, jp, tp, batch = world
    ref, ref_aux = jax_api.loss(jp, jnp_batch(batch), jcfg, rec_rules)
    out, aux = api.loss(tp, torch_batch(batch), tcfg)
    assert out.ndim == 0 and set(aux) == set(ref_aux) == {"bce"}
    _close(ref, out)


def test_retrieval_matches_jax(world, rec_rules):
    jcfg, tcfg, jp, tp, batch = world
    rng = np.random.default_rng(7)
    query = {k: batch[k][:1] for k in ("user", "hist_item", "hist_category", "hist_len")}
    query["cand_category"] = rng.integers(0, 1000, 50).astype(np.int32)
    cand = rng.integers(0, 1000, 50).astype(np.int32)
    ref = jax_api.retrieval(jp, jnp_batch(query), jnp.asarray(cand), jcfg, rec_rules)
    out = api.retrieval(tp, torch_batch(query), torch.from_numpy(cand), tcfg)
    assert out.shape == (50,)
    _close(ref, out)


def test_param_count_matches_jax(world):
    from repro.models.common import param_count as jax_param_count

    jcfg, tcfg, _, _, _ = world
    assert param_count(api.param_defs(tcfg)) == jax_param_count(jax_api.param_defs(jcfg))


def test_quantized_dien_fails_in_repro_and_is_refused_by_the_launcher(world, rec_rules):
    jcfg, tcfg, jp, _, batch = world
    with pytest.raises(TypeError):
        jax_api.serve(jax_quantize_tree(jp), jnp_batch(batch), jcfg, rec_rules)
    with pytest.raises(NotImplementedError, match=r"dien\.py:46"):
        serve.run(dataclasses.replace(tcfg, seq_len=4), variants=["quantized"], sizes=(1,),
                  device="cpu", reps=10)
    with pytest.raises(NotImplementedError, match=r"dien\.py:46"):
        serve.main(["--arch", "dien", "--variants", "quantized", "--device", "cpu"])
