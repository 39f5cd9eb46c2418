"""The ported DIN model against `repro`'s, on the CPU at a small size
(vocabs <= 1000, widths as configured, L=20).

Same JAX-initialised parameters (carried through numpy), same numpy
batches from `taobao_batches`, with history lengths that include 0 (every
step masked: the softmax is uniform over -1e30s) and L; `quantized` is
made by each package's own `quantize_tree` from the same parameters.
Tolerances, those in force for FM and DIEN:

- serve, logits, loss and retrieval: atol 1e-5 (f32 on both sides, other
  matmul backends and summation orders); the gathers exactly;
- one SGD step and one AdamW step through `make_train_step`:
  `tests/test_torch_optimizer.py`'s `SGD_ATOL` and its AdamW rule
  (`ADAM_ATOL`, `ADAM_FLIP_SHARE`, at most 2·lr a step), for that file's
  reasons.

DIN serves `baseline` and `quantized`; `repro` builds no trained variant
of it (its ladder's distillation copies a taobao_ssa teacher's "pos"),
which the launcher refuses (`serve.UNSERVABLE`), shown raising in `repro`
below. `repro`'s retrieval takes candidate rows with a bare `jnp.take`, so
quantized retrieval has no reference.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.compression_loop import LadderConfig as JaxLadderConfig  # noqa: E402
from repro.core.compression_loop import run_ladder as jax_run_ladder  # noqa: E402
from repro.core.quantization import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.data.synthetic import taobao_batches  # noqa: E402
from repro.models.common import param_count as jax_param_count  # noqa: E402
from repro.models.recsys import api as jax_api  # noqa: E402
from repro.models.recsys import din as jax_din  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.quantization import quantize_tree  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.models.recsys import api, din  # noqa: E402
from test_torch_optimizer import ADAM_ATOL, ADAM_FLIP_SHARE, SGD_ATOL, _run_both  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_params, jnp_batch, reduced_pair, to_torch_params, torch_batch,
)

ATOL = 1e-5
L = 20


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = reduced_pair("din", seq_len=L)
    jp = jax_params(jcfg, seed=3)
    tp = to_torch_params(jp)
    variants = {"baseline": (jp, tp), "quantized": (jax_quantize_tree(jp), quantize_tree(tp))}
    batch = next(taobao_batches(jcfg, 16, 1, seed=5))
    batch["hist_len"][:3] = [0, L, 1]
    return jcfg, tcfg, variants, batch


def test_config_is_repros():
    from repro.configs.base import get_config as jax_get_config

    assert dataclasses.asdict(get_config("din")) == dataclasses.asdict(jax_get_config("din"))


def test_behaviour_embedding_is_the_exact_gather(world, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants["baseline"]
    for hist in (True, False):
        ref = jax_din._behaviour_emb(jp, jnp_batch(batch), jcfg, rec_rules, hist)
        _close(ref, din._behaviour_emb(tp, torch_batch(batch), tcfg, hist), atol=0)


def test_target_attention_matches_jax(world, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants["baseline"]
    hist = din._behaviour_emb(tp, torch_batch(batch), tcfg, hist=True)
    cand = din._behaviour_emb(tp, torch_batch(batch), tcfg, hist=False)
    mask = np.arange(L)[None] < batch["hist_len"][:, None]
    ref = jax_din.target_attention(jp, jnp.asarray(hist.numpy()), jnp.asarray(cand.numpy()),
                                   jnp.asarray(mask), jcfg)
    out = din.target_attention(tp, hist, cand, torch.from_numpy(mask), tcfg)
    assert out.shape == (16, 2 * tcfg.embed_dim)
    _close(ref, out)
    # no valid step: the weights are uniform over all L steps, as in repro
    _close(hist[0].mean(dim=0), out[0])


@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_serve_matches_jax(world, variant, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants[variant]
    ref = jax_api.serve(jp, jnp_batch(batch), jcfg, rec_rules)
    before = eb_ops.launches
    out = api.serve(tp, torch_batch(batch), tcfg)
    assert eb_ops.launches == before  # the CPU runs the plain version
    assert out.shape == (16,) and out.dtype == torch.float32
    _close(ref, out)


@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_logits_match_jax(world, variant, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants[variant]
    _close(jax_din.logits(jp, jnp_batch(batch), jcfg, rec_rules),
           din.logits(tp, torch_batch(batch), tcfg))


@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_loss_matches_jax(world, variant, rec_rules):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants[variant]
    ref, ref_aux = jax_api.loss(jp, jnp_batch(batch), jcfg, rec_rules)
    out, aux = api.loss(tp, torch_batch(batch), tcfg)
    assert out.ndim == 0 and set(aux) == set(ref_aux) == {"bce"}
    _close(ref, out)


@pytest.mark.parametrize("hist_len", [0, 7, L])
def test_retrieval_matches_jax(world, rec_rules, hist_len):
    jcfg, tcfg, variants, batch = world
    jp, tp = variants["baseline"]
    rng = np.random.default_rng(7)
    query = {k: batch[k][3:4] for k in ("user", "hist_item", "hist_category")}
    query["hist_len"] = np.array([hist_len], np.int32)
    query["cand_category"] = rng.integers(0, 1000, 50).astype(np.int32)
    cand = rng.integers(0, 1000, 50).astype(np.int32)
    ref = jax_api.retrieval(jp, jnp_batch(query), jnp.asarray(cand), jcfg, rec_rules)
    out = api.retrieval(tp, torch_batch(query), torch.from_numpy(cand), tcfg)
    assert out.shape == (50,)
    _close(ref, out)


def test_quantized_retrieval_runs_where_repro_raises(world, rec_rules):
    """`repro` takes the candidates' rows with a bare `jnp.take`
    (`din.py:81, 83`), which an int8 table dict cannot take; the port
    dequantizes them, and its scores are then the quantized serve call's
    for the same (user, history, candidate) rows."""
    jcfg, tcfg, variants, batch = world
    jq, tq = variants["quantized"]
    query = {k: batch[k][3:4] for k in ("user", "hist_item", "hist_category", "hist_len")}
    query["cand_category"] = batch["category"][:8]
    cand = batch["item"][:8]
    with pytest.raises(TypeError):
        jax_api.retrieval(jq, jnp_batch(query), jnp.asarray(cand), jcfg, rec_rules)
    out = din.retrieval(tq, torch_batch(query), torch.from_numpy(cand), tcfg)
    rows = {k: np.repeat(v, 8, axis=0) for k, v in query.items() if k != "cand_category"}
    rows.update(item=cand, category=query["cand_category"])
    _close(din.logits(tq, torch_batch(rows), tcfg).detach().numpy(), out)


def test_param_count_matches_jax(world):
    jcfg, tcfg, _, _ = world
    assert param_count(api.param_defs(tcfg)) == jax_param_count(jax_api.param_defs(jcfg))


@pytest.fixture(scope="module")
def steps_world(world):
    jcfg, tcfg, variants, _ = world
    batch = next(taobao_batches(jcfg, 32, 1, seed=6))
    batch["hist_len"][:2] = [0, L]
    return jcfg, tcfg, variants["baseline"][0], [batch]


def test_one_sgd_step_matches_repro(steps_world, rec_rules):
    ref, out, metrics = _run_both(steps_world, rec_rules, ("sgd", 0.1))
    assert ref.keys() == out.keys()
    for jn, tn, jl, tl in metrics:
        assert tn == pytest.approx(jn, rel=1e-5) and tl == pytest.approx(jl, rel=1e-5)
    for path, t in out.items():
        np.testing.assert_allclose(t.numpy(), ref[path], rtol=0, atol=SGD_ATOL, err_msg=str(path))
    before = np.asarray(steps_world[2]["attn_w0"])
    assert np.abs(out[("attn_w0",)].numpy() - before).max() > 0


def test_one_adamw_step_matches_repro(steps_world, rec_rules):
    ref, out, metrics = _run_both(steps_world, rec_rules, ("adamw", 1e-3))
    for jn, tn, jl, tl in metrics:
        assert tl == pytest.approx(jl, rel=1e-5) and tn == pytest.approx(jn, rel=1e-3)
    n = n_far = 0
    for path, t in out.items():
        d = np.abs(t.numpy() - ref[path])
        assert d.max() <= 2 * 1e-3 * len(metrics), path  # at most 2·lr a step
        n, n_far = n + d.size, n_far + int((d > ADAM_ATOL).sum())
    assert n_far <= ADAM_FLIP_SHARE * n


@pytest.fixture(scope="module")
def repro_ladder_error(world, rec_rules):
    """What `repro`'s `run_ladder` raises for DIN, from its parameters."""
    jcfg, _, variants, batch = world
    with pytest.raises(KeyError, match="pos") as err:
        jax_run_ladder(variants["baseline"][0], jcfg, rec_rules, lambda: iter([jnp_batch(batch)]),
                       JaxLadderConfig(finetune_steps=1, qat_steps=1, distill_steps=1))
    return err.value


@pytest.mark.parametrize("variant", ["pruned", "pruned_quantized", "distilled"])
def test_each_trained_variant_raises_in_repro_and_is_refused(world, repro_ladder_error, variant):
    """`repro`'s ladder builds no DIN variant: its distillation copies the
    teacher's "pos", which DIN has not (`distillation.py:33-39`)."""
    _, tcfg, _, _ = world
    assert "distillation.py:33-39" in serve.UNSERVABLE[("target_attn", variant)]
    assert variant not in serve.variants_for(tcfg)
    with pytest.raises(NotImplementedError, match=r"distillation\.py:33-39"):
        serve.run(tcfg, variants=[variant], sizes=(1,), device="cpu")
