"""The ported AutoInt model against `repro`'s, on the CPU at a small size
(vocabs <= 1000 for the 39 Criteo fields, widths as configured: 3 layers
of 2 heads × 32 over embeddings of 16).

Same JAX-initialised parameters (carried through numpy), same numpy
batches from `criteo_batches`. Tolerances, those in force for FM and DIEN:

- serve, logits, loss and retrieval: atol 1e-5 (f32 on both sides, other
  matmul backends and summation orders); the lookup exactly;
- one SGD step and one AdamW step through `make_train_step`:
  `tests/test_torch_optimizer.py`'s `SGD_ATOL` and its AdamW rule
  (`ADAM_ATOL`, `ADAM_FLIP_SHARE`, at most 2·lr a step), for that file's
  reasons.

AutoInt serves `baseline` only: `repro` multiplies its projections with a
bare `@`, which raises on the int8 reps of `quantize_tree` and on the
masked reps its ladder's pruning makes. Each pair the launcher refuses
(`serve.UNSERVABLE`) is shown raising in `repro` below.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.compression_loop import LadderConfig as JaxLadderConfig  # noqa: E402
from repro.core.compression_loop import run_ladder as jax_run_ladder  # noqa: E402
from repro.core.quantization import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.data.synthetic import criteo_batches  # noqa: E402
from repro.models.common import param_count as jax_param_count  # noqa: E402
from repro.models.recsys import api as jax_api  # noqa: E402
from repro.models.recsys import autoint as jax_autoint  # noqa: E402
from repro.models.recsys.embedding import unified_lookup as jax_unified_lookup  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.quantization import quantize_tree  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.models.recsys import api, autoint  # noqa: E402
from repro_torch.models.recsys.embedding import unified_lookup  # noqa: E402
from test_torch_optimizer import ADAM_ATOL, ADAM_FLIP_SHARE, SGD_ATOL, _run_both  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_params, jnp_batch, reduced_pair, to_torch_params, torch_batch,
)

ATOL = 1e-5


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = reduced_pair("autoint")
    jp = jax_params(jcfg, seed=3)
    batch = next(criteo_batches(jcfg, 16, 1, seed=5))
    return jcfg, tcfg, jp, to_torch_params(jp), batch


def test_config_is_repros():
    from repro.configs.base import get_config as jax_get_config

    assert dataclasses.asdict(get_config("autoint")) == dataclasses.asdict(
        jax_get_config("autoint"))


def test_dims_and_param_count_match_jax(world):
    jcfg, tcfg, _, tp, _ = world
    assert autoint._dims(tcfg) == jax_autoint._dims(jcfg) == ([16, 64, 64], 64)
    assert param_count(api.param_defs(tcfg)) == jax_param_count(jax_api.param_defs(jcfg))
    assert tp["w_out"].shape == (39 * 64, 1)


def test_interaction_stack_matches_jax(world, rec_rules):
    jcfg, tcfg, jp, tp, batch = world
    e_j = jax_unified_lookup(jp["table"], jnp.asarray(batch["sparse_idx"]), jcfg, rec_rules)
    e_t = unified_lookup(tp["table"], torch.from_numpy(batch["sparse_idx"]), tcfg)
    _close(e_j, e_t, atol=0)  # the lookup is exact
    out = autoint._interact(tp, e_t, tcfg)
    assert out.shape == (16, 39, 64)
    _close(jax_autoint._interact(jp, e_j, jcfg), out)


def test_serve_matches_jax(world, rec_rules):
    jcfg, tcfg, jp, tp, batch = world
    ref = jax_api.serve(jp, jnp_batch(batch), jcfg, rec_rules)
    before = eb_ops.launches
    out = api.serve(tp, torch_batch(batch), tcfg)
    assert eb_ops.launches == before  # the CPU runs the plain version
    assert out.shape == (16,) and out.dtype == torch.float32
    _close(ref, out)


def test_logits_match_jax(world, rec_rules):
    jcfg, tcfg, jp, tp, batch = world
    _close(jax_autoint.logits(jp, jnp_batch(batch), jcfg, rec_rules),
           autoint.logits(tp, torch_batch(batch), tcfg))


def test_loss_matches_jax(world, rec_rules):
    jcfg, tcfg, jp, tp, batch = world
    ref, ref_aux = jax_api.loss(jp, jnp_batch(batch), jcfg, rec_rules)
    out, aux = api.loss(tp, torch_batch(batch), tcfg)
    assert out.ndim == 0 and set(aux) == set(ref_aux) == {"bce"}
    _close(ref, out)


def test_retrieval_matches_jax(world, rec_rules):
    jcfg, tcfg, jp, tp, batch = world
    cand_vocab = max(f.vocab for f in tcfg.fields)
    cand = np.random.default_rng(7).integers(0, cand_vocab, 50).astype(np.int32)
    query = {"sparse_idx": batch["sparse_idx"][:1]}
    ref = jax_api.retrieval(jp, jnp_batch(query), jnp.asarray(cand), jcfg, rec_rules)
    out = api.retrieval(tp, torch_batch(query), torch.from_numpy(cand), tcfg)
    assert out.shape == (50,)
    _close(ref, out)


@pytest.fixture(scope="module")
def steps_world(world):
    jcfg, tcfg, jp, _, _ = world
    return jcfg, tcfg, jp, [next(criteo_batches(jcfg, 32, 1, seed=6))]


def test_one_sgd_step_matches_repro(steps_world, rec_rules):
    ref, out, metrics = _run_both(steps_world, rec_rules, ("sgd", 0.1))
    assert ref.keys() == out.keys()
    for jn, tn, jl, tl in metrics:
        assert tn == pytest.approx(jn, rel=1e-5) and tl == pytest.approx(jl, rel=1e-5)
    for path, t in out.items():
        np.testing.assert_allclose(t.numpy(), ref[path], rtol=0, atol=SGD_ATOL, err_msg=str(path))
    before = np.asarray(steps_world[2]["attn0"]["wq"])
    assert np.abs(out[("attn0", "wq")].numpy() - before).max() > 0


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


def test_quantized_variant_raises_in_repro_and_is_refused(world, rec_rules):
    """`repro`'s `_interact` multiplies `x @ p["wq"]` (`autoint.py:50-52`)
    with `wq` an int8 rep dict after `quantize_tree`; so does the port's."""
    jcfg, tcfg, jp, tp, batch = world
    with pytest.raises(TypeError, match="@"):
        jax_api.serve(jax_quantize_tree(jp), jnp_batch(batch), jcfg, rec_rules)
    with pytest.raises(TypeError, match="@"):
        api.serve(quantize_tree(tp), torch_batch(batch), tcfg)
    assert "autoint.py:50-52" in serve.UNSERVABLE[("self_attn", "quantized")]
    assert serve.variants_for(tcfg) == ("baseline",)
    with pytest.raises(NotImplementedError, match=r"autoint\.py:50-52"):
        serve.main(["--arch", "autoint", "--variants", "quantized", "--device", "cpu"])


@pytest.fixture(scope="module")
def repro_ladder_error(world, rec_rules):
    """What `repro`'s `run_ladder` raises for AutoInt: its first fine-tune
    step runs `_interact` on the masked reps of the pruned projections."""
    jcfg, _, jp, _, batch = world
    with pytest.raises(TypeError, match="@") as err:
        jax_run_ladder(jp, jcfg, rec_rules, lambda: iter([jnp_batch(batch)]),
                       JaxLadderConfig(finetune_steps=1, qat_steps=1, distill_steps=1))
    return err.value


@pytest.mark.parametrize("variant", ["pruned", "pruned_quantized", "distilled"])
def test_each_trained_variant_raises_in_repro_and_is_refused(world, repro_ladder_error, variant):
    _, tcfg, _, _, _ = world
    assert "prune_tree" in serve.UNSERVABLE[("self_attn", variant)]
    assert variant not in serve.variants_for(tcfg)
    with pytest.raises(NotImplementedError, match=r"autoint\.py:50-52"):
        serve.run(tcfg, variants=[variant], sizes=(1,), device="cpu")
