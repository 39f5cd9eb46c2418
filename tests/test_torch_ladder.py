"""The port's Table-I ladder against `repro`'s, on the CPU at a small size.

Both packages run `run_ladder` from the same `repro` teacher on the same
numpy batches, unstructured and structured. What must hold:

- every tree has `repro`'s keys, and every mask is equal exactly (the
  pruning rounds after the first read fine-tuned weights, which differ in
  the last bits; a tile or an element would flip only at a tie);
- `variant_stats` (params, bytes, sparsity) are equal;
- each variant's `serve` agrees. Tolerances, from this test's measurement:
  baseline and quantized 1e-5 (the same trees); pruned and distilled 1e-4
  (measured ≤ 8.8e-5: a few AdamW steps, whose g/(√v̂ + 1e-8) magnifies
  the last-bit differences of gradients that cancel to ~1e-8);
  pruned_quantized 2e-2 (measured 1.5e-3 with torch's default thread pool
  and 7.8e-3 with one thread: after QAT the float weights differ in the
  last bits, and a weight near a rounding boundary, or a row whose largest
  entry moved, takes another int8 code). So its int8 weights are also held
  element by element: a dequantized weight lies within one quantization
  step (+1e-4) of `repro`'s, but for at most 1% of a leaf (measured: up to
  0.19% of a table with one torch thread, 0.003% with the default pool:
  entries whose AdamW steps took the other sign) that lie within the AdamW
  bound, one step + 2·lr per training step. The QAT stage's float weights,
  run alone in both packages from `repro`'s pruned variant, are held at
  1e-4 element by element and through `serve`, where the rounding does not
  enter.

Weights carried across: a `repro` ladder's five variants load into the
port (`from_numpy_tree`) and serve as `repro` serves them, and the port's
five variants go back to `repro` (`to_numpy_tree` of
`without_block_masks`) and serve there as in the port.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.compression_loop import LadderConfig as JaxLadderConfig  # noqa: E402
from repro.core.compression_loop import _finetune as jax_finetune  # noqa: E402
from repro.core.compression_loop import run_ladder as jax_run_ladder  # noqa: E402
from repro.core.compression_loop import variant_stats as jax_variant_stats  # noqa: E402
from repro.data.synthetic import taobao_batches  # noqa: E402
from repro.models.recsys import api as jax_api  # noqa: E402
from repro_torch.core.compression_loop import (  # noqa: E402
    LadderConfig, _finetune, run_ladder, serving_params, variant_stats,
)
from repro_torch.core.pruning import without_block_masks  # noqa: E402
from repro_torch.core.quantization import dequantize  # noqa: E402
from repro_torch.kernels.block_pruned_matmul import ops as bpm_ops  # noqa: E402
from repro_torch.models.common import from_numpy_tree, to_numpy_tree, tree_leaves  # noqa: E402
from repro_torch.models.recsys import api  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_params, jnp_batch, small_configs, to_numpy, to_torch_params, torch_batch,
)

VARIANTS = ("baseline", "quantized", "pruned", "pruned_quantized", "distilled")
SERVE_ATOL = {"baseline": 1e-5, "quantized": 1e-5, "pruned": 1e-4, "distilled": 1e-4,
              "pruned_quantized": 2e-2}
STEPS = dict(finetune_steps=2, qat_steps=2, distill_steps=2)


def _batches(jcfg):
    return list(taobao_batches(jcfg, 32, 4, seed=5))


@pytest.fixture(scope="module", params=[False, True], ids=["unstructured", "structured"])
def ladders(request, rec_rules):
    structured = request.param
    jcfg, tcfg = small_configs()
    teacher = jax_params(jcfg, seed=0)
    batches = _batches(jcfg)
    jl = jax_run_ladder(teacher, jcfg, rec_rules, lambda: (jnp_batch(b) for b in batches),
                        JaxLadderConfig(structured=structured, **STEPS))
    lc = LadderConfig(structured=structured, **STEPS)
    tl = run_ladder(to_torch_params(teacher), tcfg, lambda: (torch_batch(b) for b in batches), lc)
    request_batch = next(taobao_batches(jcfg, 64, 1, seed=9))
    return structured, lc, jl, tl, request_batch


def _jax_serve(variant, batch, rules):
    return np.asarray(jax_api.serve(variant["params"], jnp_batch(batch), variant["cfg"], rules))


def _serve(name, variant, batch, lc):
    return api.serve(serving_params(name, variant["params"], lc), torch_batch(batch),
                     variant["cfg"]).numpy()


def test_five_variants_with_repro_keys_and_equal_masks(ladders):
    _, _, jl, tl, _ = ladders
    assert tuple(tl) == tuple(jl) == VARIANTS
    n_masks = 0
    for name in VARIANTS:
        ref = dict(tree_leaves(to_numpy(jl[name]["params"])))
        out = dict(tree_leaves(tl[name]["params"]))
        assert ref.keys() == out.keys(), name
        for path in out:
            if path[-1] == "mask":
                np.testing.assert_array_equal(out[path].numpy(), ref[path], err_msg=str(path))
                n_masks += 1
    assert n_masks == 2 * 15  # pruned and pruned_quantized: every 2-D linear of taobao_ssa
    assert tl["distilled"]["cfg"].n_attn_layers == jl["distilled"]["cfg"].n_attn_layers


def test_variant_stats_equal_repro(ladders):
    structured, _, jl, tl, _ = ladders
    ref, out = jax_variant_stats(jl), variant_stats(tl)
    assert out == ref
    assert out["pruned"]["sparsity"] == pytest.approx(0.284 if structured else 0.4, abs=0.01)


@pytest.mark.parametrize("name", VARIANTS)
def test_each_variant_serves_as_in_repro(ladders, rec_rules, name):
    structured, lc, jl, tl, batch = ladders
    ref = _jax_serve(jl[name], batch, rec_rules)
    before = bpm_ops.launches
    out = _serve(name, tl[name], batch, lc)
    assert bpm_ops.launches == before  # on the CPU the plain version runs
    assert out.shape == (64,) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=SERVE_ATOL[name])


def test_pruned_quantized_weights_within_one_int8_step_of_repro(ladders):
    """|deq_port − deq_repro| ≤ |deq_port − w_port| + |w_port − w_repro| +
    |w_repro − deq_repro| ≤ one step (the larger scale) + the float
    weights' difference: 1e-4 but for a few elements, which AdamW may have
    moved the other way by up to 2·lr a step."""
    _, lc, jl, tl, _ = ladders
    adam_bound = 2 * lc.lr * (lc.prune_rounds * lc.finetune_steps + lc.qat_steps)
    ref = jl["pruned_quantized"]["params"]
    out = tl["pruned_quantized"]["params"]
    n_reps = 0

    def walk(r, o, path):
        nonlocal n_reps
        if "q" in o:
            jr = {k: torch.from_numpy(np.asarray(v)) for k, v in r.items()}
            d = (dequantize(o) - dequantize(jr)).abs()
            rows = o["q"].shape[0] == o["s"].shape[0]  # per-row (table) or per-column scale
            step = torch.maximum(o["s"], jr["s"])
            step = step[:, None] if rows else step[None, :]
            assert int((d > step + 1e-4).sum()) <= 1e-2 * d.numel(), path
            assert bool((d <= step + adam_bound).all()), path
            n_reps += 1
            return
        for k in o:
            if isinstance(o[k], dict):
                walk(r[k], o[k], path + (k,))

    walk(ref, out, ())
    assert n_reps == 3 + 15  # three tables and every linear


@pytest.fixture(scope="module")
def qat_stage(ladders, rec_rules):
    """The QAT stage alone in both packages, from `repro`'s pruned variant
    on the ladder's batches: its float weights, before `quantize_tree`."""
    structured, lc, jl, _, _ = ladders
    jcfg, tcfg = small_configs()
    batches = _batches(jcfg)
    start = jl["pruned"]["params"]
    jq = jax_finetune(start, jcfg, rec_rules, (jnp_batch(b) for b in batches), lc.qat_steps,
                      lc.lr, qat=True)
    tq = _finetune(to_torch_params(start), tcfg, (torch_batch(b) for b in batches),
                   lc.qat_steps, lc.lr, qat=True, structured=structured)
    return jq, tq


def test_qat_float_weights_and_serve_match_repro(ladders, qat_stage, rec_rules):
    """Where no int8 rounding enters, the QAT stage is held at the pruned
    variant's 1e-4, on every weight and on `serve` of the float tree
    (measured: at most 3.4e-6 and 3.4e-6, one torch thread or the pool)."""
    _, lc, jl, _, batch = ladders
    jq, tq = qat_stage
    ref = dict(tree_leaves(to_numpy(jq)))
    got = dict(tree_leaves(tq))
    assert got.keys() == ref.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.numpy(), ref[path], rtol=0, atol=1e-4, err_msg=str(path))
    cfg = jl["pruned"]["cfg"]
    out = _serve("pruned", {"params": tq, "cfg": cfg}, batch, lc)
    want = _jax_serve({"params": jq, "cfg": cfg}, batch, rec_rules)
    np.testing.assert_allclose(out, want, rtol=0, atol=SERVE_ATOL["pruned"])


@pytest.mark.parametrize("name", VARIANTS)
def test_repro_variants_load_into_the_port_and_serve_alike(ladders, rec_rules, name):
    _, lc, jl, _, batch = ladders
    carried = {"params": from_numpy_tree(to_numpy(jl[name]["params"]), "cpu"),
               "cfg": jl[name]["cfg"]}
    out = _serve(name, carried, batch, lc)
    np.testing.assert_allclose(out, _jax_serve(jl[name], batch, rec_rules), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", VARIANTS)
def test_port_variants_round_trip_and_serve_in_repro(ladders, rec_rules, name):
    _, lc, _, tl, batch = ladders
    served = serving_params(name, tl[name]["params"], lc)
    back = to_numpy_tree(without_block_masks(served))
    assert back.keys() == tl[name]["params"].keys()
    again = from_numpy_tree(back, "cpu")
    for (p1, a), (p2, b) in zip(tree_leaves(again), tree_leaves(tl[name]["params"])):
        assert p1 == p2 and torch.equal(a, b)
    jvariant = {"params": jax.tree.map(jnp.asarray, back), "cfg": tl[name]["cfg"]}
    np.testing.assert_allclose(_jax_serve(jvariant, batch, rec_rules),
                               _serve(name, tl[name], batch, lc), rtol=0, atol=1e-5)
