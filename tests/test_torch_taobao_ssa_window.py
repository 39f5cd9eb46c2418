"""The ported taobao_ssa ranker under the paper's C2 local-attention window
against `repro`'s, on the CPU at a small size (seq_len 20).

`repro` reads the window from an `attn_window` attribute of its config
(here a frozen subclass of its `RecSysConfig`); the port from
`configs/base.with_attn_window`. Same JAX-initialised parameters (through
numpy) and numpy batches, the histories cut so that rows with no valid key
occur (hist_len 0 and 1). Tolerance atol 1e-5: f32 on both sides, other
matmul backends and summation orders.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quantization import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.data.synthetic import taobao_batches  # noqa: E402
from repro.models.recsys import api as jax_api  # noqa: E402
from repro.models.recsys import taobao_ssa as jax_ssa  # noqa: E402
from repro_torch.core.distillation import make_student_cfg  # noqa: E402
from repro_torch.core.quantization import quantize_tree  # noqa: E402
from repro_torch.kernels.local_attention import ops as la_ops  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.recsys import api  # noqa: E402
from repro_torch.models.recsys import taobao_ssa  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_params, jnp_batch, small_configs, to_numpy, to_torch_params, torch_batch, windowed_pair,
)

ATOL = 1e-5
L = 20
WINDOWS = [1, 8, L]


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = small_configs(L)
    jp = jax_params(jcfg, seed=3)
    tp = to_torch_params(jp)
    variants = {
        "baseline": (jp, tp),
        "quantized": (jax_quantize_tree(jp), quantize_tree(tp)),
    }
    batch = next(taobao_batches(jcfg, 16, 1, seed=5))
    batch["hist_len"][:4] = [0, 1, 2, 3]  # rows past hist_len + window - 1 have no valid key
    return variants, batch


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=0, atol=atol)


def test_the_window_rides_on_the_config():
    jcfg, tcfg = windowed_pair(8, L)
    assert jax_ssa.cfg_window(jcfg) == 8 and taobao_ssa.cfg_window(tcfg) == 8
    assert taobao_ssa.cfg_window(small_configs(L)[1]) == 0
    student = make_student_cfg(tcfg)  # dataclasses.replace keeps a subclass's field
    assert student.attn_window == 8 and student.n_attn_layers == 1
    assert jax_ssa.cfg_window(dataclasses.replace(jcfg, n_attn_layers=1)) == 8


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_logits_and_attention_probs_match_jax(world, window, variant, rec_rules):
    variants, batch = world
    jcfg, tcfg = windowed_pair(window, L)
    jp, tp = variants[variant]
    ref_lg = jax_ssa.logits(jp, jnp_batch(batch), jcfg, rec_rules)
    lg = taobao_ssa.logits(tp, torch_batch(batch), tcfg)
    _close(ref_lg, lg)
    ref_lg, ref_attn = jax_ssa.logits_and_attn(jp, jnp_batch(batch), jcfg, rec_rules,
                                               collect_attn=True)
    lg_c, attn = taobao_ssa.logits_and_attn(tp, torch_batch(batch), tcfg, collect_attn=True)
    _close(ref_lg, lg_c)
    assert len(attn) == len(ref_attn) == tcfg.n_attn_layers
    for r, a in zip(ref_attn, attn):
        assert a.shape == (16, tcfg.n_heads, L, L)
        _close(r, a)
        # outside the window no mass, except on rows with no valid key (uniform there)
        pos = torch.arange(L)
        outside = (pos[:, None] - pos[None, :]).abs() >= window
        hist = torch.from_numpy(batch["hist_len"]).long()
        has_key = (pos[None, :] - window + 1).clamp(min=0) < hist[:, None]  # [B, L]
        leak = a * outside[None, None] * has_key[:, None, :, None]
        assert float(leak.max()) == 0.0


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_serve_and_retrieval_match_jax(world, window, variant, rec_rules):
    variants, batch = world
    jcfg, tcfg = windowed_pair(window, L)
    jp, tp = variants[variant]
    ref = jax_api.serve(jp, jnp_batch(batch), jcfg, rec_rules)
    before = la_ops.launches
    out = api.serve(tp, torch_batch(batch), tcfg)
    assert la_ops.launches == before  # CPU tensors take the plain version
    assert out.shape == (16,)
    _close(ref, out)
    rng = np.random.default_rng(window)
    query = {k: batch[k][:1] for k in ("user", "hist_item", "hist_category", "hist_len")}
    query["cand_category"] = rng.integers(0, 1000, 30).astype(np.int32)
    cand = rng.integers(0, 1000, 30).astype(np.int32)
    ref = jax_api.retrieval(jp, jnp_batch(query), jnp.asarray(cand), jcfg, rec_rules)
    out = api.retrieval(tp, torch_batch(query), torch.from_numpy(cand), tcfg)
    _close(ref, out)


@pytest.mark.parametrize("window", [L, L + 7])
@pytest.mark.parametrize("variant", ["baseline", "quantized"])
def test_a_window_of_at_least_L_is_full_attention(world, window, variant):
    variants, batch = world
    _, tp = variants[variant]
    _, tcfg = windowed_pair(window, L)
    full = taobao_ssa.logits(tp, torch_batch(batch), small_configs(L)[1])
    windowed = taobao_ssa.logits(tp, torch_batch(batch), tcfg)
    torch.testing.assert_close(windowed, full, rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [1, 8])
def test_loss_gradient_of_every_leaf_matches_jax_grad(world, window, rec_rules):
    """A windowed train step's gradients: through the local-attention op's
    backward (and embedding_bag's), against jax.grad of `repro`'s loss."""
    variants, batch = world
    jcfg, tcfg = windowed_pair(window, L)
    jp, _ = variants["baseline"]
    (ref, _), ref_g = jax.value_and_grad(
        lambda p: jax_api.loss(p, jnp_batch(batch), jcfg, rec_rules), has_aux=True)(jp)
    tp = to_torch_params(jp)
    paths, leaves = zip(*tree_leaves(tp))
    for leaf in leaves:
        leaf.requires_grad_(True)
    out, _ = api.loss(tp, torch_batch(batch), tcfg)
    grads = torch.autograd.grad(out, leaves)
    assert float(out.detach()) == pytest.approx(float(ref), abs=ATOL)
    ref_g = dict(tree_leaves(to_numpy(ref_g)))
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), ref_g[path], rtol=0, atol=ATOL, err_msg=str(path))
    assert float(grads[paths.index(("enc0", "wv"))].abs().max()) > 0
    # at window 1 each row attends to itself alone: q and k get no gradient, as in repro
    assert (float(grads[paths.index(("enc0", "wq"))].abs().max()) > 0) == (window > 1)
