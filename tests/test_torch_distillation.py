"""The port's distillation (C3 + C1 student) against `repro`'s, on the CPU.

The student is built from the same `repro` teacher in both packages.
Singular vectors are fixed only up to sign, so the low-rank factors are
compared as products a @ b (within 1e-5: the rank-16 truncation of an
f32 SVD of a 64 x 64 matrix in two LAPACK builds, measured at 1.9e-6);
everything else is taken from the teacher as it is and
must be equal. Losses and gradients within 1e-5 (f32 forward and backward
over the encoder in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import distillation as jax_distill  # noqa: E402
from repro.data.synthetic import taobao_batches  # noqa: E402
from repro_torch.core import distillation  # noqa: E402
from repro_torch.models.common import from_numpy_tree, tree_leaves  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_params, jnp_batch, small_configs, to_numpy, to_torch_params, torch_batch,
)

ATOL = 1e-5


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = small_configs()
    teacher = jax_params(jcfg, seed=1)
    js_cfg, ts_cfg = jax_distill.make_student_cfg(jcfg), distillation.make_student_cfg(tcfg)
    jstudent = jax_distill.init_student_from_teacher(teacher, js_cfg, jax.random.key(0))
    tstudent = distillation.init_student_from_teacher(to_torch_params(teacher), ts_cfg)
    batch = next(taobao_batches(jcfg, 16, 1, seed=7))
    return jcfg, tcfg, js_cfg, ts_cfg, teacher, jstudent, tstudent, batch


def test_student_config_halves_the_encoder(world):
    _, tcfg, js_cfg, ts_cfg, *_ = world
    assert ts_cfg.n_attn_layers == js_cfg.n_attn_layers == 1 and tcfg.n_attn_layers == 2


def test_student_matches_repro(world):
    *_, jstudent, tstudent, _ = world
    ref, out = dict(tree_leaves(to_numpy(jstudent))), dict(tree_leaves(tstudent))
    assert ref.keys() == out.keys()
    for path, t in out.items():
        if path[-1] in ("a", "b"):
            continue
        np.testing.assert_array_equal(t.numpy(), ref[path], err_msg=str(path))
    for proj in ("wq", "wk", "wv", "wo"):
        j, t = jstudent["enc0"][proj], tstudent["enc0"][proj]
        assert t["a"].shape == j["a"].shape == (64, 16) and t["b"].shape == (16, 64)
        np.testing.assert_allclose((t["a"] @ t["b"]).numpy(), np.asarray(j["a"] @ j["b"]),
                                   rtol=0, atol=ATOL, err_msg=proj)
    assert tstudent["enc0"]["w1"]["gw"].shape == (4, 16, 64)


def test_attention_kl_and_its_gradient_match_repro():
    rng = np.random.default_rng(0)
    t = rng.random((2, 4, 5, 5)).astype(np.float32)
    s = rng.random((2, 2, 5, 5)).astype(np.float32)  # head counts may differ
    t /= t.sum(-1, keepdims=True)
    s /= s.sum(-1, keepdims=True)
    ref, ref_g = jax.value_and_grad(jax_distill.attention_kl, argnums=1)(jnp.asarray(t),
                                                                         jnp.asarray(s))
    ts = torch.from_numpy(s).requires_grad_(True)
    out = distillation.attention_kl(torch.from_numpy(t), ts)
    out.backward()
    assert float(out.detach()) == pytest.approx(float(ref), abs=1e-7)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(ref_g), rtol=0, atol=1e-7)


def test_distill_loss_and_its_gradient_match_repro(world, rec_rules):
    jcfg, tcfg, js_cfg, ts_cfg, teacher, jstudent, _, batch = world
    (ref, ref_m), ref_g = jax.value_and_grad(
        lambda p: jax_distill.distill_loss(p, teacher, jnp_batch(batch), js_cfg, jcfg, rec_rules),
        has_aux=True)(jstudent)
    # the same student on both sides (the repro one, carried across)
    tstudent = from_numpy_tree(to_numpy(jstudent), "cpu")
    paths, leaves = zip(*tree_leaves(tstudent))
    for leaf in leaves:
        leaf.requires_grad_(True)
    tteacher = to_torch_params(teacher)
    out, m = distillation.distill_loss(tstudent, tteacher, torch_batch(batch), ts_cfg, tcfg)
    grads = torch.autograd.grad(out, leaves)
    assert float(out.detach()) == pytest.approx(float(ref), abs=ATOL)
    for k in ("task", "attn_kl", "soft"):
        assert float(m[k].detach()) == pytest.approx(float(ref_m[k]), abs=ATOL), k
    assert float(m["attn_kl"].detach()) > 0
    ref_g = dict(tree_leaves(to_numpy(ref_g)))
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), ref_g[path], rtol=0, atol=ATOL, err_msg=str(path))
    # the teacher gets no gradient (repro's stop_gradient)
    assert all(not t.requires_grad for _, t in tree_leaves(tteacher))
