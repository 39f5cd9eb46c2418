"""The port's optimizers and train step against `repro`'s, on the CPU.

- One `adamw` (with and without weight decay) and one `sgd` update from
  the same gradients, parameters and state: every leaf within 1e-7
  absolute (the same f32 arithmetic; `b**c` may round differently in
  XLA's and ATen's `pow`).
- Three `make_train_step` steps of SGD with momentum on taobao_ssa from
  `repro`'s parameters and the same numpy batches: a default case, one that
  hits the clip (gnorm > 1), one with `grad_accum=2` and one on a masked
  tree, every leaf (masks included) within 2e-6. SGD's update is linear
  in the gradient, so this holds the gradients, the clip and the
  microbatching themselves: their f32 rounding, scaled by lr 0.1 and
  three steps, is what the tolerance allows.
- Three AdamW steps: Adam's step g/(√v̂ + 1e-8) turns the last-bit
  difference of a gradient that cancels to ~1e-8 into a difference of up
  to 2·lr in that element, so a few elements may move by up to 2·lr a step
  while the rest agree within 1e-5. Measured on this case: the loss within
  4e-6 relative, most elements within 1e-5, at most 0.5% beyond it, the
  largest difference 1.4e-3 (3 steps at lr 1e-3).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import pruning as jax_pruning  # noqa: E402
from repro.data.synthetic import taobao_batches  # noqa: E402
from repro.models.recsys import api as jax_api  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.train_loop import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.models.common import from_numpy_tree, tree_leaves  # noqa: E402
from repro_torch.models.recsys import api  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training.train_loop import fit, make_train_step  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_params, jnp_batch, small_configs, to_numpy, to_torch_params, torch_batch,
)

UPDATE_ATOL = 1e-7
SGD_ATOL = 2e-6
ADAM_ATOL, ADAM_FLIP_SHARE = 1e-5, 0.005


def _leaves(tree):
    return dict(tree_leaves(tree))


def _random_tree(rng):
    return {
        "a": rng.normal(size=(8, 5)).astype(np.float32),
        "b": {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "mask": (rng.random((5, 3)) > 0.5).astype(np.float32)},
        "c": rng.normal(size=(7,)).astype(np.float32),
    }


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adamw", {"weight_decay": 0.1}),
                                     ("sgd", {}), ("sgd", {"momentum": 0.0})])
def test_one_update_matches_repro(name, kw):
    rng = np.random.default_rng(0)
    params, grads = _random_tree(rng), _random_tree(rng)
    jo = jax_opt.get_optimizer(name, 1e-2, **kw)
    to = optimizer.get_optimizer(name, 1e-2, **kw)
    jp, jg = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads)
    tp, tg = from_numpy_tree(params, "cpu"), from_numpy_tree(grads, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(2):  # the second update reads the first one's state
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
    ref, out = _leaves(to_numpy(ju)), _leaves(tu)
    assert ref.keys() == out.keys()
    for path, u in out.items():
        np.testing.assert_allclose(u.numpy(), ref[path], rtol=0, atol=UPDATE_ATOL, err_msg=str(path))
    for path, m in _leaves(ts).items():
        np.testing.assert_allclose(m.numpy(), _leaves(to_numpy(js))[path], rtol=0,
                                   atol=UPDATE_ATOL, err_msg=str(path))


def test_adam8bit_is_not_ported():
    with pytest.raises(NotImplementedError, match="adam8bit"):
        optimizer.get_optimizer("adam8bit")


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = small_configs()
    jp = jax_params(jcfg, seed=0)
    batches = list(taobao_batches(jcfg, 32, 3, seed=5))
    return jcfg, tcfg, jp, batches


def _run_both(world, rec_rules, opt, *, scale=1.0, grad_accum=1, masked=False):
    jcfg, tcfg, jp, batches = world
    if masked:
        jp = jax_pruning.prune_tree(jp, 0.3)
    tp = to_torch_params(jp)
    jo, to = getattr(jax_opt, opt[0])(*opt[1:]), getattr(optimizer, opt[0])(*opt[1:])

    def jloss(p, b):
        loss, m = jax_api.loss(p, b, jcfg, rec_rules)
        return loss * scale, m

    def tloss(p, b):
        loss, m = api.loss(p, b, tcfg)
        return loss * scale, m

    jstep = jax.jit(jax_make_train_step(jloss, jo, grad_accum=grad_accum))
    tstep = make_train_step(tloss, to, grad_accum=grad_accum)
    js, ts = jo.init(jp), to.init(tp)
    metrics = []
    for b in batches:
        jp, js, jm = jstep(jp, js, jnp_batch(b))
        tp, ts, tm = tstep(tp, ts, torch_batch(b))
        metrics.append((float(jm["grad_norm"]), float(tm["grad_norm"]),
                        float(jm["loss"]), float(tm["loss"])))
    return _leaves(to_numpy(jp)), _leaves(tp), metrics


@pytest.mark.parametrize("case", ["default", "clipped", "grad_accum_2", "masked"])
def test_three_sgd_steps_match_repro(world, rec_rules, case):
    kw = {"clipped": {"scale": 10.0}, "grad_accum_2": {"grad_accum": 2},
          "masked": {"masked": True}}.get(case, {})
    ref, out, metrics = _run_both(world, rec_rules, ("sgd", 0.1), **kw)
    assert ref.keys() == out.keys()
    if case == "masked":
        assert any(p[-1] == "mask" for p in out)
    if case == "clipped":
        assert all(m[0] > 1.0 for m in metrics)  # the clip scales every step
    for jn, tn, jl, tl in metrics:
        assert tn == pytest.approx(jn, rel=1e-5) and tl == pytest.approx(jl, rel=1e-5)
    for path, t in out.items():
        np.testing.assert_allclose(t.numpy(), ref[path], rtol=0, atol=SGD_ATOL, err_msg=str(path))


def test_three_adamw_steps_match_repro(world, rec_rules):
    ref, out, metrics = _run_both(world, rec_rules, ("adamw", 1e-3))
    for jn, tn, jl, tl in metrics:
        assert tl == pytest.approx(jl, rel=1e-5) and tn == pytest.approx(jn, rel=1e-3)
    n = n_far = 0
    for path, t in out.items():
        d = np.abs(t.numpy() - ref[path])
        assert d.max() <= 2 * 1e-3 * len(metrics), path  # at most 2·lr a step
        n, n_far = n + d.size, n_far + int((d > ADAM_ATOL).sum())
    assert n_far <= ADAM_FLIP_SHARE * n


def test_fit_logs_and_calls_back(world):
    _, tcfg, jp, batches = world
    opt = optimizer.adamw(1e-3)
    step = make_train_step(lambda p, b: api.loss(p, b, tcfg), opt)
    params = to_torch_params(jp)
    seen = []
    params, state, hist = fit(step, params, opt.init(params), (torch_batch(b) for b in batches),
                              callback=lambda i, m: seen.append(i))
    assert seen == [0, 1, 2] and [h["step"] for h in hist] == [0, 1, 2]
    assert int(state["count"]) == 3 and all(np.isfinite(h["loss"]) for h in hist)


def test_train_step_leaves_its_inputs_and_integer_leaves_alone(world):
    _, tcfg, jp, batches = world
    from repro_torch.core.pruning import prune_tree, with_block_masks

    params = with_block_masks(prune_tree(to_torch_params(jp), 0.3, structured=True))
    before = {p: t.clone() for p, t in tree_leaves(params)}
    opt = optimizer.adamw(1e-3)
    new, _, m = make_train_step(lambda p, b: api.loss(p, b, tcfg), opt)(
        params, opt.init(params), torch_batch(batches[0]))
    for path, t in tree_leaves(params):
        assert torch.equal(t, before[path]), path  # functional: nothing written in place
    new = dict(tree_leaves(new))
    assert torch.equal(new[("enc0", "w1", "block_mask")], before[("enc0", "w1", "block_mask")])
    assert not torch.equal(new[("enc0", "w1", "mask")], before[("enc0", "w1", "mask")])
    assert float(m["grad_norm"]) > 0
