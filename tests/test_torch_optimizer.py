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
- adam8bit: the block-wise int8 moments to the bit (codes, scales, the
  dequantized values) and five updates from the same gradients, as each
  test states.
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


_BLOCK_SHAPES = [(700,), (5, 700), (3, 4, 256), (2, 1), (1, 256), (4, 257), (64, 16)]


@pytest.mark.parametrize("shape", _BLOCK_SHAPES, ids=str)
def test_blockwise_round_trip_matches_repro_bit_for_bit(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * rng.uniform(0, 10, size=shape[:-1] + (1,))).astype(np.float32)
    x.reshape(-1)[:3] = 0.0  # a block's zeros; an all-zero block below
    if shape[-1] >= 256:
        x[..., :256] = 0.0
    qj, sj = jax_opt._quantize_blockwise(jnp.asarray(x))
    qt, st = optimizer._quantize_blockwise(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and tuple(qt.shape) == shape
    assert tuple(st.shape) == optimizer._n_blocks(shape) == jax_opt._n_blocks(shape)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(optimizer._dequantize_blockwise(qt, st).numpy(),
                                  np.asarray(jax_opt._dequantize_blockwise(qj, sj)))


def test_rounding_half_to_even_as_jnp_round():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 127.0], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


def _adam8bit_run(params, grads_of, steps, jit):
    """`steps` adam8bit updates in both packages from the same parameters
    and the same gradients each step (`grads_of(i, params)`, numpy): the
    parameters move by `repro`'s updates, both optimizers keep their own
    state. Yields (repro update, state; port update, state) each step."""
    jo, to = jax_opt.adam8bit(1e-3), optimizer.adam8bit(1e-3)
    jupdate = jax.jit(jo.update) if jit else jo.update
    jp = jax.tree.map(jnp.asarray, params)
    js, ts = jo.init(jp), to.init(from_numpy_tree(params, "cpu"))
    for i in range(steps):
        g = grads_of(i, jp)
        ju, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(from_numpy_tree(g, "cpu"), ts, from_numpy_tree(to_numpy(jp), "cpu"))
        yield to_numpy(ju), to_numpy(js), tu, ts
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)


def _state_diffs(js, ts):
    """Per leaf of the state: (codes off, their largest step) for int8
    leaves, the largest relative difference for the scales."""
    ref, out = _leaves(js), _leaves(ts)
    assert ref.keys() == out.keys()
    diffs = {}
    for path, t in out.items():
        a, b = ref[path], t.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == np.int8:
            d = np.abs(a.astype(np.int64) - b)
            diffs[path] = (float((d > 0).mean()), int(d.max()))
        else:
            diffs[path] = float((np.abs(a.astype(np.float64) - b)
                                 / np.maximum(np.abs(a), 1e-30)).max())
    return diffs


def test_five_adam8bit_steps_on_a_small_tree_match_repro():
    """Leaves of rank 1 and 2 agree to the bit with `repro`'s update run op
    by op. `repro` maps a rank-3 leaf over its first axis (`lax.map`, one
    compiled loop) where XLA may fuse f32 operations, so that leaf's codes
    may move by one step in at most 0.1% of its elements (measured: 0) and
    its scales by 1e-5 relative (measured: within 2.3e-7)."""
    rng = np.random.default_rng(0)
    tree = lambda: {"a": rng.normal(size=(8, 300)).astype(np.float32),  # noqa: E731
                    "b": {"w": rng.normal(size=(3, 4, 300)).astype(np.float32)},
                    "c": rng.normal(size=(7,)).astype(np.float32)}
    params, grads = tree(), [tree() for _ in range(5)]
    for ju, js, tu, ts in _adam8bit_run(params, lambda i, p: grads[i], 5, jit=False):
        for path, d in _state_diffs(js, ts).items():
            if path[1:3] == ("b", "w"):  # m/b/w/q, m/b/w/s, v/...
                ok = d[0] <= 1e-3 and d[1] <= 1 if isinstance(d, tuple) else d <= 1e-5
            else:
                ok = d == ((0.0, 0) if isinstance(d, tuple) else 0.0)
            assert ok, (path, d)
        for path, u in _leaves(tu).items():
            np.testing.assert_allclose(u.numpy(), _leaves(ju)[path], rtol=0,
                                       atol=0 if path != ("b", "w") else UPDATE_ATOL,
                                       err_msg=str(path))


@pytest.mark.parametrize("jit", [False, True], ids=["op_by_op", "jit"])
def test_five_adam8bit_steps_on_taobao_ssa_match_repro(world, rec_rules, jit):
    """Five updates from `repro`'s gradients of taobao_ssa's loss on five
    batches, fed to both optimizers. Op by op, `repro`'s update gives the
    port's codes, scales and updates to the bit (every leaf has rank 1 or
    2). Jitted, XLA fuses f32 operations: codes within one step in at most
    0.1% of a leaf (measured: one code of 611,074, 2.4e-5 of its leaf),
    scales within 1e-4 relative (measured 9.3e-6), updates within 5e-5
    (measured 1.3e-5; lr 1e-3)."""
    jcfg, _, jp, _ = world
    batches = list(taobao_batches(jcfg, 32, 5, seed=5))
    grad = jax.jit(jax.grad(lambda p, b: jax_api.loss(p, b, jcfg, rec_rules)[0]))
    grads_of = lambda i, p: to_numpy(grad(p, jnp_batch(batches[i])))  # noqa: E731
    for ju, js, tu, ts in _adam8bit_run(to_numpy(jp), grads_of, 5, jit=jit):
        for path, d in _state_diffs(js, ts).items():
            if isinstance(d, tuple):
                assert d == (0.0, 0) if not jit else (d[0] <= 1e-3 and d[1] <= 1), (path, d)
            else:
                assert d == 0.0 if not jit else d <= 1e-4, (path, d)
        for path, u in _leaves(tu).items():
            np.testing.assert_allclose(u.numpy(), _leaves(ju)[path], rtol=0,
                                       atol=5e-5 if jit else 0, err_msg=str(path))


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
