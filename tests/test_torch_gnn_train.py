"""NequIP's losses, gradients and training steps in the port against
`repro`'s on the CPU, on `tests/test_torch_gnn.py`'s small inputs (2
layers of 8 channels, `random_graph`s of 40 nodes, `molecule_batch`es of
4 molecules, `repro`'s parameters carried into the port). Tolerances,
each measured on these inputs:

- Both losses, with and without their masks: within `LOSS_REL` (measured
  up to 1.2e-7).
- Every leaf's gradient against `jax.grad`: within `GRAD_REL` of the
  leaf's largest |g| (measured up to 9.3e-7); a leaf the model's algebra
  gives no gradient at 2 layers (`self_1`, `self_2`: zero l≥1 features
  enter the first layer, and the last layer's l≥1 outputs reach no
  output) is zero in both.
- Three AdamW steps of `make_train_step` against `repro`'s jitted one:
  losses within `LOSS_REL`, every weight under `tests/test_torch_optimizer.py`'s
  AdamW rule (`ADAM_ATOL`, `ADAM_FLIP_SHARE`, at most 2·lr a step).
- remat on and off: the same bits, forward and gradients.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)
from repro.models.gnn import nequip as jnequip  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.train_loop import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.models.common import tree_from_leaves, tree_leaves  # noqa: E402
from repro_torch.models.gnn import nequip  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402
from test_torch_gnn import _cfgs, _graph, _jb, _losses, _params, _rel, _tb  # noqa: E402
from test_torch_optimizer import ADAM_ATOL, ADAM_FLIP_SHARE  # noqa: E402

LOSS_REL = 1e-5
GRAD_REL = 1e-5


LOSS_KINDS = ["species", "features+mask", "molecule", "molecule+mask"]


@pytest.mark.parametrize("kind", LOSS_KINDS)
def test_losses_and_every_gradient_match_repro(kind, gnn_rules):
    """`node_class_loss` (mean, and over `label_mask` divided by its count)
    and `energy_loss` (with `node_mask` applied before the segment sum),
    and the gradient of each leaf against `jax.grad`."""
    jcfg, tcfg = _cfgs(remat=False)  # remat is held to no remat below; it slows XLA's build
    jp, tp = _params(jcfg, kind)
    g = _graph(kind)
    jloss, tloss = _losses(kind)
    (ref, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, b, jcfg, gnn_rules), has_aux=True))(jp, _jb(g))
    paths, leaves = zip(*[(p, t.requires_grad_(True)) for p, t in tree_leaves(tp)])
    loss, metrics = tloss(dict(tp), _tb(g), tcfg)
    assert set(metrics) == ({"mse"} if kind.startswith("molecule") else {"nll"})
    assert float(loss.detach()) == pytest.approx(float(ref), rel=LOSS_REL)
    grads = torch.autograd.grad(loss, leaves)
    jleaves = dict(tree_leaves(jax.tree.map(np.asarray, jgrads)))
    for path, grad in zip(paths, grads):
        assert _rel(jleaves[path], grad.numpy()) <= GRAD_REL, path  # 0 where repro's is 0


def test_a_label_mask_divides_by_its_count_and_an_empty_one_by_one():
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0], "species")
    g = _tb(_graph("species"))
    with torch.no_grad():
        out = nequip.forward(tp, g, tcfg)
        nll = -torch.log_softmax(out, -1).gather(-1, g["labels"].long()[:, None])[:, 0]
        mask = torch.arange(40) % 3 == 0
        loss, _ = nequip.node_class_loss(tp, {**g, "label_mask": mask}, tcfg)
        assert float(loss) == pytest.approx(float(nll[mask].sum() / mask.sum()), rel=1e-6)
        none, _ = nequip.node_class_loss(tp, {**g, "label_mask": torch.zeros(40, dtype=bool)},
                                         tcfg)
        assert float(none) == 0.0


def test_three_adamw_steps_match_repros_train_step(gnn_rules):
    jcfg, tcfg = _cfgs(remat=False)
    jp, tp = _params(jcfg, "species")
    graphs = [_graph("species", seed=s) for s in range(3)]
    jo, to = jax_opt.adamw(1e-3), optimizer.adamw(1e-3)
    jstep = jax.jit(jax_make_train_step(
        lambda p, b: jnequip.node_class_loss(p, b, jcfg, gnn_rules), jo))
    tstep = make_train_step(lambda p, b: nequip.node_class_loss(p, b, tcfg), to)
    js, ts = jo.init(jp), to.init(tp)
    for g in graphs:
        jp, js, jm = jstep(jp, js, _jb(g))
        tp, ts, tm = tstep(tp, ts, _tb(g))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_REL)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    ref = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    n = n_far = 0
    for path, t in tree_leaves(tp):
        d = np.abs(t.numpy() - ref[path])
        assert d.max() <= 2 * 1e-3 * len(graphs), path  # at most 2·lr a step
        n, n_far = n + d.size, n_far + int((d > ADAM_ATOL).sum())
    assert n_far <= ADAM_FLIP_SHARE * n


@pytest.mark.parametrize("hoist", [False, True])
def test_remat_on_and_off_give_the_same_bits(hoist):
    jcfg, _ = _cfgs()
    _, tp = _params(jcfg, "features+mask")
    g = _tb(_graph("features+mask"))
    res = []
    for remat in (True, False):
        tcfg = _cfgs(remat=remat, hoist_gathers=hoist)[1]
        paths, leaves = zip(*[(p, t.detach().clone().requires_grad_(True))
                              for p, t in tree_leaves(tp)])
        params = tree_from_leaves(zip(paths, leaves))
        loss, _ = nequip.node_class_loss(params, g, tcfg)
        res.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l_on, g_on), (l_off, g_off) = res
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))
