"""The port's training launcher, and FM and DIEN training through their
kernels' autograd Functions, against `repro`, on the CPU.

- `main` trains each ported arch (taobao_ssa, fm, dien, din, autoint) at
  the launcher's config (vocabularies cut to 5,000, widths as configured),
  and each LM arch (yi_6b, chatglm3_6b, command_r_35b, olmoe_1b_7b,
  llama4_maverick_400b_a17b) at `repro`'s (2 layers, d 128, vocab 512, at
  most 8 experts top-2, bf16), and the GNN arch (nequip) as configured, and
  prints the keys `repro`'s launcher prints, and `resumed_from`. NequIP's
  config, parameter layout and graphs are `repro`'s launcher's.
- An LM run's losses equal those of `repro`'s `make_train_step` loop from
  the port's initial parameters carried into JAX (bf16 bits), on the same
  batches: within `LM_LOSS_REL` of each loss (see there). So do NequIP's,
  within `GNN_LOSS_REL`, at 2 layers of 8 channels in both packages (the
  full config takes ~3 s a step on one CPU thread here: `chip_smoke.py`
  phase 13 trains it as configured on the card).
- A deviation from `repro`: a rerun over a finished checkpoint reports the
  restored step and a rate of the steps it trained (none); `repro`'s
  reports one step more and divides the restored steps by its seconds.
- A crash and a resume end in the bits of an uninterrupted run: the
  resumed run trains on the uninterrupted stream's batches. `repro`'s
  launcher draws fresh ones from seed `start` after a restore, which this
  file pins as the reason for the port's `resumable`. Each package's
  launcher resumes the other's checkpoint.
- Three `make_train_step` steps of FM and of DIEN from `repro`'s parameters
  and the same numpy batches, through `tests/test_torch_optimizer.py`'s
  `_run_both`: SGD within its `SGD_ATOL`, AdamW under its `ADAM_ATOL` /
  `ADAM_FLIP_SHARE` rule (the reasons are that file's).
- The CPU backward of each new autograd Function, which is the backward
  the card runs, against `jax.grad` of `repro`'s function: within 1e-5
  absolute (f32 sums in another order; the AUGRU's gradients pass through
  100 steps of tanh and sigmoid, whose derivatives are at most 1).
"""
import json
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import criteo_batches, taobao_batches  # noqa: E402
from repro.kernels.augru.ref import augru_ref as jax_augru_ref  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models.recsys.fm import fm_interaction as jax_fm_interaction  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.augru import ops as augru_ops  # noqa: E402
from repro_torch.kernels.fm_interaction import ops as fm_ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from test_torch_optimizer import ADAM_ATOL, ADAM_FLIP_SHARE, SGD_ATOL, _run_both  # noqa: E402
from torch_parity import jax_params, reduced_pair  # noqa: E402

KEYS = {"arch", "steps", "restarts", "wall_s", "steps_per_s"}
GRAD_ATOL = 1e-5
# bf16 LM training against `repro`'s, relative to each loss: measured up to
# 5.7e-5 for the dense archs and 5.6e-4 for the MoE ones on these three
# steps (XLA rounds its fused bf16 intermediates elsewhere,
# `tests/test_torch_transformer.py`, and AdamW's first steps move every
# weight by about lr whatever the gradient's size)
LM_LOSS_REL = 2e-3
LM_ARCHS = ["yi_6b", "chatglm3_6b", "command_r_35b", "olmoe_1b_7b", "llama4_maverick_400b_a17b"]
# f32 NequIP against `repro`, relative to each loss: measured up to 6.1e-8
# over three AdamW steps (f32 sums in another order)
GNN_LOSS_REL = 1e-5
SMALL_GNN = dict(n_layers=2, d_hidden=8)


def _json_line(text):
    return json.loads(text.strip().splitlines()[-1])


def test_repros_launcher_prints_these_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "fm", "--steps", "1", "--batch", "8",
                                      "--ckpt-dir", str(tmp_path)])
    jax_train.main()
    assert set(_json_line(capsys.readouterr().out)) == KEYS


@pytest.mark.parametrize("arch", ["taobao_ssa", "fm", "dien", "din", "autoint"] + LM_ARCHS
                         + ["nequip"])
def test_main_trains_each_arch_on_the_cpu_and_prints_repros_keys(arch, tmp_path, capsys):
    batch = "4" if arch in LM_ARCHS else "8"
    train.main(["--arch", arch, "--device", "cpu", "--steps", "3", "--batch", batch,
                "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    rec = _json_line(capsys.readouterr().out)
    assert set(rec) == KEYS | {"resumed_from"} and rec["arch"] == arch and rec["steps"] == 3
    assert rec["restarts"] == rec["resumed_from"] == 0 and checkpoint.latest_step(tmp_path) == 2


@pytest.mark.parametrize("arch", ["nequip"])
def test_lm_and_gnn_archs_are_refused(arch, tmp_path):
    """No arch is refused any more: the GNN arch, the last, resolves to
    `repro`'s config, which the launcher keeps as it is, with `repro`'s
    launcher's parameter layout (7 classes) and graphs (one `random_graph`
    of 512 nodes a step, seeded by the step)."""
    import dataclasses

    from repro.models.common import ParamDef as JaxParamDef
    from repro_torch.models.common import tree_leaves

    cfg = train.reduced_config(get_config(arch))
    jcfg = jax_train.reduced_config(jax_train.get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and cfg.family == "gnn"
    ref = jax.tree.map(lambda d: d.shape, jax_train.param_defs_for(jcfg),
                       is_leaf=lambda x: isinstance(x, JaxParamDef))
    assert [(p, d.shape) for p, d in tree_leaves(train.param_defs_for(cfg))] == \
        list(tree_leaves(ref))
    for _, a, b in zip(range(3), jax_train.make_data(jcfg, 8)(2),
                       train.resumable(train.make_data(cfg, 8, "cpu"))(2)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy(), err_msg=k)


def _small_nequip(monkeypatch):
    """The launcher's NequIP at 2 layers of 8 channels in both packages."""
    import dataclasses

    small = dataclasses.replace(get_config("nequip"), **SMALL_GNN)
    monkeypatch.setattr(train, "get_config", lambda name: small)
    return small, dataclasses.replace(jax_train.get_config("nequip"), **SMALL_GNN)


def test_nequip_losses_match_repros_train_step_loop(tmp_path, monkeypatch, gnn_rules):
    """Three AdamW steps through the launcher, and `repro`'s jitted
    `make_train_step` from the same initial parameters (the port's, seed 0)
    on `repro`'s launcher's graphs."""
    from repro.training.optimizer import get_optimizer as jax_get_optimizer
    from repro.training.train_loop import make_train_step as jax_make_train_step
    from repro_torch.models.common import init_params, to_numpy_tree

    cfg, jcfg = _small_nequip(monkeypatch)
    rec = train.run("nequip", steps=3, ckpt_dir=str(tmp_path), device="cpu")
    start = init_params(train.param_defs_for(cfg), torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree.map(jnp.asarray, to_numpy_tree(start))
    opt = jax_get_optimizer("adamw", 1e-3)
    step = jax.jit(jax_make_train_step(jax_train.make_loss(jcfg, gnn_rules), opt))
    state, ref = opt.init(jparams), []
    for _, batch in zip(range(3), jax_train.make_data(jcfg, 8)(0)):
        jparams, state, metrics = step(jparams, state, batch)
        ref.append(float(metrics["loss"]))
    assert rec["losses"] == pytest.approx(ref, rel=GNN_LOSS_REL)


def test_a_crashed_and_resumed_nequip_run_ends_in_the_bits_of_an_uninterrupted_one(
        tmp_path, monkeypatch):
    _small_nequip(monkeypatch)
    kw = dict(steps=6, ckpt_every=2, device="cpu")
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        train.run("nequip", ckpt_dir=str(tmp_path / "a"), crash_at=5, **kw)
    resumed = train.run("nequip", ckpt_dir=str(tmp_path / "a"), **kw)
    whole = train.run("nequip", ckpt_dir=str(tmp_path / "b"), **kw)
    assert (resumed["restarts"], resumed["resumed_from"], resumed["steps"]) == (1, 4, 6)
    assert resumed["losses"] == whole["losses"][4:] and all(np.isfinite(whole["losses"]))
    a, _ = checkpoint.flatten((resumed["params"], resumed["opt_state"]))
    b, _ = checkpoint.flatten((whole["params"], whole["opt_state"]))
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_losses_match_repros_train_step_loop(arch, tmp_path, lm_rules):
    """Three AdamW steps at batch 4 × 128 tokens through the launcher, and
    `repro`'s jitted `make_train_step` from the same initial parameters
    (the port's, seed 0, carried into JAX with their bf16 bits) on
    `repro`'s `make_data` batches."""
    import ml_dtypes

    from repro.training.optimizer import get_optimizer as jax_get_optimizer
    from repro.training.train_loop import make_train_step as jax_make_train_step
    from repro_torch.models.common import init_params, to_numpy_tree

    rec = train.run(arch, steps=3, batch=4, ckpt_dir=str(tmp_path), device="cpu")
    cfg = train.reduced_config(get_config(arch))
    start = init_params(train.param_defs_for(cfg), torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree.map(lambda a: jnp.asarray(a.view(ml_dtypes.bfloat16)),
                           to_numpy_tree(start))
    jcfg = jax_train.reduced_config(jax_train.get_config(arch))
    opt = jax_get_optimizer("adamw", 1e-3)
    step = jax.jit(jax_make_train_step(jax_train.make_loss(jcfg, lm_rules), opt))
    state, ref = opt.init(jparams), []
    for _, batch in zip(range(3), jax_train.make_data(jcfg, 4)(0)):
        jparams, state, metrics = step(jparams, state, batch)
        ref.append(float(metrics["loss"]))
    assert rec["losses"] == pytest.approx(ref, rel=LM_LOSS_REL)


def test_unported_recsys_archs_and_cuda_without_a_card_are_refused(tmp_path):
    """Every recsys arch of `repro` is ported now: an arch `repro` does not
    know is refused, as `repro`'s `get_config` refuses it."""
    with pytest.raises(KeyError, match="unknown arch"):
        train.run("dcn", steps=1, ckpt_dir=str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.run("fm", steps=1, ckpt_dir=str(tmp_path))  # the default device


@pytest.mark.parametrize("arch", ["taobao_ssa", "fm", "dien", "din", "autoint"] + LM_ARCHS)
def test_a_crashed_and_resumed_run_ends_in_the_bits_of_an_uninterrupted_one(arch, tmp_path):
    kw = dict(steps=6, batch=8, ckpt_every=2, device="cpu")
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        train.run(arch, ckpt_dir=str(tmp_path / "a"), crash_at=5, **kw)
    resumed = train.run(arch, ckpt_dir=str(tmp_path / "a"), **kw)
    whole = train.run(arch, ckpt_dir=str(tmp_path / "b"), **kw)
    assert (resumed["restarts"], whole["restarts"], resumed["steps"]) == (1, 0, 6)
    assert (resumed["resumed_from"], whole["resumed_from"]) == (4, 0)
    assert len(resumed["losses"]) == 2 and len(whole["losses"]) == 6
    assert resumed["losses"] == whole["losses"][4:] and all(np.isfinite(whole["losses"]))
    a, _ = checkpoint.flatten((resumed["params"], resumed["opt_state"]))
    b, _ = checkpoint.flatten((whole["params"], whole["opt_state"]))
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_resumed_run_replays_the_uninterrupted_stream_where_repros_draws_anew():
    cfg = train.reduced_config(get_config("fm"))
    data = train.make_data(cfg, 8, "cpu")
    twenty_first = next(train.resumable(data)(20))
    uninterrupted = [b for _, b in zip(range(21), data(0))][20]
    assert all(torch.equal(twenty_first[k], uninterrupted[k]) for k in uninterrupted)
    # repro's launcher hands make_data(cfg, batch) to ResilientTrainer: its
    # resumed stream starts at seed 20, not at the uninterrupted batch 20
    jcfg = jax_train.reduced_config(jax_train.get_config("fm"))
    fresh = next(jax_train.make_data(jcfg, 8)(20))
    assert not np.array_equal(np.asarray(fresh["sparse_idx"]),
                              uninterrupted["sparse_idx"].numpy())


def test_adam8bit_trains_taobao_ssa_and_refuses_fms_0d_bias_as_repro(tmp_path):
    rec = train.run("taobao_ssa", steps=2, batch=8, optimizer="adam8bit",
                    ckpt_dir=str(tmp_path / "ssa"), device="cpu")
    assert all(np.isfinite(rec["losses"]))
    assert rec["opt_state"]["m"]["tower_w0"]["q"].dtype == torch.int8
    with pytest.raises(ValueError, match="unpack"):
        train.run("fm", steps=1, batch=8, optimizer="adam8bit",
                  ckpt_dir=str(tmp_path / "fm"), device="cpu")


@pytest.fixture(scope="module")
def worlds():
    """arch -> (repro cfg, port cfg, repro params, three numpy batches of 32)."""
    out = {}
    jcfg, tcfg = reduced_pair("fm")
    out["fm"] = (jcfg, tcfg, jax_params(jcfg, seed=0), list(criteo_batches(jcfg, 32, 3, seed=5)))
    jcfg, tcfg = reduced_pair("dien", seq_len=20)
    out["dien"] = (jcfg, tcfg, jax_params(jcfg, seed=0),
                   list(taobao_batches(jcfg, 32, 3, seed=5)))
    return out


@pytest.mark.parametrize("arch", ["fm", "dien"])
def test_three_sgd_steps_match_repro(worlds, rec_rules, arch):
    before = (fm_ops.launches, augru_ops.launches)
    ref, out, metrics = _run_both(worlds[arch], rec_rules, ("sgd", 0.1))
    assert (fm_ops.launches, augru_ops.launches) == before  # the CPU runs the plain versions
    assert ref.keys() == out.keys()
    for jn, tn, jl, tl in metrics:
        assert tn == pytest.approx(jn, rel=1e-5) and tl == pytest.approx(jl, rel=1e-5)
    for path, t in out.items():
        np.testing.assert_allclose(t.numpy(), ref[path], rtol=0, atol=SGD_ATOL, err_msg=str(path))
    moved = {"fm": ("table",), "dien": ("augru_wh",)}[arch]
    assert np.abs(out[moved].numpy() - _to_np(worlds[arch][2], moved)).max() > 0


def _to_np(jparams, path):
    node = jparams
    for k in path:
        node = node[k]
    return np.asarray(node)


@pytest.mark.parametrize("arch", ["fm", "dien"])
def test_three_adamw_steps_match_repro(worlds, rec_rules, arch):
    ref, out, metrics = _run_both(worlds[arch], rec_rules, ("adamw", 1e-3))
    for jn, tn, jl, tl in metrics:
        assert tl == pytest.approx(jl, rel=1e-5) and tn == pytest.approx(jn, rel=1e-3)
    n = n_far = 0
    for path, t in out.items():
        d = np.abs(t.numpy() - ref[path])
        assert d.max() <= 2 * 1e-3 * len(metrics), path  # at most 2·lr a step
        n, n_far = n + d.size, n_far + int((d > ADAM_ATOL).sum())
    assert n_far <= ADAM_FLIP_SHARE * n


@pytest.mark.parametrize("B,F,k", [(32, 39, 10), (5, 3, 1), (7, 8, 33)])
def test_fm_interaction_backward_matches_jax_grad(B, F, k):
    rng = np.random.default_rng(B)
    e, dy = rng.normal(size=(B, F, k)).astype(np.float32), rng.normal(size=B).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(jax_fm_interaction(x) * dy))(jnp.asarray(e))
    et = torch.from_numpy(e).requires_grad_(True)
    out = fm_ops.fm_interaction_op(et)
    assert type(out.grad_fn).__name__ == "_FMInteractionBackward"  # the card's backward
    (grad,) = torch.autograd.grad(out, et, torch.from_numpy(dy))
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref), rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(grad.numpy(), fm_ops.fm_interaction_grad(
        torch.from_numpy(e), torch.from_numpy(dy)).numpy(), rtol=0, atol=0)


def _augru_inputs(B, T, g, seed):
    rng = np.random.default_rng(seed)
    zx = rng.normal(size=(B, T, 3 * g)).astype(np.float32)
    wh = (rng.normal(size=(g, 3 * g)) / np.sqrt(g)).astype(np.float32)
    h0 = (rng.normal(size=(B, g)) * 0.1).astype(np.float32)
    att = rng.uniform(size=(B, T)).astype(np.float32)
    mask = rng.uniform(size=(B, T)) > 0.2
    dh = rng.normal(size=(B, g)).astype(np.float32)
    return zx, wh, h0, att, mask, dh


@pytest.mark.parametrize("B,T,g", [(8, 20, 18), (3, 100, 108), (1, 1, 1)])
def test_augru_backward_matches_jax_grad(B, T, g):
    zx, wh, h0, att, mask, dh = _augru_inputs(B, T, g, seed=B + T)
    refs = jax.grad(lambda *a: jnp.sum(jax_augru_ref(*a, jnp.asarray(mask)) * dh),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, (zx, wh, h0, att)))
    inputs = [torch.from_numpy(x).requires_grad_(True) for x in (zx, wh, h0, att)]
    before = augru_ops.launches
    out = augru_ops.augru_op(*inputs, torch.from_numpy(mask))
    assert type(out.grad_fn).__name__ == "_AUGRUBackward"  # the card's backward
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(dh))
    assert augru_ops.launches == before
    for name, g_, r in zip(("zx", "wh", "h0", "att"), grads, refs):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r), rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)


def test_augru_backward_gives_only_the_gradients_asked_for():
    zx, wh, h0, att, mask, dh = _augru_inputs(4, 6, 8, seed=0)
    wh_t = torch.from_numpy(wh).requires_grad_(True)
    out = augru_ops.augru_op(torch.from_numpy(zx), wh_t, torch.from_numpy(h0),
                             torch.from_numpy(att), torch.from_numpy(mask))
    (g_wh,) = torch.autograd.grad(out, [wh_t], torch.from_numpy(dh))
    ref = jax.grad(lambda w: jnp.sum(jax_augru_ref(jnp.asarray(zx), w, jnp.asarray(h0),
                                                   jnp.asarray(att), jnp.asarray(mask)) * dh))(
        jnp.asarray(wh))
    np.testing.assert_allclose(g_wh.numpy(), np.asarray(ref), rtol=0, atol=GRAD_ATOL)


def test_each_launcher_resumes_the_others_checkpoint(tmp_path, monkeypatch, capsys):
    """The port's launcher checkpoints step 3 and `repro`'s resumes it (one
    restart); `repro`'s checkpoints step 5 and the port's resumes that."""
    d = str(tmp_path)
    train.main(["--arch", "fm", "--device", "cpu", "--steps", "3", "--batch", "8",
                "--ckpt-every", "3", "--ckpt-dir", d])
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "fm", "--steps", "5", "--batch", "8",
                                      "--ckpt-every", "5", "--ckpt-dir", d])
    jax_train.main()
    train.main(["--arch", "fm", "--device", "cpu", "--steps", "6", "--batch", "8",
                "--ckpt-dir", d])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [(r["steps"], r["restarts"]) for r in lines] == [(3, 0), (5, 1), (6, 1)]
    assert checkpoint.latest_step(d) == 5


def test_a_rerun_over_a_finished_checkpoint_reports_the_restored_step_and_no_steps(
        tmp_path, monkeypatch, capsys):
    """A deviation from `repro`: over a checkpoint of step 4, a run to 4
    trains nothing and prints steps 4, resumed_from 4 and steps_per_s 0;
    `repro`'s launcher, run the same way, prints steps 5 and a rate of
    restored steps."""
    d = str(tmp_path)
    argv = ["--arch", "fm", "--steps", "4", "--batch", "8", "--ckpt-every", "2", "--ckpt-dir", d]
    train.main(argv + ["--device", "cpu"])
    train.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jax_train.main()
    first, again, ref = (json.loads(x) for x in capsys.readouterr().out.strip().splitlines())
    assert (first["steps"], first["restarts"], first["resumed_from"]) == (4, 0, 0)
    assert (again["steps"], again["restarts"], again["resumed_from"]) == (4, 1, 4)
    assert again["steps_per_s"] == 0
    assert (ref["steps"], ref["restarts"]) == (5, 1) and ref["steps_per_s"] > 0
    assert checkpoint.latest_step(d) == 4
    rec = train.run("fm", steps=4, batch=8, ckpt_every=2, ckpt_dir=d, device="cpu")
    assert rec["losses"] == [] and rec["steps"] == rec["resumed_from"] == 4
