"""The port's fault-tolerance controller against `repro`'s answers.

- `repro`'s crash-and-resume test (`tests/test_training.py`) on the port:
  a crash at step 25 leaves the checkpoint of step 20, and the next run
  restores it and ends at step 50 with one restart.
- The resumed run ends in the same bits as an uninterrupted one, with the
  launcher's batch stream (`launch/train.resumable`).
- The heartbeat and straggler sequence of `repro`'s test gives `repro`'s
  answers in both packages.
- A deviation from `repro`: a rerun over a finished checkpoint trains no
  step and reports the restored step as the last one, where `repro`'s
  trainer reports one step more (shown on `repro`'s own trainer).
"""
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)
from repro.training.fault_tolerance import FTConfig as JaxFTConfig  # noqa: E402
from repro.training.fault_tolerance import HeartbeatMonitor as JaxHeartbeatMonitor  # noqa: E402
from repro.training.fault_tolerance import ResilientTrainer as JaxResilientTrainer  # noqa: E402
from repro_torch.launch.train import resumable  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.fault_tolerance import (  # noqa: E402
    FTConfig, HeartbeatMonitor, ResilientTrainer)
from repro_torch.training.optimizer import get_optimizer  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402


def _quadratic_problem():
    target = torch.linspace(-1.0, 1.0, 16)
    params = {"w": torch.zeros(16), "b": torch.zeros(())}

    def loss_fn(p, batch):
        x = batch.get("x", torch.ones(16))
        loss = torch.mean(torch.square(p["w"] * x + p["b"] - target))
        return loss, {}

    return params, loss_fn


def test_resilient_trainer_resumes_after_crash(tmp_path):
    params, loss_fn = _quadratic_problem()
    opt = get_optimizer("adamw", 0.05)
    step = make_train_step(loss_fn, opt, grad_clip=0.0)
    cfg = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=10)
    mk = lambda start: iter(lambda: {}, None)  # noqa: E731  (infinite empty batches)

    trainer = ResilientTrainer(step, cfg, make_batches=mk)
    state = opt.init(params)
    with pytest.raises(RuntimeError, match="injected failure at step 25"):
        trainer.run(params, state, 50, crash_at=25)
    assert checkpoint.latest_step(tmp_path) == 20  # last periodic ckpt

    p2, s2, restarts, last = trainer.run(params, state, 50)
    assert restarts == 1 and last == 50
    assert int(s2["count"]) == 50


def _stream(start):
    """A batch stream of a distinct x each step, seeded by the step it starts at."""
    def gen():
        i = 0
        while True:
            g = torch.Generator().manual_seed(1000 * start + i)
            yield {"x": torch.randn(16, generator=g)}
            i += 1
    return gen()


@pytest.mark.parametrize("opt_name", ["sgd", "adamw", "adam8bit"])
def test_a_resumed_run_ends_in_the_bits_of_an_uninterrupted_one(tmp_path, opt_name):
    params, loss_fn = _quadratic_problem()
    params = {"w": params["w"]}  # adam8bit blocks along a last axis: no 0-d leaf
    opt = get_optimizer(opt_name, 0.05)
    step = make_train_step(lambda p, b: loss_fn({**p, "b": torch.zeros(())}, b), opt)

    def train(ckpt_dir, **kw):
        trainer = ResilientTrainer(step, FTConfig(ckpt_dir=str(ckpt_dir), ckpt_every=10),
                                   make_batches=resumable(_stream))
        return trainer.run(params, opt.init(params), 30, **kw)

    with pytest.raises(RuntimeError):
        train(tmp_path / "crashed", crash_at=25)
    p_resumed, s_resumed, restarts, last = train(tmp_path / "crashed")
    p_whole, s_whole, restarts_whole, _ = train(tmp_path / "whole")
    assert (restarts, restarts_whole, last) == (1, 0, 30)
    resumed, _ = checkpoint.flatten((p_resumed, s_resumed))
    whole, _ = checkpoint.flatten((p_whole, s_whole))
    assert len(resumed) == len(whole)
    assert all(torch.equal(a, b) for a, b in zip(resumed, whole))


def _heartbeat_sequence(cfg_cls, mon_cls):
    """`repro`'s heartbeat/straggler test as a record of every answer."""
    cfg = cfg_cls(heartbeat_s=1.0, dead_after=3, straggler_factor=2.0, straggler_patience=2)
    mon = mon_cls(["w0", "w1", "w2"], cfg)
    for t in range(10):
        mon.beat("w0", float(t), 0.1)
        mon.beat("w1", float(t), 0.1)
        mon.beat("w2", float(t), 0.5)  # persistently 5x slower
    out = [mon.dead_workers(20.0)]
    mon.beat("w0", 20.0)
    out.append(mon.dead_workers(20.5))
    out.append(mon.stragglers())  # first strike
    out.append(mon.stragglers())  # patience reached
    mon.evict("w2")
    out.append(sorted(mon.last_beat))
    out.append(mon.stragglers())  # the two left run alike: none
    return out


def test_heartbeat_and_straggler_detection_give_repros_answers():
    ours = _heartbeat_sequence(FTConfig, HeartbeatMonitor)
    assert ours == _heartbeat_sequence(JaxFTConfig, JaxHeartbeatMonitor)
    assert ours[0] == ["w0", "w1", "w2"] and "w0" not in ours[1]
    assert ours[2] == [] and ours[3] == ["w2"] and "w2" not in ours[4]


def _counting_step(calls):
    """A train step that counts its calls and the state's steps."""
    def step(params, opt_state, batch):
        calls.append(1)
        return params, {"count": opt_state["count"] + 1}, {}
    return step


@pytest.mark.parametrize("n_steps", [4, 3])
def test_a_rerun_over_a_finished_checkpoint_trains_nothing_and_reports_the_restored_step(
        tmp_path, n_steps):
    """Checkpoint of step 4, then a rerun to `n_steps` (at or below it): no
    step runs and the last step is 4; `repro`'s trainer, run the same way,
    reports 5 after the same zero steps."""
    import jax.numpy as jnp

    mk = lambda start: iter(lambda: {}, None)  # noqa: E731  (infinite empty batches)
    port_calls, repro_calls = [], []
    port = ResilientTrainer(_counting_step(port_calls), FTConfig(str(tmp_path / "port"), 2),
                            make_batches=mk)
    state = {"count": torch.zeros((), dtype=torch.int32)}
    p, s, restarts, last = port.run({"w": torch.zeros(3)}, state, 4)
    assert (restarts, last, int(s["count"]), len(port_calls)) == (0, 4, 4, 4)
    p, s, restarts, last = port.run({"w": torch.zeros(3)}, state, n_steps)
    assert (restarts, last, int(s["count"]), len(port_calls)) == (1, 4, 4, 4)

    ref = JaxResilientTrainer(_counting_step(repro_calls),
                              JaxFTConfig(str(tmp_path / "repro"), 2), make_batches=mk)
    jstate = {"count": jnp.zeros((), jnp.int32)}
    ref.run({"w": jnp.zeros(3)}, jstate, 4)
    _, s, restarts, last = ref.run({"w": jnp.zeros(3)}, jstate, n_steps)
    assert (restarts, last, int(s["count"]), len(repro_calls)) == (1, 5, 4, 4)
