"""Fault-tolerant training controller (port of `repro.training.fault_tolerance`):
heartbeats, the straggler policy and auto-resume.

Host-side Python around the train step, with failures injected by the
caller; the policies are `repro`'s:

  * periodic chunked-atomic checkpoints (training/checkpoint.py),
  * heartbeat watchdog: a worker missing `dead_after` beats is declared
    failed,
  * straggler mitigation: per-step worker durations in a rolling window; a
    worker slower than `straggler_factor` x the median for
    `straggler_patience` checks in a row is evicted,
  * resume: `ResilientTrainer.run` restores the latest checkpoint in its
    directory whenever there is one, and asks `make_batches` for the
    batches from that step on.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.training import checkpoint


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = "/tmp/repro_torch_ckpt"
    ckpt_every: int = 50
    heartbeat_s: float = 10.0
    dead_after: int = 3  # missed beats
    straggler_factor: float = 2.0
    straggler_patience: int = 3


class HeartbeatMonitor:
    def __init__(self, workers, cfg: FTConfig):
        self.cfg = cfg
        self.last_beat: Dict[str, float] = {w: 0.0 for w in workers}
        self.durations: Dict[str, deque] = {w: deque(maxlen=20) for w in workers}
        self.slow_strikes: Dict[str, int] = defaultdict(int)

    def beat(self, worker: str, now: float, step_duration: Optional[float] = None):
        self.last_beat[worker] = now
        if step_duration is not None:
            self.durations[worker].append(step_duration)

    def dead_workers(self, now: float):
        limit = self.cfg.heartbeat_s * self.cfg.dead_after
        return [w for w, t in self.last_beat.items() if now - t > limit]

    def stragglers(self):
        """Workers persistently slower than straggler_factor x median."""
        meds = {w: float(np.median(d)) for w, d in self.durations.items() if len(d) >= 5}
        if len(meds) < 2:
            return []
        global_med = float(np.median(list(meds.values())))
        out = []
        for w, m in meds.items():
            if m > self.cfg.straggler_factor * global_med:
                self.slow_strikes[w] += 1
                if self.slow_strikes[w] >= self.cfg.straggler_patience:
                    out.append(w)
            else:
                self.slow_strikes[w] = 0
        return out

    def evict(self, worker: str):
        self.last_beat.pop(worker, None)
        self.durations.pop(worker, None)
        self.slow_strikes.pop(worker, None)


class ResilientTrainer:
    """Checkpoint/auto-resume wrapper around a train step."""

    def __init__(self, train_step, cfg: FTConfig, *, make_batches: Callable):
        self.train_step = train_step
        self.cfg = cfg
        self.make_batches = make_batches  # (start_step) -> iterator

    def run(self, params, opt_state, n_steps: int, *, crash_at: Optional[int] = None):
        """Train with periodic checkpoints; `crash_at` injects a failure
        (tests). Returns (params, opt_state, restarts, last_step). A
        restored leaf goes to the device of its leaf in `(params,
        opt_state)`. A restored step at or beyond `n_steps` trains nothing
        and is the last step (`repro` returns it + 1 there, as if one step
        had run)."""
        start = checkpoint.latest_step(self.cfg.ckpt_dir)
        restarts = 0
        step0 = 0
        if start is not None:
            params, opt_state = checkpoint.restore(self.cfg.ckpt_dir, start, (params, opt_state))
            step0 = start
            restarts += 1

        batches = self.make_batches(step0)
        last = step0
        for step, batch in zip(range(step0, n_steps), batches):
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"injected failure at step {step}")
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            last = step + 1
            if last % self.cfg.ckpt_every == 0:
                checkpoint.save(self.cfg.ckpt_dir, last, (params, opt_state))
        return params, opt_state, restarts, last
