"""RecPipe-style cascade inference (arXiv 2105.08820) as chained service
events: stage 1 scores the FULL candidate set on a light pool (distilled /
int8), stage 2 reranks only the top-k survivors on the heavy pool. The
heavy model therefore sees k items per query instead of the full set —
latency and throughput scale with k while ranking quality is anchored by
the strong reranker.

Public API
    CascadeConfig       stage pool names + candidates / rerank_k (ITEMS)
    CascadeDispatcher.admit    redirect a fresh arrival into stage 1
                               (clones the request; timeline dict shared)
    CascadeDispatcher.advance  on stage completion, mutate the request
                               into its next stage and return the next
                               pool (None = cascade finished)

The dispatcher owns no clock and no queue: it redirects a request's entry
pool at admission and, when a stage's batch completes, mutates the request
into its next stage and resubmits it to the next pool on the same event
loop. End-to-end latency is then exactly stage-1 (queue + service) plus
stage-2 (queue + service), which the tests assert from the per-stage
timeline stamps (`s1_*`, `s2_*` — stage 0 stamps under `s0_*`, so one
arrival list replays cleanly through baseline AND cascade runs).

Invariants: stage advancement uses `submit(force=True)` — work already
paid for upstream is never shed mid-chain; each stage stamps enqueue <=
start <= done in order. In a multi-cell federation a cascade stays within
its home cell, with one exception: the engine's `spill_stage` hook may
hand the rerank stage to a remote cell's same-named pool when the home
rerank pool is past its SLO headroom (the request then pays the
inter-cell RTT between `s1_done` and `s2_enqueue` — stamps survive the
hop because the stage prefix, not the cell, keys them).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.serving.pool import ReplicaPool, Request


@dataclasses.dataclass
class CascadeConfig:
    stage1: str  # light filter pool name (e.g. "distilled")
    stage2: str  # heavy rerank pool name (e.g. "baseline")
    candidates: int = 512  # stage-1 scores the full candidate set
    rerank_k: int = 32  # stage-2 reranks the top-k survivors


class CascadeDispatcher:
    def __init__(self, cfg: CascadeConfig):
        self.cfg = cfg

    def admit(self, req: Request, pools: Dict[str, ReplicaPool]) -> Tuple[Request, ReplicaPool]:
        """Route a fresh arrival into stage 1 with the full candidate load.
        The arrival is cloned (sharing its timeline dict, so the caller can
        still read per-stage stamps) — arrival lists are commonly reused
        across A/B runs and must never come back with mutated cost/stage.
        Sharing is safe because stage prefixes never collide: a baseline
        run stamps s0_* (Request.stamp keys by the request's own stage)
        while cascade stages stamp s1_*/s2_*."""
        staged = dataclasses.replace(req, stage=1, cost=self.cfg.candidates)
        return staged, pools[self.cfg.stage1]

    def advance(self, req: Request, pools: Dict[str, ReplicaPool]) -> Optional[ReplicaPool]:
        """Called when a stage completes. Returns the next pool to submit
        the request to, or None when the cascade is finished."""
        if req.stage == 1:
            req.stage = 2
            req.cost = self.cfg.rerank_k
            return pools[self.cfg.stage2]
        return None
