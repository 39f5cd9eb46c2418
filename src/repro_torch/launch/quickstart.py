"""Quickstart (port of `examples/quickstart.py`): train the paper's Baseline
ranker on synthetic Taobao logs, apply the paper's full compression ladder,
compare accuracy and size.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cuda]

1. train    — taobao_ssa with every vocabulary cut to 10,000 (widths as
   configured), `TaobaoWorld(10_000, 10_000, 5_000)`, 100 AdamW steps at
   lr 2e-3 on batches of 512 (seed 1), parameters from seed 0;
2. ladder   — `run_ladder` at 15 fine-tune, 15 QAT and 30 distillation
   steps on batches of 512 (seed 3), unstructured pruning;
3. evaluate — 256 queries × 50 candidates (`taobao_eval_candidates`: one
   positive from the user's history, 49 uniform negatives) through each
   variant's serve call: params, bytes, HR@10, NDCG@50 and MRR.

Prints the example's lines (the loss every 25 steps, then the table) and
last one JSON object: the losses, each stage's seconds and the rows. The
settings are the example's; `build`'s keywords cut them for tests.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RecSysConfig, get_config
from repro_torch.core.compression_loop import (
    LadderConfig, run_ladder, serving_params, variant_stats)
from repro_torch.data.metrics import ranking_metrics
from repro_torch.data.synthetic import TaobaoWorld, taobao_batches, taobao_eval_candidates
from repro_torch.launch.serve import disable_tf32, make_params
from repro_torch.models.recsys import api
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_loop import make_train_step

VOCAB = 10_000
WORLD = (10_000, 10_000, 5_000)  # users, items, categories
STEPS, BATCH, LR = 100, 512, 2e-3
TRAIN_SEED, LADDER_SEED = 1, 3
LADDER = LadderConfig(finetune_steps=15, qat_steps=15, distill_steps=30)
N_QUERIES, N_CAND = 256, 50
LOG_EVERY = 25


def config(vocab: int = VOCAB) -> RecSysConfig:
    """taobao_ssa with every vocabulary cut to `vocab`."""
    cfg = get_config("taobao_ssa")
    return dataclasses.replace(
        cfg, fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, vocab)) for f in cfg.fields))


def _on(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@dataclasses.dataclass
class Quickstart:
    """What `build` makes: the teacher's losses, the ladder's variants as a
    server runs them ({name: {"params", "cfg"}}), their `variant_stats`,
    the evaluation set and each stage's seconds."""

    losses: List[float]
    variants: Dict[str, Dict]
    stats: Dict[str, Dict]
    eval_batch: Dict[str, torch.Tensor]
    pos_idx: np.ndarray
    seconds: Dict[str, float]


def train_teacher(cfg: RecSysConfig, world: TaobaoWorld, device, *, steps: int = STEPS,
                  batch: int = BATCH, lr: float = LR, log=None):
    """Stage 1: `steps` AdamW steps from seed-0 parameters on the world's
    batches of seed `TRAIN_SEED`. Returns the parameters and each step's loss."""
    params = make_params(cfg, device, seed=0)
    opt = get_optimizer("adamw", lr)
    step = make_train_step(lambda p, b: api.loss(p, b, cfg), opt)
    state = opt.init(params)
    losses = []
    gen = taobao_batches(cfg, batch, 10**6, world=world, seed=TRAIN_SEED)
    for i, b in zip(range(steps), gen):
        params, state, m = step(params, state, _on(b, device))
        losses.append(m["loss"])
        if log is not None and i % LOG_EVERY == 0:
            log(f"  step {i:3d}  loss {float(m['loss']):.4f}")
    return params, [float(x) for x in losses]


def compress(params: Dict, cfg: RecSysConfig, world: TaobaoWorld, device, *,
             ladder: LadderConfig = LADDER, batch: int = BATCH) -> Dict[str, Dict]:
    """Stage 2: the five Table-I variants (`run_ladder`) on the world's
    batches of seed `LADDER_SEED`, each stage starting them afresh."""
    def batch_fn():
        for b in taobao_batches(cfg, batch, 10**6, world=world, seed=LADDER_SEED):
            yield _on(b, device)

    return run_ladder(params, cfg, batch_fn, ladder)


def eval_set(cfg: RecSysConfig, world: TaobaoWorld, device, *, n_queries: int = N_QUERIES,
             n_cand: int = N_CAND):
    """The example's evaluation set: the flat batch of n_queries·n_cand rows
    on `device` and each query's positive index."""
    ev = taobao_eval_candidates(cfg, n_queries=n_queries, n_cand=n_cand, world=world)
    return _on(ev["batch"], device), ev["pos_idx"]


def build(device="cuda", *, cfg: Optional[RecSysConfig] = None,
          world: Optional[TaobaoWorld] = None, steps: int = STEPS, batch: int = BATCH,
          ladder: LadderConfig = LADDER, n_queries: int = N_QUERIES, n_cand: int = N_CAND,
          log=None) -> Quickstart:
    """Stages 1 and 2 and the evaluation set. `cfg`, `world` and the
    counts cut the run for tests; the defaults are the example's."""
    dev = resolve_device(device)
    cfg = cfg or config()
    world = world or TaobaoWorld(*WORLD)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    params, losses = train_teacher(cfg, world, dev, steps=steps, batch=batch, log=log)
    sync()
    t1 = time.perf_counter()
    if log is not None:
        log("== 2. compression ladder (prune -> finetune -> quantize -> QAT, + distill) ==")
    built = compress(params, cfg, world, dev, ladder=ladder, batch=batch)
    sync()
    t2 = time.perf_counter()
    batch_ev, pos_idx = eval_set(cfg, world, dev, n_queries=n_queries, n_cand=n_cand)
    variants = {name: {"params": serving_params(name, v["params"], ladder), "cfg": v["cfg"]}
                for name, v in built.items()}
    return Quickstart(losses, variants, variant_stats(built), batch_ev, pos_idx,
                      {"train": t1 - t0, "ladder": t2 - t1})


def scores(q: Quickstart) -> Dict[str, torch.Tensor]:
    """Each variant's serve call on the evaluation set: {name: [n_queries·n_cand]}."""
    with torch.no_grad():
        return {name: api.serve(v["params"], q.eval_batch, v["cfg"])
                for name, v in q.variants.items()}


def table(q: Quickstart, by_variant: Dict[str, torch.Tensor]) -> List[Dict]:
    """Stage 3: the example's row of each variant."""
    rows = []
    for name, s in by_variant.items():
        s = s.detach().cpu().numpy().reshape(len(q.pos_idx), -1)  # [queries, candidates]
        m = ranking_metrics(s, q.pos_idx, k=50)
        m10 = ranking_metrics(s, q.pos_idx, k=10)
        st = q.stats[name]
        rows.append({"variant": name, "params": st["params"], "bytes": st["bytes"],
                     "HR@10": m10["hit_rate"], "NDCG@50": m["ndcg"], "MRR": m["mrr"]})
    return rows


def run(device="cuda", **kw) -> List[Dict]:
    """The three stages: a record of training (its losses), one of the
    ladder, then one row per variant (`table`). Keywords as `build`."""
    q = build(device, **kw)
    return [{"stage": "train", "steps": len(q.losses), "losses": q.losses,
             "seconds": q.seconds["train"]},
            {"stage": "ladder", "variant_stats": q.stats, "seconds": q.seconds["ladder"]},
            *table(q, scores(q))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    disable_tf32()
    print("== 1. train the teacher ==", flush=True)
    q = build(args.device, log=lambda line: print(line, flush=True))
    print("== 3. evaluate (candidate set 50, as in the paper) ==")
    rows = table(q, scores(q))
    print(f"{'variant':18s} {'params':>10s} {'size':>10s} {'HR@10':>7s} {'NDCG@50':>8s} {'MRR':>7s}")
    for r in rows:
        print(f"{r['variant']:18s} {r['params']/1e6:9.2f}M {r['bytes']/2**20:9.2f}M "
              f"{r['HR@10']:7.3f} {r['NDCG@50']:8.3f} {r['MRR']:7.3f}")
    print(json.dumps({"losses": q.losses, "seconds": q.seconds, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
