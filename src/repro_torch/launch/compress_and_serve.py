"""The paper's pipeline end to end (port of `examples/compress_and_serve.py`):

    PYTHONPATH=src python -m repro_torch.launch.compress_and_serve [--steps 300] \
        [--batch 512] [--device cuda] [--ckpt-dir DIR]

1. train  — taobao_ssa with every vocabulary cut to 50,000 (widths as
   configured), `TaobaoWorld(50_000, 50_000, 10_000)`, AdamW at 2e-3
   through `ResilientTrainer` (checkpoints every 100 steps into
   `--ckpt-dir`, whose latest checkpoint it restores first if there is
   one; without one, into a fresh temporary directory removed afterwards);
2. ladder — `run_ladder` with 20 fine-tune, 20 QAT and 40 distillation
   steps (unstructured pruning);
3. serve  — each variant's serve call calibrated into a `LatencyModel`
   (`launch/serve.latency_model`: the card synchronised after every call)
   and served by an `ElasticEngine` (2 autoscaled replicas, p99 SLO 150
   ms, two tiers of `TierPolicy(1500, 150)`) under the 45 s spike;
4. cache  — (a) a resident tier of the trained item table's 4,096 hottest
   rows of a Zipf stream: the cached lookup must equal the uncached one
   bit for bit (it raises otherwise), and the share of lookups it serves;
   (b) the calibrated baseline in a `ServingSystem` under Zipf id traffic
   that pays an embedding fetch per missed row, with a warm
   `CacheConfig(4096, "lru")` against no cache.

Prints one JSON line per record. As `repro`'s example, except: a curve
point is the mean of `CAL_REPS` = 10 calls, not 2 (the card's host spreads
by about 1 ms between runs); after a restore training resumes on the
uninterrupted batch stream (`launch/train.resumable`); and without
`--ckpt-dir` each run checkpoints into a directory of its own
(`repro`'s example uses a fixed one, so a second run there restores the
first's last step, trains nothing, and at another vocabulary takes the
old run's tables).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.core.caching import (
    build_resident_table, cached_embedding_bag, hot_ids, residency_mask)
from repro_torch.core.compression_loop import LadderConfig, run_ladder, variant_stats
from repro_torch.core.serving.cache import CacheConfig
from repro_torch.core.serving.engine import (
    ElasticEngine, EngineConfig, PoolSpec, ServingSystem, attach_zipf_ids, poisson_arrivals)
from repro_torch.core.serving.pool import PoolConfig
from repro_torch.core.serving.rate_limiter import TierPolicy
from repro_torch.core.serving.replica import LatencyModel, ReplicaSpec, sustainable_rate
from repro_torch.data.synthetic import TaobaoWorld, taobao_batches, zipf_id_stream
from repro_torch.launch import serve
from repro_torch.launch.train import recording_losses, resumable
from repro_torch.models.recsys import api
from repro_torch.models.recsys.embedding import embedding_bag
from repro_torch.training.fault_tolerance import FTConfig, ResilientTrainer
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_loop import make_train_step

VOCAB = 50_000
LADDER = LadderConfig(finetune_steps=20, qat_steps=20, distill_steps=40)
SIZES = (1, 8, 32, 128, 512)
CAL_REPS = 10
HORIZON = 45.0
CACHE_ROWS, IDS_PER_REQUEST = 4096, 16


def spike(t: float) -> float:
    return 150.0 if t < 10 else (900.0 if t < 30 else 200.0)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def config(vocab: int = VOCAB):
    cfg = get_config("taobao_ssa")
    return dataclasses.replace(
        cfg, fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, vocab)) for f in cfg.fields))


def cache_serving(baseline_lat: LatencyModel, vocab: int, stream: np.ndarray,
                  horizon: float = 20.0) -> Dict:
    """Stage 4(b): the calibrated baseline, each missed row paying an
    embedding fetch, under Zipf id traffic at an offered rate between the
    cold and the warm fleet's capacity; no cache against a warm LRU."""
    spec = ReplicaSpec("baseline", baseline_lat, cold_start_s=5.0, warm_start_s=0.2,
                       embed_fetch_s=2.0 * baseline_lat(32) / (32 * IDS_PER_REQUEST))
    wait = 0.02
    r_cold = sustainable_rate(spec, 2, wait, IDS_PER_REQUEST, hit_rate=0.0)
    r_warm = sustainable_rate(spec, 2, wait, IDS_PER_REQUEST, hit_rate=0.85)
    rate = min(1.2 * r_cold, 0.9 * r_warm)
    rows = []
    for label, cache in (("none", None), ("lru_warm", CacheConfig(CACHE_ROWS, "lru"))):
        system = ServingSystem(
            {"baseline": PoolSpec(
                spec, PoolConfig(n_replicas=2, autoscale=False, max_batch=32, max_wait_s=wait),
                cache=cache)},
            slo_p99_s=0.15, adaptive_shedding=False)
        if cache is not None:
            system.pools["baseline"].embed_cache.warm(stream)
        arr = poisson_arrivals(lambda t: rate, horizon, seed=12, priority_frac=0.0)
        attach_zipf_ids(arr, vocab, IDS_PER_REQUEST, alpha=1.1, seed=13)
        res = system.run(arr, until=horizon)
        rows.append({"cache": label, "hit_rate": res["cache"]["hit_rate"],
                     "p50_ms": res["p50"] * 1e3, "p99_ms": res["p99"] * 1e3,
                     "throughput": res["throughput"]})
    return {"offered_rate": rate, "cold_rate": r_cold, "warm_rate": r_warm, "rows": rows}


def run(*, ckpt_dir: Optional[str] = None, **kw) -> List[Dict]:
    """The four stages; one record each (stage 3: one a variant). `vocab`,
    `sizes` and the horizons cut the run for tests; the defaults are the
    example's. Without `ckpt_dir` the checkpoints go to a fresh temporary
    directory, removed when the run ends."""
    with (tempfile.TemporaryDirectory(prefix="repro_torch_e2e_ckpt_") if ckpt_dir is None
          else contextlib.nullcontext(ckpt_dir)) as d:
        return _run(ckpt_dir=d, **kw)


def _run(*, ckpt_dir: str, steps: int = 300, batch: int = 512, device="cuda",
         vocab: int = VOCAB, ladder: LadderConfig = LADDER, sizes=SIZES,
         horizon: float = HORIZON, cache_horizon: float = 20.0) -> List[Dict]:
    dev = resolve_device(device)
    cfg = config(vocab)
    fields = {f.name: f.vocab for f in cfg.fields}
    world = TaobaoWorld(fields["user"], fields["item"], fields["category"])  # 50k, 50k, 10k
    records: List[Dict] = []

    # ---- stage 1: fault-tolerant training (checkpoints + resume path) ----
    t0 = time.perf_counter()
    params = serve.make_params(cfg, dev, seed=0)
    opt = get_optimizer("adamw", 2e-3)
    losses: List[torch.Tensor] = []

    def mk_batches(start):
        return ({k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                for b in taobao_batches(cfg, batch, 10**9, world=world, seed=100 + start))

    trainer = ResilientTrainer(
        recording_losses(make_train_step(lambda p, b: api.loss(p, b, cfg), opt), losses),
        FTConfig(ckpt_dir=ckpt_dir, ckpt_every=100),
        make_batches=resumable(mk_batches))
    params, _, restarts, last = trainer.run(params, opt.init(params), steps)
    _sync(dev)
    records.append({"stage": "train", "steps": last, "restarts": restarts,
                    "losses": [float(x) for x in losses], "seconds": time.perf_counter() - t0})

    # ---- stage 2: the paper's ladder ----
    t0 = time.perf_counter()
    built = run_ladder(params, cfg, lambda: mk_batches(777), ladder)
    _sync(dev)
    records.append({"stage": "ladder", "variant_stats": variant_stats(built),
                    "seconds": time.perf_counter() - t0})

    # ---- stage 3: serve every variant through the elastic engine ----
    def batch_of(n, seed=5):
        b = next(iter(taobao_batches(cfg, n, 1, world=world, seed=seed)))
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items() if k != "label"}

    fixed = {n: batch_of(n) for n in sizes}
    arrivals = poisson_arrivals(spike, horizon, seed=0)
    curves = {}
    for name, v in built.items():
        t0 = time.perf_counter()
        lat = curves[name] = serve.latency_model(v["params"], v["cfg"], fixed, CAL_REPS)
        t1 = time.perf_counter()
        res = ElasticEngine(
            ReplicaSpec(name, lat, cold_start_s=5.0, warm_start_s=0.2),
            EngineConfig(n_replicas=2, autoscale=True, slo_p99_s=0.15),
            tiers={"tier0": TierPolicy(1500, 150), "tier1": TierPolicy(1500, 150)},
        ).run(arrivals, until=horizon)
        records.append({"stage": "serve", "variant": name, "curve": serve.curve_record(lat),
                        "latency_1_ms": lat(1) * 1e3, "latency_512_ms": lat(512) * 1e3,
                        "p50_ms": res["p50"] * 1e3, "p99_ms": res["p99"] * 1e3,
                        "throughput": res["throughput"], "rejected": res["rejected"],
                        "calibrate_seconds": t1 - t0, "seconds": time.perf_counter() - t0})

    # ---- stage 4: the caching layer, end to end ----
    # (a) a resident tier of the TRAINED item table's hot rows; the cached
    # lookup must match the uncached one exactly
    t0 = time.perf_counter()
    item_table = built["baseline"]["params"]["tables"]["item"]
    rows = int(item_table.shape[0])  # padded rows included: all gatherable
    stream = zipf_id_stream(40_000, rows, 1.1, seed=11)
    resident = build_resident_table(item_table, hot_ids(stream, CACHE_ROWS))
    idx = torch.from_numpy(stream[:4096].reshape(256, 16).astype(np.int32)).to(dev)
    cached = cached_embedding_bag(item_table, resident, idx)
    uncached = embedding_bag(item_table, idx)
    exact = bool(torch.equal(cached, uncached))
    share = float(residency_mask(resident, idx).float().mean())
    records.append({"stage": "cache_exact", "exact": exact, "resident_share": share,
                    "lookups": int(idx.numel()), "resident_rows": resident.n_resident,
                    "seconds": time.perf_counter() - t0})
    if not exact:
        raise AssertionError("the cached embedding_bag differs from the uncached one")

    # (b) the calibrated baseline under Zipf id traffic: a warm hot-id cache
    # against the no-cache fleet at the same offered load
    t0 = time.perf_counter()
    records.append({"stage": "cache_serving",
                    **cache_serving(curves["baseline"], rows, stream, cache_horizon),
                    "seconds": time.perf_counter() - t0})
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="")
    args = ap.parse_args(argv)
    serve.disable_tf32()
    for rec in run(steps=args.steps, batch=args.batch, device=args.device,
                   ckpt_dir=args.ckpt_dir or None):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
