"""Elastic-scheduling study (paper §IV.B) on the multi-pool engine: the
same traffic spike served by (a) a fixed single pool, (b) an autoscaled
pool, (c) autoscaling + warm pool + priority bypass, then the refactor's
new scenarios — (d) a heterogeneous baseline+distilled fleet behind each
router policy (including the recommended cost_model), (e) ranking traffic
as a RecPipe-style cascade vs the baseline pool alone under one shared
capacity budget, and the cost-aware serving path — (f) mixed pointwise +
ranking traffic with count-closed vs item-closed batches, (g) a
per-pool cost-weighted rate limiter protecting the heavy pool while the
cheap pool keeps absorbing tail traffic, and (h) the adaptive control
plane — a pool whose offline calibration is 2x off its true service
times misroutes under cost-model routing until an OnlineLatencyModel
learns the correction from observed batches, and SLO-aware batch sizing
narrows a too-wide item cap on breach (serving/control.py).

    PYTHONPATH=src python -m repro_torch.launch.elastic_scaling

The port's copy of `examples/elastic_scaling.py`: the same code on the port's serving
simulator (`repro_torch.core.serving`), with analytic latency curves; no
model, no device.
"""
from repro_torch.core.serving.autoscaler import ScalerConfig
from repro_torch.core.serving.cascade import CascadeConfig
from repro_torch.core.serving.control import ControlConfig
from repro_torch.core.serving.engine import (
    ElasticEngine, EngineConfig, PoolSpec, ServingSystem, poisson_arrivals,
)
from repro_torch.core.serving.pool import PoolConfig
from repro_torch.core.serving.rate_limiter import TierPolicy
from repro_torch.core.serving.replica import LatencyModel, ReplicaSpec
from repro_torch.core.serving.router import make_router

SPIKE = lambda t: 120.0 if t < 15 else (1100.0 if t < 40 else 150.0)
RANK_SPIKE = lambda t: 25.0 if t < 15 else (110.0 if t < 40 else 35.0)

BASELINE = lambda: ReplicaSpec("baseline", LatencyModel.analytic(0.018, 0.0008),
                               cold_start_s=5.0, warm_start_s=0.2)
DISTILLED = lambda: ReplicaSpec("distilled", LatencyModel.analytic(0.004, 0.0001),
                                cold_start_s=2.0, warm_start_s=0.2)


def report(name, res):
    tr = res["trace"]
    print(f"{name:38s} p50={res['p50']*1e3:8.1f}ms p99={res['p99']*1e3:8.1f}ms "
          f"thpt={res['throughput']:6.0f}/s shed={res['rejected']:6d} "
          f"slo={res['slo_attainment']:.3f} "
          f"max_repl={max(tr['replicas'], default=0)}")
    return res


def single_pool(name, *, autoscale, warm_pool, bypass, cold=5.0):
    spec = ReplicaSpec("model", LatencyModel.analytic(0.018, 0.0008),
                       cold_start_s=cold, warm_start_s=0.2)
    eng = ElasticEngine(
        spec,
        EngineConfig(n_replicas=2, autoscale=autoscale, slo_p99_s=0.15,
                     max_batch=32, priority_bypass=bypass),
        tiers={"tier0": TierPolicy(1500, 120), "tier1": TierPolicy(1500, 120)},
        scaler_cfg=ScalerConfig(min_replicas=2, warm_pool_size=4 if warm_pool else 0),
    )
    arrivals = poisson_arrivals(SPIKE, 60.0, seed=0, priority_frac=0.03)
    return report(name, eng.run(arrivals, until=60.0))


def heterogeneous(policy, **kw):
    pools = {
        "baseline": PoolSpec(BASELINE(), PoolConfig(n_replicas=2, max_batch=32)),
        "distilled": PoolSpec(DISTILLED(), PoolConfig(n_replicas=2, max_batch=32)),
    }
    sys_ = ServingSystem(
        pools, make_router(policy, **kw),
        tiers={"tier0": TierPolicy(1500, 120), "tier1": TierPolicy(1500, 120)},
        slo_p99_s=0.15, capacity=12,
    )
    arrivals = poisson_arrivals(SPIKE, 60.0, seed=0, priority_frac=0.03)
    res = report(f"hetero 2-pool [{policy}]", sys_.run(arrivals, until=60.0))
    share = ", ".join(f"{n}={p['completed']}" for n, p in res["pools"].items())
    print(f"{'':38s} pool share: {share}")


def ranking(mode):
    candidates, k = 512, 32
    tiers = {"tier0": TierPolicy(200, 40), "tier1": TierPolicy(200, 40)}
    pcfg = lambda: PoolConfig(n_replicas=2, max_batch=4, priority_bypass=False)
    if mode == "baseline_only":
        sys_ = ServingSystem({"baseline": PoolSpec(BASELINE(), pcfg())},
                             tiers=tiers, slo_p99_s=0.3, capacity=8)
        arrivals = poisson_arrivals(RANK_SPIKE, 60.0, seed=0, cost=candidates,
                                    priority_frac=0.0)
    else:
        sys_ = ServingSystem(
            {"distilled": PoolSpec(DISTILLED(), pcfg()),
             "baseline": PoolSpec(BASELINE(), pcfg())},
            cascade=CascadeConfig("distilled", "baseline",
                                  candidates=candidates, rerank_k=k),
            tiers=tiers, slo_p99_s=0.3, capacity=8)
        arrivals = poisson_arrivals(RANK_SPIKE, 60.0, seed=0, priority_frac=0.0)
    report(f"ranking 512-cand [{mode}]", sys_.run(arrivals, until=60.0))


def mixed_batching(batching):
    """90% pointwise + 10% ranking traffic: a 256-candidate query in a
    count-closed batch stalls every pointwise query sharing it; the item
    budget keeps per-batch service time bounded."""
    cap = 256 if batching == "items" else None
    pools = {
        "baseline": PoolSpec(BASELINE(), PoolConfig(
            n_replicas=2, max_batch=64, max_wait_s=0.02, max_batch_items=cap)),
        "distilled": PoolSpec(DISTILLED(), PoolConfig(
            n_replicas=2, max_batch=64, max_wait_s=0.02, max_batch_items=cap)),
    }
    sys_ = ServingSystem(
        pools, make_router("cost_model"),
        tiers={"tier0": TierPolicy(1500, 300), "tier1": TierPolicy(1500, 300)},
        slo_p99_s=0.15, capacity=12,
    )
    arrivals = poisson_arrivals(lambda t: 250.0, 40.0, seed=0, priority_frac=0.02,
                                cost_mix=((1, 0.9), (256, 0.1)))
    report(f"mixed traffic [{batching}-closed batches]", sys_.run(arrivals, until=40.0))


def per_pool_admission(protected):
    """Overload the bulk-scoring pool with ranking traffic (the cost-model
    router sends ranking there — its latency curve is flattest at large
    batch): the pool's own cost-weighted limiter sheds work it cannot
    serve inside the SLO, while the pointwise pool keeps serving every
    request it is routed. Without the pool limiter the bulk queue grows
    without bound and its stage p99 explodes."""
    bulk_tiers = (
        {"tier0": TierPolicy(6400, 2600), "tier1": TierPolicy(6400, 2600)}
        if protected else None)
    pools = {
        "bulk": PoolSpec(
            ReplicaSpec("bulk", LatencyModel.analytic(0.030, 2e-5),
                        cold_start_s=5.0, warm_start_s=0.2),
            PoolConfig(n_replicas=2, autoscale=False, max_batch=4,
                       max_batch_items=512, priority_bypass=False),
            tiers=bulk_tiers),
        "point": PoolSpec(
            ReplicaSpec("point", LatencyModel.analytic(0.002, 1e-3),
                        cold_start_s=2.0, warm_start_s=0.2),
            PoolConfig(n_replicas=2, autoscale=False)),
    }
    sys_ = ServingSystem(pools, make_router("cost_model"), slo_p99_s=0.25,
                         adaptive_shedding=False)
    arrivals = poisson_arrivals(lambda t: 250.0, 30.0, seed=0, priority_frac=0.0,
                                cost_mix=((1, 0.7), (256, 0.3)))
    label = "per-pool limiter" if protected else "fleet limiter only"
    res = report(f"bulk-pool overload [{label}]", sys_.run(arrivals, until=30.0))
    for name, p in res["pools"].items():
        print(f"{'':38s} {name}: completed={p['completed']} shed={p['shed']} "
              f"stage_p99={p['p99']*1e3:.0f}ms")


def adaptive_control(mode):
    """The control plane (serving/control.py) closing the feedback loop:
    the "drifted" pool's offline calibration claims it is 2x faster than
    it really is, so the cost-model router floods it. Static: the stale
    calibration stands for the whole run. Adaptive: every completed
    batch's measured service time EWMA-corrects the predicted curve
    (watch the learned correction converge to ~2.0), and the router
    recovers the oracle split."""
    truth = LatencyModel.analytic(0.020, 0.001)
    claims_2x_faster = LatencyModel.analytic(0.010, 0.0005)
    ctl = ControlConfig(online_latency=True, adapt_batch=False)
    pcfg = lambda: PoolConfig(n_replicas=2, autoscale=False, max_batch=4,
                              max_wait_s=0.02, priority_bypass=False)
    pools = {
        "accurate": PoolSpec(
            ReplicaSpec("accurate", truth, cold_start_s=5.0, warm_start_s=0.2),
            pcfg(), control=ctl if mode == "adaptive" else None),
        "drifted": PoolSpec(
            ReplicaSpec("drifted", claims_2x_faster, cold_start_s=5.0,
                        warm_start_s=0.2, true_latency=truth),
            pcfg(), control=ctl if mode == "adaptive" else None),
    }
    sys_ = ServingSystem(pools, make_router("cost_model"), slo_p99_s=1.0,
                         adaptive_shedding=False)
    arrivals = poisson_arrivals(lambda t: 45.0, 30.0, seed=0, cost=64,
                                priority_frac=0.0)
    res = report(f"2x mis-calibrated pool [{mode}]", sys_.run(arrivals, until=30.0))
    corr = ", ".join(f"{n}: corr={p['control']['latency_correction']:.2f}"
                     for n, p in res["pools"].items())
    print(f"{'':38s} learned {corr}")


def adaptive_batch_sizing(mode):
    """SLO-aware batch sizing: ranking traffic in the item-capped
    batching regime, where a static 1024-item cap makes every request
    eat the wide batch's fill + service time. The BatchSizeController
    narrows the effective cap on SLO breach and widens it under
    headroom, per scale tick, from the pool's own windowed p99."""
    ctl = ControlConfig(online_latency=False, adapt_batch=True,
                        min_batch_items=128, max_batch_items=1024)
    pools = {"bulk": PoolSpec(
        BASELINE(),
        PoolConfig(n_replicas=2, autoscale=False, max_batch=256,
                   max_wait_s=1.0, max_batch_items=1024,
                   priority_bypass=False),
        control=ctl if mode == "adaptive" else None)}
    sys_ = ServingSystem(pools, slo_p99_s=0.6, adaptive_shedding=False)
    arrivals = poisson_arrivals(lambda t: 90.0, 30.0, seed=0, cost=16,
                                priority_frac=0.0)
    res = report(f"1024-item cap vs SLO [{mode}]", sys_.run(arrivals, until=30.0))
    cap = res["pools"]["bulk"]["control"]["max_batch_items"]
    print(f"{'':38s} effective max_batch_items at end: {cap}")


def main():
    print("traffic: 120 QPS -> 1100 QPS spike -> 150 QPS; SLO p99 = 150ms")
    single_pool("fixed 2 replicas", autoscale=False, warm_pool=False, bypass=False)
    single_pool("autoscale (cold starts)", autoscale=True, warm_pool=False, bypass=False)
    single_pool("autoscale + warm pool", autoscale=True, warm_pool=True, bypass=False)
    single_pool("autoscale + warm pool + bypass", autoscale=True, warm_pool=True, bypass=True)
    print("\nheterogeneous fleet (baseline + distilled), capacity budget 12:")
    heterogeneous("least_loaded")
    heterogeneous("power_of_two", seed=0)
    heterogeneous("slo_aware", slo_p99_s=0.15, quality_order=("baseline", "distilled"))
    heterogeneous("cost_model")
    print("\nranking traffic (512 candidates/query), capacity budget 8, SLO p99 = 300ms:")
    ranking("baseline_only")
    ranking("cascade")
    print("\nmixed 90% pointwise / 10% ranking-256 traffic (cost_model router):")
    mixed_batching("count")
    mixed_batching("items")
    print("\nper-pool cost-weighted admission under a ranking overload:")
    per_pool_admission(protected=False)
    per_pool_admission(protected=True)
    print("\nadaptive control plane (serving/control.py):")
    adaptive_control("static")
    adaptive_control("adaptive")
    adaptive_batch_sizing("static")
    adaptive_batch_sizing("adaptive")


if __name__ == "__main__":
    main()
