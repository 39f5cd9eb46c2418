"""Multi-cell serving federation demo (serving/federation.py): three cells
— each its own ServingSystem with cell-local budget and SLO monitor — on
one shared event loop, sticky (home-cell) traffic skewed 60/25/15 so the
hot cell runs past its local capacity while the fleet has headroom.

Three scenarios:
  1. spillover off: the hot cell queues and sheds while the other two
     cells idle — fleet p99 is the hot cell's p99;
  2. spillover on: requests past the hot cell's SLO headroom take one hop
     (paying a 5ms inter-cell RTT) to the best remote cell — fleet p99
     recovers at equal-or-better fleet throughput;
  3. cascade rerank spillover: the hot cell's heavy rerank pool is
     undersized, so stage 2 of the cascade spills to the cold cell's
     rerank pool while stage 1 stays home (stage timeline stamps survive
     the hop).

    PYTHONPATH=src python -m repro_torch.launch.multi_cell

The port's copy of `examples/multi_cell.py`: the same code on the port's serving
simulator (`repro_torch.core.serving`), with analytic latency curves; no
model, no device.
"""
from repro_torch.core.serving.cascade import CascadeConfig
from repro_torch.core.serving.engine import PoolSpec, poisson_arrivals
from repro_torch.core.serving.federation import CellSpec, FederatedSystem, assign_homes
from repro_torch.core.serving.pool import PoolConfig
from repro_torch.core.serving.rate_limiter import TierPolicy
from repro_torch.core.serving.replica import LatencyModel, ReplicaSpec

BASELINE = lambda: ReplicaSpec("baseline", LatencyModel.analytic(0.018, 0.0008),
                               cold_start_s=5.0, warm_start_s=0.2)
DISTILLED = lambda: ReplicaSpec("distilled", LatencyModel.analytic(0.004, 0.0001),
                                cold_start_s=2.0, warm_start_s=0.2)

SKEW = {"us": 0.60, "eu": 0.25, "ap": 0.15}


def report(name, res):
    print(f"{name:34s} p50={res['p50']*1e3:7.1f}ms p99={res['p99']*1e3:7.1f}ms "
          f"thpt={res['throughput']:6.0f}/s rej={res['rejected']:5d} "
          f"spilled={res['spilled']:5d} slo={res['slo_attainment']:.3f}")
    for cname, c in res["cells"].items():
        sp = c["spill"]
        print(f"  {cname}: arrived={c['arrived']:6d} completed={c['completed']:6d} "
              f"p99={c['p99']*1e3:7.1f}ms spill_out={sp['spilled_out']:5d} "
              f"spill_in={sp['spilled_in']:5d}")
    return res


def skewed_fleet(spillover):
    cells = {
        name: CellSpec(
            pools={"baseline": PoolSpec(
                BASELINE(),
                PoolConfig(n_replicas=2, autoscale=False, max_batch=32,
                           max_wait_s=0.02))},
            slo_p99_s=0.15,
        )
        for name in SKEW
    }
    fed = FederatedSystem(cells, policy="sticky", spillover=spillover,
                          rtt_s=0.005, slo_p99_s=0.15)
    arr = poisson_arrivals(lambda t: 2400.0, 20.0, seed=0, priority_frac=0.0)
    assign_homes(arr, SKEW, seed=1)
    label = "spillover on" if spillover else "spillover off"
    report(f"3 cells, 60/25/15 skew [{label}]", fed.run(arr, until=20.0))


def cascade_rerank_spill():
    """Ranking traffic through per-cell cascades: the hot cell's rerank
    pool has 1 replica (undersized), the cold cell's has 4 — under load
    the rerank stage spills cross-cell while the filter stage stays home."""
    def cell(n_rerank):
        return CellSpec(
            pools={
                "distilled": PoolSpec(DISTILLED(), PoolConfig(
                    n_replicas=4, autoscale=False, max_batch=4,
                    priority_bypass=False)),
                "baseline": PoolSpec(BASELINE(), PoolConfig(
                    n_replicas=n_rerank, autoscale=False, max_batch=4,
                    priority_bypass=False)),
            },
            cascade=CascadeConfig("distilled", "baseline",
                                  candidates=256, rerank_k=16),
            tiers={"tier0": TierPolicy(1e9, 1e9), "tier1": TierPolicy(1e9, 1e9)},
            slo_p99_s=0.3,
        )

    fed = FederatedSystem({"hot": cell(1), "cold": cell(4)}, policy="sticky",
                          spillover=True, rtt_s=0.005, slo_p99_s=0.3)
    arr = poisson_arrivals(lambda t: 120.0, 15.0, seed=3, priority_frac=0.0)
    assign_homes(arr, {"hot": 0.9, "cold": 0.1}, seed=4)
    res = report("cascade, undersized hot rerank", fed.run(arr, until=15.0))
    print(f"  rerank stages spilled cross-cell: {res['cascade_spilled']}")
    spilled = [r for r in arr
               if "s2_enqueue" in r.timeline
               and r.timeline["s2_enqueue"] - r.timeline["s1_done"] > 1e-9]
    if spilled:
        r = spilled[0]
        tl = r.timeline
        print(f"  example spilled request {r.rid}: s1_done={tl['s1_done']:.4f} "
              f"-> +5ms RTT -> s2_enqueue={tl['s2_enqueue']:.4f} "
              f"s2_done={tl['s2_done']:.4f} (stage stamps survive the hop)")


def main():
    print("fleet: 3 cells x 2 baseline replicas; 2400 QPS, homes skewed "
          f"{SKEW}; SLO p99 = 150ms, inter-cell RTT = 5ms")
    skewed_fleet(spillover=False)
    skewed_fleet(spillover=True)
    print("\ncascade rerank spillover (2 cells, 90/10 skew, SLO p99 = 300ms):")
    cascade_rerank_spill()


if __name__ == "__main__":
    main()
