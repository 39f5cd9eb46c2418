"""The port's copy of the serving simulator against `repro`'s.

`repro_torch.core.serving` is a copy of `repro.core.serving` that imports
nothing of `repro`. The simulator is deterministic, so each scenario is
built by one function that takes the package's name, runs in both
packages, and the two results must be equal as JSON, bit for bit: no
tolerance. Horizons are a few simulated seconds.
"""
import importlib
import json
import types

import numpy as np
import pytest

pytest.importorskip("torch")

PACKAGES = ("repro", "repro_torch")
_MODULES = ("autoscaler", "cache", "cascade", "control", "engine", "events", "federation",
            "metrics", "pool", "rate_limiter", "replica", "router", "shard", "tracing")


def _pkg(name: str) -> types.SimpleNamespace:
    """The package's serving modules and its synthetic-data module."""
    ns = {m: importlib.import_module(f"{name}.core.serving.{m}") for m in _MODULES}
    ns["synthetic"] = importlib.import_module(f"{name}.data.synthetic")
    return types.SimpleNamespace(**ns)


def _canon(x):
    """A summary as plain JSON values: numpy scalars and arrays unpacked,
    every dict key a string (summaries key some blocks by bool)."""
    if isinstance(x, dict):
        return {repr(k) if not isinstance(k, str) else k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return _canon(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"not a summary value: {type(x)}")


def _same_in_both(scenario, *args):
    """Run `scenario(pkg, *args)` in both packages; the two results as
    JSON text must be equal. Returns `repro`'s result."""
    ref, port = (_canon(scenario(_pkg(name), *args)) for name in PACKAGES)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    return ref


# the launcher's traffic profiles (`repro.launch.serve.PROFILES`), QPS at t
PROFILES = {
    "steady": lambda t: 300.0,
    "spike": lambda t: 150.0 if t < 15 else (1200.0 if t < 40 else 200.0),
    "ramp": lambda t: 50.0 + 20.0 * t,
}
HORIZON = 16.0  # simulated seconds: reaches the spike's first second at 1200/s
# a five-point curve shaped like a taobao_ssa serve call on the card, seconds
FIVE_POINT = ([1, 8, 32, 128, 512], [1.3e-3, 1.35e-3, 1.4e-3, 1.8e-3, 2.3e-3])


def _curve(p, kind):
    if kind == "analytic":
        return p.replica.LatencyModel.analytic(0.004, 2e-5)
    sizes, times = FIVE_POINT
    return p.replica.LatencyModel(np.asarray(sizes, np.float64), np.asarray(times))


def _elastic(p, profile, kind):
    spec = p.replica.ReplicaSpec("baseline", _curve(p, kind), cold_start_s=5.0, warm_start_s=0.2)
    eng = p.engine.ElasticEngine(
        spec, p.engine.EngineConfig(n_replicas=2, autoscale=True, slo_p99_s=0.1),
        tiers={"tier0": p.rate_limiter.TierPolicy(2000, 200),
               "tier1": p.rate_limiter.TierPolicy(2000, 200)})
    arrivals = p.engine.poisson_arrivals(PROFILES[profile], HORIZON, seed=0)
    return eng.run(arrivals, until=HORIZON)


@pytest.mark.parametrize("kind", ["analytic", "five_point"])
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_elastic_engine_under_each_profile(profile, kind):
    res = _same_in_both(_elastic, profile, kind)
    assert res["completed"] > 0
    assert res["arrived"] == res["completed"] + res["rejected"] + res["in_queue"]


def _two_pools(p, router):
    """A CPU-class and an accelerator-class pool under bimodal traffic whose
    requests carry Zipf ids, each pool with a hot-id cache."""
    cache = p.cache.CacheConfig(256)
    pools = {
        "cpu": p.engine.PoolSpec(
            p.replica.ReplicaSpec.cpu_like("base", embed_fetch_s=2e-5),
            p.pool.PoolConfig.for_platform("cpu", n_replicas=2, autoscale=False), cache=cache),
        "acc": p.engine.PoolSpec(
            p.replica.ReplicaSpec.accelerator_like("base", embed_fetch_s=2e-5),
            p.pool.PoolConfig.for_platform("accelerator", n_replicas=2, autoscale=False),
            cache=cache),
    }
    system = p.engine.ServingSystem(pools, p.router.make_router(router), slo_p99_s=0.2)
    arr = p.engine.poisson_arrivals(
        lambda t: 150.0, 4.0, seed=5,
        cost_mix=p.synthetic.bimodal_cost_mix(spread=0.25))
    p.engine.attach_zipf_ids(arr, 4096, 8, seed=6)
    return system.run(arr, until=6.0)


@pytest.mark.parametrize("router", ["size_aware", "cost_model", "cost_model_blind",
                                    "least_loaded"])
def test_two_pool_system_with_caches_under_bimodal_traffic(router):
    res = _same_in_both(_two_pools, router)
    assert res["completed"] > 0 and res["cache"]["hits"] > 0


def _cascade(p):
    pools = {
        "baseline": p.engine.PoolSpec(
            p.replica.ReplicaSpec("baseline", p.replica.LatencyModel.analytic(0.02, 1e-3),
                                  cold_start_s=5.0, warm_start_s=0.2),
            p.pool.PoolConfig(n_replicas=2, max_batch=4, priority_bypass=False)),
        "distilled": p.engine.PoolSpec(
            p.replica.ReplicaSpec("distilled", p.replica.LatencyModel.analytic(0.004, 5e-5),
                                  cold_start_s=5.0, warm_start_s=0.2),
            p.pool.PoolConfig(n_replicas=2, max_batch=4, priority_bypass=False)),
    }
    system = p.engine.ServingSystem(
        pools, cascade=p.cascade.CascadeConfig("distilled", "baseline", candidates=256,
                                               rerank_k=16), slo_p99_s=1.0)
    arr = p.engine.poisson_arrivals(lambda t: 40.0, 5.0, seed=9, priority_frac=0.0)
    return system.run(arr, until=8.0)


def test_cascade():
    res = _same_in_both(_cascade)
    assert res["completed"] > 0


def _federation(p, invalidation):
    """Two cells over one sharded table, a shared L2 each, Zipf-hot row
    updates published while they serve."""
    shard = p.shard.EmbeddingShardService(16, ("a", "b"), invalidation=invalidation)
    cache = p.cache.CacheConfig(128, l2=p.cache.CacheConfig(1024))
    cfg = p.pool.PoolConfig(n_replicas=2, autoscale=False, priority_bypass=False)
    spec = lambda name: p.replica.ReplicaSpec(  # noqa: E731
        name, p.replica.LatencyModel.analytic(0.02, 1e-3), cold_start_s=5.0, warm_start_s=0.2)
    cells = {name: p.federation.CellSpec({"p": p.engine.PoolSpec(spec(f"p{name}"), cfg,
                                                                 cache=cache)})
             for name in ("a", "b")}
    fed = p.federation.FederatedSystem(cells, "sticky", rtt_s=0.004, rtt={("a", "b"): 0.004},
                                       shard=shard)
    arr = p.engine.attach_zipf_ids(
        p.engine.poisson_arrivals(lambda t: 300.0, 4.0, seed=11), 8192, 16, seed=11)
    p.federation.assign_homes(arr, {"a": 0.5, "b": 0.5}, seed=11)
    fed.loop.add_stream("shard_update",
                        p.synthetic.update_event_stream(8.0, 4.0, 8192, 32, seed=12))
    return fed.run(arr, until=6.0)


@pytest.mark.parametrize("invalidation", [True, False])
def test_federation_with_the_shard_tier_and_updates(invalidation):
    res = _same_in_both(_federation, invalidation)
    assert res["completed"] > 0 and res["shard"]["publishes"] > 0
    assert res["shard"]["remote_fetches"] > 0


@pytest.mark.parametrize("args", [(1000, 500, 1.1, 3), (64, 1, 0.8, 0), (5000, 20_000, 1.3, 7)])
def test_zipf_id_stream_is_the_same(args):
    n, vocab, alpha, seed = args
    ref, port = (_pkg(name).synthetic.zipf_id_stream(n, vocab, alpha, seed=seed)
                 for name in PACKAGES)
    assert port.dtype == ref.dtype and np.array_equal(port, ref)


@pytest.mark.parametrize("args", [(5.0, 6.0, 4096, 16, 4), (50.0, 2.0, 100, 1, 0),
                                  (0.0, 2.0, 100, 4, 0)])
def test_update_event_stream_is_the_same(args):
    rate, horizon, vocab, rows, seed = args
    ref, port = (list(_pkg(name).synthetic.update_event_stream(rate, horizon, vocab, rows,
                                                                seed=seed))
                 for name in PACKAGES)
    assert port == ref
    assert (len(ref) > 0) == (rate > 0)


@pytest.mark.parametrize("kw", [{}, {"spread": 0.25}, {"spread": 0.25, "modes": 5},
                                {"rank_frac": 1.0}, {"rank_frac": 0.0, "point_cost": 4}])
def test_bimodal_cost_mix_is_the_same(kw):
    ref, port = (_pkg(name).synthetic.bimodal_cost_mix(**kw) for name in PACKAGES)
    assert port == ref
