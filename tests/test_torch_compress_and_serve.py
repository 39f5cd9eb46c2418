"""The port's end-to-end pipeline (`repro_torch.launch.compress_and_serve`),
on the CPU.

- A tiny run (2 training steps, vocabularies of 300, one step a ladder
  stage, sizes 1 and 8, horizons of a few simulated seconds) passes through
  all four stages: train, ladder, serve (five variants), cache (the cached
  lookup bitwise the uncached one; the cache-serving rows).
- A deviation from `repro`: without `ckpt_dir` each run checkpoints into a
  fresh temporary directory, removed when it ends, so two default runs at
  different vocabularies share nothing (`repro`'s example uses one fixed
  directory, whose second run restores the first's step and tables); in
  one directory given twice, the second run at another vocabulary is
  refused by `restore`, where `repro` took the old tables.
- Stage 4(b) gives JSON-equal numbers to `repro`'s loop
  (`examples/compress_and_serve.py`, stage 4(b)) on the same analytic
  curve: the simulator is deterministic, so no tolerance.
"""
import json
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)
from repro.core.serving.cache import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.core.serving import engine as jax_engine  # noqa: E402
from repro.core.serving.pool import PoolConfig as JaxPoolConfig  # noqa: E402
from repro.core.serving import replica as jax_replica  # noqa: E402
from repro.data.synthetic import zipf_id_stream as jax_zipf_id_stream  # noqa: E402
from repro_torch.core.compression_loop import LadderConfig  # noqa: E402
from repro_torch.core.serving.replica import LatencyModel  # noqa: E402
from repro_torch.data.synthetic import zipf_id_stream  # noqa: E402
from repro_torch.launch import compress_and_serve as cs  # noqa: E402
from repro_torch.models.recsys.embedding import _pad_rows  # noqa: E402

VARIANTS = ["baseline", "quantized", "pruned", "pruned_quantized", "distilled"]


def test_a_tiny_run_passes_through_all_four_stages(tmp_path):
    recs = cs.run(steps=2, batch=16, device="cpu", ckpt_dir=str(tmp_path), vocab=300,
                  ladder=LadderConfig(finetune_steps=1, qat_steps=1, distill_steps=1),
                  sizes=(1, 8), horizon=3.0, cache_horizon=2.0)
    stages = [r["stage"] for r in recs]
    assert stages == ["train", "ladder"] + ["serve"] * 5 + ["cache_exact", "cache_serving"]
    train, ladder, *served, exact, cache = recs
    assert train["steps"] == 2 and train["restarts"] == 0 and np.isfinite(train["losses"]).all()
    assert list(ladder["variant_stats"]) == VARIANTS
    assert 0.3 < ladder["variant_stats"]["pruned"]["sparsity"] < 0.5
    assert [r["variant"] for r in served] == VARIANTS
    for r in served:
        assert r["curve"]["sizes"] == [1.0, 8.0] and all(s > 0 for s in r["curve"]["seconds"])
        assert r["throughput"] > 0 and r["p99_ms"] >= r["p50_ms"] > 0
    assert exact["exact"] and exact["lookups"] == 4096 and exact["resident_rows"] == 512
    assert 0 < exact["resident_share"] <= 1
    assert [row["cache"] for row in cache["rows"]] == ["none", "lru_warm"]
    assert cache["rows"][0]["hit_rate"] == 0.0 < cache["rows"][1]["hit_rate"]
    assert json.dumps(recs)  # every record is JSON


def test_a_second_run_in_the_same_directory_restores_and_trains_no_step(tmp_path):
    kw = dict(batch=8, device="cpu", ckpt_dir=str(tmp_path), vocab=300,
              ladder=LadderConfig(finetune_steps=1, qat_steps=1, distill_steps=1),
              sizes=(1,), horizon=1.0, cache_horizon=1.0)
    first = cs.run(steps=100, **kw)[0]  # the example checkpoints every 100 steps
    again = cs.run(steps=100, **kw)[0]
    assert (first["restarts"], again["restarts"], again["losses"]) == (0, 1, [])


def test_two_default_runs_at_different_vocabularies_share_no_checkpoint(tmp_path, monkeypatch):
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    dirs = []

    class Spy(cs.ResilientTrainer):
        def __init__(self, train_step, cfg, **kw):
            dirs.append(cfg.ckpt_dir)
            super().__init__(train_step, cfg, **kw)

    monkeypatch.setattr(cs, "ResilientTrainer", Spy)
    kw = dict(steps=100, batch=8, device="cpu", sizes=(1,), horizon=1.0, cache_horizon=1.0,
              ladder=LadderConfig(finetune_steps=1, qat_steps=1, distill_steps=1))
    runs = [cs.run(vocab=v, **kw)[0] for v in (300, 600)]  # the example checkpoints every 100
    assert [(r["steps"], r["restarts"], len(r["losses"])) for r in runs] == [(100, 0, 100)] * 2
    assert len(set(dirs)) == 2 and all(d.startswith(str(scratch)) for d in dirs)
    assert list(scratch.iterdir()) == []  # each run removed its own
    with pytest.raises(ValueError, match="tables/"):  # one directory given twice
        for v in (300, 600):  # tables of 512 and 1,024 padded rows
            cs.run(vocab=v, ckpt_dir=str(tmp_path / "shared"), **kw)


def _repro_cache_loop(baseline_lat, vocab, stream, horizon):
    """`examples/compress_and_serve.py` stage 4(b), statement for statement,
    on `repro`'s simulator, returning what it prints."""
    ids_per_req = 16
    spec = jax_replica.ReplicaSpec("baseline", baseline_lat, cold_start_s=5.0,
                                   warm_start_s=0.2,
                                   embed_fetch_s=2.0 * baseline_lat(32) / (32 * ids_per_req))
    wait = 0.02
    r_cold = jax_replica.sustainable_rate(spec, 2, wait, ids_per_req, hit_rate=0.0)
    r_warm = jax_replica.sustainable_rate(spec, 2, wait, ids_per_req, hit_rate=0.85)
    rate = min(1.2 * r_cold, 0.9 * r_warm)
    rows = []
    for label, cache in (("none", None), ("lru_warm", JaxCacheConfig(4096, "lru"))):
        sys_ = jax_engine.ServingSystem(
            {"baseline": jax_engine.PoolSpec(
                spec, JaxPoolConfig(n_replicas=2, autoscale=False,
                                    max_batch=32, max_wait_s=wait),
                cache=cache)},
            slo_p99_s=0.15, adaptive_shedding=False)
        if cache is not None:
            sys_.pools["baseline"].embed_cache.warm(stream)
        arr = jax_engine.poisson_arrivals(lambda t: rate, horizon, seed=12, priority_frac=0.0)
        jax_engine.attach_zipf_ids(arr, vocab, ids_per_req, alpha=1.1, seed=13)
        res = sys_.run(arr, until=horizon)
        rows.append({"cache": label, "hit_rate": res["cache"]["hit_rate"],
                     "p50_ms": res["p50"] * 1e3, "p99_ms": res["p99"] * 1e3,
                     "throughput": res["throughput"]})
    return {"offered_rate": rate, "cold_rate": r_cold, "warm_rate": r_warm, "rows": rows}


# a taobao_ssa-like curve (16,000 requests/s offered: a simulated second)
# and a DIEN-like one whose base fills half the batching window
@pytest.mark.parametrize("base_ms,per_item_us,horizon", [(2.2, 1.2, 1.0), (20.0, 10.0, 4.0)])
def test_cache_serving_equals_repros_loop_on_an_analytic_curve(base_ms, per_item_us, horizon):
    vocab = _pad_rows(50_000)  # the example's item table, padded rows included
    stream = zipf_id_stream(40_000, vocab, 1.1, seed=11)
    np.testing.assert_array_equal(stream, jax_zipf_id_stream(40_000, vocab, 1.1, seed=11))
    ours = cs.cache_serving(LatencyModel.analytic(base_ms * 1e-3, per_item_us * 1e-6),
                            vocab, stream, horizon=horizon)
    ref = _repro_cache_loop(
        jax_replica.LatencyModel.analytic(base_ms * 1e-3, per_item_us * 1e-6), vocab, stream,
        horizon)
    assert json.dumps(ours, sort_keys=True) == json.dumps(ref, sort_keys=True)
    cold, warm = ours["rows"]
    assert warm["hit_rate"] > 0.5 and warm["p99_ms"] < cold["p99_ms"]


def test_main_passes_its_flags_and_prints_one_json_line_a_record(monkeypatch, capsys):
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return [{"stage": "train", "steps": 0}, {"stage": "ladder"}]

    monkeypatch.setattr(cs, "run", fake_run)
    cs.main(["--steps", "7", "--batch", "32", "--device", "cpu", "--ckpt-dir", "/x"])
    assert seen == {"steps": 7, "batch": 32, "device": "cpu", "ckpt_dir": "/x"}
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["stage"] for x in lines] == ["train", "ladder"]
