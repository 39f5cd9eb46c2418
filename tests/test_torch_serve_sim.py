"""The launcher's stages 5–6: each variant's serve call calibrated into a
`LatencyModel` and served by the elastic engine under a traffic profile,
against `repro.launch.serve`'s loop on the CPU."""
import dataclasses
import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.serving.replica import LatencyModel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

SIX = {"p50_ms", "p99_ms", "throughput", "rejected", "latency_1", "latency_512"}
# a curve shaped like a taobao_ssa serve call on the card, seconds
SIZES, TIMES = (1, 8, 32, 128, 512), (1.3e-3, 1.35e-3, 1.4e-3, 1.8e-3, 2.3e-3)


def _tiny(arch="taobao_ssa"):
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, 300)) for f in cfg.fields),
        seq_len=12,
    )


def _repro_loop(name, sizes, times, profile, horizon):
    """`repro/launch/serve.py`'s engine loop, built from `repro`'s own parts."""
    from repro.core.serving.engine import ElasticEngine, EngineConfig, poisson_arrivals
    from repro.core.serving.rate_limiter import TierPolicy
    from repro.core.serving.replica import LatencyModel as RefLatencyModel, ReplicaSpec
    from repro.launch.serve import PROFILES

    lat = RefLatencyModel(np.asarray(sizes, np.float64), np.asarray(times))
    spec = ReplicaSpec(name, lat, cold_start_s=5.0, warm_start_s=0.2)
    eng = ElasticEngine(
        spec,
        EngineConfig(n_replicas=2, autoscale=True, slo_p99_s=0.1),
        tiers={"tier0": TierPolicy(2000, 200), "tier1": TierPolicy(2000, 200)},
    )
    res = eng.run(poisson_arrivals(PROFILES[profile], horizon, seed=0), until=horizon)
    return {"p50_ms": res["p50"] * 1e3, "p99_ms": res["p99"] * 1e3,
            "throughput": res["throughput"], "rejected": res["rejected"],
            "latency_1": lat(1) * 1e3, "latency_512": lat(512) * 1e3}


@pytest.mark.parametrize("profile", ["ramp", "spike", "steady"])
def test_simulate_is_repros_launcher_loop(profile):
    lat = LatencyModel(np.asarray(SIZES, np.float64), np.asarray(TIMES))
    got = serve.simulate("baseline", lat, profile, 16.0)
    want = _repro_loop("baseline", SIZES, TIMES, profile, 16.0)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert set(got) == SIX and got["throughput"] > 0


def test_profiles_are_repros():
    from repro.launch.serve import PROFILES

    assert sorted(serve.PROFILES) == sorted(PROFILES)
    for name, fn in serve.PROFILES.items():
        for t in np.linspace(0.0, 60.0, 241):
            assert fn(t) == PROFILES[name](t), (name, t)


def test_run_with_a_profile_serves_each_variant():
    recs = serve.run(_tiny(), variants=("baseline", "quantized"), device="cpu", reps=10,
                     profile="spike", horizon=5.0)
    served = [r for r in recs if "serving" in r]
    assert [r["variant"] for r in served] == ["baseline", "quantized"]
    timed = [r for r in recs if "size" in r]
    assert [(r["variant"], r["size"]) for r in timed] == [
        (v, n) for v in ("baseline", "quantized") for n in serve.SIZES]
    for r in served:
        assert r["arch"] == "taobao_ssa" and set(r["serving"]) == SIX
        assert all(math.isfinite(x) for x in r["serving"].values())
        assert r["serving"]["throughput"] > 0
        lat = serve.curve_from_record(r["curve"])
        assert r["curve"]["sizes"] == list(map(float, serve.SIZES))
        assert all(t > 0 for t in r["curve"]["seconds"])
        assert r["serving"]["latency_512"] == lat(512) * 1e3
        json.dumps(r)


def test_curve_record_round_trips_exactly():
    lat = LatencyModel(np.asarray(SIZES, np.float64), np.asarray(TIMES) / 3.0)
    back = serve.curve_from_record(json.loads(json.dumps(serve.curve_record(lat))))
    assert np.array_equal(back.sizes, lat.sizes) and np.array_equal(back.times, lat.times)
    assert back.times.dtype == lat.times.dtype


def test_latency_model_times_512_requests_at_512(monkeypatch):
    """The 512 point is a call of 512 requests, one draw of 512 cut to each
    size (`repro`'s launcher cuts every size from a batch of 256)."""
    cfg = _tiny()
    batches = serve.request_batches(cfg, serve.SIZES, torch.device("cpu"))
    seen = []

    def fake_serve(params, batch, cfg):
        seen.append({k: v.shape[0] for k, v in batch.items()})
        return torch.zeros(1)

    monkeypatch.setattr(serve.rec_api, "serve", fake_serve)
    lat = serve.latency_model({}, cfg, batches, reps=10)
    assert lat.sizes.tolist() == list(map(float, serve.SIZES))
    assert len(seen) == (1 + 10) * len(serve.SIZES)  # a warm call and the timed ones
    at = [s for s in seen if max(s.values()) == 512]
    assert len(at) == 11 and all(set(s.values()) == {512} for s in at)
    assert [max(s.values()) for s in seen[::11]] == list(serve.SIZES)


def test_run_refuses_an_unknown_profile():
    with pytest.raises(ValueError, match="unknown profile"):
        serve.run(_tiny(), variants=("baseline",), device="cpu", profile="burst")


def test_cli_rejects_an_unknown_profile_as_repros_does(monkeypatch, capsys):
    with pytest.raises(SystemExit) as port:
        serve.main(["--profile", "burst", "--device", "cpu"])
    assert port.value.code == 2 and "invalid choice: 'burst'" in capsys.readouterr().err
    from repro.launch import serve as ref_serve

    monkeypatch.setattr(sys, "argv", ["serve", "--profile", "burst"])
    with pytest.raises(SystemExit) as ref:
        ref_serve.main()
    assert ref.value.code == 2 and "invalid choice: 'burst'" in capsys.readouterr().err


def test_cli_prints_repros_lines_and_the_serving_json(monkeypatch, capsys):
    """`main` at a tiny FM (no ladder): the timed records, one `repro`-style
    line per variant, then `{"serving": ...}` with no "stats"."""
    monkeypatch.setattr(serve, "get_config", _tiny)
    serve.main(["--arch", "fm", "--device", "cpu", "--sizes", "1,8,32", "--horizon", "3",
                "--profile", "steady"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    start = lines.index("{")  # the last object, printed with an indent
    records = [json.loads(x) for x in lines if x.startswith('{"arch"')]
    assert [(r["variant"], r["size"]) for r in records] == [
        (v, n) for v in ("baseline", "quantized") for n in (1, 8, 32)]
    sim = [x for x in lines[:start] if not x.startswith("{")]
    assert [x.split()[0] for x in sim] == ["baseline", "quantized"]
    assert all("p50=" in x and "p99=" in x and "thpt=" in x and "svc(512)=" in x for x in sim)
    final = json.loads("\n".join(lines[start:]))
    assert set(final) == {"serving"} and set(final["serving"]) == {"baseline", "quantized"}
    for r in final["serving"].values():
        assert set(r) == SIX and r["throughput"] > 0
