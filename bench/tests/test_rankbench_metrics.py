"""The arithmetic of the metrics: latency and rate over all requests, the
trace's intervals, the needed flops and bytes, on the CPU."""
import numpy as np
import pytest
import torch

import tiny
from harness import stats, trace, traffic, work
from harness.spec import load_module

BENCH = tiny.BENCH


def test_outcome_counts_every_request_due_in_the_window_failures_included():
    offsets = np.array([0, 2, 5, 6, 8, 10])
    due = np.array([0.1, 0.2, 0.3, 0.9, 1.5])  # the last is due after the 1 s window
    done = np.array([0.15, np.nan, 0.5, 1.2, 1.6])  # the second never served
    scores = np.zeros(10, np.float32)
    scores[5] = np.nan  # the third request's only score is not finite
    out = stats.outcome(due, done, scores, offsets, 0, 1.0, gave_up=3.0)
    assert out.attempted == 4
    assert (out.unserved, out.nonfinite, out.failed) == (1, 1, 2)
    np.testing.assert_allclose(out.latency_s, [0.05, 2.8, 0.2, 0.3])
    # served whole and finite within the window: the first only (the fourth ends at 1.2)
    assert out.completed.tolist() == [True, False, False, False] and out.completed_cands == 2
    assert stats.percentile(out.latency_s, 50) == pytest.approx(0.25)


def test_p99_and_rate_readers():
    from harness.runner import Run
    lat = np.arange(1, 1001) / 1000.0
    out = stats.Outcome(1000, 0, 0, 0, lat, np.ones(1000, bool), 12345)
    run = Run(cell=None, seconds=5.0, setup_s=7.5, outcome=out, req=None, first=0, calls=[],
              device_trace=None, reference=None)
    read = lambda n: load_module(BENCH / "metrics" / f"{n}.py", f"m_{n}").read(run)  # noqa: E731
    assert read("p99_ms") == pytest.approx(np.percentile(lat, 99) * 1e3)
    assert read("cands_per_s") == pytest.approx(12345 / 5.0)
    assert read("setup_s") == 7.5
    for n in ("call_idle_share", "idle_share", "serve_mfu", "embedding_bag_roofline"):
        assert read(n) is None  # nothing to read without a trace


def test_union_overlap_and_idle_gaps():
    iv = np.array([[0.0, 1.0], [0.5, 2.0], [3.0, 4.0], [3.5, 3.6]])
    u = trace.union(iv)
    np.testing.assert_allclose(u, [[0.0, 2.0], [3.0, 4.0]])
    assert trace.overlap(u, np.array([[1.0, 3.5]])) == pytest.approx(1.5)
    assert trace.overlap(u, np.array([[2.0, 3.0]])) == 0.0
    # one call: waiting 0-1, assembling 1-2, serving 2-5, copying 5-6
    calls = [(0.0, 1.0, 2.0, 5.0, 6.0, 0, 1), (6.5, 6.5, 7.0, 8.0, 9.0, 1, 2)]
    busy = np.array([[2.5, 4.0], [5.5, 9.0]])
    gaps = trace.idle_gaps(busy, 0.0, 10.0, calls)
    assert gaps["assemble"] == pytest.approx(2.5)  # 0-2.5: its middle, 1.25, is in the assembly
    assert gaps["serve_enqueue"] == pytest.approx(1.5)  # 4.0-5.5
    assert gaps["outside_calls"] == pytest.approx(1.0)  # 9-10
    assert sum(gaps.values()) == pytest.approx(10.0 - 1.5 - 3.5)


def test_call_idle_share_and_idle_share_from_a_trace():
    from harness.runner import Run
    dev = trace.DeviceTrace(np.array([0.5, 2.5]), np.array([1.0, 3.0]), ["k", "embedding_bag_x"],
                            ["kernel", "kernel"])
    calls = [(0.0, 0.0, 0.0, 0.1, 2.0, 0, 1), (2.0, 2.0, 2.0, 2.1, 4.0, 1, 2)]
    run = Run(cell=None, seconds=4.0, setup_s=0.0, outcome=None, req=None, first=0, calls=calls,
              device_trace=dev, reference=None)
    read = lambda n: load_module(BENCH / "metrics" / f"{n}.py", f"m2_{n}").read(run)  # noqa: E731
    assert read("idle_share") == pytest.approx(75.0)
    assert read("call_idle_share") == pytest.approx(75.0)
    assert read("host_ms_per_call") == pytest.approx(100.0)


def _ssa_model():
    return tiny.load_cell("ssa.rank.bulk").model


def _din_model():
    return tiny.load_cell("din.rank.bulk").model


def test_taobao_ssa_needed_flops_by_hand():
    m = _ssa_model()
    ref = load_module(BENCH / "configs" / "taobao_ssa.py", "ref_ssa")
    d, h = 64, 100
    per_layer = 3 * 2 * h * d * d + 2 * h * d * d + 2 * 2 * h * d * 4 * d + 2 * h * h * d * 2
    tower = 2 * (208 * 200 + 200 * 80 + 80 * 1)
    assert ref.dot_flops(m, np.array([100]), np.array([1])) == 2 * per_layer + tower
    assert 2 * per_layer + tower == pytest.approx(24.9e6, rel=2e-3)  # 24.9 MFLOP a row today
    # a request's candidates share its history: 50 candidates add 49 towers, not encoders
    one = ref.dot_flops(m, np.array([40]), np.array([1]))
    fifty = ref.dot_flops(m, np.array([40]), np.array([50]))
    assert fifty - one == 49 * tower
    # past the sequence length nothing more is needed
    assert ref.dot_flops(m, np.array([130]), np.array([1])) == ref.dot_flops(m, np.array([100]),
                                                                             np.array([1]))


def test_din_needed_flops_by_hand():
    m = _din_model()
    ref = load_module(BENCH / "configs" / "din.py", "ref_din")
    h, du = 60, 36
    att = 2 * h * (144 * 80 + 80 * 40 + 40 * 1) + 2 * h * du
    tower = 2 * (90 * 200 + 200 * 80 + 80 * 1)
    assert ref.dot_flops(m, np.array([60]), np.array([7])) == 7 * (att + tower)


@pytest.mark.parametrize("name", ["ssa.rank.steady", "din.rank.bulk"])
def test_needed_flops_match_the_dry_run_counter(name):
    """At full histories and one candidate a request, what a row needs is
    what the program executes: the configuration's dot flops equal the
    dry run's counter (`repro_torch.launch.hlo_stats`) over `api.serve`."""
    from repro_torch.launch.hlo_stats import count
    from repro_torch.models.recsys import api
    from harness.model import make_weights, program_config

    cell = tiny.tiny_cell(name)
    cell.traffic["hist_len"] = [tiny.L, tiny.L]
    cfg = program_config(cell.model, exact=False)
    params = make_weights(cfg, 5, "cpu")
    r = traffic.generate(cell.traffic, cell.model, 9, 5, "cpu")
    from harness.server import Server
    batch = Server(api, params, cfg, r, 10**6).batch(0, 9)
    # one candidate a request: keep each request's first row
    first = torch.as_tensor(r.offsets[:-1])
    batch = {k: v[first] for k, v in batch.items()}
    _, st, _ = count(lambda p, b: api.serve(p, b, cfg), (params, batch))
    ref = cell.reference()
    assert st["flops"] == ref.dot_flops(cell.model, np.full(9, tiny.L), np.ones(9))


def test_lookup_bytes_by_hand():
    """Two calls over tiny requests: the bytes counted from the rule."""
    cell = tiny.tiny_cell("din.rank.bulk")
    m = cell.model
    r = traffic.generate(cell.traffic, m, 6, 11, "cpu")
    calls = [(0, 0, 0, 0, 0, 0, 2), (0, 0, 0, 0, 0, 2, 6)]
    got = work.lookup_bytes(m, r, calls)
    d = m["embed_dim"]
    ids = outputs = 0
    rows = {"item": 0, "category": 0, "user": 0}
    for (*_, a, b) in calls:
        seen = {"item": set(), "category": set(), "user": set()}
        for q in range(a, b):
            h = int(r.hist_len[q])
            seen["user"].add(int(r.user[q]))
            seen["item"] |= set(r.hist_item[q, :h].tolist())
            seen["category"] |= set(r.hist_category[q, :h].tolist())
            c0, c1 = r.offsets[q], r.offsets[q + 1]
            seen["item"] |= set(r.item[c0:c1].tolist())
            seen["category"] |= set(r.category[c0:c1].tolist())
            n = int(c1 - c0)
            ids += 4 * (1 + 2 * h + 2 * n)
            outputs += 4 * d * (1 + 2 * h + 2 * n)
        for t in rows:
            rows[t] += len(seen[t])
    want_rows = 4 * d * sum(rows.values())
    assert got["ids"] == ids and got["outputs"] == outputs and got["rows"] == want_rows
    assert got["total"] == ids + outputs + want_rows
