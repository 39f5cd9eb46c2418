"""The reader of the serve calls that replayed a captured CUDA graph
(`metrics/serve_replay_share.py`): the path each of the window's calls
took, from the program's root `serve` spans paired with the calls, on a
synthetic recording of mixed paths; None where the program's root span
records no path (a program without the graph path) or where the pairing
fails; then the program's real spans around a tiny run on the CPU, every
call eager. On the card (`-m cuda`) a traced run of a tiny cell replays
all but its first calls, and the spans still pair:

    PYTHONPATH=src python -m pytest -q -m cuda bench/tests/test_rankbench_replay.py
"""
import types

import numpy as np
import pytest
import torch

import tiny
from harness import runner, spans
from harness.spec import load_module

BENCH = tiny.BENCH
BASE_NS = 5_000_000_000_000


class FakeRecording:
    """The root spans of a recording: (of, rows) each, one call a span,
    1 ms apart, with a `lookup` child under each eager one."""

    def __init__(self, roots, dropped=0):
        self.names, ids, cols = [], {}, {c: [] for c in ("name", "parent", "items")}
        for of, rows in roots:
            spans_of_call = [("serve", of, -1, rows)]
            if of == "eager":
                spans_of_call.append(("lookup", "user", len(cols["name"]), rows))
            for name, what, parent, items in spans_of_call:
                ids.setdefault((name, what), len(self.names))
                if len(self.names) == ids[name, what]:
                    self.names.append((name, what))
                cols["name"].append(ids[name, what])
                cols["parent"].append(parent)
                cols["items"].append(items)
        self.cols = {c: np.asarray(v, np.int64) for c, v in cols.items()}
        self.dropped = dropped

    def column(self, name):
        return self.cols[name].copy()


def _run(rows_per_call):
    offsets = np.concatenate([[0], np.cumsum(rows_per_call)])
    calls = [(k * 1e-3, k * 1e-3, k * 1e-3, k * 1e-3 + 5e-4, k * 1e-3 + 6e-4, k, k + 1)
             for k in range(len(rows_per_call))]
    return runner.Run(cell=None, seconds=1.0, setup_s=0.0, outcome=None,
                      req=types.SimpleNamespace(offsets=offsets), first=0, calls=calls,
                      device_trace=None, reference=None)


def _reader():
    return load_module(BENCH / "metrics" / "serve_replay_share.py", "m_serve_replay_share")


def test_the_share_of_the_windows_calls_that_replayed():
    paths = ["eager", "capture"] + ["replay"] * 6 + ["eager", "replay"]
    rec = FakeRecording([(p, 3200) for p in paths])
    assert _reader().share(_run([3200] * 10), rec) == pytest.approx(70.0)
    # the drain's calls come after the window's: the first N pair
    assert _reader().share(_run([3200] * 4), rec) == pytest.approx(50.0)


def test_the_reader_reads_the_programs_newest_recording(monkeypatch):
    rec = FakeRecording([("replay", 50), ("replay", 100), ("eager", 50), ("replay", 50)])
    monkeypatch.setattr(spans, "recording", lambda: rec)
    assert _reader().read(_run([50, 100, 50, 50])) == pytest.approx(75.0)


@pytest.mark.parametrize("fault", ["no_path", "no_recording", "dropped", "too_few_serve_spans",
                                   "rows_differ", "no_calls"])
def test_nothing_is_read_where_the_paths_cannot_be_paired(fault):
    roots = [("replay", 3200)] * 4
    run, rec = _run([3200] * 4), FakeRecording(roots)
    assert _reader().share(run, rec) == pytest.approx(100.0)
    if fault == "no_path":  # the root span of a program without the graph path
        rec = FakeRecording([("", 3200)] * 4)
    elif fault == "no_recording":
        rec = None
    elif fault == "dropped":
        rec = FakeRecording(roots, dropped=1)
    elif fault == "too_few_serve_spans":
        rec = FakeRecording(roots[:3])
    elif fault == "rows_differ":
        run = _run([3200, 3200, 3150, 3200])
    elif fault == "no_calls":
        run = _run([])
    assert _reader().share(run, rec) is None


def test_a_tiny_run_on_the_cpu_is_all_eager():
    """The program's own spans, recorded under the CPU profiler around six
    calls of one signature: CPU tensors never take the graph path."""
    from torch.profiler import ProfilerActivity, profile

    from harness.model import make_weights, program_config
    from harness.server import Server
    from repro_torch.core import spans as program_spans
    from repro_torch.models.recsys import api

    cell = tiny.tiny_cell("din.rank.bulk")
    cfg = program_config(cell.model, exact=False)
    params = make_weights(cfg, 5, "cpu")
    req = cell.generate()(cell.traffic, cell.model, 4000, 5, "cpu")
    server = Server(api, params, cfg, req, int(cell.traffic["max_rows"]))
    server.call(0.0, 0.0, 0, 1)  # unprofiled: the next profiled call starts a recording
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(1, 7):
            server.call(0.0, 0.0, k, k + 1)
    run = runner.Run(cell, 1.0, 0.0, None, req, 1, server.calls[1:], None, None)
    assert _reader().share(run, program_spans.recording()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["din.rank.bulk", "ssa.rank.bulk"])
def test_a_traced_run_replays_and_its_spans_still_pair_on_card(name, monkeypatch):
    """A traced tiny run on the card: every call of the window replays (its
    one signature was captured in the warm-up, outside the profiler), the
    readers of the idle share by layer still read values, and each traced
    call runs the eager call's five lookups: `embedding_bag` kernels on the
    device trace, five for each root `serve` span of the recording (the
    kernel wrapper's own count reads no replay). The profiler has been seen
    to keep no record of a few whole calls (11 of 1,147 once, 0 of 1,369
    in another run), so the trace's count is held to whole calls, and to
    all but 2% of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: run `PYTHONPATH=src python -m pytest -m cuda bench/tests`")
    from repro_torch.models.recsys import serve_graph
    from repro_torch.core import spans as program_spans
    from harness import trace

    monkeypatch.setattr(serve_graph, "GRAPHS", serve_graph.Graphs())  # none of another run's
    traces = []
    read_trace = trace.Profiler.device_trace

    def kept(self, origin_ns):
        traces.append(read_trace(self, origin_ns))
        return traces[-1]

    monkeypatch.setattr(trace.Profiler, "device_trace", kept)
    cell = tiny.tiny_cell(name, provision=400_000.0)  # replays outrun the tiny default
    r = runner.run_cell(cell, 3_900_000_011, 1.0, True, "cuda", 0.0, exact=False)
    metrics = r["line"]["metrics"]
    config = {"din.rank.bulk": "din", "ssa.rank.bulk": "taobao_ssa"}[name]
    assert r["line"]["correct"] is True
    assert metrics[f"serve_replay_share.{config}"]["value"] >= 99.0
    for layer in ("lookup", "interaction", "tower"):
        assert f"{layer}_idle_share.{config}" in metrics
    rec = program_spans.recording()
    calls = sum(rec.names[n][0] == "serve" for n in rec.column("name"))
    lookups = sum("embedding_bag" in n for n in traces[0].names)
    assert calls > 0 and lookups % 5 == 0, (lookups, calls)
    assert 5 * (calls - calls // 50) <= lookups <= 5 * calls, (lookups, calls)
    torch.cuda.empty_cache()
