"""The program's spans laid on the window (`harness.spans`) and the three
readers of the idle share by layer: the pairing of the program's `serve`
spans with the server's calls, the offset, each idle gap put down to the
innermost span, what reads nothing, and the identity with the harness's
own `serve_enqueue` where the `serve` spans fill [t2, t3]; then the same
on the CPU with the program's real spans around a tiny run."""
import sys
import types

import numpy as np
import pytest

import tiny
from harness import spans, trace
from harness.runner import Run
from harness.spec import load_module

BENCH = tiny.BENCH
READERS = {"lookup": "lookup_idle_share", "interaction": "interaction_idle_share",
           "tower": "tower_idle_share"}
BASE_NS = 7_000_000_000_000  # the program's clock at the window's start
DELAY_S = 3e-6  # from the server's t2 to the program's serve span


class FakeRecording:
    """What `repro_torch.core.spans.Recording` gives a reader: interned
    (name, of) pairs, columns, drops."""

    def __init__(self, rows, dropped=0):
        self.names, ids = [], {}
        cols = {c: [] for c in ("name", "call", "parent", "t0_ns", "t1_ns", "items")}
        for name, of, call, parent, t0, t1, items in rows:
            if (name, of) not in ids:
                ids[name, of] = len(self.names)
                self.names.append((name, of))
            for c, v in zip(cols, (ids[name, of], call, parent, t0, t1, items)):
                cols[c].append(v)
        self.cols = {c: np.asarray(v, np.int64) for c, v in cols.items()}
        self.dropped = dropped

    def column(self, name):
        return self.cols[name].copy()


def _ns(s):
    return BASE_NS + int(round(s * 1e9))


def _din_call(rows, call, first_row, t2, t3, delay=DELAY_S):
    """One DIN call's spans: serve from t2 + delay to t3 - 1 us, five
    lookups of 10 us each from its start, then the interaction (with its
    `attn` MLP in its second half) and the tower."""
    s0, s1 = t2 + delay, t3 - 1e-6
    out = [("serve", "", call, -1, _ns(s0), _ns(s1), rows)]
    t = s0 + 1e-6
    for f in ("user", "hist_item", "hist_category", "item", "category"):
        out.append(("lookup", f, call, first_row, _ns(t), _ns(t + 10e-6), rows))
        t += 11e-6
    span = (s1 - t) / 4
    out.append(("interaction", "", call, first_row, _ns(t), _ns(t + 2 * span), rows * 100))
    out.append(("mlp", "attn", call, first_row + 6, _ns(t + span), _ns(t + 2 * span), rows))
    out.append(("mlp", "tower", call, first_row, _ns(t + 2.5 * span), _ns(t + 3.5 * span), rows))
    return out


def _run(calls, rows_per_call, busy, seconds=1.0):
    """A Run of `calls` (t0..t4, first request, end request), one request
    a call of `rows_per_call` rows, and a device busy over `busy`."""
    offsets = np.concatenate([[0], np.cumsum(rows_per_call)])
    busy = np.asarray(busy, float).reshape(-1, 2)
    dev = trace.DeviceTrace(busy[:, 0], busy[:, 1], ["k"] * len(busy), ["kernel"] * len(busy))
    return Run(cell=None, seconds=seconds, setup_s=0.0, outcome=None,
               req=types.SimpleNamespace(offsets=offsets), first=0, calls=calls,
               device_trace=dev, reference=None)


def _world(n=4, rows=3200):
    """n DIN calls of `rows` rows in a 1 s window, call k's [t2, t3] =
    [k/4 + 0.01, k/4 + 0.21], and their spans (9 a call)."""
    calls, rec_rows = [], []
    for k in range(n):
        t0 = k * 0.25
        t2, t3 = t0 + 0.01, t0 + 0.21
        calls.append((t0, t0 + 0.005, t2, t3, t3 + 0.02, k, k + 1))
        rec_rows += _din_call(rows, k, len(rec_rows), t2, t3)
    return calls, rec_rows


def _gaps_around(points, width=2e-6, seconds=1.0):
    """Busy everywhere in [0, seconds] but a gap of `width` centred on each
    point."""
    edges = [0.0]
    for p in sorted(points):
        edges += [p - width / 2, p + width / 2]
    edges.append(seconds)
    return np.asarray(edges).reshape(-1, 2)


def _mid(row):
    return ((row[4] + row[5]) / 2 - BASE_NS) / 1e9 - DELAY_S


def test_pairing_offset_and_each_gap_goes_to_the_innermost_span():
    calls, rows = _world()
    # per call: a gap inside the second lookup, one in the interaction
    # before its MLP, one in the `attn` MLP, one in the tower, one in serve
    # between the lookups and the interaction, and one outside any span
    points = []
    for k in range(len(calls)):
        r = rows[9 * k:9 * (k + 1)]
        inter0 = (r[6][4] - BASE_NS) / 1e9 - DELAY_S
        points += [_mid(r[2]), inter0 + 1e-4, _mid(r[7]), _mid(r[8]),
                   inter0 - 0.5e-6, calls[k][2] - 0.004]
    run = _run(calls, [3200] * len(calls), _gaps_around(points))
    got = spans.split(run, FakeRecording(rows))
    w = 2e-6 * len(calls)
    assert got["lookup"] == pytest.approx(w)
    assert got["interaction"] == pytest.approx(2 * w)  # the interaction's own and its MLP's
    assert got["tower"] == pytest.approx(w)
    assert got["serve"] == pytest.approx(w)  # serve's own, between the layers
    # the gap outside every span is in none of them
    assert sum(got.values()) == pytest.approx(5 * w)


def test_the_window_starts_at_the_first_call_whatever_the_programs_clock():
    """A constant shift of the program's clock against the server's moves
    nothing: the offset is read from the pairs."""
    calls, rows = _world()
    shifted = [r[:4] + (r[4] + 123_456_789, r[5] + 123_456_789) + r[6:] for r in rows]
    points = [_mid(rows[9 * k + 3]) for k in range(len(calls))]
    run = _run(calls, [3200] * len(calls), _gaps_around(points))
    a = spans.split(run, FakeRecording(rows))
    b = spans.split(run, FakeRecording(shifted))
    assert a == b and a["lookup"] == pytest.approx(2e-6 * len(calls))


def test_the_recording_may_run_on_past_the_windows_calls():
    """The drain's calls come after the window's: the first N pair."""
    calls, rows = _world(n=4)
    run = _run(calls[:3], [3200] * 3, _gaps_around([_mid(rows[2])]))
    assert spans.split(run, FakeRecording(rows))["lookup"] == pytest.approx(2e-6)


@pytest.mark.parametrize("fault", ["no_recording", "dropped", "too_few_serve_spans",
                                   "rows_differ", "offsets_spread", "span_outside_its_call",
                                   "no_trace"])
def test_nothing_is_read_where_the_spans_cannot_be_laid_on_the_window(fault):
    calls, rows = _world()
    busy = _gaps_around([_mid(rows[2])])
    rec, run = FakeRecording(rows), _run(calls, [3200] * len(calls), busy)
    assert spans.split(run, rec) is not None
    if fault == "no_recording":
        rec = None
    elif fault == "dropped":
        rec = FakeRecording(rows, dropped=1)
    elif fault == "too_few_serve_spans":
        rec = FakeRecording(rows[:9 * 3])
    elif fault == "rows_differ":
        run = _run(calls, [3200, 3200, 3150, 3200], busy)
    elif fault == "offsets_spread":
        # two of four calls reach the program 60 us later than the others
        late = []
        for k in range(len(calls)):
            late += _din_call(3200, k, 9 * k, calls[k][2], calls[k][3],
                              DELAY_S + (60e-6 if k % 2 else 0.0))
        rec = FakeRecording(late)
    elif fault == "span_outside_its_call":
        # the second call's serve span ends 60 us after its t3
        r = rows[9]
        rec = FakeRecording(rows[:9] + [r[:5] + (_ns(calls[1][3] + 60e-6),) + r[6:]]
                            + rows[10:])
    elif fault == "no_trace":
        run.device_trace = None
    assert spans.split(run, rec) is None


def test_the_three_shares_and_serves_own_are_the_harness_serve_enqueue():
    """Where each `serve` span fills its call's [t2, t3], every idle gap
    the harness files under `serve_enqueue` goes to one of the four, and
    no other gap does: the sum is the harness's `serve_enqueue` to the bit
    of the arithmetic, at any busy pattern."""
    rng = np.random.default_rng(3)
    calls, rows = [], []
    for k in range(6):
        t0 = k * 0.15
        t2, t3 = t0 + 0.02, t0 + 0.02 + rng.uniform(0.05, 0.1)
        calls.append((t0, t0 + 0.01, t2, t3, t3 + 0.01, k, k + 1))
        call = _din_call(3200, k, len(rows), t2, t3, delay=0.0)
        call[0] = call[0][:5] + (_ns(t3),) + call[0][6:]  # serve ends at t3
        rows += call
    edges = np.sort(rng.uniform(0, 1.0, 40_000))
    busy = trace.union(edges.reshape(-1, 2))
    run = _run(calls, [3200] * 6, busy)
    got = spans.split(run, FakeRecording(rows))
    want = trace.idle_gaps(run.busy(), 0.0, 1.0, calls)["serve_enqueue"]
    assert min(got.values()) > 0
    assert sum(got.values()) == pytest.approx(want, rel=1e-9, abs=1e-9)


def test_the_readers_give_each_layers_share_of_the_window(monkeypatch):
    calls, rows = _world()
    points = [_mid(rows[9 * k + 2]) for k in range(len(calls))] + [_mid(rows[8])]
    run = _run(calls, [3200] * len(calls), _gaps_around(points, width=1e-3), seconds=1.0)
    monkeypatch.setattr(spans, "recording", lambda: FakeRecording(rows))
    got = {layer: load_module(BENCH / "metrics" / f"{m}.py", f"m_spans_{m}").read(run)
           for layer, m in READERS.items()}
    assert got == pytest.approx({"lookup": 0.4, "interaction": 0.0, "tower": 0.1})


def test_the_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    """The parent of the change that adds the program's spans: importing
    them fails, and each reader gives None without raising."""
    import repro_torch.core
    calls, rows = _world()
    monkeypatch.delattr(repro_torch.core, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    assert spans.recording() is None
    run = _run(calls, [3200] * len(calls), _gaps_around([0.5]))
    for m in READERS.values():
        assert load_module(BENCH / "metrics" / f"{m}.py", f"m_none_{m}").read(run) is None


@pytest.mark.parametrize("name", ["ssa.rank.bulk", "din.rank.bulk"])
def test_the_programs_own_spans_pair_with_a_tiny_runs_calls(name):
    """The program's real spans, recorded under the CPU profiler around a
    tiny closed loop, pair with the server's calls; over a device trace
    busy in short slivers, every share is found and the four together are
    the harness's `serve_enqueue` less the moments between t2 and the
    program's entry and between its return and t3."""
    from torch.profiler import ProfilerActivity, profile

    from harness import runner
    from harness.model import make_weights, program_config
    from harness.server import Server
    from repro_torch.core import spans as program_spans
    from repro_torch.models.recsys import api

    cell = tiny.tiny_cell(name)
    cfg = program_config(cell.model, exact=False)
    params = make_weights(cfg, 5, "cpu")
    req = cell.generate()(cell.traffic, cell.model, 4000, 5, "cpu")
    server = Server(api, params, cfg, req, int(cell.traffic["max_rows"]))
    server.call(0.0, 0.0, 0, 1)  # unprofiled: the next profiled call starts a recording
    seconds = 0.3
    with profile(activities=[ProfilerActivity.CPU]):
        server.closed_loop(8, 1, 4000, seconds, 1.0)
    calls = [c for c in server.calls[1:] if c[2] < seconds]
    rec = program_spans.recording()
    assert rec.calls >= len(calls) > 3
    starts = np.arange(0.0, seconds, 20e-6)
    busy = np.stack([starts, starts + 10e-6], axis=1)
    dev = trace.DeviceTrace(busy[:, 0], busy[:, 1], ["k"] * len(busy), ["kernel"] * len(busy))
    run = Run(cell, seconds, 0.0, None, req, 1, calls, dev, None)
    got = spans.split(run, rec)
    assert got is not None and min(got.values()) > 0
    enqueue = trace.idle_gaps(run.busy(), 0.0, seconds, calls)["serve_enqueue"]
    assert 0.9 * enqueue <= sum(got.values()) <= enqueue * (1 + 1e-9)
    assert [runner.c_rows(req, c) for c in calls] == \
        list(rec.column("items")[rec.column("parent") == -1][:len(calls)])
