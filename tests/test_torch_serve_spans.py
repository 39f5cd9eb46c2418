"""The host spans inside `api.serve` (`repro_torch.core.spans`), for
taobao_ssa and DIN at tiny sizes.

Under torch's profiler one serve call records its span tree (the table in
the module's docstring: names, parents, nesting in time, items); with the
profiler off, or outside a serve call, nothing is recorded and the spans
leave no memory behind; the scores do not depend on it; a serve call that
finds the profiler turned on since the call before starts a new recording
(so each test makes one call unprofiled first); the export passes
`tools/check_trace`.
The card-only test (`-m cuda`) checks the switch under the CUDA-only
profiler that the benchmark runs, and that the exported spans fall
between each call's host stamps:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_serve_spans.py
"""
import dataclasses
import sys
import time
import tracemalloc
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.models.recsys import api  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.check_trace import check_trace  # noqa: E402

B, L, VOCAB = 5, 6, 300
ARCHS = ["taobao_ssa", "din"]

# (name, of, parent's row, items) of each span of one call, in the order
# they open; items in terms of the batch's rows B and history L
TREE = {
    "taobao_ssa": [("serve", "eager", -1, B), ("lookup", "user", 0, B), ("lookup", "item", 0, B),
                   ("lookup", "category", 0, B), ("interaction", "", 0, B * L),
                   ("lookup", "hist_item", 4, B * L), ("lookup", "hist_category", 4, B * L),
                   ("encoder_block", "", 4, B), ("encoder_block", "", 4, B),
                   ("mlp", "tower", 0, B)],
    "din": [("serve", "eager", -1, B), ("lookup", "user", 0, B), ("lookup", "hist_item", 0, B * L),
            ("lookup", "hist_category", 0, B * L), ("lookup", "item", 0, B),
            ("lookup", "category", 0, B), ("interaction", "", 0, B * L),
            ("mlp", "attn", 6, B), ("mlp", "tower", 0, B)],
}


def _world(arch, device="cpu"):
    cfg = get_config(arch)
    fields = tuple(dataclasses.replace(f, vocab=min(f.vocab, VOCAB),
                                       multi_hot=L if f.multi_hot > 1 else 1)
                   for f in cfg.fields)
    cfg = dataclasses.replace(cfg, fields=fields, seq_len=L)
    params = init_params(api.param_defs(cfg), torch.Generator().manual_seed(0), device)
    g = torch.Generator().manual_seed(1)
    batch = {"user": torch.randint(0, VOCAB, (B,), generator=g),
             "item": torch.randint(0, VOCAB, (B,), generator=g),
             "category": torch.randint(0, VOCAB, (B,), generator=g),
             "hist_item": torch.randint(0, VOCAB, (B, L), generator=g),
             "hist_category": torch.randint(0, VOCAB, (B, L), generator=g),
             "hist_len": torch.tensor([1, L, 3, 0, 2])}
    return cfg, params, {k: v.to(device) for k, v in batch.items()}


def _profiled(cfg, params, batch):
    """One serve call with the profiler off, so that the next profiled call
    starts a recording; then the profiler's context."""
    api.serve(params, batch, cfg)
    return profile(activities=[ProfilerActivity.CPU])


def _rows(rec):
    """The recording's rows: (name, of, parent, items, call, t0_ns, t1_ns)
    each."""
    cols = [rec.column(c) for c in ("name", "parent", "items", "call", "t0_ns", "t1_ns")]
    return [(*rec.names[n], int(p), int(i), int(c), int(a), int(b))
            for n, p, i, c, a, b in zip(*cols)]


def _check_tree(arch, rows, base):
    """`rows` are one call's spans, the first at row `base`: the table's
    tree, each span inside its parent and after its elder siblings."""
    want = [(n, of, p + base if p >= 0 else -1, items) for n, of, p, items in TREE[arch]]
    assert [r[:4] for r in rows] == want
    assert len({r[4] for r in rows}) == 1  # one call number
    for k, (_, _, p, _, _, t0, t1) in enumerate(rows):
        assert t0 <= t1
        if p >= 0:
            assert rows[p - base][5] <= t0 and t1 <= rows[p - base][6]
        elder = [r for r in rows[:k] if r[2] == p]
        if elder:
            assert elder[-1][6] <= t0


@pytest.mark.parametrize("arch", ARCHS)
def test_a_profiled_serve_call_records_its_span_tree(arch):
    cfg, params, batch = _world(arch)
    with _profiled(cfg, params, batch):
        api.serve(params, batch, cfg)
    rec = spans.recording()
    assert rec.calls == 1 and rec.dropped == 0 and len(rec) == len(TREE[arch])
    _check_tree(arch, _rows(rec), 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_nothing_is_recorded_with_the_profiler_off(arch):
    cfg, params, batch = _world(arch)
    before = spans.recording()
    n = len(before) if before is not None else 0
    api.serve(params, batch, cfg)
    assert spans.recording() is before
    assert (len(before) if before is not None else 0) == n


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_with_the_profiler_off_leave_no_memory_behind(arch):
    """With the profiler off a span is the shared no-op: 1,000 roots and
    spans hold no memory afterwards, and at most one transient object
    between them (the `with` statement's bound `__exit__`)."""
    _, _, batch = _world(arch)
    idx = batch["hist_item"]
    rounds = [None] * 1000

    def spin():
        for _ in rounds:
            with spans.serve(batch):
                with spans.span("lookup", idx, None, of="hist_item"):
                    pass

    spin()
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        now0, _ = tracemalloc.get_traced_memory()
        spin()
        now1, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert now1 == now0
    assert peak - now0 < 1024


@pytest.mark.parametrize("arch", ARCHS)
def test_scores_are_the_same_bits_with_the_profiler_on_and_off(arch):
    cfg, params, batch = _world(arch)
    off = api.serve(params, batch, cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        on = api.serve(params, batch, cfg)
    assert torch.equal(off, on)


@pytest.mark.parametrize("arch", ARCHS)
def test_turning_the_profiler_on_again_starts_a_new_recording(arch):
    cfg, params, batch = _world(arch)
    with _profiled(cfg, params, batch):
        api.serve(params, batch, cfg)
        api.serve(params, batch, cfg)
    first = spans.recording()
    assert first.calls == 2 and len(first) == 2 * len(TREE[arch])
    n = len(TREE[arch])
    _check_tree(arch, _rows(first)[n:], n)
    assert {r[4] for r in _rows(first)} == {0, 1}
    with _profiled(cfg, params, batch):
        api.serve(params, batch, cfg)
    second = spans.recording()
    assert second is not first
    assert second.calls == 1 and len(second) == n and len(first) == 2 * n
    # profiled again with no serve call between: the same recording goes on
    with profile(activities=[ProfilerActivity.CPU]):
        api.serve(params, batch, cfg)
    assert spans.recording() is second and second.calls == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_a_full_recording_counts_the_spans_it_drops(arch, monkeypatch):
    cfg, params, batch = _world(arch)
    n = len(TREE[arch])
    monkeypatch.setattr(spans, "LIMIT", n + 2)
    with _profiled(cfg, params, batch):
        api.serve(params, batch, cfg)
        api.serve(params, batch, cfg)
    rec = spans.recording()
    assert rec.calls == 2 and len(rec) == n + 2 and rec.dropped == n - 2
    _check_tree(arch, _rows(rec)[:n], 0)
    # the second call's first two spans kept, in their places
    assert [r[:3] for r in _rows(rec)[n:]] == [(name, of, p + n if p >= 0 else -1)
                                              for name, of, p, _ in TREE[arch][:2]]
    assert check_trace(rec.to_chrome_trace()) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_the_chrome_trace_export_passes_check_trace(arch):
    cfg, params, batch = _world(arch)
    with _profiled(cfg, params, batch):
        api.serve(params, batch, cfg)
        api.serve(params, batch, cfg)
    rec = spans.recording()
    doc = rec.to_chrome_trace()
    assert check_trace(doc) == []
    xs = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    assert len(xs) == 2 * len(TREE[arch])
    assert xs[0]["name"] == "serve eager"
    assert xs[0]["args"] == {"call": 0, "items": B, "of": "eager"}
    assert xs[1]["name"] == "lookup user" and xs[1]["args"]["of"] == "user"
    # on the wall clock: within a minute of now
    assert abs(xs[-1]["ts"] / 1e6 - time.time()) < 60
    base = int(xs[0]["ts"] * 1e3) - 10**6
    assert check_trace(rec.to_chrome_trace(base)) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_a_call_outside_serve_records_nothing(arch):
    cfg, params, batch = _world(arch)
    batch = dict(batch, label=torch.ones(B))
    serve_batch = {k: v for k, v in batch.items() if k != "label"}
    api.serve(params, serve_batch, cfg)
    before = spans.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        api.loss(params, batch, cfg)
    assert spans.recording() is before
    with _profiled(cfg, params, serve_batch):
        api.loss(params, batch, cfg)
        api.serve(params, serve_batch, cfg)
        api.loss(params, batch, cfg)
    rec = spans.recording()
    assert rec is not before and rec.calls == 1 and len(rec) == len(TREE[arch])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_spans_under_the_cuda_profiler_fall_between_the_calls_stamps_on_card(arch,
                                                                          cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, batch = _world(arch, cuda_device)
    api.serve(params, batch, cfg)
    torch.cuda.synchronize()
    stamps = []
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd.profiler._is_profiler_enabled
        for _ in range(4):
            a = time.time_ns()
            api.serve(params, batch, cfg)
            stamps.append((a, time.time_ns()))
        torch.cuda.synchronize()
    rec = spans.recording()
    n = len(TREE[arch])
    assert rec.calls == 4 and len(rec) == 4 * n and rec.dropped == 0
    for c in range(4):
        _check_tree(arch, _rows(rec)[c * n:(c + 1) * n], c * n)
    base = stamps[0][0]
    doc = rec.to_chrome_trace(base)
    assert check_trace(doc) == []
    tol_us = 5.0  # the wall clock's offset is read to about a microsecond
    for ev in (e for e in doc["traceEvents"] if e["ph"] == "X"):
        a, b = stamps[ev["args"]["call"]]
        assert (a - base) / 1e3 - tol_us <= ev["ts"]
        assert ev["ts"] + ev["dur"] <= (b - base) / 1e3 + tol_us
