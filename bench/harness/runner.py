"""One run of one cell: set-up, warm-up, the window, the check, the metrics.

In order: TF32 off (the configurations state f32); the program's kernels
built or loaded (`repro_torch.kernels._build`, into `build/repro_torch`
inside the checkout); the weights and the requests made on the device
from the seed; the cell's own shapes warmed up (a ladder of row counts,
then `warmup_s` of the cell's traffic on requests of their own, again
while a pass still makes the allocator take new device memory, up to
`WARM_PASSES`); the window of `seconds`, traced with `trace`; the
requests due in it served to the end; the peak memory read; the served
scores checked against the plain reference; the metrics read by their
readers; last, the modules loaded, looked at once all that is done.

`run_cell` is the whole run on any device; `bench/run.py` refuses a
machine without the card before it gets here, so a run on the CPU (the
tests') never prints a device metric.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import stats, trace as trace_mod, traffic as traffic_mod
from harness.model import program_config, sub_seed
from harness.server import Server, warm_shapes
from harness.spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_PASSES = 3  # passes of the warm traffic at most


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: Cell
    seconds: float
    setup_s: float
    outcome: stats.Outcome
    req: traffic_mod.Requests
    first: int  # the window's first request
    calls: List[tuple]  # the calls that began in the window
    device_trace: Optional[trace_mod.DeviceTrace]
    reference: object  # configs/<config>.py
    cache: Dict = dataclasses.field(default_factory=dict)

    def busy(self) -> Optional[np.ndarray]:
        """The device's busy intervals, clipped to the window."""
        if self.device_trace is None:
            return None
        if "busy" not in self.cache:
            self.cache["busy"] = trace_mod.clip(self.device_trace.busy_union(), 0.0, self.seconds)
        return self.cache["busy"]


def plan(cell: Cell, seconds: float, seed: int) -> Dict:
    """How many requests each phase takes, and the open loop's arrivals."""
    t = cell.traffic
    sizes = np.geomspace(1, t["max_rows"], 48)
    c = t["candidates"]
    out = {"shapes": int(np.sum(sizes) // (c if isinstance(c, int) else c[0])) + 48,
           "top_rows": int(t["max_rows"])}
    if t["loop"] == "open":
        rate = float(cell.params["rate_per_s"])
        arrivals = cell.arrivals()
        out["warm_arrivals"] = arrivals(rate, t["warmup_s"], sub_seed(seed, 4), t)
        out["arrivals"] = arrivals(rate, seconds, seed, t)
        out["warm"], out["window"] = len(out["warm_arrivals"]), len(out["arrivals"])
    else:
        per_s = float(cell.params["provision_per_s"])
        most = c if isinstance(c, int) else c[1]  # the loop never holds more rows
        out["top_rows"] = min(out["top_rows"], int(t["clients"]) * most)
        out["warm"] = int(per_s * t["warmup_s"]) + t["clients"]
        out["window"] = int(per_s * seconds) + t["clients"]
    return out


def serve_phase(server: Server, cell: Cell, first: int, n: int, seconds: float,
                arrival: Optional[np.ndarray], drain_s: float) -> int:
    t = cell.traffic
    if t["loop"] == "open":
        return server.open_loop(arrival, first, seconds, drain_s)
    return server.closed_loop(t["clients"], first, first + n, seconds, drain_s)


def sample(cell: Cell, req, done: np.ndarray, out: stats.Outcome, first: int,
           seed: int) -> np.ndarray:
    """The window's served requests whose scores are checked: a sample
    drawn from the seed, with the one of most candidates in it."""
    served = first + np.flatnonzero(np.isfinite(done[first:first + out.attempted]))
    rng = np.random.default_rng(sub_seed(seed, 5))
    k = min(len(served), int(cell.traffic["check_requests"]))
    chosen = rng.choice(served, size=k, replace=False) if k else served[:0]
    if len(served):
        big = served[np.lexsort((req.hist_len_host[served], req.ncand[served]))[-1]]
        chosen = np.unique(np.r_[chosen, big])
    return chosen


def rows_of(req, reqs: np.ndarray) -> np.ndarray:
    if not len(reqs):
        return np.zeros(0, np.int64)
    return np.concatenate([np.arange(req.offsets[i], req.offsets[i + 1]) for i in reqs])


def judge(cell: Cell, scores: np.ndarray, ref: Optional[torch.Tensor], rows: np.ndarray,
          out: stats.Outcome) -> Dict:
    """The numbers compared, each beside its limit, and `correct`: the
    scores at `rows` against the reference's there, and the window's
    requests left unserved or with scores that are not finite."""
    numbers = {"unserved": [float(out.unserved), 0.0], "nonfinite": [float(out.nonfinite), 0.0]}
    gap = float((torch.as_tensor(scores[rows]) - ref).abs().max()) if len(rows) else float("nan")
    numbers["score_gap"] = [gap, float(cell.model["check"]["score_gap"])]
    return {"numbers": numbers,
            "correct": all(v <= lim for v, lim in numbers.values())}  # a NaN gap fails


def check(cell: Cell, params, req, server: Server, out: stats.Outcome, first: int, seed: int,
          control: bool = False) -> Dict:
    """The served scores of the sampled requests against the plain
    reference, f32 with TF32 off. With `control`, the same judgement of
    the control: the reference computed with TF32 on, put in the served
    scores' place, which has to come out not correct."""
    chosen = sample(cell, req, server.done, out, first, seed)
    rows = rows_of(req, chosen)
    ref_mod = cell.reference()
    ref = low = None
    if len(chosen):
        with torch.no_grad():
            ref = ref_mod.scores(params, cell.model, req, chosen).to("cpu")
            if control:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                try:
                    low = ref_mod.scores(params, cell.model, req, chosen).to("cpu").numpy()
                finally:
                    disable_tf32()
    result = judge(cell, server.scores, ref, rows, out)
    result.update(sample_requests=int(len(chosen)), sample_rows=int(len(rows)))
    if control:
        in_place = server.scores.copy()
        if low is not None:
            in_place[rows] = low
        result["control"] = judge(cell, in_place, ref, rows, out)
    return result


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             api=None, exact: bool = True, control: bool = False) -> Dict:
    """One run; returns the result line's object and the earlier lines'."""
    if api is None:
        from repro_torch.models.recsys import api
    from repro_torch.kernels.embedding_bag import ops as eb_ops

    on_card = torch.device(device).type == "cuda"
    disable_tf32()
    marks = {}
    cfg = program_config(cell.model, exact)
    if on_card:
        from repro_torch.kernels import _build
        marks["build"] = _build.build_all()["seconds"]
    t = time.perf_counter()
    params = cell.make_weights()(cfg, seed, device)
    p = plan(cell, seconds, seed)
    n_total = p["shapes"] + WARM_PASSES * p["warm"] + p["window"]
    req = cell.generate()(cell.traffic, cell.model, n_total, seed, device)
    if on_card:
        torch.cuda.synchronize()
    marks["weights_and_requests"] = time.perf_counter() - t
    t = time.perf_counter()
    server = Server(api, params, cfg, req, int(cell.traffic["max_rows"]))
    warm_shapes(server, 0, p["shapes"], p["top_rows"])
    first = p["shapes"]
    for k in range(WARM_PASSES):
        segments = device_segments() if on_card else 0
        serve_phase(server, cell, first, p["warm"], float(cell.traffic["warmup_s"]),
                    p.get("warm_arrivals"), float(cell.traffic["drain_s"]))
        first += p["warm"]
        marks["warm_passes"] = k + 1
        if not on_card or device_segments() == segments:
            break
    marks["warm"] = time.perf_counter() - t
    server.calls.clear()
    launches0 = eb_ops.launches
    gc.collect()
    gc.freeze()  # what set-up made stays out of the collector's passes in the window
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        segments0 = device_segments()
    setup_s = time.perf_counter() - t_start

    with trace_mod.Profiler(traced and on_card) as prof:
        offset_ns = trace_mod.clock_offset_ns()
        serve_phase(server, cell, first, p["window"], seconds, p.get("arrivals"),
                    float(cell.traffic["drain_s"]))
        gave_up = server.now()
    origin_ns = int(round(server.t_origin * 1e9)) + offset_ns
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    if on_card:
        marks["device_mallocs_in_window"] = device_segments() - segments0

    out = stats.outcome(server.due, server.done, server.scores, req.offsets, first, seconds,
                        gave_up)
    window_calls = [c for c in server.calls if c[2] < seconds]
    launches = eb_ops.launches - launches0
    dev_trace = prof.device_trace(origin_ns)
    run = Run(cell, seconds, setup_s, out, req, first, window_calls, dev_trace, cell.reference())
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = m.reader().read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}

    rows = [c_rows(req, c) for c in window_calls]
    info = {
        "cell": cell.name, "seed": seed, "seconds": seconds, "traced": traced,
        "setup": marks, "calls": len(window_calls),
        "rows_per_call": float(np.mean(rows)) if rows else 0.0,
        "requests_per_call": float(np.mean([c[6] - c[5] for c in window_calls]))
        if window_calls else 0.0,
        "embedding_bag_launches_per_call": launches / max(1, len(server.calls)),
        "executed_dot_flops_per_row": ref_dot_flops_per_row(run),
        "latency_ms": {"p50": stats.percentile(out.latency_s, 50) * 1e3,
                       "p99": stats.percentile(out.latency_s, 99) * 1e3,
                       "max": float(np.max(out.latency_s)) * 1e3 if out.attempted else None,
                       "p99_by_tenth": p99_by_tenth(server.due[first:first + out.attempted],
                                                    out.latency_s, seconds)},
        "gave_up_s": gave_up,
        "longest_calls": longest_calls(req, window_calls),
    }
    breakdown = None
    if dev_trace is not None:
        busy = run.busy()
        info["copy_lag_s"] = trace_mod.copy_lag(dev_trace, window_calls, 0.0, seconds)
        info["device_events"] = len(dev_trace.names)
        breakdown = breakdown_of(dev_trace, busy, window_calls, seconds)
        for c in info["longest_calls"]:
            a, b = c["at_s"] + sum(c["ms"][:2]) / 1e3, c["at_s"] + sum(c["ms"][:3]) / 1e3
            busy_s = trace_mod.overlap(busy, np.asarray([[a, b]]))
            c["enqueue_busy_share"] = busy_s / max(b - a, 1e-12)
    t = time.perf_counter()
    result = check(cell, params, req, server, out, first, seed, control)
    result["seconds"] = time.perf_counter() - t
    found = forbidden_modules()  # after the readers and the reference have loaded too
    info["forbidden_modules"] = found
    line = {"correct": bool(result["correct"]) and not found, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": {
                "platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name() if on_card else "cpu",
                "count": 1, "memory_peak_bytes": memory_peak}}
    if dev_trace is not None:
        busy = run.busy()
        line["device"]["busy_s"] = float(np.sum(busy[:, 1] - busy[:, 0]))
        line["device"]["window_s"] = float(seconds)
        line["breakdown"] = breakdown
    line["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in result["numbers"].items()}
    info["check"] = {k: v for k, v in result.items() if k != "numbers"}
    return {"line": line, "info": info, "forbidden": found}


def p99_by_tenth(due: np.ndarray, latency_s: np.ndarray, seconds: float) -> List[float]:
    """The p99 in ms of the requests due in each tenth of the window: how
    the tail drifts within one run, beside how it differs between runs."""
    tenth = np.minimum((due / seconds * 10).astype(np.int64), 9)
    return [stats.percentile(latency_s[tenth == k], 99) * 1e3 for k in range(10)]


def device_segments() -> int:
    """cudaMalloc calls the caching allocator has made in this process."""
    return int(torch.cuda.memory_stats().get("num_device_alloc", 0))


def longest_calls(req, calls: List[tuple], k: int = 5) -> List[Dict]:
    """The k calls whose pass (t0 to t4) took longest, with each stamp's
    share: where a stall in the window sat."""
    order = sorted(range(len(calls)), key=lambda n: calls[n][0] - calls[n][4])[:k]
    return [{"at_s": calls[n][0], "rows": c_rows(req, calls[n]),
             "ms": [(b - a) * 1e3 for a, b in zip(calls[n][:4], calls[n][1:5])],
             "after_ms": ((calls[n + 1][0] if n + 1 < len(calls) else calls[n][4]) - calls[n][4])
             * 1e3} for n in order]


def c_rows(req, c) -> int:
    return int(req.offsets[c[6]] - req.offsets[c[5]])


def ref_dot_flops_per_row(run: Run) -> Optional[float]:
    """Dot flops a candidate row executes today (every row of a request
    encodes its history in full), from the configuration's formula at the
    full history and one candidate a row; beside the needed flops only."""
    L = run.cell.model["seq_len"]
    return run.reference.dot_flops(run.cell.model, np.asarray([L]), np.asarray([1]))


def breakdown_of(dev: trace_mod.DeviceTrace, busy: np.ndarray, calls: List[tuple],
                 seconds: float) -> Dict:
    inside = (dev.start >= 0.0) & (dev.start < seconds)
    by_name: Dict[str, float] = {}
    for s, e, n, ok in zip(dev.start, dev.end, dev.names, inside):
        if ok:
            by_name[n] = by_name.get(n, 0.0) + float(e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = trace_mod.idle_gaps(busy, 0.0, seconds, calls)
    return {"device_ops": [[n[:160], v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}


def sweep(cell: Cell, seed: int, seconds: float, rates: List[float], device,
          api=None) -> List[Dict]:
    """The open loop at each offered rate for `seconds`, one process, one
    set of weights: p99 over the requests due, those still queued at the
    window's end counted at its end, and the share still queued."""
    if api is None:
        from repro_torch.models.recsys import api
    disable_tf32()
    cfg = program_config(cell.model)
    params = cell.make_weights()(cfg, seed, device)
    rows = []
    for k, rate in enumerate(rates):
        arrival = cell.arrivals()(rate, seconds, sub_seed(seed, 100 + k), cell.traffic)
        shapes = 1024 if k == 0 else 0
        req = cell.generate()(cell.traffic, cell.model, shapes + len(arrival),
                              sub_seed(seed, 200 + k), device)
        server = Server(api, params, cfg, req, int(cell.traffic["max_rows"]))
        warm_shapes(server, 0, shapes)
        server.calls.clear()
        server.open_loop(arrival, shapes, seconds, 0.0)
        gave_up = server.now()
        out = stats.outcome(server.due, server.done, server.scores, req.offsets, shapes,
                            seconds, gave_up)
        calls = [c for c in server.calls if c[2] < seconds]
        rows.append({"rate_per_s": rate, "attempted": out.attempted,
                     "p50_ms": stats.percentile(out.latency_s, 50) * 1e3,
                     "p99_ms": stats.percentile(out.latency_s, 99) * 1e3,
                     "queued_share": out.unserved / max(1, out.attempted),
                     "calls": len(calls),
                     "rows_per_call": float(np.mean([c_rows(req, c) for c in calls]))
                     if calls else 0.0,
                     "cands_per_s": out.completed_cands / seconds})
        del req, server
    return rows


def no_card_reason(chips: int) -> Optional[str]:
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: the benchmark measures the card only"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, torch.cuda.device_count() is " \
               f"{torch.cuda.device_count()}"
    return None
