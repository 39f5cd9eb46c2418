#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, with no arguments: it puts `src` on
`sys.path` itself and imports nothing of JAX or of the `repro` package.
Phases, one JSON line each:

1. device  — `nvidia-smi` name and power limit, torch / CUDA versions, TF32
   switched off (the reference is full f32). No card: it raises.
2. build   — every `src/repro_torch/csrc/*.cu` compiled by nvcc (or found
   in the build cache), with the seconds it took.
3. kernels — each kernel's wrapper on card tensors at the main path's
   shapes, held against its plain PyTorch version on the same inputs, and
   timed beside its bound, the plain version and one PyTorch library call.
4. serve   — the full-width taobao_ssa ranker, `baseline` and `quantized`,
   at 1/8/32/128/512 requests through `repro_torch.launch.serve`; kernel
   launch counts are reset just before and read just after.
5. profile — one baseline serve call's device busy time and the kernel's
   share (torch.profiler); the idle share sets that busy time against the
   serve phase's unprofiled median, since the profiler slows the host.
6. card vs CPU — the same parameters and one 512-request batch through
   `serve` on the card and on the CPU's plain path.

Then the `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`. Any failure raises and the exit code is
not 0; nothing is caught and passed over.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.recsys import api  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SIZES = (1, 8, 32, 128, 512)
SERVE_REPS = 20
KERNEL_ITERS = 50
SLEEP_CYCLES = 1_000_000  # ~0.5 ms at H100 clocks: longer than the host takes to enqueue a call
PROFILE_CALLS = 10
TOL_REL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    serve.disable_tf32()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build() -> None:
    rep = _build.build_all()
    for name, text in rep["ptxas"].items():
        print(f"[nvcc {name}]\n{text}", file=sys.stderr, flush=True)
    emit({"phase": "build", "seconds": rep["seconds"], "built": rep["built"],
          "cached": rep["cached"], "cache_hit": not rep["built"]})


def _time_ms(fn, flush: torch.Tensor, iters: int = KERNEL_ITERS) -> float:
    """Median device time of one call. Before each: a write that evicts L2
    (the serve path reads the tables cold too), then a device-side sleep
    that keeps the stream busy while the host enqueues the call, so the
    events bracket device work and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def _bag_case(name, V, d, vocab, B, nnz, weighted, gen, flush):
    """One shape: ids drawn from the `vocab` real rows of a padded [V, d] table."""
    dev = torch.device("cuda")
    table = torch.randn((V, d), generator=gen, device=dev)
    idx = torch.randint(0, vocab, (B, nnz), generator=gen, device=dev, dtype=torch.int32)
    w = torch.rand((B, nnz), generator=gen, device=dev) if weighted else None

    out = eb_ops.embedding_bag_op(table, idx, w)
    ref = embedding_bag_ref(table, idx, w)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if nnz == 1:
        ok = torch.equal(out, ref) and (weighted or torch.equal(out, table[idx[:, 0].long()]))
        tol = 0.0
    else:
        tol = TOL_REL * float(ref.abs().max())
        ok = err <= tol

    idx64 = idx.long()
    if nnz == 1:
        library = (lambda: F.embedding(idx64[:, 0], table)) if not weighted else None
    else:
        library = lambda: F.embedding_bag(idx64, table, mode="sum", per_sample_weights=w)  # noqa: E731
    kernel_ms = _time_ms(lambda: eb_ops.embedding_bag_op(table, idx, w), flush)
    plain_ms = _time_ms(lambda: embedding_bag_ref(table, idx, w), flush)
    library_ms = _time_ms(library, flush) if library else None

    # least bytes: each distinct row read once, ids and weights read once, out written once
    uniq = int(torch.unique(idx).numel())
    nbytes = uniq * d * 4 + idx.numel() * 4 + (w.numel() * 4 if weighted else 0) + B * d * 4
    flops = 2 * B * nnz * d
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return {
        "shape": name, "table": [V, d], "B": B, "nnz": nnz, "weighted": weighted,
        "ok": bool(ok), "max_abs_err": err, "tol": tol,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bytes": nbytes, "distinct_rows": uniq, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(64 * 2**20 // 4, device="cuda")  # 64 MB > the 50 MB L2
    # full-width padded tables and the ids a 512-request serve call looks up
    cases = [
        _bag_case("item_hist_nnz1", 200_192, 64, 200_000, 512 * 100, 1, False, gen, flush),
        _bag_case("user_nnz1", 1_000_448, 16, 1_000_000, 512, 1, False, gen, flush),
        _bag_case("item_bag_nnz100", 200_192, 64, 200_000, 512, 100, True, gen, flush),
    ]
    for c in cases:
        emit({"phase": "kernels", "kernel": "embedding_bag", **c})
    bad = [c["shape"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"embedding_bag disagrees with its plain version at {bad}")
    head = cases[0]  # the serve path's largest lookup: 51,200 ids into the item table
    return {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:37",
        "launches": None, "ok": True,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "at": head["shape"], "shapes": cases,
    }


def phase_serve(cfg, params_by_variant, batches):
    """Returns the kernel launches of the run and the baseline median ms
    at each size."""
    eb_ops.launches = 0
    results = {v: serve.calibrate_variant(p, cfg, batches, reps=SERVE_REPS)
               for v, p in params_by_variant.items()}
    launches = eb_ops.launches
    expect = {"baseline": 5, "quantized": 0}  # quantized tables are int8: gathered in plain torch
    for v, by_size in results.items():
        for n, r in by_size.items():
            p = r["probs"]
            finite_in_01 = bool(torch.isfinite(p).all() and ((p > 0) & (p < 1)).all())
            emit({"phase": "serve", "variant": v, "size": n, "reps": SERVE_REPS,
                  "median_ms": float(np.median(r["ms"])),
                  "p90_ms": float(np.percentile(r["ms"], 90)),
                  "launches_per_call": r["launches_per_call"], "probs_ok": finite_in_01})
            if p.shape != (n,) or not finite_in_01:
                raise AssertionError(f"{v}@{n}: probabilities not finite in (0,1) of shape ({n},)")
            if r["launches_per_call"] != expect[v]:
                raise AssertionError(
                    f"{v}@{n}: {r['launches_per_call']} kernel launches per call, "
                    f"expected {expect[v]}")
    if launches == 0:
        raise AssertionError("the serve path launched no embedding_bag kernel")
    return launches, {n: float(np.median(r["ms"])) for n, r in results["baseline"].items()}


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (inputs in us)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def phase_profile(cfg, params, batches, serve_median_ms) -> None:
    """Where a baseline serve call's time goes: the device's busy time and
    the kernel's share of it (torch.profiler). The profiler slows the host
    several-fold, so the idle share is taken against `serve_median_ms`, the
    unprofiled median of the serve phase at the same size."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for n in (1, max(SIZES)):
        batch = batches[n]
        for _ in range(3):
            api.serve(params, batch, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_CALLS):
                api.serve(params, batch, cfg)
            torch.cuda.synchronize()
            profiled_wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_CALLS
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = [(e.time_range.start, e.time_range.end) for e in kernels]
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        bag_ms = sum(v for k, v in by_name.items() if "embedding_bag_kernel" in k)
        busy_ms = _busy_ms(spans) / PROFILE_CALLS if spans else None
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        emit({"phase": "profile", "variant": "baseline", "size": n, "calls": PROFILE_CALLS,
              "profiled_wall_ms_per_call": profiled_wall_ms,
              "serve_median_ms": serve_median_ms[n], "device_busy_ms_per_call": busy_ms,
              "device_idle_share": None if busy_ms is None else 1 - busy_ms / serve_median_ms[n],
              "device_ops_per_call": len(kernels) / PROFILE_CALLS,
              "embedding_bag_ms_per_call": bag_ms / PROFILE_CALLS,
              "top_ms_per_call": [[k[:80], v / PROFILE_CALLS] for k, v in top]})


def phase_card_vs_cpu(cfg, params_by_variant, batch) -> None:
    cpu_batch = {k: v.to("cpu") for k, v in batch.items()}

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.to("cpu") for k, v in tree.items()}

    for v, params in params_by_variant.items():
        card = api.serve(params, batch, cfg).to("cpu")
        host = api.serve(to_cpu(params), cpu_batch, cfg)
        diff = float((card - host).abs().max())
        emit({"phase": "card_vs_cpu", "variant": v, "size": int(card.shape[0]),
              "max_abs_diff": diff, "tol": 1e-5})
        if not diff <= 1e-5:
            raise AssertionError(f"{v}: card and CPU differ by {diff}")


def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kernel = phase_kernels()

    cfg = get_config("taobao_ssa")
    dev = torch.device("cuda")
    params = serve.make_params(cfg, dev, seed=0)
    variants = serve.build_variants(params, serve.VARIANTS)
    batches = serve.request_batches(cfg, SIZES, dev)
    kernel["launches"], serve_median_ms = phase_serve(cfg, variants, batches)
    phase_profile(cfg, variants["baseline"], batches, serve_median_ms)
    phase_card_vs_cpu(cfg, variants, batches[max(SIZES)])

    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [kernel]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
