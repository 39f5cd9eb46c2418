#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout, with no arguments: it puts `src` on
`sys.path` itself and imports nothing of JAX or of the `repro` package.
Phases, one JSON line each:

1. device  — `nvidia-smi` name and power limit, torch / CUDA versions, TF32
   switched off (the reference is full f32). No card: it raises.
2. build   — every `src/repro_torch/csrc/*.cu` compiled by nvcc, one
   process per source started together (or found in the build cache),
   with the seconds it took.
3. kernels — each kernel's wrapper on card tensors at the main paths'
   shapes, held against its plain PyTorch version on the same inputs, and
   timed beside its bound, the plain version and, where one exists, one
   PyTorch library call: embedding_bag at taobao_ssa's, FM's and DIEN's
   lookups, fm_interaction at FM's B=512, augru at DIEN's B=512 and at a
   ragged B.
Then, for each ported arch in turn (taobao_ssa, fm, dien), at full width with
random weights, its parameters freed before the next:
4. serve   — the arch's variants (taobao_ssa and fm: `baseline` and
   `quantized`; dien: `baseline`) at 1/8/32/128/512 requests through
   `repro_torch.launch.serve`; every kernel's launch count is reset just
   before and read just after, and must match `EXPECT_LAUNCHES`.
5. profile — baseline serve calls' device busy time and each kernel's
   share (torch.profiler); the idle share sets that busy time against the
   serve phase's unprofiled median, since the profiler slows the host.
6. card vs CPU — the same parameters and one 512-request batch through
   `serve` on the card and on the CPU's plain path, every variant.

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

from repro_torch.configs.base import PORTED, get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.augru import ops as augru_ops  # noqa: E402
from repro_torch.kernels.augru.ref import augru_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.fm_interaction import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref  # noqa: E402
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
PROB_TOL = 1e-5  # card vs CPU, on probabilities
FM_RTOL, FM_ATOL = 1e-4, 1e-3  # the JAX kernel test's: (Σe)² − Σe² cancels
AUGRU_TOL = 1e-5  # absolute: h lies in (-1, 1)

# kernel launches per serve call, by (arch, variant); quantized tables are
# int8, gathered in plain torch
EXPECT_LAUNCHES = {
    ("taobao_ssa", "baseline"): {"embedding_bag": 5, "fm_interaction": 0, "augru": 0},
    ("taobao_ssa", "quantized"): {"embedding_bag": 0, "fm_interaction": 0, "augru": 0},
    ("fm", "baseline"): {"embedding_bag": 2, "fm_interaction": 1, "augru": 0},
    ("fm", "quantized"): {"embedding_bag": 0, "fm_interaction": 1, "augru": 0},
    ("dien", "baseline"): {"embedding_bag": 5, "fm_interaction": 0, "augru": 1},
}
KERNEL_SYMBOL = {"embedding_bag": "embedding_bag_kernel",
                 "fm_interaction": "fm_interaction_kernel", "augru": "augru_kernel"}


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


def _bound(nbytes: float, flops: float) -> dict:
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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
    return {
        "shape": name, "table": [V, d], "B": B, "nnz": nnz, "weighted": weighted,
        "ok": bool(ok), "max_abs_err": err, "tol": tol,
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "distinct_rows": uniq, **_bound(nbytes, 2 * B * nnz * d),
    }


def _embedding_bag_kernel(gen, flush) -> dict:
    # full-width padded tables and the ids a 512-request serve call looks up
    fm_rows, fm_vocab = 33_763_840, 33_763_409
    cases = [
        _bag_case("taobao_item_hist_nnz1", 200_192, 64, 200_000, 512 * 100, 1, False, gen, flush),
        _bag_case("taobao_user_nnz1", 1_000_448, 16, 1_000_000, 512, 1, False, gen, flush),
        _bag_case("item_bag_nnz100", 200_192, 64, 200_000, 512, 100, True, gen, flush),
        _bag_case("fm_first_order_nnz39", fm_rows, 1, fm_vocab, 512, 39, False, gen, flush),
        _bag_case("fm_unified_nnz1", fm_rows, 10, fm_vocab, 512 * 39, 1, False, gen, flush),
        _bag_case("dien_item_hist_nnz1", 50_000_384, 18, 50_000_000, 512 * 100, 1, False, gen,
                  flush),
    ]
    torch.cuda.empty_cache()
    for c in cases:
        emit({"phase": "kernels", "kernel": "embedding_bag", **c})
    bad = [c["shape"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"embedding_bag disagrees with its plain version at {bad}")
    head = cases[0]  # taobao_ssa's largest lookup: 51,200 ids into the item table
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


def _fm_interaction_kernel(gen, flush) -> dict:
    dev = torch.device("cuda")
    F_, k = 39, 10
    checks = []
    for B in (512, 37):
        e = torch.randn((B, F_, k), generator=gen, device=dev)
        out, ref = fm_ops.fm_interaction_op(e), fm_interaction_ref(e)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=FM_RTOL, atol=FM_ATOL))
        checks.append({"B": B, "ok": ok, "max_abs_err": err})
        emit({"phase": "kernels", "kernel": "fm_interaction", "B": B, "F": F_, "k": k, "ok": ok,
              "max_abs_err": err, "rtol": FM_RTOL, "atol": FM_ATOL})
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"fm_interaction disagrees with its plain version: {checks}")
    B = 512
    e = torch.randn((B, F_, k), generator=gen, device=dev)
    ms = _time_ms(lambda: fm_ops.fm_interaction_op(e), flush)
    plain_ms = _time_ms(lambda: fm_interaction_ref(e), flush)
    # per value: s += v, q += v·v (3); per factor: S², −, Σ (3); per example: ½ (1)
    bound = _bound(4 * B * F_ * k + 4 * B, B * (3 * F_ * k + 3 * k + 1))
    rec = {"name": "fm_interaction", "route": "cuda",
           "source": "src/repro_torch/csrc/fm_interaction.cu",
           "replaces": "src/repro/kernels/fm_interaction/fm_interaction.py:25",
           "launches": None, "ok": True, "max_abs_err": max(c["max_abs_err"] for c in checks),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"], "library_ms": None,
           "library_none": "no single PyTorch call computes the FM sum-square interaction",
           "at": f"B={B} F={F_} k={k}", "bytes": bound["bytes"], "flops": bound["flops"],
           "checks": checks}
    emit({"phase": "kernels", "kernel": "fm_interaction", **rec})
    return rec


def _augru_inputs(B, T, g, gen):
    """DIEN-like inputs: zx of unit scale, wh at fan-in scale, attention
    weights that sum to 1 over a prefix of random length, h0 = 0."""
    dev = torch.device("cuda")
    zx = torch.randn((B, T, 3 * g), generator=gen, device=dev)
    wh = torch.randn((g, 3 * g), generator=gen, device=dev) / g ** 0.5
    lens = torch.randint(T // 4, T + 1, (B,), generator=gen, device=dev)
    mask = torch.arange(T, device=dev)[None] < lens[:, None]
    logits = torch.where(mask, torch.randn((B, T), generator=gen, device=dev), -1e30)
    att = torch.softmax(logits, dim=-1)
    return zx, wh, torch.zeros((B, g), device=dev), att, mask


def _augru_kernel(gen, flush) -> dict:
    T, g = 100, 108
    checks = []
    for B in (512, 37, 1):
        args = _augru_inputs(B, T, g, gen)
        out, ref = augru_ops.augru_op(*args), augru_ref(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        checks.append({"B": B, "ok": err <= AUGRU_TOL, "max_abs_err": err})
        emit({"phase": "kernels", "kernel": "augru", "B": B, "T": T, "g": g,
              "ok": err <= AUGRU_TOL, "max_abs_err": err, "tol": AUGRU_TOL})
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"augru disagrees with its plain version: {checks}")
    B = 512
    args = _augru_inputs(B, T, g, gen)
    ms = _time_ms(lambda: augru_ops.augru_op(*args), flush)
    plain_ms = _time_ms(lambda: augru_ref(*args), flush, iters=10)
    # per row and step: h @ wh (2·g·3g) and 16 elementwise ops per unit
    # (r, u: add + exp + add + div each; c: mul, add, tanh; a·u; 1−u, ·h, u·c, +)
    nbytes = 4 * B * T * 3 * g + 4 * g * 3 * g + 4 * B * g + 4 * B * T + B * T + 4 * B * g
    bound = _bound(nbytes, B * T * (6 * g * g + 16 * g))
    rec = {"name": "augru", "route": "cuda", "source": "src/repro_torch/csrc/augru.cu",
           "replaces": "src/repro/kernels/augru/augru.py:48",
           "launches": None, "ok": True, "max_abs_err": max(c["max_abs_err"] for c in checks),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"], "library_ms": None,
           "library_none": ("torch.nn.GRU / cuDNN compute a GRU without the attentional "
                            "update gate, another function"),
           "at": f"B={B} T={T} g={g}", "bytes": bound["bytes"], "flops": bound["flops"],
           "checks": checks}
    emit({"phase": "kernels", "kernel": "augru", **rec})
    return rec


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(64 * 2**20 // 4, device="cuda")  # 64 MB > the 50 MB L2
    kernels = {
        "embedding_bag": _embedding_bag_kernel(gen, flush),
        "fm_interaction": _fm_interaction_kernel(gen, flush),
        "augru": _augru_kernel(gen, flush),
    }
    del flush
    torch.cuda.empty_cache()
    return kernels


def phase_serve(arch, cfg, params_by_variant, batches):
    """Returns the kernel launches of this arch's run, by kernel, and the
    baseline median ms at each size."""
    serve.reset_launch_counts()
    results = {v: serve.calibrate_variant(p, cfg, batches, reps=SERVE_REPS)
               for v, p in params_by_variant.items()}
    launches = serve.launch_counts()
    for v, by_size in results.items():
        expect = EXPECT_LAUNCHES[(arch, v)]
        for n, r in by_size.items():
            p = r["probs"]
            finite_in_01 = bool(torch.isfinite(p).all() and ((p > 0) & (p < 1)).all())
            emit({"phase": "serve", "arch": arch, "variant": v, "size": n, "reps": SERVE_REPS,
                  "median_ms": float(np.median(r["ms"])),
                  "p90_ms": float(np.percentile(r["ms"], 90)),
                  "launches_per_call": r["launches_per_call"], "probs_ok": finite_in_01})
            if p.shape != (n,) or not finite_in_01:
                raise AssertionError(
                    f"{arch}/{v}@{n}: probabilities not finite in (0,1) of shape ({n},)")
            if r["launches_per_call"] != expect:
                raise AssertionError(
                    f"{arch}/{v}@{n}: kernel launches per call {r['launches_per_call']}, "
                    f"expected {expect}")
    for k in {k for v in params_by_variant for k, n in EXPECT_LAUNCHES[(arch, v)].items() if n}:
        if launches[k] == 0:
            raise AssertionError(f"the {arch} serve path launched no {k} kernel")
    emit({"phase": "serve_launches", "arch": arch, "launches": launches})
    return launches, {n: float(np.median(r["ms"])) for n, r in results["baseline"].items()}


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (inputs in us)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def phase_profile(arch, cfg, params, batches, serve_median_ms, sizes) -> None:
    """Where a baseline serve call's time goes: the device's busy time and
    each kernel's share of it (torch.profiler). The profiler slows the host
    several-fold, so the idle share is taken against `serve_median_ms`, the
    unprofiled median of the serve phase at the same size."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for n in sizes:
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
        busy_ms = _busy_ms(spans) / PROFILE_CALLS if spans else None
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        emit({"phase": "profile", "arch": arch, "variant": "baseline", "size": n,
              "calls": PROFILE_CALLS, "profiled_wall_ms_per_call": profiled_wall_ms,
              "serve_median_ms": serve_median_ms[n], "device_busy_ms_per_call": busy_ms,
              "device_idle_share": None if busy_ms is None else 1 - busy_ms / serve_median_ms[n],
              "device_ops_per_call": len(kernels) / PROFILE_CALLS,
              "kernel_ms_per_call": {
                  k: sum(v for name, v in by_name.items() if sym in name) / PROFILE_CALLS
                  for k, sym in KERNEL_SYMBOL.items()},
              "top_ms_per_call": [[k[:80], v / PROFILE_CALLS] for k, v in top]})


def phase_card_vs_cpu(arch, cfg, params_by_variant, batch) -> None:
    cpu_batch = {k: v.to("cpu") for k, v in batch.items()}

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.to("cpu") for k, v in tree.items()}

    for v, params in params_by_variant.items():
        card = api.serve(params, batch, cfg).to("cpu")
        host_params = to_cpu(params)
        host = api.serve(host_params, cpu_batch, cfg)
        del host_params
        diff = float((card - host).abs().max())
        emit({"phase": "card_vs_cpu", "arch": arch, "variant": v, "size": int(card.shape[0]),
              "max_abs_diff": diff, "tol": PROB_TOL})
        if not diff <= PROB_TOL:
            raise AssertionError(f"{arch}/{v}: card and CPU differ by {diff}")


def drive_arch(arch: str) -> dict:
    """Serve, profile and card-vs-CPU for one arch at full width; returns
    the kernel launches of its serve phase."""
    t0 = time.perf_counter()
    cfg = get_config(arch)
    dev = torch.device("cuda")
    params = serve.make_params(cfg, dev, seed=0)
    variants = serve.build_variants(params, serve.variants_for(cfg), cfg)
    batches = serve.request_batches(cfg, SIZES, dev)
    setup_s = time.perf_counter() - t0
    launches, serve_median_ms = phase_serve(arch, cfg, variants, batches)
    profile_sizes = (1, max(SIZES)) if arch == "taobao_ssa" else (max(SIZES),)
    phase_profile(arch, cfg, variants["baseline"], batches, serve_median_ms, profile_sizes)
    phase_card_vs_cpu(arch, cfg, variants, batches[max(SIZES)])
    emit({"phase": "arch_done", "arch": arch, "setup_seconds": setup_s,
          "seconds": time.perf_counter() - t0,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    del params, variants, batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return launches


def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kernels = phase_kernels()

    by_arch = {arch: drive_arch(arch) for arch in PORTED}
    for name, rec in kernels.items():
        rec["launches_by_arch"] = {a: n[name] for a, n in by_arch.items()}
        rec["launches"] = sum(rec["launches_by_arch"].values())
        if rec["launches"] == 0:
            raise AssertionError(f"no main path launched the {name} kernel")

    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [{k: v for k, v in rec.items() if k not in ("shapes", "checks")}
                      for rec in kernels.values()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
