"""The benchmark of the PyTorch and CUDA port (`repro_torch`): ranking
requests served on the card through `repro_torch.models.recsys.api.serve`.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` from the root of a checkout and prints,
as its last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `check`, each number compared beside its limit (also the last
lines of standard error). Earlier lines say how the run went.

Two more modes, which print rows instead of a result:

    --sweep R1,R2,...     the open loop at each offered rate (the knee)
    --control S1,S2,...   per seed, the run's judgement and the control's
                          (the reference computed with TF32 on, put in the
                          served scores' place), one process

It needs the card: without CUDA, or with fewer cards than the cell asks
for, it prints no result and exits 2. It exits 3, naming them on
standard error, if a module whose top-level name is jax, jaxlib, flax or
repro is loaded once the window has closed: looked at after the check
and the readers have run, just before the result would be printed. `PYTHONPATH` is set here:
`src/` (the program) and `bench/` (the harness) of this checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _json_safe(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    return x


def emit(obj) -> None:
    print(json.dumps(_json_safe(obj)), flush=True)


def power_limit() -> str:
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", default="", help="comma-separated offered rates a second")
    ap.add_argument("--control", default="", help="comma-separated seeds")
    args = ap.parse_args(argv)

    # every cache of the run inside the checkout (the kernels build into
    # build/repro_torch there by themselves) or under the given HOME/TMPDIR
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

    import torch
    from harness import runner
    from harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    reason = runner.no_card_reason(cell.chips)
    if reason:
        print(f"no result: {reason}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    if args.sweep:
        rates = [float(r) for r in args.sweep.split(",")]
        for row in runner.sweep(cell, args.seed, args.seconds, rates, "cuda"):
            emit({"sweep": cell.name, **row})
        emit({"power": power_limit()})
        return 0
    if args.control:
        for s in (int(x) for x in args.control.split(",")):
            r = runner.run_cell(cell, s, args.seconds, False, "cuda", time.perf_counter(),
                                control=True)
            ctrl = r["info"]["check"]["control"]
            emit({"control": cell.name, "seed": s, "correct": r["line"]["correct"],
                  "control_correct": ctrl["correct"],
                  "program_gap": r["line"]["check"]["score_gap"]["value"],
                  "control_gap": ctrl["numbers"]["score_gap"][0],
                  "limit": r["line"]["check"]["score_gap"]["limit"],
                  "rows_per_call": r["info"]["rows_per_call"],
                  "sample_rows": r["info"]["check"].get("sample_rows")})
            torch.cuda.empty_cache()
        emit({"power": power_limit()})
        return 0

    r = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = runner.forbidden_modules()
    if found:
        print("loaded once the window had closed, and forbidden here: " + ", ".join(found),
              file=sys.stderr)
        return 3
    r["info"]["power"] = power_limit()
    emit(r["info"])
    for name, c in r["line"]["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    emit(r["line"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
