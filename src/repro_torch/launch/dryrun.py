"""The dry run: what one rank of a production mesh computes in each cell
(port of `repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k \\
        --mesh single --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --mesh both --device cpu

`repro` compiles each cell ahead of time for 256 or 512 TPU devices and
reads XLA's SPMD-partitioned program (`hlo_stats.analyze` of its HLO
text, `memory_analysis`). In its place the port starts a fake process
group (`torch.testing._internal.distributed.fake_pg`: every collective
returns at once and moves nothing) of 256 or 512 ranks as `--rank`,
builds the production mesh on it (`launch/mesh`), cuts that rank's blocks
of the cell's arguments (`cells.build_cell`'s `in_specs`,
`sharding.block_slices`) as fake tensors on `--device` (shapes and dtypes,
no storage: `FakeTensorMode`) and calls the cell's own `fn` on them under
the counter (`launch/hlo_stats.Counter`). Nothing is allocated on the
device and nothing is launched: every kernel wrapper takes its
shape-only path and hands the counter its work. The counts are the
eager program's, so its bytes are not XLA's fused traffic, and no time is
measured: the roofline terms are the counts over the card's data-sheet
peaks (`launch/analysis`).

Each cell's record goes to `<results>/<arch>__<shape>__<mesh>.json`
(`--results`, by default `results/dryrun_torch/` of the checkout)
with `repro`'s keys (`cell`, `mesh`, `n_chips`, `optimizer`, `tag`,
`meta`, `flops`, `bytes_accessed`, `collectives`, `collective_counts`,
`top_computations`, `memory`, `timings` with `trace_s` for the lower and
compile times) and `kernels`, `device`, `rank`, `peak_bytes` (arguments +
temporaries), `fits` against `memory_limit` (the card's memory where one is
present, else the H100 80GB HBM3's data-sheet 80 GB), `roofline`, and
for an LM cell `model_flops` and `mfu_ratio`. A cell that refuses its mesh
(an LM layout such as `{"train_layout": "tp"}` under `--overrides`, which
runs on one rank only) writes `.err.json`
with the refusal and exits 1, as `repro`'s sweep records a cell that does
not compile. `--sweep` runs each cell in a subprocess of its own, so that
one failure cannot stop the sweep; `--report` prints the records as a
markdown table. The card is the default device; pass
`--device cpu` where there is none (the counts do not depend on it).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.distributed.sharding import block_slices
from repro_torch.launch import analysis
from repro_torch.launch.cells import all_cells, build_cell
from repro_torch.launch.hlo_stats import count
from repro_torch.launch.mesh import axis_names, make_mesh, make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def start_fake_group(world: int, rank: int = 0) -> None:
    """The default process group: a fake one of `world` ranks, this
    process its rank `rank`. It is process-global; one a process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    dist.init_process_group("fake", store=FakeStore(), world_size=world, rank=rank)


def fake_blocks(tree, specs, mesh, coord, mode: FakeTensorMode, device):
    """The blocks at mesh `coord` of a tree of whole "meta" tensors laid out
    by `specs`, as fake tensors of `mode` on `device`."""
    if isinstance(tree, dict):
        return {k: fake_blocks(v, specs[k], mesh, coord, mode, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(fake_blocks(v, s, mesh, coord, mode, device)
                          for v, s in zip(tree, specs))
    shape = [s.stop - s.start for s in block_slices(tree.shape, specs, mesh, coord)]
    with mode:
        return torch.empty(shape, dtype=tree.dtype, device=device)


def trace(cell, mesh, device) -> Dict:
    """`cell.fn` on this rank's fake blocks of `cell.args` under the
    counter: its `stats()`, `memory()` (the donated arguments `cell.donate`)
    and the seconds the trace took."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    coord = tuple(mesh.get_coordinate())
    args = tuple(fake_blocks(a, s, mesh, coord, mode, device)
                 for a, s in zip(cell.args, cell.in_specs))
    t0 = time.perf_counter()
    with mode:
        _, stats, memory = count(cell.fn, args, cell.donate)
    return {"stats": stats, "memory": memory, "trace_s": time.perf_counter() - t0}


def memory_limit() -> Dict:
    """The bytes a rank's peak is held to: the card's where one is present,
    else the H100 80GB HBM3's data-sheet figure."""
    if torch.cuda.is_available():
        return {"device": torch.cuda.get_device_name(0),
                "bytes": torch.cuda.get_device_properties(0).total_memory, "source": "the card"}
    return {"device": analysis.CARD, "bytes": analysis.HBM_BYTES, "source": "data sheet"}


def record(cell, cfg, mesh, optimizer: str, tag: str, device: torch.device, rank: int,
           traced: Dict) -> Dict:
    """The record of `cell` of config `cfg` (the module's docstring lists
    its keys)."""
    stats, mem = traced["stats"], traced["memory"]
    n_chips = mesh.size()
    limit = memory_limit()
    peak = mem["argument_bytes"] + mem["temp_bytes"]
    shape = "x".join(map(str, mesh.shape))
    rec = {
        "cell": cell.name, "mesh": shape, "n_chips": n_chips, "optimizer": optimizer,
        "tag": tag, "meta": cell.meta, "flops": stats["flops"],
        "bytes_accessed": stats["bytes_hbm"], "collectives": stats["collectives"],
        "collective_counts": stats["collective_counts"],
        "top_computations": stats["top_computations"], "memory": mem,
        "timings": {"trace_s": traced["trace_s"]}, "kernels": stats["kernels"],
        "device": device.type, "rank": rank, "peak_bytes": peak,
        "fits": peak <= limit["bytes"], "memory_limit": limit,
        "roofline": analysis.Roofline(stats["flops"], stats["bytes_hbm"],
                                      stats["collectives"]["total"], n_chips).as_dict(),
    }
    if cfg.family == "lm":
        mf = analysis.model_flops_lm(cfg, cell.meta["tokens"], cell.meta["kind"])
        rec["model_flops"] = mf
        rec["mfu_ratio"] = analysis.mfu_ratio(mf / n_chips, stats["flops"])
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, optimizer: str, overrides=None,
             tag: str = "", accum: int = 1, device="cuda", rank: int = 0) -> Dict:
    """The record of one cell on the production mesh (16x16, or 2x16x16
    with `multi_pod`) as seen by `rank`, on a fake process group that this
    call starts (one a process)."""
    dev = resolve_device(device)
    n = 512 if multi_pod else 256
    start_fake_group(n, rank)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    cell = build_cell(arch, shape, mesh, optimizer=optimizer, overrides=overrides, accum=accum)
    cfg = get_config(arch, **(overrides or {}))
    return record(cell, cfg, mesh, optimizer, tag, dev, rank, trace(cell, mesh, dev))


def run_on_mesh(arch: str, shape_name: str, mesh_shape: Sequence[int], device="cuda", *,
                cfg=None, shape=None, optimizer: str = "adamw", rank: int = 0) -> Dict:
    """The record of `build_cell(arch, shape_name, ...)` (with `cfg=` and
    `shape=` as it takes them) on a mesh of `mesh_shape`, as seen by
    `rank`, on a fake process group that this call starts (one a process)."""
    dev = resolve_device(device)
    start_fake_group(math.prod(mesh_shape), rank)
    mesh = make_mesh(mesh_shape, axis_names(mesh_shape), "cpu")
    cfg = cfg or get_config(arch)
    cell = build_cell(arch, shape_name, mesh, optimizer=optimizer, cfg=cfg, shape=shape)
    return record(cell, cfg, mesh, optimizer, "", dev, rank, trace(cell, mesh, dev))


def cell_path(arch: str, shape: str, multi_pod: bool, tag: str = "",
              results: Path = RESULTS) -> Path:
    mesh_tag = "multi" if multi_pod else "single"
    suffix = f"__{tag}" if tag else ""
    return Path(results) / f"{arch}__{shape}__{mesh_tag}{suffix}.json"


def _sweep(args) -> int:
    """Every cell of `all_cells()` on the asked meshes, one subprocess a
    cell; records already written are kept unless `--force`."""
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    for mesh_kind in meshes:
        for arch, shape in all_cells():
            out = cell_path(arch, shape, mesh_kind == "multi", args.tag, args.results)
            if out.exists() and not args.force:
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--mesh", mesh_kind, "--optimizer", args.optimizer,
                   "--device", args.device, "--rank", str(args.rank),
                   "--accum", str(args.accum), "--results", str(args.results)]
            if args.tag:
                cmd += ["--tag", args.tag]
            if args.overrides:
                cmd += ["--overrides", args.overrides]
            print(f"[sweep] {arch}:{shape} ({mesh_kind})", flush=True)
            failures += subprocess.run(cmd).returncode != 0
    print(f"[sweep] done, {failures} failures", flush=True)
    return 1 if failures else 0


def _g(x: float) -> str:
    return f"{x:.4g}"


def report(results: Path = RESULTS) -> str:
    """A markdown table of the records in `results`: per cell, each number
    on the 16x16 mesh and then (after ";") on 2x16x16; a cell with an
    `.err.json` on both meshes named as refused."""
    rows = ["| cell | dot flops / device | kernels: calls, flops, bytes (16x16) | collective "
            "bytes / device, AG / AR / RS / A2A | peak GiB, fits | t_compute / t_memory / "
            "t_collective s, bound | mfu_ratio |", "|---|---|---|---|---|---|---|"]
    refused = []
    for arch, shape in all_cells():
        recs = [cell_path(arch, shape, multi, results=results) for multi in (False, True)]
        if not all(p.exists() for p in recs):
            if all(p.with_suffix(".err.json").exists() for p in recs):
                refused.append(f"{arch}:{shape}")
            continue
        r1, r2 = (json.loads(p.read_text()) for p in recs)
        kern = ", ".join(f"{k} {v['calls']}, {_g(v['flops'])}, {_g(v['bytes'])}"
                         for k, v in r1["kernels"].items()) or "none"
        coll = "; ".join(" / ".join(_g(r["collectives"][k]) for k in
                                    ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"))
                         for r in (r1, r2))
        roof = "; ".join(f"{_g(r['roofline']['t_compute_s'])} / {_g(r['roofline']['t_memory_s'])}"
                         f" / {_g(r['roofline']['t_collective_s'])}, {r['roofline']['bottleneck']}"
                         for r in (r1, r2))
        peak = "; ".join(f"{_g(r['peak_bytes'] / 2**30)}{'' if r['fits'] else ' (no)'}"
                         for r in (r1, r2))
        mfu = "; ".join(_g(r["mfu_ratio"]) for r in (r1, r2)) if "mfu_ratio" in r1 else "—"
        rows.append(f"| {arch}:{shape} | {_g(r1['flops'])}; {_g(r2['flops'])} | {kern} | {coll} "
                    f"| {peak} | {roof} | {mfu} |")
    if refused:
        rows.append(f"\nRefused on both meshes: {', '.join(refused)}.")
    return "\n".join(rows)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry run on fake tensors")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--sweep", action="store_true", help="run all 40 cells")
    ap.add_argument("--tag", default="", help="variant tag for the output file")
    ap.add_argument("--overrides", default="", help="JSON dict of config overrides")
    ap.add_argument("--force", action="store_true", help="re-run cells already recorded")
    ap.add_argument("--accum", type=int, default=1, help="gradient accumulation")
    ap.add_argument("--device", default="cuda", help="where the fake tensors lie")
    ap.add_argument("--rank", type=int, default=0, help="the rank whose blocks are counted")
    ap.add_argument("--results", type=Path, default=RESULTS, help="where the records go")
    ap.add_argument("--report", action="store_true",
                    help="print the records in --results as a markdown table")
    args = ap.parse_args(argv)
    if args.report:
        print(report(args.results))
        return 0
    args.results.mkdir(parents=True, exist_ok=True)

    if args.sweep:
        return _sweep(args)
    if not (args.arch and args.shape) or args.mesh == "both":
        ap.error("--arch, --shape and one --mesh are needed outside --sweep")
    multi = args.mesh == "multi"
    overrides = json.loads(args.overrides) if args.overrides else None
    out = cell_path(args.arch, args.shape, multi, args.tag, args.results)
    try:
        rec = run_cell(args.arch, args.shape, multi, args.optimizer, overrides=overrides,
                       tag=args.tag, accum=args.accum, device=args.device, rank=args.rank)
    except Exception:  # the record of a cell that refuses its mesh, as `repro`'s sweep keeps
        err = {"cell": f"{args.arch}:{args.shape}", "mesh": args.mesh, "device": args.device,
               "rank": args.rank, "error": traceback.format_exc()}
        out.with_suffix(".err.json").write_text(json.dumps(err, indent=2))
        print(f"FAIL {args.arch}:{args.shape} [{args.mesh}]", flush=True)
        traceback.print_exc()
        return 1
    out.write_text(json.dumps(rec, indent=2, default=str))
    out.with_suffix(".err.json").unlink(missing_ok=True)
    print(
        f"OK {rec['cell']} [{rec['mesh']}] flops={rec['flops']:.3e} "
        f"bytes={rec['bytes_accessed']:.3e} coll={rec['collectives']['total']:.3e} "
        f"peak={rec['peak_bytes'] / 2**30:.2f}GiB fits={rec['fits']} "
        f"trace={rec['timings']['trace_s']:.1f}s",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
