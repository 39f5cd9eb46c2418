"""What one cell of the benchmark is, read from files found by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration and traffic mix. Everything else is a file of its own under
`bench/`, found by the name that `BENCHMARK.json` gives:

  configs/<config>.json    the configuration's sizes, as run
  configs/<config>.py      its plain reference and its needed dot flops;
                           optionally `make_weights`, the weights of a
                           variant other than the f32 baseline
  traffic/<traffic>.json   the traffic mix's parameters
  traffic/<traffic>.py     optional: `arrivals` or `generate`, where the
                           mix needs what the general generator has not
  cells/<workload>.json    what one cell fixes beyond its mix (a rate)
  metrics/<metric>.py      the reader of one metric (a metric split by a
                           suffix, `<metric>.<part>`, may share it)

so a later cell or metric is added as files and entries, and no file here
changes. A name in a file that nothing implements (an arrival process, a
variant) fails when the cell is loaded, before any set-up.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file `path` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mangle(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str  # "end_to_end" | "per_layer"
    workloads: Optional[List[str]]
    moves: Optional[str]
    bench: Path = BENCH

    def reader(self):
        """`metrics/<name>.py`; for a quantity split by a suffix after a dot
        (`cands_per_s.din`), `metrics/<name before the dot>.py` where the
        split has no reader of its own."""
        path = self.bench / "metrics" / f"{self.name}.py"
        if not path.exists():
            path = self.bench / "metrics" / f"{self.name.split('.')[0]}.py"
        return load_module(path, f"bench_metric_{_mangle(self.name)}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    model: Dict  # configs/<config>.json
    traffic: Dict  # traffic/<traffic>.json
    params: Dict  # cells/<workload>.json
    end_to_end: List[Metric]
    per_layer: List[Metric]
    bench: Path = BENCH

    def reference(self):
        return load_module(self.bench / "configs" / f"{self.config_name}.py",
                           f"bench_config_{_mangle(self.config_name)}")

    def traffic_hooks(self):
        """`traffic/<traffic>.py` as a module, or None where the mix has none."""
        path = self.bench / "traffic" / f"{self.traffic_name}.py"
        return load_module(path, f"bench_traffic_{_mangle(self.traffic_name)}") \
            if path.exists() else None

    def arrivals(self):
        """The open loop's arrival process: `(rate, seconds, seed, mix) ->
        sorted times`; the general generator's by the mix's `arrivals`
        name, or the mix's own file's `arrivals`."""
        from harness import traffic
        hooks = self.traffic_hooks()
        if hooks is not None and hasattr(hooks, "arrivals"):
            return hooks.arrivals
        kind = self.traffic.get("arrivals")
        if kind not in traffic.ARRIVALS:
            raise ValueError(f"traffic/{self.traffic_name}.json: arrivals {kind!r} is neither "
                             f"one of {sorted(traffic.ARRIVALS)} nor given by "
                             f"traffic/{self.traffic_name}.py")
        return traffic.ARRIVALS[kind]

    def generate(self):
        """The request generator: `(mix, model, n, seed, device) -> Requests`;
        the general one, or the mix's own file's `generate` (which may be
        the general one with another `draw_items`)."""
        from harness import traffic
        hooks = self.traffic_hooks()
        if hooks is not None and hasattr(hooks, "generate"):
            return hooks.generate
        return traffic.generate

    def make_weights(self):
        """The weight maker: `(cfg, seed, device) -> params`; the f32
        baseline's, or the configuration file's own `make_weights` for any
        other variant."""
        from harness import model
        ref = self.reference()
        if hasattr(ref, "make_weights"):
            return ref.make_weights
        variant = self.model.get("variant")
        if variant != "baseline":
            raise ValueError(f"configs/{self.config_name}.json: variant {variant!r} needs a "
                             f"make_weights in configs/{self.config_name}.py")
        return model.make_weights

    def validate(self) -> None:
        """Resolve every name the files give, so that one nothing implements
        fails here, before any set-up."""
        self.make_weights()
        self.generate()
        loop = self.traffic.get("loop")
        if loop == "open":
            self.arrivals()
        elif loop == "closed":
            if "arrivals" in self.traffic:
                raise ValueError(f"traffic/{self.traffic_name}.json: a closed loop takes no "
                                 "arrivals (each answer sends the next request)")
        else:
            raise ValueError(f"traffic/{self.traffic_name}.json: loop {loop!r} is neither "
                             "'open' nor 'closed'")


def _metrics(spec: Dict, kind: str, bench: Path) -> List[Metric]:
    return [Metric(m["name"], m["unit"], kind, m.get("workloads"), m.get("moves"), bench)
            for m in spec.get(kind, [])]


def cell_metrics(metrics: List[Metric], cell: str, reported: Optional[List[str]] = None):
    """The metrics of `metrics` that `cell` reports: those that list it, or,
    without a list, every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer one)."""
    out = []
    for m in metrics:
        if m.workloads is not None:
            if cell in m.workloads:
                out.append(m)
        elif m.kind == "end_to_end" or reported is None or m.moves in reported:
            out.append(m)
    return out


def load_cell(name: str, root: Path = ROOT, entry: Optional[Dict] = None) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json, or, given `entry` (a
    workload entry in that file's form), that cell under the file's
    metrics."""
    spec = read_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if entry is None and name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    w = entry or entries[name]
    bench = root / "bench"
    cell_file = bench / "cells" / f"{name}.json"
    e2e = cell_metrics(_metrics(spec, "end_to_end", bench), name)
    cell = Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
        model=read_json(bench / "configs" / f"{w['config']}.json"),
        traffic=read_json(bench / "traffic" / f"{w['traffic']}.json"),
        params=read_json(cell_file) if cell_file.exists() else {},
        end_to_end=e2e,
        per_layer=cell_metrics(_metrics(spec, "per_layer", bench), name,
                               [m.name for m in e2e]),
        bench=bench,
    )
    cell.validate()
    return cell
