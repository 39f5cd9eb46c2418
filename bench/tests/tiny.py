"""Cells of the benchmark cut to widths a CPU test can hold.

The widths, vocabularies and history are cut from the configuration
files; everything else (the files' roles, limits and the traffic mix's
shape) is kept, so a tiny run drives the same code as a run on the card.
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import load_cell  # noqa: E402

L = 12
VOCAB = {"user": 300, "item": 700, "category": 40}


def tiny_model(model: dict) -> dict:
    m = copy.deepcopy(model)
    m["seq_len"] = L
    if "d_attn" in m:
        m["embed_dim"] = m["d_attn"] = 16
        m["mlp_dims"] = [24, 8]
    else:
        m["embed_dim"] = 6
        m["attn_mlp_dims"] = [12, 6]
        m["mlp_dims"] = [16, 8]
    for f in m["fields"]:
        f["vocab"] = VOCAB[f.get("shares") or f["name"]]
        if f.get("multi_hot", 1) > 1:
            f["multi_hot"] = L
    for f in m["fields"]:
        if f["name"] == "user" and "dim" in f:
            f["dim"] = 4
    return m


def tiny_traffic(traffic: dict) -> dict:
    t = copy.deepcopy(traffic)
    t.update(max_rows=96, hist_len=[3, L], warmup_s=0.2, drain_s=5.0, check_requests=64)
    # the mix's form kept: a fixed number a request, or a log-uniform range
    t["candidates"] = 5 if isinstance(t["candidates"], int) else [2, 20]
    return t


# The open loop, which no cell of BENCHMARK.json runs today (PERF.md says
# why), kept under test as a cell of the `rank.poisson` mix.
OPEN = {"name": "ssa.rank.steady", "config": "taobao_ssa", "traffic": "rank.poisson", "chips": 1}


def tiny_cell(name: str, rate: float = 300.0, provision: float = 40000.0):
    """The cell `name` at tiny widths, its open loop at `rate` requests a
    second, its closed loop provisioned for `provision`."""
    cell = load_cell(name, ROOT, OPEN if name == OPEN["name"] else None)
    cell.model = tiny_model(cell.model)
    cell.traffic = tiny_traffic(cell.traffic)
    cell.params = {"rate_per_s": rate} if cell.traffic["loop"] == "open" \
        else {"provision_per_s": provision}
    return cell
