"""Input-shape registry: every (architecture family x shape) cell.

Each shape names a *workload*, not just dimensions: it determines which step
function (`train_step` / `prefill_step` / `decode_step` / `serve_step` /
`retrieval_step`) the dry-run lowers.

A copy of `repro.configs.shapes`: the port imports nothing of `repro`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# ---------------------------------------------------------------------------
# Shape descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMShape:
    """LM-family workload: seq_len x global_batch."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class GNNShape:
    """GNN workload."""

    name: str
    n_nodes: int
    n_edges: int
    d_feat: Optional[int]
    kind: str  # "full_batch" | "minibatch" | "batched_small"
    batch_nodes: int = 0  # sampled-training seed nodes
    fanout: tuple = ()  # neighbor-sampler fanout per hop
    graph_batch: int = 0  # batched-small-graphs batch size


@dataclasses.dataclass(frozen=True)
class RecSysShape:
    """RecSys workload."""

    name: str
    batch: int
    kind: str  # "train" | "serve" | "retrieval"
    n_candidates: int = 0


# ---------------------------------------------------------------------------
# The assigned shape sets (verbatim from the assignment)
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": LMShape("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": LMShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": LMShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": LMShape("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}

GNN_SHAPES = {
    "full_graph_sm": GNNShape(
        "full_graph_sm", n_nodes=2_708, n_edges=10_556, d_feat=1_433, kind="full_batch"
    ),
    "minibatch_lg": GNNShape(
        "minibatch_lg",
        n_nodes=232_965,
        n_edges=114_615_892,
        d_feat=602,
        kind="minibatch",
        batch_nodes=1_024,
        fanout=(15, 10),
    ),
    "ogb_products": GNNShape(
        "ogb_products", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, kind="full_batch"
    ),
    "molecule": GNNShape(
        "molecule", n_nodes=30, n_edges=64, d_feat=None, kind="batched_small", graph_batch=128
    ),
}

RECSYS_SHAPES = {
    "train_batch": RecSysShape("train_batch", batch=65_536, kind="train"),
    "serve_p99": RecSysShape("serve_p99", batch=512, kind="serve"),
    "serve_bulk": RecSysShape("serve_bulk", batch=262_144, kind="serve"),
    "retrieval_cand": RecSysShape(
        "retrieval_cand", batch=1, kind="retrieval", n_candidates=1_000_000
    ),
}

FAMILY_SHAPES = {
    "lm": LM_SHAPES,
    "gnn": GNN_SHAPES,
    "recsys": RECSYS_SHAPES,
}


def shapes_for_family(family: str):
    return FAMILY_SHAPES[family]
