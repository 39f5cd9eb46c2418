"""Host-side fanout neighbor sampler (GraphSAGE-style) for minibatch_lg.

Produces static-shape padded subgraphs so the jitted train step never
re-specializes: seeds x (1 + f1 + f1*f2) node slots, seeds x (f1 + f1*f2)
edge slots, with masks for padding. CSR adjacency is built once on the
host (numpy); sampling is vectorized numpy — this runs in the input
pipeline workers, not on device.

A copy of `repro.models.gnn.sampler` (the port imports nothing of
`repro`); its syntax tree, docstrings removed, equals the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E]
    n_nodes: int

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> "CSRGraph":
        order = np.argsort(dst, kind="stable")
        src_s = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr=indptr, indices=src_s, n_nodes=n_nodes)

    def sample_neighbors(self, nodes: np.ndarray, fanout: int, rng) -> np.ndarray:
        """[B] -> [B, fanout] sampled in-neighbors (with replacement;
        isolated nodes self-loop)."""
        start = self.indptr[nodes]
        deg = self.indptr[nodes + 1] - start
        r = rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(nodes), fanout))
        idx = start[:, None] + r
        out = self.indices[np.minimum(idx, len(self.indices) - 1)]
        return np.where(deg[:, None] > 0, out, nodes[:, None])


def sample_subgraph(
    g: CSRGraph, seeds: np.ndarray, fanout: Tuple[int, ...], rng
) -> Dict[str, np.ndarray]:
    """Layer-wise fanout sampling -> flat padded subgraph arrays.

    Returns local-id arrays: node_ids [N_sub] (global ids for feature
    fetch), edge_src/edge_dst [E_sub] (local), seed_mask [N_sub].
    Shapes depend only on (len(seeds), fanout) — static under jit.
    """
    frontiers = [seeds]
    edges_src_g, edges_dst_g = [], []
    for f in fanout:
        cur = frontiers[-1]
        nbrs = g.sample_neighbors(cur, f, rng)  # [B, f] global
        edges_src_g.append(nbrs.reshape(-1))
        edges_dst_g.append(np.repeat(cur, f))
        frontiers.append(nbrs.reshape(-1))

    node_ids = np.concatenate(frontiers)  # duplicates allowed (static shape)
    # edges reference the frontier layout directly (no dedup -> static shapes):
    offs = np.cumsum([0] + [len(f) for f in frontiers])
    edge_src_l, edge_dst_l = [], []
    for li, f in enumerate(fanout):
        n_dst = len(frontiers[li])
        src_slots = offs[li + 1] + np.arange(n_dst * f)
        dst_slots = offs[li] + np.repeat(np.arange(n_dst), f)
        edge_src_l.append(src_slots)
        edge_dst_l.append(dst_slots)

    return {
        "node_ids": node_ids.astype(np.int32),
        "edge_src": np.concatenate(edge_src_l).astype(np.int32),
        "edge_dst": np.concatenate(edge_dst_l).astype(np.int32),
        "seed_mask": (np.arange(len(node_ids)) < len(seeds)),
    }


def subgraph_sizes(n_seeds: int, fanout: Tuple[int, ...]) -> Tuple[int, int]:
    """Static (n_nodes, n_edges) of a sampled subgraph."""
    n_nodes, n_edges, layer = n_seeds, 0, n_seeds
    for f in fanout:
        n_edges += layer * f
        layer *= f
        n_nodes += layer
    return n_nodes, n_edges
