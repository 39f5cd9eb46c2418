"""Synthetic Taobao-like and Criteo-like data, the serving simulator's
lookup workloads, the GNN graphs and the LM token streams (port of
`repro.data.synthetic`).

Pure numpy, copied so the port imports nothing of `repro`: for the same
seed these generators give arrays identical to `repro.data.synthetic`'s.

Taobao: users have latent category preferences; histories are drawn from them;
labels come from a ground-truth logistic model on user-item affinity +
recency-weighted history match, so a model that learns gets HR@K well
above the 1/50 floor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import RecSysConfig


@dataclasses.dataclass
class TaobaoWorld:
    """Ground truth for the synthetic marketplace."""

    n_users: int
    n_items: int
    n_cats: int
    dim: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.item_cat = rng.integers(0, self.n_cats, self.n_items)
        self.user_pref = rng.normal(size=(self.n_users, self.dim)).astype(np.float32)
        self.cat_vec = rng.normal(size=(self.n_cats, self.dim)).astype(np.float32)
        self.item_pop = rng.zipf(1.3, self.n_items).astype(np.float64)
        self.item_pop /= self.item_pop.sum()

    def affinity(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        return np.einsum(
            "ud,ud->u", self.user_pref[users], self.cat_vec[self.item_cat[items]]
        )


def taobao_batches(
    cfg: RecSysConfig,
    batch: int,
    steps: int,
    *,
    world: Optional[TaobaoWorld] = None,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Behaviour-log batches matching the din/dien/taobao_ssa input spec."""
    fields = {f.name: f for f in cfg.fields}
    n_users = fields["user"].vocab
    n_items = fields["item"].vocab
    n_cats = fields["category"].vocab
    world = world or TaobaoWorld(n_users, n_items, n_cats)
    L = cfg.seq_len
    rng = np.random.default_rng(seed + 1)

    for _ in range(steps):
        users = rng.integers(0, n_users, batch)
        # history: preference-tilted popularity sampling
        cand_pool = rng.integers(0, n_items, (batch, 4 * L))
        aff = np.einsum(
            "ud,ukd->uk",
            world.user_pref[users],
            world.cat_vec[world.item_cat[cand_pool]],
        )
        topk = np.argsort(-aff, axis=1)[:, :L]
        hist = np.take_along_axis(cand_pool, topk, axis=1)
        hist_len = rng.integers(L // 4, L + 1, batch)
        pad_mask = np.arange(L)[None] >= hist_len[:, None]
        hist = np.where(pad_mask, 0, hist)

        # candidate: half drawn from the history (re-engagement), half
        # uniform; label = history relevance + affinity
        from_hist = rng.random(batch) < 0.5
        pick = rng.integers(0, np.maximum(hist_len, 1))
        cand = np.where(from_hist, hist[np.arange(batch), pick],
                        rng.integers(0, n_items, batch))
        cand_cat = world.item_cat[cand]
        overlap = np.mean(
            (world.item_cat[hist] == cand_cat[:, None]) & ~pad_mask, axis=1
        ) * (L / np.maximum(hist_len, 1))
        logits = (
            2.5 * overlap
            + 0.5 * world.affinity(users, cand)
            + 0.3 * rng.normal(size=batch)
        )
        label = (logits > np.median(logits)).astype(np.float32)

        yield {
            "user": users.astype(np.int32),
            "item": cand.astype(np.int32),
            "category": cand_cat.astype(np.int32),
            "hist_item": hist.astype(np.int32),
            "hist_category": world.item_cat[hist].astype(np.int32),
            "hist_len": hist_len.astype(np.int32),
            "label": label,
        }


def taobao_eval_candidates(
    cfg: RecSysConfig, n_queries: int, n_cand: int = 50, *, seed: int = 10,
    world: Optional[TaobaoWorld] = None,
) -> Dict[str, np.ndarray]:
    """Ranking-eval set (paper: candidate set 50, 1 positive): returns a
    flat batch of n_queries*n_cand rows + the positive index per query."""
    fields = {f.name: f for f in cfg.fields}
    world = world or TaobaoWorld(
        fields["user"].vocab, fields["item"].vocab, fields["category"].vocab
    )
    rng = np.random.default_rng(seed)
    base = next(taobao_batches(cfg, n_queries, 1, world=world, seed=seed))

    # positive = an item from the user's history (re-engagement target);
    # negatives uniform — HR@K measures retrieving the behavioural signal
    cands = rng.integers(0, fields["item"].vocab, (n_queries, n_cand))
    pos_idx = rng.integers(0, n_cand, n_queries).astype(np.int32)
    pick = rng.integers(0, np.maximum(base["hist_len"], 1))
    pos_items = base["hist_item"][np.arange(n_queries), pick]
    cands[np.arange(n_queries), pos_idx] = pos_items

    flat = {
        k: np.repeat(base[k], n_cand, axis=0)
        for k in ("user", "hist_item", "hist_category", "hist_len")
    }
    flat["item"] = cands.reshape(-1).astype(np.int32)
    flat["category"] = world.item_cat[flat["item"]].astype(np.int32)
    return {"batch": flat, "pos_idx": pos_idx, "n_cand": n_cand}


def zipf_id_stream(
    n: int, vocab: int, alpha: float = 1.1, *, seed: int = 0
) -> np.ndarray:
    """Zipf(alpha)-popular ID stream over [0, vocab): id k has rank k+1,
    so the hottest ids are the smallest integers and p(k) ∝ (k+1)^-alpha.
    This is the canonical embedding-lookup workload (DeepRecSys-style
    skew): the serving caches, bench_serving experiment 6 and the cache
    examples all draw from it. Deterministic under (n, vocab, alpha,
    seed) — replay yields the identical array."""
    if vocab < 1:
        raise ValueError(f"vocab must be >= 1, got {vocab}")
    rng = np.random.default_rng(seed)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -float(alpha)
    p /= p.sum()
    return rng.choice(vocab, size=int(n), p=p).astype(np.int64)


def update_event_stream(
    rate_per_s: float, horizon_s: float, vocab: int,
    rows_per_event: int = 32, *, alpha: float = 1.1, seed: int = 0,
) -> Iterator[Tuple[float, Tuple[int, ...]]]:
    """Lazy, time-sorted (t, ids) stream of embedding-table updates for
    `EventLoop.add_stream("shard_update", ...)`: Poisson event times
    (exponential gaps at `rate_per_s`) up to `horizon_s`, each event
    publishing `rows_per_event` Zipf(alpha)-hot row ids over [0, vocab).
    Hot rows update most often — exactly the rows the caches hold — so
    this is the adversarial workload for the shard tier's versioned
    invalidation (serving/shard.py): without it, staleness climbs with
    the update rate. Deterministic under the argument tuple, and lazy
    like the arrival streams: one pending event, not a materialised
    list."""
    if rate_per_s <= 0.0:
        return
    rng = np.random.default_rng(seed)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -float(alpha)
    p /= p.sum()
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_per_s)
        if t >= horizon_s:
            return
        ids = rng.choice(vocab, size=int(rows_per_event), p=p)
        yield t, tuple(int(i) for i in ids)


def bimodal_cost_mix(
    rank_cost: int = 512, rank_frac: float = 0.1, *,
    point_cost: int = 1, spread: float = 0.0, modes: int = 3,
) -> Tuple[Tuple[int, float], ...]:
    """Weighted (cost, weight) mix for `poisson_arrivals(cost_mix=...)`
    modelling the DeepRecSys bimodal query-size distribution: a
    POINTWISE mode (`point_cost` items — one user/item probe) carrying
    `1 - rank_frac` of the traffic and a RANKING mode at `rank_cost`
    candidates carrying the rest. `spread` > 0 widens the ranking mode
    into `modes` sizes over [rank_cost*(1-spread), rank_cost*(1+spread)]
    with binomial-shaped weights — real candidate sets are not all
    exactly 512 — which exercises the size-aware router's class
    decision at more than one point on the curve. Pure and
    deterministic: same arguments, same tuple.

        bimodal_cost_mix()                      -> ((1, 0.9), (512, 0.1))
        bimodal_cost_mix(spread=0.25, modes=3)  -> pointwise + ranking
                                                   at 384/512/640
    """
    if not 0.0 <= rank_frac <= 1.0:
        raise ValueError(f"rank_frac must be in [0, 1], got {rank_frac}")
    mix = []
    if rank_frac < 1.0:
        mix.append((int(point_cost), 1.0 - rank_frac))
    if rank_frac > 0.0:
        if spread <= 0.0 or modes <= 1:
            mix.append((int(rank_cost), rank_frac))
        else:
            sizes = np.linspace(rank_cost * (1.0 - spread),
                                rank_cost * (1.0 + spread), int(modes))
            # binomial-shaped weights: the central size dominates
            w = np.array([float(math.comb(modes - 1, k))
                          for k in range(int(modes))])
            w = w / w.sum() * rank_frac
            mix.extend((max(int(round(s)), 1), float(wk))
                       for s, wk in zip(sizes, w))
    return tuple(mix)


def criteo_batches(
    cfg: RecSysConfig, batch: int, steps: int, *, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Criteo-like batches for fm/autoint: Zipf ids, labels from hidden
    per-field-pair crossing weights (so FM-family models can fit them)."""
    rng = np.random.default_rng(seed)
    F = len(cfg.fields)
    vocabs = np.array([f.vocab for f in cfg.fields])
    hid = rng.normal(size=(F, 8)).astype(np.float32) * 0.5
    id_vec = rng.normal(size=(64, 8)).astype(np.float32)

    for _ in range(steps):
        u = rng.random((batch, F))
        idx = np.floor((vocabs[None, :]) * u ** 3).astype(np.int64)  # zipf-ish
        idx = np.minimum(idx, vocabs[None, :] - 1)
        e = id_vec[idx % 64] * hid[None, :, :]
        s = e.sum(axis=1)
        logits = 0.5 * (np.square(s).sum(-1) - np.square(e).sum(axis=(1, 2)))
        label = (logits > np.median(logits)).astype(np.float32)
        yield {"sparse_idx": idx.astype(np.int32), "label": label}


def random_graph(
    n_nodes: int, avg_degree: int, *, d_feat: Optional[int] = None,
    n_classes: int = 7, seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Random geometric graph in R^3 with community-ish labels."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n_nodes, 3)).astype(np.float32) * 2.0
    n_edges = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, n_edges)
    # bias edges toward spatial proximity: sample candidates, keep closest
    cand = rng.integers(0, n_nodes, (n_edges, 4))
    d = np.linalg.norm(pos[cand] - pos[src][:, None], axis=-1)
    dst = cand[np.arange(n_edges), np.argmin(d, axis=1)]
    g = {
        "positions": pos,
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
        "labels": (np.linalg.norm(pos, axis=1) * n_classes / 4).astype(np.int32) % n_classes,
    }
    if d_feat:
        w = rng.normal(size=(3, d_feat)).astype(np.float32)
        g["features"] = (pos @ w + 0.1 * rng.normal(size=(n_nodes, d_feat))).astype(
            np.float32
        )
    else:
        g["species"] = rng.integers(0, 16, n_nodes).astype(np.int32)
    return g


def molecule_batch(
    n_graphs: int, n_nodes: int = 30, n_edges: int = 64, *, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Flattened batch of small molecules; energies from a pairwise
    Lennard-Jones-ish ground truth (learnable by NequIP)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n_graphs, n_nodes, 3)).astype(np.float32) * 1.5
    species = rng.integers(0, 8, (n_graphs, n_nodes)).astype(np.int32)
    src = rng.integers(0, n_nodes, (n_graphs, n_edges))
    dst = rng.integers(0, n_nodes, (n_graphs, n_edges))
    d = np.linalg.norm(
        pos[np.arange(n_graphs)[:, None], src] - pos[np.arange(n_graphs)[:, None], dst],
        axis=-1,
    )
    energy = np.sum(np.exp(-d) - 0.1 * d, axis=1).astype(np.float32)

    off = (np.arange(n_graphs) * n_nodes)[:, None]
    return {
        "positions": pos.reshape(-1, 3),
        "species": species.reshape(-1),
        "edge_src": (src + off).reshape(-1).astype(np.int32),
        "edge_dst": (dst + off).reshape(-1).astype(np.int32),
        "graph_ids": np.repeat(np.arange(n_graphs), n_nodes).astype(np.int32),
        "energies": energy,
    }


def lm_token_batches(
    vocab: int, batch: int, seq: int, steps: int, *, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-chain token streams (learnable bigram structure)."""
    rng = np.random.default_rng(seed)
    # sparse bigram transition: each token has 8 likely successors
    succ = rng.integers(0, vocab, (vocab, 8))
    for _ in range(steps):
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        for t in range(seq):
            pick = succ[toks[:, t], rng.integers(0, 8, batch)]
            rand = rng.integers(0, vocab, batch)
            use_rand = rng.random(batch) < 0.1
            toks[:, t + 1] = np.where(use_rand, rand, pick)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
