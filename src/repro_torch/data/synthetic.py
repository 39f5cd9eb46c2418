"""Synthetic Taobao-like data (port of the Taobao part of `repro.data.synthetic`).

Pure numpy, copied so the port imports nothing of `repro`: for the same
seed these generators give arrays identical to `repro.data.synthetic`'s.

Users have latent category preferences; histories are drawn from them;
labels come from a ground-truth logistic model on user-item affinity +
recency-weighted history match, so a model that learns gets HR@K well
above the 1/50 floor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

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
