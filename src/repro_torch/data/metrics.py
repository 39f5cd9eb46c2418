"""Ranking metrics for the paper's Fig 6: HitRate@K, NDCG@K, MRR (a numpy
copy of `repro.data.metrics`, which the port does not import)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def ranking_metrics(scores: np.ndarray, pos_idx: np.ndarray, k: int = 50) -> Dict[str, float]:
    """scores: [n_queries, n_cand]; pos_idx: [n_queries] index of the
    positive candidate. Returns HR@k, NDCG@k, MRR."""
    n, m = scores.shape
    order = np.argsort(-scores, axis=1)
    rank = np.empty_like(order)
    rows = np.arange(n)[:, None]
    rank[rows, order] = np.arange(m)[None, :]
    pos_rank = rank[np.arange(n), pos_idx]  # 0-based

    hr = float(np.mean(pos_rank < k))
    ndcg = float(np.mean(np.where(pos_rank < k, 1.0 / np.log2(pos_rank + 2.0), 0.0)))
    mrr = float(np.mean(1.0 / (pos_rank + 1.0)))
    return {"hit_rate": hr, "ndcg": ndcg, "mrr": mrr}


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary AUC (rank-sum)."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels > 0.5].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
