"""Plain PyTorch version of the embedding-bag kernel.

`out[b] = Σ_j w[b,j] · table[idx[b,j]]`: a flat `index_select`, then a
weighted sum over `nnz`. With `weights=None` every weight is 1 and the
multiply is skipped, so a bag of one is the exact gathered row. An id
outside `[0, V)` raises (`index_select` checks its indices).
"""
from __future__ import annotations

from typing import Optional

import torch


def embedding_bag_ref(
    table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """table: f32 [V, d]; idx: int [B, nnz]; weights: f32 [B, nnz] or None -> [B, d]."""
    B, nnz = idx.shape
    rows = table.index_select(0, idx.reshape(-1)).reshape(B, nnz, table.shape[1])
    if weights is not None:
        rows = rows * weights[..., None]
    return rows.sum(dim=1)
