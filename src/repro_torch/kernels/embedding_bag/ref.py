"""Plain PyTorch version of the embedding-bag kernel.

`out[b] = Σ_j w[b,j] · table[idx[b,j]]`: a flat `index_select`, then a
weighted sum over `nnz`. With `weights=None` every weight is 1 and the
multiply is skipped, so a bag of one is the exact gathered row. An id
outside `[0, V)` raises (`index_select` checks its indices).

With a row range (`row0`, `id_limit`), `table` is the block of rows
[row0, row0 + V) of a table of `id_limit` rows: an id outside [0,
id_limit) raises, one outside the block adds +0.0 and no row of it is read.
"""
from __future__ import annotations

from typing import Optional

import torch


def embedding_bag_ref(
    table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor] = None,
    row0: int = 0, id_limit: Optional[int] = None,
) -> torch.Tensor:
    """table: f32 [V, d]; idx: int [B, nnz]; weights: f32 [B, nnz] or None -> [B, d]."""
    B, nnz = idx.shape
    (V, d), flat = table.shape, idx.reshape(-1)
    if row0 == 0 and id_limit in (None, V):
        rows = table.index_select(0, flat).reshape(B, nnz, d)
        if weights is not None:
            rows = rows * weights[..., None]
        return rows.sum(dim=1)
    if bool(((flat < 0) | (flat >= id_limit)).any()):
        raise IndexError(f"an id lies outside [0, {id_limit})")
    local = flat.long() - row0
    mine = (local >= 0) & (local < V)
    rows = table.new_zeros((B * nnz, d))
    rows[mine] = table.index_select(0, local[mine])
    rows = rows.reshape(B, nnz, d)
    if weights is not None:
        rows = torch.where(mine.reshape(B, nnz, 1), rows * weights[..., None], 0.0)
    return rows.sum(dim=1)
