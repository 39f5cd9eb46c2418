"""The resident hot-row tier of an embedding table (port of `repro.core.caching`).

Embedding ids are Zipf-skewed, so a small RESIDENT table of the hottest
rows serves most lookups while the full table stays where it is:

    hot_ids                deterministic top-k hot ids of a stream
                           (frequency desc, id asc tie-break)
    build_resident_table   copy the hot rows out of the full table and
                           invert them into a [V] slot map (-1 = miss)
    residency_mask         per-lookup hit mask (the measured hit rate)
    cached_embedding_bag   rows selected from the resident tier or the full
                           table, then reduced exactly as the uncached
                           lookup (`models/recsys/embedding.embedding_bag`)
                           reduces them: the output is bitwise the uncached
                           one for any mix of hits and misses

The full table may be f32 [V, d] or the C5 int8 layout {"q": int8 [V, d],
"s": f32 [V]}; resident rows are kept dequantized (f32), paid once at
admission. An f32 reduce is one call of the EmbeddingBag kernel over the
selected rows, [B·nnz, d], with ids `arange(B·nnz)` in [B, nnz] bags:
the bag shape, and so the kernel's launch plan and its order of sums, is
the uncached call's. An int8 reduce is the uncached int8 path's plain one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.kernels.embedding_bag.embedding_bag import load_width
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
from repro_torch.models.recsys.embedding import _take_rows


def hot_ids(ids: np.ndarray, capacity: int) -> np.ndarray:
    """The `capacity` hottest ids of a stream, deterministically: sorted by
    (frequency desc, id asc), so equal-frequency ties never depend on hash
    or encounter order. Fewer unique ids than capacity returns them all."""
    uniq, counts = np.unique(np.asarray(ids).reshape(-1), return_counts=True)
    order = np.lexsort((uniq, -counts))  # freq desc, id asc within ties
    return uniq[order[: int(capacity)]].astype(np.int64)


@dataclasses.dataclass
class ResidentTable:
    """The hot tier: `rows` [C, d] f32 copies of the hot embedding rows,
    `slot_of` [V] int32 mapping id -> resident slot (-1 = not resident)."""

    rows: torch.Tensor
    slot_of: torch.Tensor

    @property
    def n_resident(self) -> int:
        return int(self.rows.shape[0])


def build_resident_table(table: Union[torch.Tensor, dict], resident_ids: np.ndarray,
                         vocab: Optional[int] = None) -> ResidentTable:
    """Copy `resident_ids` rows out of the full table (dequantizing the int8
    layout once, at admission) and build the inverse slot map, on the
    table's device."""
    q = table["q"] if isinstance(table, dict) else table
    ids = torch.as_tensor(np.asarray(resident_ids, np.int64), device=q.device)
    rows = (_take_rows(table, ids) if ids.numel() else  # the kernel takes no empty batch
            torch.zeros((0, q.shape[1]), dtype=torch.float32, device=q.device))
    if vocab is None:
        vocab = q.shape[0]
    slot_of = torch.full((vocab,), -1, dtype=torch.int32, device=q.device)
    slot_of[ids] = torch.arange(ids.shape[0], dtype=torch.int32, device=q.device)
    return ResidentTable(rows=rows, slot_of=slot_of)


def residency_mask(resident: ResidentTable, idx: torch.Tensor) -> torch.Tensor:
    """Boolean hit mask of a lookup batch; `.float().mean()` is the measured
    hit rate the simulator's EmbeddingCache models."""
    return resident.slot_of[idx.long()] >= 0


def cached_embedding_bag(
    table: Union[torch.Tensor, dict],
    resident: ResidentTable,
    idx: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    combiner: str = "sum",
) -> torch.Tensor:
    """EmbeddingBag through the resident tier: rows whose id is resident
    come from the small table, the rest from the full table.

    table: [V, d] f32 (or the int8 dict layout); idx: [B, nnz] int; mask:
    [B, nnz] (1 = valid, or any per-entry weight). Bitwise equal to
    `embedding_bag(table, idx, mask, combiner)`: resident rows are exact
    copies, and the reduce is the uncached one on the same rows."""
    B, nnz = idx.shape
    flat_idx = idx.reshape(-1).long()
    # the slow-tier fallback: an f32 table's rows by a plain gather, so that
    # the reduce below is the lookup's one kernel launch
    miss_rows = (_take_rows(table, flat_idx) if isinstance(table, dict)
                 else table.index_select(0, flat_idx))
    if resident.n_resident == 0:  # an empty tier: everything misses
        flat = miss_rows
    else:
        slot = resident.slot_of[flat_idx]
        hit_rows = resident.rows.index_select(0, torch.clamp(slot, min=0).long())
        flat = torch.where((slot >= 0)[:, None], hit_rows, miss_rows)
    w = None if mask is None else mask.to(torch.float32).contiguous()
    if isinstance(table, dict):  # the uncached int8 path's reduce
        rows = flat.reshape(B, nnz, -1)
        if w is not None:
            rows = rows * w[..., None]
        out = rows.sum(dim=1)
    else:
        if flat.is_cuda and load_width(flat) != load_width(table):
            raise ValueError(
                f"the selected rows load {load_width(flat)} floats at a time and the table "
                f"{load_width(table)}: the kernel's plan, and its order of sums, would differ "
                "from the uncached lookup's (the table is not 16-byte aligned)")
        bags = torch.arange(B * nnz, dtype=torch.int32, device=flat.device).view(B, nnz)
        out = embedding_bag_op(flat.contiguous(), bags, w)
    if combiner == "mean":
        denom = (
            torch.clamp(w.sum(dim=1), min=1)[:, None]
            if w is not None
            else torch.full((B, 1), float(nnz), dtype=out.dtype, device=out.device)
        )
        out = out / denom
    return out
