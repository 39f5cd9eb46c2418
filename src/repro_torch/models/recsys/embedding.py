"""Sparse embedding substrate for the recsys family (port of `repro.models.recsys.embedding`).

Two layouts, as in `repro`:

  * unified table — all equal-dim fields concatenated into one
    [sum_vocab, d] table with static per-field offsets;
  * named tables — per-field tables for heterogeneous dims (user 16-d vs
    item 64-d in taobao_ssa), with `shares=` aliasing (history reuses the
    item table).

Every lookup of an f32 table goes through the Hopper EmbeddingBag kernel
(`kernels/embedding_bag`): a plain gather is a bag of one per id with unit
weight, which the kernel reproduces exactly. An int8 table {"q","s"} is
gathered and then dequantized in plain torch, as `repro` does in jnp:
neither package has a kernel for int8 rows.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
from repro_torch.models.common import ParamDef


# ---------------------------------------------------------------------------
# Unified-table layout (equal-dim fields: fm / autoint)
# ---------------------------------------------------------------------------


def unified_offsets(cfg: RecSysConfig) -> np.ndarray:
    """Static row offsets of each field inside the unified table."""
    offs = np.zeros(len(cfg.fields), np.int64)
    acc = 0
    for i, f in enumerate(cfg.fields):
        offs[i] = acc
        acc += f.vocab
    return offs


def _pad_rows(rows: int, multiple: int = 512) -> int:
    """Tables are padded to a multiple of 512 rows, as in `repro` (whose
    row-sharded tables must divide the mesh); padding rows are never
    addressed by real ids, but the padded shape is what parameter
    transfer between the packages carries."""
    return -(-rows // multiple) * multiple


def unified_table_def(cfg: RecSysConfig, extra_dim: int = 0) -> ParamDef:
    """[padded Σ vocab, d] with d = `extra_dim` or the config's embed_dim."""
    return ParamDef((_pad_rows(cfg.table_rows()), extra_dim or cfg.embed_dim),
                    torch.float32, "embed")


def _take_rows(table, rows: torch.Tensor) -> torch.Tensor:
    """Gather rows from a table in any representation: rows.shape + (d,).

    f32 table: through the EmbeddingBag kernel as bags of one ([N, 1] ids,
    unit weights), exactly the gathered rows. int8 {"q": int8 [V,d],
    "s": f32 [V]}: gather, then dequantize with the per-row scale."""
    if isinstance(table, dict):
        r = rows.long()
        return table["q"][r].to(torch.float32) * table["s"][r][..., None]
    flat = rows.to(torch.int32).reshape(-1, 1).contiguous()
    return embedding_bag_op(table, flat).reshape(*rows.shape, table.shape[1])


def unified_lookup(table, sparse_idx: torch.Tensor, cfg: RecSysConfig) -> torch.Tensor:
    """sparse_idx: [B, n_fields] per-field local ids -> [B, n_fields, d]."""
    offs = torch.as_tensor(unified_offsets(cfg), dtype=torch.int32, device=sparse_idx.device)
    return _take_rows(table, sparse_idx + offs[None, :])


# ---------------------------------------------------------------------------
# EmbeddingBag: multi-hot gather + reduce
# ---------------------------------------------------------------------------


def embedding_bag(
    table,
    idx: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    combiner: str = "sum",
) -> torch.Tensor:
    """torch.nn.EmbeddingBag equivalent.

    table: [V, d] f32 or int8 {"q","s"}; idx: [B, nnz] int; mask: [B, nnz]
    (1 = valid, or any per-entry weight). An f32 table is one kernel call
    with the mask as the bag weights; an int8 table is gathered,
    dequantized and reduced in plain torch."""
    B, nnz = idx.shape
    w = None if mask is None else mask.to(torch.float32).contiguous()
    if isinstance(table, dict):
        flat = _take_rows(table, idx)  # [B, nnz, d]
        if w is not None:
            flat = flat * w[..., None]
        out = flat.sum(dim=1)
    else:
        out = embedding_bag_op(table, idx.to(torch.int32).contiguous(), w)
    if combiner == "mean":
        denom = (
            torch.clamp(w.sum(dim=1), min=1)[:, None]
            if w is not None
            else torch.full((B, 1), float(nnz), dtype=out.dtype, device=out.device)
        )
        out = out / denom
    return out


# ---------------------------------------------------------------------------
# Named per-field tables (din / dien / taobao_ssa)
# ---------------------------------------------------------------------------


def named_table_defs(cfg: RecSysConfig) -> Dict[str, ParamDef]:
    defs = {}
    for f in cfg.owned_fields():
        d = cfg.field_dim(f)
        defs[f.name] = ParamDef((_pad_rows(f.vocab), d), torch.float32, "embed")
    return defs


def table_for(params_tables, cfg: RecSysConfig, field_name: str):
    f = {f.name: f for f in cfg.fields}[field_name]
    return params_tables[f.shares or f.name]


def field_lookup(params_tables, cfg: RecSysConfig, field_name: str, idx: torch.Tensor):
    """Single- or multi-hot lookup for one named field."""
    return _take_rows(table_for(params_tables, cfg, field_name), idx)
