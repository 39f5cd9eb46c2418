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

Across ranks. Every lookup takes `repro`'s `rules` (`distributed/sharding.
adapt_rules` of `RECSYS_RULES` to a `DeviceMesh`, which it threads under
"__mesh__"); None, or rules without a mesh, is the one-rank lookup. Under
`RECSYS_RULES` a table's rows are split over "model" (its spec
`P("model")`), and where that mesh dim has more than one rank each rank
holds the block [row0, row0 + V/m) (`sharding.block_slices`), int8 tables
their scales too. The ids are the batch's block of this rank, laid out by
the logical axis `batch` names ("batch", or "candidates" in retrieval).
The split lookup:

  * where the ids' layout splits them over "model" too (`serve_full_mesh`,
    retrieval's candidates), gathers them over "model" first;
  * looks up the ids in its own rows (the kernel's row range: a foreign
    id adds +0.0 and reads no row);
  * sums the ranks' parts back to the ids' layout: a reduce-scatter over
    "model" where it gathered, else an all-reduce (`sum_forward`: the
    result is replicated over "model", so its gradient is not summed).

That is where `repro`'s `constrain` of a lookup's output to the batch's
layout forces GSPMD's collective. Each id lives on one rank and the others
add +0.0, so the output is the one-rank lookup's bit for bit. An
EmbeddingBag over a split table (FM's first-order term) gathers its rows
so, then sums each bag through the kernel over those rows, as a bag over
the whole table sums them: the same bits again.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.core import spans
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import entry_axes, mesh_axis_names
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
                    torch.float32, "embed", axes=("rows", None))


class RowSplit(NamedTuple):
    """The mesh dim that splits the tables' rows: its name, process group,
    number of ranks and this rank's index along it."""
    axis: str
    group: Any
    ways: int
    index: int


def row_split(rules) -> Optional[RowSplit]:
    """The rows' split under `rules`, or None where the tables are whole on
    every rank (no rules, no mesh, no "rows" rule, or one rank along it)."""
    mesh = None if rules is None else rules.get("__mesh__")
    axis = None if mesh is None else rules.get("rows")
    if axis is None:
        return None
    if not isinstance(axis, str):
        raise ValueError(f"tables split over one mesh dim, not {axis!r}")
    ways = mesh.size(mesh_axis_names(mesh).index(axis))
    if ways == 1:
        return None
    return RowSplit(axis, mesh.get_group(axis), ways, mesh.get_local_rank(axis))


def _take_local(table, rows: torch.Tensor) -> torch.Tensor:
    if isinstance(table, dict):
        r = rows.long()
        return table["q"][r].to(torch.float32) * table["s"][r][..., None]
    flat = rows.to(torch.int32).reshape(-1, 1).contiguous()
    return embedding_bag_op(table, flat).reshape(*rows.shape, table.shape[1])


def _take_block(table, ids: torch.Tensor, split: RowSplit) -> torch.Tensor:
    """The rows of `ids` that this rank's block holds, +0.0 for the others."""
    V = (table["q"] if isinstance(table, dict) else table).shape[0]
    row0 = split.index * V
    if isinstance(table, dict):
        local = ids.long() - row0
        mine = (local >= 0) & (local < V)
        local = torch.where(mine, local, 0)
        rows = table["q"][local].to(torch.float32) * table["s"][local][..., None]
        return torch.where(mine[..., None], rows, 0.0)
    flat = ids.to(torch.int32).reshape(-1, 1).contiguous()
    out = embedding_bag_op(table, flat, row0=row0, id_limit=V * split.ways)
    return out.reshape(*ids.shape, table.shape[1])


def _take_rows(table, rows: torch.Tensor, rules=None, batch: str = "batch") -> torch.Tensor:
    """Gather rows from a table in any representation: rows.shape + (d,).

    f32 table: through the EmbeddingBag kernel as bags of one ([N, 1] ids,
    unit weights), exactly the gathered rows. int8 {"q": int8 [V,d],
    "s": f32 [V]}: gather, then dequantize with the per-row scale. Under
    `rules` that split the rows, this rank's block of the ids' rows, the
    ids laid out by the logical axis `batch` (see the module's
    docstring)."""
    split = row_split(rules)
    if split is None:
        return _take_local(table, rows)
    ids_axes = entry_axes(rules.get(batch))
    if split.axis not in ids_axes:
        return collectives.sum_forward(_take_block(table, rows, split), [split.group])
    if ids_axes[-1] != split.axis:
        raise ValueError(f"ids split over {ids_axes}: the rows' dim {split.axis!r} must be "
                         "the minor one")
    ids = collectives.gather(rows, 0, split.group)
    return collectives.reduce_scatter(_take_block(table, ids, split), 0, split.group)


def unified_lookup(table, sparse_idx: torch.Tensor, cfg: RecSysConfig,
                   rules=None) -> torch.Tensor:
    """sparse_idx: [B, n_fields] per-field local ids -> [B, n_fields, d]."""
    offs = torch.as_tensor(unified_offsets(cfg), dtype=torch.int32, device=sparse_idx.device)
    return _take_rows(table, sparse_idx + offs[None, :], rules)


# ---------------------------------------------------------------------------
# EmbeddingBag: multi-hot gather + reduce
# ---------------------------------------------------------------------------


def embedding_bag(
    table,
    idx: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    combiner: str = "sum",
    rules=None,
) -> torch.Tensor:
    """torch.nn.EmbeddingBag equivalent.

    table: [V, d] f32 or int8 {"q","s"}; idx: [B, nnz] int; mask: [B, nnz]
    (1 = valid, or any per-entry weight). An f32 table is one kernel call
    with the mask as the bag weights; an int8 table is gathered,
    dequantized and reduced in plain torch. Under `rules` that split the
    table's rows, the bags' rows are gathered first (`_take_rows`), then
    an f32 bag sums them through the kernel, each bag over its own rows."""
    B, nnz = idx.shape
    w = None if mask is None else mask.to(torch.float32).contiguous()
    if isinstance(table, dict):
        flat = _take_rows(table, idx, rules)  # [B, nnz, d]
        if w is not None:
            flat = flat * w[..., None]
        out = flat.sum(dim=1)
    elif row_split(rules) is None:
        out = embedding_bag_op(table, idx.to(torch.int32).contiguous(), w)
    else:
        rows = _take_rows(table, idx, rules).reshape(B * nnz, table.shape[1])
        own = torch.arange(B * nnz, dtype=torch.int32, device=idx.device).reshape(B, nnz)
        out = embedding_bag_op(rows, own, w)
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
        defs[f.name] = ParamDef((_pad_rows(f.vocab), d), torch.float32, "embed", axes=("rows", None))
    return defs


def table_for(params_tables, cfg: RecSysConfig, field_name: str):
    f = {f.name: f for f in cfg.fields}[field_name]
    return params_tables[f.shares or f.name]


def field_lookup(params_tables, cfg: RecSysConfig, field_name: str, idx: torch.Tensor,
                 rules=None):
    """Single- or multi-hot lookup for one named field."""
    with spans.span("lookup", idx, None, of=field_name):
        return _take_rows(table_for(params_tables, cfg, field_name), idx, rules)
