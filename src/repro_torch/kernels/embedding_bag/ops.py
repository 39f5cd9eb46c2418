"""Wrapper for the EmbeddingBag kernel: checks, dispatch and a launch count.

A CPU tensor goes to the plain version (`ref.embedding_bag_ref`); a CUDA
tensor goes to the Hopper kernel, or the call raises. There is no fallback
from the kernel to the plain version. A fake tensor takes the shape-only
path (`_checks.shape_only`): an empty [B, d] output, no launch counted.
A kernel launch and a shape-only call each hand the kernel's work to an
active counter (`kernels/work.record`).

The lookup is differentiable through `torch.autograd.Function`: the
forward is the kernel (or the plain version), the backward plain PyTorch
on either device, as JAX's gather gradient is XLA's scatter-add and not a
Pallas kernel. The table's gradient (`_table_grad`) adds each row's terms
in one fixed order on either device, so a training step repeats bit for
bit.

A row range (`row0`, `id_limit`) makes `table` the block of rows
[row0, row0 + V) of a table of `id_limit` rows split by rows across
ranks: ids are the whole table's, an id outside the block adds nothing,
and the table gradient adds into the block's rows only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels._checks import check_tensor, dispatch_device, shape_only
from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.work import embedding_bag_work, record

# Kernel launches made through `embedding_bag_op`, in this process. Callers
# that count (the serve launcher, chip_smoke.py) reset it to 0 themselves.
launches = 0


def _bag(table, idx, weights, row0, id_limit):
    global launches
    work = lambda: embedding_bag_work(table, idx, weights, row0, dense=True)  # noqa: E731
    if shape_only(table, idx, weights):
        record("embedding_bag", work)
        return table.new_empty((idx.shape[0], table.shape[1]))
    if table.device.type == "cpu":
        return embedding_bag_ref(table, idx, weights, row0, id_limit)
    out = embedding_bag(table, idx, weights, row0=row0, id_limit=id_limit)
    launches += 1
    record("embedding_bag", work)
    return out


class Segments(NamedTuple):
    """ids [M] grouped by value for a fixed-order sum into `n` rows: `order`,
    a stable argsort of ids; `lengths` [n], the int64 count of each id."""
    ids: torch.Tensor
    order: torch.Tensor
    lengths: torch.Tensor


def segments(ids: torch.Tensor, n: int) -> Segments:
    """Group `ids` (any shape, flattened; values in [0, n)). Integer counts
    do not depend on the order of their adds, so `index_add_` gives the
    same lengths on either device and in every run."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    lengths = torch.zeros(n, dtype=torch.int64, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int64))
    return Segments(flat, order, lengths)


def segment_sum(rows: torch.Tensor, seg: Segments) -> torch.Tensor:
    """out[v] = Σ of `rows` [M, ...] whose id is v, [n, ...], each v's terms
    added from the first to the last in the order of M: the same bits on
    either device and in every run. `segment_reduce` adds each run of the
    sorted rows in order, without a wait for the device; a v no id names
    gets 0. Rows go in as [M, -1]: on CUDA a 1-D input takes a tree
    reduction (cub's segmented reduce), whose bits are not the CPU's.
    (`index_add_` adds with atomics on CUDA, and
    `index_put_(accumulate=True)` in parallel on the CPU.)"""
    out = torch.segment_reduce(rows[seg.order].reshape(rows.shape[0], -1), "sum",
                               lengths=seg.lengths, unsafe=True)
    return out.reshape(seg.lengths.shape[:1] + rows.shape[1:])


def _table_grad(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                row0: int = 0, ranged: bool = False) -> torch.Tensor:
    """d_table[v] = Σ of `rows` [B·nnz, d] whose id is row0 + v, in batch
    order. `ranged`: the ids outside the block go to one more segment past
    the last, which is dropped (no host sync, as a boolean mask would
    need), so that no row of the block has a term of them."""
    V = table.shape[0]
    if not ranged:
        return segment_sum(rows, segments(idx, V))
    local = idx.reshape(-1).long() - row0
    local = torch.where((local >= 0) & (local < V), local, V)
    return segment_sum(rows, segments(local, V + 1))[:V]


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, weights, row0, id_limit):
        ctx.save_for_backward(table, idx, weights)
        ctx.row0, ctx.ranged = row0, id_limit != table.shape[0]
        return _bag(table, idx, weights, row0, id_limit)

    @staticmethod
    def backward(ctx, dy):
        table, idx, weights = ctx.saved_tensors
        (B, nnz), d = idx.shape, table.shape[1]
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            rows = dy[:, None, :].expand(B, nnz, d)
            if weights is not None:
                rows = weights[..., None] * rows
            d_table = _table_grad(table, idx, rows.reshape(B * nnz, d), ctx.row0, ctx.ranged)
        if ctx.needs_input_grad[2]:
            if ctx.ranged:  # a foreign id's row is 0 here
                local = idx.long() - ctx.row0
                mine = (local >= 0) & (local < table.shape[0])
                rows = torch.where(mine[..., None], table[torch.where(mine, local, 0)], 0.0)
            else:
                rows = table.index_select(0, idx.reshape(-1)).reshape(B, nnz, d)
            d_weights = (rows * dy[:, None, :]).sum(dim=-1)
        return d_table, None, d_weights, None, None


def embedding_bag_op(
    table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor] = None, *,
    row0: int = 0, id_limit: Optional[int] = None,
) -> torch.Tensor:
    """table f32 [V,d] (any d), idx int32 [B,nnz], weights f32 [B,nnz] or
    None (all ones) -> f32 [B,d] = Σ_j weights[b,j] · table[idx[b,j]].
    With a row range, `table` holds the rows [row0, row0 + V) of a table
    of `id_limit` rows (None: row0 + V), and the sum runs over the ids
    that lie in it."""
    check_tensor(table, "table", 2, torch.float32)
    check_tensor(idx, "idx", 2, torch.int32)
    if weights is not None:
        check_tensor(weights, "weights", 2, torch.float32)
        if weights.shape != idx.shape:
            raise ValueError(f"weights {tuple(weights.shape)} != idx {tuple(idx.shape)}")
    B, nnz = idx.shape
    if B < 1 or nnz < 1:
        raise ValueError(f"need at least one bag of at least one id, got idx {tuple(idx.shape)}")
    V = table.shape[0]
    id_limit = row0 + V if id_limit is None else id_limit
    if row0 < 0 or row0 + V > id_limit:
        raise ValueError(f"rows [{row0}, {row0 + V}) are not a block of a table of {id_limit}")
    dispatch_device("embedding_bag_op", table=table, idx=idx, weights=weights)
    return _EmbeddingBag.apply(table, idx, weights, row0, id_limit)
