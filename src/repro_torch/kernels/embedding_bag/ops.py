"""Wrapper for the EmbeddingBag kernel: checks, dispatch and a launch count.

A CPU tensor goes to the plain version (`ref.embedding_bag_ref`); a CUDA
tensor goes to the Hopper kernel, or the call raises. There is no fallback
from the kernel to the plain version.

The lookup is differentiable through `torch.autograd.Function`: the
forward is the kernel (or the plain version), the backward plain PyTorch
on either device, as JAX's gather gradient is XLA's scatter-add and not a
Pallas kernel. The table's gradient (`_table_grad`) adds each row's terms
in one fixed order on either device, so a training step repeats bit for
bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._checks import check_tensor, dispatch_device
from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

# Kernel launches made through `embedding_bag_op`, in this process. Callers
# that count (the serve launcher, chip_smoke.py) reset it to 0 themselves.
launches = 0


def _bag(table, idx, weights):
    global launches
    if table.device.type == "cpu":
        return embedding_bag_ref(table, idx, weights)
    out = embedding_bag(table, idx, weights)
    launches += 1
    return out


def _table_grad(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """d_table[v] = Σ of `rows` [B·nnz, d] whose id is v, each row's terms
    added from the first to the last in batch order: the same bits on
    either device and in every run. A stable sort groups each id's terms,
    integer counts give each row's run (an integer sum does not depend on
    its order), and `segment_reduce` adds each run in order, without a wait
    for the device. (`index_add_` adds with atomics on CUDA, and
    `index_put_(accumulate=True)` in parallel on the CPU.)"""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(table.shape[0], dtype=torch.int64, device=table.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int64))
    return torch.segment_reduce(rows[order], "sum", lengths=counts, unsafe=True)


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, weights):
        ctx.save_for_backward(table, idx, weights)
        return _bag(table, idx, weights)

    @staticmethod
    def backward(ctx, dy):
        table, idx, weights = ctx.saved_tensors
        (B, nnz), d = idx.shape, table.shape[1]
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            rows = dy[:, None, :].expand(B, nnz, d)
            if weights is not None:
                rows = weights[..., None] * rows
            d_table = _table_grad(table, idx, rows.reshape(B * nnz, d))
        if ctx.needs_input_grad[2]:
            d_weights = (table.index_select(0, idx.reshape(-1)).reshape(B, nnz, d)
                         * dy[:, None, :]).sum(dim=-1)
        return d_table, None, d_weights


def embedding_bag_op(
    table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """table f32 [V,d] (any d), idx int32 [B,nnz], weights f32 [B,nnz] or
    None (all ones) -> f32 [B,d] = Σ_j weights[b,j] · table[idx[b,j]]."""
    check_tensor(table, "table", 2, torch.float32)
    check_tensor(idx, "idx", 2, torch.int32)
    if weights is not None:
        check_tensor(weights, "weights", 2, torch.float32)
        if weights.shape != idx.shape:
            raise ValueError(f"weights {tuple(weights.shape)} != idx {tuple(idx.shape)}")
    B, nnz = idx.shape
    if B < 1 or nnz < 1:
        raise ValueError(f"need at least one bag of at least one id, got idx {tuple(idx.shape)}")
    dispatch_device("embedding_bag_op", table=table, idx=idx, weights=weights)
    return _EmbeddingBag.apply(table, idx, weights)
