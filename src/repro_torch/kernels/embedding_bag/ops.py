"""Wrapper for the EmbeddingBag kernel: checks, dispatch and a launch count.

A CPU tensor goes to the plain version (`ref.embedding_bag_ref`); a CUDA
tensor goes to the Hopper kernel, or the call raises. There is no fallback
from the kernel to the plain version.
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


def embedding_bag_op(
    table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """table f32 [V,d] (any d), idx int32 [B,nnz], weights f32 [B,nnz] or
    None (all ones) -> f32 [B,d] = Σ_j weights[b,j] · table[idx[b,j]]."""
    global launches
    check_tensor(table, "table", 2, torch.float32)
    check_tensor(idx, "idx", 2, torch.int32)
    if weights is not None:
        check_tensor(weights, "weights", 2, torch.float32)
        if weights.shape != idx.shape:
            raise ValueError(f"weights {tuple(weights.shape)} != idx {tuple(idx.shape)}")
    B, nnz = idx.shape
    if B < 1 or nnz < 1:
        raise ValueError(f"need at least one bag of at least one id, got idx {tuple(idx.shape)}")
    dev = dispatch_device("embedding_bag_op", table=table, idx=idx, weights=weights)
    if dev.type == "cpu":
        return embedding_bag_ref(table, idx, weights)
    out = embedding_bag(table, idx, weights)
    launches += 1
    return out
