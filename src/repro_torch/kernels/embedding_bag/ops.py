"""Wrapper for the EmbeddingBag kernel: checks, dispatch and a launch count.

A CPU tensor goes to the plain version (`ref.embedding_bag_ref`); a CUDA
tensor goes to the Hopper kernel, or the call raises. There is no fallback
from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

# Kernel launches made through `embedding_bag_op`, in this process. Callers
# that count (the serve launcher, chip_smoke.py) reset it to 0 themselves.
launches = 0


def _check(t: torch.Tensor, name: str, ndim: int, dtype: torch.dtype) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def embedding_bag_op(
    table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """table f32 [V,d], idx int32 [B,nnz], weights f32 [B,nnz] or None
    (all ones) -> f32 [B,d] = Σ_j weights[b,j] · table[idx[b,j]]."""
    global launches
    _check(table, "table", 2, torch.float32)
    _check(idx, "idx", 2, torch.int32)
    if weights is not None:
        _check(weights, "weights", 2, torch.float32)
        if weights.shape != idx.shape:
            raise ValueError(f"weights {tuple(weights.shape)} != idx {tuple(idx.shape)}")
    B, nnz = idx.shape
    if B < 1 or nnz < 1:
        raise ValueError(f"need at least one bag of at least one id, got idx {tuple(idx.shape)}")
    # the kernel reads rows in 16-byte chunks
    if table.shape[1] % 4 != 0:
        raise ValueError(f"table width must be a multiple of 4, got {table.shape[1]}")
    if table.data_ptr() % 16 != 0:
        raise ValueError("table data must be 16-byte aligned")
    devices = {t.device for t in (table, idx, weights) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"table, idx and weights must share one device, got {devices}")
    dev = table.device
    if dev.type == "cpu":
        return embedding_bag_ref(table, idx, weights)
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag_op runs on cpu or cuda, not {dev}")
    # the kernel's library launches on the current device
    if dev.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors are on {dev} but the current device is cuda:{torch.cuda.current_device()}")
    out = embedding_bag(table, idx, weights)
    launches += 1
    return out
