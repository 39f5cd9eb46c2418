"""ctypes binding of the Hopper EmbeddingBag kernel (`csrc/embedding_bag.cu`).

Replaces the Pallas TPU kernel `repro/kernels/embedding_bag/embedding_bag.py:embedding_bag`.
The caller (`ops.embedding_bag_op`) has checked device, dtypes, shapes and
contiguity; this module picks the load width, allocates the output and
launches on the current stream. The library is built at first use, never
at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def load_width(table: torch.Tensor) -> int:
    """Floats a lane loads at once from a row of `table` [V, d]: 4 (16 bytes)
    when d % 4 == 0 and the data is 16-byte aligned, 2 when d % 2 == 0 and it
    is 8-byte aligned, else 1. The output, allocated here, is always aligned
    at least as well."""
    d, ptr = table.shape[1], table.data_ptr()
    for vec in (4, 2):
        if d % vec == 0 and ptr % (4 * vec) == 0:
            return vec
    return 1


def embedding_bag(
    table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor]
) -> torch.Tensor:
    """table: f32 [V,d]; idx: int32 [B,nnz]; weights: f32 [B,nnz] or None
    (all ones), all contiguous on the current CUDA device -> f32 [B,d]."""
    B, nnz = idx.shape
    V, d = table.shape
    out = torch.empty((B, d), dtype=torch.float32, device=table.device)
    err = _build.function("embedding_bag", "embedding_bag_f32", _ARGTYPES)(
        table.data_ptr(), idx.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        B, nnz, V, d, load_width(table), torch.cuda.current_stream(table.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError {err}")
    return out
