"""ctypes binding of the Hopper EmbeddingBag kernel (`csrc/embedding_bag.cu`).

Replaces the Pallas TPU kernel `repro/kernels/embedding_bag/embedding_bag.py:embedding_bag`.
The caller (`ops.embedding_bag_op`) has checked device, dtypes, shapes,
contiguity and alignment; this module only allocates the output and
launches on the current stream. The library is built at first use, never
at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("embedding_bag").embedding_bag_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def embedding_bag(
    table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor]
) -> torch.Tensor:
    """table: f32 [V,d]; idx: int32 [B,nnz]; weights: f32 [B,nnz] or None
    (all ones), all contiguous on the current CUDA device, d % 4 == 0 and
    the table 16-byte aligned -> f32 [B,d]."""
    B, nnz = idx.shape
    V, d = table.shape
    out = torch.empty((B, d), dtype=torch.float32, device=table.device)
    err = _fn()(
        table.data_ptr(), idx.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        B, nnz, V, d, torch.cuda.current_stream(table.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError {err}")
    return out
