"""ctypes binding of the Hopper block-pruned matmul kernel (`csrc/block_pruned_matmul.cu`).

Replaces the Pallas TPU kernel
`repro/kernels/block_pruned_matmul/block_pruned_matmul.py:block_pruned_matmul`.
The caller (`ops.block_pruned_matmul_op`) has checked device, dtypes,
shapes and contiguity; this module allocates the output and launches on
the current stream. The library is built at first use, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def block_pruned_matmul(x: torch.Tensor, w: torch.Tensor, block_mask: torch.Tensor) -> torch.Tensor:
    """x f32 [M,K], w f32 [K,N], block_mask int32 [ceil(K/128), ceil(N/128)],
    all contiguous on the current CUDA device -> f32 [M,N]."""
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = _build.function("block_pruned_matmul", "block_pruned_matmul_f32", _ARGTYPES)(
        x.data_ptr(), w.data_ptr(), block_mask.data_ptr(), out.data_ptr(), M, K, N,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"block_pruned_matmul kernel launch failed: cudaError {err}")
    return out
