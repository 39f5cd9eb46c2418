"""ctypes binding of the Hopper W8A8 int8 matmul kernel (`csrc/int8_matmul.cu`).

Replaces the Pallas TPU kernel `repro/kernels/int8_matmul/int8_matmul.py:int8_matmul`.
The caller (`ops.int8_matmul_op`) has checked device, dtypes, shapes and
contiguity; this module allocates the output and launches on the current
stream. The library is built at first use, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def int8_matmul(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: torch.Tensor,
                b_scale: torch.Tensor) -> torch.Tensor:
    """a_q int8 [M,K], b_q int8 [K,N], a_scale f32 [M], b_scale f32 [N], all
    contiguous on the current CUDA device -> f32 [M,N]."""
    M, K = a_q.shape
    N = b_q.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a_q.device)
    err = _build.function("int8_matmul", "int8_matmul_s8", _ARGTYPES)(
        a_q.data_ptr(), b_q.data_ptr(), a_scale.data_ptr(), b_scale.data_ptr(), out.data_ptr(),
        M, K, N, torch.cuda.current_stream(a_q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    return out
