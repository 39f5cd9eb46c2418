"""ctypes binding of the Hopper AUGRU kernel (`csrc/augru.cu`).

Replaces the Pallas TPU kernel `repro/kernels/augru/augru.py:augru`. The
caller (`ops.augru_op`) has checked device, dtypes, shapes, contiguity and
that `wh` fits in a block's shared memory; this module allocates the output
and launches on the current stream. The library is built at first use,
never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# A block's shared memory on Hopper (sm_90): 227 KB.
MAX_SMEM_BYTES = 232_448
ROWS_PER_BLOCK = 4  # kRows in csrc/augru.cu

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def smem_bytes(g: int) -> int:
    """Dynamic shared memory of one block: h [4, g], wh [g, 3g], zh [4, 3g]
    in f32 (mirrors `smem_bytes` in csrc/augru.cu)."""
    return 4 * (ROWS_PER_BLOCK * g + 3 * g * g + 3 * ROWS_PER_BLOCK * g)


def augru(zx: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor, att: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """zx f32 [B,T,3g], wh f32 [g,3g], h0 f32 [B,g], att f32 [B,T], mask
    bool [B,T], all contiguous on the current CUDA device -> f32 [B,g]."""
    B, T, _ = zx.shape
    g = wh.shape[0]
    out = torch.empty((B, g), dtype=torch.float32, device=zx.device)
    err = _build.function("augru", "augru_f32", _ARGTYPES)(
        zx.data_ptr(), wh.data_ptr(), h0.data_ptr(), att.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B, T, g, torch.cuda.current_stream(zx.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"augru kernel launch failed: cudaError {err}")
    return out
