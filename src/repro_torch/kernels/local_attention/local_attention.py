"""ctypes binding of the Hopper windowed-attention kernel (`csrc/local_attention.cu`).

Replaces the Pallas TPU kernel
`repro/kernels/local_attention/local_attention.py:local_attention`. The
caller (`ops.windowed_attention_op`) has checked device, dtypes, shapes and
contiguity; this module allocates the output and launches on the current
stream. The library is built at first use, never at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instances
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                    causal: bool, kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """q, k, v: f32 or bf16 [BH, L, dh], dh in `HEAD_DIMS`; kv_len int32
    [BH] or None; all contiguous on the current CUDA device -> [BH, L, dh]."""
    BH, L, dh = q.shape
    out = torch.empty_like(q)
    err = _build.function("local_attention", "local_attention_fwd", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_len.data_ptr() if kv_len is not None else None, out.data_ptr(),
        BH, L, dh, window, int(causal), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"local_attention kernel launch failed: cudaError {err}")
    return out
