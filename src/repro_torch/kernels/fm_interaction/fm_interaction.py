"""ctypes binding of the Hopper FM interaction kernel (`csrc/fm_interaction.cu`).

Replaces the Pallas TPU kernel
`repro/kernels/fm_interaction/fm_interaction.py:fm_interaction_kernel`. The
caller (`ops.fm_interaction_op`) has checked device, dtype, shape and
contiguity; this module allocates the output and launches on the current
stream. The library is built at first use, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def fm_interaction(e: torch.Tensor) -> torch.Tensor:
    """e: f32 [B, F, k], contiguous on the current CUDA device -> f32 [B]."""
    B, F, k = e.shape
    out = torch.empty((B,), dtype=torch.float32, device=e.device)
    err = _build.function("fm_interaction", "fm_interaction_f32", _ARGTYPES)(
        e.data_ptr(), out.data_ptr(), B, F, k, torch.cuda.current_stream(e.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fm_interaction kernel launch failed: cudaError {err}")
    return out
