"""ctypes binding of the Hopper windowed-attention kernel (`csrc/local_attention.cu`).

Replaces the Pallas TPU kernel
`repro/kernels/local_attention/local_attention.py:local_attention`. The
caller (`ops.windowed_attention_op`) has checked device, dtypes, shapes and
that each view's rows are contiguous and 16-byte aligned; this module
picks the launch plan (`launch_plan`), allocates the output as a
[B, H, L, dh] view of a [B, L, H, dh] tensor and launches on the current
stream. The library is built at first use, never at import.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_pruned_matmul.block_pruned_matmul import H100_SMS, sm_count

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instances
ROWS_A_WARP = 16  # kRowsAWarp in csrc/local_attention.cu: the mma's m16
MAX_WARPS = 4  # kMaxWarps: 128 threads a block, eight blocks an SM at dh 16
SMEM_BYTES = 48 * 1024  # a block's staged tiles of k and v (the C entry takes up to 216 KB)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


class Plan(NamedTuple):
    warps: int    # warps a block, 16 query rows each
    rows: int     # query rows a block
    keys: int     # keys a staged tile of k and v
    q_tiles: int  # blocks along L, for each (b, h)
    buffers: int  # 1 where a tile holds a block's whole key span, else 2 (double-buffered)
    smem: int     # dynamic shared memory of a block, bytes


def row_strides(dh: int, elem_size: int) -> Tuple[int, int]:
    """Elements of a staged row of k and of v (mirrors `k_stride` and
    `v_stride` in csrc/local_attention.cu): dh + 8, and dh + 4 in f32 or
    dh + 8 in bf16, so that an mma fragment's loads fall in other banks and
    every row is a whole number of 16-byte copies."""
    return dh + 8, dh + 4 if elem_size == 4 else dh + 8


def key_bytes(dh: int, elem_size: int) -> int:
    """Shared memory a staged key takes, its row of k and its row of v."""
    return sum(row_strides(dh, elem_size)) * elem_size


def block_span(L: int, rows: int, window: int, causal: bool) -> int:
    """The keys a block of `rows` query rows can reach, at most."""
    return min(L, rows + (min(window, L) - 1) * (1 if causal else 2))


def launch_plan(BH: int, L: int, dh: int, window: int, causal: bool, elem_size: int,
                sms: int = H100_SMS) -> Plan:
    """The kernel's launch for BH (b, h) pairs of length L, a pure function
    of the shape: up to MAX_WARPS warps of 16 rows a block, as many as L
    needs (at least dh/32, so the block has dh threads to sum v's mean),
    halved while the grid would be under a block an SM; the block's key
    span staged whole where it fits SMEM_BYTES (at the C2 ranker's L 100,
    window 32, dh 16: one tile of all 100 keys), else in two buffers of
    tiles of a multiple of 8 keys."""
    least = max(1, dh // 32)
    warps = max(least, min(MAX_WARPS, -(-L // ROWS_A_WARP)))
    while warps > least and BH * -(-L // (warps * ROWS_A_WARP)) < sms:
        warps //= 2
    warps = max(warps, least)
    rows = warps * ROWS_A_WARP
    span = block_span(L, rows, window, causal)
    kb = key_bytes(dh, elem_size)
    if span * kb <= SMEM_BYTES:
        keys, buffers = span, 1
    else:
        keys, buffers = SMEM_BYTES // (2 * kb) // 8 * 8, 2
    return Plan(warps, rows, keys, -(-L // rows), buffers, buffers * keys * kb)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                    causal: bool, kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """q, k, v: f32 or bf16 [B, H, L, dh] views (rows contiguous, 16-byte
    aligned), dh in `HEAD_DIMS`; kv_len int32 [B] or None; on the current
    CUDA device -> [B, H, L, dh], a view of a [B, L, H, dh] tensor."""
    B, H, L, dh = q.shape
    plan = launch_plan(B * H, L, dh, window, causal, q.element_size(), sm_count(q.device))
    out = torch.empty((B, L, H, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = _build.function("local_attention", "local_attention_fwd", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_len.data_ptr() if kv_len is not None else None, out.data_ptr(),
        ctypes.addressof(strides), B, H, L, dh, window, int(causal),
        int(q.dtype == torch.bfloat16), plan.warps, plan.rows, plan.keys,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"local_attention kernel launch failed: cudaError {err}")
    return out
