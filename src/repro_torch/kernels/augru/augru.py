"""ctypes binding of the Hopper AUGRU kernel (`csrc/augru.cu`).

Replaces the Pallas TPU kernel `repro/kernels/augru/augru.py:augru`. The
caller (`ops.augru_op`) has checked device, dtypes, shapes, contiguity and
that `g` is at most `MAX_G`; this module picks the launch plan
(`launch_plan`), allocates the output and launches on the current stream.
The library is built at first use, never at import.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_pruned_matmul.block_pruned_matmul import H100_SMS, sm_count

# A block's shared memory and an SM's registers on Hopper (sm_90).
MAX_SMEM_BYTES = 232_448
SM_REGISTERS = 65_536
SPLIT = 4  # kS in csrc/augru.cu: lanes that split one unit's sum over j
UNITS_PER_WARP = 32 // SPLIT
MAX_ROWS = 64  # kMaxRows in csrc/augru.cu
ZX_BUFFERS = 3  # kZxBuffers: zx rows of steps t, t+1 and t+2
AM_STEPS = 128  # kAmSteps: steps of att and mask staged at once
# the kernel's template instances: terms of j a lane (ceil(g / SPLIT), rounded up)
KS_SIZES = (1, 2, 4, 8, 16, 24, 27, 32, 34)
MAX_G = SPLIT * KS_SIZES[-1]  # 136

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class Plan(NamedTuple):
    ks: int       # terms of j a lane: the kernel's template instance
    rows: int     # batch rows a block (a multiple of 4)
    blocks: int   # blocks in the grid
    threads: int  # threads a block: 8 units of g a warp
    smem: int     # dynamic shared memory of a block, bytes
    regs: int     # floats a lane keeps in registers across a step: wh's 3*ks, 12 sums
    reg_budget: int  # registers a thread may have with one block of `threads` an SM
    waves: int    # waves of blocks, at one block an SM


def zx_stride(g: int) -> int:
    """Floats of a row of zx in shared memory (mirrors csrc/augru.cu)."""
    g3 = 3 * g
    return g3 + (8 - g3 % 32) % 32


def smem_bytes(rows: int, g: int, ks: int) -> int:
    """A block's dynamic shared memory: h [2][rows/4][4*ks][4] f32, zx
    [3][rows][zx_stride] f32, att [rows][AM_STEPS] f32, mask [rows][AM_STEPS]
    bytes (mirrors `smem_bytes` in csrc/augru.cu)."""
    return 4 * (2 * rows * SPLIT * ks + ZX_BUFFERS * rows * zx_stride(g) + rows * AM_STEPS) \
        + rows * AM_STEPS


def launch_plan(B: int, g: int, sms: int = H100_SMS) -> Plan:
    """The kernel's launch for a batch of B rows at width g, a pure function
    of the shape: a lane group of SPLIT lanes a unit, 8 units a warp; the
    rows a block the least multiple of 4 that puts the batch in one wave of
    `sms` blocks (4 at B = 512, 32 at B = 4096 on 132 SMs), as far as
    shared memory and MAX_ROWS allow; beyond that, more waves."""
    if not 1 <= g <= MAX_G or B < 1:
        raise ValueError(f"need B >= 1 and 1 <= g <= {MAX_G}, got B={B}, g={g}")
    ks = next(n for n in KS_SIZES if SPLIT * n >= g)
    threads = 32 * -(-g // UNITS_PER_WARP)
    cap = MAX_ROWS
    while cap > 4 and smem_bytes(cap, g, ks) > MAX_SMEM_BYTES:
        cap -= 4
    rows = min(cap, 4 * -(-B // (4 * sms)))
    blocks = -(-B // rows)
    reg_budget = min(255, SM_REGISTERS // threads // 8 * 8)
    return Plan(ks, rows, blocks, threads, smem_bytes(rows, g, ks), 3 * ks + 12, reg_budget,
                -(-blocks // sms))


def augru(zx: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor, att: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """zx f32 [B,T,3g], wh f32 [g,3g], h0 f32 [B,g], att f32 [B,T], mask
    bool [B,T], all contiguous on the current CUDA device -> f32 [B,g]."""
    B, T, _ = zx.shape
    g = wh.shape[0]
    plan = launch_plan(B, g, sm_count(zx.device))
    out = torch.empty((B, g), dtype=torch.float32, device=zx.device)
    err = _build.function("augru", "augru_f32", _ARGTYPES)(
        zx.data_ptr(), wh.data_ptr(), h0.data_ptr(), att.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B, T, g, plan.ks, plan.rows, plan.blocks, plan.threads,
        torch.cuda.current_stream(zx.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"augru kernel launch failed: cudaError {err}")
    return out
