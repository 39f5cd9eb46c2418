"""ctypes binding of the Hopper block-pruned matmul kernel (`csrc/block_pruned_matmul.cu`).

Replaces the Pallas TPU kernel
`repro/kernels/block_pruned_matmul/block_pruned_matmul.py:block_pruned_matmul`.
The caller (`ops.block_pruned_matmul_op`) has checked device, dtypes,
shapes and contiguity; this module picks the launch plan (`launch_plan`),
allocates the output and launches on the current stream. The library is
built at first use, never at import.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

H100_SMS = 132
ROWS = 0  # the CUDA-core path: lanes of a warp a row of out, f32 FMA
TALL = 1  # the tall kernel: 64 x 64 tiles, w's panel kept for every M tile a block walks
# tile id -> (rows of out, columns of out) a block; the C entry's `tile`
# (2 and 3: the small kernel, whose warp groups split the steps of K)
TILES = {TALL: (64, 64), 2: (32, 64), 3: (32, 32)}
K_GROUPS = {2: 2, 3: 4}  # the small kernel's warp groups over K, by tile
MAX_SPLITS = 8  # blocks of a cluster over one tile's K: the portable cluster size
ROWS_WARPS, ROWS_K = 4, 4  # the rows path: warps a block, terms of k a lane
MIN_K_TC = 32  # the tensor-core tiles' least K; the C entry refuses less
MAX_GRID_M = 65535  # the grid's y limit; blocks walk the M tiles past it
# M tiles a tall block walks: 4 where the grid has one column of tiles, 2
# where it has more (measured at the encoder's 51,200-row calls)
TALL_TILES_PER_BLOCK = (4, 2)


class Plan(NamedTuple):
    tile: int    # the C entry's `tile`: ROWS or a key of TILES
    grid_m: int  # the C entry's `grid_m`: blocks along M (each walks M tiles grid_m apart)
    blocks: int  # blocks in the grid
    splits: int = 1  # the C entry's `splits`: blocks (a cluster) that split one tile's K


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def rows_lanes(K: int, N: int) -> int:
    """Lanes a row of out on the rows path, as the C entry picks them: all 32
    over n when K < 8, else enough over n for N (at most 32) and over k for
    about ROWS_K terms a lane."""
    nl = 32 if K < 8 else min(32, _pow2_at_least(N))
    lanes = nl
    while lanes < 32 and lanes // nl * ROWS_K < K:
        lanes *= 2
    return lanes


def launch_plan(M: int, K: int, N: int, sms: int = H100_SMS) -> Plan:
    """The kernel's launch for x [M,K] @ w [K,N], a pure function of the shape.

    N < 8 or K < MIN_K_TC: the rows path (an n8 tile would be mostly
    padding, and below 32 terms 3xTF32's per-term error shows against an
    f32 matmul, as measured on the card). Else the tall 64 x 64 tile where
    its grid covers `sms` blocks (the encoder's 51,200-row calls); a tall
    block walks TALL_TILES_PER_BLOCK M tiles, keeping its panel of w. Else
    (M <= 512 and the like) the small kernel: a block a 32 x 32 tile of
    out, or 32 x 64 where 32 x 32 would give more blocks than SMs (fewer
    bytes of x and w an SM). Its K_GROUPS warp groups split a block's steps
    of K, and `splits` blocks of a cluster split a tile's K, since a small
    call's time goes with the bytes one SM has to pull, not with the
    grid's: `splits` doubles while the grid stays within a block an SM for
    32 x 32, two for 32 x 64 (as measured), and each block keeps 4 steps of
    16 columns.
    """
    if N < 8 or K < MIN_K_TC:
        blocks = -(-M // (ROWS_WARPS * (32 // rows_lanes(K, N))))
        return Plan(ROWS, blocks, blocks)
    m_tiles, n_tiles = -(-M // 64), -(-N // 64)
    if m_tiles * n_tiles >= sms:
        per = TALL_TILES_PER_BLOCK[0 if n_tiles == 1 else 1]
        grid_m = min(MAX_GRID_M, -(-m_tiles // per))
        return Plan(TALL, grid_m, grid_m * n_tiles)
    tile = 3 if -(-M // 32) * -(-N // 32) <= sms else 2
    bm, bn = TILES[tile]
    grid_m = min(MAX_GRID_M, -(-M // bm))
    tiles = grid_m * -(-N // bn)
    splits, k_steps, wave = 1, -(-K // 16), sms if tile == 3 else 2 * sms
    while splits < MAX_SPLITS and tiles * splits * 2 <= wave and k_steps >= 4 * splits * 2:
        splits *= 2
    return Plan(tile, grid_m, tiles * splits, splits)


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (the plan's `sms`)."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_plan(plan: Plan, K: int) -> None:
    """Refuse a forced launch the C entry would refuse."""
    if plan.tile not in (ROWS, *TILES) or not 1 <= plan.grid_m <= MAX_GRID_M \
            or plan.splits not in (1, 2, 4, 8) or plan.splits > 1 and plan.tile in (ROWS, TALL):
        raise ValueError(f"no such launch: {plan}")
    if plan.tile != ROWS and K < MIN_K_TC:
        raise ValueError(f"tile {plan.tile} needs K >= {MIN_K_TC}, got K {K}: take the rows path")


def block_pruned_matmul(x: torch.Tensor, w: torch.Tensor, block_mask: torch.Tensor,
                        plan: Optional[Plan] = None) -> torch.Tensor:
    """x f32 [M,K], w f32 [K,N], block_mask int32 [ceil(K/128), ceil(N/128)],
    all contiguous on the current CUDA device -> f32 [M,N]. `plan` None
    takes `launch_plan` at the card's SM count; a given plan forces a tile
    (the tensor-core tiles need K >= MIN_K_TC)."""
    M, K = x.shape
    N = w.shape[1]
    if plan is None:
        plan = launch_plan(M, K, N, sm_count(x.device))
    else:
        _check_plan(plan, K)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = _build.function("block_pruned_matmul", "block_pruned_matmul_f32", _ARGTYPES)(
        x.data_ptr(), w.data_ptr(), block_mask.data_ptr(), out.data_ptr(), M, K, N,
        plan.tile, plan.grid_m, plan.splits, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"block_pruned_matmul kernel launch failed: cudaError {err}")
    return out
