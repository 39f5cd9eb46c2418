"""ctypes binding of the Hopper W8A8 int8 matmul kernel (`csrc/int8_matmul.cu`).

Replaces the Pallas TPU kernel `repro/kernels/int8_matmul/int8_matmul.py:int8_matmul`.
The caller (`ops.int8_matmul_op`) has checked device, dtypes, shapes and
contiguity; this module picks the launch plan (`launch_plan`) and the load
widths (`load_widths`), allocates the output and launches on the current
stream. The library is built at first use, never at import.

The plan is a pure function of (M, K, N, SMs): the tile of out a block
owns (64 x 256 where that gives a wave of tiles, else 32 x 64) and how
many blocks walk the M tiles; the C entry owns the shared-memory layout.
Every tile takes all of K in one block, so its int32 sums end in one
place and the epilogue runs once (a split of K would fill the card no
better at any shape the port times: 512³ already has 128 tiles).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_pruned_matmul.block_pruned_matmul import H100_SMS, sm_count

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class TileShape(NamedTuple):
    bm: int       # rows of out a block
    bn: int       # columns of out a block
    threads: int  # threads a block
    per_sm: int   # blocks an SM its registers allow (the kernel's MIN_BLOCKS)


WIDE, SMALL = 0, 1  # the C entry's `tile`
TILES = {WIDE: TileShape(64, 256, 256, 2), SMALL: TileShape(32, 64, 128, 4)}
MAX_GRID_N = 65535  # the grid's y limit: N tiles


class Plan(NamedTuple):
    tile: int     # the C entry's `tile`: a key of TILES
    grid_m: int   # blocks along M; each walks the M tiles grid_m apart
    grid_n: int   # blocks along N
    va: int       # bytes a copy of a_q's rows: 16, 4 or 1, the widest K takes
    vb: int       # bytes a copy of b_q's rows, the widest N takes

    @property
    def blocks(self) -> int:
        return self.grid_m * self.grid_n


def vector_width(row_bytes: int) -> int:
    """The widest copy (16, 4 or 1 bytes) that tiles rows of `row_bytes`."""
    return next(v for v in (16, 4, 1) if row_bytes % v == 0)


def m_tiles(M: int, tile: int) -> int:
    return -(-M // TILES[tile].bm)


def launch_plan(M: int, K: int, N: int, sms: int = H100_SMS) -> Plan:
    """The kernel's launch for a_q [M,K] @ b_q [K,N], a pure function of the
    shape. The tile: WIDE where it gives at least `sms` tiles of out (the
    ranker's 51,200 x 64 x 256: 800 tiles, a block's columns all of N, so
    a_q is read once); else SMALL (512³: 128 tiles, one wave). The grid:
    as many blocks as the SMs hold at once (`per_sm` each), at most one a
    tile; a block walks the M tiles grid_m apart, all of K each, with the
    next tile's stages in flight while it stores one."""
    if min(M, K, N, sms) < 1:
        raise ValueError(f"need M, K, N and sms of at least 1, got {M}, {K}, {N}, {sms}")
    tile = WIDE if m_tiles(M, WIDE) * -(-N // TILES[WIDE].bn) >= sms else SMALL
    grid_n = -(-N // TILES[tile].bn)
    return tile_plan(M, K, N, tile,
                     min(m_tiles(M, tile), max(1, sms * TILES[tile].per_sm // grid_n)))


def tile_plan(M: int, K: int, N: int, tile: int, grid_m: Optional[int] = None) -> Plan:
    """The launch of `tile` at this shape with `grid_m` blocks along M (None:
    a block a tile); the card-only tests and chip_smoke.py force tiles
    with it."""
    if tile not in TILES:
        raise ValueError(f"no such tile: {tile}")
    tiles_m, grid_n = m_tiles(M, tile), -(-N // TILES[tile].bn)
    grid_m = tiles_m if grid_m is None else grid_m
    if not 1 <= grid_m <= tiles_m:
        raise ValueError(f"grid_m {grid_m} outside [1, {tiles_m}] for tile {tile} at M={M}")
    if grid_n > MAX_GRID_N:
        raise ValueError(f"N {N} needs more than {MAX_GRID_N} column tiles")
    return Plan(tile, grid_m, grid_n, vector_width(K), vector_width(N))


def load_widths(plan: Plan, a_q: torch.Tensor, b_q: torch.Tensor) -> tuple:
    """The plan's copy widths, lowered where a_q's or b_q's base is not
    aligned to them (a view that starts inside an allocation)."""
    return tuple(next(v for v in (16, 4, 1) if v <= w and t.data_ptr() % v == 0)
                 for w, t in ((plan.va, a_q), (plan.vb, b_q)))


def int8_matmul(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: torch.Tensor,
                b_scale: torch.Tensor, plan: Optional[Plan] = None) -> torch.Tensor:
    """a_q int8 [M,K], b_q int8 [K,N], a_scale f32 [M], b_scale f32 [N], all
    contiguous on the current CUDA device -> f32 [M,N]. `plan` None takes
    `launch_plan` at the card's SM count; a given plan (`tile_plan`)
    forces its tile and grid."""
    M, K = a_q.shape
    N = b_q.shape[1]
    if plan is None:
        plan = launch_plan(M, K, N, sm_count(a_q.device))
    elif plan != tile_plan(M, K, N, plan.tile, plan.grid_m):
        raise ValueError(f"no such launch at M={M}, K={K}, N={N}: {plan}")
    va, vb = load_widths(plan, a_q, b_q)
    out = torch.empty((M, N), dtype=torch.float32, device=a_q.device)
    err = _build.function("int8_matmul", "int8_matmul_s8", _ARGTYPES)(
        a_q.data_ptr(), b_q.data_ptr(), a_scale.data_ptr(), b_scale.data_ptr(), out.data_ptr(),
        M, K, N, plan.tile, plan.grid_m, va, vb, torch.cuda.current_stream(a_q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    return out
