"""ctypes binding of the Hopper EmbeddingBag kernel (`csrc/embedding_bag.cu`).

Replaces the Pallas TPU kernel `repro/kernels/embedding_bag/embedding_bag.py:embedding_bag`.
The caller (`ops.embedding_bag_op`) has checked device, dtypes, shapes and
contiguity; this module picks the load width and the launch plan
(`launch_plan`), allocates the output and launches on the current stream.
The library is built at first use, never at import.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

# threads that keep an H100 busy: 132 SMs x 1,024 (the kernel's 8-warp
# blocks, four of them an SM)
TARGET_THREADS = 132 * 1024


class Plan(NamedTuple):
    group: int  # lanes that cover a row (computed again by the C entry from d and vec)
    split: int  # groups that walk one bag's ids, each a contiguous run: the C entry's `split`


def launch_plan(B: int, nnz: int, d: int, vec: int) -> Plan:
    """How many lanes own a bag, a pure function of the shape. `group`
    covers d in `vec`-float chunks (a power of two, at most 32); `split`
    doubles while the bags' lanes are fewer than TARGET_THREADS, a bag has
    ids for every run and the bag's lanes fit in a warp. A bag of one id
    never splits."""
    nchunks, group = d // vec, 1
    while group < nchunks and group < 32:
        group *= 2
    split = 1
    while group * split * 2 <= 32 and split * 2 <= nnz and B * group * split < TARGET_THREADS:
        split *= 2
    return Plan(group, split)


def load_width(table: torch.Tensor) -> int:
    """Floats a lane loads at once from a row of `table` [V, d]: 4 (16 bytes)
    when d % 4 == 0 and the data is 16-byte aligned, 2 when d % 2 == 0 and it
    is 8-byte aligned, else 1. The output, allocated here, is always aligned
    at least as well."""
    d, ptr = table.shape[1], table.data_ptr()
    for vec in (4, 2):
        if d % vec == 0 and ptr % (4 * vec) == 0:
            return vec
    return 1


def embedding_bag(
    table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor],
    split: Optional[int] = None, *, row0: int = 0, id_limit: Optional[int] = None,
) -> torch.Tensor:
    """table: f32 [V,d]; idx: int32 [B,nnz]; weights: f32 [B,nnz] or None
    (all ones), all contiguous on the current CUDA device -> f32 [B,d].
    `split` None takes `launch_plan`'s; a given split forces it. `table`
    holds the rows [row0, row0 + V) of a table of `id_limit` rows (None:
    row0 + V); an id outside that block adds nothing and reads no row."""
    B, nnz = idx.shape
    V, d = table.shape
    vec = load_width(table)
    if split is None:
        split = launch_plan(B, nnz, d, vec).split
    out = torch.empty((B, d), dtype=torch.float32, device=table.device)
    err = _build.function("embedding_bag", "embedding_bag_f32", _ARGTYPES)(
        table.data_ptr(), idx.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        B, nnz, V, d, vec, split, row0, row0 + V if id_limit is None else id_limit,
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError {err}")
    return out
