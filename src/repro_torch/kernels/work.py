"""The work of each kernel: the bytes it must move and the operations it
must do, and the least time the card could take for them.

The kernel benchmark (`launch/bench_kernels`) sets each row's bound from
these, and the dry run's counter (`launch/hlo_stats.Counter`) adds them up
for every kernel call a wrapper makes (`record`), so that the two read
the same work.

Bytes count each input read once and each output written once; where the
work depends on values (the tiles a block mask keeps, the keys a request's
length leaves, the distinct rows a lookup reads), a function counts what
the given values need. With `dense` it counts the dense upper bound from
shapes alone: every tile kept, every key in the window valid, every id of
a lookup a distinct row of the block. `dense` is the default on fake
tensors, which have no values, and the counter asks for it on real ones
too, so that a dry run and a real run of one cell count the same work.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.kernels.block_pruned_matmul.ref import expand_block_mask
from repro_torch.kernels.local_attention.ref import attention_mask

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s; f32
# FLOP/s outside the tensor cores; int8 tensor-core OP/s; f32-accurate
# products on the tensor cores as 3xTF32, a third of the 495 TFLOP/s of TF32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12
F32_3XTF32_FLOPS = 495e12 / 3


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS) -> Dict:
    """The least time the card could take: the larger of `nbytes` at the
    HBM rate and `flops` at `peak`, and which of the two it is."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def record(name: str, work: Callable[[], Dict]) -> None:
    """Hand one call of kernel `name` to every counter on the dispatch mode
    stack (`launch/hlo_stats.Counter`); `work()`, its `bound` dict, is
    reckoned only where a counter listens."""
    counters = [m for m in _get_current_dispatch_mode_stack() if hasattr(m, "add_kernel")]
    if counters:
        done = work()
        for c in counters:
            c.add_kernel(name, done)


def fm_interaction_work(B: int, F: int, k: int) -> Dict:
    """e read once and the output written once; per value s += v and
    q += v·v (3), per factor S², − and Σ (3), per example ½ (1)."""
    return bound(4 * B * F * k + 4 * B, B * (3 * F * k + 3 * k + 1))


def int8_matmul_work(M: int, K: int, N: int) -> Dict:
    """a_q and b_q read once (a byte an element), both scales, the f32
    output written once; 2·M·N·K int8 operations at the int8 rate."""
    return bound(M * K + K * N + 4 * M + 4 * N + 4 * M * N, 2 * M * N * K, INT8_OPS)


def augru_work(B: int, T: int, g: int) -> Dict:
    """zx, wh, h0, the attention and the mask read once, the final h
    written once; per row and step h @ wh (2·g·3g, the recurrence's dot
    flops) and 16 elementwise operations a unit."""
    nbytes = 4 * B * T * 3 * g + 4 * g * 3 * g + 4 * B * g + 4 * B * T + B * T + 4 * B * g
    return bound(nbytes, B * T * (6 * g * g + 16 * g))


def _window_pairs(L: int, window: int, causal: bool) -> int:
    """The (query, key) pairs |i − j| < window (and j ≤ i if causal) of L
    positions, every key valid."""
    w = min(window, L)
    return L * w - w * (w - 1) // 2 if causal else L * (2 * w - 1) - w * (w - 1)


def local_attention_work(q: torch.Tensor, window: int, causal: bool = False,
                         kv_len: Optional[torch.Tensor] = None,
                         dense: Optional[bool] = None) -> Dict:
    """The least work of one call, counted from this call's window,
    causality and key lengths. q: [B, H, L, dh]; kv_len [B] or None.

    Bytes: the output written once, `kv_len` read once, and of q, k and v
    only the rows the function needs: q's rows that have a valid key; k's
    keys that some query attends; v's likewise, but all L of a request's
    rows where one of its queries has no valid key, since that row is the
    mean of v over all L (as `repro`'s −1e30 mask makes it). Operations:
    per valid (query, key) pair 2·dh for q·k, 2·dh for p·v and 3 for the
    softmax (max, exp, sum); L·dh additions for each row with no valid
    key; one division per output element. `dense` (default: q is fake)
    takes every key valid: all L rows of q, k and v, the window's pairs."""
    B, H, L, dh = q.shape
    elem = q.element_size()
    kv_bytes = kv_len.numel() * 4 if kv_len is not None else 0
    if is_fake(q) if dense is None else dense:
        pairs = B * H * _window_pairs(L, window, causal)
        nbytes = B * H * dh * elem * 3 * L + q.numel() * elem + kv_bytes
        return {**bound(nbytes, pairs * (4 * dh + 3) + q.numel()), "pairs": pairs,
                "rows_without_keys": 0}
    mask = attention_mask(L, window, causal=causal, kv_len=kv_len, device=q.device)
    reps = B if mask.ndim == 2 else 1  # without kv_len one [L, L] mask serves every request
    mask = mask.reshape(-1, L, L)
    live_rows, live_keys = mask.any(dim=2), mask.any(dim=1)  # [b, L] each
    v_rows = torch.where(live_rows.all(dim=1), live_keys.sum(dim=1), L)
    rows_read = int(live_rows.sum()) + int(live_keys.sum()) + int(v_rows.sum())
    dead_rows = int((~live_rows).sum())
    nbytes = reps * H * dh * elem * rows_read + q.numel() * elem + kv_bytes
    pairs = reps * H * int(mask.sum())
    flops = pairs * (4 * dh + 3) + reps * H * dead_rows * L * dh + q.numel()
    return {**bound(nbytes, flops), "pairs": pairs, "rows_without_keys": reps * H * dead_rows}


def block_pruned_matmul_work(x: torch.Tensor, w: torch.Tensor, block_mask: torch.Tensor,
                             dense: Optional[bool] = None) -> Dict:
    """The least work of x @ (w ⊙ expand(block_mask)): the surviving weights
    once, the columns of x that meet a surviving tile once, the tile mask,
    the output once; 2 operations a surviving weight and row, at the rate
    of f32-accurate products on the tensor cores (3xTF32), with the time at
    the CUDA cores' f32 rate beside it. `dense` (default: the mask is
    fake) keeps every tile."""
    (M, K), N = x.shape, w.shape[1]
    if is_fake(block_mask) if dense is None else dense:
        surviving, live_k = K * N, K
    else:
        mask = expand_block_mask(block_mask, (K, N))
        surviving = int(mask.sum())
        live_k = int((mask.sum(dim=1) > 0).sum())
    nbytes = 4 * (M * live_k + surviving + block_mask.numel() + M * N)
    flops = 2 * M * surviving
    return {**bound(nbytes, flops, F32_3XTF32_FLOPS),
            "bound_peak": "3xTF32 on the tensor cores, 495/3 TFLOP/s",
            "bound_ms_f32_cores": bound(nbytes, flops)["bound_ms"]}


def embedding_bag_work(table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor],
                       row0: int = 0, dense: Optional[bool] = None) -> Dict:
    """Each distinct row of the block read once, the ids and weights once,
    the output written once; d multiply-adds an id that lies in the block
    (`table` holds rows [row0, row0 + V) of the whole table). `dense`
    (default: idx is fake) takes every id in the block and as many
    distinct rows as ids, up to V."""
    (B, nnz), (V, d) = idx.shape, table.shape
    if is_fake(idx) if dense is None else dense:
        in_block, uniq = B * nnz, min(B * nnz, V)
    else:
        local = idx.reshape(-1).long() - row0
        mine = local[(local >= 0) & (local < V)]
        in_block, uniq = int(mine.numel()), int(torch.unique(mine).numel())
    nbytes = uniq * d * 4 + idx.numel() * 4 + (weights.numel() * 4 if weights is not None else 0) \
        + B * d * 4
    return {**bound(nbytes, 2 * in_block * d), "distinct_rows": uniq}
