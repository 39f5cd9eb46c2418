"""Kernel benchmark on the card: the port's counterpart of
`benchmarks/bench_kernels.py:run`, at its six shapes.

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels [--iters 50] [--seed 0]

Each row launches one hand-written kernel through its wrapper on CUDA
tensors drawn from `--seed`, holds the result against the kernel's plain
PyTorch version on the same inputs, and times three things the same way
(`time_ms`): the kernel, the plain version, and one PyTorch library call
that computes the same function where there is one (the port never calls
it). Beside them stands the card's bound for the same work (`bound`): the
larger of the bytes the function must move over the H100's memory rate
and its operations over the peak rate for their type. The rows:

- `int8_matmul` 512³, through `quantized_linear` (activations and weights
  quantized per row, as `repro`'s benchmark does);
- `block_pruned_matmul` 512 x 512 x 512 with a 4 x 4 tile mask, 40% of the
  tiles pruned on average (also held against an f64 product);
- `local_attention` BH 8, L 2048, dh 64, window 256, f32;
- `embedding_bag` 4096 bags of 20 ids into a 1M x 32 table;
- `fm_interaction` 65,536 examples of 39 fields x 10;
- `augru` B 4096, T 100, g 108.

Prints one JSON line a row, then the device. It needs an NVIDIA card and
raises without one: a time is a device time, never the CPU's.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.augru import ops as augru_ops
from repro_torch.kernels.augru.ref import augru_ref
from repro_torch.kernels.block_pruned_matmul import block_pruned_matmul as bpm_kernel
from repro_torch.kernels.block_pruned_matmul import ops as bpm_ops
from repro_torch.kernels.block_pruned_matmul.ref import block_pruned_matmul_ref, expand_block_mask
from repro_torch.kernels.embedding_bag import embedding_bag as eb_kernel
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.fm_interaction import ops as fm_ops
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref
from repro_torch.kernels.int8_matmul import ops as int8_ops
from repro_torch.kernels.int8_matmul.ref import (
    int8_matmul_ref, int32_product, pallas_epilogue, quantize_activations)
from repro_torch.kernels.local_attention import ops as la_ops
from repro_torch.kernels.local_attention.ref import attention_mask, local_attention_ref
from repro_torch.launch.serve import disable_tf32

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s; f32
# FLOP/s outside the tensor cores; int8 tensor-core OP/s; f32-accurate
# products on the tensor cores as 3xTF32, a third of the 495 TFLOP/s of TF32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12
F32_3XTF32_FLOPS = 495e12 / 3
KERNEL_ITERS = 50
SLEEP_CYCLES = 1_000_000  # ~0.5 ms at H100 clocks: longer than the host takes to enqueue a call
L2_FLUSH_BYTES = 64 * 2**20  # > the H100's 50 MB L2
LA_TOL, LA_BF16_TOL = 1e-5, 2e-2  # absolute; the JAX kernel test's for f32 and bf16
# f32 inputs: the kernel's error against the f64 function at most 2x the larger of
# the f32 plain version's and four f32 ulps of the largest output (at a window of 1
# the plain version returns v exactly, and the tensor core's f32 sums truncate)
LA_F64_FACTOR, LA_F64_ULPS = 2.0, 2.0 ** -22
INT8_RTOL, INT8_ATOL = 1e-6, 1e-4  # against the ref's association, as the JAX kernel test
BPM_RTOL, BPM_ATOL = 1e-5, 1e-4  # the JAX kernel test's: f32 sums in another order
BPM_F64_FACTOR = 2.0  # the kernel's error against an f64 product: at most 2x the f32 plain's
EB_TOL_REL = 1e-5  # bags of more than one row, of the largest output: f32 sums in another order


def time_ms(fn: Callable[[], object], flush: Optional[torch.Tensor],
            iters: int = KERNEL_ITERS) -> float:
    """Median device time of one call. Before each: a write that evicts L2
    (a serve call finds its inputs cold too; `flush` None skips it, and the
    inputs are then warm in L2), then a device-side sleep that keeps the
    stream busy while the host enqueues the call, so the CUDA events bracket
    device work and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS) -> Dict:
    """The least time the card could take: the larger of `nbytes` at the
    HBM rate and `flops` at `peak`, and which of the two it is."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def l2_flush_buffer(device) -> torch.Tensor:
    """The buffer `time_ms` writes before each call to evict L2."""
    return torch.empty(L2_FLUSH_BYTES // 4, device=device)


def int8_matmul_work(M: int, K: int, N: int) -> Dict:
    """a_q and b_q read once (a byte an element), both scales, the f32
    output written once; 2·M·N·K int8 operations at the int8 rate."""
    return bound(M * K + K * N + 4 * M + 4 * N + 4 * M * N, 2 * M * N * K, INT8_OPS)


def local_attention_work(q: torch.Tensor, window: int, causal: bool = False,
                         kv_len: Optional[torch.Tensor] = None) -> Dict:
    """The least work of one call, counted from this call's window,
    causality and key lengths. q: [B, H, L, dh]; kv_len [B] or None.

    Bytes: the output written once, `kv_len` read once, and of q, k and v
    only the rows the function needs: q's rows that have a valid key; k's
    keys that some query attends; v's likewise, but all L of a request's
    rows where one of its queries has no valid key, since that row is the
    mean of v over all L (as `repro`'s −1e30 mask makes it). Operations:
    per valid (query, key) pair 2·dh for q·k, 2·dh for p·v and 3 for the
    softmax (max, exp, sum); L·dh additions for each row with no valid
    key; one division per output element."""
    B, H, L, dh = q.shape
    mask = attention_mask(L, window, causal=causal, kv_len=kv_len, device=q.device)
    reps = B if mask.ndim == 2 else 1  # without kv_len one [L, L] mask serves every request
    mask = mask.reshape(-1, L, L)
    live_rows, live_keys = mask.any(dim=2), mask.any(dim=1)  # [b, L] each
    v_rows = torch.where(live_rows.all(dim=1), live_keys.sum(dim=1), L)
    rows_read = int(live_rows.sum()) + int(live_keys.sum()) + int(v_rows.sum())
    dead_rows = int((~live_rows).sum())
    nbytes = (reps * H * dh * q.element_size() * rows_read + q.numel() * q.element_size()
              + (kv_len.numel() * 4 if kv_len is not None else 0))
    pairs = reps * H * int(mask.sum())
    flops = pairs * (4 * dh + 3) + reps * H * dead_rows * L * dh + q.numel()
    return {**bound(nbytes, flops), "pairs": pairs, "rows_without_keys": reps * H * dead_rows}


def local_attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                        causal: bool = False, kv_len: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The windowed attention in float64 throughout: q, k, v [B, H, L, dh],
    kv_len [B] or None; masked scores −1e30, as `repro`'s model."""
    L, dh = q.shape[-2:]
    mask = attention_mask(L, window, causal=causal, kv_len=kv_len, device=q.device)
    if mask.ndim == 3:
        mask = mask[:, None]
    s = torch.einsum("bhld,bhmd->bhlm", q.double(), k.double()) / dh ** 0.5
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bhlm,bhmd->bhld", p, v.double())


def local_attention_case(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
                         causal: bool = False, kv_len: Optional[torch.Tensor] = None,
                         flush: Optional[torch.Tensor] = None, iters: int = KERNEL_ITERS) -> Dict:
    """`windowed_attention_op` on card tensors q, k, v [B, H, L, dh] (f32 or
    bf16, any views the op takes; `kv_len` [B] or None), held against the
    plain version on the same inputs in f32: within LA_TOL, or LA_BF16_TOL
    for bf16 inputs; a second launch, and a launch on contiguous copies of
    q, k and v, must give the same bits; for f32 inputs, its error against
    the function in f64 at most LA_F64_FACTOR times the larger of the plain
    version's and LA_F64_ULPS of the largest output (the kernel's products
    are 3xTF32 on the tensor cores). With
    `flush`, also times the kernel, the plain version and the library call
    (SDPA with the boolean mask), and counts the work."""
    B, H, L, dh = q.shape
    out = la_ops.windowed_attention_op(q, k, v, window=window, causal=causal, kv_len=kv_len)
    again = la_ops.windowed_attention_op(q, k, v, window=window, causal=causal, kv_len=kv_len)
    copies = la_ops.windowed_attention_op(q.contiguous(), k.contiguous(), v.contiguous(),
                                          window=window, causal=causal, kv_len=kv_len)
    bit_equal = bool(torch.equal(out, again) and torch.equal(out, copies))
    rows = None if kv_len is None else kv_len.repeat_interleave(H)
    qf, kf, vf = (t.float().reshape(B * H, L, dh) for t in (q, k, v))

    def plain():
        return local_attention_ref(qf, kf, vf, window=window, causal=causal, kv_len=rows)

    ref = plain().reshape(B, H, L, dh)
    err = float((out.float() - ref).abs().max())
    tol = LA_TOL if q.dtype == torch.float32 else LA_BF16_TOL
    rec = {"window": window, "causal": causal, "dtype": str(q.dtype).split(".")[-1],
           "kv_len_min": None if kv_len is None else int(kv_len.min()),
           "ok": bool(torch.isfinite(out).all()) and err <= tol and bit_equal,
           "max_abs_err": err, "tol": tol, "bit_equal": bit_equal}
    if q.dtype == torch.float32:
        exact = local_attention_f64(q, k, v, window, causal, kv_len)
        err64 = float((out.double() - exact).abs().max())
        plain_err64 = float((ref.double() - exact).abs().max())
        rec.update(err_f64=err64, plain_err_f64=plain_err64,
                   f64_ratio=err64 / plain_err64 if plain_err64 else 0.0)
        floor = LA_F64_ULPS * float(exact.abs().max())
        rec["ok"] = rec["ok"] and err64 <= LA_F64_FACTOR * max(plain_err64, floor)
    if flush is None:
        return rec
    mask = attention_mask(L, window, causal=causal, kv_len=kv_len, device=q.device)
    if kv_len is not None:
        mask = mask[:, None]  # [B, 1, L, L] against the scores [B, H, L, L]
    return {
        **rec,
        "ms": time_ms(lambda: la_ops.windowed_attention_op(
            q, k, v, window=window, causal=causal, kv_len=kv_len), flush, iters),
        "plain_ms": time_ms(plain, flush, iters),
        # the yardstick: rows with no valid key come out NaN there (it is only timed)
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                              flush, iters),
        "library": "F.scaled_dot_product_attention with the boolean window and key mask",
        **local_attention_work(q, window, causal, kv_len),
    }


def int8_case(x: torch.Tensor, w_rep: Dict[str, torch.Tensor], *,
              flush: Optional[torch.Tensor] = None, iters: int = KERNEL_ITERS) -> Dict:
    """`quantized_linear(x, w_rep)` on card tensors (x f32 [M, K]; w_rep the
    C5 rep, int8 [K, N] and per-output-channel scales [N]). Checks: with
    unit scales the kernel's output is the int32 accumulator, equal to the
    plain version's; with the scales, the Pallas epilogue of that
    accumulator bit for bit, and the ref's association within INT8_RTOL and
    INT8_ATOL, the JAX kernel test's. With `flush`, also times the kernel,
    the plain version and the library call, and counts the work."""
    (M, K), N = x.shape, w_rep["q"].shape[1]
    x_q, x_s = quantize_activations(x)
    w_q, w_s = w_rep["q"], w_rep["s"]
    acc = int32_product(x_q, w_q)
    ones_m, ones_n = torch.ones(M, device=x.device), torch.ones(N, device=x.device)
    acc_ok = bool(torch.equal(int8_ops.int8_matmul_op(x_q, w_q, ones_m, ones_n), acc.float()))
    out = int8_ops.quantized_linear(x, w_rep)
    ref = int8_matmul_ref(x_q, w_q, x_s, w_s)
    epi_ok = bool(torch.equal(out, pallas_epilogue(acc, x_s, w_s)))
    rec = {"ok": acc_ok and epi_ok and bool(torch.allclose(out, ref, rtol=INT8_RTOL,
                                                             atol=INT8_ATOL)),
           "accumulator_equal": acc_ok, "equals_pallas_epilogue": epi_ok,
           "max_abs_err": float((out - ref).abs().max()), "rtol": INT8_RTOL, "atol": INT8_ATOL}
    if flush is None:
        return rec
    return {
        **rec,
        "ms": time_ms(lambda: int8_ops.int8_matmul_op(x_q, w_q, x_s, w_s), flush, iters),
        "plain_ms": time_ms(lambda: int8_matmul_ref(x_q, w_q, x_s, w_s), flush, iters),
        "library_ms": time_ms(lambda: pallas_epilogue(torch._int_mm(x_q, w_q), x_s, w_s),
                              flush, iters),
        "library": "torch._int_mm + the epilogue",
        **int8_matmul_work(M, K, N),
    }


def block_pruned_matmul_work(x: torch.Tensor, w: torch.Tensor, block_mask: torch.Tensor) -> Dict:
    """The least work of x @ (w ⊙ expand(block_mask)): the surviving weights
    once, the columns of x that meet a surviving tile once, the tile mask,
    the output once; 2 operations a surviving weight and row, at the rate
    of f32-accurate products on the tensor cores (3xTF32), with the time at
    the CUDA cores' f32 rate beside it."""
    (M, K), N = x.shape, w.shape[1]
    mask = expand_block_mask(block_mask, (K, N))
    surviving = int(mask.sum())
    live_k = int((mask.sum(dim=1) > 0).sum())
    nbytes = 4 * (M * live_k + surviving + block_mask.numel() + M * N)
    flops = 2 * M * surviving
    return {**bound(nbytes, flops, F32_3XTF32_FLOPS),
            "bound_peak": "3xTF32 on the tensor cores, 495/3 TFLOP/s",
            "bound_ms_f32_cores": bound(nbytes, flops)["bound_ms"]}


def block_pruned_matmul_case(x: torch.Tensor, w: torch.Tensor, block_mask: torch.Tensor, *,
                             flush: Optional[torch.Tensor] = None, iters: int = KERNEL_ITERS,
                             alt_plans: Optional[Dict[str, "bpm_kernel.Plan"]] = None) -> Dict:
    """`block_pruned_matmul_op` on x [M,K], w [K,N] and the int32 tile mask,
    held against the plain version (within BPM_RTOL, BPM_ATOL) and against
    an f64 product (its error at most BPM_F64_FACTOR times the f32 plain
    version's), and launched twice for the same bits. With `flush` (on the
    card), also times the kernel (L2 flushed, and with its inputs warm in
    L2), the plain version, the library call `torch.matmul(x, w * mask)`
    (TF32 off) and each of `alt_plans`, and counts the work."""
    (M, K), N = x.shape, w.shape[1]
    out = bpm_ops.block_pruned_matmul_op(x, w, block_mask)
    again = bpm_ops.block_pruned_matmul_op(x, w, block_mask)
    ref = block_pruned_matmul_ref(x, w, block_mask)
    w_eff = w * expand_block_mask(block_mask, (K, N))
    exact = x.double() @ w_eff.double()
    err64 = float((out.double() - exact).abs().max())
    plain_err64 = float((ref.double() - exact).abs().max())
    bit_equal = bool(torch.equal(out, again))
    close = bool(torch.allclose(out, ref, rtol=BPM_RTOL, atol=BPM_ATOL))
    rec = {"ok": close and bit_equal and err64 <= BPM_F64_FACTOR * plain_err64,
           "max_abs_err": float((out - ref).abs().max()), "rtol": BPM_RTOL, "atol": BPM_ATOL,
           "err_f64": err64, "plain_err_f64": plain_err64,
           "f64_ratio": err64 / plain_err64 if plain_err64 else 0.0, "bit_equal": bit_equal,
           "density": bpm_ops.density(block_mask)}
    if x.is_cuda:
        rec["plan"] = bpm_kernel.launch_plan(M, K, N, bpm_kernel.sm_count(x.device))._asdict()
    if flush is None:
        return rec
    ms = time_ms(lambda: bpm_ops.block_pruned_matmul_op(x, w, block_mask), flush, iters)
    library_ms = time_ms(lambda: torch.matmul(x, w_eff), flush, iters)
    return {
        **rec, "ms": ms,
        "ms_l2_warm": time_ms(lambda: bpm_ops.block_pruned_matmul_op(x, w, block_mask), None,
                              iters),
        "plain_ms": time_ms(lambda: block_pruned_matmul_ref(x, w, block_mask), flush, iters),
        "library_ms": library_ms, "library": "torch.matmul(x, w * mask), TF32 off",
        "vs_library": ms / library_ms,
        "alt_plans_ms": {name: time_ms(lambda: bpm_kernel.block_pruned_matmul(x, w, block_mask,
                                                                               plan), flush, iters)
                         for name, plan in (alt_plans or {}).items()},
        **block_pruned_matmul_work(x, w, block_mask),
    }


def embedding_bag_work(table: torch.Tensor, idx: torch.Tensor,
                       weights: Optional[torch.Tensor]) -> Dict:
    """Each distinct row read once, the ids and weights once, the output
    written once; d multiply-adds an id."""
    (B, nnz), d = idx.shape, table.shape[1]
    uniq = int(torch.unique(idx).numel())
    nbytes = uniq * d * 4 + idx.numel() * 4 + (weights.numel() * 4 if weights is not None else 0) \
        + B * d * 4
    return {**bound(nbytes, 2 * B * nnz * d), "distinct_rows": uniq}


def embedding_bag_case(table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor],
                       *, flush: Optional[torch.Tensor] = None,
                       iters: int = KERNEL_ITERS) -> Dict:
    """`embedding_bag_op` held against the plain version: a bag of one is
    the gathered row to the bit (and the plain version's row, weighted),
    larger bags within EB_TOL_REL of the largest output; launched twice for
    the same bits. With `flush` (on the card), also times the kernel, the
    plain version and the library call (`F.embedding` for unweighted bags
    of one, else `F.embedding_bag(mode="sum")`), and counts the work."""
    (B, nnz), d = idx.shape, table.shape[1]
    out = eb_ops.embedding_bag_op(table, idx, weights)
    again = eb_ops.embedding_bag_op(table, idx, weights)
    ref = embedding_bag_ref(table, idx, weights)
    err = float((out - ref).abs().max())
    if nnz == 1:
        tol = 0.0
        ok = bool(torch.equal(out, ref)) and (
            weights is not None or bool(torch.equal(out, table[idx[:, 0].long()])))
    else:
        tol = EB_TOL_REL * float(ref.abs().max())
        ok = err <= tol
    bit_equal = bool(torch.equal(out, again))
    rec = {"ok": ok and bit_equal, "max_abs_err": err, "tol": tol, "bit_equal": bit_equal}
    if table.is_cuda:
        rec["plan"] = eb_kernel.launch_plan(B, nnz, d, eb_kernel.load_width(table))._asdict()
    if flush is None:
        return rec
    idx64 = idx.long()
    if nnz == 1 and weights is None:
        library, library_name = (lambda: F.embedding(idx64[:, 0], table)), "F.embedding"
    else:
        library, library_name = (lambda: F.embedding_bag(idx64, table, mode="sum",
                                                         per_sample_weights=weights),
                                 "F.embedding_bag(mode='sum')")
    ms = time_ms(lambda: eb_ops.embedding_bag_op(table, idx, weights), flush, iters)
    library_ms = time_ms(library, flush, iters)
    return {**rec, "ms": ms,
            "plain_ms": time_ms(lambda: embedding_bag_ref(table, idx, weights), flush, iters),
            "library_ms": library_ms, "library": library_name, "vs_library": ms / library_ms,
            **embedding_bag_work(table, idx, weights)}


def _check(out: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float) -> Dict:
    err = float((out.float() - ref.float()).abs().max())
    ok = bool(torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol))
    return {"max_abs_err": err, "rtol": rtol, "atol": atol, "ok": ok}


def _row(name, shape, check, kernel, plain, library, library_name, work, flush, iters,
         plain_iters=None) -> Dict:
    return {
        "kernel": name, "shape": shape, **check,
        "ms": time_ms(kernel, flush, iters),
        "plain_ms": time_ms(plain, flush, plain_iters or iters),
        "library_ms": time_ms(library, flush, iters) if library is not None else None,
        "library": library_name, **work,
    }


def _int8_row(gen, dev, flush, iters):
    M = K = N = 512
    a = torch.randn((M, K), generator=gen, device=dev)
    w_q, w_s = quantize_activations(torch.randn((N, K), generator=gen, device=dev))
    # [K, N] with per-output-channel scales, as the C5 rep
    return {"kernel": "int8_matmul", "shape": [M, K, N],
            **int8_case(a, {"q": w_q.T.contiguous(), "s": w_s}, flush=flush, iters=iters)}


def _block_pruned_row(gen, dev, flush, iters):
    M = K = N = 512
    x = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev)
    bm = (torch.rand((4, 4), generator=gen, device=dev) > 0.4).to(torch.int32)
    return {"kernel": "block_pruned_matmul", "shape": [M, K, N],
            **block_pruned_matmul_case(x, w, bm, flush=flush, iters=iters)}


def _local_attention_row(gen, dev, flush, iters):
    BH, L, dh, window = 8, 2048, 64, 256
    q, k, v = (torch.randn((BH, 1, L, dh), generator=gen, device=dev) for _ in range(3))
    return {"kernel": "local_attention", "shape": [BH, L, dh, window],
            **local_attention_case(q, k, v, window=window, flush=flush, iters=iters)}


def _embedding_bag_row(gen, dev, flush, iters):
    V, d, B, nnz = 1_000_000, 32, 4096, 20
    table = torch.randn((V, d), generator=gen, device=dev)
    idx = torch.randint(0, V, (B, nnz), generator=gen, device=dev, dtype=torch.int32)
    return {"kernel": "embedding_bag", "shape": [V, d, B, nnz],
            **embedding_bag_case(table, idx, None, flush=flush, iters=iters)}


def _fm_row(gen, dev, flush, iters):
    B, F_, k = 65_536, 39, 10
    e = torch.randn((B, F_, k), generator=gen, device=dev)
    check = _check(fm_ops.fm_interaction_op(e), fm_interaction_ref(e), 1e-4, 1e-3)
    # per value: s += v, q += v·v (3); per factor: S², −, Σ (3); per example: ½ (1)
    work = bound(4 * B * F_ * k + 4 * B, B * (3 * F_ * k + 3 * k + 1))
    return _row("fm_interaction", [B, F_, k], check, lambda: fm_ops.fm_interaction_op(e),
                lambda: fm_interaction_ref(e), None,
                "none: no single PyTorch call computes the FM sum-square interaction", work,
                flush, iters)


def _augru_row(gen, dev, flush, iters):
    B, T, g = 4096, 100, 108
    zx = torch.randn((B, T, 3 * g), generator=gen, device=dev)
    wh = torch.randn((g, 3 * g), generator=gen, device=dev) * 0.3
    h0 = torch.zeros((B, g), device=dev)
    att = torch.rand((B, T), generator=gen, device=dev)
    mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    args = (zx, wh, h0, att, mask)
    check = _check(augru_ops.augru_op(*args), augru_ref(*args), 0.0, 1e-5)
    # per row and step: h @ wh (2·g·3g) and 16 elementwise operations a unit
    nbytes = 4 * B * T * 3 * g + 4 * g * 3 * g + 4 * B * g + 4 * B * T + B * T + 4 * B * g
    work = bound(nbytes, B * T * (6 * g * g + 16 * g))
    return _row("augru", [B, T, g], check, lambda: augru_ops.augru_op(*args),
                lambda: augru_ref(*args), None,
                "none: cuDNN's GRU has no attentional update gate", work, flush, iters,
                plain_iters=5)


ROWS = (_int8_row, _block_pruned_row, _local_attention_row, _embedding_bag_row, _fm_row,
        _augru_row)


def run(device="cuda", seed: int = 0, iters: int = KERNEL_ITERS) -> List[Dict]:
    """One record per kernel, in `ROWS` order. Raises without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the kernel benchmark times CUDA kernels; got device {dev}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = l2_flush_buffer(dev)
    rows = []
    with torch.no_grad():
        for row in ROWS:
            rows.append(row(gen, dev, flush, iters))
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=KERNEL_ITERS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    disable_tf32()  # the plain versions and the library calls in full f32
    rows = run(seed=args.seed, iters=args.iters)
    for r in rows:
        print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    bad = [r["kernel"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")


if __name__ == "__main__":
    main()
