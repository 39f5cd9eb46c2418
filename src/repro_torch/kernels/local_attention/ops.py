"""Wrapper for the windowed-attention kernel: checks, dispatch, a launch
count and a gradient (port of `repro.kernels.local_attention.ops`).

`windowed_attention_op` keeps `repro`'s [B, H, L, dh] signature, and takes
q, k and v as views with any strides whose last dimension is contiguous
(16-byte aligned): the model hands it `t.transpose(1, 2)` of its
[B, L, H, dh] projections, and on the card gets back such a view of a
[B, L, H, dh] output, so nothing is copied on either side. A CPU tensor
goes to the plain version (`ref.local_attention_ref`); a CUDA tensor goes
to the Hopper kernel, or the call raises. Unlike `repro`'s wrapper, which
falls back to the ref unless L divides by 128, the kernel takes any L. A
fake tensor takes the shape-only path (`_checks.shape_only`): an empty
output laid out as the kernel's, no launch counted. A kernel launch and a
shape-only call each hand the kernel's work (every key valid:
`kernels/work.local_attention_work`'s dense bound) to an active counter
(`kernels/work.record`).

The attention is differentiable through `torch.autograd.Function`: the
forward is the kernel (or the plain version), the backward plain PyTorch
on either device, which recomputes the masked softmax from q, k and v and
differentiates it. The TPU kernel has no backward; JAX differentiates the
jnp masked softmax of the model.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._checks import check_tensor, dispatch_device, shape_only
from repro_torch.kernels.local_attention.local_attention import HEAD_DIMS, local_attention
from repro_torch.kernels.local_attention.ref import local_attention_ref
from repro_torch.kernels.work import local_attention_work, record

# Kernel launches made through `windowed_attention_op`, in this process.
# Callers that count (the serve launcher, chip_smoke.py) reset it to 0 themselves.
launches = 0

DTYPES = (torch.float32, torch.bfloat16)


def _attend(q, k, v, kv_len, window, causal):
    global launches
    work = lambda: local_attention_work(q, window, causal, kv_len, dense=True)  # noqa: E731
    if shape_only(q, k, v, kv_len):
        record("local_attention", work)
        B, H, L, dh = q.shape
        return q.new_empty((B, L, H, dh)).transpose(1, 2)  # the kernel's layout
    if q.device.type == "cpu":
        return local_attention_ref(q, k, v, window=window, causal=causal, kv_len=kv_len)
    out = local_attention(q, k, v, window, causal, kv_len)
    launches += 1
    record("local_attention", work)
    return out


class _LocalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_len, window, causal):
        ctx.save_for_backward(q, k, v, kv_len)
        ctx.window, ctx.causal = window, causal
        return _attend(q, k, v, kv_len, window, causal)

    @staticmethod
    def backward(ctx, dy):
        q, k, v, kv_len = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), need)]
            out = local_attention_ref(*ins, window=ctx.window, causal=ctx.causal,
                                      kv_len=kv_len)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, dy))
        return tuple(next(grads) if n else None for n in need) + (None, None, None)


def windowed_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
                          causal: bool = False,
                          kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: [B, H, L, dh] of one dtype, f32 or bf16, dh in (16, 32, 64,
    128), views whose last dimension is contiguous (`check_rows`); kv_len
    int32 [B] or None (every key valid) -> [B, H, L, dh]:
    softmax(q·kᵀ/√dh over the keys j with |i−j| < window, j < kv_len[b]
    and, if `causal`, j ≤ i)·v."""
    check_tensor(q, "q", 4, q.dtype, contiguous=False)
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be one of {DTYPES}, got {q.dtype}")
    check_tensor(k, "k", 4, q.dtype, contiguous=False)
    check_tensor(v, "v", 4, q.dtype, contiguous=False)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "must have one shape")
    B, H, L, dh = q.shape
    if min(B, H, L) < 1 or dh not in HEAD_DIMS:
        raise ValueError(f"need B, H, L >= 1 and dh in {HEAD_DIMS}, got {tuple(q.shape)}")
    if isinstance(window, bool) or not isinstance(window, int) or window < 1:
        raise ValueError(f"window must be an int of at least 1, got {window!r}")
    if kv_len is not None:
        check_tensor(kv_len, "kv_len", 1, torch.int32)
        if kv_len.shape != (B,):
            raise ValueError(f"kv_len {tuple(kv_len.shape)} must be ({B},)")
    dispatch_device("windowed_attention_op", q=q, k=k, v=v, kv_len=kv_len)
    return _LocalAttention.apply(q, k, v, kv_len, min(window, L), bool(causal))
