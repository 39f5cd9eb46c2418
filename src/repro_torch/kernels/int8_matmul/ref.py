"""Plain PyTorch version of the W8A8 int8 matmul with its dequant epilogue
(port of `repro.kernels.int8_matmul.ref`).

The int32 product is taken as a float64 matmul and converted back: every
product of two int8 values and every partial sum of up to K of them is an
integer below 2^53 (K·127² for K < 5·10^11), so float64 holds each one
exactly and the result is the int32 accumulator in any summation order,
on either device (CUDA has no integer matmul in PyTorch).
"""
from __future__ import annotations

import torch


def int32_product(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """int8 [M,K] @ int8 [K,N] -> the exact int32 accumulator [M,N]."""
    return (a_q.to(torch.float64) @ b_q.to(torch.float64)).to(torch.int32)


def int8_matmul_ref(a_q, b_q, a_scale, b_scale):
    """a_q: int8 [M,K]; b_q: int8 [K,N]; a_scale: f32 [M]; b_scale: f32 [N].
    Returns f32 [M,N] = (a_q·b_q in int32) * a_scale[:,None] * b_scale[None,:],
    multiplied left to right as in `repro`'s ref."""
    acc = int32_product(a_q, b_q)
    return acc.to(torch.float32) * a_scale[:, None] * b_scale[None, :]


def pallas_epilogue(acc, a_scale, b_scale):
    """The TPU kernel's (and the Hopper kernel's) epilogue on an int32
    accumulator: `f32(acc) * (a_scale[:,None] * b_scale[None,:])`."""
    return acc.to(torch.float32) * (a_scale[:, None] * b_scale[None, :])


def quantize_activations(x):
    """Per-row dynamic int8 quantization of activations (C5 'dynamic-range-
    aware quantization along the Value branch'). `torch.round` rounds half
    to even, as `jnp.round` does."""
    s = torch.clamp(x.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127).to(torch.int8)
    return q, s.to(torch.float32)
