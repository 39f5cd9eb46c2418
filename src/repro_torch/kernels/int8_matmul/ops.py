"""Wrappers for the W8A8 int8 matmul kernel: checks, dispatch and a launch
count (port of `repro.kernels.int8_matmul.ops`).

`int8_matmul_op` takes quantized operands; `quantized_linear` quantizes
the activations per row in plain PyTorch first, as `repro` does. A CPU
tensor goes to the plain version (`ref.int8_matmul_ref`, `repro`'s ref and
its association `(acc·a_s)·b_s`); a CUDA tensor goes to the Hopper kernel
(the Pallas epilogue `acc·(a_s·b_s)`), or the call raises. Unlike `repro`'s
wrapper, which falls back to the ref unless M, K and N divide by 128, the
kernel takes any M, K, N >= 1.

No model path runs this: the int8 rep of `core/lightweight.py` is
weight-only dequantization, as in `repro`, and W8A8 gives another result.
The kernel has no backward: on CUDA tensors under grad the wrapper raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels._checks import check_no_grad, check_tensor, dispatch_device
from repro_torch.kernels.int8_matmul.int8_matmul import int8_matmul
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref, quantize_activations

# Kernel launches made through `int8_matmul_op`, in this process. Callers
# that count (the serve launcher, chip_smoke.py) reset it to 0 themselves.
launches = 0


def int8_matmul_op(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: torch.Tensor,
                   b_scale: torch.Tensor) -> torch.Tensor:
    """a_q int8 [M,K], b_q int8 [K,N], a_scale f32 [M], b_scale f32 [N] ->
    f32 [M,N] = f32(a_q·b_q summed in int32) scaled by a_scale ⊗ b_scale."""
    global launches
    check_tensor(a_q, "a_q", 2, torch.int8)
    check_tensor(b_q, "b_q", 2, torch.int8)
    check_tensor(a_scale, "a_scale", 1, torch.float32)
    check_tensor(b_scale, "b_scale", 1, torch.float32)
    (M, K), (K2, N) = a_q.shape, b_q.shape
    if min(M, K, N) < 1 or K2 != K:
        raise ValueError(f"need a_q [M,K] and b_q [K,N] with M, K, N >= 1, got "
                         f"{tuple(a_q.shape)} and {tuple(b_q.shape)}")
    if a_scale.shape != (M,) or b_scale.shape != (N,):
        raise ValueError(f"a_scale {tuple(a_scale.shape)} must be ({M},) and b_scale "
                         f"{tuple(b_scale.shape)} ({N},)")
    dev = dispatch_device("int8_matmul_op", a_q=a_q, b_q=b_q, a_scale=a_scale, b_scale=b_scale)
    if dev.type == "cpu":
        return int8_matmul_ref(a_q, b_q, a_scale, b_scale)
    check_no_grad("int8_matmul_op", a_scale=a_scale, b_scale=b_scale)
    out = int8_matmul(a_q, b_q, a_scale, b_scale)
    launches += 1
    return out


def quantized_linear(x: torch.Tensor, w_rep: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x: f32 [M, K]; w_rep: {"q": int8 [K,N], "s": f32 [N]} (C5 storage rep).
    Quantizes the activations per row, then runs the int8 kernel."""
    check_tensor(x, "x", 2, torch.float32)
    if x.device.type == "cuda":
        check_no_grad("quantized_linear", x=x)
    x_q, x_s = quantize_activations(x)
    return int8_matmul_op(x_q, w_rep["q"], x_s, w_rep["s"])
