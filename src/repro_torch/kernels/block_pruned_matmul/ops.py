"""Wrapper for the block-pruned matmul kernel: checks, dispatch, a launch
count and a gradient.

A CPU tensor goes to the plain version (`ref.block_pruned_matmul_ref`); a
CUDA tensor goes to the Hopper kernel, or the call raises. Unlike `repro`'s
`pruned_linear`, which falls back to the ref unless M, K and N divide by
128, the kernel takes any M, K, N >= 1. The mask's tile is 128 x 128
(`ref.BLOCK`), compiled into the kernel. A fake tensor takes the
shape-only path (`_checks.shape_only`): an empty [M, N] output, no launch
counted. A kernel launch and a shape-only call each hand the kernel's work
(every tile kept: `kernels/work.block_pruned_matmul_work`'s dense bound) to
an active counter (`kernels/work.record`).

The product is differentiable through `torch.autograd.Function`. The
backward is plain PyTorch on either device (the TPU kernel has no backward;
JAX differentiates the jnp product `x @ (w * mask)`):

    dx = dy @ (w ⊙ M)ᵀ,   dw = (xᵀ dy) ⊙ M,   dM = (xᵀ dy) ⊙ w,

where M is the elementwise mask. A caller that trains the mask, as `repro`
does (its `{"w", "mask"}` leaves are float parameters), passes it as
`mask`, which must equal `expand(block_mask)[:K, :N]`
(`core/pruning.with_block_masks` builds `block_mask` from it and checks
that); without `mask`, M is the expanded block mask and gets no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._checks import check_tensor, dispatch_device, shape_only
from repro_torch.kernels.block_pruned_matmul.block_pruned_matmul import block_pruned_matmul
from repro_torch.kernels.block_pruned_matmul.ref import (
    BLOCK, block_pruned_matmul_ref, expand_block_mask)
from repro_torch.kernels.work import block_pruned_matmul_work, record

# Kernel launches made through `block_pruned_matmul_op`, in this process.
# Callers that count (the serve launcher, chip_smoke.py) reset it to 0 themselves.
launches = 0


def _product(x, w, block_mask):
    global launches
    work = lambda: block_pruned_matmul_work(x, w, block_mask, dense=True)  # noqa: E731
    if shape_only(x, w, block_mask):
        record("block_pruned_matmul", work)
        return x.new_empty((x.shape[0], w.shape[1]))
    if x.device.type == "cpu":
        return block_pruned_matmul_ref(x, w, block_mask)
    out = block_pruned_matmul(x, w, block_mask)
    launches += 1
    record("block_pruned_matmul", work)
    return out


class _BlockPrunedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mask, block_mask):
        ctx.save_for_backward(x, w, mask, block_mask)
        return _product(x, w, block_mask)

    @staticmethod
    def backward(ctx, dy):
        x, w, mask, block_mask = ctx.saved_tensors
        m = mask if mask is not None else expand_block_mask(block_mask, w.shape)
        need_x, need_w, need_mask = ctx.needs_input_grad[:3]
        dx = dy @ (w * m).T if need_x else None
        dw = dmask = None
        if need_w or need_mask:
            g = x.T @ dy
            dw = g * m if need_w else None
            dmask = g * w if need_mask else None
        return dx, dw, dmask, None


def block_pruned_matmul_op(x: torch.Tensor, w: torch.Tensor, block_mask: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x f32 [M,K], w f32 [K,N], block_mask int32 [ceil(K/128), ceil(N/128)]
    (0 = tile pruned), mask f32 [K,N] or None -> f32 [M,N] = x @ (w ⊙ expand(block_mask))."""
    check_tensor(x, "x", 2, torch.float32)
    check_tensor(w, "w", 2, torch.float32)
    check_tensor(block_mask, "block_mask", 2, torch.int32)
    (M, K), (K2, N) = x.shape, w.shape
    if min(M, K, N) < 1 or K2 != K:
        raise ValueError(f"need x [M,K] and w [K,N] with M, K, N >= 1, got x {tuple(x.shape)} "
                         f"and w {tuple(w.shape)}")
    nb = (-(-K // BLOCK), -(-N // BLOCK))
    if tuple(block_mask.shape) != nb:
        raise ValueError(f"block_mask {tuple(block_mask.shape)} must be {nb} for w "
                         f"{tuple(w.shape)} in {BLOCK}-tiles")
    if mask is not None and (mask.shape != w.shape or mask.dtype != torch.float32):
        raise ValueError(f"mask must be f32 {tuple(w.shape)}, got {mask.dtype} {tuple(mask.shape)}")
    dispatch_device("block_pruned_matmul_op", x=x, w=w, block_mask=block_mask, mask=mask)
    return _BlockPrunedMatmul.apply(x, w, mask, block_mask)


def density(block_mask: torch.Tensor) -> float:
    """Surviving-tile fraction: the kernel's multiply-add and w-read cost multiplier."""
    return float((block_mask != 0).float().mean())
