"""Int8 gradient compression with error feedback (port of
`repro.distributed.grad_compression`).

Each rank quantizes (grad + residual) block-wise to int8 codes (blocks of
256 over the flattened leaf, symmetric, scale = max|block| / 127), all-reduces
the codes and the scales, and keeps the quantization residual for the next
step (error feedback — Seide et al. 2014; 1-bit Adam lineage).

The arithmetic is `repro`'s exactly: the codes and the scales are both
summed over the ranks and divided by n, so the mean is dequantized with the
MEAN scale (`mean(codes) * mean(scale)`), not with each rank's own; and the
codes travel as f32 (whole numbers, exact in f32 up to 2^24 >> 127·512),
so the all-reduce moves as many bytes as an uncompressed f32 one, although
`repro`'s docstring says "~4x". A smaller wire format is a separate change.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_map

_BLOCK = 256


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device: PyTorch's CUDA division by
    a Python number (or a CPU scalar) multiplies by its f32 reciprocal,
    which rounds differently; a divisor on x's own device divides."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _q(x: torch.Tensor):
    """Block-wise symmetric int8 quantization: (codes held in f32, scale,
    shape, pad)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.clamp(_div(torch.amax(torch.abs(blocks), dim=1), 127.0), min=1e-12)
    codes = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return codes, scale, tuple(x.shape), pad


def _dq(codes: torch.Tensor, scale: torch.Tensor, shape, pad: int) -> torch.Tensor:
    flat = (codes * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_allreduce_mean(grad: torch.Tensor, residual: torch.Tensor,
                            group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: error-feedback int8 all-reduce-mean over `group` (a
    process group; None is one rank and no collective, as `repro`'s psum
    over no axes). Returns (averaged grad, new residual)."""
    g = grad.to(torch.float32) + residual
    codes, scale, shape, pad = _q(g)
    codes_sum, scale_sum = codes.clone(), scale.clone()
    n = 1
    if group is not None:
        dist.all_reduce(codes_sum, group=group)  # small whole numbers in f32: exact
        dist.all_reduce(scale_sum, group=group)  # conservative shared scale
        n = dist.get_world_size(group)
    mean = _dq(_div(codes_sum, n), _div(scale_sum, n), shape, pad)
    new_residual = g - _dq(codes, scale, shape, pad)
    return mean.to(grad.dtype), new_residual


def allreduce_bytes(grad: torch.Tensor) -> int:
    """The bytes one rank hands the all-reduce for `grad`: the f32 codes
    and the f32 scales of its padded blocks."""
    n_blocks = -(-grad.numel() // _BLOCK)
    return 4 * (n_blocks * _BLOCK + n_blocks)


def make_compressed_allreduce(group=None):
    """Tree-level API: (grads, residuals) -> (means, new residuals), over
    nested dicts of tensors."""

    def apply(grads: Any, residuals: Any) -> Tuple[Any, Any]:
        pairs = tree_map(lambda g, r: compress_allreduce_mean(g, r, group), grads, residuals)
        means = tree_map(lambda g, p: p[0], grads, pairs)
        res = tree_map(lambda g, p: p[1], grads, pairs)
        return means, res

    return apply


def init_residuals(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
