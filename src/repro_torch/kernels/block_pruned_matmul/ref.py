"""Plain PyTorch version of the block-pruned matmul kernel.

`y = x @ (w ⊙ expand(block_mask))`: each entry of `block_mask`
[ceil(K/128), ceil(N/128)] is broadcast over its 128 x 128 tile, the
expanded mask is cut to `w`'s [K, N], and the product is one f32 matmul.
The same function as `repro.kernels.block_pruned_matmul.ref` at its
default block, which takes only K and N that divide by 128; here the edge
tiles may be ragged.
"""
from __future__ import annotations

import torch

BLOCK = 128  # the mask's tile, as in repro's pruned_linear; compiled into the kernel


def expand_block_mask(block_mask: torch.Tensor, shape, block: int = BLOCK,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[ceil(K/block), ceil(N/block)] -> the elementwise mask [K, N] in `dtype`."""
    K, N = shape
    full = block_mask.to(dtype).repeat_interleave(block, dim=0).repeat_interleave(block, dim=1)
    return full[:K, :N]


def block_pruned_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                            block_mask: torch.Tensor) -> torch.Tensor:
    """x: f32 [M, K]; w: f32 [K, N]; block_mask: [ceil(K/128), ceil(N/128)] -> f32 [M, N]."""
    return x @ (w * expand_block_mask(block_mask, w.shape, BLOCK, w.dtype))
