"""Wrapper for the AUGRU kernel: checks, dispatch and a launch count.

A CPU tensor goes to the plain version (`ref.augru_ref`); a CUDA tensor
goes to the Hopper kernel, or the call raises. Unlike `repro`'s wrapper,
which falls back to the ref unless B divides by 128, the kernel takes any
B. It refuses a `g` whose `wh` does not fit in a block's shared memory
(g > 136), since the kernel keeps all of `wh` there.

The kernel has no backward yet: on CUDA tensors of which one requires
grad, with grad mode on, the wrapper raises rather than return an output
that autograd cannot see through. Training DIEN on the card waits for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_no_grad, check_tensor, dispatch_device
from repro_torch.kernels.augru.augru import MAX_SMEM_BYTES, augru, smem_bytes
from repro_torch.kernels.augru.ref import augru_ref

# Kernel launches made through `augru_op`, in this process. Callers that
# count (the serve launcher, chip_smoke.py) reset it to 0 themselves.
launches = 0


def augru_op(zx: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor, att: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """zx f32 [B,T,3g], wh f32 [g,3g], h0 f32 [B,g], att f32 [B,T], mask
    bool [B,T] -> the final AUGRU state f32 [B,g]."""
    global launches
    check_tensor(zx, "zx", 3, torch.float32)
    check_tensor(wh, "wh", 2, torch.float32)
    check_tensor(h0, "h0", 2, torch.float32)
    check_tensor(att, "att", 2, torch.float32)
    check_tensor(mask, "mask", 2, torch.bool)
    B, T, g3 = zx.shape
    g = wh.shape[0]
    if B < 1 or T < 1 or g < 1:
        raise ValueError(f"need B, T and g of at least 1, got zx {tuple(zx.shape)}")
    if g3 != 3 * g or wh.shape != (g, 3 * g) or h0.shape != (B, g):
        raise ValueError(f"shapes disagree: zx {tuple(zx.shape)}, wh {tuple(wh.shape)}, "
                         f"h0 {tuple(h0.shape)}")
    if att.shape != (B, T) or mask.shape != (B, T):
        raise ValueError(f"att {tuple(att.shape)} and mask {tuple(mask.shape)} must be {(B, T)}")
    dev = dispatch_device("augru_op", zx=zx, wh=wh, h0=h0, att=att, mask=mask)
    if dev.type == "cpu":
        return augru_ref(zx, wh, h0, att, mask)
    check_no_grad("augru_op", zx=zx, wh=wh, h0=h0, att=att)
    if smem_bytes(g) > MAX_SMEM_BYTES:
        raise ValueError(f"g={g}: wh needs {smem_bytes(g)} bytes of shared memory, "
                         f"a block has {MAX_SMEM_BYTES}")
    out = augru(zx, wh, h0, att, mask)
    launches += 1
    return out
