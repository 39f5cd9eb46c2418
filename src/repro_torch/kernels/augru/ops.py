"""Wrapper for the AUGRU kernel: checks, dispatch, a gradient and a launch count.

A CPU tensor goes to the plain version (`ref.augru_ref`); a CUDA tensor
goes to the Hopper kernel, or the call raises. Unlike `repro`'s wrapper,
which falls back to the ref unless B divides by 128, the kernel takes any
B. It refuses a `g` above 136: the kernel keeps `wh` in registers, each
lane a quarter of a unit's three columns, and has template instances up
to there. A fake tensor takes the shape-only path (`_checks.shape_only`):
an empty [B, g] output, no launch counted. A kernel launch and a
shape-only call each hand the kernel's work to an active counter
(`kernels/work.record`).

The recurrence is differentiable through `torch.autograd.Function`: the
forward is the kernel (or the plain version), which returns only the
final h; the backward recomputes the recurrence with the plain version
under grad and differentiates it, on either device, as `repro`'s gradient
is XLA's autodiff of its jnp scan and not a Pallas kernel. A DIEN training
step on the card so runs the recurrence twice, the kernel and then the
plain version; the backward launches nothing and uses no atomics, so the
step repeats bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_tensor, dispatch_device, shape_only
from repro_torch.kernels.augru.augru import MAX_G, augru
from repro_torch.kernels.augru.ref import augru_ref
from repro_torch.kernels.work import augru_work, record

# Kernel launches made through `augru_op`, in this process. Callers that
# count (the serve launcher, chip_smoke.py) reset it to 0 themselves.
launches = 0


class _AUGRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, zx, wh, h0, att, mask):
        global launches
        ctx.save_for_backward(zx, wh, h0, att, mask)
        work = lambda: augru_work(zx.shape[0], zx.shape[1], wh.shape[0])  # noqa: E731
        if shape_only(zx, wh, h0, att, mask):
            record("augru", work)
            return zx.new_empty(h0.shape)
        if zx.device.type == "cpu":
            return augru_ref(zx, wh, h0, att, mask)
        out = augru(zx, wh, h0, att, mask)
        launches += 1
        record("augru", work)
        return out

    @staticmethod
    def backward(ctx, dh):
        saved = ctx.saved_tensors
        wanted = [i for i in range(4) if ctx.needs_input_grad[i]]  # mask: bool, no gradient
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved[:4])]
            h = augru_ref(*inputs, saved[4])
            grads = torch.autograd.grad(h, [inputs[i] for i in wanted], dh)
        out = [None] * 5
        for i, g in zip(wanted, grads):
            out[i] = g
        return tuple(out)


def augru_op(zx: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor, att: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """zx f32 [B,T,3g], wh f32 [g,3g], h0 f32 [B,g], att f32 [B,T], mask
    bool [B,T] -> the final AUGRU state f32 [B,g]."""
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
    if dev.type == "cuda" and g > MAX_G:
        raise ValueError(f"g={g} is wider than the kernel takes: g <= {MAX_G} (wh in "
                         "registers, its rows of h and zx in shared memory)")
    return _AUGRU.apply(zx, wh, h0, att, mask)
