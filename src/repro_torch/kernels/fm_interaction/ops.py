"""Wrapper for the FM interaction kernel: checks, dispatch, a gradient and
a launch count.

A CPU tensor goes to the plain version (`ref.fm_interaction_ref`); a CUDA
tensor goes to the Hopper kernel, or the call raises. Unlike `repro`'s
wrapper, which falls back to the ref unless B divides by 256, the kernel
takes any B. A fake tensor takes the shape-only path (`_checks.shape_only`):
an empty [B] output, no launch counted. A kernel launch and a shape-only
call each hand the kernel's work to an active counter (`kernels/work.record`).

The interaction is differentiable through `torch.autograd.Function`: the
forward is the kernel (or the plain version), the backward the same plain
PyTorch on either device, `de[b,f,c] = dy[b]·(Σ_f' e[b,f',c] − e[b,f,c])`,
as `repro`'s gradient is XLA's autodiff of jnp code and not a Pallas
kernel. The backward launches nothing and adds in a fixed order (no
atomics), so a training step repeats bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_tensor, dispatch_device, shape_only
from repro_torch.kernels.fm_interaction.fm_interaction import fm_interaction
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref
from repro_torch.kernels.work import fm_interaction_work, record

# Kernel launches made through `fm_interaction_op`, in this process. Callers
# that count (the serve launcher, chip_smoke.py) reset it to 0 themselves.
launches = 0


def fm_interaction_grad(e: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gradient of `fm_interaction_ref` at e [B, F, k] for dy [B]."""
    s = torch.sum(e, dim=1, keepdim=True)  # Σ_f e
    return dy[:, None, None] * (s - e)


class _FMInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e):
        global launches
        ctx.save_for_backward(e)
        work = lambda: fm_interaction_work(*e.shape)  # noqa: E731
        if shape_only(e):
            record("fm_interaction", work)
            return e.new_empty(e.shape[:1])
        if e.device.type == "cpu":
            return fm_interaction_ref(e)
        out = fm_interaction(e)
        launches += 1
        record("fm_interaction", work)
        return out

    @staticmethod
    def backward(ctx, dy):
        (e,) = ctx.saved_tensors
        return fm_interaction_grad(e, dy)


def fm_interaction_op(e: torch.Tensor) -> torch.Tensor:
    """e: f32 [B, F, k] -> f32 [B] = ½ Σ_c [(Σ_f e)² − Σ_f e²]."""
    check_tensor(e, "e", 3, torch.float32)
    if min(e.shape) < 1:
        raise ValueError(f"need B, F and k of at least 1, got e {tuple(e.shape)}")
    dispatch_device("fm_interaction_op", e=e)
    return _FMInteraction.apply(e)
