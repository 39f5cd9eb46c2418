"""Wrapper for the FM interaction kernel: checks, dispatch and a launch count.

A CPU tensor goes to the plain version (`ref.fm_interaction_ref`); a CUDA
tensor goes to the Hopper kernel, or the call raises. Unlike `repro`'s
wrapper, which falls back to the ref unless B divides by 256, the kernel
takes any B.

The kernel has no backward yet: on a CUDA tensor that requires grad, with
grad mode on, the wrapper raises rather than return an output that
autograd cannot see through. Training FM on the card waits for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._checks import check_no_grad, check_tensor, dispatch_device
from repro_torch.kernels.fm_interaction.fm_interaction import fm_interaction
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

# Kernel launches made through `fm_interaction_op`, in this process. Callers
# that count (the serve launcher, chip_smoke.py) reset it to 0 themselves.
launches = 0


def fm_interaction_op(e: torch.Tensor) -> torch.Tensor:
    """e: f32 [B, F, k] -> f32 [B] = ½ Σ_c [(Σ_f e)² − Σ_f e²]."""
    global launches
    check_tensor(e, "e", 3, torch.float32)
    if min(e.shape) < 1:
        raise ValueError(f"need B, F and k of at least 1, got e {tuple(e.shape)}")
    if dispatch_device("fm_interaction_op", e=e).type == "cpu":
        return fm_interaction_ref(e)
    check_no_grad("fm_interaction_op", e=e)
    out = fm_interaction(e)
    launches += 1
    return out
