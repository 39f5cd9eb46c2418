"""Checks every kernel wrapper makes before it dispatches.

A wrapper refuses what its kernel does not take, and picks its path from
the device its tensors lie on: the CPU runs the plain version, the current
CUDA device runs the kernel, anything else raises. Fake tensors
(`torch._subclasses.fake_tensor`, the dry run's: shapes and dtypes, no
storage) on either device take the shape-only path instead (`shape_only`):
the wrapper returns an output of the kernel's shape and dtype, launches
nothing and counts no launch. The path follows from the tensors' type,
never from a failure.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake


def check_tensor(t: torch.Tensor, name: str, ndim: int, dtype: torch.dtype, *,
                 contiguous: bool = True) -> None:
    """Type, rank and dtype; with `contiguous` False, `check_rows` instead of
    contiguity."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not contiguous:
        check_rows(t, name)


def check_rows(t: torch.Tensor, name: str) -> None:
    """A view whose kernel reads its last dimension as rows of 16-byte
    vectors: that dimension contiguous, the base and every other stride
    (of a dimension longer than 1) a multiple of 16 bytes."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name} must have a contiguous last dimension, got strides {t.stride()}")
    size = t.element_size()
    misaligned = not is_fake(t) and t.data_ptr() % 16  # a fake tensor has no address
    if misaligned or any(s * size % 16 for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1):
        raise ValueError(f"{name} must start on 16 bytes and step by multiples of 16 bytes, "
                         f"got strides {t.stride()} of {size}-byte elements")


def shape_only(*tensors) -> bool:
    """Whether a call takes the shape-only path: one of `tensors` (None
    entries skipped) is a fake tensor."""
    return any(t is not None and is_fake(t) for t in tensors)


def dispatch_device(op: str, **tensors) -> torch.device:
    """The one device of `tensors` (None entries are skipped): cpu, or the
    current CUDA device (a kernel's library launches there); fake tensors
    on any CUDA device, where nothing launches."""
    devices = {t.device for t in tensors.values() if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{', '.join(tensors)} must share one device, got {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"{op} runs on cpu or cuda, not {dev}")
    if shape_only(*tensors.values()):
        return dev
    if dev.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors are on {dev} but the current device is cuda:{torch.cuda.current_device()}")
    return dev


def check_no_grad(op: str, **tensors) -> None:
    """Raise if autograd would need a gradient through a kernel that has no
    backward (grad mode on and one of `tensors` requires grad)."""
    if not torch.is_grad_enabled():
        return
    needing = [name for name, t in tensors.items() if t.requires_grad]
    if needing:
        raise RuntimeError(
            f"{op} has no backward on CUDA, but {', '.join(needing)} requires grad: "
            "call it under torch.no_grad(), or on CPU tensors (the plain version is "
            "differentiable)")
