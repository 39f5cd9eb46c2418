"""PyTorch / CUDA port of the `repro` recommendation-system package.

The port mirrors `repro`'s module paths (`repro.models.recsys.taobao_ssa`
-> `repro_torch.models.recsys.taobao_ssa`) so that the counterpart of each
module is easy to find, and keeps `repro`'s data layout at every public
function: parameter trees are nested dicts of tensors with the same keys
(`"tables"`, `"pos"`, `"enc0"`, `"tower_w0"`, ...), and compressed linears
use the same rep dicts (`{"q","s"}`, `{"w","mask"}`, ... — see
`core/lightweight.py`).

What differs from `repro`:

- It imports `torch` and numpy, never `jax`, and nothing of `repro`: where
  it needs a module of `repro` (configs, synthetic data) it keeps its own
  copy.
- The logical-axis sharding argument `rules` and `constrain` (no-ops on
  one device) are dropped from every signature.
- Randomness comes from an explicit `torch.Generator`, and tensors live on
  an explicit `device`. Entry points default to `device="cuda"` and raise
  when CUDA is missing; the CPU is used only when the caller passes
  `device="cpu"`.
- Every TPU kernel on a ported path is a hand-written Hopper kernel under
  `csrc/`, bound through `kernels/<name>/`. On a CPU tensor a kernel's
  wrapper runs the kernel's plain PyTorch version instead.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device a caller asked for; raises if it asked for CUDA and there
    is none (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
