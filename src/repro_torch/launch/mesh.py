"""Mesh construction (port of `repro.launch.mesh`). Functions only:
importing this module starts no process group.

A mesh over ranks is a `torch.distributed.DeviceMesh` (`init_device_mesh`)
over the default process group, which the caller has started
(`torch.distributed.init_process_group` with its own address, world size
and rank). `AbstractMesh` has a shape and axis names and no ranks: specs
(`distributed/sharding.adapt_rules`, `pspec`) and per-rank block sizes
(`sharding.block_slices`) resolve on it as on a real mesh, as `repro`'s
resolve on `jax.sharding.AbstractMesh`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


class AbstractMesh(NamedTuple):
    """A mesh's shape and axis names, without ranks."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def size(self, dim=None) -> int:
        """Ranks along mesh dim `dim` (an index), or in all: as `DeviceMesh.size`."""
        return math.prod(self.shape) if dim is None else self.shape[dim]


def axis_names(shape) -> Tuple[str, ...]:
    """The axis names of a mesh of `shape`: ("data", "model") for two dims,
    ("pod", "data", "model") for three, as the production meshes name them."""
    return {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]


def make_mesh(shape, axis_names, device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` over the default process group, whose world
    size must be the mesh's size. Rank r sits at `r`'s row-major coordinate."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("start the default process group "
                           "(torch.distributed.init_process_group) before making a mesh")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The pod meshes: 16x16 (256 ranks) single-pod, 2x16x16 multi-pod."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}; have {have}")
    return make_mesh(shape, axes, device_type)


def make_test_mesh(device_type: str = "cuda"):
    """The (1, 1) ("data", "model") mesh, over a default process group of
    one rank."""
    return make_mesh((1, 1), ("data", "model"), device_type)
