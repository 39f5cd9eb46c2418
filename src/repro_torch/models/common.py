"""Parameter-definition machinery (port of `repro.models.common`).

A model declares its parameters once as a nested dict of `ParamDef`s
(shape + dtype + init + logical axes). From that one declaration come:
  - real tensors (`init_params`);
  - abstract ones (`abstract_params`: tensors on the "meta" device, which
    hold a shape and a dtype and no storage, as `jax.ShapeDtypeStruct`);
  - the layout of each leaf over a mesh (`param_pspecs`: the logical axes
    through a rule table of `distributed/sharding`, in the training
    layout or, where a def has `serve_axes`, the serving one).
`from_numpy_tree` / `to_numpy_tree` carry a parameter tree between this
package and `repro` (whose trees convert to numpy with
`jax.tree.map(np.asarray, params)`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import pspec

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """A parameter's shape, dtype, init and logical axes: `axes` (one per
    dim) for training (FSDP-style), `serve_axes` for serving (TP-style)
    where it differs. Both are keywords, and `axes` has no default."""
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "fan_in"  # "fan_in" | "normal" | "zeros" | "ones" | "embed"
    scale: float = 1.0
    axes: Axes = dataclasses.field(kw_only=True)
    serve_axes: Optional[Axes] = dataclasses.field(default=None, kw_only=True)

    def __post_init__(self):
        for axes in (self.axes, self.serve_axes):
            if axes is not None and len(axes) != len(self.shape):
                raise ValueError(f"axes {axes} for a tensor of shape {self.shape}")

    def mode_axes(self, serve: bool) -> Axes:
        return self.serve_axes if (serve and self.serve_axes is not None) else self.axes


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _map_defs(fn, defs):
    if is_def(defs):
        return fn(defs)
    return {k: _map_defs(fn, defs[k]) for k in sorted(defs)}


def abstract_params(defs):
    """ParamDef tree -> tensors on the "meta" device (shape and dtype, no
    storage): `repro`'s ShapeDtypeStruct tree."""
    return _map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def param_pspecs(defs, rules, serve: bool = False):
    """ParamDef tree -> PartitionSpec tree (training or serving layout)."""
    return _map_defs(lambda d: pspec(d.mode_axes(serve), rules), defs)


def _leaves(defs):
    """ParamDef leaves of a nested dict, in `jax.tree.flatten` order (sorted keys)."""
    if is_def(defs):
        return [defs]
    return [leaf for k in sorted(defs) for leaf in _leaves(defs[k])]


def _init_one(d: ParamDef, generator: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init in ("embed", "normal"):
        std = d.scale * 0.02
    elif d.init == "fan_in":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(d.init)
    z = torch.randn(d.shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (z * std).to(device=device, dtype=d.dtype)


def init_params(defs, generator: torch.Generator, device) -> Dict[str, Any]:
    """ParamDef tree -> real tensors on `device`. Normal draws come from
    `generator` (on its own device) in sorted-key order."""
    if is_def(defs):
        return _init_one(defs, generator, device)
    return {k: init_params(defs[k], generator, device) for k in sorted(defs)}


def param_count(defs) -> int:
    return int(sum(np.prod(d.shape) for d in _leaves(defs)))


def param_bytes(defs) -> int:
    return int(sum(np.prod(d.shape) * d.dtype.itemsize for d in _leaves(defs)))


def _is_bfloat16(arr: np.ndarray) -> bool:
    """A bfloat16 array as numpy holds it: `ml_dtypes.bfloat16` (what
    `np.asarray` of a JAX bf16 array gives) or the 2-byte void type that
    `np.load` gives for a `.npy` `repro` wrote from one (descr '<V2')."""
    return arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2
                                            and arr.dtype.names is None)


def tensor_from_numpy(arr) -> torch.Tensor:
    """A writable CPU tensor of `arr`'s values and dtype. A bfloat16 array
    (see `_is_bfloat16`) is read through its 16-bit patterns into a
    `torch.bfloat16` tensor with the same bits; numpy itself has no
    bfloat16, and `torch.from_numpy` refuses `ml_dtypes`' type."""
    arr = np.asarray(arr)
    if _is_bfloat16(arr):
        bits = np.array(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """`t` on the host as numpy; a bfloat16 tensor as its 16-bit patterns
    (uint16), which `.view(ml_dtypes.bfloat16)` reads as `repro`'s values."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).reshape(t.shape)
    return t.numpy()


def from_numpy_tree(tree, device) -> Dict[str, Any]:
    """Nested dict of numpy arrays (e.g. `repro` params through
    `jax.tree.map(np.asarray, ...)`) -> the same tree of tensors on
    `device`. Every key, shape and dtype (int8 and bfloat16 included) is
    kept, bfloat16 bit for bit (`tensor_from_numpy`)."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree).to(device)


def to_numpy_tree(tree) -> Dict[str, Any]:
    """Inverse of `from_numpy_tree`: tensors anywhere -> numpy on the host,
    a bfloat16 leaf as its 16-bit patterns (`numpy_from_tensor`)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return numpy_from_tensor(tree)


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts that share `tree`'s keys (`tree`
    sets which keys are walked; `rest` may hold more)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree, path: Tuple[str, ...] = ()):
    """(path, leaf) pairs of a nested dict, in `jax.tree.leaves` order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def tree_from_leaves(pairs) -> Dict[str, Any]:
    """Inverse of `tree_leaves`: (path, leaf) pairs -> the nested dict."""
    tree: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def float_tree(tree):
    """The float tensor leaves of a nested dict, same keys, others left out:
    what `repro` differentiates and updates (its trees hold float leaves
    only; the port's may also carry integer ones, such as int8 weights or
    the block masks of `core/pruning.with_block_masks`)."""
    if isinstance(tree, dict):
        out = {k: float_tree(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None}
    return tree if torch.is_tensor(tree) and tree.is_floating_point() else None


def merge_tree(tree, update):
    """`tree` with the leaves that `update` (a subtree of it) holds replaced."""
    if not isinstance(update, dict):
        return update
    return {k: merge_tree(v, update[k]) if k in update else v for k, v in tree.items()}
