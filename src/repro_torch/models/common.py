"""Parameter-definition machinery (port of `repro.models.common`).

A model declares its parameters once as a nested dict of `ParamDef`s
(shape + dtype + init). `init_params` turns that tree into real tensors;
`from_numpy_tree` / `to_numpy_tree` carry a parameter tree between this
package and `repro` (whose trees convert to numpy with
`jax.tree.map(np.asarray, params)`). The logical sharding axes of
`repro`'s `ParamDef` are dropped: the port runs on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "fan_in"  # "fan_in" | "normal" | "zeros" | "ones" | "embed"
    scale: float = 1.0


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


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


def from_numpy_tree(tree, device) -> Dict[str, Any]:
    """Nested dict of numpy arrays (e.g. `repro` params through
    `jax.tree.map(np.asarray, ...)`) -> the same tree of tensors on
    `device`. Every key, shape and dtype (int8 included) is kept."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)  # a writable copy


def to_numpy_tree(tree) -> Dict[str, Any]:
    """Inverse of `from_numpy_tree`: tensors anywhere -> numpy on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


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
