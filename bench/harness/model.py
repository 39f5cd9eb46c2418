"""The system under test, its configuration and its weights.

The program is `repro_torch`: the configuration object comes from its
`configs.base.get_config`, and is held to the sizes in the cell's
configuration file, so that the file is the configuration as run. The
weights are the benchmark's own: drawn on the device from the seed, in
one draw, in the tree layout that `repro_torch.models.recsys.api.
param_defs(cfg)` names, so that the program and the reference read the
same tensors and neither made them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# The keys of a configuration file that are the program's `RecSysConfig`
# fields; the rest (source, variant, precision, roles, assumed, check)
# are the benchmark's.
MODEL_KEYS = ("interaction", "embed_dim", "seq_len", "n_attn_layers", "n_heads", "d_attn",
              "mlp_dims", "attn_mlp_dims", "gru_dim", "dtype", "quantized", "pruned")

# Leaves are laid out in one buffer at multiples of this many floats (256
# bytes, the allocator's own alignment), so every table keeps the aligned
# rows the lookup kernel loads 16 bytes at a time.
ALIGN = 64


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of a run, from a seed of any size."""
    return int(np.random.SeedSequence([int(seed) % (1 << 128), stream]).generate_state(
        1, np.uint64)[0]) >> 1


def program_config(model: Dict, exact: bool = True):
    """The program's config for the configuration file `model`: the
    program's own (`get_config(model["arch"])`) with the file's sizes.
    With `exact`, a size may differ from the program's only under a key
    that the file lists in `program_overrides`; without, any may (the CPU
    tests' tiny widths)."""
    from repro_torch.configs.base import FieldSpec, get_config

    cfg = get_config(model["arch"])
    want = {k: (tuple(v) if isinstance(v, list) else v) for k, v in model.items()
            if k in MODEL_KEYS}
    want["fields"] = tuple(FieldSpec(**{k: v for k, v in f.items() if k != "role"})
                           for f in model["fields"])
    have = {k: getattr(cfg, k) for k in want}
    allowed = set(model.get("program_overrides", []))
    diff = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if exact and set(diff) - allowed:
        raise ValueError(f"configs/{model['arch']}.json differs from the program's config "
                         f"outside its program_overrides: "
                         f"{ {k: v for k, v in diff.items() if k not in allowed} }")
    return dataclasses.replace(cfg, **want) if diff else cfg


def _leaves(defs, path=()) -> List[Tuple[Tuple[str, ...], object]]:
    if hasattr(defs, "shape") and hasattr(defs, "init"):
        return [(path, defs)]
    return [leaf for k in sorted(defs) for leaf in _leaves(defs[k], path + (k,))]


def _std_and_mean(d) -> Tuple[float, float]:
    """Draws that keep every layer's activations near unit scale, so that
    the comparison of scores sees every layer: table rows and positions of
    unit norm, fan-in weights, small non-zero biases and PReLU slopes, and
    layer-norm scales near 1."""
    if d.init in ("embed", "normal"):
        return 1.0 / math.sqrt(d.shape[-1]), 0.0
    if d.init == "fan_in":
        return 1.0 / math.sqrt(d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]), 0.0
    if d.init == "zeros":
        return 0.1, 0.0
    if d.init == "ones":
        return 0.1, 1.0
    raise ValueError(d.init)


def make_weights(cfg, seed: int, device) -> Dict:
    """The parameter tree of `param_defs(cfg)`, f32, drawn from `seed` on
    `device` in one call into one buffer; each leaf is an aligned,
    contiguous view of it, scaled in place."""
    from repro_torch.models.recsys.api import param_defs

    leaves = _leaves(param_defs(cfg))
    offsets, n = [], 0
    for _, d in leaves:
        offsets.append(n)
        n += -(-int(np.prod(d.shape)) // ALIGN) * ALIGN
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 1))
    flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    tree: Dict = {}
    for (path, d), off in zip(leaves, offsets):
        if d.dtype != torch.float32:
            raise ValueError(f"{'/'.join(path)}: the baseline variant serves f32, not {d.dtype}")
        leaf = flat[off:off + int(np.prod(d.shape))].view(d.shape)
        std, mean = _std_and_mean(d)
        leaf.mul_(std).add_(mean)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
