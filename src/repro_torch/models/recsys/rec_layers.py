"""Small shared layers for the recsys towers (port of `repro.models.recsys.rec_layers`)."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import spans
from repro_torch.core.lightweight import linear
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import rule_groups
from repro_torch.models.common import ParamDef


def mlp_defs(name: str, in_dim: int, dims: Tuple[int, ...], out_dim: int = 1) -> Dict:
    """MLP tower ParamDefs: dims hidden layers + linear head to out_dim."""
    defs = {}
    prev = in_dim
    for i, d in enumerate(dims):
        defs[f"{name}_w{i}"] = ParamDef((prev, d), torch.float32, "fan_in", axes=(None, None))
        defs[f"{name}_b{i}"] = ParamDef((d,), torch.float32, "zeros", axes=(None,))
        defs[f"{name}_a{i}"] = ParamDef((d,), torch.float32, "zeros", axes=(None,))  # PReLU
        prev = d
    defs[f"{name}_wout"] = ParamDef((prev, out_dim), torch.float32, "fan_in", axes=(None, None))
    defs[f"{name}_bout"] = ParamDef((out_dim,), torch.float32, "zeros", axes=(None,))
    return defs


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, a * x)


def mlp_apply(params: Dict, name: str, x: torch.Tensor, n_layers: int) -> torch.Tensor:
    """All matmuls go through the compressible-linear dispatch so the C4/C5
    ladder (masked / int8 / low-rank reps) applies to every tower."""
    with spans.span("mlp", x, of=name):
        for i in range(n_layers):
            x = linear(params[f"{name}_w{i}"], x) + params[f"{name}_b{i}"]
            x = prelu(x, params[f"{name}_a{i}"])
        return linear(params[f"{name}_wout"], x) + params[f"{name}_bout"]


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor, rules=None) -> torch.Tensor:
    """Numerically stable binary cross entropy, the mean over the batch.
    Under `rules` whose "batch" splits the batch over mesh dims, `logits`
    and `labels` are this rank's block, and the mean is the global batch's,
    as `repro`'s `jnp.mean` of a batch-split array: the local sum, summed
    over those dims (`sum_forward`: every rank then holds the loss), over
    the global count."""
    z = logits.to(torch.float32)
    y = labels.to(torch.float32)
    per = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    groups = rule_groups(rules, "batch")
    if not groups:
        return torch.mean(per)
    n = per.numel() * math.prod(dist.get_world_size(g) for g in groups)
    return collectives.sum_forward(torch.sum(per), groups) / n
