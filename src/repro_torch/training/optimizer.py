"""Optimizers over nested dicts of tensors (port of `repro.training.optimizer`).

Functional, as `repro`'s mini-optax: `init(params) -> state` and
`update(grads, state, params) -> (updates, state)`, the caller applying
`p + u`. Not `torch.optim`: `repro`'s AdamW takes b2 = 0.95 and no weight
decay by default and corrects the bias in f32 from an int32 step count,
where `torch.optim.AdamW` defaults to β₂ 0.999 and weight decay 0.01. The
arithmetic keeps `repro`'s order. Gradients are dense, so every row of a
table moves its moments every step, as in `repro`.

Only float leaves carry state (`models/common.float_tree`). `adam8bit`
comes with a later slice.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.models.common import float_tree, tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), float_tree(params))


def sgd(lr: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": _zeros(params)}

    def update(grads, state, params):
        mu = tree_map(lambda g, m: momentum * m + g.to(torch.float32), grads, state["mu"])
        updates = tree_map(lambda m: -lr * m, mu)
        return updates, {"mu": mu}

    return Optimizer(init, update)


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        zeros = _zeros(params)
        device = next(leaf for _, leaf in tree_leaves(zeros)).device
        return {
            "m": zeros,
            "v": _zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(grads, state, params):
        count = state["count"] + 1
        c = count.to(torch.float32)
        m = tree_map(lambda g, m_: b1 * m_ + (1 - b1) * g.to(torch.float32), grads, state["m"])
        v = tree_map(
            lambda g, v_: b2 * v_ + (1 - b2) * torch.square(g.to(torch.float32)),
            grads, state["v"],
        )
        bc1 = 1 - b1**c
        bc2 = 1 - b2**c

        def upd(m_, v_, p):
            step = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            return -lr * step

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "count": count}

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float = 1e-4, **kw) -> Optimizer:
    opts = {"sgd": sgd, "adamw": adamw}
    if name not in opts:
        raise NotImplementedError(f"optimizer {name!r} is not ported (adam8bit comes later)")
    return opts[name](lr, **kw)
