"""Optimizers over nested dicts of tensors (port of `repro.training.optimizer`).

Functional, as `repro`'s mini-optax: `init(params) -> state` and
`update(grads, state, params) -> (updates, state)`, the caller applying
`p + u`. Not `torch.optim`: `repro`'s AdamW takes b2 = 0.95 and no weight
decay by default and corrects the bias in f32 from an int32 step count,
where `torch.optim.AdamW` defaults to β₂ 0.999 and weight decay 0.01. The
arithmetic keeps `repro`'s order. Gradients are dense, so every row of a
table moves its moments every step, as in `repro`.

Only float leaves carry state (`models/common.float_tree`). `adam8bit`
keeps `repro`'s block-wise int8 moments: blocks of 256 along the last axis,
`v` stored as its square root, codes rounded half to even (`torch.round`
as `jnp.round`). `repro` maps a leaf of rank 3 or more over its first axis
(`lax.map`) to save memory; every element's arithmetic is the same either
way, so the port updates the whole leaf at once. As `repro`'s, it has no
last axis to block a 0-d leaf along (FM's bias) and raises there. Its
blocks of 256 are not elementwise: a rank's block of a leaf split by rows
would block differently from `repro`'s whole leaf, so a train step across
ranks refuses it (`Optimizer.elementwise`).

`abstract_state` and `state_pspecs` are the state's shapes and layout for
specs and sizes without memory: `init` on "meta" tensors, and the params'
PartitionSpecs carried over to each moment.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.models.common import float_tree, tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)
    # each element's update reads only that element (and scalars such as
    # the step count), so a rank can update its block of a split leaf alone
    elementwise: bool = True


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


_BLOCK = 256


def _blocks_of(x: torch.Tensor) -> torch.Tensor:
    """x [..., n] -> [..., n_blocks, _BLOCK], the last axis zero-padded."""
    *lead, n = x.shape
    pad = (-n) % _BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(*lead, -1, _BLOCK)


def _quantize_blockwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (f32) -> (int8 codes of x.shape, f32 scales [..., n_blocks])."""
    *lead, n = x.shape
    blocks = _blocks_of(x)
    scale = torch.amax(torch.abs(blocks), dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / safe[..., None]), -127, 127).to(torch.int8)
    q = q.reshape(*lead, -1)[..., :n]
    return q, scale


def _dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    *lead, n = q.shape
    blocks = _blocks_of(q.to(torch.float32)) * scale[..., None]
    return blocks.reshape(*lead, -1)[..., :n]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's (ATen's vectorised
    CPU `sqrt` is off by an ulp for some inputs): the f64 root, rounded once."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _n_blocks(shape) -> Tuple[int, ...]:
    if not shape:
        return (1,)
    return tuple(shape[:-1]) + (-(-shape[-1] // _BLOCK),)


def adam8bit(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        def zq(p):
            return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    "s": torch.zeros(_n_blocks(tuple(p.shape)), dtype=torch.float32,
                                     device=p.device)}

        floats = float_tree(params)
        device = next(leaf for _, leaf in tree_leaves(floats)).device
        return {
            "m": tree_map(zq, floats),
            "v": tree_map(zq, floats),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(grads, state, params):
        count = state["count"] + 1
        c = count.to(torch.float32)
        bc1 = 1 - b1**c
        bc2 = 1 - b2**c

        def leaf_update(g, mq, vq, p):
            g = g.to(torch.float32)
            m = b1 * _dequantize_blockwise(mq["q"], mq["s"]) + (1 - b1) * g
            # v is stored as sqrt(v): int8's 1/127 resolution underflows the
            # small-v tail otherwise (tiny v -> code 0 -> 1/eps step blowup)
            v_prev = torch.square(_dequantize_blockwise(vq["q"], vq["s"]))
            v = b2 * v_prev + (1 - b2) * torch.square(g)
            step = (m / bc1) / (_sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            mq2, ms2 = _quantize_blockwise(m)
            vq2, vs2 = _quantize_blockwise(_sqrt(v))
            return -lr * step, {"q": mq2, "s": ms2}, {"q": vq2, "s": vs2}

        out = tree_map(leaf_update, grads, state["m"], state["v"], params)
        pick = lambda i: tree_map(lambda g, o: o[i], grads, out)  # noqa: E731
        return pick(0), {"m": pick(1), "v": pick(2), "count": count}

    return Optimizer(init, update, elementwise=False)


def get_optimizer(name: str, lr: float = 1e-4, **kw) -> Optimizer:
    return {"sgd": sgd, "adamw": adamw, "adam8bit": adam8bit}[name](lr, **kw)


# ---------------------------------------------------------------------------
# State shape/sharding views (for specs and sizes without memory)
# ---------------------------------------------------------------------------


def abstract_state(opt_name: str, abstract_params) -> Any:
    """The state `init` makes, as "meta" tensors (shape and dtype, no
    storage), from params that may themselves be "meta" tensors
    (`models/common.abstract_params`)."""
    return get_optimizer(opt_name).init(abstract_params)


def state_pspecs(opt_name: str, params_pspecs, abstract_params=None) -> Any:
    """PartitionSpecs for the optimizer state given param pspecs.

    Moments inherit the param sharding. Adam8bit's [..., n_blocks] scales
    keep every leading-dim sharding and un-shard only the blocked LAST
    axis — `abstract_params` supplies tensor ranks (PartitionSpecs trim
    trailing Nones, so rank is not recoverable from the spec alone).
    """
    if opt_name == "sgd":
        return {"mu": params_pspecs}
    if opt_name == "adamw":
        return {"m": params_pspecs, "v": params_pspecs, "count": P()}
    if opt_name == "adam8bit":
        def scale_spec(spec: P, ndim: int) -> P:
            parts = list(spec)
            if len(parts) == ndim and parts:
                parts[-1] = None  # only the true last axis loses sharding
            return P(*parts)

        if abstract_params is not None:
            qtree = tree_map(lambda spec, p: {"q": spec, "s": scale_spec(spec, p.dim())},
                             params_pspecs, abstract_params)
        else:
            qtree = tree_map(lambda spec: {"q": spec, "s": spec}, params_pspecs)
        return {"m": qtree, "v": qtree, "count": P()}
    raise ValueError(opt_name)
