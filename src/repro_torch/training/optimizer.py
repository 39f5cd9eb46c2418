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
last axis to block a 0-d leaf along (FM's bias) and raises there.

Across ranks (`update(..., layout=(mesh, specs))`, the params'
PartitionSpecs) each rank updates its block of each leaf, and the update
is the whole leaf's update restricted to that block, to the bit. The
moments' codes are split as the leaf; their scales keep the leaf's
leading-dim splits but hold the whole last axis (`state_pspecs`), since
the blocks of 256 run along the whole leaf's last axis, zero-padded at its
end. A leaf split only on leading dims (most FSDP weights, the
recommender's row-split tables) holds whole blocks: its update reads nothing of another
rank. Where the last axis is split, a rank's columns need not start or end
on a block's edge (a 512-wide axis over 4 ranks gives each 128 columns,
half a block): each column takes the scale of the whole leaf's block it
lies in, and a new scale is the largest |value| of its block, a max over
the ranks that split the last axis (`collectives.max_in_place`, exact).

`abstract_state` and `state_pspecs` are the state's shapes and layout for
specs and sizes without memory: `init` on "meta" tensors, and the params'
PartitionSpecs carried over to each moment.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.distributed.collectives import max_in_place
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import axes_index, entry_axes, mesh_groups
from repro_torch.models.common import float_tree, tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params, layout=None): `layout` (mesh, the params'
    # PartitionSpecs) where each argument is a rank's blocks
    update: Callable[..., Tuple[Any, Any]]


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), float_tree(params))


def sgd(lr: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": _zeros(params)}

    def update(grads, state, params, layout=None):  # elementwise: any rank's block alone
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

    def update(grads, state, params, layout=None):  # elementwise: any rank's block alone
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


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device (a CUDA division by a
    Python number multiplies by its f32 reciprocal)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


class _Cols(NamedTuple):
    """A rank's columns of a leaf whose last axis is split: the first
    one's index in the whole leaf, the whole axis's length, and the
    groups of the mesh dims that split it."""
    first: int
    whole: int
    groups: Tuple

    def block(self, n: int, device) -> torch.Tensor:
        """The whole leaf's block of each of the n columns."""
        return torch.div(torch.arange(self.first, self.first + n, device=device), _BLOCK,
                         rounding_mode="floor")


def _cols_of(spec, ndim: int, n: int, mesh):
    """`_Cols` of a rank's block [..., n] under `spec` on `mesh`, or None
    where its last axis is whole."""
    axes = entry_axes(spec[ndim - 1]) if ndim and len(spec) == ndim else ()
    groups = mesh_groups(mesh, axes)
    if not groups:
        return None
    index, ways = axes_index(mesh, axes)
    return _Cols(index * n, ways * n, groups)


def _quantize_blockwise(x: torch.Tensor, cols=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (f32) -> (int8 codes of x.shape, f32 scales [..., n_blocks]).
    With `cols`, x is a rank's columns of the leaf; the scales are the
    whole last axis's."""
    *lead, n = x.shape
    if cols is None:
        blocks = _blocks_of(x)
        scale = _div(torch.amax(torch.abs(blocks), dim=-1), 127.0)
        safe = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(blocks / safe[..., None]), -127, 127).to(torch.int8)
        return q.reshape(*lead, -1)[..., :n], scale
    block = cols.block(n, x.device)
    amax = x.new_zeros(*lead, -(-cols.whole // _BLOCK)).scatter_reduce(
        -1, block.expand(x.shape), torch.abs(x), "amax")
    for g in cols.groups:
        max_in_place(amax, g)
    scale = _div(amax, 127.0)
    safe = torch.clamp(scale, min=1e-12)
    return torch.clamp(torch.round(x / safe[..., block]), -127, 127).to(torch.int8), scale


def _dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, cols=None) -> torch.Tensor:
    *lead, n = q.shape
    if cols is not None:
        return q.to(torch.float32) * scale[..., cols.block(n, q.device)]
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
        # the count stays on the host, where `update` reads it (see there),
        # unless the state is one without memory ("meta")
        return {
            "m": tree_map(zq, floats),
            "v": tree_map(zq, floats),
            "count": torch.zeros((), dtype=torch.int32,
                                 device="meta" if device.type == "meta" else "cpu"),
        }

    def update(grads, state, params, layout=None):
        count = state["count"] + 1
        # the update has the CPU's bits on any device: the bias corrections
        # are taken in f32 on the host (a card's `pow` rounds otherwise),
        # from the count `init` keeps there, so that nothing waits for the
        # card (a count restored to a card is read back first); each is
        # filled into a 0-d tensor on the leaves' device, no copy, which a
        # card divides by exactly (it multiplies by the reciprocal of a CPU
        # scalar)
        c = count.to(torch.float32).cpu()
        bc1 = 1 - b1**c
        bc2 = 1 - b2**c
        on_device = {}

        def corrections(x):
            if x.device not in on_device:
                on_device[x.device] = tuple(x.new_empty((), dtype=torch.float32).fill_(bc)
                                            for bc in (bc1, bc2))
            return on_device[x.device]

        mesh, specs = layout if layout is not None else (None, None)

        def leaf_update(g, mq, vq, p, spec=None):
            # a 0-d leaf has no last axis: `_dequantize_blockwise` raises, as `repro`
            cols = None if spec is None or not g.dim() else _cols_of(spec, g.dim(),
                                                                       g.shape[-1], mesh)
            c1, c2 = corrections(g)
            g = g.to(torch.float32)
            m = b1 * _dequantize_blockwise(mq["q"], mq["s"], cols) + (1 - b1) * g
            # v is stored as sqrt(v): int8's 1/127 resolution underflows the
            # small-v tail otherwise (tiny v -> code 0 -> 1/eps step blowup)
            v_prev = torch.square(_dequantize_blockwise(vq["q"], vq["s"], cols))
            v = b2 * v_prev + (1 - b2) * torch.square(g)
            step = (m / c1) / (_sqrt(v / c2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            mq2, ms2 = _quantize_blockwise(m, cols)
            vq2, vs2 = _quantize_blockwise(_sqrt(v), cols)
            return -lr * step, {"q": mq2, "s": ms2}, {"q": vq2, "s": vs2}

        rest = (grads, state["m"], state["v"], params) + ((specs,) if mesh is not None else ())
        out = tree_map(leaf_update, *rest)
        pick = lambda i: tree_map(lambda g, o: o[i], grads, out)  # noqa: E731
        return pick(0), {"m": pick(1), "v": pick(2), "count": count}

    return Optimizer(init, update)


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
