"""The train step (port of `repro.training.train_loop`).

`make_train_step(loss_fn, optimizer)` returns `train_step(params,
opt_state, batch) -> (params, opt_state, metrics)`, functional as
`repro`'s: it does not modify its arguments. Gradients come from
`torch.autograd.grad` over every float leaf of `params`, the masks of
`{"w", "mask"}` reps included (they are float parameters in `repro` too,
so their gradients enter the global-norm clip); integer leaves pass through
unchanged. Microbatching, the clip and the update keep `repro`'s order of
operations. There is no `jit`: PyTorch runs eagerly.

Across ranks (`rules` of a `DeviceMesh` of more than one rank, with the
params' PartitionSpecs), each rank holds its blocks of the params, the
optimizer state and the batch, as `repro`'s `jit` `in_shardings` lay them
out, and `loss_fn` is the loss under the same rules (a global-batch mean:
`rec_layers.bce_with_logits`). Each rank's backward forms its batch
block's part of every gradient; the parts are summed over the mesh dims
that split the batch (`rules["batch"]`), and a leaf split by rows keeps
its block. The clip's norm counts each element once over the mesh: a
leaf's squares are summed over the dims its spec splits it over. The
update is each rank's on its blocks (the optimizer takes the mesh and the
params' specs: adam8bit's blocks of 256 run along a whole leaf's last
axis, `training/optimizer`). Under
`whole_grads` (the LM's loss, whose collectives give each rank its block
of the whole batch's gradient: `models/transformer`) the step sums
nothing itself.

`grad_accum` splits the global batch as `repro` does: microbatch i is the
global rows [i·B/a, (i+1)·B/a). Across ranks a rank holds a block of
the global batch, not of each microbatch, so the step first gathers the
batch over the mesh dims that split it (integer ids, a few bytes a row)
and takes this rank's block of each microbatch.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.distributed.collectives import gather, sum_in_place
from repro_torch.distributed.sharding import (
    axes_index, entry_axes, mesh_groups, rule_groups)
from repro_torch.models.common import (
    float_tree, merge_tree, tree_from_leaves, tree_leaves, tree_map)
from repro_torch.training.optimizer import Optimizer


def _mesh_of(rules):
    """The mesh of `rules` where it has more than one rank, else None."""
    mesh = None if rules is None else rules.get("__mesh__")
    return mesh if mesh is not None and mesh.size() > 1 else None


def _spec_at(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def _grads(loss_fn, params, paths, leaves, batch):
    """This rank's part of the gradient of every float leaf in `leaves`."""
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_fn(merge_tree(params, tree_from_leaves(zip(paths, live))), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _sum_parts(grads, rules):
    """The ranks' parts of each gradient summed over the mesh dims that
    split the batch, in place; a leaf split by rows keeps its block."""
    with torch.no_grad():
        for g in rule_groups(rules, "batch") if _mesh_of(rules) is not None else ():
            grads = [sum_in_place(x.contiguous(), g) for x in grads]
    return grads


def _microbatches(batch, grad_accum: int, rules, mesh):
    """Each microbatch of the global batch (leading axis), this rank's
    block of it across the ranks of `mesh`."""
    if mesh is None:
        return [{k: v.reshape((grad_accum, v.shape[0] // grad_accum) + v.shape[1:])[i]
                 for k, v in batch.items()} for i in range(grad_accum)]
    axes = entry_axes(rules.get("batch"))
    index, ways = axes_index(mesh, axes)
    whole = {}
    for k, v in batch.items():
        for g in reversed(mesh_groups(mesh, axes)):  # minor first: major ends outermost
            v = gather(v, 0, g)
        whole[k] = v
    rows = next(iter(whole.values())).shape[0]
    if rows % (grad_accum * ways):
        raise ValueError(f"grad_accum={grad_accum} microbatches over {ways} batch blocks do "
                         f"not divide the global batch of {rows}")
    n = rows // (grad_accum * ways)  # a rank's rows of a microbatch
    return [{k: v[(i * ways + index) * n:(i * ways + index + 1) * n] for k, v in whole.items()}
            for i in range(grad_accum)]


def value_and_grad(loss_fn: Callable, params, batch, rules=None):
    """(loss, metrics, grads): `loss_fn(params, batch)` and the gradient of
    every float leaf of `params` (a tree of those leaves). Across the ranks
    of `rules`' mesh, the gradients are the whole batch's, each rank's
    block of each leaf, as `jax.value_and_grad` under `jit` gives them."""
    paths, leaves = zip(*tree_leaves(float_tree(params)))
    loss, metrics, grads = _grads(loss_fn, params, paths, leaves, batch)
    return loss, metrics, tree_from_leaves(zip(paths, _sum_parts(grads, rules)))


def make_train_step(
    loss_fn: Callable,
    optimizer: Optimizer,
    *,
    grad_accum: int = 1,
    grad_clip: float = 1.0,
    rules=None,
    param_specs=None,
    whole_grads: bool = False,
) -> Callable:
    """loss_fn(params, batch) -> (scalar, metrics dict). `rules` and
    `param_specs` (the params' PartitionSpec tree under those rules) make
    the step one across the ranks of `rules["__mesh__"]` (see the module's
    docstring); a mesh of one rank, or none, is the one-rank step.
    `whole_grads`: `loss_fn`'s backward gives each rank its block of the
    whole batch's gradient already, and the step sums none."""

    def train_step(params, opt_state, batch):
        mesh = _mesh_of(rules)
        if mesh is not None and param_specs is None:
            raise ValueError("a train step across ranks needs the params' PartitionSpecs")
        paths, leaves = zip(*tree_leaves(float_tree(params)))
        sum_rules = None if whole_grads else rules
        if grad_accum > 1:
            # microbatch over the leading batch axis
            loss = 0.0
            grads = [torch.zeros_like(p) for p in leaves]
            for mb in _microbatches(batch, grad_accum, rules, mesh):
                loss_i, metrics, grads_i = _grads(loss_fn, params, paths, leaves, mb)
                grads = [a + g for a, g in zip(grads, grads_i)]
                loss = loss + loss_i
            grads = _sum_parts(grads, sum_rules)
            loss = loss / grad_accum
            grads = [g / grad_accum for g in grads]
        else:
            loss, metrics, tree = value_and_grad(loss_fn, params, batch, sum_rules)
            grads = [g for _, g in tree_leaves(tree)]

        with torch.no_grad():
            if grad_clip:
                squares = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
                if mesh is not None:  # a split leaf's squares, summed over its blocks
                    for i, path in enumerate(paths):
                        spec = _spec_at(param_specs, path)
                        for group in mesh_groups(mesh, [a for e in spec for a in entry_axes(e)]):
                            squares[i] = sum_in_place(squares[i], group)
                gnorm = torch.sqrt(sum(squares))
                scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
                # in f32, then back: a bf16 gradient times the f32 scale
                # promotes in `repro`
                grads = [(g.float() * scale).to(g.dtype) for g in grads]
                metrics = {**metrics, "grad_norm": gnorm}
            trainable = tree_from_leaves(zip(paths, leaves))
            layout = None if mesh is None else (mesh, param_specs)
            updates, opt_state = optimizer.update(tree_from_leaves(zip(paths, grads)), opt_state,
                                                trainable, layout)
            new = tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype), trainable, updates)
        return merge_tree(params, new), opt_state, {**metrics, "loss": loss}

    return train_step


def fit(
    train_step,
    params,
    opt_state,
    batches,
    *,
    log_every: int = 50,
    callback=None,
) -> Tuple[Dict, Dict, list]:
    """Simple host loop for examples/tests; returns (params, state, history)."""
    history = []
    for step, batch in enumerate(batches):
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if step % log_every == 0 or callback:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            if callback:
                callback(step, m)
    return params, opt_state, history
