"""The train step (port of `repro.training.train_loop`).

`make_train_step(loss_fn, optimizer)` returns `train_step(params,
opt_state, batch) -> (params, opt_state, metrics)`, functional as
`repro`'s: it does not modify its arguments. Gradients come from
`torch.autograd.grad` over every float leaf of `params`, the masks of
`{"w", "mask"}` reps included (they are float parameters in `repro` too,
so their gradients enter the global-norm clip); integer leaves pass through
unchanged. Microbatching, the clip and the update keep `repro`'s order of
operations. There is no `jit`: PyTorch runs eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.common import (
    float_tree, merge_tree, tree_from_leaves, tree_leaves, tree_map)
from repro_torch.training.optimizer import Optimizer


def make_train_step(
    loss_fn: Callable,
    optimizer: Optimizer,
    *,
    grad_accum: int = 1,
    grad_clip: float = 1.0,
) -> Callable:
    """loss_fn(params, batch) -> (scalar, metrics dict)."""

    def one_grad(params, paths, leaves, batch):
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = loss_fn(merge_tree(params, tree_from_leaves(zip(paths, live))), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        paths, leaves = zip(*tree_leaves(float_tree(params)))
        if grad_accum > 1:
            # microbatch over the leading batch axis
            loss = 0.0
            grads = [torch.zeros_like(p) for p in leaves]
            for i in range(grad_accum):
                mb = {k: v.reshape((grad_accum, v.shape[0] // grad_accum) + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, metrics, grads_i = one_grad(params, paths, leaves, mb)
                grads = [a + g for a, g in zip(grads, grads_i)]
                loss = loss + loss_i
            loss = loss / grad_accum
            grads = [g / grad_accum for g in grads]
        else:
            loss, metrics, grads = one_grad(params, paths, leaves, batch)

        with torch.no_grad():
            if grad_clip:
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                                       for g in grads))
                scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
                grads = [(g * scale).to(g.dtype) for g in grads]
                metrics = {**metrics, "grad_norm": gnorm}
            trainable = tree_from_leaves(zip(paths, leaves))
            updates, opt_state = optimizer.update(tree_from_leaves(zip(paths, grads)), opt_state,
                                                trainable)
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
