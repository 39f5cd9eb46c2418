"""Differentiable collectives over `torch.distributed` process groups.

Each rank holds plain local tensors; these functions exchange them, and
each is an autograd Function with the backward that its layout asks for:

  all_to_all(t, group)        the same exchange of the gradient
  all_reduce(t, group)        sum forward, sum of the gradient backward
  sum_grad(t, groups)         identity forward, the gradient summed backward
  sum_forward(t, groups)      sum forward, identity backward
  gather(t, dim, group)       the tiled all-gather along `dim`; its
                              transpose, a reduce-scatter, backward
  reduce_scatter(t, dim, group)  the reduce-scatter along `dim`; its
                              transpose, the all-gather, backward
  gather_spec(t, spec, mesh)  a block laid out by a PartitionSpec made
                              whole: `gather` along each dim it splits
  psum(t, groups)             `sum_forward` summed in f32, back in t's dtype
  scale_grad(t, s)            identity forward, the gradient times s backward
  tp_matmul(x, w, spec, mesh) x @ w on a row- or column-parallel block of w

`sum_forward` and `sum_grad` are a conjugate pair. `sum_forward` turns
partial sums that every rank of a group holds into the whole, replicated
over the group; each rank then computes the same thing from it, so the
gradient that reaches it is already the whole gradient and must not be
summed again. `sum_grad` marks a leaf that the group's ranks use alike on
different data: each forms a part of its gradient, and the parts are
summed. (`all_reduce` is shard_map's convention instead: every rank's
output is counted once in the loss, so the gradient is summed too.)

gloo's collectives take CPU tensors and, for the all-gather and
reduce-scatter, a flat [n·d0, ...] buffer ([n, d0, ...] fails). They take
bfloat16 as they are (torch 2.13's gloo gathers, reduce-scatters and sums
it, checked on two CPU ranks): a gather moves the bits, and `psum` sums a
bf16 partial product in f32. Where a
group runs gloo and the tensor lies on a card (several processes sharing
one card, which NCCL does not take), the exchange goes through host memory:
a copy to the CPU, the collective, a copy back. Every computation stays
on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axes_index, entry_axes, mesh_groups


def through_host(t: torch.Tensor, group) -> bool:
    """Whether a collective of `t` over `group` copies through host memory:
    a card's tensor over a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def sum_in_place(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over `group` in place (t contiguous), outside autograd."""
    if through_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        return t.copy_(h)
    dist.all_reduce(t, group=group)
    return t


def max_in_place(t: torch.Tensor, group) -> torch.Tensor:
    """`t`'s elementwise max over `group` in place (t contiguous), outside
    autograd."""
    if through_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, op=dist.ReduceOp.MAX, group=group)
        return t.copy_(h)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def _gather0(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `t` [d0, ...] stacked along dim 0 in group-rank order:
    [n·d0, ...]."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if through_host(src, group):
        src = src.cpu()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))  # gloo's layout
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device)


def _scatter0(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of `t` [n·d0, ...], of which this rank keeps
    its [d0, ...] block of dim 0."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if through_host(src, group):
        src = src.cpu()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device)


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    src = t.contiguous()
    if through_host(src, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


def _gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = _gather0(t, group)
    shape = list(t.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(t.shape)).movedim(0, dim).reshape(shape)


def _scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    shape = list(t.shape)
    shape[dim: dim + 1] = [n, shape[dim] // n]
    parts = t.reshape(shape).movedim(dim, 0)
    out = _scatter0(parts.reshape((-1,) + tuple(parts.shape[2:])), group)
    return out.reshape(parts.shape[1:])


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return sum_in_place(t.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return sum_in_place(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        for g in ctx.groups:
            sum_in_place(grad, g)
        return grad, None


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        out = t.clone(memory_format=torch.contiguous_format)
        for g in groups:
            sum_in_place(out, g)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.s, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_dim(grad, ctx.dim, ctx.group), None, None


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_dim(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.dim, ctx.group), None, None


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of dim 0 to group rank i, the chunks received stacked in
    source order (`all_to_all_single` of equal chunks); backward, the same
    exchange of the gradient."""
    return _AllToAll.apply(t, group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group`; backward, the sum of the gradient."""
    return _AllReduce.apply(t, group)


def sum_grad(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """`t` itself; backward, the gradient summed over each of `groups`."""
    return _SumGrad.apply(t, tuple(groups)) if groups else t


def sum_forward(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The sum of `t` over each of `groups` in turn; backward, the gradient
    as it is (see the module's docstring)."""
    return _SumForward.apply(t, tuple(groups)) if groups else t


def gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' `t` concatenated along `dim` in group-rank order (a tiled
    all-gather, n times `t`'s size); backward, the reduce-scatter (sum) of
    the gradient."""
    return _GatherDim.apply(t, dim, group)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of `t` over `group`, of which this rank keeps its block of
    `dim` (1/n of it, in group-rank order); backward, the tiled all-gather
    of the gradient."""
    return _ReduceScatterDim.apply(t, dim, group)


def gather_spec(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor of which `t` is this rank's block under `spec` (a
    PartitionSpec) on `mesh`: each dim gathered over the mesh dims its
    entry names, the minor one first, so that the major one ends outermost
    (`sharding.block_slices`' numbering). Each step is a `gather`, so the
    backward reduce-scatters: the sum of every rank's gradient, this rank's
    block of it. Mesh dims of one rank are skipped."""
    for d, entry in enumerate(spec):
        for g in reversed(mesh_groups(mesh, entry_axes(entry))):
            t = gather(t, d, g)
    return t


def psum(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """`sum_forward` of partial products: summed in f32 and cast back, so
    that a bf16 partial sum rounds once, as the whole product does."""
    if not groups:
        return t
    return sum_forward(t.float(), groups).to(t.dtype)


def scale_grad(t: torch.Tensor, s: float) -> torch.Tensor:
    """`t` itself; backward, the gradient times `s`. An output of
    `all_reduce` that each of n ranks counts in its own copy of a
    replicated loss takes s = 1/n: `all_reduce`'s backward sums the n
    copies' gradients, and the loss counts the output once."""
    return _ScaleGrad.apply(t, s) if s != 1 else t


def tp_matmul(x: torch.Tensor, w: torch.Tensor, spec, mesh) -> torch.Tensor:
    """x @ w, w [N_in, N_out] this rank's block under `spec` on `mesh`
    (Megatron's tensor parallelism). Where `spec` splits w's rows
    (row-parallel), x is taken at the same block of its last dim, unless it
    holds just that block already (a column-parallel product's output),
    and the partial products are summed over those mesh dims (`psum`);
    where it splits the columns (column-parallel), the result is this
    rank's block of them."""
    rows = entry_axes(spec[0]) if len(spec) else ()
    if not rows:
        return torch.matmul(x, w)
    index, _ = axes_index(mesh, rows)
    n = w.shape[0]
    if x.shape[-1] != n:
        x = x[..., index * n:(index + 1) * n]
    return psum(torch.matmul(x, w), mesh_groups(mesh, rows))
