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
  psum(t, groups, partials)   `sum_forward` summed in f32, back in t's dtype;
                              with `partials`, the gradient summed too
  scale_grad(t, s)            identity forward, the gradient times s backward
  sum_grad_outside(t, spec, mesh, axes)
                              `sum_grad` over the dims that spec leaves out
  over_copies(fn, x, mesh, axes)
                              fn(x) on ranks that hold x alike, each copy
                              counted 1/n
  tp_matmul(x, w, spec, mesh, partials)
                              x @ w on a row- or column-parallel block of w

`sum_forward` and `sum_grad` are a conjugate pair. `sum_forward` turns
partial sums that every rank of a group holds into the whole, replicated
over the group; each rank then computes the same thing from it, so the
gradient that reaches it is already the whole gradient and must not be
summed again. `sum_grad` marks a leaf that the group's ranks use alike on
different data: each forms a part of its gradient, and the parts are
summed. (`all_reduce` is shard_map's convention instead: every rank's
output is counted once in the loss, so the gradient is summed too.)

The two conventions are those of a value that a group's ranks hold alike.
Megatron's ("replicated"): each rank holds the whole gradient of it, and
a rank that uses only a block of it (a column block of the weights, a
slice of x) marks it with `sum_grad` first, so that its part of the
gradient is summed back into the whole. shard_map's ("partials"): each
rank holds only its part of the gradient, the whole is their sum, and a
sum over the group sums the gradient too (`psum(..., partials=True)`).

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

import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axes_index, entry_axes, mesh_axis_names, mesh_groups


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


def _sum_f32(t: torch.Tensor, groups) -> torch.Tensor:
    out = t.float().clone(memory_format=torch.contiguous_format)
    for g in groups:
        sum_in_place(out, g)
    return out.to(t.dtype)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _sum_f32(t, groups)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.groups), None


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


def psum(t: torch.Tensor, groups: Sequence, partials: bool = False) -> torch.Tensor:
    """`sum_forward` of partial products: summed in f32 and cast back, so
    that a bf16 partial sum rounds once, as the whole product does. With
    `partials` (shard_map's convention, module docstring) the gradient
    that reaches each rank is its part only, and the backward sums the
    parts the same way."""
    if not groups:
        return t
    if partials:
        return _PSum.apply(t, tuple(groups))
    return sum_forward(t.float(), groups).to(t.dtype)


def scale_grad(t: torch.Tensor, s: float) -> torch.Tensor:
    """`t` itself; backward, the gradient times `s`. An output of
    `all_reduce` that each of n ranks counts in its own copy of a
    replicated loss takes s = 1/n: `all_reduce`'s backward sums the n
    copies' gradients, and the loss counts the output once."""
    return _ScaleGrad.apply(t, s) if s != 1 else t


def sum_grad_outside(t: torch.Tensor, spec, mesh, axes=None) -> torch.Tensor:
    """`sum_grad` over the mesh dims of `axes` (by default all of the
    mesh's) that `spec` leaves out: `t` is a block under `spec` that the
    ranks of those dims hold alike and use each on its own data, so that
    each forms a part of its gradient."""
    named = {a for e in spec for a in entry_axes(e)}
    axes = mesh_axis_names(mesh) if axes is None else axes
    return sum_grad(t, mesh_groups(mesh, [a for a in axes if a not in named]))


def over_copies(fn, x: torch.Tensor, mesh, axes):
    """`fn(x)`, which returns (out, *rest), on ranks that hold the same x
    over the mesh dims `axes`, where fn's backward is shard_map's (each
    rank returns its part of x's gradient): each copy counts 1/n of out's
    gradient, and x's gradient is summed over the n copies, so that every
    rank returns the whole of it, as Megatron's convention wants."""
    out, *rest = fn(sum_grad(x, mesh_groups(mesh, axes)))
    n = math.prod(mesh.size(mesh_axis_names(mesh).index(a)) for a in axes)
    return (scale_grad(out, 1.0 / n), *rest)


def tp_matmul(x: torch.Tensor, w: torch.Tensor, spec, mesh, partials: bool = False
              ) -> torch.Tensor:
    """x @ w, w [N_in, N_out] this rank's block under `spec` on `mesh`
    (Megatron's tensor parallelism). Where `spec` splits w's rows
    (row-parallel), x is taken at the same block of its last dim, unless it
    holds just that block already (a column-parallel product's output),
    and the partial products are summed over those mesh dims (`psum`);
    where it splits the columns (column-parallel), the result is this
    rank's block of them.

    The backward follows the module docstring's conventions: by default
    Megatron's, where x is the same on the ranks of the dims that split w:
    where a rank uses all of x (column-parallel) or a slice of it, x's
    gradient is summed over those dims (Megatron's f, `sum_grad`), and the
    sum of the partial products passes the gradient as it is (its g). With
    `partials`, shard_map's: x's gradient stays this rank's part, and the
    sum sums the gradient too."""
    rows = entry_axes(spec[0]) if len(spec) else ()
    if not rows:
        if not partials:
            x = sum_grad(x, mesh_groups(mesh, entry_axes(spec[1]) if len(spec) > 1 else ()))
        return torch.matmul(x, w)
    index, _ = axes_index(mesh, rows)
    groups = mesh_groups(mesh, rows)
    n = w.shape[0]
    if x.shape[-1] != n:
        if not partials:
            x = sum_grad(x, groups)
        x = x[..., index * n:(index + 1) * n]
    return psum(torch.matmul(x, w), groups, partials)
