"""Expert-parallel MoE dispatch across ranks (port of
`repro.distributed.expert_parallel`).

`repro`'s `moe_ffn_ep` is a shard_map over the expert axis; here each rank
runs the same body on its own shards, and the collectives go over the
mesh's process groups:

  local top-k routing
   -> sort entries by target expert group (model-axis rank)
   -> capacity-bounded send buffers            [n_groups, C_pair, D]
   -> all_to_all over the expert axis          (the ONLY big collective)
   -> local per-expert grouping (second sort)  [E_loc, C_e, D]
   -> batched expert FFN (weights gathered over the dp axes, FSDP-style)
   -> inverse scatter -> all_to_all back -> weighted combine.

The layout is `repro`'s (`ep_specs`, under `LM_RULES` adapted to the mesh):
x by batch over the dp axes and by seq over "model"; the expert weights by
expert over "model" and by dim 1 over the dp axes; the shared expert's
weights by dim 0 over the dp axes; the router replicated. Every step is
differentiable through `distributed/collectives`' autograd Functions
over `torch.distributed`'s collectives: an all_to_all's backward is the
reverse all_to_all, an all_reduce's an all_reduce, an all_gather's a
reduce-scatter. shard_map's transpose sums the gradient of an input over
the mesh dims its spec leaves out; the port does so explicitly
(`_Exchange.replicated`, through `collectives.sum_grad`): the router's
over every mesh dim, the shared expert's over those that are not dp axes
("model").

The aux loss is `repro`'s: each rank's own `E·Σ me·ce`, averaged over the
ranks (`pmean`), so it depends on the mesh (a (1, 4) and a (2, 2) mesh give
different values for the same tokens). Every rank returns the same aux; a
replicated output's cotangent is summed across ranks in the backward, so
the global loss that `repro` differentiates is the sum of each rank's loss
with aux weighted 1/n on each of the n ranks.

Without a mesh (or on a mesh whose "model" dim is 1) there is one group,
`n_groups = 1`, `E_loc = E`; both capacity stages (`C_pair`, then `C_e`
per expert) still apply. With `mesh=None` no collective runs; with a
mesh the all_to_alls and the aux all_reduces run whatever its size, and at
one rank each gives back its input bits. The FSDP gather runs only over a
dp group of more than one rank: over one rank it would copy the weights
into a second buffer of the same bits.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    LM_RULES, P, adapt_rules, axes_index, entry_axes, mesh_axis_names, mesh_groups)
from repro_torch.models import moe as moe_lib
from repro_torch.models.moe import combine, expert_ffn, route, scatter_rows

_SHARED = ("shared_gate", "shared_up", "shared_down")


def _sort_dispatch(keys: torch.Tensor, n_bins: int, capacity: int):
    """entries -> (slot, kept): slot = bin*capacity + rank within bin
    (rank >= capacity dropped). keys: [N] int in [0, n_bins]; a key of
    n_bins ranks in a bin of its own past the last."""
    order = torch.argsort(keys, stable=True)  # XLA's sort is stable for equal keys
    sorted_keys = keys[order]
    first = torch.searchsorted(sorted_keys, sorted_keys, right=False)
    rank = torch.arange(keys.shape[0], device=keys.device) - first
    kept = rank < capacity
    slot_sorted = torch.where(kept, sorted_keys * capacity + rank, n_bins * capacity)
    # scatter slot back to entry order (`order` is a permutation)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    kept_e = torch.empty_like(kept)
    kept_e[order] = kept
    return slot, kept_e


def _capacity(n: int, bins: int, cf: float) -> int:
    return max(4, math.ceil(n / bins * cf))


def _dp_axes(rules) -> Tuple[str, ...]:
    dp = rules.get("batch") or ()
    return (dp,) if isinstance(dp, str) else tuple(dp)


def ep_specs(rules, has_shared: bool) -> Tuple[P, Dict[str, P]]:
    """(x's spec, the layer params' specs) that `moe_ffn_ep` takes its
    shards in, under `rules` (`LM_RULES` adapted to the mesh): `repro`'s
    `in_specs`. The output has x's spec; aux is replicated."""
    dp = _dp_axes(rules) or None
    w_spec = P(rules.get("experts"), dp, None)
    specs = {"router": P(None, None), "w_gate": w_spec, "w_up": w_spec, "w_down": w_spec}
    if has_shared:
        specs.update({k: P(dp, None) for k in _SHARED})
    return P(dp, rules.get("seq"), None), specs


class _Exchange:
    """The collectives of one call: over the "model" group (`ep`) and any
    mesh dim by name, the weights' gathers by their specs (`ep_specs`' or
    `w_specs`), or none at all without a mesh."""

    def __init__(self, mesh, rules, w_specs=None):
        self.mesh = mesh
        if mesh is None:
            self.n_groups, self.names = 1, ()
            return
        self.names = mesh_axis_names(mesh)
        self.groups = {a: mesh.get_group(a) for a in self.names}
        self.ep = self.groups[rules["experts"]]
        self.n_groups = mesh.size(self.names.index(rules["experts"]))
        self.w_specs = w_specs if w_specs is not None else ep_specs(rules, True)[1]

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Chunk i of dim 0 to group rank i; the chunks received stacked in
        source order (`lax.all_to_all(..., 0, 0, tiled=False)`)."""
        if self.mesh is None:
            return t
        return collectives.all_to_all(t, self.ep)

    def gather_dp(self, w: torch.Tensor, dim: int, name: str) -> torch.Tensor:
        """`lax.all_gather(w, dp_axes, axis=dim, tiled=True)`, over the
        mesh dims that leaf `name`'s spec names at `dim` (the dp axes
        under `ep_specs`): the minor axis first, so that the major one ends
        outermost. Over a group of one rank the gather is `w` itself, as it
        costs nothing in `repro`: no second copy of the layer's weights."""
        if self.mesh is None:
            return w
        spec = self.w_specs[name]
        axes = entry_axes(spec[dim]) if dim < len(spec) else ()
        for g in reversed(mesh_groups(self.mesh, axes)):
            w = collectives.gather(w, dim, g)
        return w

    def whole(self, w: torch.Tensor, name: str) -> torch.Tensor:
        """A shared expert's weight made whole from its block under its
        spec; its gradient summed over the mesh dims the spec leaves out,
        as shard_map's transpose sums it (`replicated`)."""
        if self.mesh is None:
            return w
        spec = self.w_specs[name]
        w = self.replicated(w, tuple(a for e in spec for a in entry_axes(e)))
        return collectives.gather_spec(w, spec, self.mesh)

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        """`lax.pmean` over the dp axes and the expert axis: every rank of
        this mesh."""
        if self.mesh is None:
            return t
        for a in self.names:
            t = collectives.all_reduce(t, self.groups[a])
        return t / self.mesh.size()

    def replicated(self, t: torch.Tensor, sharded_over: Sequence[str] = ()) -> torch.Tensor:
        """`t`, whose spec names only the mesh dims `sharded_over`: its
        gradient sums over every other mesh dim, as shard_map's transpose
        sums an input's over the dims its spec leaves out."""
        if self.mesh is None:
            return t
        rest = tuple(self.groups[a] for a in self.names if a not in sharded_over)
        return collectives.sum_grad(t, rest)


def moe_ffn_ep(x, layer_params, cfg, stats=None, *, mesh=None,
               w_specs=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN. x: [B, S, D], this rank's block of the
    global x under `ep_specs`; `layer_params` this rank's blocks of the
    layer's weights. Returns (this rank's block of out, aux).

    `mesh`: a `DeviceMesh` with a "model" dim (and any dp dims of
    `LM_RULES`' "batch"); None computes one group with no collective. A
    mesh without a "model" dim takes `moe_ffn`, as `repro` does. `stats`,
    if a dict, gets appended the entries this rank dropped at each capacity
    stage, under "dropped_pair" (its send buffers' C_pair) and
    "dropped_expert" (its experts' C_e, of the entries it received)
    (tensors, read by the caller when it likes): a record, which changes
    no output.

    `w_specs` (a dict of PartitionSpecs by leaf name) gives the layout the
    weights arrive in where it is not `ep_specs`' (the serving layout of
    `param_pspecs(..., serve=True)`, sliced to one layer): each expert
    weight is gathered along dim 1 over the mesh dims its spec names there
    (never along the expert dim), a shared expert's weights whole over
    theirs; the numbers are those of `ep_specs`' layout."""
    rules = adapt_rules(LM_RULES, mesh) if mesh is not None else {}
    if mesh is not None and rules["experts"] is None:
        return moe_lib.moe_ffn(x, layer_params, cfg, stats)
    ex = _Exchange(mesh, rules, w_specs)
    n_groups = ex.n_groups
    E, K, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    if E % n_groups:
        raise ValueError(f"{E} experts over {n_groups} expert groups")
    E_loc = E // n_groups
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)

    # ---- routing (router weights replicated) ----
    gate, eidx, aux = route(xt, ex.replicated(layer_params["router"]), E, K)
    aux = ex.pmean(aux)

    # ---- stage 1: entries -> expert-group send buffers ----
    flat_e = eidx.reshape(-1)  # [T*K]
    group = torch.div(flat_e, E_loc, rounding_mode="floor")
    C_pair = _capacity(T * K, n_groups, cf)
    slot, kept = _sort_dispatch(group, n_groups, C_pair)
    tok = torch.div(torch.arange(T * K, device=x.device), K, rounding_mode="floor")

    send_x = scatter_rows(n_groups * C_pair, slot, xt[tok])
    send_e = torch.full((n_groups * C_pair + 1,), -1, dtype=flat_e.dtype, device=x.device)
    send_e = send_e.index_put((torch.clamp(slot, max=n_groups * C_pair),),
                              flat_e - group * E_loc)[:n_groups * C_pair]

    # ---- all_to_all to the expert owners ----
    recv_x, recv_e = ex.all_to_all(send_x), ex.all_to_all(send_e)

    # ---- stage 2: group received tokens by local expert ----
    R = n_groups * C_pair
    keys2 = torch.where(recv_e >= 0, recv_e, E_loc)  # padding -> drop bin
    C_e = _capacity(R, E_loc, cf)
    slot2, kept2 = _sort_dispatch(keys2, E_loc, C_e)
    slot2 = torch.where(recv_e >= 0, slot2, E_loc * C_e)
    if stats is not None:
        stats.setdefault("dropped_pair", []).append(torch.sum(~kept))
        stats.setdefault("dropped_expert", []).append(torch.sum((recv_e >= 0) & ~kept2))

    buf = scatter_rows(E_loc * C_e, slot2, recv_x).reshape(E_loc, C_e, D)

    # ---- expert FFN; weights FSDP-gathered over the dp axes ----
    w_gate, w_up, w_down = (ex.gather_dp(layer_params[k], 1, k)
                            for k in ("w_gate", "w_up", "w_down"))
    out_buf = expert_ffn(buf, w_gate, w_up, w_down).reshape(E_loc * C_e, D)

    # ---- inverse: buffer -> recv layout -> a2a back -> combine ----
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    back = torch.where((slot2 < E_loc * C_e)[:, None],
                       out_buf[torch.clamp(slot2, 0, E_loc * C_e - 1)], zero)  # [R, D]
    ret = ex.all_to_all(back)
    entry_out = torch.where(kept[:, None],
                            ret[torch.clamp(slot, 0, n_groups * C_pair - 1)], zero)  # [T*K, D]
    out = torch.sum(entry_out.reshape(T, K, D) * gate[..., None].to(x.dtype), dim=1)

    if "shared_gate" in layer_params:
        # shared weights FSDP-sharded on dim 0 over the dp axes
        sg, su, sd = (ex.whole(layer_params[k], k) for k in _SHARED)
        hg = F.silu(torch.matmul(xt, sg).float()).to(x.dtype)
        out = out + torch.matmul(hg * torch.matmul(xt, su), sd)

    return out.reshape(B, S, D), aux


def moe_ffn_tp(x, layer_params, cfg, stats=None, *, mesh, rules, w_specs,
               seq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """`models.moe.moe_ffn` on the whole batch, across the ranks of `mesh`,
    whole expert stacks never gathered: decode's dispatcher, and train's
    and prefill's under `moe_impl="gspmd"`. x: [B, S, D], this rank's block
    of the tokens: of the batch under `rules["batch"]` and, with `seq`, of
    the sequence under `rules["seq"]`; the same on the ranks of every
    other mesh dim. `layer_params` are this rank's blocks under `w_specs`
    (one layer's slice of `param_pspecs`: the serving layout, with the
    experts over "model", w_gate's and w_up's D and w_down's F over "data",
    a shared expert column- then row-parallel over "model"; or training's
    "fsdp" one, the same but for the dp dims in place of "data" and a
    shared expert's first dim over them).

    The tokens are gathered over the dims that split them, so that routing,
    capacity and drops are `moe_ffn`'s on the whole batch, computed alike
    on every rank. Each rank runs its own experts' queues: gate and up
    products over its block of D, summed over the dims that split D (each
    rank then holds the whole [E_loc, C, F] hidden), the down product over
    its block of F, a partial sum. The combine's partial outputs are summed
    over the dims that split the experts and F, a shared expert's over its
    own; this rank keeps its block of the tokens. Returns (out block, aux);
    aux is the whole batch's, as `moe_ffn`'s, the same on every rank.

    The backward is shard_map's ("partials", `collectives`' docstring):
    each rank forms its part of every gradient from its block of the
    output's, the sums sum the gradient, the token gathers reduce-scatter
    it, and each weight's part is summed over the mesh dims its spec leaves
    out (the router's over all). Where ranks hold the same tokens (dims
    that split neither batch nor sequence), each counts 1/n of its output's
    gradient and x's gradient is summed over them, so that they return the
    whole of it, as the callers' Megatron layout wants. aux's gradient is
    each rank's part (the loss weights it 1/n on each of n ranks)."""
    batch_axes = entry_axes(rules.get("batch"))
    seq_axes = entry_axes(rules.get("seq")) if seq else ()
    same = [a for a in mesh_axis_names(mesh) if a not in batch_axes + seq_axes]
    return collectives.over_copies(
        lambda t: _moe_ffn_tp(t, layer_params, cfg, stats, mesh, w_specs, batch_axes, seq_axes),
        x, mesh, same)


def _moe_ffn_tp(x, layer_params, cfg, stats, mesh, w_specs, batch_axes, seq_axes):
    """`moe_ffn_tp` on ranks that each hold their own tokens."""
    B, S, D = x.shape
    for g in reversed(mesh_groups(mesh, seq_axes)):
        x = collectives.gather(x, 1, g)
    for g in reversed(mesh_groups(mesh, batch_axes)):
        x = collectives.gather(x, 0, g)
    xt = x.reshape(-1, D)
    p = {k: collectives.sum_grad_outside(v, w_specs[k], mesh) for k, v in layer_params.items()}
    buffer, entry_slot, gate, aux = moe_lib.dispatch(xt, p["router"], cfg, stats)

    E = cfg.n_experts
    spec_in, spec_out = w_specs["w_gate"], w_specs["w_down"]
    e_axes = entry_axes(spec_in[0])
    e_idx, e_ways = axes_index(mesh, e_axes)
    E_loc = E // e_ways
    C = buffer.shape[1]
    buf = buffer[e_idx * E_loc:(e_idx + 1) * E_loc]  # [E_loc, C, D]
    d_axes = entry_axes(spec_in[1]) if len(spec_in) > 1 else ()
    d_idx, d_ways = axes_index(mesh, d_axes)
    Db = D // d_ways
    buf = buf[..., d_idx * Db:(d_idx + 1) * Db]
    d_groups = mesh_groups(mesh, d_axes)
    g = collectives.psum(torch.einsum("ecd,edf->ecf", buf, p["w_gate"]), d_groups, True)
    u = collectives.psum(torch.einsum("ecd,edf->ecf", buf, p["w_up"]), d_groups, True)
    h = F.silu(g.float()).to(buf.dtype) * u  # [E_loc, C, F]
    f_axes = entry_axes(spec_out[1]) if len(spec_out) > 1 else ()
    f_idx, f_ways = axes_index(mesh, f_axes)
    Fb = h.shape[-1] // f_ways
    part = torch.einsum("ecf,efd->ecd", h[..., f_idx * Fb:(f_idx + 1) * Fb],
                        p["w_down"])  # [E_loc, C, D], a partial sum over F
    # this rank's experts' rows of the flattened buffer; other entries read zeros
    local = entry_slot - e_idx * E_loc * C
    local = torch.where((entry_slot >= 0) & (local >= 0) & (local < E_loc * C), local, -1)
    out = combine(part.reshape(-1, D), local, gate)
    out = collectives.psum(out, mesh_groups(mesh, e_axes + f_axes), True)

    if "shared_gate" in p:
        mm = lambda t, k: collectives.tp_matmul(t, p[k], w_specs[k], mesh, True)  # noqa: E731
        hs = F.silu(mm(xt, "shared_gate").float()).to(xt.dtype) * mm(xt, "shared_up")
        out = out + mm(hs, "shared_down")

    b_idx, _ = axes_index(mesh, batch_axes)
    s_idx, _ = axes_index(mesh, seq_axes)
    out = out.reshape(-1, x.shape[1], D)[b_idx * B:(b_idx + 1) * B, s_idx * S:(s_idx + 1) * S]
    return out, aux
