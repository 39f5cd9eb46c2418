"""Logical-axis sharding rules (port of `repro.distributed.sharding`).

Params and activations are annotated with *logical* axis names; a rule table
maps logical names -> mesh dims per architecture family. The same
declarations resolve on the single-pod (data, model) mesh, the multi-pod
(pod, data, model) mesh, and the (1, 1) test mesh.

PyTorch's idiom for the pieces: a mesh is a `torch.distributed.DeviceMesh`
(or `launch/mesh.AbstractMesh`, which has no ranks, for specs and sizes);
a spec is this module's `PartitionSpec`, a tuple in `jax.sharding.P`'s form;
a laid-out leaf is a `DTensor`, whose `placements` (`Shard(d)` /
`Replicate()`, one per mesh dim) `placements` derives from a spec. `repro`'s
`shard_map_compat` is a shim across JAX versions and has no counterpart:
the port's explicit per-rank code (`expert_parallel.moe_ffn_ep`) is plain
PyTorch over process groups.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# LM family. Two weight layouts resolved via ParamDef.axes / .serve_axes:
#   TRAIN  — FSDP: weights fully sharded over (pod, data, model) on one dim
#            ("fsdp"); activations token-sharded: batch->(pod,data) AND
#            seq->model (context parallelism), so GQA kv-head counts never
#            have to divide the mesh.
#   SERVE  — Megatron-TP: row-parallel inputs ("tp_in") / col-parallel ff
#            ("ff"), vocab->model, decode KV cache seq-sharded on model
#            (flash-decode split-K); long_500k shards KV seq on
#            (data, model) since batch=1.
LM_RULES: Mapping[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": "model",  # context-parallel tokens (train/prefill)
    "kv_seq": "model",  # decode split-K over the KV cache
    "long_kv_seq": ("data", "model"),  # 500k decode, batch=1
    "fsdp": ("pod", "data", "model"),
    "tp_in": "model",  # row-parallel contraction dim (serving)
    "ff": "model",  # col-parallel hidden dim (serving)
    "embed": None,
    "kv_heads": None,
    "head_dim": None,
    "vocab": "model",
    "experts": "model",
    "expert_dp": ("pod", "data"),  # FSDP dim of expert weights (EP train)
    "moe_in": "data",  # serve-time contraction dim of expert weights
    "expert_cap": ("pod", "data"),
    "layers": None,
    "rbf": None,
}

# RecSys: embedding-table rows are the memory -> shard rows on model;
# batch on (pod, data); dense towers replicated.
RECSYS_RULES: Mapping[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "rows": "model",
    "embed": None,
    "seq": None,
    "fields": None,
    "mlp": None,
    "candidates": ("pod", "data", "model"),  # retrieval: 1M candidates, full mesh
    "layers": None,
}

# GNN: nodes/edges partitioned over (pod, data); channels on model at
# ogb_products scale (set by the launcher via rule override).
GNN_RULES: Mapping[str, MeshAxes] = {
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    "graphs": ("pod", "data"),
    "feat": None,
    "channels": None,
    "irrep": None,
    "rbf": None,
    "layers": None,
    "batch": ("pod", "data"),
}

FAMILY_RULES = {"lm": LM_RULES, "recsys": RECSYS_RULES, "gnn": GNN_RULES}


class PartitionSpec(tuple):
    """A tensor's layout over a mesh, in `jax.sharding.PartitionSpec`'s form:
    one entry per leading tensor dim, each None (replicated), a mesh dim's
    name, or a tuple of names (sharded over them, major to minor); dims past
    the last entry are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A `DeviceMesh`'s dim names, or an `AbstractMesh`'s axis names."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def adapt_rules(rules: Mapping[str, MeshAxes], mesh) -> Mapping[str, MeshAxes]:
    """Drop mesh axes that don't exist on this mesh (e.g. 'pod' on 1-pod).
    Also threads the mesh itself under "__mesh__", as `repro` does; no
    module of the port reads it: `expert_parallel.moe_ffn_ep` takes the
    mesh as an argument and adapts `LM_RULES` to it itself."""
    names = set(mesh_axis_names(mesh))

    def fix(ax: MeshAxes) -> MeshAxes:
        if ax is None:
            return None
        if isinstance(ax, str):
            return ax if ax in names else None
        kept = tuple(a for a in ax if a in names)
        return kept if kept else None

    out = {k: fix(v) for k, v in rules.items()}
    out["__mesh__"] = mesh  # type: ignore[assignment]
    return out


def mesh_groups(mesh, axes) -> Tuple:
    """The process groups of the mesh dims `axes` (major to minor) that
    have more than one rank: those a sum over them crosses."""
    names = mesh_axis_names(mesh)
    return tuple(mesh.get_group(a) for a in axes if mesh.size(names.index(a)) > 1)


def axes_index(mesh, axes) -> Tuple[int, int]:
    """(this rank's block index, the number of blocks) along the mesh dims
    `axes` of a `DeviceMesh`, major to minor, as `block_slices` numbers the
    blocks of a dim that a spec entry of those dims splits."""
    names = mesh_axis_names(mesh)
    at = dict(zip(names, mesh.get_coordinate()))
    index, ways = 0, 1
    for a in axes:
        n = mesh.size(names.index(a))
        index, ways = index * n + at[a], ways * n
    return index, ways


def rule_groups(rules, name: str) -> Tuple:
    """`mesh_groups` of the mesh dims that rule `name` lays a tensor out
    over: the groups a reduction over that logical axis sums across. ()
    without a mesh in `rules` (or without rules)."""
    mesh = None if rules is None else rules.get("__mesh__")
    return () if mesh is None else mesh_groups(mesh, entry_axes(rules.get(name)))


def pspec(axes: Sequence[Optional[str]], rules: Mapping[str, MeshAxes]) -> PartitionSpec:
    """logical axes tuple -> PartitionSpec via the rule table."""
    out = []
    used: set = set()

    def dedup(ax: MeshAxes) -> MeshAxes:
        # a mesh axis may appear at most once in a PartitionSpec
        if ax is None:
            return None
        if isinstance(ax, str):
            return None if ax in used else (used.add(ax) or ax)
        kept = tuple(a for a in ax if a not in used)
        used.update(kept)
        if not kept:
            return None
        # canonical form: when dedup collapses the rule to its trailing
        # (minor-most) axis, emit the bare axis rather than a 1-tuple; a
        # surviving leading axis keeps the tuple so the spec still shows
        # where the rule was truncated
        if len(kept) == 1 and kept[0] == ax[-1]:
            return kept[0]
        return kept

    for name in axes:
        if name is None:
            out.append(None)
            continue
        if name not in rules:
            raise KeyError(f"no sharding rule for logical axis {name!r}")
        out.append(dedup(rules[name]))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh dims of a spec entry or rule, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: PartitionSpec, mesh):
    """The `DTensor` placements of `spec` on `mesh`, one per mesh dim: each
    mesh dim named in a tensor dim's entry shards that dim (`Shard(d)`),
    every other mesh dim replicates (`Replicate()`). A tuple entry shards
    its tensor dim over its mesh dims major to minor, which is the order a
    `DTensor` applies two `Shard`s of one tensor dim in: mesh-dim order. So
    a tuple's dims must come in the mesh's order (every rule table's do)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        order = [names.index(a) if a in names else -1 for a in entry_axes(entry)]
        if -1 in order:
            raise ValueError(f"spec {spec} names a dim the mesh {names} lacks")
        if order != sorted(order):
            raise ValueError(f"spec {spec}: a tuple entry's mesh dims must follow the "
                             f"mesh's order {names}")
        for m in order:
            if isinstance(out[m], Shard):
                raise ValueError(f"spec {spec} uses mesh dim {names[m]!r} twice")
            out[m] = Shard(d)
    return out


def spec_of(placements_, mesh) -> PartitionSpec:
    """The PartitionSpec of `DTensor` placements on `mesh` (the inverse of
    `placements`): each `Shard(d)` names its mesh dim in entry d, mesh dims
    in mesh order; a `Partial` placement has no spec."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    entries: dict = {}
    for name, p in zip(names, placements_):
        if isinstance(p, Shard):
            entries.setdefault(p.dim, []).append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} has no PartitionSpec")
    parts = [None] * (max(entries) + 1 if entries else 0)
    for d, axes in entries.items():
        parts[d] = axes[0] if len(axes) == 1 else tuple(axes)
    return P(*parts)


def _mesh_sizes(mesh) -> Mapping[str, int]:
    return dict(zip(mesh_axis_names(mesh), tuple(mesh.shape)))


def block_slices(shape, spec: PartitionSpec, mesh, coordinate) -> Tuple[slice, ...]:
    """The block of a tensor of `shape` laid out by `spec` that the rank at
    mesh `coordinate` (one index per mesh dim) holds: `jax`'s
    `devices_indices_map` entry for that device. Refuses a dim that its mesh
    dims do not divide, as `jit`'s `in_shardings` do: nothing is padded."""
    sizes = _mesh_sizes(mesh)
    at = dict(zip(mesh_axis_names(mesh), coordinate))
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)} has dims")
    out = []
    for d, n in enumerate(shape):
        axes = entry_axes(spec[d]) if d < len(spec) else ()
        ways = math.prod(sizes[a] for a in axes)
        if n % ways:
            raise ValueError(f"dim {d} of shape {tuple(shape)} is not divisible by the "
                             f"{ways} ways of {spec[d]!r} ({spec})")
        index = 0
        for a in axes:  # major to minor
            index = index * sizes[a] + at[a]
        step = n // ways
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute_one(t: torch.Tensor, spec: PartitionSpec, mesh):
    """`t`, whole on every rank, as a `DTensor` laid out on `mesh` by `spec`:
    this rank keeps its block (`block_slices`) on the mesh's device, and no
    bytes move between ranks."""
    from torch.distributed.tensor import DTensor

    block = block_slices(t.shape, spec, mesh, mesh.get_coordinate())
    local = t[block].to(_mesh_device(mesh)).contiguous()
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def distribute(tree, specs, mesh):
    """A nested dict of tensors, each whole on every rank, -> the same tree
    of `DTensor`s laid out on `mesh` by `specs` (a matching tree of
    PartitionSpecs; `distribute_one` each). Refuses a dim that the mesh
    dims do not divide, as `jit`'s `in_shardings` do."""
    from repro_torch.models.common import tree_map  # common imports this module

    return tree_map(lambda t, spec: distribute_one(t, spec, mesh), tree, specs)


def constrain(x, axes: Sequence[Optional[str]], rules):
    """`with_sharding_constraint` by logical axes: a `DTensor` is
    redistributed to the spec's placements on its own mesh; a plain tensor
    (one that no mesh lays out) comes back as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(pspec(axes, rules), x.device_mesh))


def _is_axes(x) -> bool:
    return (isinstance(x, tuple) and not _is_spec(x)
            and all(isinstance(a, (str, type(None))) for a in x))


def tree_pspecs(axes_tree, rules):
    """Map a nested dict of logical-axes tuples to PartitionSpecs."""
    if _is_axes(axes_tree):
        return pspec(axes_tree, rules)
    return {k: tree_pspecs(v, rules) for k, v in axes_tree.items()}
