"""NequIP [arXiv:2101.03164] — E(3)-equivariant message passing (port of
`repro.models.gnn.nequip`).

Per interaction layer, per edge (j -> i):
  Y_l(r̂_ij)            spherical harmonics of the edge direction
  R(|r_ij|)            radial MLP on an RBF expansion x cutoff envelope,
                       emitting one weight per (coupling path x channel)
  m_ij^{l_out}         = Σ_paths w_path ⊙ CG(feat_j^{l_in} ⊗ Y^{l_sh})
  agg_i                = segment_sum over incoming edges
  feat_i               = gate( self_interact(feat_i) + agg_i )

Layers run as a Python loop over the stacked `[L, ...]` leaves of
`params["layers"]` (`repro`'s `lax.scan`; the tree keeps `repro`'s layout,
so a checkpoint crosses between the packages), each under
`torch.utils.checkpoint` when `cfg.remat` is set (`repro`'s
`jax.checkpoint`). Graphs batch by flattening with graph ids.

Every sum over edges or nodes adds its terms in one fixed order, on either
device and in every run: `gather` (`jnp.take`) and `scatter_sum`
(`jax.ops.segment_sum`) are autograd Functions whose reduce, forward or
backward, is `kernels/embedding_bag/ops.segment_sum` (a stable sort and
`segment_reduce`, never CUDA's atomic `index_add_`), over the edge
grouping `segments` computes once a forward. The species lookup runs the
`embedding_bag` kernel at one id a bag (exact), whose table gradient is
that same reduce. Divisions by a constant multiply by its f32 reciprocal,
as XLA rewrites them, so `radial_basis` is `repro`'s bits.

Across ranks (`rules` of a `DeviceMesh` whose "nodes" rule splits the
nodes over more than one rank), each rank holds its block of the nodes
(positions, species or features, labels, masks, graph ids) under
`rules["nodes"]` and its block of the edges under `rules["edges"]`, the
same mesh dims, where `repro`'s GSPMD pins them (`constrain`). Edge ids
stay global node ids, and `segments` groups the rank's edges over all N
nodes. The two node-indexed operations become collectives with their
transposes as backward (`_Split`): `gather` all-gathers the node blocks
(`collectives.gather_spec`) and then takes the rank's edges, its
backward the fixed-order reduce into all N rows and a reduce-scatter
back to the block; `scatter_sum` reduces the rank's edges into all N
rows and reduce-scatters them to the block, its backward an all-gather
and a take. The positions are gathered once a forward; under
`hoist_gathers` each layer gathers once per l, else once per coupling
path, as `repro`'s. The losses are global means over the whole graph:
sums over the node dims (`collectives.psum`), which every rank then
holds alike. Mesh dims that the nodes' rule leaves out ("model" under
plain `GNN_RULES`) hold copies of the same blocks, so nothing is summed
over them. Each rank's backward forms its nodes' part of every
parameter's gradient; the train step sums the parts over the node dims
(`launch/cells._gnn_cell`). Without rules, or where the node dims have
one rank, the path is the one-rank one, to the bit.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.distributed.collectives import gather_spec, psum, reduce_scatter
from repro_torch.distributed.sharding import P, axes_index, entry_axes, mesh_groups
from repro_torch.kernels.embedding_bag.ops import Segments, embedding_bag_op, segment_sum, segments
from repro_torch.models.common import ParamDef
from repro_torch.models.gnn.irreps import DIM, N_PATHS, path_list, spherical_harmonics
from repro_torch.models.layers import jnp_linspace

RAD_HIDDEN = 32


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def param_defs(cfg: GNNConfig, d_feat: Optional[int] = None, n_classes: int = 1) -> Dict:
    C, L, R = cfg.d_hidden, cfg.n_layers, cfg.n_rbf
    defs: Dict = {}
    if d_feat:  # Cora/products-style continuous node features -> scalars
        defs["feat_proj"] = ParamDef((d_feat, C), torch.float32, "fan_in", axes=(None, None))
    else:
        defs["species"] = ParamDef((cfg.n_species, C), torch.float32, "embed", axes=(None, None))
    defs["layers"] = {
        "rad_w1": ParamDef((L, R, RAD_HIDDEN), torch.float32, "fan_in",
                           axes=("layers", "rbf", None)),
        "rad_b1": ParamDef((L, RAD_HIDDEN), torch.float32, "zeros", axes=("layers", None)),
        "rad_w2": ParamDef((L, RAD_HIDDEN, N_PATHS * C), torch.float32, "fan_in",
                           axes=("layers", None, None)),
        # per-l self interactions (channel mixing) + residual weight
        "self_0": ParamDef((L, C, C), torch.float32, "fan_in", axes=("layers", None, None)),
        "self_1": ParamDef((L, C, C), torch.float32, "fan_in", axes=("layers", None, None)),
        "self_2": ParamDef((L, C, C), torch.float32, "fan_in", axes=("layers", None, None)),
        # gates for l=1,2 from scalar channels
        "gate_w": ParamDef((L, C, 2 * C), torch.float32, "fan_in", axes=("layers", None, None)),
        "gate_b": ParamDef((L, 2 * C), torch.float32, "zeros", axes=("layers", None)),
    }
    defs["out_w1"] = ParamDef((C, C), torch.float32, "fan_in", axes=(None, None))
    defs["out_b1"] = ParamDef((C,), torch.float32, "zeros", axes=(None,))
    defs["out_w2"] = ParamDef((C, n_classes), torch.float32, "fan_in", axes=(None, None))
    defs["out_b2"] = ParamDef((n_classes,), torch.float32, "zeros", axes=(None,))
    return defs


# ---------------------------------------------------------------------------
# Fixed-order gather and segment sum
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return x.index_select(0, seg.ids)

    @staticmethod
    def backward(ctx, dy):
        return segment_sum(dy, ctx.seg), None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, seg):
        ctx.seg = seg
        return segment_sum(rows, seg)

    @staticmethod
    def backward(ctx, dy):
        return dy.index_select(0, ctx.seg.ids), None


class _Split(NamedTuple):
    """How the nodes lie across ranks: `mesh` and the mesh dims of the
    nodes' rule (major to minor), `groups` the process groups of those
    dims that have more than one rank, `ways` the number of node blocks."""
    mesh: object
    axes: Tuple[str, ...]
    groups: Tuple
    ways: int

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The node blocks of every rank along dim 0, in block order: a
        tiled all-gather, its backward the reduce-scatter."""
        return gather_spec(x, P(self.axes), self.mesh)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the node dims of x [N, ...], of which this rank
        keeps its node block: `whole`'s transpose (the major dim first, so
        that it ends outermost)."""
        for g in self.groups:
            x = reduce_scatter(x, 0, g)
        return x


def _split(rules) -> Optional[_Split]:
    """The nodes' split under `rules`, or None where the node dims have one
    rank (no rules, no mesh, or copies only): the one-rank path."""
    mesh = None if rules is None else rules.get("__mesh__")
    if mesh is None:
        return None
    axes = entry_axes(rules.get("nodes"))
    groups = mesh_groups(mesh, axes)
    if not groups:
        return None
    if entry_axes(rules.get("edges")) != axes:
        raise ValueError(f"the edges' rule {rules.get('edges')!r} must split them over the "
                         f"nodes' mesh dims {rules.get('nodes')!r}: a rank's messages are "
                         "summed over the node dims")
    return _Split(mesh, axes, groups, axes_index(mesh, axes)[1])


def gather(x: torch.Tensor, seg: Segments, split: Optional[_Split] = None) -> torch.Tensor:
    """`jnp.take(x, ids, axis=0)`: x [n, ...] -> [M, ...]; its gradient sums
    each row's terms in the order of M (`segment_sum`). Under `split`, x is
    this rank's node block and the ids are global: the blocks are
    all-gathered first, and the gradient reduce-scattered back."""
    return _Gather.apply(x if split is None else split.whole(x), seg)


def scatter_sum(rows: torch.Tensor, seg: Segments, split: Optional[_Split] = None
                ) -> torch.Tensor:
    """`jax.ops.segment_sum(rows, ids, n)`: rows [M, ...] -> [n, ...], each
    row's terms added in the order of M; its gradient is a gather. Under
    `split`, the rank's rows are summed into all n rows, and the ranks'
    sums reduce-scattered to this rank's node block."""
    out = _ScatterSum.apply(rows, seg)
    return out if split is None else split.block(out)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def _recip(x: float) -> float:
    """fl(1 / x) in f32: XLA turns a division by a constant into a product."""
    return float(np.float32(1.0) / np.float32(x))


def radial_basis(dist: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    """Gaussian RBF x smooth cosine cutoff. dist: [E] -> [E, n_rbf]."""
    mu = jnp_linspace(cfg.cutoff, cfg.n_rbf, dist.device)
    gamma = cfg.n_rbf / cfg.cutoff
    rbf = torch.exp(-gamma * torch.square(dist[:, None] - mu[None]))
    fc = 0.5 * (torch.cos(math.pi * torch.clamp(dist * _recip(cfg.cutoff), 0, 1)) + 1.0)
    return rbf * fc[:, None]


def interaction_layer(feats, lp, src: Segments, dst: Segments, sh, rbf, cfg: GNNConfig,
                      split: Optional[_Split] = None):
    """One NequIP interaction. feats: {l: [N,C,2l+1]}; lp: this layer's
    params; `src` / `dst`: the edges grouped by source and by destination
    (over all nodes); `split`: the nodes across ranks (feats the rank's
    block), or None."""
    C = cfg.d_hidden
    # radial MLP -> per-edge path weights [E, n_paths, C]
    h = F.silu(rbf @ lp["rad_w1"] + lp["rad_b1"])
    w = (h @ lp["rad_w2"]).reshape(-1, N_PATHS, C)

    # messages: gather source features, couple with SH, weight, accumulate
    gathered = {}
    if cfg.hoist_gathers:
        # one [E,C,d] gather per l (3 total) instead of one per coupling path (15)
        for l in range(cfg.l_max + 1):
            gathered[l] = gather(feats[l], src, split)

    msgs = {l: 0.0 for l in range(cfg.l_max + 1)}
    for p_idx, (lf, ls, lo, fn) in enumerate(path_list()):
        if lf > cfg.l_max or ls > cfg.l_max or lo > cfg.l_max:
            continue
        src_feat = gathered.get(lf)
        if src_feat is None:
            src_feat = gather(feats[lf], src, split)  # [E,C,2lf+1]
        y = sh[ls][:, None, :]  # [E,1,2ls+1]
        coupled = fn(src_feat, y)  # [E,C,2lo+1]
        msgs[lo] = msgs[lo] + coupled * w[:, p_idx, :, None]

    new = {}
    for l in range(cfg.l_max + 1):
        agg = scatter_sum(msgs[l], dst, split)
        mixed = torch.einsum("ncd,ce->ned", feats[l], lp[f"self_{l}"])
        new[l] = mixed + agg

    # gate nonlinearity
    s = new[0][..., 0]  # [N,C]
    gates = torch.sigmoid(s @ lp["gate_w"] + lp["gate_b"])  # [N,2C]
    out = {0: F.silu(s)[..., None]}
    if cfg.l_max >= 1:
        out[1] = new[1] * gates[:, :C, None]
    if cfg.l_max >= 2:
        out[2] = new[2] * gates[:, C:, None]
    # residual
    return {l: out[l] + feats[l] for l in out}


# ---------------------------------------------------------------------------
# Forward / losses
# ---------------------------------------------------------------------------


def forward(params, graph, cfg: GNNConfig, rules=None) -> torch.Tensor:
    """graph: {positions [N,3], edge_src [E], edge_dst [E],
    species [N] | features [N,d_feat], (edge_mask [E], node_mask [N])}.
    Returns per-node output [N, n_out]. Across the ranks of `rules` (see
    the module's docstring) each is this rank's block and so is the
    output."""
    split = _split(rules)
    pos = graph["positions"]
    n_nodes = pos.shape[0]
    n_all = n_nodes if split is None else n_nodes * split.ways
    src = segments(graph["edge_src"], n_all)
    dst = segments(graph["edge_dst"], n_all)

    pos_all = pos if split is None else split.whole(pos)
    r = gather(pos_all, src) - gather(pos_all, dst)  # j -> i
    dist = torch.sqrt(torch.sum(torch.square(r + 1e-12), dim=-1))
    sh = spherical_harmonics(r)
    if "edge_mask" in graph:
        m = graph["edge_mask"][:, None].to(pos.dtype)
        sh = {l: y * m for l, y in sh.items()}
    rbf = radial_basis(dist, cfg)

    C = cfg.d_hidden
    if "features" in graph:
        s0 = graph["features"] @ params["feat_proj"]
    else:
        s0 = embedding_bag_op(params["species"], graph["species"].to(torch.int32).reshape(-1, 1))
    feats = {0: s0[..., None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = torch.zeros((n_nodes, C, DIM[l]), dtype=s0.dtype, device=s0.device)

    def body(feats, lp):
        return interaction_layer(feats, lp, src, dst, sh, rbf, cfg, split)

    layers = params["layers"]
    for i in range(next(iter(layers.values())).shape[0]):
        lp = {k: v[i] for k, v in layers.items()}
        feats = checkpoint(body, feats, lp, use_reentrant=False) if cfg.remat else body(feats, lp)

    s = feats[0][..., 0]
    h = F.silu(s @ params["out_w1"] + params["out_b1"])
    return h @ params["out_w2"] + params["out_b2"]


def node_class_loss(params, batch, cfg: GNNConfig, rules=None):
    """Full-batch / sampled node classification (Cora, Reddit, products).
    Across ranks: the mean over the whole graph's (labelled) nodes, each
    rank's sums added over the node dims."""
    split = _split(rules)
    out = forward(params, batch, cfg, rules)  # [N, n_classes]
    labels = batch["labels"]
    mask = batch.get("label_mask")
    logp = F.log_softmax(out.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.to(torch.int64)[:, None])[:, 0]
    if mask is not None:
        nll = torch.where(mask, nll, 0.0)
    if split is None:
        loss = torch.mean(nll) if mask is None else \
            torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
    else:
        count = float(nll.shape[0] * split.ways) if mask is None else \
            torch.clamp(psum(torch.sum(mask.to(nll.dtype)), split.groups), min=1)
        loss = psum(torch.sum(nll), split.groups) / count
    return loss, {"nll": loss}


def energy_loss(params, batch, cfg: GNNConfig, rules=None):
    """Batched molecular energy regression: per-node contributions summed
    per graph (a fixed-order segment sum over graph ids). Across ranks:
    each rank's nodes give a partial sum of every graph, added over the
    node dims; `energies`, this rank's block under `rules["batch"]`, are
    gathered whole, and the mean runs over all graphs."""
    split = _split(rules)
    out = forward(params, batch, cfg, rules)[:, 0]  # [N]
    if "node_mask" in batch:
        out = torch.where(batch["node_mask"], out, 0.0)
    energies = batch["energies"]
    if split is not None:
        energies = gather_spec(energies, P(rules.get("batch")), split.mesh)
    e = scatter_sum(out, segments(batch["graph_ids"], energies.shape[0]))
    if split is not None:
        e = psum(e, split.groups)
    loss = torch.mean(torch.square(e - energies))
    return loss, {"mse": loss}
