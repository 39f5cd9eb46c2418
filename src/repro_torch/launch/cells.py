"""Dry-run cell builder: (arch x shape x mesh) -> (fn, abstract args, specs)
(port of `repro.launch.cells`).

Every one of the 40 assigned cells is built here from "meta" tensors
(`models/common.abstract_params`, `training/optimizer.abstract_state`):
shapes and dtypes, no storage. Its specs are the port's `PartitionSpec`
trees on the mesh it is built on, a `launch/mesh.AbstractMesh` (the
production meshes, for specs and sizes) or a `DeviceMesh` (to run `fn`).
Nothing is compiled and no flops are counted here.

`fn` takes this rank's blocks of `args` under `in_specs` and gives its
blocks of the outputs under `out_specs`, as `repro`'s `jit` with
`in_shardings` / `out_shardings` computes them. A recsys cell's `fn` runs
across the ranks of a `DeviceMesh` (the row-split lookup, the global-batch
loss, the train step's sums), and so does an LM cell's (the transformer
split by `rules`: FSDP weights and context-parallel attention in the
train step and prefill, tensor parallelism and split-K attention in
decode; `train_layout="tp"`'s Megatron products, `int8_serve`'s int8
blocks and `moe_impl="gspmd"`'s whole-batch dispatch too:
`models/transformer`'s docstring), and so does a GNN cell's (NequIP split by nodes and edges over the node dims:
`models/gnn/nequip`'s docstring). The long-context decode layout (batch 1,
the cache split over "long_kv_seq") is the long_500k shape's, or any
decode of 100,000 positions or more, as in `repro`; a `shape=` named
"long_500k" takes it at any size.

Beyond `repro`'s `build_cell`: `cfg=` takes a config in place of
`get_config(arch, **overrides)` (a reduced one, or one with the C2
window), and `shape=` a shape in place of the registry's (the same kind
at another size), so that a cell also runs at sizes a test or one card
holds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ARCH_NAMES, GNNConfig, LMConfig, RecSysConfig, get_config
from repro_torch.configs.shapes import FAMILY_SHAPES, GNNShape, LMShape, RecSysShape
from repro_torch.distributed.sharding import FAMILY_RULES, P, adapt_rules, mesh_axis_names, pspec
from repro_torch.models import transformer as tf
from repro_torch.models.common import ParamDef, abstract_params, is_def, param_pspecs
from repro_torch.models.gnn import nequip
from repro_torch.models.gnn.sampler import subgraph_sizes
from repro_torch.models.recsys import api as rec_api
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import make_train_step


class Cell(NamedTuple):
    name: str
    fn: Any  # the step function, on this rank's blocks
    args: Tuple  # trees of "meta" tensors
    in_specs: Tuple  # PartitionSpec trees, one per arg
    out_specs: Any
    meta: Dict  # model flops info etc.
    donate: Tuple = ()  # argnums donated (train: params+opt_state alias in place)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_cell(cfg: LMConfig, shape: LMShape, mesh, rules, optimizer: str,
             accum: int = 1) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    defs = tf.param_defs(cfg)

    if shape.kind == "train":
        params = abstract_params(defs)
        if cfg.train_layout == "tp":
            # Megatron-TP weights (serve layout) during training: no
            # per-layer weight all-gathers; activations batch-sharded only
            rules = {**rules, "seq": None}
            p_specs = param_pspecs(defs, rules, serve=True)
        else:
            p_specs = param_pspecs(defs, rules, serve=False)
        opt = opt_lib.get_optimizer(optimizer)
        opt_state = opt_lib.abstract_state(optimizer, params)
        o_specs = opt_lib.state_pspecs(optimizer, p_specs, params)
        batch = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
        b_specs = {k: pspec(("batch", "seq"), rules) for k in batch}

        step = make_train_step(lambda p, b: tf.loss(p, b, cfg, rules), opt, grad_accum=accum,
                               rules=rules, param_specs=p_specs, whole_grads=True)
        metric_specs = {"ce": P(), "aux": P(), "grad_norm": P(), "loss": P()}
        return Cell(
            name=f"{cfg.name}:{shape.name}",
            fn=step,
            args=(params, opt_state, batch),
            in_specs=(p_specs, o_specs, b_specs),
            out_specs=(p_specs, o_specs, metric_specs),
            meta={"tokens": B * S, "kind": "train"},
            donate=(0, 1),
        )

    if cfg.int8_serve:
        defs = tf.int8_param_defs(defs)
    params = abstract_params(defs)
    p_specs = param_pspecs(defs, rules, serve=True)

    if shape.kind == "prefill":
        tokens = _meta((B, S), torch.int32)
        t_spec = pspec(("batch", "seq"), rules)
        cache_spec = pspec(tf.cache_axes(cfg, long_context=False), rules)

        return Cell(
            name=f"{cfg.name}:{shape.name}",
            fn=lambda p, t: tf.prefill(p, t, cfg, rules=rules),
            args=(params, tokens),
            in_specs=(p_specs, t_spec),
            out_specs=(pspec(("batch", None), rules), (cache_spec, cache_spec)),
            meta={"tokens": B * S, "kind": "prefill"},
        )

    assert shape.kind == "decode"
    long_ctx = S >= 100_000 or shape.name == "long_500k"
    if long_ctx:
        # batch=1: batch axes cannot shard; all parallelism goes to the
        # KV sequence (split-K decode over (data, model)).
        rules = {**rules, "batch": None}
    cshape = tf.cache_shape(cfg, B, S)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    cache = (_meta(cshape, dt), _meta(cshape, dt))
    c_spec = pspec(tf.cache_axes(cfg, long_context=long_ctx), rules)

    return Cell(
        name=f"{cfg.name}:{shape.name}",
        fn=lambda p, c, t, q: tf.decode(p, c, t, q, cfg, rules=rules),
        args=(params, cache, _meta((B,), torch.int32), _meta((B,), torch.int32)),
        in_specs=(p_specs, (c_spec, c_spec), pspec(("batch",), rules), pspec(("batch",), rules)),
        out_specs=(pspec(("batch", None), rules), (c_spec, c_spec)),
        meta={"tokens": B, "kind": "decode", "kv_len": S},
        donate=(1,),
    )


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _rec_batch_specs(cfg: RecSysConfig, B: int, rules, with_label=True):
    if cfg.interaction in ("fm", "self_attn"):
        batch = {"sparse_idx": _meta((B, len(cfg.fields)), torch.int32)}
        specs = {"sparse_idx": pspec(("batch", None), rules)}
    else:
        L = cfg.seq_len
        batch = {
            "user": _meta((B,), torch.int32),
            "item": _meta((B,), torch.int32),
            "category": _meta((B,), torch.int32),
            "hist_item": _meta((B, L), torch.int32),
            "hist_category": _meta((B, L), torch.int32),
            "hist_len": _meta((B,), torch.int32),
        }
        specs = {k: pspec(("batch",) + (None,) * (v.dim() - 1), rules) for k, v in batch.items()}
    if with_label:
        batch["label"] = _meta((B,), torch.float32)
        specs["label"] = pspec(("batch",), rules)
    return batch, specs


def _full_mesh_axes(mesh):
    names = mesh_axis_names(mesh)
    return tuple(a for a in ("pod", "data", "model") if a in names)


def _quantize_table_defs(defs):
    """C5: re-declare row-sharded tables as int8 + per-row scales (the
    abstract-params analogue of core/quantization.quantize_table)."""

    def visit(d):
        if not is_def(d):
            return {k: visit(v) for k, v in d.items()}
        if len(d.shape) == 2 and d.axes and d.axes[0] == "rows":
            return {
                "q": ParamDef(d.shape, torch.int8, "zeros", axes=d.axes),
                "s": ParamDef((d.shape[0],), torch.float32, "ones", axes=(d.axes[0],)),
            }
        return d

    return visit(defs)


def _pad512(n: int) -> int:
    """Natural sizes rarely divide the mesh; inputs are padded (models
    honour edge_mask / node_mask / label_mask; retrieval's padded
    candidates score ids that the caller discards)."""
    return -(-n // 512) * 512


def _rec_cell(cfg: RecSysConfig, shape: RecSysShape, mesh, rules, optimizer: str) -> Cell:
    if cfg.serve_full_mesh and shape.kind == "serve":
        rules = {**rules, "batch": _full_mesh_axes(mesh)}
    defs = rec_api.param_defs(cfg)
    if cfg.quantized:
        defs = _quantize_table_defs(defs)
    params = abstract_params(defs)
    p_specs = param_pspecs(defs, rules)

    if shape.kind == "train":
        opt = opt_lib.get_optimizer(optimizer)
        opt_state = opt_lib.abstract_state(optimizer, params)
        o_specs = opt_lib.state_pspecs(optimizer, p_specs, params)
        batch, b_specs = _rec_batch_specs(cfg, shape.batch, rules)
        step = make_train_step(lambda p, b: rec_api.loss(p, b, cfg, rules), opt,
                               rules=rules, param_specs=p_specs)
        metric_specs = {"bce": P(), "grad_norm": P(), "loss": P()}
        return Cell(
            name=f"{cfg.name}:{shape.name}",
            fn=step,
            args=(params, opt_state, batch),
            in_specs=(p_specs, o_specs, b_specs),
            out_specs=(p_specs, o_specs, metric_specs),
            meta={"examples": shape.batch, "kind": "train"},
            donate=(0, 1),
        )

    if shape.kind == "serve":
        batch, b_specs = _rec_batch_specs(cfg, shape.batch, rules, with_label=False)
        return Cell(
            name=f"{cfg.name}:{shape.name}",
            fn=lambda p, b: rec_api.serve(p, b, cfg, rules),
            args=(params, batch),
            in_specs=(p_specs, b_specs),
            out_specs=pspec(("batch",), rules),
            meta={"examples": shape.batch, "kind": "serve"},
        )

    assert shape.kind == "retrieval"
    # candidate axis shards over the full mesh -> pad to a multiple of 512
    N = _pad512(shape.n_candidates)
    # single-query scoring: the query batch (B=1) cannot shard; all
    # parallelism goes to the candidate axis.
    rules = {**rules, "batch": None}
    query, q_specs = _rec_batch_specs(cfg, 1, rules, with_label=False)
    if cfg.interaction not in ("fm", "self_attn"):
        query["cand_category"] = _meta((N,), torch.int32)
        q_specs["cand_category"] = pspec(("candidates",), rules)
    return Cell(
        name=f"{cfg.name}:{shape.name}",
        fn=lambda p, q, c: rec_api.retrieval(p, q, c, cfg, rules),
        args=(params, query, _meta((N,), torch.int32)),
        in_specs=(p_specs, q_specs, pspec(("candidates",), rules)),
        out_specs=pspec(("candidates",), rules),
        meta={"examples": N, "kind": "retrieval"},
    )


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

_GNN_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47, "molecule": 1}


def _gnn_cell(cfg: GNNConfig, shape: GNNShape, mesh, rules, optimizer: str) -> Cell:
    if cfg.full_mesh_graph:
        full = _full_mesh_axes(mesh)
        rules = {**rules, "nodes": full, "edges": full}
    n_classes = _GNN_CLASSES[shape.name]

    if shape.kind == "minibatch":
        n_nodes, n_edges = subgraph_sizes(shape.batch_nodes, shape.fanout)
    elif shape.kind == "batched_small":
        n_nodes = shape.n_nodes * shape.graph_batch
        n_edges = shape.n_edges * shape.graph_batch
    else:
        n_nodes, n_edges = shape.n_nodes, shape.n_edges
    n_nodes, n_edges = _pad512(n_nodes), _pad512(n_edges)

    defs = nequip.param_defs(cfg, d_feat=shape.d_feat, n_classes=n_classes)
    params = abstract_params(defs)
    p_specs = param_pspecs(defs, rules)

    graph: Dict[str, Any] = {
        "positions": _meta((n_nodes, 3), torch.float32),
        "edge_src": _meta((n_edges,), torch.int32),
        "edge_dst": _meta((n_edges,), torch.int32),
    }
    g_specs: Dict[str, P] = {
        "positions": pspec(("nodes", None), rules),
        "edge_src": pspec(("edges",), rules),
        "edge_dst": pspec(("edges",), rules),
    }
    if shape.d_feat:
        graph["features"] = _meta((n_nodes, shape.d_feat), torch.float32)
        g_specs["features"] = pspec(("nodes", None), rules)
    else:
        graph["species"] = _meta((n_nodes,), torch.int32)
        g_specs["species"] = pspec(("nodes",), rules)

    graph["edge_mask"] = _meta((n_edges,), torch.bool)
    g_specs["edge_mask"] = pspec(("edges",), rules)
    if shape.kind == "batched_small":
        graph["graph_ids"] = _meta((n_nodes,), torch.int32)
        graph["energies"] = _meta((shape.graph_batch,), torch.float32)
        graph["node_mask"] = _meta((n_nodes,), torch.bool)
        g_specs["graph_ids"] = pspec(("nodes",), rules)
        g_specs["energies"] = pspec(("batch",), rules)
        g_specs["node_mask"] = pspec(("nodes",), rules)
        loss, metric_names = nequip.energy_loss, ("mse",)
    else:
        graph["labels"] = _meta((n_nodes,), torch.int32)
        g_specs["labels"] = pspec(("nodes",), rules)
        graph["label_mask"] = _meta((n_nodes,), torch.bool)
        g_specs["label_mask"] = pspec(("nodes",), rules)
        loss, metric_names = nequip.node_class_loss, ("nll",)

    # each rank's backward forms its nodes' part of every gradient: the
    # step sums the parts over the node dims (under full_mesh_graph
    # "model" too; under plain GNN_RULES "model" holds copies, not parts)
    step_rules = {**rules, "batch": rules["nodes"]}
    opt = opt_lib.get_optimizer(optimizer)
    opt_state = opt_lib.abstract_state(optimizer, params)
    o_specs = opt_lib.state_pspecs(optimizer, p_specs, params)
    metric_specs = {m: P() for m in metric_names}
    metric_specs.update({"grad_norm": P(), "loss": P()})
    return Cell(
        name=f"{cfg.name}:{shape.name}",
        fn=make_train_step(lambda p, b: loss(p, b, cfg, rules), opt, rules=step_rules,
                           param_specs=p_specs),
        args=(params, opt_state, graph),
        in_specs=(p_specs, o_specs, g_specs),
        out_specs=(p_specs, o_specs, metric_specs),
        meta={"nodes": n_nodes, "edges": n_edges, "kind": "train"},
        donate=(0, 1),
    )


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    *,
    optimizer: str = "adamw",
    overrides: Optional[Dict] = None,
    accum: int = 1,
    cfg=None,
    shape=None,
) -> Cell:
    """The cell of `arch` at the shape `shape_name` on `mesh`. `cfg` (a
    config of `arch`'s family) replaces `get_config(arch, **overrides)`;
    `shape` (a shape of the same kind) replaces the registry's."""
    if cfg is None:
        cfg = get_config(arch, **(overrides or {}))
    family = cfg.family
    rules = adapt_rules(FAMILY_RULES[family], mesh)
    registered = FAMILY_SHAPES[family][shape_name]
    if shape is not None and shape.kind != registered.kind:
        raise ValueError(f"shape {shape} is not of {shape_name}'s kind {registered.kind!r}")
    shape = shape or registered

    if family == "lm":
        # long_500k runs the paper's C2 sparse attention
        if shape_name == "long_500k" and not (overrides or {}).get("sparse_attention") is False:
            cfg = dataclasses.replace(cfg, sparse_attention=True)
        return _lm_cell(cfg, shape, mesh, rules, optimizer, accum=accum)
    if family == "recsys":
        return _rec_cell(cfg, shape, mesh, rules, optimizer)
    if family == "gnn":
        return _gnn_cell(cfg, shape, mesh, rules, optimizer)
    raise ValueError(family)


def all_cells():
    """The 40 assigned (arch, shape) names."""
    out = []
    for arch in ARCH_NAMES:
        if arch == "taobao_ssa":
            continue  # the paper's own model is extra, not one of the 40
        fam = get_config(arch).family
        for shape_name in FAMILY_SHAPES[fam]:
            out.append((arch, shape_name))
    return out
