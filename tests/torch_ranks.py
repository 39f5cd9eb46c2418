"""gloo ranks on the CPU for the port's multi-rank tests.

`run_ranks(fn, world, tmp_path, *args)` starts `world` processes with
`torch.multiprocessing` (the spawn method), each of which joins a gloo
process group through a file under `tmp_path` (no port is fixed: six
pytest-xdist workers share the machine), calls `fn(rank, world, *args)`,
and saves what it returns. It gives back the ranks' results in rank order,
or raises the first rank's error, or kills them all past `timeout`.

The rank bodies live here too, so that a spawned rank imports torch and
`repro_torch` only: nothing of JAX or `repro`.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _entry(rank, world, init_file, out_dir, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = TIMEOUT_S):
    run_dir = Path(tmp_path) / f"ranks_{fn.__name__}_{time.monotonic_ns()}"
    run_dir.mkdir(parents=True)
    ctx = mp.start_processes(_entry, args=(world, str(run_dir / "init"), str(run_dir), fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.05, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [torch.load(run_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


class Reference:
    """A `repro` script run in a subprocess on `n_devices` forced CPU
    devices (`XLA_FLAGS`, which the pytest process never sets), started
    before the ranks so that the two run at once. `wait()` gives its
    standard output; past `timeout` (`TIMEOUT_S`) from its start it is
    killed."""

    def __init__(self, script: str, args, n_devices: int, xla_flags: str = "",
                 timeout: float = TIMEOUT_S):
        repo = Path(__file__).resolve().parents[1]
        env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(repo / "src"),
               "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", "/tmp"),
               "XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices} {xla_flags}"}
        self.deadline = time.monotonic() + timeout
        self.proc = subprocess.Popen([sys.executable, "-c", script, *map(str, args)], env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait(self) -> str:
        try:
            out, err = self.proc.communicate(timeout=max(0.1, self.deadline - time.monotonic()))
        finally:
            self.kill()
        assert self.proc.returncode == 0, err
        return out

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def to_numpy(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------


def ep_rank(rank, world, mesh_shape, cases, coef):
    """`moe_ffn_ep` on this rank's blocks of each case's global inputs
    (`cases`: (cfg kwargs, params, x, cotangent) in numpy), then the
    backward of Σ out·cotangent + coef·aux/n. Returns, per case, this
    rank's mesh coordinate, out block, aux, drop counts and gradients."""
    from repro_torch.configs.base import LMConfig
    from repro_torch.distributed import expert_parallel as ep
    from repro_torch.distributed.sharding import LM_RULES, adapt_rules, block_slices
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    coord = tuple(mesh.get_coordinate())
    x_spec, specs = None, None
    results = []
    for kw, params, x, cot in cases:
        cfg = LMConfig(**kw)
        x_spec, specs = ep.ep_specs(adapt_rules(LM_RULES, mesh), "shared_gate" in params)
        blk = lambda a, spec: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a[block_slices(a.shape, spec, mesh, coord)]))
        lp = {k: blk(v, specs[k]).requires_grad_() for k, v in params.items()}
        xl = blk(x, x_spec).requires_grad_()
        stats = {}
        out, aux = ep.moe_ffn_ep(xl, lp, cfg, stats, mesh=mesh)
        loss = torch.sum(out * blk(cot, x_spec)) + coef * aux / world
        loss.backward()
        results.append({
            "coord": coord, "out": to_numpy(out), "aux": float(aux.detach()),
            "dropped_pair": int(stats["dropped_pair"][0]),
            "dropped_expert": int(stats["dropped_expert"][0]),
            "grads": {"x": to_numpy(xl.grad), **{k: to_numpy(v.grad) for k, v in lp.items()}},
        })
    return results


def compression_rank(rank, world, grads, steps):
    """`steps` error-feedback steps of `make_compressed_allreduce` over the
    world group; `grads[t][name]` holds every rank's gradient [world, ...]
    of step t. Returns, per step, this rank's means and residuals, its codes
    and the codes' all-reduced sum."""
    import torch.distributed as dist

    from repro_torch.distributed import grad_compression as gc

    group = dist.group.WORLD
    mine = lambda t: {k: torch.from_numpy(v[rank]) for k, v in grads[t].items()}  # noqa: E731
    fn = gc.make_compressed_allreduce(group)
    res = gc.init_residuals(mine(0))
    out = []
    for t in range(steps):
        g = mine(t)
        codes = {k: gc._q(g[k] + res[k])[0] for k in g}
        sums = {k: c.clone() for k, c in codes.items()}
        for c in sums.values():
            dist.all_reduce(c, group=group)
        means, res = fn(g, res)
        out.append({"mean": {k: to_numpy(v) for k, v in means.items()},
                    "res": {k: to_numpy(v) for k, v in res.items()},
                    "codes": {k: to_numpy(v) for k, v in codes.items()},
                    "code_sums": {k: to_numpy(v) for k, v in sums.items()}})
    return out


def two_rank_layouts_rank(rank, world):
    """A reduced MoE transformer's `loss` (and gradients) under
    `train_layout="tp"` and its `prefill` under `int8_serve`, on each mesh
    of this world's two ranks, (1, 2) and (2, 1), each rank on its blocks:
    {(mesh, name): the largest difference from the one-rank call on the
    whole arguments (its block), over the largest |value|}. The MoE layer
    dispatches the whole batch (`moe_impl="gspmd"`), as the one-rank call
    does (`moe_impl="ep"` routes each shard's tokens on its own)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import LM_RULES, adapt_rules, block_slices, pspec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.common import init_params, param_pspecs, tree_leaves, tree_map
    from repro_torch.training.train_loop import value_and_grad

    cfg = dataclasses.replace(get_config("olmoe_1b_7b"), n_layers=1, d_model=32, n_heads=2,
                              n_kv_heads=2, d_ff=16, vocab_size=64, n_experts=4, top_k=2,
                              dtype="float32", moe_impl="gspmd")
    gen = torch.Generator().manual_seed(0)
    params = init_params(transformer.param_defs(cfg), gen, "cpu")
    int8 = init_params(transformer.int8_param_defs(transformer.param_defs(cfg)), gen, "cpu")
    int8 = tree_map(lambda t: torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8)
                    if t.dtype == torch.int8 else t, int8)
    int8["moe"], int8["attn"]["attn_norm"] = params["moe"], params["attn"]["attn_norm"]
    int8["attn"]["ffn_norm"], int8["final_norm"] = params["attn"]["ffn_norm"], params["final_norm"]
    tokens = torch.randint(0, 64, (2, 8), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    tp, i8 = (dataclasses.replace(cfg, **kw) for kw in ({"train_layout": "tp"},
                                                        {"int8_serve": True}))
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        coord = tuple(mesh.get_coordinate())
        rules = adapt_rules(LM_RULES, mesh)
        trules = {**rules, "seq": None}  # the tp train cell's

        def cut(t, spec):
            return t[block_slices(t.shape, spec, mesh, coord)]

        def rel(got, whole, spec):
            return float((got - cut(whole, spec)).abs().max() / whole.abs().max())

        specs = param_pspecs(transformer.param_defs(cfg), trules, serve=True)
        bspec = pspec(("batch", "seq"), trules)
        loss, _, grads = value_and_grad(lambda p, b: transformer.loss(p, b, tp, trules),
                                        tree_map(cut, params, specs),
                                        {k: cut(v, bspec) for k, v in batch.items()})
        loss1, _, grads1 = value_and_grad(lambda p, b: transformer.loss(p, b, tp), params, batch)
        errs = [rel(g, g1, spec) for (_, g), (_, g1), (_, spec) in
                zip(tree_leaves(grads), tree_leaves(grads1), tree_leaves(specs))]
        out[(shape, "loss")] = max([abs(float(loss - loss1)) / abs(float(loss1))] + errs)
        ispecs = param_pspecs(transformer.int8_param_defs(transformer.param_defs(cfg)), rules,
                              serve=True)
        with torch.no_grad():
            logits, _ = transformer.prefill(tree_map(cut, int8, ispecs),
                                            cut(tokens, pspec(("batch", "seq"), rules)), i8,
                                            rules=rules)
            logits1, _ = transformer.prefill(int8, tokens, i8)
        out[(shape, "prefill")] = rel(logits, logits1, pspec(("batch", None), rules))
    return out


def layout_rank(rank, world, cases, ckpt_dir):
    """For each (mesh shape, spec, shape) case: `distribute` an arange
    tensor of that shape on the mesh, and restore it from a checkpoint
    (written by rank 0) under the spec. Returns this rank's coordinate, both
    local blocks, and whether the DTensors gather back to the whole."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import distribute, placements
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import checkpoint

    meshes = {shape: make_mesh(shape, ("data", "model"), "cpu")
              for shape in sorted({c[0] for c in cases})}
    tree = {f"w{i}": torch.arange(float(np.prod(shape))).reshape(shape)
            for i, (_, _, shape) in enumerate(cases)}
    if rank == 0:
        checkpoint.save(ckpt_dir, 1, tree)
    dist.barrier()
    out = []
    for i, (mesh_shape, spec, shape) in enumerate(cases):
        mesh = meshes[mesh_shape]
        name = f"w{i}"
        dt = distribute({name: tree[name]}, {name: spec}, mesh)[name]
        only = lambda layout: {k: (layout if k == name else None) for k in tree}  # noqa: E731
        by_spec = checkpoint.restore(ckpt_dir, 1, tree, shardings=only(spec), mesh=mesh)[name]
        by_placements = checkpoint.restore(
            ckpt_dir, 1, tree, shardings=only((mesh, placements(spec, mesh))))[name]
        out.append({
            "coord": tuple(mesh.get_coordinate()), "local": to_numpy(dt.to_local()),
            "restored": [to_numpy(r.to_local()) for r in (by_spec, by_placements)],
            "placements": [tuple(dt.placements), tuple(by_spec.placements),
                           tuple(by_placements.placements)],
            "whole": all(bool(torch.equal(t.full_tensor(), tree[name]))
                         for t in (dt, by_spec, by_placements)),
        })
    return out


def mesh_rank(rank, world):
    """On a world of one rank: `make_test_mesh`, `make_production_mesh`'s
    refusal, `constrain` on a DTensor and on a plain tensor, and a reduced
    MoE transformer's loss and gradients through the mesh against none."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import (
        LM_RULES, P, adapt_rules, constrain, distribute_one,
    )
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.models import transformer
    from repro_torch.models.common import init_params, tree_from_leaves, tree_leaves

    mesh = make_test_mesh("cpu")
    rules = adapt_rules(LM_RULES, mesh)
    refused = []
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        except RuntimeError as e:
            refused.append(str(e))
    t = torch.arange(16.0).reshape(4, 4)
    moved = constrain(distribute_one(t, P("data"), mesh), ("fsdp", None), rules)

    cfg = dataclasses.replace(get_config("olmoe_1b_7b"), n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=4, d_ff=32, vocab_size=128, n_experts=8, top_k=2,
                              dtype="float32")
    params = init_params(transformer.param_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, 128, (2, 16), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    runs = []
    for m in (None, mesh):
        leaves = {k: v.detach().requires_grad_() for k, v in tree_leaves(params)}
        loss, _ = transformer.loss(tree_from_leaves(leaves.items()), batch, cfg,
                                   None if m is None else rules)
        runs.append([loss] + list(torch.autograd.grad(loss, list(leaves.values()))))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    return {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "batch": rules["batch"], "fsdp": rules["fsdp"],
            "mesh_threaded": rules["__mesh__"] is mesh, "refused": refused,
            "constrained": [str(p) for p in moved.placements],
            "constrained_whole": bool(torch.equal(moved.full_tensor(), t)),
            "plain_untouched": constrain(t, ("fsdp", None), rules) is t,
            "transformer_same_bits": same}


def spec_tree(tree, specs):
    """`specs` (a PartitionSpec tree) stretched over `tree`: a leaf of
    `tree` under a spec takes it; a rep dict where `specs` has one spec
    ({"w","mask"}, {"q","s"}, a "block_mask") gives each of its leaves that
    spec, as `repro`'s layout of a pruned or quantized linear keeps its
    weight's."""
    if isinstance(tree, dict) and isinstance(specs, dict):
        return {k: spec_tree(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: spec_tree(v, specs) for k, v in tree.items()}
    return specs


def cut(tree, specs, mesh, coord):
    """This rank's blocks (`block_slices`) of a tree of whole numpy arrays
    laid out by a matching spec tree, as CPU tensors."""
    from repro_torch.distributed.sharding import block_slices
    from repro_torch.models.common import tensor_from_numpy

    if isinstance(tree, dict):
        return {k: cut(v, specs[k], mesh, coord) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cut(v, s, mesh, coord) for v, s in zip(tree, specs))
    a = np.asarray(tree)
    return tensor_from_numpy(np.array(a[block_slices(a.shape, specs, mesh, coord)], order="C"))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return to_numpy(tree)


def recsys_rank(rank, world, mesh_shapes, cases):
    """Each case through `launch/cells.build_cell` on each of this world's
    meshes of `mesh_shapes` (gloo, on the CPU), on this rank's blocks of
    the case's whole numpy arguments (`cut` under the cell's `in_specs`).
    A case is a dict: "arch", "shape_name", "shape" (a `RecSysShape`),
    "cfg" (the port's config), "kind" ("serve", "retrieval", "grad": the
    loss and its gradients under the training rules, "step": the cell's
    train step) and "args" (the cell's arguments, whole: params [,
    opt_state], batch [, candidates]). Returns {mesh shape: per case this
    rank's coordinate and its blocks of the outputs, in numpy}; for "serve"
    and "retrieval" also "one_rank", the one-rank call (no rules) on the
    whole params and this rank's blocks of the rest."""
    from repro_torch.distributed.sharding import RECSYS_RULES, P, adapt_rules
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import axis_names, make_mesh
    from repro_torch.models.recsys import api
    from repro_torch.training.train_loop import value_and_grad

    results = {}
    for mesh_shape in mesh_shapes:
        mesh = make_mesh(mesh_shape, axis_names(mesh_shape), "cpu")
        coord = tuple(mesh.get_coordinate())
        out = results[tuple(mesh_shape)] = []
        for case in cases:
            cfg = case["cfg"]
            cell = build_cell(case["arch"], case["shape_name"], mesh, cfg=cfg,
                              shape=case["shape"], optimizer=case.get("optimizer", "adamw"))
            specs = (spec_tree(case["args"][0], cell.in_specs[0]),) + tuple(cell.in_specs[1:])
            if case["kind"] == "grad":
                specs = (specs[0], specs[2])
            args = [cut(a, s, mesh, coord) for a, s in zip(case["args"], specs)]
            if case["kind"] == "grad":
                rules = adapt_rules(RECSYS_RULES, mesh)
                loss, _, grads = value_and_grad(
                    lambda p, b: api.loss(p, b, cfg, rules), args[0], args[1], rules)
                result = (loss, grads)
            else:
                result = cell.fn(*args)
            rec = {"coord": coord, "out": _numpy_tree(result)}
            if case["kind"] in ("serve", "retrieval"):
                whole = cut(case["args"][0], spec_tree(case["args"][0], P()), mesh, coord)
                fn = api.serve if case["kind"] == "serve" else api.retrieval
                rec["one_rank"] = to_numpy(fn(whole, *args[1:], cfg))
            out.append(rec)
    return results


def cell_run_rank(rank, world, cases):
    """Each (arch, shape, optimizer, overrides) cell, at a reduced size
    (`_small_cell`), built on the (1, 2) mesh of this world's two ranks and
    its `fn` called on this rank's blocks of whole arguments from a seed:
    per case, whether every output is finite, and the loss of a train
    step (every rank returns the whole batch's)."""
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_leaves

    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    coord = tuple(mesh.get_coordinate())
    out = []
    for arch, shape, optimizer, overrides in cases:
        cfg, small = _small_cell(arch, shape, overrides)
        cell = build_cell(arch, shape, mesh, optimizer=optimizer, cfg=cfg, shape=small)
        args = _whole_args(arch, cfg, cell, optimizer)
        specs = (spec_tree(args[0], cell.in_specs[0]),) + tuple(cell.in_specs[1:])
        blocks = [cut(a, s, mesh, coord) for a, s in zip(args, specs)]
        with torch.set_grad_enabled(small.kind == "train"):
            res = cell.fn(*blocks)
        leaves = [t for _, t in tree_leaves(_as_dicts(res)) if t.is_floating_point()]
        out.append({"finite": all(bool(torch.isfinite(t).all()) for t in leaves),
                    "loss": float(res[2]["loss"]) if small.kind == "train" else None})
    return out


def _small_cell(arch, shape, overrides):
    """(config, shape) of a cell cut to a few hundred kB: an LM of 2 layers
    of width 64 over 128 tokens, the recommender's vocabularies at 1,000
    and a history of 8."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import LMShape, RecSysShape

    cfg = get_config(arch, **(overrides or {}))
    if arch == "taobao_ssa":
        cfg = dataclasses.replace(cfg, seq_len=8, fields=tuple(
            dataclasses.replace(f, vocab=min(f.vocab, 1000)) for f in cfg.fields))
        return cfg, RecSysShape(shape, 8, "train")
    cfg = dataclasses.replace(cfg, n_layers=2, d_model=64, n_heads=4, head_dim=16, n_kv_heads=2,
                              d_ff=128, vocab_size=128, dtype="float32", q_chunk=8)
    kind = {"train_4k": "train", "prefill_32k": "prefill"}.get(shape, "decode")
    seq, batch = {"train": (8, 4), "prefill": (8, 4)}.get(
        kind, (64, 1) if shape == "long_500k" else (32, 4))
    return cfg, LMShape(shape, seq, batch, kind)


def _whole_args(arch, cfg, cell, optimizer):
    """A small cell's whole arguments, numpy, from seed 0: the params at
    their defs' init (int8 codes drawn), a fresh optimizer state, the
    tokens (or a Taobao batch), a cache of normals and its positions."""
    from repro_torch.data.synthetic import taobao_batches
    from repro_torch.models import transformer
    from repro_torch.models.common import from_numpy_tree, init_params, tree_map
    from repro_torch.models.recsys import api
    from repro_torch.training.optimizer import get_optimizer

    gen = torch.Generator().manual_seed(0)
    if arch == "taobao_ssa":
        params = init_params(api.param_defs(cfg), gen, "cpu")
        batch = next(taobao_batches(cfg, cell.args[2]["label"].shape[0], 1, seed=0))
        state = get_optimizer(optimizer).init(params)
        return [_numpy_tree(params), _numpy_tree(state), batch]
    defs = transformer.param_defs(cfg)
    if cfg.int8_serve and cell.meta["kind"] != "train":
        defs = transformer.int8_param_defs(defs)
    params = tree_map(lambda t: torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8)
                      if t.dtype == torch.int8 else t, init_params(defs, gen, "cpu"))
    ids = lambda shape, high: torch.randint(0, high, tuple(shape), generator=gen,  # noqa: E731
                                            dtype=torch.int32).numpy()
    if cell.meta["kind"] == "train":
        b = cell.args[2]["tokens"].shape
        state = _numpy_tree(get_optimizer(optimizer).init(from_numpy_tree(
            _numpy_tree(params), "cpu")))
        return [_numpy_tree(params), state, {"tokens": ids(b, cfg.vocab_size),
                                             "labels": ids(b, cfg.vocab_size)}]
    if cell.meta["kind"] == "prefill":
        return [_numpy_tree(params), ids(cell.args[1].shape, cfg.vocab_size)]
    cache = tuple(torch.randn(tuple(c.shape), generator=gen).numpy() for c in cell.args[1])
    T = cell.args[1][0].shape[2]
    return [_numpy_tree(params), cache, ids(cell.args[2].shape, cfg.vocab_size),
            ids(cell.args[3].shape, T - 1)]


def _lm_args(case, params, cell, cut_fn):
    """A case's arguments for its cell: the params (`params[case["params"]]`,
    by default the arch's), a fresh state of the case's optimizer (AdamW by
    default; the rank's blocks of the whole params' state) for a step, then
    the case's own (`cut_fn(tree, spec)` gives the blocks a rank holds)."""
    from repro_torch.distributed.sharding import P
    from repro_torch.models.common import from_numpy_tree
    from repro_torch.training.optimizer import get_optimizer

    specs = list(cell.in_specs)
    whole = params[case.get("params", case["arch"])]
    p = cut_fn(whole, spec_tree(whole, specs[0]))
    if case["kind"] == "step":
        state = get_optimizer(case.get("optimizer", "adamw")).init(from_numpy_tree(whole, "cpu"))
        return [p, cut_fn(_numpy_tree(state), specs[1]), cut_fn(case["args"][0], specs[2])]
    if case["kind"] == "grad":
        return [p, cut_fn(case["args"][0], specs[2])]
    if case["kind"] == "decode":  # a row of tokens a step
        specs[2] = P(None, *specs[2])
    return [p] + [cut_fn(a, s) for a, s in zip(case["args"], specs[1:])]


def _lm_call(case, cell, args, rules):
    """The case's outputs (see `lm_rank`)."""
    from repro_torch.models import transformer
    from repro_torch.training.train_loop import value_and_grad

    kind, cfg = case["kind"], case["cfg"]
    if cfg.train_layout == "tp":  # the cell's: tokens split by batch only
        rules = {**rules, "seq": None}
    with torch.set_grad_enabled(kind in ("grad", "step")):
        if kind == "grad":
            loss, _, grads = value_and_grad(
                lambda p, b: transformer.loss(p, b, cfg, rules), args[0], args[1])
            return loss, grads
        if kind == "decode":
            params, cache, tokens, pos = args
            logits = []
            for t in range(tokens.shape[0]):
                lg, cache = cell.fn(params, cache, tokens[t], pos + t)
                logits.append(lg)
            return torch.stack(logits), cache
        return cell.fn(*args)


def lm_rank(rank, world, mesh_shapes, cases, params):
    """Each LM case through `launch/cells.build_cell` on its mesh of this
    world's ranks (gloo, on the CPU), on this rank's blocks of the case's
    whole numpy arguments (`cut` under the cell's `in_specs`). `params`
    holds each arch's whole numpy params. A case is a dict: "arch",
    "shape_name", "shape" (an `LMShape`), "cfg" (the port's config), "mesh"
    (its shape, one of `mesh_shapes`), "accum", "kind" and "args" (the rest
    of the cell's arguments): "grad" (the loss and its gradients in the
    training layout; args (batch,)), "step" (the train cell's step from a
    fresh AdamW state; args (batch,)), "prefill" (args (tokens,)),
    "decode" (the decode cell stepped once a row of tokens [n, B], at
    pos, pos + 1, ...; args (cache, tokens, pos)); optionally "params"
    (its key in `params`, by default "arch") and "optimizer" (the step's,
    by default "adamw"). Returns {mesh shape: per
    case of that mesh (in `cases` order) this rank's coordinate and its
    blocks of the outputs, in numpy; a decode's outputs are (its logits
    stacked over the steps, the last cache)}."""
    from repro_torch.distributed.sharding import LM_RULES, adapt_rules
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import axis_names, make_mesh

    results = {}
    for mesh_shape in mesh_shapes:
        mesh = make_mesh(mesh_shape, axis_names(mesh_shape), "cpu")
        coord = tuple(mesh.get_coordinate())
        rules = adapt_rules(LM_RULES, mesh)
        out = results[tuple(mesh_shape)] = []
        for case in cases:
            if tuple(case["mesh"]) != tuple(mesh_shape):
                continue
            cell = build_cell(case["arch"], case["shape_name"], mesh, cfg=case["cfg"],
                              shape=case["shape"], accum=case["accum"],
                              optimizer=case.get("optimizer", "adamw"))
            args = _lm_args(case, params, cell, lambda t, s: cut(t, s, mesh, coord))
            out.append({"coord": coord, "out": _numpy_tree(_lm_call(case, cell, args, rules))})
    return results


def one_rank_lm(rank, world, cases, params):
    """On a world of one rank, each case of `lm_rank`'s through its cell on
    the (1, 1) mesh against the plain call (no rules) on the same whole
    arguments: whether every output has the same bits."""
    from repro_torch.distributed.sharding import LM_RULES, adapt_rules
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import make_train_step

    mesh = make_test_mesh("cpu")
    same = []
    for case in cases:
        cfg = case["cfg"]
        cell = build_cell(case["arch"], case["shape_name"], mesh, cfg=cfg, shape=case["shape"],
                          accum=case["accum"])
        args = _lm_args(case, params, cell, lambda t, s: _tensors(t))
        got = _lm_call(case, cell, args, adapt_rules(LM_RULES, mesh))
        if case["kind"] == "step":
            plain = make_train_step(lambda p, b: transformer.loss(p, b, cfg),
                                    opt_lib.get_optimizer("adamw"), grad_accum=case["accum"])
            ref = plain(*args)
        else:
            with torch.no_grad():
                if case["kind"] == "prefill":
                    ref = transformer.prefill(*args, cfg)
                else:
                    params_, cache, tokens, pos = args
                    logits = []
                    for t in range(tokens.shape[0]):
                        lg, cache = transformer.decode(params_, cache, tokens[t], pos + t, cfg)
                        logits.append(lg)
                    ref = torch.stack(logits), cache
        leaves = [[t for _, t in tree_leaves(_as_dicts(r))] for r in (got, ref)]
        same.append(len(leaves[0]) == len(leaves[1])
                    and all(torch.equal(a, b) for a, b in zip(*leaves)))
    return same


def _tensors(tree):
    """A tree of numpy arrays (dicts, tuples) as CPU tensors."""
    from repro_torch.models.common import tensor_from_numpy

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tensors(v) for v in tree)
    return tensor_from_numpy(tree)


def _as_dicts(tree):
    """Tuples of a result tree as dicts keyed by position (for `tree_leaves`)."""
    if isinstance(tree, (tuple, list)):
        return {str(i): _as_dicts(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return tree


def split_decode_rank(rank, world, device, cases):
    """`layers.split_decode_attention` on this rank's block of each case's
    whole cache, the sequence split over the world group in rank order. A
    case is a dict of numpy q [B,1,K,G,hd], k, v [B,T,K,hd], pos [B], and
    "sparse", "window", "n_global", "dtype". Returns each output as f32
    numpy."""
    import torch.distributed as dist

    from repro_torch.models.layers import split_decode_attention

    if device == "cuda":
        torch.cuda.set_device(0)
    out = []
    for c in cases:
        dt = getattr(torch, c["dtype"])
        T = c["k"].shape[1]
        n = T // world
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        o = split_decode_attention(
            put(c["q"]).to(dt), put(c["k"][:, rank * n:(rank + 1) * n]).to(dt),
            put(c["v"][:, rank * n:(rank + 1) * n]).to(dt), put(c["pos"]), t0=rank * n, T=T,
            groups=(dist.group.WORLD,), sparse=c["sparse"], window=c["window"],
            n_global=c["n_global"])
        out.append(o.float().cpu().numpy())
    return out


def gnn_rules(cfg, mesh):
    """The rules a NequIP cell of `cfg` runs under on `mesh`
    (`launch/cells._gnn_cell`'s): `GNN_RULES`, the nodes and edges over
    the whole mesh under `full_mesh_graph`."""
    from repro_torch.distributed.sharding import GNN_RULES, adapt_rules, mesh_axis_names

    rules = adapt_rules(GNN_RULES, mesh)
    if cfg.full_mesh_graph:
        full = tuple(a for a in ("pod", "data", "model") if a in mesh_axis_names(mesh))
        rules = {**rules, "nodes": full, "edges": full}
    return rules


def gnn_rank(rank, world, cases):
    """Each NequIP case through `launch/cells.build_cell` on its mesh of
    this world's ranks (gloo, on the CPU), on this rank's blocks of the
    case's whole numpy params and graph (`cut` under the cell's
    `in_specs`). A case is a dict: "mesh" (its shape), "cfg" (the port's
    config), "shape_name", "shape" (a `GNNShape`), "params", "graph".
    Returns per case this rank's coordinate and, in numpy: the forward's
    output block ("out") and the one-rank forward's block of the whole
    graph ("one_rank"), the loss and the whole gradients
    (`value_and_grad` under the step's rules: the parts summed over the
    node dims), and the cell's train step from a fresh AdamW state twice
    ("step", and whether the second gave the same bits)."""
    from repro_torch.distributed.sharding import block_slices
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import axis_names, make_mesh
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.gnn import nequip
    from repro_torch.training.optimizer import get_optimizer
    from repro_torch.training.train_loop import value_and_grad

    meshes = {}
    out = []
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, axis_names(shape), "cpu")
        mesh = meshes[shape]
        coord = tuple(mesh.get_coordinate())
        cfg = case["cfg"]
        cell = build_cell("nequip", case["shape_name"], mesh, cfg=cfg, shape=case["shape"])
        rules = gnn_rules(cfg, mesh)
        params = cut(case["params"], cell.in_specs[0], mesh, coord)
        graph = cut(case["graph"], cell.in_specs[2], mesh, coord)
        loss_fn = (nequip.energy_loss if "energies" in graph else nequip.node_class_loss)
        with torch.no_grad():
            fwd = nequip.forward(params, graph, cfg, rules)
            whole = nequip.forward(params, _tensors(case["graph"]), cfg)
        rows = block_slices(tuple(whole.shape), cell.in_specs[2]["positions"], mesh, coord)
        loss, _, grads = value_and_grad(lambda p, b: loss_fn(p, b, cfg, rules), params, graph,
                                        {**rules, "batch": rules["nodes"]})
        opt = get_optimizer("adamw")
        steps = [cell.fn(params, opt.init(params), graph) for _ in range(2)]
        leaves = [[t for _, t in tree_leaves(_as_dicts(s))] for s in steps]
        out.append({"coord": coord, "out": to_numpy(fwd), "one_rank": to_numpy(whole[rows]),
                    "loss": float(loss), "grads": _numpy_tree(grads),
                    "step": _numpy_tree(steps[0]),
                    "step_repeats": all(torch.equal(a, b) for a, b in zip(*leaves))})
    return out


def gnn_cell_rank(rank, world, mesh_shape, device="cpu"):
    """NequIP's molecule cell (`launch/cells.build_cell`, 2 layers of 8
    channels, 16 molecules padded to 512 atoms and 1,024 edges) on this
    world's `mesh_shape` (gloo; tensors on `device`, "cuda" being card 0
    shared by the ranks): its forward and its `fn` from seed-0 weights and
    a fresh AdamW state on this rank's blocks of one batch. Returns the
    rank's coordinate, the forward's block and the one-rank forward's
    block of the whole graph (numpy), the metrics, the `embedding_bag`
    launches of the step, whether every output is finite and whether the
    updated params keep their shapes."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import GNNShape
    from repro_torch.data import synthetic
    from repro_torch.distributed.sharding import block_slices
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import axis_names, make_mesh
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.models.gnn import nequip
    from repro_torch.training.optimizer import get_optimizer

    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = make_mesh(mesh_shape, axis_names(mesh_shape), "cpu")
    coord = tuple(mesh.get_coordinate())
    cfg = dataclasses.replace(get_config("nequip"), n_layers=2, d_hidden=8)
    shape = GNNShape("molecule", n_nodes=30, n_edges=64, d_feat=None, kind="batched_small",
                     graph_batch=16)
    cell = build_cell("nequip", "molecule", mesh, cfg=cfg, shape=shape)
    g = synthetic.molecule_batch(16, 30, 64, seed=0)
    N, n = cell.meta["nodes"], g["positions"].shape[0]

    def pad(a, fill):
        return np.concatenate([a, np.full((N - n,) + a.shape[1:], fill, a.dtype)])

    g = {**g, "positions": pad(g["positions"], 1.0), "species": pad(g["species"], 0),
         "graph_ids": pad(g["graph_ids"], 0), "node_mask": pad(np.ones(n, bool), False),
         "edge_mask": np.ones(g["edge_src"].shape, bool)}
    params = init_params(nequip.param_defs(cfg, n_classes=1), torch.Generator().manual_seed(0),
                         device)
    to = lambda tree: {k: v.to(device) for k, v in tree.items()}  # noqa: E731
    blocks = to(cut(g, cell.in_specs[2], mesh, coord))
    with torch.no_grad():
        fwd = nequip.forward(params, blocks, cfg, gnn_rules(cfg, mesh))
        whole = nequip.forward(params, to(_tensors(g)), cfg)
    rows = block_slices(tuple(whole.shape), cell.in_specs[2]["positions"], mesh, coord)
    eb_ops.launches = 0
    new, _, metrics = cell.fn(params, get_optimizer("adamw").init(params), blocks)
    return {"coord": coord, "out": to_numpy(fwd), "one_rank": to_numpy(whole[rows]),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "launches": eb_ops.launches,
            "finite": all(bool(torch.isfinite(t).all()) for _, t in tree_leaves(new)),
            "same_shapes": [t.shape for _, t in tree_leaves(new)]
            == [t.shape for _, t in tree_leaves(params)]}


def adam8bit_rank(rank, world, mesh_shapes, cases, device="cpu"):
    """adam8bit across ranks on shared gradients: for each case, a dict of
    "arch", "shape_name" and "cfg" (the train cell whose specs lay the
    params out, `launch/cells.build_cell(..., optimizer="adam8bit")`) and
    "seed", the whole params (`init_params` of the arch's defs) and three
    draws of gradients (normal, each leaf at a scale of 10^-3 to 10^2) are
    made alike on every rank; the one-rank update runs on the CPU on the
    whole tree, and this rank's update on its blocks on `device` (the
    state the whole state's blocks, under the cell's specs), on each mesh
    of `mesh_shapes`. Returns {mesh: per case, this rank's coordinate and
    per leaf (path joined by "/"): whether every update and moment (codes
    and scales) of its blocks has the bits of the one-rank call's block,
    and whether its last axis is split (its update then exchanges the
    blocks' maxima)}."""
    from repro_torch.distributed.sharding import block_slices
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import axis_names, make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.common import float_tree, init_params, tree_leaves, tree_map
    from repro_torch.models.recsys import api
    from repro_torch.training.optimizer import _cols_of, adam8bit

    results = {}
    for mesh_shape in mesh_shapes:
        mesh = make_mesh(mesh_shape, axis_names(mesh_shape), "cpu")
        coord = tuple(mesh.get_coordinate())
        out = results[tuple(mesh_shape)] = []
        for case in cases:
            cfg = case["cfg"]
            cell = build_cell(case["arch"], case["shape_name"], mesh, cfg=cfg,
                              optimizer="adam8bit")
            p_specs, o_specs = cell.in_specs[:2]
            defs = (transformer if case["arch"] in ("yi_6b", "olmoe_1b_7b") else api).param_defs(cfg)
            whole = float_tree(init_params(defs, torch.Generator().manual_seed(case["seed"]), "cpu"))
            rng = np.random.default_rng(case["seed"])
            grads = [tree_map(lambda p: torch.from_numpy(
                (rng.standard_normal(tuple(p.shape)) * 10.0 ** rng.integers(-3, 3)).astype(
                    np.float32)), whole) for _ in range(3)]

            def block(t, spec):
                return t[block_slices(t.shape, spec, mesh, coord)].contiguous().to(device)

            opt = adam8bit(1e-3)
            state = opt.init(whole)
            mine = {"m": tree_map(block, state["m"], o_specs["m"]),
                    "v": tree_map(block, state["v"], o_specs["v"]),
                    "count": state["count"].to(device)}
            params = tree_map(block, whole, p_specs)
            same = {"/".join(p): True for p, _ in tree_leaves(whole)}
            for g in grads:
                upd, state = opt.update(g, state, whole)
                got, mine = opt.update(tree_map(block, g, p_specs), mine, params, (mesh, p_specs))
                for path, u in tree_leaves(got):
                    key = "/".join(path)
                    ok = torch.equal(u.cpu(), block(tree_leaves_at(upd, path), tree_leaves_at(
                        p_specs, path)).cpu())
                    for mv in ("m", "v"):
                        for part in ("q", "s"):
                            spec = tree_leaves_at(o_specs[mv], path)[part]
                            ok &= torch.equal(tree_leaves_at(mine[mv], path)[part].cpu(),
                                              block(tree_leaves_at(state[mv], path)[part],
                                                    spec).cpu())
                    same[key] &= ok
            split = {"/".join(p): _cols_of(tree_leaves_at(p_specs, p), t.dim(), t.shape[-1],
                                           mesh) is not None for p, t in tree_leaves(params)}
            out.append({"coord": coord, "same": same, "split_last": split,
                        "device": str(next(iter(tree_leaves(params)))[1].device)})
    return results


def tree_leaves_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree
