"""Serving launcher (the pipeline of `repro.launch.serve` before its
simulator): builds the Table-I variants of one recsys arch at full width
and times the serve call at each batch size, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch taobao_ssa|fm|dien] \
        [--variants baseline,quantized,pruned,pruned_quantized,distilled] \
        [--train-steps 40] [--structured] --sizes 1,8,32,128,512 [--device cuda] \
        [--params params.npz] [--reps 20]

Prints one JSON line per variant and size: median and p90 ms of a serve
call, and each kernel's launches per call; then, when the ladder ran, one
line of `variant_stats`. Parameters are random (`init_params` on the
device, from seed 0) unless `--params` names an .npz whose keys are the
tree's paths joined by "/" (e.g. "tables/item", "enc0/wq", "tower_w0").
taobao_ssa, the arch with a ladder, then always pretrains, as `repro`'s
launcher does, whichever variants are asked for: `--train-steps` steps of
AdamW at lr 1e-3 on batches of 256 (`launch/train.make_data`, seed 0), so
`baseline` names the same tree in every run. `quantized` is post-training
quantization of those parameters (`core/quantization.quantize_tree`). The
trained variants (`pruned`, `pruned_quantized`, `distilled`) come from
`run_ladder` with 10 fine-tune, 10 QAT and 15 distillation steps on the
batches of seed 1; `--structured` prunes in 128 x 128 tiles, whose linears
then run the block-pruned kernel. fm and dien have no ladder and serve
their weights as they are; `dien` has no quantized variant either (see
`UNSERVABLE`). Requests come from `criteo_batches` for `fm` and from
`taobao_batches` otherwise. The hand-off of the curves to the serving
simulator comes with a later slice.

Matmuls run in full f32: TF32 is switched off explicitly, since the JAX
reference is full f32.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PORTED, RecSysConfig, get_config
from repro_torch.core.compression_loop import (
    LadderConfig, run_ladder, serving_params, variant_stats)
from repro_torch.core.distillation import make_student_cfg
from repro_torch.core.quantization import quantize_tree
from repro_torch.data.synthetic import criteo_batches, taobao_batches
from repro_torch.kernels.augru import ops as augru_ops
from repro_torch.kernels.block_pruned_matmul import ops as block_pruned_matmul_ops
from repro_torch.kernels.embedding_bag import ops as embedding_bag_ops
from repro_torch.kernels.fm_interaction import ops as fm_interaction_ops
from repro_torch.launch.train import make_data
from repro_torch.models.common import from_numpy_tree, init_params
from repro_torch.models.recsys import api as rec_api
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_loop import make_train_step

SIZES = (1, 8, 32, 128, 512)
VARIANTS = ("baseline", "quantized", "pruned", "pruned_quantized", "distilled")
TRAINED = ("pruned", "pruned_quantized", "distilled")  # need pretraining and the ladder
TRAIN_STEPS = 40  # pretraining steps, as repro's launcher
TRAIN_BATCH = 256
TRAIN_LR = 1e-3
LADDER = LadderConfig(finetune_steps=10, qat_steps=10, distill_steps=15)  # repro's launcher's

_NO_LADDER = (
    "repro builds the trained variants for taobao_ssa only: its "
    "distillation.init_student_from_teacher (src/repro/core/distillation.py:33-39) builds a "
    "taobao_ssa student and copies the teacher's 'pos', so run_ladder raises for this arch")
# (interaction, variant) pairs the reference cannot serve, and why
UNSERVABLE = {
    ("augru", "quantized"): (
        "DIEN has no quantized variant: repro's dien._gru_cell "
        "(src/repro/models/recsys/dien.py:46) multiplies the GRU weights with a bare @, "
        "which raises on the int8 rep dicts quantize_tree makes of them"
    ),
    **{(arch, v): _NO_LADDER for arch in ("fm", "augru") for v in TRAINED},
}
WARMUP = 3  # untimed calls at each size before the timed ones

# every kernel wrapper of the port, by kernel name; each counts its launches
KERNELS = {"embedding_bag": embedding_bag_ops, "fm_interaction": fm_interaction_ops,
           "augru": augru_ops, "block_pruned_matmul": block_pruned_matmul_ops}


def launch_counts() -> Dict[str, int]:
    return {name: ops.launches for name, ops in KERNELS.items()}


def reset_launch_counts() -> None:
    for ops in KERNELS.values():
        ops.launches = 0


def disable_tf32() -> None:
    """Full-f32 matmuls and convolutions on the card (the reference is f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load_params(path: str, device) -> Dict:
    """An .npz of "/"-joined tree paths -> the nested parameter tree on `device`."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return from_numpy_tree(tree, device)


def make_params(cfg: RecSysConfig, device, seed: int = 0) -> Dict:
    """Random parameters at the config's width, drawn on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(rec_api.param_defs(cfg), gen, device)


def variants_for(cfg: RecSysConfig) -> Tuple[str, ...]:
    """The variants this arch serves: those of `VARIANTS` it can serve."""
    return tuple(v for v in VARIANTS if (cfg.interaction, v) not in UNSERVABLE)


def check_variants(names: Iterable[str], cfg: RecSysConfig) -> None:
    """Raise for a variant that `build_variants` cannot make for this arch."""
    for name in names:
        if name not in VARIANTS:
            raise ValueError(f"unknown variant {name!r}; the variants are {VARIANTS}")
        if (cfg.interaction, name) in UNSERVABLE:
            raise NotImplementedError(UNSERVABLE[(cfg.interaction, name)])


def has_ladder(cfg: RecSysConfig) -> bool:
    """Whether `run_ladder` builds this arch's trained variants (taobao_ssa only)."""
    return all((cfg.interaction, v) not in UNSERVABLE for v in TRAINED)


def base_params(cfg: RecSysConfig, device, params_path: Optional[str] = None,
                train_steps: int = TRAIN_STEPS):
    """The parameters every variant is built from, and the ladder's
    fine-tuning batches (None without a ladder): the loaded or seed-0
    weights, pretrained `train_steps` steps where the arch has a ladder."""
    params = load_params(params_path, device) if params_path else make_params(cfg, device)
    if not has_ladder(cfg):
        return params, None
    data = make_data(cfg, TRAIN_BATCH, device)
    params, _ = pretrain(params, cfg, data(0), train_steps)
    return params, lambda: data(1)  # every stage replays the same batches


def pretrain(params: Dict, cfg: RecSysConfig, batches, steps: int) -> Tuple[Dict, List[float]]:
    """`steps` AdamW steps at `TRAIN_LR` on `rec_api.loss`; returns the
    parameters and each step's loss."""
    opt = get_optimizer("adamw", TRAIN_LR)
    step = make_train_step(lambda p, b: rec_api.loss(p, b, cfg), opt)
    state = opt.init(params)
    losses = []
    for _, b in zip(range(steps), batches):
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return params, losses


def build_variants(params: Dict, names: Iterable[str], cfg: RecSysConfig, *,
                   batch_fn=None, ladder: Optional[LadderConfig] = None) -> Dict[str, Dict]:
    """{name: the tree `serve` runs}. Without a trained variant among
    `names` this is `params` and its PTQ; with one, `run_ladder(params, cfg,
    batch_fn, ladder)` builds all five, as `repro` does, and a structured
    ladder's masked variants gain their block masks (`serving_params`)."""
    names = tuple(names)
    check_variants(names, cfg)
    if not any(n in TRAINED for n in names):
        return {name: params if name == "baseline" else quantize_tree(params) for name in names}
    if batch_fn is None:
        raise ValueError("the trained variants need batch_fn, the fine-tuning batches")
    ladder = ladder or LADDER
    built = run_ladder(params, cfg, batch_fn, ladder)
    return {name: serving_params(name, built[name]["params"], ladder) for name in names}


def request_batches(cfg: RecSysConfig, sizes: Iterable[int], device, seed: int = 2) -> Dict[int, Dict]:
    """One batch of requests per size, cut from one draw of the arch's
    generator: `criteo_batches` for FM, `taobao_batches` (one world) else."""
    sizes = tuple(sizes)
    gen = criteo_batches if cfg.interaction == "fm" else taobao_batches
    b = next(gen(cfg, max(sizes), 1, seed=seed))
    return {
        n: {k: torch.from_numpy(v[:n]).to(device) for k, v in b.items() if k != "label"}
        for n in sizes
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def variant_cfg(name: str, cfg: RecSysConfig) -> RecSysConfig:
    """The config variant `name` serves with: the distilled student's is shallower."""
    return make_student_cfg(cfg) if name == "distilled" else cfg


def calibrate_variant(params: Dict, cfg: RecSysConfig, batches: Dict[int, Dict],
                      *, reps: int = 10) -> Dict[int, Dict]:
    """Time `rec_api.serve` at each size: {size: {"ms": [..],
    "launches_per_call": {kernel: launches / call}, "probs"}}. The device is
    synchronised before each clock read, so a time covers the work and not
    only its enqueue."""
    out = {}
    for n, batch in batches.items():
        device = next(iter(batch.values())).device
        for _ in range(WARMUP):
            rec_api.serve(params, batch, cfg)
        launches0 = launch_counts()
        ms: List[float] = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            probs = rec_api.serve(params, batch, cfg)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[n] = {
            "ms": ms,
            "launches_per_call": {k: (c - launches0[k]) / reps
                                  for k, c in launch_counts().items()},
            "probs": probs,
        }
    return out


def run(cfg: Optional[RecSysConfig] = None, *, variants: Optional[Iterable[str]] = None,
        sizes: Iterable[int] = SIZES, device="cuda", params_path: Optional[str] = None,
        reps: int = 10, train_steps: int = TRAIN_STEPS,
        ladder: Optional[LadderConfig] = None) -> List[Dict]:
    """Build the variants (by default all the arch serves, `variants_for`)
    and time them; one record per (variant, size), then one of
    `variant_stats` when the ladder ran. taobao_ssa pretrains
    `train_steps` steps first (`base_params`); a trained variant among them
    runs `ladder` (default `LADDER`)."""
    dev = resolve_device(device)
    cfg = cfg or get_config("taobao_ssa")
    variants = tuple(variants or variants_for(cfg))
    check_variants(variants, cfg)  # before the parameters are built
    params, batch_fn = base_params(cfg, dev, params_path, train_steps)
    batches = request_batches(cfg, sizes, dev)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    records = []
    built = build_variants(params, variants, cfg, batch_fn=batch_fn, ladder=ladder)
    for name, vparams in built.items():
        vcfg = variant_cfg(name, cfg)
        for n, r in calibrate_variant(vparams, vcfg, batches, reps=reps).items():
            records.append({
                "arch": cfg.name, "variant": name, "size": n, "device": kind, "reps": reps,
                "median_ms": float(np.median(r["ms"])),
                "p90_ms": float(np.percentile(r["ms"], 90)),
                "launches_per_call": r["launches_per_call"],
            })
    if any(v in TRAINED for v in variants):
        records.append({"arch": cfg.name, "variant_stats": variant_stats(
            {name: {"params": p} for name, p in built.items()})})
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="taobao_ssa", choices=PORTED)
    ap.add_argument("--variants", default=None,
                    help="comma-separated; default: the arch's own (taobao_ssa: all five, "
                         "fm: baseline and quantized, dien: baseline)")
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS,
                    help="taobao_ssa's pretraining steps, before any variant is built")
    ap.add_argument("--structured", action="store_true",
                    help="prune in 128 x 128 tiles (the block-pruned kernel's path)")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", default=None, help=".npz of '/'-joined parameter paths")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if args.reps < 10:
        ap.error("--reps must be at least 10")
    disable_tf32()
    for rec in run(
        get_config(args.arch),
        variants=args.variants.split(",") if args.variants else None,
        sizes=[int(s) for s in args.sizes.split(",")],
        device=args.device, params_path=args.params, reps=args.reps,
        train_steps=args.train_steps,
        ladder=dataclasses.replace(LADDER, structured=args.structured),
    ):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
