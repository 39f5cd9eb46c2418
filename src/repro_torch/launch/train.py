"""Training launcher (port of `repro.launch.train`) for every family:

    PYTHONPATH=src python -m repro_torch.launch.train [--arch taobao_ssa|fm|dien|din|autoint|
        yi_6b|chatglm3_6b|command_r_35b|olmoe_1b_7b|llama4_maverick_400b_a17b|nequip] \
        [--steps 200] [--batch 256] [--optimizer adamw|sgd|adam8bit] [--lr 1e-3] \
        [--ckpt-dir DIR] [--ckpt-every 100] [--device cuda]

Config -> model -> optimizer -> fault-tolerant loop (checkpoint/resume),
as `repro`'s: `reduced_config` cuts a recsys arch's vocabularies to 5,000
and keeps its widths, and an LM arch to 2 layers, d 128, 4 heads of 32,
d_ff 256, vocab 512 and at most 8 experts top-2 (in its dtype, bf16 for
every LM config), and keeps NequIP as configured; parameters come from
seed 0, batches from `make_data` (seed 0; an LM's are 128 tokens a row
from `lm_token_batches`; NequIP's one `random_graph` of 512 nodes and
4,096 edges a step, 7 classes, whatever `--batch` says),
and `ResilientTrainer` checkpoints every `--ckpt-every` steps into
`--ckpt-dir` (default `repro_torch_ckpt_<arch>` in the temp directory),
restoring the latest checkpoint there first if it finds one. A checkpoint
is `repro`'s layout, so one package's restores in the other. Prints
`repro`'s JSON line (arch, steps, restarts, wall_s, steps_per_s) and
`resumed_from`, the step restored (0 without a checkpoint).

Deviations from `repro`:

- after a restore `repro`'s launcher draws fresh batches from seed `start`
  (`make_data(cfg, batch)(start)`), so a resumed run trains on other data
  than an uninterrupted one; here the batches of a resumed run are the
  uninterrupted stream's from step `start` on (`resumable`), and a run
  that crashes and resumes ends in the same bits as one that does not;
- `steps_per_s` counts the steps this call trained, `steps` minus
  `resumed_from` (`repro` divides the last step, restored steps included,
  by this call's seconds), and `resumed_from` is a key `repro` does not
  print; over a finished checkpoint `steps` is the restored step and
  `steps_per_s` 0 (`repro` reports one step more, see
  `training/fault_tolerance.ResilientTrainer.run`).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_NAMES, get_config
from repro_torch.data import synthetic
from repro_torch.models.common import init_params
from repro_torch.models import transformer
from repro_torch.models.gnn import nequip
from repro_torch.models.recsys import api as rec_api
from repro_torch.training import checkpoint
from repro_torch.training.fault_tolerance import FTConfig, ResilientTrainer
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_loop import make_train_step

# `repro`'s printed keys, and the step this call resumed from
PRINTED = ("arch", "steps", "restarts", "wall_s", "steps_per_s", "resumed_from")
LM_SEQ = 128  # tokens a row of an LM batch, as `repro`'s launcher
GNN_NODES, GNN_DEGREE, GNN_CLASSES = 512, 8, 7  # the graph a NequIP step trains on


def reduced_config(cfg):
    """Shrink any ported arch config to CPU-trainable scale (`repro`'s cuts)."""
    if cfg.family == "lm":
        return dataclasses.replace(
            cfg, n_layers=2, d_model=128, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4),
            d_ff=256, vocab_size=512, head_dim=32,
            n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
            top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        )
    if cfg.family == "recsys":
        fields = tuple(dataclasses.replace(f, vocab=min(f.vocab, 5000)) for f in cfg.fields)
        return dataclasses.replace(cfg, fields=fields)
    return cfg  # nequip is already small


def make_data(cfg, batch: int, device, seed_base: int = 0):
    """`step -> iterator of batches` on `device`: `lm_token_batches` of
    `LM_SEQ` tokens for an LM, `criteo_batches` for FM and AutoInt,
    `taobao_batches` for the other recsys archs, seeded `seed_base + step`,
    and for NequIP one `random_graph` a batch, seeded `seed_base + step`,
    `seed_base + step + 1`, ..., as `repro`'s. A fresh iterator each call,
    so `make_data(...)(1)` replays the same batches."""
    if cfg.family == "gnn":
        def gen(step):
            for i in itertools.count(step):
                yield synthetic.random_graph(GNN_NODES, GNN_DEGREE, n_classes=GNN_CLASSES,
                                             seed=seed_base + i)
    elif cfg.family == "lm":
        gen = lambda step: synthetic.lm_token_batches(  # noqa: E731
            cfg.vocab_size, batch, LM_SEQ, 10**9, seed=seed_base + step)
    elif cfg.interaction in ("fm", "self_attn"):
        gen = lambda step: synthetic.criteo_batches(cfg, batch, 10**9, seed=seed_base + step)  # noqa: E731
    else:
        gen = lambda step: synthetic.taobao_batches(cfg, batch, 10**9, seed=seed_base + step)  # noqa: E731
    return lambda step: (
        {k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in gen(step)
    )


def resumable(data: Callable) -> Callable:
    """`start -> the batches of `data(0)` from step `start` on`: what a
    resumed `ResilientTrainer` trains on, the uninterrupted run's stream."""
    return lambda start: itertools.islice(data(0), start, None)


def recording_losses(train_step: Callable, losses: List[torch.Tensor]) -> Callable:
    """`train_step` that also appends each step's loss (a tensor, read after
    the run: no wait for the device a step) to `losses`."""
    def step(params, opt_state, batch):
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses.append(metrics["loss"])
        return params, opt_state, metrics

    return step


def make_loss(cfg):
    if cfg.family == "lm":
        return lambda p, b: transformer.loss(p, b, cfg)
    if cfg.family == "recsys":
        return lambda p, b: rec_api.loss(p, b, cfg)
    return lambda p, b: nequip.node_class_loss(p, b, cfg)


def param_defs_for(cfg):
    if cfg.family == "lm":
        return transformer.param_defs(cfg)
    if cfg.family == "recsys":
        return rec_api.param_defs(cfg)
    return nequip.param_defs(cfg, n_classes=GNN_CLASSES)


def run(arch: str, *, steps: int = 200, batch: int = 256, optimizer: str = "adamw",
        lr: float = 1e-3, ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
        device="cuda", crash_at: Optional[int] = None) -> Dict:
    """Train `arch` through `ResilientTrainer`; `crash_at` injects a failure
    at that step (it raises). Returns `repro`'s record (arch, steps,
    restarts, wall_s, steps_per_s) with "resumed_from", "params",
    "opt_state" and "losses", the loss of each step this call ran."""
    cfg = reduced_config(get_config(arch))  # refuses an unknown arch
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(param_defs_for(cfg), gen, dev)
    opt = get_optimizer(optimizer, lr)
    opt_state = opt.init(params)
    losses: List[torch.Tensor] = []
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), f"repro_torch_ckpt_{arch}")
    trainer = ResilientTrainer(
        recording_losses(make_train_step(make_loss(cfg), opt), losses),
        FTConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
        make_batches=resumable(make_data(cfg, batch, dev)),
    )
    resumed_from = checkpoint.latest_step(ckpt_dir) or 0
    t0 = time.time()
    params, opt_state, restarts, last = trainer.run(params, opt_state, steps, crash_at=crash_at)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    return {"arch": arch, "steps": last, "restarts": restarts, "wall_s": round(dt, 2),
            "steps_per_s": round((last - resumed_from) / dt, 2), "resumed_from": resumed_from,
            "params": params, "opt_state": opt_state, "losses": [float(x) for x in losses]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="taobao_ssa", choices=ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--optimizer", default="adamw", choices=("sgd", "adamw", "adam8bit"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.arch, steps=args.steps, batch=args.batch, optimizer=args.optimizer,
              lr=args.lr, ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
              device=args.device)
    print(json.dumps({k: rec[k] for k in PRINTED}))


if __name__ == "__main__":
    main()
