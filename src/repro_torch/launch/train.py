"""Training helpers of `repro.launch.train` for the recsys family:
`reduced_config` and `make_data`. The fault-tolerant trainer and its
checkpoints come with a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.data import synthetic


def reduced_config(cfg: RecSysConfig) -> RecSysConfig:
    """Shrink a recsys config to CPU-trainable scale: vocabularies cut to 5,000."""
    fields = tuple(dataclasses.replace(f, vocab=min(f.vocab, 5000)) for f in cfg.fields)
    return dataclasses.replace(cfg, fields=fields)


def make_data(cfg: RecSysConfig, batch: int, device, seed_base: int = 0):
    """`step -> iterator of batches` on `device`: `criteo_batches` for FM,
    `taobao_batches` otherwise, seeded `seed_base + step`, as `repro`'s. A
    fresh iterator each call, so `make_data(...)(1)` replays the same batches."""
    if cfg.interaction in ("fm", "self_attn"):
        gen = lambda step: synthetic.criteo_batches(cfg, batch, 10**9, seed=seed_base + step)  # noqa: E731
    else:
        gen = lambda step: synthetic.taobao_batches(cfg, batch, 10**9, seed=seed_base + step)  # noqa: E731
    return lambda step: (
        {k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in gen(step)
    )
