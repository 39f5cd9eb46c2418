"""Shared helpers of the `test_torch_*` parity tests: the same small config
in both packages, `repro` parameters carried into the port, and numpy
batches handed to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import reduced_recsys
from repro.models.common import init_params as jax_init_params
from repro.models.recsys import api as jax_api
from repro_torch.configs.base import get_config as torch_get_config
from repro_torch.models.common import from_numpy_tree


def small_configs(seq_len: int = 20):
    """(repro cfg, repro_torch cfg) of taobao_ssa with vocabs <= 1000 and a
    short history: 2 blocks, d=64, 4 heads as at full width."""
    jcfg = dataclasses.replace(reduced_recsys("taobao_ssa"), seq_len=seq_len)
    tcfg = torch_get_config("taobao_ssa")
    tcfg = dataclasses.replace(
        tcfg,
        fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, 1000)) for f in tcfg.fields),
        seq_len=seq_len,
    )
    return jcfg, tcfg


def jax_params(jcfg, seed: int = 0):
    return jax_init_params(jax_api.param_defs(jcfg), jax.random.key(seed))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch_params(jparams):
    """repro params -> the port's tree on the CPU (through numpy)."""
    return from_numpy_tree(to_numpy(jparams), "cpu")


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
