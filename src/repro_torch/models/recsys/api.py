"""Uniform recsys model API: dispatch by cfg.interaction (port of `repro.models.recsys.api`)."""
from __future__ import annotations

from repro_torch.configs.base import RecSysConfig
from repro_torch.models.recsys import autoint, dien, din, fm, taobao_ssa

_MODULES = {
    "fm": fm,
    "self_attn": autoint,
    "target_attn": din,
    "augru": dien,
    "self_attn_seq": taobao_ssa,
}


def module_for(cfg: RecSysConfig):
    return _MODULES[cfg.interaction]


def param_defs(cfg):
    return module_for(cfg).param_defs(cfg)


def loss(params, batch, cfg):
    return module_for(cfg).loss(params, batch, cfg)


def serve(params, batch, cfg):
    return module_for(cfg).serve(params, batch, cfg)


def retrieval(params, query, cand_ids, cfg):
    return module_for(cfg).retrieval(params, query, cand_ids, cfg)
