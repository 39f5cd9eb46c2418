"""Uniform recsys model API: dispatch by cfg.interaction (port of `repro.models.recsys.api`).

Only the `self_attn_seq` interaction (taobao_ssa) is ported; the others
raise `NotImplementedError` naming the slice that brings them.
"""
from __future__ import annotations

from repro_torch.configs.base import RecSysConfig
from repro_torch.models.recsys import taobao_ssa

_MODULES = {
    "self_attn_seq": taobao_ssa,
}
_LATER = {
    "fm": "the FM slice",
    "augru": "the DIEN slice",
    "target_attn": "the recsys-families slice (DIN)",
    "self_attn": "the recsys-families slice (AutoInt)",
}


def module_for(cfg: RecSysConfig):
    mod = _MODULES.get(cfg.interaction)
    if mod is None:
        later = _LATER.get(cfg.interaction, "a later slice")
        raise NotImplementedError(
            f"interaction {cfg.interaction!r} is not ported yet; it comes with {later}"
        )
    return mod


def param_defs(cfg):
    return module_for(cfg).param_defs(cfg)


def loss(params, batch, cfg):
    return module_for(cfg).loss(params, batch, cfg)


def serve(params, batch, cfg):
    return module_for(cfg).serve(params, batch, cfg)


def retrieval(params, query, cand_ids, cfg):
    return module_for(cfg).retrieval(params, query, cand_ids, cfg)
