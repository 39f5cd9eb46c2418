"""Uniform recsys model API: dispatch by cfg.interaction (port of `repro.models.recsys.api`).

`rules`, as `repro`'s: `distributed/sharding.adapt_rules(RECSYS_RULES,
mesh)` of a `DeviceMesh` (with `launch/cells`' overrides for
`serve_full_mesh` and retrieval), the arguments this rank's blocks of
their layout; None runs on one rank with whole arguments.

`serve` on the card replays a captured CUDA graph of the call where the
same batch signature comes again (`serve_graph`); its root span records
which way the call went."""
from __future__ import annotations

from repro_torch.configs.base import RecSysConfig
from repro_torch.core import spans
from repro_torch.models.recsys import autoint, dien, din, fm, serve_graph, taobao_ssa

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


def loss(params, batch, cfg, rules=None):
    return module_for(cfg).loss(params, batch, cfg, rules)


def serve(params, batch, cfg, rules=None):
    with spans.serve(batch):
        graphs = serve_graph.GRAPHS
        how, sig = graphs.path(params, batch, cfg, rules)
        spans.serve_path(how)
        if sig is None:
            return module_for(cfg).serve(params, batch, cfg, rules)
        return graphs.run(how, sig, module_for(cfg).serve, params, batch, cfg)


def retrieval(params, query, cand_ids, cfg, rules=None):
    return module_for(cfg).retrieval(params, query, cand_ids, cfg, rules)
