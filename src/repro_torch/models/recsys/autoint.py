"""AutoInt [arXiv:1810.11921]: multi-head self-attention over field embeddings
(port of `repro.models.recsys.autoint`).

Layer l: Q,K,V projections of the [B, F, d_l] field matrix, softmax over the
field axis, residual via a linear map, ReLU. After n layers the flattened
field matrix feeds a linear scorer. The field embeddings come from one
unified-table lookup through the EmbeddingBag kernel; the attention over
39 fields is plain PyTorch, as `repro` leaves it to XLA outside any
kernel.

The projections are applied with a bare matmul, as in `repro`, so AutoInt
has no quantized variant: `repro`'s `_interact` (`autoint.py:50-52`)
raises on the int8 rep dicts `quantize_tree` makes of them, and so does
this one.
Every entry point takes `repro`'s `rules` (None: one rank); across ranks
only the lookups (`embedding.py`) and the loss's mean exchange data, and
the rest works row by row on this rank's block of the batch (or of the
candidates), so `repro`'s `constrain`s of its outputs already hold.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.models.common import ParamDef
from repro_torch.models.recsys.embedding import (
    _take_rows,
    unified_lookup,
    unified_offsets,
    unified_table_def,
)
from repro_torch.models.recsys.rec_layers import bce_with_logits


def _dims(cfg: RecSysConfig):
    d_out = cfg.n_heads * cfg.d_attn
    ins = [cfg.embed_dim] + [d_out] * (cfg.n_attn_layers - 1)
    return ins, d_out


def param_defs(cfg: RecSysConfig) -> Dict:
    ins, d_out = _dims(cfg)
    defs: Dict = {"table": unified_table_def(cfg)}
    for l, d_in in enumerate(ins):
        defs[f"attn{l}"] = {k: ParamDef((d_in, d_out), torch.float32, "fan_in", axes=(None, None))
                            for k in ("wq", "wk", "wv", "w_res")}
    F = len(cfg.fields)
    defs["w_out"] = ParamDef((F * d_out, 1), torch.float32, "fan_in", axes=(None, None))
    defs["b_out"] = ParamDef((1,), torch.float32, "zeros", axes=(None,))
    return defs


def _interact(params, e: torch.Tensor, cfg: RecSysConfig) -> torch.Tensor:
    """e: [B, F, d0] -> [B, F, d_out] through the attention stack."""
    H, da = cfg.n_heads, cfg.d_attn
    x = e
    for l in range(cfg.n_attn_layers):
        p = params[f"attn{l}"]
        B, F, _ = x.shape
        q = (x @ p["wq"]).reshape(B, F, H, da)
        k = (x @ p["wk"]).reshape(B, F, H, da)
        v = (x @ p["wv"]).reshape(B, F, H, da)
        s = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(da)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(B, F, H * da)
        x = torch.relu(o + x @ p["w_res"])
    return x


def logits(params, batch, cfg: RecSysConfig, rules=None):
    e = unified_lookup(params["table"], batch["sparse_idx"], cfg, rules)
    x = _interact(params, e, cfg)
    B = x.shape[0]
    return (x.reshape(B, -1) @ params["w_out"] + params["b_out"])[:, 0]


def loss(params, batch, cfg: RecSysConfig, rules=None):
    lg = logits(params, batch, cfg, rules)
    b = bce_with_logits(lg, batch["label"], rules)
    return b, {"bce": b}


def serve(params, batch, cfg: RecSysConfig, rules=None):
    return torch.sigmoid(logits(params, batch, cfg, rules))


def retrieval(params, query, cand_ids, cfg: RecSysConfig, rules=None):
    """Broadcast the 38 user-field embeddings; swap the candidate field's
    embedding per candidate; full attention stack over [N, F, d]."""
    cand_field = max(range(len(cfg.fields)), key=lambda i: cfg.fields[i].vocab)
    offs = unified_offsets(cfg)
    e = unified_lookup(params["table"], query["sparse_idx"], cfg, rules)[0]  # [F,d]
    v_c = _take_rows(params["table"], cand_ids + int(offs[cand_field]), rules,
                     "candidates")  # [N,d], this rank's block
    N = v_c.shape[0]
    eN = e[None].expand(N, *e.shape).clone()
    eN[:, cand_field, :] = v_c
    x = _interact(params, eN, cfg)
    return (x.reshape(N, -1) @ params["w_out"] + params["b_out"])[:, 0]
