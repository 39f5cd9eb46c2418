"""DIN [arXiv:1706.06978]: target attention over the behaviour sequence
(port of `repro.models.recsys.din`).

Behaviour unit = item_emb ⊕ category_emb (2·de). Attention features per
(candidate, step): [h, c, h−c, h·c] -> MLP(80,40) -> masked softmax ->
weighted sum. Tower: [user, cand, pooled] -> MLP(200,80) -> logit.

Every lookup of an f32 table goes through the EmbeddingBag kernel (five a
call at width 18: user, item, category and the two histories) and every
linear through the compressible-linear dispatch (`mlp_apply`), so the
quantized variant serves int8 tables and weights, as in `repro`. The
arithmetic keeps `repro`'s order: masked steps get -1e30 and the softmax
is f32.
Every entry point takes `repro`'s `rules` (None: one rank); across ranks
only the lookups (`embedding.py`) and the loss's mean exchange data, and
the rest works row by row on this rank's block of the batch (or of the
candidates), so `repro`'s `constrain`s of its outputs already hold.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.core import spans
from repro_torch.models.recsys.embedding import _take_rows, field_lookup, named_table_defs
from repro_torch.models.recsys.rec_layers import bce_with_logits, mlp_apply, mlp_defs


def param_defs(cfg: RecSysConfig) -> Dict:
    de = cfg.embed_dim
    du = 2 * de  # behaviour-unit dim
    defs: Dict = {"tables": named_table_defs(cfg)}
    defs.update(mlp_defs("attn", 4 * du, cfg.attn_mlp_dims))
    tower_in = de + du + du  # user + candidate + pooled
    defs.update(mlp_defs("tower", tower_in, cfg.mlp_dims))
    return defs


def _behaviour_emb(params, batch, cfg, hist: bool, rules=None):
    t = params["tables"]
    if hist:
        it = field_lookup(t, cfg, "hist_item", batch["hist_item"], rules)
        ca = field_lookup(t, cfg, "hist_category", batch["hist_category"], rules)
    else:
        it = field_lookup(t, cfg, "item", batch["item"], rules)
        ca = field_lookup(t, cfg, "category", batch["category"], rules)
    return torch.cat([it, ca], dim=-1)  # [..., 2de]


def target_attention(params, hist, cand, hist_mask, cfg):
    """hist: [B,L,du]; cand: [B,du] -> pooled [B,du]."""
    with spans.span("interaction", hist_mask, 2):
        c = cand[:, None, :].expand_as(hist)
        feats = torch.cat([hist, c, hist - c, hist * c], dim=-1)  # [B,L,4du]
        att = mlp_apply(params, "attn", feats, len(cfg.attn_mlp_dims))[..., 0]  # [B,L]
        att = torch.where(hist_mask, att, -1e30)
        w = torch.softmax(att.to(torch.float32), dim=-1).to(hist.dtype)
        return torch.einsum("bl,bld->bd", w, hist)


def logits(params, batch, cfg: RecSysConfig, rules=None):
    user = field_lookup(params["tables"], cfg, "user", batch["user"], rules)
    hist = _behaviour_emb(params, batch, cfg, True, rules)  # [B,L,du]
    cand = _behaviour_emb(params, batch, cfg, False, rules)  # [B,du]
    mask = torch.arange(hist.shape[1], device=hist.device)[None] < batch["hist_len"][:, None]
    pooled = target_attention(params, hist, cand, mask, cfg)
    x = torch.cat([user, cand, pooled], dim=-1)
    return mlp_apply(params, "tower", x, len(cfg.mlp_dims))[:, 0]


def loss(params, batch, cfg: RecSysConfig, rules=None):
    lg = logits(params, batch, cfg, rules)
    b = bce_with_logits(lg, batch["label"], rules)
    return b, {"bce": b}


def serve(params, batch, cfg: RecSysConfig, rules=None):
    return torch.sigmoid(logits(params, batch, cfg, rules))


def retrieval(params, query, cand_ids, cfg: RecSysConfig, rules=None):
    """One user, N candidate items: history encoded once, target attention
    batched over candidates. The candidates' rows are gathered from any
    table representation (`repro` takes them with a bare `jnp.take`, which
    serves f32 tables only)."""
    t = params["tables"]
    user = field_lookup(t, cfg, "user", query["user"], rules)[0]  # [de]
    hist = _behaviour_emb(params, query, cfg, True, rules)[0]  # [L,du]
    L = hist.shape[0]
    mask = torch.arange(L, device=hist.device)[None] < query["hist_len"][:, None]  # [1,L]

    it = _take_rows(t["item"], cand_ids, rules, "candidates")
    ca = _take_rows(t["category"], query["cand_category"], rules, "candidates")
    cand = torch.cat([it, ca], dim=-1)  # [N,du]

    N = cand.shape[0]
    pooled = target_attention(params, hist[None].expand(N, L, hist.shape[1]), cand,
                              mask.expand(N, L), cfg)
    x = torch.cat([user[None].expand(N, user.shape[0]), cand, pooled], dim=-1)
    return mlp_apply(params, "tower", x, len(cfg.mlp_dims))[:, 0]
