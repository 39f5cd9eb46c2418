"""DIEN [arXiv:1809.03672]: GRU interest extraction + AUGRU interest evolution
(port of `repro.models.recsys.dien`).

Stage 1: standard GRU over behaviour units -> interest states h_t, in plain
PyTorch: the attention needs every state h1 [B,L,g], and the AUGRU kernel
returns only the last. The input projection x @ wx + b is taken for all
steps at once, before the time loop.
Stage 2: attention score a_t = softmax(h_t W_a cand); AUGRU scales the
update gate by a_t:  u_t' = a_t * u_t;  h_t = (1-u_t')∘h_{t-1} + u_t'∘h̃_t.
It runs in the Hopper AUGRU kernel (`kernels/augru`), one launch a call.

The GRU weights are applied with a bare matmul, as in `repro`, so DIEN has
no quantized variant: `repro`'s `_gru_cell` (`dien.py:46`) raises on the
int8 rep dicts `quantize_tree` makes of them.
Every entry point takes `repro`'s `rules` (None: one rank); across ranks
only the lookups (`embedding.py`) and the loss's mean exchange data, and
the rest works row by row on this rank's block of the batch (or of the
candidates), so `repro`'s `constrain`s of its outputs already hold.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.kernels.augru.ops import augru_op
from repro_torch.models.common import ParamDef
from repro_torch.models.recsys.embedding import _take_rows, field_lookup, named_table_defs
from repro_torch.models.recsys.rec_layers import bce_with_logits, mlp_apply, mlp_defs


def _gru_defs(name: str, d_in: int, g: int) -> Dict:
    return {
        f"{name}_wx": ParamDef((d_in, 3 * g), torch.float32, "fan_in", axes=(None, None)),
        f"{name}_wh": ParamDef((g, 3 * g), torch.float32, "fan_in", axes=(None, None)),
        f"{name}_b": ParamDef((3 * g,), torch.float32, "zeros", axes=(None,)),
    }


def param_defs(cfg: RecSysConfig) -> Dict:
    de = cfg.embed_dim
    du = 2 * de
    g = cfg.gru_dim
    defs: Dict = {"tables": named_table_defs(cfg)}
    defs.update(_gru_defs("gru1", du, g))
    defs.update(_gru_defs("augru", g, g))
    defs["w_att"] = ParamDef((g, du), torch.float32, "fan_in", axes=(None, None))
    defs.update(mlp_defs("tower", de + du + g, cfg.mlp_dims))
    return defs


def _gru_cell(params, name, h: torch.Tensor, zx: torch.Tensor) -> torch.Tensor:
    """One GRU step from the input projection zx = x @ wx + b; gates in
    [r, u, c] layout."""
    g = h.shape[-1]
    zh = h @ params[f"{name}_wh"]
    r = torch.sigmoid(zx[..., :g] + zh[..., :g])
    u = torch.sigmoid(zx[..., g : 2 * g] + zh[..., g : 2 * g])
    c = torch.tanh(zx[..., 2 * g :] + r * zh[..., 2 * g :])
    return (1.0 - u) * h + u * c


def _run_gru(params, name, xs: torch.Tensor, mask: torch.Tensor, g: int):
    """xs: [B,L,d] time loop; mask: [B,L] -> (h_last [B,g], states [B,L,g]).
    A masked step keeps the previous state."""
    B, L, _ = xs.shape
    zx = xs @ params[f"{name}_wx"] + params[f"{name}_b"]  # [B,L,3g], all steps at once
    h = torch.zeros((B, g), dtype=xs.dtype, device=xs.device)
    hs = []
    for t in range(L):
        h = torch.where(mask[:, t, None], _gru_cell(params, name, h, zx[:, t]), h)
        hs.append(h)
    return h, torch.stack(hs, dim=1)


def _behaviour_emb(params, batch, cfg, hist: bool, rules=None):
    t = params["tables"]
    if hist:
        it = field_lookup(t, cfg, "hist_item", batch["hist_item"], rules)
        ca = field_lookup(t, cfg, "hist_category", batch["hist_category"], rules)
    else:
        it = field_lookup(t, cfg, "item", batch["item"], rules)
        ca = field_lookup(t, cfg, "category", batch["category"], rules)
    return torch.cat([it, ca], dim=-1)


def _attention(h1: torch.Tensor, q: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """h1 [B,L,g], q = cand @ w_att.T [B,g] -> softmax over the unmasked
    steps [B,L]; masked keys get -1e30, the softmax is f32."""
    att_logits = torch.einsum("blg,bg->bl", h1, q)
    att_logits = torch.where(mask, att_logits, -1e30)
    return torch.softmax(att_logits.to(torch.float32), dim=-1).to(h1.dtype)


def _evolve(params, h1: torch.Tensor, att: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Stage 2: the AUGRU over h1 [B,L,g] from h0 = 0 -> final state [B,g]."""
    zx = (h1 @ params["augru_wx"] + params["augru_b"]).contiguous()
    h0 = torch.zeros((h1.shape[0], h1.shape[2]), dtype=h1.dtype, device=h1.device)
    return augru_op(zx, params["augru_wh"], h0, att.contiguous(), mask.contiguous())


def _interest(params, hist, mask, cand, cfg):
    """hist [B,L,du], cand [B,du] -> final evolved interest [B,g]."""
    g = cfg.gru_dim
    _, h1 = _run_gru(params, "gru1", hist, mask, g)  # [B,L,g]
    att = _attention(h1, cand @ params["w_att"].T, mask)
    return _evolve(params, h1, att, mask)


def logits(params, batch, cfg: RecSysConfig, rules=None):
    user = field_lookup(params["tables"], cfg, "user", batch["user"], rules)
    hist = _behaviour_emb(params, batch, cfg, True, rules)
    cand = _behaviour_emb(params, batch, cfg, False, rules)
    mask = torch.arange(hist.shape[1], device=hist.device)[None] < batch["hist_len"][:, None]
    interest = _interest(params, hist, mask, cand, cfg)
    x = torch.cat([user, cand, interest], dim=-1)
    return mlp_apply(params, "tower", x, len(cfg.mlp_dims))[:, 0]


def loss(params, batch, cfg: RecSysConfig, rules=None):
    lg = logits(params, batch, cfg, rules)
    b = bce_with_logits(lg, batch["label"], rules)
    return b, {"bce": b}


def serve(params, batch, cfg: RecSysConfig, rules=None):
    return torch.sigmoid(logits(params, batch, cfg, rules))


def retrieval(params, query, cand_ids, cfg: RecSysConfig, rules=None):
    """GRU stage-1 runs once; candidate-dependent AUGRU batched over N
    (this rank's block of them)."""
    t = params["tables"]
    user = field_lookup(t, cfg, "user", query["user"], rules)[0]
    hist = _behaviour_emb(params, query, cfg, True, rules)  # [1,L,du]
    L = hist.shape[1]
    mask = torch.arange(L, device=hist.device)[None] < query["hist_len"][:, None]  # [1,L]

    it = _take_rows(t["item"], cand_ids, rules, "candidates")
    ca = _take_rows(t["category"], query["cand_category"], rules, "candidates")
    cand = torch.cat([it, ca], dim=-1)
    N = cand.shape[0]

    g = cfg.gru_dim
    _, h1 = _run_gru(params, "gru1", hist, mask, g)  # [1,L,g]
    h1N = h1.expand(N, L, g)
    maskN = mask.expand(N, L)
    att = _attention(h1N, cand @ params["w_att"].T, maskN)
    h_final = _evolve(params, h1N, att, maskN)

    userN = user[None].expand(N, user.shape[0])
    x = torch.cat([userN, cand, h_final], dim=-1)
    return mlp_apply(params, "tower", x, len(cfg.mlp_dims))[:, 0]
