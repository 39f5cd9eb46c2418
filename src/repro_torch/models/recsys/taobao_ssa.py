"""The paper's Baseline (§V): sequential self-attention ranker on Taobao
(port of `repro.models.recsys.taobao_ssa`).

hist units (item⊕cat sum -> 64-d) + learned positions -> 2 pre-LN encoder
blocks (4-head self-attention + FFN 64->256->64) -> masked mean pool ->
tower([user16, cand64, pool64, pool*cand]) -> logit.

Every projection is a compressible linear (core/lightweight.py) and every
f32 table lookup goes through the EmbeddingBag kernel (models/recsys/
embedding.py). The arithmetic keeps `repro`'s order: scores are
`einsum(q, k) / sqrt(dh)`, masked keys get -1e30, the softmax is f32, the
layer norm uses the population variance, and the pool divides by
`clip(Σmask, 1)`.

The paper's C2 local-attention window (|i−j| < window) applies when the
config carries a non-zero `attn_window` attribute (`cfg_window`), as in
`repro`; `RecSysConfig` has no such field, so a caller's config adds it
(`configs/base.with_attn_window`). The windowed attention then runs the
hand-written local-attention kernel (`kernels/local_attention`) with the
history's key mask, except where the caller collects the attention
probabilities (the C3 distillation KL), which the kernel does not return.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.core.lightweight import linear
from repro_torch.core.sparse_attention import local_global_mask
from repro_torch.kernels.local_attention.ops import windowed_attention_op
from repro_torch.models.common import ParamDef
from repro_torch.models.recsys.embedding import _take_rows, field_lookup, named_table_defs
from repro_torch.models.recsys.rec_layers import bce_with_logits, mlp_apply, mlp_defs


def param_defs(cfg: RecSysConfig) -> Dict:
    d = cfg.d_attn  # 64
    L = cfg.seq_len
    defs: Dict = {"tables": named_table_defs(cfg)}
    defs["pos"] = ParamDef((L, d), torch.float32, "normal")
    for l in range(cfg.n_attn_layers):
        defs[f"enc{l}"] = {
            "ln1": ParamDef((d,), torch.float32, "ones"),
            "wq": ParamDef((d, d), torch.float32, "fan_in"),
            "wk": ParamDef((d, d), torch.float32, "fan_in"),
            "wv": ParamDef((d, d), torch.float32, "fan_in"),
            "wo": ParamDef((d, d), torch.float32, "fan_in"),
            "ln2": ParamDef((d,), torch.float32, "ones"),
            "w1": ParamDef((d, 4 * d), torch.float32, "fan_in"),
            "w2": ParamDef((4 * d, d), torch.float32, "fan_in"),
        }
    user_dim = cfg.field_dim([f for f in cfg.fields if f.name == "user"][0])
    tower_in = user_dim + d + d + d
    defs.update(mlp_defs("tower", tower_in, cfg.mlp_dims))
    return defs


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)  # population variance, as jnp.var
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale


def _encoder_block(p, x: torch.Tensor, mask: torch.Tensor, n_heads: int, *, window: int = 0,
                   kv_len=None, collect_attn: bool = False):
    """Pre-LN MHA + FFN. Returns (x, attention probs [B,H,L,L]) — the probs
    feed the C3 distillation KL. `window`>0 applies the paper's C2 local
    attention mask (|i-j| < window); unless `collect_attn`, that attention
    runs the local-attention kernel over the keys j < `kv_len` (the
    history lengths, which `mask` is made of), and the probs are None."""
    B, L, d = x.shape
    dh = d // n_heads
    h = _ln(x, p["ln1"])
    q = linear(p["wq"], h).reshape(B, L, n_heads, dh)
    k = linear(p["wk"], h).reshape(B, L, n_heads, dh)
    v = linear(p["wv"], h).reshape(B, L, n_heads, dh)
    if window and not collect_attn:
        heads = [t.transpose(1, 2) for t in (q, k, v)]  # [B,H,L,dh] views, not copies
        o = windowed_attention_op(*heads, window=window, kv_len=kv_len)
        o = o.transpose(1, 2).reshape(B, L, d)  # on the card a view of [B,L,H,dh]: no copy
        probs = None
    else:
        s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(dh)
        valid = mask[:, None, None, :]  # key mask
        if window:
            valid = valid & local_global_mask(L, window, device=x.device)[None, None]
        s = torch.where(valid, s, -1e30)
        probs = torch.softmax(s.to(torch.float32), dim=-1)
        o = torch.einsum("bhlm,bmhd->blhd", probs.to(v.dtype), v).reshape(B, L, d)
    x = x + linear(p["wo"], o)
    h2 = _ln(x, p["ln2"])
    x = x + linear(p["w2"], torch.relu(linear(p["w1"], h2)))
    return x, probs


def encode_history(params, batch, cfg: RecSysConfig, collect_attn: bool = False):
    """-> (pooled [B,d], attn list per layer)."""
    t = params["tables"]
    it = field_lookup(t, cfg, "hist_item", batch["hist_item"])
    ca = field_lookup(t, cfg, "hist_category", batch["hist_category"])
    x = it + ca + params["pos"][None]
    L = x.shape[1]
    hist_len = batch["hist_len"]
    mask = torch.arange(L, device=x.device)[None] < hist_len[:, None]
    window = cfg_window(cfg)
    kv_len = hist_len.to(torch.int32) if window else None
    attns = []
    for l in range(cfg.n_attn_layers):
        x, probs = _encoder_block(params[f"enc{l}"], x, mask, cfg.n_heads, window=window,
                                  kv_len=kv_len, collect_attn=collect_attn)
        if collect_attn:
            attns.append(probs)
    m = mask[..., None].to(x.dtype)
    pooled = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
    return pooled, attns


def cfg_window(cfg) -> int:
    """The C2 window, carried by an optional `attn_window` attribute so the
    config dataclass stays family-generic, as in `repro`; 0 = none."""
    return getattr(cfg, "attn_window", 0) or 0


def _tower_logits(params, user, cand, pooled, cfg):
    x = torch.cat([user, cand, pooled, pooled * cand], dim=-1)
    return mlp_apply(params, "tower", x, len(cfg.mlp_dims))[:, 0]


def logits_and_attn(params, batch, cfg: RecSysConfig, collect_attn: bool = False):
    t = params["tables"]
    user = field_lookup(t, cfg, "user", batch["user"])
    it = field_lookup(t, cfg, "item", batch["item"])
    ca = field_lookup(t, cfg, "category", batch["category"])
    cand = it + ca
    pooled, attns = encode_history(params, batch, cfg, collect_attn)
    return _tower_logits(params, user, cand, pooled, cfg), attns


def logits(params, batch, cfg: RecSysConfig):
    return logits_and_attn(params, batch, cfg)[0]


def loss(params, batch, cfg: RecSysConfig):
    lg = logits(params, batch, cfg)
    b = bce_with_logits(lg, batch["label"])
    return b, {"bce": b}


def serve(params, batch, cfg: RecSysConfig):
    return torch.sigmoid(logits(params, batch, cfg))


def retrieval(params, query, cand_ids, cfg: RecSysConfig):
    """History encoding is candidate-independent here — encode once, then
    batched tower over N candidates."""
    t = params["tables"]
    user = field_lookup(t, cfg, "user", query["user"])[0]
    pooled, _ = encode_history(params, query, cfg)
    pooled = pooled[0]

    it = _take_rows(t["item"], cand_ids)
    ca = _take_rows(t["category"], query["cand_category"])
    cand = it + ca
    N = cand.shape[0]
    return _tower_logits(
        params,
        user[None].expand(N, user.shape[0]),
        cand,
        pooled[None].expand(N, pooled.shape[0]),
        cfg,
    )
