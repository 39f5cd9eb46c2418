"""Plain reference of `taobao_ssa.json`: the paper's baseline ranker.

arXiv:2506.11421 §V.A: a sequential self-attention ranker on Taobao user
behaviour. Per request, the history's units (item row + category row +
a learned position) go through two pre-LN encoder blocks (4-head
self-attention over the valid steps, then an FFN 64 -> 256 -> 64 with a
ReLU, each with a residual) and a masked mean pool; per candidate, a
PReLU tower (200-80) over [user, candidate, pool, pool * candidate]
gives a logit and the sigmoid its score. The layer norm has a scale and
no bias and uses the population variance (eps 1e-5); a masked key gets
-1e30 before the softmax.

Plain PyTorch in float32 with TF32 off, written from that description.
It imports nothing of the program: lookups are plain indexing, and the
history is encoded once a request, since it does not depend on the
candidate.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

REQUEST_BLOCK = 512  # requests encoded at once
ROW_BLOCK = 16384  # candidate rows through the tower at once


def _ln(x, scale):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * scale


def _prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def _mlp(p: Dict, name: str, x, n_hidden: int):
    for i in range(n_hidden):
        x = _prelu(x @ p[f"{name}_w{i}"] + p[f"{name}_b{i}"], p[f"{name}_a{i}"])
    return x @ p[f"{name}_wout"] + p[f"{name}_bout"]


def encode(p: Dict, model: Dict, hist_item, hist_category, hist_len):
    """[R, L] histories -> pooled [R, d]."""
    t = p["tables"]
    x = t["item"][hist_item.long()] + t["category"][hist_category.long()] + p["pos"][None]
    R, L, d = x.shape
    H = model["n_heads"]
    dh = d // H
    mask = torch.arange(L, device=x.device)[None] < hist_len.long()[:, None]  # [R, L]
    for layer in range(model["n_attn_layers"]):
        e = p[f"enc{layer}"]
        h = _ln(x, e["ln1"])
        q, k, v = ((h @ e[w]).view(R, L, H, dh).transpose(1, 2) for w in ("wq", "wk", "wv"))
        s = q @ k.transpose(-1, -2) / math.sqrt(dh)  # [R, H, L, L]
        s = s.masked_fill(~mask[:, None, None, :], -1e30)
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(R, L, d)
        x = x + o @ e["wo"]
        x = x + torch.relu(_ln(x, e["ln2"]) @ e["w1"]) @ e["w2"]
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)


def scores(p: Dict, model: Dict, req, reqs: np.ndarray) -> torch.Tensor:
    """The scores of every candidate of requests `reqs` (in that order),
    from the weights `p` and the harness's requests `req`."""
    t = p["tables"]
    out = []
    for a in range(0, len(reqs), REQUEST_BLOCK):
        block = reqs[a:a + REQUEST_BLOCK]
        r = torch.as_tensor(block, device=req.user.device)
        pooled = encode(p, model, req.hist_item[r], req.hist_category[r], req.hist_len[r])
        rows = np.concatenate([np.arange(req.offsets[i], req.offsets[i + 1]) for i in block])
        owner = np.repeat(np.arange(len(block)), req.ncand[block])
        for b in range(0, len(rows), ROW_BLOCK):
            c = torch.as_tensor(rows[b:b + ROW_BLOCK], device=r.device)
            o = torch.as_tensor(owner[b:b + ROW_BLOCK], device=r.device)
            user = t["user"][req.user[r][o].long()]
            cand = t["item"][req.item[c].long()] + t["category"][req.category[c].long()]
            pool = pooled[o]
            x = torch.cat([user, cand, pool, pool * cand], dim=-1)
            out.append(torch.sigmoid(_mlp(p, "tower", x, len(model["mlp_dims"]))[:, 0]))
    return torch.cat(out)


def dot_flops(model: Dict, hist_len: np.ndarray, ncand: np.ndarray) -> float:
    """Dot flops the requests need (2 a multiply-add): the encoder once a
    request over its h valid steps (per block 6hd² for q, k, v, 2hd² for
    the output projection, 16hd² for the FFN, 2h²d for the scores and
    2h²d for their product with v), the tower once a candidate."""
    d = model["d_attn"]
    h = np.minimum(hist_len.astype(np.float64), model["seq_len"])
    enc = model["n_attn_layers"] * float(np.sum(24 * h * d * d + 4 * h * h * d))
    user = {f["name"]: f for f in model["fields"]}["user"].get("dim") or model["embed_dim"]
    dims = [user + 3 * d, *model["mlp_dims"], 1]
    tower = 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return enc + tower * float(np.sum(ncand))
