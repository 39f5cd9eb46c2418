"""Plain reference of `din.json`: the Deep Interest Network.

At the widths of the DIN model in the DIEN authors' public code
(github.com/mouna99/dien): each behaviour of the history and the
candidate are units [item row, category row] (2 x 18); an activation unit
scores each valid behaviour from [h, c, h - c, h * c] through an MLP
(80-40) to one number; the scores are normalised by a softmax over the
valid behaviours (a masked step gets -1e30) and pool the behaviours; a
tower (200-80) over [user, candidate, pool] gives a logit and the sigmoid
its score. Both MLPs use PReLU, as the DIN paper's activation unit
(arXiv:1706.06978, Fig. 2).

Plain PyTorch in float32 with TF32 off, written from that description.
It imports nothing of the program: lookups are plain indexing. The
target attention depends on the candidate, so it runs once a candidate;
the history's rows are looked up once a request.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

REQUEST_BLOCK = 256  # requests whose candidates are scored at once


def _prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def _mlp(p: Dict, name: str, x, n_hidden: int):
    for i in range(n_hidden):
        x = _prelu(x @ p[f"{name}_w{i}"] + p[f"{name}_b{i}"], p[f"{name}_a{i}"])
    return x @ p[f"{name}_wout"] + p[f"{name}_bout"]


def scores(p: Dict, model: Dict, req, reqs: np.ndarray) -> torch.Tensor:
    """The scores of every candidate of requests `reqs` (in that order),
    from the weights `p` and the harness's requests `req`."""
    t = p["tables"]
    L = model["seq_len"]
    out = []
    for a in range(0, len(reqs), REQUEST_BLOCK):
        block = reqs[a:a + REQUEST_BLOCK]
        r = torch.as_tensor(block, device=req.user.device)
        hist = torch.cat([t["item"][req.hist_item[r].long()],
                          t["category"][req.hist_category[r].long()]], dim=-1)  # [R, L, 36]
        mask = torch.arange(L, device=r.device)[None] < req.hist_len[r].long()[:, None]
        rows = np.concatenate([np.arange(req.offsets[i], req.offsets[i + 1]) for i in block])
        o = torch.as_tensor(np.repeat(np.arange(len(block)), req.ncand[block]), device=r.device)
        c = torch.as_tensor(rows, device=r.device)
        cand = torch.cat([t["item"][req.item[c].long()], t["category"][req.category[c].long()]],
                         dim=-1)  # [N, 36]
        h = hist[o]  # [N, L, 36]
        cc = cand[:, None, :].expand_as(h)
        att = _mlp(p, "attn", torch.cat([h, cc, h - cc, h * cc], dim=-1),
                   len(model["attn_mlp_dims"]))[..., 0]
        att = att.masked_fill(~mask[o], -1e30)
        pool = (torch.softmax(att, dim=-1)[..., None] * h).sum(dim=1)
        user = t["user"][req.user[r][o].long()]
        x = torch.cat([user, cand, pool], dim=-1)
        out.append(torch.sigmoid(_mlp(p, "tower", x, len(model["mlp_dims"]))[:, 0]))
    return torch.cat(out)


def dot_flops(model: Dict, hist_len: np.ndarray, ncand: np.ndarray) -> float:
    """Dot flops the requests need (2 a multiply-add), all once a
    candidate: the activation unit's MLP over the h valid behaviours, the
    pool (2h·du) and the tower."""
    de = model["embed_dim"]
    du = 2 * de
    h = np.minimum(hist_len.astype(np.float64), model["seq_len"])
    att = [4 * du, *model["attn_mlp_dims"], 1]
    att_per_step = 2 * sum(a * b for a, b in zip(att[:-1], att[1:])) + 2 * du
    tower = [de + 2 * du, *model["mlp_dims"], 1]
    tower_flops = 2 * sum(a * b for a, b in zip(tower[:-1], tower[1:]))
    n = ncand.astype(np.float64)
    return float(np.sum(n * (h * att_per_step + tower_flops)))
