"""Ranking requests, made from a seed by one general generator that a
traffic mix's file parameterises.

A request is one user with a history and a set of candidates: the
program scores every candidate. The rule for the rows is `repro_torch.
data.synthetic.taobao_batches`' (copied, and moved onto the device):

  * users uniform over the user table; a world of latent preferences
    (`world_dim` numbers a user and a category) and an item -> category
    map, all drawn from the seed;
  * the history: of `history_pool` x L items drawn uniformly, the L of
    highest affinity to the user, the positions past `hist_len` (uniform
    in the mix's range) set to item 0, categories from the map;
  * each candidate drawn from the valid history with probability
    `from_history`, else uniformly over the items.

What the copy adds is the request: its number of candidates (the mix's
`candidates`: a number, every request's, or a range [lo, hi] drawn
log-uniformly) and its arrival (the mix's `arrivals`, a name in
`ARRIVALS`). Requests are index ranges into arrays made once at set-up;
`offsets[r]` is the first candidate row of request r.

Items are drawn uniformly over the table by `uniform_items`; a mix's own
file, `traffic/<mix>.py`, may give another `arrivals` or `generate` (see
`harness.spec.Cell`): for a skew, `generate` with another `draw_items`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from harness.model import sub_seed

CHUNK = 16384  # requests whose history pool is scored at once


@dataclasses.dataclass
class Requests:
    user: torch.Tensor  # [R] int32
    hist_item: torch.Tensor  # [R, L] int32
    hist_category: torch.Tensor  # [R, L] int32
    hist_len: torch.Tensor  # [R] int32
    item: torch.Tensor  # [C] int32, the candidates of every request in order
    category: torch.Tensor  # [C] int32
    cand_req: torch.Tensor  # [C] int64, each candidate's request
    ncand: np.ndarray  # [R] int64
    offsets: np.ndarray  # [R + 1] int64
    hist_len_host: np.ndarray  # [R] int64

    @property
    def count(self) -> int:
        return len(self.ncand)


def _vocab(model: Dict, role_field: str) -> int:
    return {f["name"]: f for f in model["fields"]}[role_field]["vocab"]


def uniform_items(n_items: int, size, generator, device) -> torch.Tensor:
    """Item ids uniform over [0, n_items), int32."""
    return torch.randint(0, n_items, size, dtype=torch.int32, generator=generator, device=device)


def candidate_counts(traffic: Dict, n: int, generator, device) -> torch.Tensor:
    """Each request's number of candidates, int64 on `device`: the mix's
    `candidates`, a number (every request's) or [lo, hi] (log-uniform)."""
    c = traffic["candidates"]
    if isinstance(c, int):
        return torch.full((n,), c, dtype=torch.int64, device=device)
    if isinstance(c, list) and len(c) == 2 and all(isinstance(x, int) for x in c):
        c_lo, c_hi = c
        u = torch.rand(n, generator=generator, device=device)
        k = torch.exp(math.log(c_lo) + u * (math.log(c_hi + 1) - math.log(c_lo))).floor()
        return k.clamp(c_lo, c_hi).to(torch.int64)
    raise ValueError(f"candidates {c!r}: a whole number or a range [lo, hi]")


def generate(traffic: Dict, model: Dict, n: int, seed: int, device,
             draw_items=uniform_items) -> Requests:
    """`n` requests of the mix `traffic` for the configuration `model`,
    drawn from `seed` on `device`: the same seed and sizes give the same
    requests. `draw_items(n_items, size, generator, device)` draws the
    history pools' and the other candidates' items."""
    n_users, n_items = _vocab(model, "user"), _vocab(model, "item")
    n_cats = _vocab(model, "category")
    L = model["seq_len"]
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 2))
    kw = dict(generator=g, device=device)

    item_cat = torch.randint(0, n_cats, (n_items,), dtype=torch.int32, **kw)
    dim = traffic["world_dim"]
    user_pref = torch.randn(n_users, dim, **kw)
    cat_vec = torch.randn(n_cats, dim, **kw)

    user = torch.randint(0, n_users, (n,), dtype=torch.int32, **kw)
    lo, hi = traffic["hist_len"]
    hist_len = torch.randint(lo, hi + 1, (n,), dtype=torch.int32, **kw)
    hist = torch.empty((n, L), dtype=torch.int32, device=device)
    pool_n = traffic["history_pool"] * L
    for a in range(0, n, CHUNK):
        b = min(n, a + CHUNK)
        pool = draw_items(n_items, (b - a, pool_n), g, device)
        pref = user_pref[user[a:b].long()]
        aff = torch.einsum("ud,ukd->uk", pref, cat_vec[item_cat[pool.long()].long()])
        top = torch.topk(aff, L, dim=1).indices
        hist[a:b] = torch.gather(pool, 1, top)
    pad = torch.arange(L, device=device)[None] >= hist_len[:, None]
    hist.masked_fill_(pad, 0)
    hist_category = item_cat[hist.long()]

    ncand_d = candidate_counts(traffic, n, g, device)
    ncand = ncand_d.cpu().numpy()
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(ncand, out=offsets[1:])
    C = int(offsets[-1])
    cand_req = torch.repeat_interleave(torch.arange(n, device=device), ncand_d, output_size=C)
    from_hist = torch.rand(C, **kw) < traffic["from_history"]
    pick = (torch.rand(C, **kw) * hist_len[cand_req].to(torch.float32)).long()
    pick = torch.minimum(pick, hist_len[cand_req].long() - 1)
    other = draw_items(n_items, (C,), g, device)
    item = torch.where(from_hist, hist[cand_req, pick], other)
    return Requests(
        user=user, hist_item=hist, hist_category=hist_category, hist_len=hist_len,
        item=item, category=item_cat[item.long()], cand_req=cand_req, ncand=ncand,
        offsets=offsets, hist_len_host=hist_len.cpu().numpy().astype(np.int64),
    )


def poisson(rate: float, seconds: float, seed: int, mix: Optional[Dict] = None) -> np.ndarray:
    """Poisson arrival times in [0, seconds) at `rate` a second, from
    `seed`. The mix's `rate_profile`, a cycle of [seconds, factor] steps
    repeated over the window, scales the rate step by step (a burst);
    without one the rate is constant."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    profile = (mix or {}).get("rate_profile") or [[seconds, 1.0]]
    if any(len(p) != 2 or p[0] <= 0 or p[1] < 0 for p in profile):
        raise ValueError(f"rate_profile {profile!r}: steps of [seconds > 0, factor >= 0]")
    out, t0, k = [], 0.0, 0
    while t0 < seconds:
        length, factor = profile[k % len(profile)]
        t1 = min(seconds, t0 + length)
        count = rng.poisson(rate * factor * (t1 - t0))
        out.append(np.sort(rng.uniform(t0, t1, count)))
        t0, k = t1, k + 1
    return np.concatenate(out)


ARRIVALS = {"poisson": poisson}
