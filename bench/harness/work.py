"""The work the window's requests need, whatever implements it, and the
card's peaks it is held against.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates: HBM3 at
3.35 TB/s; f32 outside the tensor cores at 67 TFLOP/s (the configurations
state f32 with TF32 off, so no product may use the tensor cores' TF32).

Dot flops come from each configuration's own formula (`configs/<config>.
py:dot_flops`), 2 a multiply-add, counted from the requests: work that
the requests share is counted once.

Lookup bytes follow the rule of `repro_torch.kernels.work.
embedding_bag_work` (copied; nothing of the program is imported): each
distinct table row a call reads, read once; each id read once; each
output row written once. Counted as needed: a request's user and
history ids once for the request (not once per candidate row), a
history's positions up to its length only, and the candidates' own ids
and rows once per candidate. Distinct rows are counted per call and per
table, over every field that the table serves in that call.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
ID_BYTES = 4
VALUE_BYTES = 4


def field_dim(model: Dict, f: Dict) -> int:
    return f.get("dim") or model["embed_dim"]


def table_of(f: Dict) -> str:
    return f.get("shares") or f["name"]


def lookup_bytes(model: Dict, req, calls: List[tuple]) -> Dict[str, float]:
    """The bytes the lookups of `calls` need (see the module's docstring):
    {"rows", "ids", "outputs", "total"}. Each call is (..., first request,
    end request); `req` is the harness's `Requests`, on any device."""
    if not calls:
        return {"rows": 0.0, "ids": 0.0, "outputs": 0.0, "total": 0.0}
    dev = req.user.device
    first = np.asarray([c[5] for c in calls], np.int64)
    end = np.asarray([c[6] for c in calls], np.int64)
    n_req = end - first
    reqs = np.concatenate([np.arange(a, b) for a, b in zip(first, end)])
    call_of_req = np.repeat(np.arange(len(calls)), n_req)
    L = model["seq_len"]
    hlen = req.hist_len_host[reqs]
    ncand = req.ncand[reqs]
    n_cands = int(ncand.sum())
    valid = int(np.minimum(hlen, L).sum())
    reqs_d = torch.as_tensor(reqs, device=dev)
    call_d = torch.as_tensor(call_of_req, device=dev)
    cand_rows = torch.as_tensor(np.concatenate(
        [np.arange(req.offsets[a], req.offsets[b]) for a, b in zip(first, end)]), device=dev)
    cand_call = torch.as_tensor(np.repeat(call_of_req, ncand), device=dev)
    mask = torch.arange(L, device=dev)[None] < req.hist_len[reqs_d][:, None]

    ids = outputs = 0.0
    keys: Dict[str, List[torch.Tensor]] = {}
    dims: Dict[str, int] = {}
    for f in model["fields"]:
        d, role, tab = field_dim(model, f), f["role"], table_of(f)
        dims[tab] = d
        if role == "request":
            vals, calls_of = getattr(req, f["name"])[reqs_d], call_d
            ids += len(reqs) * ID_BYTES
            outputs += len(reqs) * d * VALUE_BYTES
        elif role == "history":
            h = getattr(req, f["name"])[reqs_d]
            vals = h[mask]
            calls_of = call_d[:, None].expand_as(h)[mask]
            ids += valid * ID_BYTES
            outputs += valid * d * VALUE_BYTES
        elif role == "candidate":
            vals, calls_of = getattr(req, f["name"])[cand_rows], cand_call
            ids += n_cands * ID_BYTES
            outputs += n_cands * d * VALUE_BYTES
        else:
            raise ValueError(f"field {f['name']}: unknown role {role!r}")
        vocab = {g["name"]: g["vocab"] for g in model["fields"]}[tab]
        keys.setdefault(tab, []).append(calls_of.long() * vocab + vals.long())
    rows = sum(float(torch.unique(torch.cat(k)).numel()) * dims[t] * VALUE_BYTES
               for t, k in keys.items())
    return {"rows": rows, "ids": ids, "outputs": outputs, "total": rows + ids + outputs}
