"""Factorization Machine [Rendle ICDM'10] (port of `repro.models.recsys.fm`).

logit = w0 + Σᵢ wᵢ + ½ Σ_d [(Σᵢ vᵢ)² − Σᵢ vᵢ²]_d   (the O(nk) sum-square trick)

The factors come from one unified-table lookup and the first-order term is
an EmbeddingBag of the example's 39 ids into the 1-wide table, both through
the EmbeddingBag kernel for an f32 table. The second-order term goes
through the Hopper FM interaction kernel (`kernels/fm_interaction`), whose
plain version is `repro`'s `fm_interaction`.

Every entry point takes `repro`'s `rules` (None: one rank); across ranks
only the lookups (`embedding.py`: the 1-wide table is split by rows as the
factors are) and the loss's mean exchange data, and the interaction works
row by row on this rank's block of the batch (or of the candidates), so
`repro`'s `constrain`s of its outputs already hold.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.kernels.fm_interaction.ops import fm_interaction_op
from repro_torch.models.common import ParamDef
from repro_torch.models.recsys.embedding import (
    _take_rows,
    embedding_bag,
    unified_lookup,
    unified_offsets,
    unified_table_def,
)
from repro_torch.models.recsys.rec_layers import bce_with_logits


def param_defs(cfg: RecSysConfig):
    return {
        "table": unified_table_def(cfg),  # [rows, k] second-order factors
        "linear": unified_table_def(cfg, extra_dim=1),  # [rows, 1] first-order
        "bias": ParamDef((), torch.float32, "zeros", axes=()),
    }


def fm_interaction(e: torch.Tensor) -> torch.Tensor:
    """e: [B, F, k] -> [B] second-order term via the sum-square identity."""
    return fm_interaction_op(e.contiguous())


def logits(params, batch, cfg: RecSysConfig, rules=None):
    idx = batch["sparse_idx"]  # [B, F] local ids
    e = unified_lookup(params["table"], idx, cfg, rules)  # [B,F,k]
    offs = torch.as_tensor(unified_offsets(cfg), dtype=torch.int32, device=idx.device)
    rows = idx + offs[None, :]
    first = embedding_bag(params["linear"], rows, rules=rules)[:, 0]  # [B]
    return params["bias"] + first + fm_interaction(e)


def loss(params, batch, cfg: RecSysConfig, rules=None):
    lg = logits(params, batch, cfg, rules)
    b = bce_with_logits(lg, batch["label"], rules)
    return b, {"bce": b}


def serve(params, batch, cfg: RecSysConfig, rules=None):
    return torch.sigmoid(logits(params, batch, cfg, rules))


def retrieval(params, query, cand_ids, cfg: RecSysConfig, rules=None):
    """Score one query against N candidates of the designated candidate
    field (largest-vocab field). FM factorizes: score(c) = const +
    ⟨Σ_{f≠c} v_f, v_c⟩ + w_c, so it is one [N,k] @ [k] batched dot."""
    cand_field = max(range(len(cfg.fields)), key=lambda i: cfg.fields[i].vocab)
    offs = unified_offsets(cfg)

    idx = query["sparse_idx"]  # [1, F] — candidate slot ignored
    e = unified_lookup(params["table"], idx, cfg, rules)[0]  # [F,k]
    mask = torch.arange(e.shape[0], device=e.device) != cand_field
    e_user = torch.sum(e * mask[:, None], dim=0)  # [k]

    rows = cand_ids + int(offs[cand_field])
    v_c = _take_rows(params["table"], rows, rules, "candidates")  # [N,k], this rank's block
    w_c = _take_rows(params["linear"], rows, rules, "candidates")[:, 0]

    dot = v_c @ e_user
    # (e_u+v_c)² − (sq_u+v_c²) = (e_u²−sq_u) + 2⟨e_u,v_c⟩ — v_c² cancels.
    sq_u = torch.sum(torch.square(e * mask[:, None]), dim=0)
    const = 0.5 * torch.sum(torch.square(e_user) - sq_u)
    return const + dot + w_c
