"""Plain PyTorch version of the windowed-attention kernel: dense masked
attention (port of `repro.kernels.local_attention.ref`).

`local_attention_ref` is `repro`'s ref over [BH, L, dh] (or [B, H, L, dh],
as the wrapper calls it), with one more argument, `kv_len`: the keys
j < kv_len[r] of row r of the leading dimension are valid, the others
masked with -1e30 before the softmax. That is the key mask that
`repro`'s taobao_ssa encoder (`models/recsys/taobao_ssa.py:66-71`) puts
beside the window. A query row with no valid key at all (kv_len ≤ 0, or
i ≥ kv_len + window − 1) then gets the softmax of L equal scores, so its
output is the mean of v over all L positions, as in `repro`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sparse_attention import local_global_mask, masked_attention


def attention_mask(L: int, window: int, *, causal: bool = False,
                   kv_len: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """The valid (query, key) pairs: [L, L] without `kv_len`, [BH, L, L] with it."""
    mask = local_global_mask(L, window, 0, causal=causal, device=device)
    if kv_len is None:
        return mask
    keys = torch.arange(L, device=device)[None] < kv_len[:, None]  # [BH, L]
    return mask[None] & keys[:, None, :]


def local_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
                        causal: bool = False,
                        kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q,k,v: [BH, L, dh] with kv_len int [BH] or None -> [BH, L, dh]; or
    q,k,v: [B, H, L, dh] views with kv_len int [B] or None -> [B, H, L, dh]."""
    mask = attention_mask(q.shape[-2], window, causal=causal, kv_len=kv_len, device=q.device)
    if mask.ndim == 3:
        mask = mask[:, None]  # [N, 1, L, L] against the scores [N, H or 1, L, L]
    if q.ndim == 4:
        return masked_attention(q, k, v, mask)
    return masked_attention(q[:, None], k[:, None], v[:, None], mask)[:, 0]
