"""C2 — hybrid sparse attention (port of `repro.core.sparse_attention`,
paper §III.A, Formula 4).

Full attention inside a local window w ≪ L plus fixed or random global
samples: nonzeros O(L·w) or O(L·log L), compute O(Lwd + L·logL·d). The
taobao_ssa encoder applies the window with its key mask through the
windowed-attention kernel (`kernels/local_attention`), whose plain version
is `windowed_attention` below with that key mask added.

The strided global pattern (`seed=None`) is `repro`'s bit for bit: the same
float32 `linspace` arithmetic, truncated to int. A seeded pattern draws its
columns from a `torch.Generator`, whose stream is not JAX's: it has the same
properties (`n_global` distinct columns), not the same columns.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _strided_columns(L: int, n_global: int) -> torch.Tensor:
    """`jnp.linspace(0, L-1, n_global).astype(int32)` as XLA computes it on
    the CPU: `i * ((L-1) * (1/div))` in float32 for i < div (XLA turns the
    division by the constant `div` into a product with its reciprocal and
    reassociates), then `L-1` itself, truncated toward 0."""
    if n_global == 1:
        return torch.zeros(1, dtype=torch.int64)
    div = n_global - 1
    f32 = torch.float32
    stop = torch.tensor(L - 1, dtype=f32)
    scale = stop * (torch.tensor(1.0, dtype=f32) / torch.tensor(div, dtype=f32))
    out = torch.cat([torch.arange(div, dtype=f32) * scale, stop[None]])
    return out.to(torch.int64)


def local_global_mask(
    L: int, window: int, n_global: int = 0, *, causal: bool = False,
    seed: Optional[int] = None, device=None,
) -> torch.Tensor:
    """[L, L] boolean mask: |i−j| < window, plus n_global sampled key
    columns attendable from everywhere (fixed strided pattern by default,
    random with a seed — the paper allows either)."""
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    m = (i - j).abs() < window
    if n_global:
        if seed is None:
            cols = _strided_columns(L, n_global)
        else:
            gen = torch.Generator().manual_seed(seed)
            cols = torch.randperm(L, generator=gen)[:n_global]
        m = m | torch.isin(j, cols.to(j.device))
    if causal:
        m = m & (j <= i)
    return m


def masked_attention(q, k, v, mask) -> torch.Tensor:
    """Reference dense-masked attention. q,k,v: [B,H,L,dh]; mask [L,L] or
    any shape that broadcasts to the scores [B,H,L,L]."""
    dh = q.shape[-1]
    s = torch.einsum("bhld,bhmd->bhlm", q, k) / math.sqrt(dh)
    if mask.ndim == 2:
        mask = mask[None, None]
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s.to(torch.float32), dim=-1).to(v.dtype)
    return torch.einsum("bhlm,bhmd->bhld", p, v)


def windowed_attention(q, k, v, window: int, *, causal: bool = False) -> torch.Tensor:
    """Pure local-window attention — plain version of kernels/local_attention.
    q,k,v: [B,H,L,dh]."""
    L = q.shape[2]
    return masked_attention(q, k, v, local_global_mask(L, window, 0, causal=causal,
                                                       device=q.device))


def hybrid_sparse_attention(
    q, k, v, *, window: int, n_global: int = 0, causal: bool = False,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """The paper's full C2 pattern (window + sampled globals)."""
    L = q.shape[2]
    mask = local_global_mask(L, window, n_global, causal=causal, seed=seed, device=q.device)
    return masked_attention(q, k, v, mask)


def attention_flops(L: int, d: int, window: int, n_global: int) -> dict:
    """Formula-4 accounting: dense O(L²d) vs sparse O(Lwd + L·ng·d)."""
    dense = 4 * L * L * d
    sparse = 4 * L * (min(window, L) + n_global) * d
    return {"dense": dense, "sparse": sparse, "ratio": sparse / dense}
