"""Shared neural-net layers for the LM family (port of `repro.models.layers`).

Pure functions over tensors, op for op `repro`'s `jnp` code. Where `repro`
asks XLA for an f32 product of bf16 operands (`preferred_element_type=
jnp.float32`) both operands are cast to f32 first: the product of two
bf16 values is exact in f32, so this is the same sum, never a bf16 matmul.
Every other product runs in its operands' dtype, as `repro`'s. A Python
float that scales a tensor is rounded to the tensor's dtype first
(`_scalar`), as JAX does with a weakly typed scalar.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives

_NEG = -1e30  # `repro`'s mask value


def _scalar(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`: what `x * value` multiplies by in JAX."""
    return float(torch.tensor(value, dtype=dtype))


def _f32_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.einsum(spec, a, b, preferred_element_type=jnp.float32)`."""
    return torch.einsum(spec, a.float(), b.float())


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)  # jnp.var: ddof 0
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def apply_norm(x, scale, norm_type: str):
    return rms_norm(x, scale) if norm_type == "rmsnorm" else layer_norm(x, scale)


# ---------------------------------------------------------------------------
# Rotary position embedding (full + fractional / "2d" GLM variant)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, fraction: float, theta: float, device=None):
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int). The
    rotation runs in f32 (bf16 times f32 promotes, as in `repro`) and is
    cast back to x's dtype."""
    head_dim = x.shape[-1]
    inv, rot = rope_freqs(head_dim, fraction, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv  # [..., seq, rot/2]
    cos = torch.cos(ang)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    # re-interleave
    out = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention — dense, KV-chunked (flash-style), decode, sparse decode
# ---------------------------------------------------------------------------


def dense_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Reference full attention. q: [B,S,K,G,hd] (GQA-grouped);
    k, v: [B,T,K,hd]. Returns [B,S,K,G,hd]."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    scale = _scalar(hd**-0.5, q.dtype)
    scores = _f32_einsum("bskgd,btkd->bkgst", q * scale, k)  # [B,K,G,S,T]
    if causal:
        qpos = torch.arange(S, device=q.device) + q_offset
        kpos = torch.arange(T, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]  # [S,T]
        scores = torch.where(mask[None, None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


def flash_attention(q, k, v, *, causal: bool, kv_chunk: int = 1024, q_offset: int = 0,
                    remat_step: bool = False):
    """KV-chunked streaming-softmax attention (the FlashAttention
    recurrence), a loop over key/value chunks carrying (running max,
    normalizer, weighted accumulator), so the live score buffer is
    [B,K,G,S,kv_chunk] instead of [B,K,G,S,T]. `remat_step` recomputes a
    chunk's scores in the backward (`torch.utils.checkpoint`, as `repro`'s
    `jax.checkpoint` of its scan step): memory, not numbers.

    q: [B,S,K,G,hd]; k, v: [B,T,K,hd]. Returns [B,S,K,G,hd]. T above
    `kv_chunk` must be a multiple of it, as in `repro`.
    """
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    if T <= kv_chunk:
        return dense_attention(q, k, v, causal=causal, q_offset=q_offset)
    if T % kv_chunk:
        raise ValueError(f"flash_attention: T={T} is not a multiple of kv_chunk={kv_chunk}")
    qs = q * _scalar(hd**-0.5, q.dtype)
    qpos = q_offset + torch.arange(S, device=q.device)  # global query positions

    def step(m, l, acc, kc, vc, t0: int):  # noqa: E741
        s = _f32_einsum("bskgd,btkd->bkgst", qs, kc)  # [B,K,G,S,c]
        if causal:
            kpos = t0 + torch.arange(kv_chunk, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]  # [S,c]
            s = torch.where(mask[None, None, None], s, _NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype), vc)
        return m_new, l_new, acc * alpha[..., None] + pv.float()

    if remat_step and torch.is_grad_enabled():
        plain = step

        def step(*args):
            return checkpoint(plain, *args, use_reentrant=False)

    m = torch.full((B, K, G, S), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)  # noqa: E741
    acc = torch.zeros((B, K, G, S, hd), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, kv_chunk):
        kc, vc = k[:, t0:t0 + kv_chunk], v[:, t0:t0 + kv_chunk]
        m, l, acc = step(m, l, acc, kc, vc, t0)  # noqa: E741
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return torch.movedim(out, 3, 1).to(q.dtype)  # [B,S,K,G,hd]


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token decode. q: [B,1,K,G,hd]; caches: [B,T,K,hd]; pos: [B]
    index of the current token (attends to <= pos)."""
    hd = q.shape[-1]
    T = k_cache.shape[1]
    scale = _scalar(hd**-0.5, q.dtype)
    scores = torch.einsum("bkgd,btkd->bkgt", q[:, 0] * scale, k_cache).float()
    valid = torch.arange(T, device=q.device)[None] <= pos[:, None]  # [B,T]
    scores = torch.where(valid[:, None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out[:, None]  # [B,1,K,G,hd]


def jnp_linspace(stop: float, n: int, device) -> torch.Tensor:
    """`jnp.linspace(0.0, stop, n)` in f32, bit for bit, as XLA computes it
    on the CPU, jitted or not: i times fl(stop · fl(1 / (n - 1))) (its
    `start·(1 - step) + stop·step` simplifies to that product), the last
    point `stop`. `torch.linspace` rounds some points the other way: at
    (5.0, 8) index 5 by 2.4e-7, and C2's global samples are floors of
    (1.0, n)'s."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    delta = np.float32(stop) * (np.float32(1.0) / np.float32(n - 1))
    out = torch.arange(n, dtype=torch.float32, device=device) * float(delta)
    out[-1] = float(np.float32(stop))
    return out


def _rows(cache, idx):
    """cache [B,T,...] at per-row positions idx [B,n] -> [B,n,...]."""
    return cache[torch.arange(cache.shape[0], device=cache.device)[:, None], idx]


def _sparse_keys(pos, T: int, window: int, n_global: int, device):
    """The C2 pattern's keys of each decode query: (positions [B, W+Gb],
    the trailing window's then the strided global samples', and which of
    them count: at or before pos, and a global sample not inside the
    window, whose keys the window holds already)."""
    B = pos.shape[0]
    # ---- trailing window from pos-window+1, clamped into the cache as
    # `jax.lax.dynamic_slice_in_dim` clamps its start ----
    start = torch.clamp(pos - window + 1, 0, T - window)  # [B]
    win_pos = start[:, None] + torch.arange(window, device=device)[None]  # [B,window]
    # ---- strided global samples over [0, pos]: n_global evenly spaced ----
    frac = jnp_linspace(1.0, n_global, device)
    gpos = torch.floor(frac[None] * torch.clamp(pos[:, None], min=1).float()).to(torch.int64)
    sel_pos = torch.cat([win_pos, gpos], dim=1)  # [B,W+Gb]
    valid = sel_pos <= pos[:, None]
    # avoid double-counting: global positions inside the window are masked
    in_window = sel_pos >= start[:, None]
    dup = torch.cat([torch.zeros((B, window), dtype=torch.bool, device=device),
                     in_window[:, window:]], dim=1)
    return sel_pos, valid & ~dup


def sparse_decode_attention(q, k_cache, v_cache, pos, *, window: int, n_global: int):
    """The paper's C2 hybrid sparse attention at decode time: full attention
    over the trailing `window` positions + `n_global` strided global samples
    (fixed sparse pattern, Formula 4 -> O(w + n_global) per token).

    q: [B,1,K,G,hd]; caches: [B,T,K,hd]; pos: [B].
    """
    hd = q.shape[-1]
    T = k_cache.shape[1]
    scale = _scalar(hd**-0.5, q.dtype)
    sel_pos, keep = _sparse_keys(pos, T, min(window, T), min(n_global, T), q.device)
    k_sp, v_sp = _rows(k_cache, sel_pos), _rows(v_cache, sel_pos)  # [B,W+Gb,K,hd]

    scores = torch.einsum("bkgd,btkd->bkgt", q[:, 0] * scale, k_sp).float()
    scores = torch.where(keep[:, None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v_sp.dtype), v_sp)
    return out[:, None]


def split_decode_attention(q, k_cache, v_cache, pos, *, t0: int, T: int, groups,
                           sparse: bool = False, window: int = 0, n_global: int = 0):
    """`decode_attention` (or, `sparse`, `sparse_decode_attention`) over a
    cache whose sequence is split across the ranks of `groups` (split-K
    flash-decode). k_cache, v_cache [B,T_loc,K,hd] hold this rank's keys,
    at global positions [t0, t0 + T_loc) of the cache's T; every key is
    masked by its global position. Each rank forms over its keys the max m,
    the sum l of exp(s - m) and the unnormalised output o (f32); the ranks
    combine them: the max of m, then l and o rescaled by exp(m - max) and
    summed. A rank without a key that counts has m = -inf, l = 0, o = 0
    and weighs 0 (no NaN). q: [B,1,K,G,hd]; pos: [B]. Returns
    [B,1,K,G,hd] in q's dtype, the same on every rank of `groups`."""
    hd = q.shape[-1]
    T_loc = k_cache.shape[1]
    scale = _scalar(hd**-0.5, q.dtype)
    if sparse:
        sel_pos, keep = _sparse_keys(pos, T, min(window, T), min(n_global, T), q.device)
        local = sel_pos - t0
        keep = keep & (local >= 0) & (local < T_loc)
        at = torch.clamp(local, 0, T_loc - 1)
        k_cache, v_cache = _rows(k_cache, at), _rows(v_cache, at)
    else:
        keep = (t0 + torch.arange(T_loc, device=q.device))[None] <= pos[:, None]  # [B,T_loc]
    s = torch.einsum("bkgd,btkd->bkgt", q[:, 0] * scale, k_cache).float()
    s = torch.where(keep[:, None, None], s, -torch.inf)
    m = torch.amax(s, dim=-1)  # [B,K,G]
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = torch.sum(p, dim=-1)  # noqa: E741
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    m_all = m.clone()
    for g in groups:
        collectives.max_in_place(m_all, g)
    w = torch.where(torch.isfinite(m), torch.exp(m - m_all), 0.0)
    l = collectives.sum_forward(l * w, groups)  # noqa: E741
    o = collectives.sum_forward(o * w[..., None], groups)
    return (o / l[..., None]).to(q.dtype)[:, None]


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def swiglu(x, w_gate, w_up, w_down):
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, w_down)
