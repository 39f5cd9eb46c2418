"""LM-family transformer: dense + MoE, GQA + RoPE, train/prefill/decode
(port of `repro.models.transformer`).

One code path serves all five LM architectures. Parameters keep `repro`'s
stacked [L, ...] layout, so weights carry across unchanged; `repro`'s
`jax.lax.scan` over the stack is a loop over layer slices here. Workloads:

  loss(params, batch, cfg)                 -> scalar CE (+ MoE aux), metrics
  prefill(params, tokens, cfg)             -> (last_logits, kv_cache)
  decode(params, cache, token, pos, cfg)   -> (logits, new_cache)

The ParamDefs carry `repro`'s logical axes (`models/common.param_pspecs`).
`trunk`'s `mesh` reaches the MoE layers' expert-parallel dispatch, as
`repro`'s rules argument does; `repro`'s `constrain` calls, which GSPMD
propagates over the rest of the forward, have no counterpart yet, so
`trunk` refuses a mesh of more than one rank: its attention, RoPE and loss
would see only this rank's block of the tokens.
`cfg.remat` recomputes each layer in the backward (`torch.utils.checkpoint`,
non-reentrant), as `repro`'s `jax.checkpoint` of its scan body: memory,
not numbers. `decode` is
functional as `repro`'s: it copies the caches once and writes the new
token's keys and values into the copy.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.distributed.expert_parallel import moe_ffn_ep
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import ParamDef, tree_map
from repro_torch.models.layers import (
    apply_norm,
    apply_rope,
    decode_attention,
    dense_attention,
    flash_attention,
    sparse_decode_attention,
    swiglu,
)

# `repro`'s full mesh, 512 chips (also divisible into the 256-chip single
# pod): a weight is FSDP-sharded on its first dim that this divides, and
# `pad_vocab` rounds V up to a multiple of it.
_FSDP_WAYS = 512


def _dtype(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _mm(x, w):
    """Representation-dispatched matmul over the last axis of x: a dense
    tensor, or C5 int8 {"q": int8 [din,dout], "s": f32 [dout]}, dequantized
    in bf16 (as `repro`) before the product."""
    if isinstance(w, dict):
        deq = w["q"].to(torch.bfloat16) * w["s"].to(torch.bfloat16)[None, :]
        return torch.matmul(x, deq.to(x.dtype))
    return torch.matmul(x, w)


def _take_rows(table, tokens):
    """Embedding gather over dense or int8 {"q","s"} tables (per-row scales;
    dequantized AFTER the gather)."""
    if isinstance(table, dict):
        q = table["q"][tokens]
        s = table["s"][tokens]
        return q.float() * s[..., None]
    return table[tokens]


def _moe_layout(cfg: LMConfig) -> Tuple[int, int, int]:
    """(n_super, n_dense_per_super, n_moe_per_super)."""
    if cfg.n_experts == 0:
        return cfg.n_layers, 1, 0
    if cfg.moe_interleave == 1:
        return cfg.n_layers, 0, 1
    if cfg.moe_interleave != 2 or cfg.n_layers % 2:
        raise ValueError(f"moe_interleave={cfg.moe_interleave} over {cfg.n_layers} layers")
    return cfg.n_layers // 2, 1, 1


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------


def _fsdp_axes(shape, candidates):
    """Put 'fsdp' on the first candidate dim divisible by the full mesh
    (a sharded dim must divide exactly); replicate if none fits."""
    axes = [None] * len(shape)
    for dim in candidates:
        if shape[dim] % _FSDP_WAYS == 0:
            axes[dim] = "fsdp"
            break
    return tuple(axes)


def _wdef(shape, dt, serve_axes):
    """A stacked [L, ...] weight: FSDP on dim 1 or 2 in training, TP-style
    `serve_axes` in serving."""
    return ParamDef(shape, dt, "fan_in", axes=("layers",) + _fsdp_axes(shape[1:], (0, 1)),
                    serve_axes=serve_axes)


def param_defs(cfg: LMConfig) -> Dict:
    dt = _dtype(cfg)
    D, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    L, V, F_ = cfg.n_layers, cfg.vocab_size, cfg.d_ff
    row_parallel = ("layers", "tp_in", None)

    attn = {
        "attn_norm": ParamDef((L, D), dt, "ones", axes=("layers", None)),
        "wq": _wdef((L, D, H * hd), dt, row_parallel),
        "wk": _wdef((L, D, K * hd), dt, row_parallel),
        "wv": _wdef((L, D, K * hd), dt, row_parallel),
        "wo": _wdef((L, H * hd, D), dt, row_parallel),
    }
    if cfg.use_bias:
        attn["bq"] = ParamDef((L, H * hd), dt, "zeros", axes=("layers", None))
        attn["bk"] = ParamDef((L, K * hd), dt, "zeros", axes=("layers", None))
        attn["bv"] = ParamDef((L, K * hd), dt, "zeros", axes=("layers", None))
    if not cfg.parallel_block:
        attn["ffn_norm"] = ParamDef((L, D), dt, "ones", axes=("layers", None))

    n_super, n_dense, n_moe = _moe_layout(cfg)
    defs: Dict = {"attn": attn}
    if n_dense:
        Ld = n_super * n_dense if cfg.n_experts == 0 else n_super
        defs["ffn"] = {
            "w_gate": _wdef((Ld, D, F_), dt, ("layers", None, "ff")),
            "w_up": _wdef((Ld, D, F_), dt, ("layers", None, "ff")),
            "w_down": _wdef((Ld, F_, D), dt, row_parallel),
        }
    if n_moe:
        defs["moe"] = moe_lib.moe_param_defs(cfg, n_super, dt)

    if cfg.pad_vocab:
        V = -(-V // _FSDP_WAYS) * _FSDP_WAYS
    emb_axes = _fsdp_axes((V, D), (0, 1))
    defs["embed"] = ParamDef((V, D), dt, "embed", axes=emb_axes, serve_axes=("vocab", None))
    defs["final_norm"] = ParamDef((D,), dt, "ones", axes=(None,))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((V, D), dt, "embed", axes=emb_axes,
                                   serve_axes=("vocab", None))
    return defs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _project_qkv(x, p, cfg: LMConfig, positions):
    """x: [B,S,D] -> q [B,S,K,G,hd] (rope'd), k,v [B,S,K,hd] (rope'd k)."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G = H // K
    q = _mm(x, p["wq"])
    k = _mm(x, p["wk"])
    v = _mm(x, p["wv"])
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q.reshape(B, S, K, G, hd), k, v


def _attention_train(x, p, cfg: LMConfig):
    """Full-sequence attention (train/prefill). Returns (attn_out, (k, v))."""
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(x, p, cfg, positions)
    if cfg.attn_impl == "dense":
        out = dense_attention(q, k, v, causal=True)
    else:
        out = flash_attention(q, k, v, causal=True, kv_chunk=cfg.q_chunk,
                              remat_step=cfg.flash_remat)
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
    return _mm(out, p["wo"]), (k, v)


def _attention_decode(x, p, cfg: LMConfig, k_cache, v_cache, pos):
    """One-token decode. x: [B,1,D]; caches [B,T,K,hd], written in place at
    `pos` (clamped into the cache, as `dynamic_update_slice` clamps)."""
    B = x.shape[0]
    T = k_cache.shape[1]
    q, k_new, v_new = _project_qkv(x, p, cfg, pos[:, None])
    rows = torch.arange(B, device=x.device)
    at = torch.clamp(pos, 0, T - 1)
    k_cache[rows, at] = k_new[:, 0]
    v_cache[rows, at] = v_new[:, 0]

    if cfg.sparse_attention:
        out = sparse_decode_attention(q, k_cache, v_cache, pos, window=cfg.attn_window,
                                      n_global=cfg.attn_n_global)
    else:
        out = decode_attention(q, k_cache, v_cache, pos)
    out = out.reshape(B, 1, cfg.n_heads * cfg.resolved_head_dim)
    return _mm(out, p["wo"]), (k_cache, v_cache)


def _ffn_dense(x, p):
    if any(isinstance(p[k], dict) for k in ("w_gate", "w_up", "w_down")):
        g = _mm(x, p["w_gate"])
        u = _mm(x, p["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
        return _mm(h, p["w_down"])
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _layer(x, attn_p, ffn_p, moe_p, cfg: LMConfig, decode_state=None, stats=None, mesh=None):
    """One transformer layer. decode_state: None | (k_cache, v_cache, pos).
    `stats` collects the MoE dispatch's record (see `prefill`); `mesh`
    reaches the expert-parallel dispatch (see `trunk`)."""
    h = apply_norm(x, attn_p["attn_norm"], cfg.norm_type)
    if decode_state is None:
        attn_out, kv = _attention_train(h, attn_p, cfg)
    else:
        attn_out, kv = _attention_decode(h, attn_p, cfg, *decode_state)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.parallel_block:
        # command-r: shared-norm parallel attention + FFN
        if moe_p is not None:
            raise ValueError("parallel_block with MoE is used by no LM arch")
        x = x + attn_out + _ffn_dense(h, ffn_p)
    else:
        x = x + attn_out
        h2 = apply_norm(x, attn_p["ffn_norm"], cfg.norm_type)
        if moe_p is not None:
            # decode (tiny token counts) takes the plain dispatcher; train
            # and prefill the expert-parallel one, as `repro`
            if cfg.moe_impl == "ep" and decode_state is None:
                ffn_out, aux = moe_ffn_ep(h2, moe_p, cfg, stats, mesh=mesh)
            else:
                ffn_out, aux = moe_lib.moe_ffn(h2, moe_p, cfg, stats)
        else:
            ffn_out = _ffn_dense(h2, ffn_p)
        x = x + ffn_out
    return x, kv, aux


def _layers(params, cfg: LMConfig) -> Iterator[Tuple[Dict, Dict, Dict]]:
    """(attn, ffn, moe) parameter slices of each layer in order; ffn or moe
    None where the layer has none. With `moe_interleave=2` (llama4) layer
    2i is dense with ffn[i] and layer 2i+1 routed with moe[i]."""
    n_super, n_dense, n_moe = _moe_layout(cfg)
    per_super = n_dense + n_moe if cfg.n_experts else 1
    at = lambda tree, i: None if tree is None else tree_map(lambda a: a[i], tree)  # noqa: E731
    for i in range(n_super):
        for j in range(per_super):
            attn = at(params["attn"], i * per_super + j)
            if cfg.n_experts == 0:
                yield attn, at(params["ffn"], i), None
            elif cfg.moe_interleave == 1:
                yield attn, None, at(params["moe"], i)
            elif j == 0:
                yield attn, at(params["ffn"], i), None
            else:
                yield attn, None, at(params["moe"], i)


# ---------------------------------------------------------------------------
# Trunk: embedding -> layers -> final norm
# ---------------------------------------------------------------------------


def trunk(params, tokens, cfg: LMConfig, stats=None, mesh=None):
    """tokens [B,S] -> hidden [B,S,D], aux loss, kv caches [L,B,S,K,hd]x2.
    `mesh` (a DeviceMesh), where given, reaches every MoE layer's
    `moe_ffn_ep`, as `repro`'s rules do; None is the one-group path. A
    mesh of more than one rank is refused until the whole forward is
    partitioned (module docstring)."""
    if mesh is not None and mesh.size() > 1:
        raise ValueError(f"trunk runs on a mesh of one rank; this one has {mesh.size()} "
                         f"({dict(zip(mesh.mesh_dim_names, mesh.shape))}): the forward "
                         "outside the MoE dispatch is not partitioned across ranks")
    x = _take_rows(params["embed"], tokens).to(_dtype(cfg))
    remat = cfg.remat and cfg.remat_policy != "none" and torch.is_grad_enabled()
    ks, vs, aux = [], [], torch.zeros((), dtype=torch.float32, device=x.device)
    for attn_p, ffn_p, moe_p in _layers(params, cfg):
        if remat:  # `repro`'s "dots" policy saves the matmuls; both recompute the rest
            x, (k, v), a = checkpoint(_layer, x, attn_p, ffn_p, moe_p, cfg, None, stats, mesh,
                                      use_reentrant=False)
        else:
            x, (k, v), a = _layer(x, attn_p, ffn_p, moe_p, cfg, None, stats, mesh)
        ks.append(k)
        vs.append(v)
        aux = aux + a
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    return x, aux, (torch.stack(ks), torch.stack(vs))


# ---------------------------------------------------------------------------
# Losses / steps
# ---------------------------------------------------------------------------


def _output_table(params):
    return params.get("lm_head", params["embed"])


def _logits(x, table):
    """x [B,S,D] against the output table -> f32 [B,S,V], an f32 product of
    the operands (`preferred_element_type=jnp.float32`)."""
    if isinstance(table, dict):
        deq = table["q"].to(torch.bfloat16) * table["s"].to(torch.bfloat16)[:, None]
        table = deq.to(x.dtype)
    return torch.einsum("bsd,vd->bsv", x.float(), table.float())


def chunked_cross_entropy(x, table, labels, n_chunks: int = 8):
    """Streaming-logsumexp CE over vocab chunks; avoids the [B,S,V] buffer.

    x: [B,S,D]; table: [V,D]; labels: [B,S] int. Returns mean CE.
    """
    B, S, D = x.shape
    V = table.shape[0]
    while V % n_chunks:
        n_chunks //= 2
    vc = V // n_chunks
    labels = labels.long()
    xf = x.float()

    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=x.device)  # noqa: E741
    dot = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        v0 = c * vc
        logits = torch.einsum("bsd,vd->bsv", xf, table[v0:v0 + vc].float())
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        l = l * torch.exp(m - m_new) + torch.sum(p, -1)  # noqa: E741
        local = labels - v0
        in_c = (local >= 0) & (local < vc)
        picked = torch.gather(logits, -1, torch.clamp(local, 0, vc - 1)[..., None])[..., 0]
        dot = dot + torch.where(in_c, picked, 0.0)
        m = m_new
    ce = (m + torch.log(torch.clamp(l, min=1e-30))) - dot
    return torch.mean(ce)


def loss(params, batch, cfg: LMConfig, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE + MoE load-balance aux."""
    x, aux, _ = trunk(params, batch["tokens"], cfg, mesh=mesh)
    ce = chunked_cross_entropy(x, _output_table(params), batch["labels"])
    total = ce + 0.01 * aux
    return total, {"ce": ce, "aux": aux}


def prefill(params, tokens, cfg: LMConfig, stats=None, mesh=None):
    """Full-sequence forward; returns last-position logits + KV caches.
    `stats`, a dict, collects each MoE layer's dispatch record: the entries
    dropped at `moe_ffn_ep`'s two capacity stages, or `moe_ffn`'s under
    `moe_impl="gspmd"` (see those): a record, not an output."""
    x, _, (k_all, v_all) = trunk(params, tokens, cfg, stats, mesh)
    logits = _logits(x[:, -1:, :], _output_table(params))
    return logits[:, 0], (k_all, v_all)


def decode(params, cache, token, pos, cfg: LMConfig, stats=None):
    """One decode step. cache: (k [L,B,T,K,hd], v [L,B,T,K,hd]);
    token: [B] int; pos: [B] current positions. Returns (logits, cache),
    the cache a new pair of tensors (the arguments are not modified).
    `stats`: as `prefill`'s; decode takes `moe_ffn`."""
    k_out, v_out = (c.clone() for c in cache)
    x = _take_rows(params["embed"], token[:, None]).to(_dtype(cfg))
    for i, (attn_p, ffn_p, moe_p) in enumerate(_layers(params, cfg)):
        x, _, _ = _layer(x, attn_p, ffn_p, moe_p, cfg, (k_out[i], v_out[i], pos), stats)
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    logits = _logits(x, _output_table(params))
    return logits[:, 0], (k_out, v_out)


# ---------------------------------------------------------------------------
# Cache shapes
# ---------------------------------------------------------------------------


def cache_shape(cfg: LMConfig, batch: int, seq_len: int):
    hd = cfg.resolved_head_dim
    return (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, hd)


def cache_axes(cfg: LMConfig, long_context: bool):
    """The KV cache's logical axes: split-K over the sequence at decode,
    over ("data", "model") for a 500k context of batch 1."""
    kv = "long_kv_seq" if long_context else "kv_seq"
    return ("layers", "batch", kv, "kv_heads", "head_dim")
