"""Mixture-of-Experts layer: top-k router + sort-based (dropping) dispatch
(port of `repro.models.moe`).

Dispatch: flatten tokens, replicate each token top_k times, sort the
(token, expert) entries by expert id (a stable sort, as XLA's), truncate
each expert's queue at a static capacity C = max(8, ceil(top_k * T / E *
capacity_factor)), run the expert FFNs as one batched einsum over the
[E, C, D] buffer, and scatter results back weighted by the router
probabilities. `repro`'s `.at[slot].set(..., mode="drop")` is a write into
a buffer with one extra row, the drop row, which is sliced off: no index
is ever out of range. `repro` sends train and prefill through the
expert-parallel dispatch (`distributed/expert_parallel.moe_ffn_ep`) and
decode through this one; the capacities differ, so at a small capacity
factor the two drop different entries.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef
from repro_torch.models.layers import swiglu


def moe_param_defs(cfg, n_moe_layers: int, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    L = n_moe_layers
    expert_axes = ("layers", "experts", "expert_dp", None)
    expert_serve_axes = ("layers", "experts", "moe_in", None)
    defs = {
        "router": ParamDef((L, d, e), dtype, "fan_in", axes=("layers", None, None)),
        "w_gate": ParamDef((L, e, d, f), dtype, "fan_in", axes=expert_axes,
                           serve_axes=expert_serve_axes),
        "w_up": ParamDef((L, e, d, f), dtype, "fan_in", axes=expert_axes,
                         serve_axes=expert_serve_axes),
        "w_down": ParamDef((L, e, f, d), dtype, "fan_in", axes=expert_axes,
                           serve_axes=expert_serve_axes),
    }
    if cfg.n_shared_experts:
        s = cfg.n_shared_experts * f
        shared_axes = ("layers", "expert_dp", None)
        defs["shared_gate"] = ParamDef((L, d, s), dtype, "fan_in", axes=shared_axes,
                                       serve_axes=("layers", None, "ff"))
        defs["shared_up"] = ParamDef((L, d, s), dtype, "fan_in", axes=shared_axes,
                                     serve_axes=("layers", None, "ff"))
        defs["shared_down"] = ParamDef((L, s, d), dtype, "fan_in", axes=shared_axes,
                                       serve_axes=("layers", "tp_in", None))
    return defs


def capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = math.ceil(top_k * n_tokens / n_experts * factor)
    return max(8, int(c))


def route(xt, router, n_experts: int, top_k: int):
    """Router of both dispatchers: (gate [T,K] renormalised, expert ids
    [T,K], the Switch-style load-balancing aux loss). `torch.topk` breaks
    ties as it likes where `lax.top_k` takes the lower index."""
    logits = torch.matmul(xt, router).float()
    probs = torch.softmax(logits, dim=-1)  # [T,E]
    gate, expert_idx = torch.topk(probs, top_k, dim=-1)  # [T,K]
    gate = gate / torch.clamp(torch.sum(gate, dim=-1, keepdim=True), min=1e-9)
    me = torch.mean(probs, dim=0)  # mean router prob per expert
    ce = torch.mean(torch.sum(F.one_hot(expert_idx, n_experts).float(), dim=1), dim=0)
    aux = n_experts * torch.sum(me * ce)
    return gate, expert_idx, aux


def scatter_rows(n_rows: int, slot, rows):
    """[n_rows, D] zeros with `rows[i]` written at `slot[i]`; a slot of
    `n_rows` or more is dropped (`.at[slot].set(rows, mode="drop")`)."""
    buf = rows.new_zeros((n_rows + 1, rows.shape[-1]))
    return buf.index_put((torch.clamp(slot, max=n_rows),), rows)[:n_rows]


def expert_ffn(buf, w_gate, w_up, w_down):
    """buf [E,C,D] through each expert's SwiGLU -> [E,C,D]."""
    g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    u = torch.einsum("ecd,edf->ecf", buf, w_up)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.einsum("ecf,efd->ecd", h, w_down)


def dispatch(xt, router, cfg, stats=None):
    """`moe_ffn`'s routing and sort-based dispatch of tokens xt [T, D]:
    (buffer [E, C, D] of each expert's queue, entry_slot [T*K] each (token,
    k) entry's row of the flattened buffer or -1 where it was dropped,
    gate [T, K], aux). `stats` as `moe_ffn`'s."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(T, E, K, cfg.capacity_factor)
    gate, expert_idx, aux = route(xt, router, E, K)

    # ---- sort-based dispatch with static capacity ----
    flat_e = expert_idx.reshape(-1)  # [T*K] token-major
    order = torch.argsort(flat_e, stable=True)  # XLA's sort is stable for equal keys
    sorted_e = flat_e[order]
    first_of_e = torch.searchsorted(sorted_e, sorted_e, right=False)
    pos_in_e = torch.arange(T * K, device=xt.device) - first_of_e  # rank within expert queue
    kept = pos_in_e < C
    buf_slot = torch.where(kept, sorted_e * C + pos_in_e, E * C)  # E*C = drop bin
    sorted_tok = order // K
    if stats is not None:
        stats.setdefault("dropped", []).append(torch.sum(~kept))
        chosen = torch.zeros(E, dtype=torch.bool, device=xt.device).index_fill_(0, flat_e, True)
        stats.setdefault("experts", []).append(torch.sum(chosen))

    buffer = scatter_rows(E * C, buf_slot, xt[sorted_tok]).reshape(E, C, D)
    entry_slot = torch.empty_like(buf_slot)
    entry_slot[order] = torch.where(kept, buf_slot, -1)
    return buffer, entry_slot, gate, aux


def combine(out_buf, entry_slot, gate):
    """Each (token, k) entry reads back its row of out_buf [E*C, D] (zeros
    where it was dropped), weighted by its gate [T, K] and summed over k:
    [T, D]."""
    T, K = gate.shape
    entry_out = torch.where(
        (entry_slot >= 0)[:, None],
        out_buf[torch.clamp(entry_slot, min=0)],
        torch.zeros((), dtype=out_buf.dtype, device=out_buf.device),
    )  # [T*K, D]
    weighted = entry_out.reshape(T, K, -1) * gate[..., None].to(out_buf.dtype)
    return torch.sum(weighted, dim=1)


def moe_ffn(x, layer_params, cfg, stats=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> ([B, S, D], aux_loss scalar).

    layer_params holds this layer's slices: router [D,E], w_* [E,D,F].
    `stats`, if a dict, gets appended under "dropped" the entries this
    call dropped at capacity and under "experts" the experts its tokens
    chose (tensors, read by the caller when it likes): a record, which
    changes no output.
    """
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    buffer, entry_slot, gate, aux = dispatch(xt, layer_params["router"], cfg, stats)

    # ---- expert FFNs: batched einsum over the expert dim ----
    out_buf = expert_ffn(buffer, layer_params["w_gate"], layer_params["w_up"],
                         layer_params["w_down"]).reshape(-1, D)
    out = combine(out_buf, entry_slot, gate)

    # ---- shared expert (always-on, like a dense FFN) ----
    if "shared_gate" in layer_params:
        out = out + swiglu(xt, layer_params["shared_gate"], layer_params["shared_up"],
                           layer_params["shared_down"])
    return out.reshape(B, S, D), aux
