"""Expert-parallel MoE dispatch (port of `repro.distributed.expert_parallel`)
on one device.

`repro`'s `moe_ffn_ep` is a shard_map over the expert axis:

  local top-k routing
   -> sort entries by target expert group (model-axis device)
   -> capacity-bounded send buffers            [n_groups, C_pair, D]
   -> all_to_all over the expert axis
   -> local per-expert grouping (second sort)  [E_loc, C_e, D]
   -> batched expert FFN
   -> inverse scatter -> all_to_all back -> weighted combine.

This module computes it as `repro` does on its one-device mesh: one group
(`n_groups = 1`, `E_loc = E`), where `all_to_all` and the weights'
`all_gather` are identities and the aux loss's `pmean` is the value
itself, while both capacity stages (`C_pair`, then `C_e` per expert) still
apply and drop what they drop there. The exchange across ranks comes with
the `torch.distributed` slice; nothing here stands in for absent ranks.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.moe import expert_ffn, route, scatter_rows


def _sort_dispatch(keys: torch.Tensor, n_bins: int, capacity: int):
    """entries -> (slot, kept): slot = bin*capacity + rank within bin
    (rank >= capacity dropped). keys: [N] int in [0, n_bins]; a key of
    n_bins ranks in a bin of its own past the last."""
    order = torch.argsort(keys, stable=True)  # XLA's sort is stable for equal keys
    sorted_keys = keys[order]
    first = torch.searchsorted(sorted_keys, sorted_keys, right=False)
    rank = torch.arange(keys.shape[0], device=keys.device) - first
    kept = rank < capacity
    slot_sorted = torch.where(kept, sorted_keys * capacity + rank, n_bins * capacity)
    # scatter slot back to entry order (`order` is a permutation)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    kept_e = torch.empty_like(kept)
    kept_e[order] = kept
    return slot, kept_e


def _capacity(n: int, bins: int, cf: float) -> int:
    return max(4, math.ceil(n / bins * cf))


def moe_ffn_ep(x, layer_params, cfg, stats=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN in one group. x: [B, S, D]. Returns (out,
    aux). `stats`, if a dict, gets appended the entries this call dropped
    at each capacity stage, under "dropped_pair" (the send buffers' C_pair)
    and "dropped_expert" (the experts' C_e) (tensors, read by the caller
    when it likes): a record, which changes no output."""
    n_groups = 1
    E, K, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    E_loc = E // n_groups
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)

    # ---- routing ----
    gate, eidx, aux = route(xt, layer_params["router"], E, K)

    # ---- stage 1: entries -> expert-group send buffers ----
    flat_e = eidx.reshape(-1)  # [T*K]
    group = torch.div(flat_e, E_loc, rounding_mode="floor")
    C_pair = _capacity(T * K, n_groups, cf)
    slot, kept = _sort_dispatch(group, n_groups, C_pair)
    tok = torch.div(torch.arange(T * K, device=x.device), K, rounding_mode="floor")

    send_x = scatter_rows(n_groups * C_pair, slot, xt[tok])
    send_e = torch.full((n_groups * C_pair + 1,), -1, dtype=flat_e.dtype, device=x.device)
    send_e = send_e.index_put((torch.clamp(slot, max=n_groups * C_pair),),
                              flat_e - group * E_loc)[:n_groups * C_pair]

    # ---- the all_to_all to the expert owners: one group, the identity ----
    recv_x, recv_e = send_x, send_e

    # ---- stage 2: group received tokens by local expert ----
    R = n_groups * C_pair
    keys2 = torch.where(recv_e >= 0, recv_e, E_loc)  # padding -> drop bin
    C_e = _capacity(R, E_loc, cf)
    slot2, kept2 = _sort_dispatch(keys2, E_loc, C_e)
    slot2 = torch.where(recv_e >= 0, slot2, E_loc * C_e)
    if stats is not None:
        stats.setdefault("dropped_pair", []).append(torch.sum(~kept))
        stats.setdefault("dropped_expert", []).append(torch.sum((recv_e >= 0) & ~kept2))

    buf = scatter_rows(E_loc * C_e, slot2, recv_x).reshape(E_loc, C_e, D)

    # ---- expert FFN (the weights' all_gather over the dp axes: identity) ----
    out_buf = expert_ffn(buf, layer_params["w_gate"], layer_params["w_up"],
                         layer_params["w_down"]).reshape(E_loc * C_e, D)

    # ---- inverse: buffer -> recv layout -> (identity) a2a back -> combine ----
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    back = torch.where((slot2 < E_loc * C_e)[:, None],
                       out_buf[torch.clamp(slot2, 0, E_loc * C_e - 1)], zero)  # [R, D]
    ret = back
    entry_out = torch.where(kept[:, None],
                            ret[torch.clamp(slot, 0, n_groups * C_pair - 1)], zero)  # [T*K, D]
    out = torch.sum(entry_out.reshape(T, K, D) * gate[..., None].to(x.dtype), dim=1)

    if "shared_gate" in layer_params:
        sg, su, sd = (layer_params[k] for k in ("shared_gate", "shared_up", "shared_down"))
        hg = F.silu(torch.matmul(xt, sg).float()).to(x.dtype)
        out = out + torch.matmul(hg * torch.matmul(xt, su), sd)

    return out.reshape(B, S, D), aux
