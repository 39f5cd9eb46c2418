"""LM-family transformer: dense + MoE, GQA + RoPE, train/prefill/decode
(port of `repro.models.transformer`).

One code path serves all five LM architectures. Parameters keep `repro`'s
stacked [L, ...] layout, so weights carry across unchanged; `repro`'s
`jax.lax.scan` over the stack is a loop over layer slices here. Workloads:

  loss(params, batch, cfg, rules)              -> scalar CE (+ MoE aux), metrics
  prefill(params, tokens, cfg, stats, rules)   -> (last_logits, kv_cache)
  decode(params, cache, token, pos, cfg, stats, rules) -> (logits, new_cache)

Across ranks. `rules` is `LM_RULES` adapted to a `DeviceMesh` (its
"__mesh__"), as a cell of `launch/cells` gives it; each argument is this
rank's block under the cell's specs, and so is each output. `repro`'s
GSPMD partitions its forward from its `constrain` calls and the cells'
shardings; here every collective is explicit, and the numbers are those of
the whole batch's forward (`distributed/collectives` has the autograd
collectives):
- train (`loss`; weights in their "fsdp" layout) and prefill (weights in
  their serving layout): the tokens split by batch over the dp dims and
  by sequence over "model" (context parallelism). Each layer gathers its
  weights whole from their blocks (`gather_spec`; its backward
  reduce-scatters the gradient to the rank's block), as do the embedding
  and output tables; a replicated leaf's gradient is summed over the
  mesh dims that split the tokens (`sum_grad`). Attention gathers K and V
  along the sequence over "model" (backward: a reduce-scatter) and keeps
  its queries local: RoPE and the causal mask take the rank's global
  positions. MoE layers take `moe_ffn_ep` on the rank's tokens. The loss
  sums each rank's cross entropy and divides by the global token count
  (`sum_forward`); the MoE aux is `moe_ffn_ep`'s mean over the ranks,
  whose gradient `scale_grad` counts once. Prefill's last logits come from
  the rank holding the sequence's last block, shared over "model", taken
  against each rank's block of the vocabulary and gathered.
- decode (serving layout, Megatron tensor parallelism): the batch split
  over the dp dims (none for a context of batch 1, whose cache splits over
  "long_kv_seq": `rules["batch"]` None), the cache's sequence over "model"
  (or ("data", "model")). q, k, v and the FFN are row- and column-parallel
  products (`tp_matmul`); the rank holding `pos` in its block writes the
  new keys; attention is split-K over the cache blocks
  (`layers.split_decode_attention`); MoE layers take `moe_ffn_tp`; the
  embedding is looked up in each rank's vocabulary block and summed, and
  the logits are gathered over the vocabulary's blocks.
- train under `train_layout="tp"` (`repro`'s Megatron experiment: the
  serving layout's weights, `rules["seq"]` None): the tokens split by
  batch only, every rank of "model" holding the same ones; each layer's
  products are decode's row- and column-parallel ones on the rank's
  blocks, never gathered, with Megatron's backward (`tp_matmul`: x's
  gradient summed over the dims that split the weight); the lookup is
  vocabulary-split, as decode's, and so is the cross entropy
  (`_Split.cross_entropy`: maxima and sums combined over the vocabulary's
  dims, no [B,S,V] logits gathered).
- `int8_serve` (prefill, decode, long-context decode): a rank holds its
  block of each int8 `q`; per-out-channel scales are whole on every rank,
  a column-parallel block taking its columns of them; an int8 table's
  per-row scales are split with its rows and its rows dequantized after
  the gather; the bf16 dequantization is `repro`'s bits (`_dequant`).
- MoE under `moe_impl="gspmd"` in train and prefill: `moe_ffn_tp`, the
  whole batch's `moe_ffn` (routing, capacity, drops and aux over the
  whole batch, not `moe_ffn_ep`'s per-shard ones), on the experts' blocks
  in the layout the cell gives them.
A mesh of one rank, or no rules, is the plain path, op for op (the mesh
still reaches `moe_ffn_ep`, whose collectives over one rank give back
their inputs).

`cfg.remat` recomputes each layer in the backward (`torch.utils.checkpoint`,
non-reentrant), as `repro`'s `jax.checkpoint` of its scan body: memory,
not numbers; a layer's weight gathers recompute with it. `decode` is
functional as `repro`'s: it copies the caches once and writes the new
token's keys and values into the copy.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.expert_parallel import moe_ffn_ep, moe_ffn_tp
from repro_torch.distributed.sharding import P, axes_index, entry_axes, mesh_groups
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import ParamDef, param_pspecs, tree_map
from repro_torch.models.layers import (
    apply_norm,
    apply_rope,
    decode_attention,
    dense_attention,
    flash_attention,
    sparse_decode_attention,
    split_decode_attention,
    swiglu,
)

# `repro`'s full mesh, 512 chips (also divisible into the 256-chip single
# pod): a weight is FSDP-sharded on its first dim that this divides, and
# `pad_vocab` rounds V up to a multiple of it.
_FSDP_WAYS = 512


def _dtype(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _dequant(w, dtype, s=None):
    """C5 int8 {"q": int8 [din,dout], "s": f32 [dout]} dequantized in bf16
    (as `repro`), then cast to `dtype`; `s` in place of w["s"] (the
    columns of a block)."""
    s = w["s"] if s is None else s
    return (w["q"].to(torch.bfloat16) * s.to(torch.bfloat16)[None, :]).to(dtype)


def _mm(x, w):
    """Representation-dispatched matmul over the last axis of x: a dense
    tensor, or C5 int8 {"q","s"} (`_dequant`) before the product."""
    if isinstance(w, dict):
        return torch.matmul(x, _dequant(w, x.dtype))
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


def int8_param_defs(defs):
    """C5 on the LM serve path (`repro.launch.cells._int8_lm_defs`): 2-D+
    weight matrices -> int8 {"q","s"} (per-out-channel scales, whole on
    every rank: [dout], or [L, dout] layer-stacked); embedding/lm_head ->
    per-row scales, split with the rows. Norms, biases and the MoE experts
    stay as they are."""

    def visit(path, d):
        if not isinstance(d, ParamDef):
            return {k: visit(path + (k,), v) for k, v in d.items()}
        if len(d.shape) < 2 or d.dtype == torch.int8:
            return d
        name = path[-1] if path else ""
        if "moe" in path:  # MoE expert einsums keep bf16 (EP path)
            return d
        if name.startswith(("attn_norm", "ffn_norm", "b")) or "norm" in name:
            return d
        if name in ("embed", "lm_head"):
            scale_axes = (d.mode_axes(True)[0],)
            scale_shape = (d.shape[0],)
        else:
            scale_axes = (None,)
            scale_shape = (d.shape[-1],)
            if len(d.shape) == 3:  # layer-stacked: per (layer, out_channel)
                scale_shape = (d.shape[0], d.shape[-1])
                scale_axes = (d.mode_axes(True)[0], None)
        return {
            "q": ParamDef(d.shape, torch.int8, "zeros", axes=d.axes, serve_axes=d.serve_axes),
            "s": ParamDef(scale_shape, torch.float32, "ones", axes=scale_axes),
        }

    return visit((), defs)


# ---------------------------------------------------------------------------
# The layout across ranks
# ---------------------------------------------------------------------------


def _mesh(rules):
    """The `DeviceMesh` of `rules`, or None (no rules, or an abstract mesh,
    which has no ranks to run on)."""
    mesh = None if rules is None else rules.get("__mesh__")
    return mesh if hasattr(mesh, "get_group") else None


def _kv_rule(rules) -> str:
    """The rule that splits decode's cache along its sequence: a batch of 1
    (`rules["batch"]` None, as the long_500k cell sets it) splits it over
    "long_kv_seq", any other batch over "kv_seq" (`cache_axes`)."""
    return "long_kv_seq" if rules.get("batch") is None else "kv_seq"


class _Split:
    """One call's layout across the ranks of `rules["__mesh__"]` (see the
    module's docstring): the params' PartitionSpecs in the call's layout
    (training's "fsdp" one, or the serving one for `serve` and under
    `train_layout="tp"`; an int8 leaf's {"q","s"} under `int8_serve`),
    stacked and one layer's slice ("layers" replicates, so a slice's spec
    drops that entry). `megatron`: the train step under
    `train_layout="tp"`, whose weights stay the rank's blocks."""

    def __init__(self, cfg: LMConfig, rules, serve: bool):
        self.mesh, self.rules = rules["__mesh__"], rules
        self.megatron = not serve and cfg.train_layout == "tp"
        defs = param_defs(cfg)
        if serve and cfg.int8_serve:
            defs = int8_param_defs(defs)
        self.specs = param_pspecs(defs, rules, serve=serve or self.megatron)
        self.layer = {k: tree_map(lambda spec: P(*spec[1:]), self.specs[k])
                      for k in ("attn", "ffn", "moe") if k in self.specs}
        self.token_axes = entry_axes(rules.get("batch")) + entry_axes(rules.get("seq"))

    def groups(self, axes):
        return mesh_groups(self.mesh, axes)

    def index(self, rule: str):
        """(this rank's block, the number of blocks) along rule's mesh dims."""
        return axes_index(self.mesh, entry_axes(self.rules.get(rule)))

    def gather(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """`t` gathered along `dim` over the mesh dims `axes`, minor first."""
        for g in reversed(self.groups(axes)):
            t = collectives.gather(t, dim, g)
        return t

    def local(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block under `spec`, used as it is; backward, its
        gradient summed over the dims that split the tokens and not the
        leaf (each of those ranks forms a part of it)."""
        return collectives.sum_grad_outside(t, spec, self.mesh, self.token_axes)

    def weight(self, t, spec):
        """The whole leaf from this rank's block under `spec`; backward, the
        whole batch's gradient: reduce-scattered over the dims that split
        the leaf, summed over the other dims that split the tokens. An int8
        {"q","s"} leaf (serving: no gradient) gathers each part."""
        if isinstance(t, dict):
            return {k: collectives.gather_spec(v, spec[k], self.mesh) for k, v in t.items()}
        return collectives.gather_spec(self.local(t, spec), spec, self.mesh)

    def weights(self, tree, specs):
        return {k: self.weight(v, specs[k]) for k, v in tree.items()}

    def locals(self, tree, specs):
        return {k: self.local(v, specs[k]) for k, v in tree.items()}

    def table(self, params):
        """(the output table's block, its spec)."""
        name = "lm_head" if "lm_head" in params else "embed"
        return params[name], self.specs[name]

    def dense(self, w, spec, dtype):
        """(the dense block, its spec) of a weight block: an int8 {"q","s"}
        one dequantized (`_dequant`) with its columns of the whole
        per-out-channel scales where `spec` splits its columns; the scales
        stay whole where it splits the rows."""
        if not isinstance(w, dict):
            return w, spec
        spec = spec["q"]
        index, _ = axes_index(self.mesh, entry_axes(spec[1]) if len(spec) > 1 else ())
        n = w["q"].shape[1]
        return _dequant(w, dtype, w["s"][index * n:(index + 1) * n]), spec

    def tp(self, p, group: str):
        """x @ p[name] on this rank's block of a serving-layout weight of
        one layer (`collectives.tp_matmul`: Megatron's f and g), as
        `mm(x, name)`; an int8 block dequantized first (`dense`)."""
        specs = self.layer[group]

        def mm(x, name):
            w, spec = self.dense(p[name], specs[name], x.dtype)
            return collectives.tp_matmul(x, w, spec, self.mesh)
        return mm

    def vocab_axes(self, spec):
        """The mesh dims that split a table's rows under `spec` (an int8
        table's: its codes')."""
        spec = spec["q"] if isinstance(spec, dict) else spec
        return entry_axes(spec[0]) if len(spec) else ()

    def lookup(self, table, ids):
        """Rows of a table split by rows (the vocabulary): each rank takes
        the ids in its block, zeros for the rest, summed over the dims that
        split it. Every rank of those dims must hold the same ids. An int8
        table's rows are dequantized after the gather (`_take_rows`)."""
        axes = self.vocab_axes(self.specs["embed"])
        index, _ = axes_index(self.mesh, axes)
        n = (table["q"] if isinstance(table, dict) else table).shape[0]
        local = ids - index * n
        inside = (local >= 0) & (local < n)
        rows = _take_rows(table, torch.clamp(local, 0, n - 1))
        rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                               device=rows.device))
        return collectives.sum_forward(rows, self.groups(axes))

    def logits(self, x, params):
        """`_logits` of x [B,S,D] against this rank's block of the output
        table's rows, gathered over the dims that split them: [B,S,V]."""
        table, spec = self.table(params)
        return self.gather(_logits(x, table), 2, self.vocab_axes(spec))

    def cross_entropy(self, x, params, labels):
        """Each token's CE [B,S] against this rank's block of the output
        table's rows (Megatron's vocabulary-parallel CE), the same on the
        ranks of the dims that split them: each rank streams its rows
        (`_streamed_ce`), and the maxima, sums and picked logits are
        combined over those dims. x's gradient is summed over them (each
        rank's part comes from its rows); the shared max is a shift,
        outside the gradient."""
        table, spec = self.table(params)
        table = self.local(table, spec)
        axes = self.vocab_axes(spec)
        groups = self.groups(axes)
        index, _ = axes_index(self.mesh, axes)
        x = collectives.sum_grad(x, groups)
        m, l, dot = _streamed_ce(x, table, labels.long() - index * table.shape[0])  # noqa: E741
        top = m.detach().clone()
        for g in groups:
            collectives.max_in_place(top, g)
        l = collectives.sum_forward(l * torch.exp(m - top), groups)  # noqa: E741
        dot = collectives.sum_forward(dot, groups)
        return (top + torch.log(torch.clamp(l, min=1e-30))) - dot


def _split_of(cfg: LMConfig, rules, serve: bool):
    """The call's `_Split` on a mesh of more than one rank, else None."""
    mesh = _mesh(rules)
    if mesh is None or mesh.size() == 1:
        return None
    return _Split(cfg, rules, serve)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _project_qkv(x, p, cfg: LMConfig, positions, mm=None):
    """x: [B,S,D] -> q [B,S,K,G,hd] (rope'd), k,v [B,S,K,hd] (rope'd k).
    `mm(x, name)` takes the products (x @ p[name] by default)."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G = H // K
    mm = mm or (lambda t, name: _mm(t, p[name]))
    q = mm(x, "wq")
    k = mm(x, "wk")
    v = mm(x, "wv")
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q.reshape(B, S, K, G, hd), k, v


def _attention_train(x, p, cfg: LMConfig, split=None, mm=None):
    """Full-sequence attention (train/prefill). Returns (attn_out, (k, v)),
    k and v this rank's block of the sequence. Across ranks the queries are
    the rank's block of the sequence, at global positions from `q_offset`,
    and K, V are gathered whole over the dims that split it. `mm(x, name)`
    takes the products where given (`train_layout="tp"`: row-parallel)."""
    B, S, D = x.shape
    q_offset = 0
    positions = torch.arange(S, device=x.device).expand(B, S)
    if split is not None:
        q_offset = split.index("seq")[0] * S
        positions = positions + q_offset
    q, k, v = _project_qkv(x, p, cfg, positions, mm)
    kv = (k, v)
    if split is not None:
        seq = entry_axes(split.rules.get("seq"))
        k, v = split.gather(k, 1, seq), split.gather(v, 1, seq)
    if cfg.attn_impl == "dense":
        out = dense_attention(q, k, v, causal=True, q_offset=q_offset)
    else:
        out = flash_attention(q, k, v, causal=True, kv_chunk=cfg.q_chunk, q_offset=q_offset,
                              remat_step=cfg.flash_remat)
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
    return (mm(out, "wo") if mm is not None else _mm(out, p["wo"])), kv


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


def _attention_decode_split(x, p, cfg: LMConfig, k_cache, v_cache, pos, split, kv):
    """`_attention_decode` across ranks: q, k, v and the output projection
    row-parallel, the caches this rank's block [B,T_loc,K,hd] of the
    sequence, from global position kv["t0"] of kv["T"]. Only the rank
    whose block holds `pos` (clamped) writes the new keys; attention is
    split-K over kv["groups"]."""
    B = x.shape[0]
    T_loc = k_cache.shape[1]
    mm = split.tp(p, "attn")
    q, k_new, v_new = _project_qkv(x, p, cfg, pos[:, None], mm)
    rows = torch.arange(B, device=x.device)
    at = torch.clamp(pos, 0, kv["T"] - 1) - kv["t0"]
    mine = ((at >= 0) & (at < T_loc))[:, None, None]
    at = torch.clamp(at, 0, T_loc - 1)
    k_cache[rows, at] = torch.where(mine, k_new[:, 0], k_cache[rows, at])
    v_cache[rows, at] = torch.where(mine, v_new[:, 0], v_cache[rows, at])
    out = split_decode_attention(q, k_cache, v_cache, pos, t0=kv["t0"], T=kv["T"],
                                 groups=kv["groups"], sparse=cfg.sparse_attention,
                                 window=cfg.attn_window, n_global=cfg.attn_n_global)
    return mm(out.reshape(B, 1, cfg.n_heads * cfg.resolved_head_dim), "wo")


def _ffn_dense(x, p, mm=None):
    """SwiGLU; `mm(x, name)` takes the products where given (across ranks:
    column-parallel gate and up, row-parallel down)."""
    if mm is None and any(isinstance(p[k], dict) for k in ("w_gate", "w_up", "w_down")):
        mm = lambda t, name: _mm(t, p[name])  # noqa: E731
    if mm is not None:
        g = mm(x, "w_gate")
        u = mm(x, "w_up")
        h = F.silu(g.float()).to(x.dtype) * u
        return mm(h, "w_down")
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _layer(x, attn_p, ffn_p, moe_p, cfg: LMConfig, decode_state=None, stats=None, mesh=None,
           split=None):
    """One transformer layer. decode_state: None | (k_cache, v_cache, pos).
    `stats` collects the MoE dispatch's record (see `prefill`); `mesh`
    reaches the expert-parallel dispatch (see `trunk`). `split` (train and
    prefill across ranks) gathers the layer's weights whole first, or under
    `train_layout="tp"` uses its blocks in Megatron's products."""
    mm_attn = mm_ffn = None
    if split is not None and split.megatron:
        attn_p = split.locals(attn_p, split.layer["attn"])
        mm_attn = split.tp(attn_p, "attn")
        if ffn_p is not None:
            ffn_p = split.locals(ffn_p, split.layer["ffn"])
            mm_ffn = split.tp(ffn_p, "ffn")
    elif split is not None:
        attn_p = split.weights(attn_p, split.layer["attn"])
        if ffn_p is not None:
            ffn_p = split.weights(ffn_p, split.layer["ffn"])
    h = apply_norm(x, attn_p["attn_norm"], cfg.norm_type)
    if decode_state is None:
        attn_out, kv = _attention_train(h, attn_p, cfg, split, mm_attn)
    else:
        attn_out, kv = _attention_decode(h, attn_p, cfg, *decode_state)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.parallel_block:
        # command-r: shared-norm parallel attention + FFN
        if moe_p is not None:
            raise ValueError("parallel_block with MoE is used by no LM arch")
        x = x + attn_out + _ffn_dense(h, ffn_p, mm_ffn)
    else:
        x = x + attn_out
        h2 = apply_norm(x, attn_p["ffn_norm"], cfg.norm_type)
        if moe_p is not None:
            ffn_out, aux = _moe(h2, moe_p, cfg, stats, mesh, split, decode_state is None)
        else:
            ffn_out = _ffn_dense(h2, ffn_p, mm_ffn)
        x = x + ffn_out
    return x, kv, aux


def _moe(h, moe_p, cfg: LMConfig, stats, mesh, split, full_sequence: bool):
    """A routed layer's FFN (see `_layer`). Decode (tiny token counts) takes
    the plain dispatcher, train and prefill the expert-parallel one under
    `moe_impl="ep"`, as `repro`; across ranks decode, and train and prefill
    under `moe_impl="gspmd"`, take `moe_ffn_tp` (the whole batch's
    `moe_ffn`). Under `train_layout="tp"` the ranks of "model" hold the
    same tokens: `moe_ffn_ep`'s copies there each count 1/n of the output's
    gradient, and x's gradient is summed over them."""
    if split is None:
        if cfg.moe_impl == "ep" and full_sequence:
            return moe_ffn_ep(h, moe_p, cfg, stats, mesh=mesh)
        return moe_lib.moe_ffn(h, moe_p, cfg, stats)
    if cfg.moe_impl != "ep" or not full_sequence:
        return moe_ffn_tp(h, moe_p, cfg, stats, mesh=split.mesh, rules=split.rules,
                          w_specs=split.layer["moe"], seq=full_sequence)
    same = [a for a in split.mesh.mesh_dim_names if a not in split.token_axes]
    return collectives.over_copies(
        lambda t: moe_ffn_ep(t, moe_p, cfg, stats, mesh=mesh, w_specs=split.layer["moe"]), h,
        split.mesh, same)


def _decode_layer_split(x, attn_p, ffn_p, moe_p, cfg: LMConfig, k_cache, v_cache, pos, split,
                        kv, stats=None):
    """`_layer` of one decode step across ranks (serving layout): x [B,1,D]
    this rank's block of the batch, whole along D on every rank of the
    other dims."""
    h = apply_norm(x, attn_p["attn_norm"], cfg.norm_type)
    attn_out = _attention_decode_split(h, attn_p, cfg, k_cache, v_cache, pos, split, kv)
    if cfg.parallel_block:
        if moe_p is not None:
            raise ValueError("parallel_block with MoE is used by no LM arch")
        return x + attn_out + _ffn_dense(h, ffn_p, split.tp(ffn_p, "ffn"))
    x = x + attn_out
    h2 = apply_norm(x, attn_p["ffn_norm"], cfg.norm_type)
    if moe_p is not None:
        ffn_out, _ = moe_ffn_tp(h2, moe_p, cfg, stats, mesh=split.mesh, rules=split.rules,
                                w_specs=split.layer["moe"])
    else:
        ffn_out = _ffn_dense(h2, ffn_p, split.tp(ffn_p, "ffn"))
    return x + ffn_out


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


def _trunk(params, tokens, cfg: LMConfig, stats, mesh, split):
    if split is None:
        x = _take_rows(params["embed"], tokens)
    elif split.megatron:  # the vocabulary-split lookup, as decode's
        x = split.lookup(split.local(params["embed"], split.specs["embed"]), tokens)
    else:
        x = _take_rows(split.weight(params["embed"], split.specs["embed"]), tokens)
    x = x.to(_dtype(cfg))
    remat = cfg.remat and cfg.remat_policy != "none" and torch.is_grad_enabled()
    ks, vs, aux = [], [], torch.zeros((), dtype=torch.float32, device=x.device)
    for attn_p, ffn_p, moe_p in _layers(params, cfg):
        if remat:  # `repro`'s "dots" policy saves the matmuls; both recompute the rest
            x, (k, v), a = checkpoint(_layer, x, attn_p, ffn_p, moe_p, cfg, None, stats, mesh,
                                      split, use_reentrant=False)
        else:
            x, (k, v), a = _layer(x, attn_p, ffn_p, moe_p, cfg, None, stats, mesh, split)
        ks.append(k)
        vs.append(v)
        aux = aux + a
    norm = params["final_norm"]
    if split is not None:
        norm = split.local(norm, split.specs["final_norm"]) if split.megatron else \
            split.weight(norm, split.specs["final_norm"])
    x = apply_norm(x, norm, cfg.norm_type)
    return x, aux, (torch.stack(ks), torch.stack(vs))


def trunk(params, tokens, cfg: LMConfig, stats=None, rules=None, serve: bool = False):
    """tokens [B,S] -> hidden [B,S,D], aux loss, kv caches [L,B,S,K,hd]x2.
    With `rules` of a mesh of more than one rank, every argument and output
    is this rank's block: the tokens' (batch, seq) block, the params'
    blocks in the training layout (or `serve`'s), the hidden state's and
    the caches' blocks of the same tokens (module docstring); the mesh
    reaches every MoE layer's `moe_ffn_ep` at any size, as `repro`'s rules
    do."""
    return _trunk(params, tokens, cfg, stats, _mesh(rules), _split_of(cfg, rules, serve))


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


def _token_cross_entropy(x, table, labels, n_chunks: int = 8):
    """Each token's CE [B,S] by a streaming logsumexp over vocab chunks."""
    m, l, dot = _streamed_ce(x, table, labels, n_chunks)  # noqa: E741
    return (m + torch.log(torch.clamp(l, min=1e-30))) - dot


def _streamed_ce(x, table, labels, n_chunks: int = 8):
    """The streaming logsumexp's state over the table's rows, each [B,S]:
    the running max m, the sum l of exp(logit - m), and the logit of each
    label among the rows (0 for a label outside them)."""
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
    return m, l, dot


def chunked_cross_entropy(x, table, labels, n_chunks: int = 8):
    """Streaming-logsumexp CE over vocab chunks; avoids the [B,S,V] buffer.

    x: [B,S,D]; table: [V,D]; labels: [B,S] int. Returns mean CE.
    """
    return torch.mean(_token_cross_entropy(x, table, labels, n_chunks))


def loss(params, batch, cfg: LMConfig, rules=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE + MoE load-balance aux. Across ranks (`trunk`) every
    rank returns the whole batch's loss and metrics."""
    split = _split_of(cfg, rules, serve=False)
    x, aux, _ = _trunk(params, batch["tokens"], cfg, None, _mesh(rules), split)
    if split is None:
        ce = chunked_cross_entropy(x, _output_table(params), batch["labels"])
    else:
        if split.megatron:
            ce = torch.sum(split.cross_entropy(x, params, batch["labels"]))
        else:
            table, spec = split.table(params)
            ce = torch.sum(_token_cross_entropy(x, split.weight(table, spec), batch["labels"]))
        n_tokens = x.shape[0] * x.shape[1] * math.prod(
            split.mesh.size(split.mesh.mesh_dim_names.index(a)) for a in split.token_axes)
        ce = collectives.sum_forward(ce, split.groups(split.token_axes)) / n_tokens
        aux = collectives.scale_grad(aux, 1.0 / split.mesh.size())
    total = ce + 0.01 * aux
    return total, {"ce": ce, "aux": aux}


def prefill(params, tokens, cfg: LMConfig, stats=None, rules=None):
    """Full-sequence forward; returns last-position logits + KV caches.
    `stats`, a dict, collects each MoE layer's dispatch record: the entries
    dropped at `moe_ffn_ep`'s two capacity stages, or `moe_ffn`'s under
    `moe_impl="gspmd"` (see those): a record, not an output. Across ranks
    (`trunk`, serving layout) the logits are this rank's block of the
    batch, whole over the vocabulary, and the caches its (batch, seq)
    block."""
    split = _split_of(cfg, rules, serve=True)
    x, _, (k_all, v_all) = _trunk(params, tokens, cfg, stats, _mesh(rules), split)
    last = x[:, -1:, :]
    if split is None:
        return _logits(last, _output_table(params))[:, 0], (k_all, v_all)
    index, ways = split.index("seq")
    if index != ways - 1:  # the sequence's last row lies on the last block's ranks
        last = torch.zeros_like(last)
    last = collectives.sum_forward(last, split.groups(entry_axes(split.rules.get("seq"))))
    return split.logits(last, params)[:, 0], (k_all, v_all)


def decode(params, cache, token, pos, cfg: LMConfig, stats=None, rules=None):
    """One decode step. cache: (k [L,B,T,K,hd], v [L,B,T,K,hd]);
    token: [B] int; pos: [B] current positions. Returns (logits, cache),
    the cache a new pair of tensors (the arguments are not modified).
    `stats`: as `prefill`'s; decode takes `moe_ffn` (`moe_ffn_tp` across
    ranks, module docstring: the cache is this rank's block along the
    batch and the sequence, token and pos its block of the batch, the
    logits its block of the batch, whole over the vocabulary)."""
    split = _split_of(cfg, rules, serve=True)
    k_out, v_out = (c.clone() for c in cache)
    if split is None:
        x = _take_rows(params["embed"], token[:, None]).to(_dtype(cfg))
        for i, (attn_p, ffn_p, moe_p) in enumerate(_layers(params, cfg)):
            x, _, _ = _layer(x, attn_p, ffn_p, moe_p, cfg, (k_out[i], v_out[i], pos), stats)
        x = apply_norm(x, params["final_norm"], cfg.norm_type)
        logits = _logits(x, _output_table(params))
        return logits[:, 0], (k_out, v_out)

    kv_axes = entry_axes(split.rules.get(_kv_rule(split.rules)))
    index, ways = axes_index(split.mesh, kv_axes)
    T_loc = k_out.shape[2]
    kv = {"t0": index * T_loc, "T": ways * T_loc, "groups": split.groups(kv_axes)}
    x = split.lookup(params["embed"], token[:, None]).to(_dtype(cfg))
    for i, (attn_p, ffn_p, moe_p) in enumerate(_layers(params, cfg)):
        x = _decode_layer_split(x, attn_p, ffn_p, moe_p, cfg, k_out[i], v_out[i], pos, split,
                                kv, stats)
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    return split.logits(x, params)[:, 0], (k_out, v_out)


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
