"""Config dataclasses + the --arch registry (port of `repro.configs.base`).

The LM, GNN and recsys families' dataclasses are kept here, every field
included (those only `repro`'s sharding reads, such as `moe_impl`,
`seq_sharded_residual`, `train_layout` and `full_mesh_graph`, too, so that
a config means the same in both packages); `get_config` knows every
architecture of `repro`: five LM, one GNN (`nequip`) and five recsys.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str  # "lm"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # positional encoding
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # chatglm3 rotates only half the head dims ("2d" RoPE)
    # norm / bias conventions
    use_bias: bool = False
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    parallel_block: bool = False  # command-r style parallel attn+FFN residual
    tie_embeddings: bool = False
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    top_k: int = 0
    moe_interleave: int = 1  # 1: every layer MoE; 2: every other layer (llama4)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "ep"  # "ep" shard_map all-to-all | "gspmd" auto-sharded
    # paper technique C2: hybrid sparse attention (window + sampled globals)
    sparse_attention: bool = False
    attn_window: int = 4_096
    attn_n_global: int = 1_024
    # compute policy
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # "full" | "dots" | "none"  (§Perf knob)
    pad_vocab: bool = False  # pad V to /512 so the LM head shards on vocab
    # distribution policy knobs (hillclimbed in §Perf)
    seq_sharded_residual: bool = False  # Megatron-SP style residual sharding
    attn_impl: str = "chunked"  # "dense" | "chunked" flash-style
    q_chunk: int = 1_024
    flash_remat: bool = False  # remat the flash step (drop per-chunk scores)
    train_layout: str = "fsdp"  # "fsdp" | "tp" weight layout for training
    int8_serve: bool = False  # C5: int8 weights/tables on the serving path

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, h = self.d_model, self.resolved_head_dim
        attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d
        dense_ffn = 3 * d * self.d_ff  # SwiGLU: gate, up, down
        n_moe = self.n_layers // self.moe_interleave if self.n_experts else 0
        n_dense = self.n_layers - n_moe
        ffn = n_dense * dense_ffn
        if self.n_experts:
            per_expert = 3 * d * self.d_ff
            ffn += n_moe * (self.n_experts + self.n_shared_experts) * per_expert
            ffn += n_moe * d * self.n_experts  # router
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        norms = self.n_layers * 2 * d + d
        return self.n_layers * attn + ffn + emb + norms

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        per_expert = 3 * d * self.d_ff
        n_moe = self.n_layers // self.moe_interleave
        inactive = n_moe * (self.n_experts - self.top_k) * per_expert
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    family: str  # "gnn"
    n_layers: int
    d_hidden: int  # channels per irrep order
    l_max: int
    n_rbf: int
    cutoff: float
    d_out: int = 1  # per-node regression target (energy contribution)
    n_species: int = 64  # atom-type / node-type vocabulary for input embedding
    dtype: str = "float32"
    remat: bool = True
    # §Perf knobs (baseline = False, paper-faithful graph partition on dp axes)
    full_mesh_graph: bool = False  # shard nodes/edges over the WHOLE mesh
    hoist_gathers: bool = False  # one source-feature gather per l, not per path


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One sparse categorical field backed by a (possibly huge) table."""

    name: str
    vocab: int
    multi_hot: int = 1  # nnz per example (EmbeddingBag reduce if > 1)
    dim: int = 0  # 0 -> RecSysConfig.embed_dim
    shares: str = ""  # share the table of another field (e.g. hist_item -> item)


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    family: str  # "recsys"
    interaction: str  # "fm" | "target_attn" | "self_attn" | "augru" | "self_attn_seq"
    embed_dim: int
    fields: Tuple[FieldSpec, ...]
    n_dense_feat: int = 0
    mlp_dims: Tuple[int, ...] = ()
    # DIN / DIEN sequential parts
    seq_len: int = 0
    attn_mlp_dims: Tuple[int, ...] = ()
    gru_dim: int = 0
    # AutoInt attention stack
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    dtype: str = "float32"
    # paper compression ladder toggles (C4/C5) — applied by core/, not here
    quantized: bool = False
    pruned: bool = False
    serve_full_mesh: bool = False

    def owned_fields(self) -> Tuple[FieldSpec, ...]:
        """Fields that own a table (excludes `shares=` aliases)."""
        return tuple(f for f in self.fields if not f.shares)

    def field_dim(self, f: FieldSpec) -> int:
        return f.dim or self.embed_dim

    def table_rows(self) -> int:
        return sum(f.vocab for f in self.owned_fields())

    def param_count(self) -> int:
        emb = sum(f.vocab * self.field_dim(f) for f in self.owned_fields())
        return emb  # towers counted by the model itself; tables dominate


@dataclasses.dataclass(frozen=True)
class WindowedRecSysConfig(RecSysConfig):
    """A `RecSysConfig` that carries the paper's C2 local-attention window
    (`attn_window`, read by `models/recsys/taobao_ssa.cfg_window`). `repro`
    reads the same attribute from whatever config object carries it; its
    `RecSysConfig`, like this one, has no such field."""

    attn_window: int = 0


def with_attn_window(cfg: RecSysConfig, window: int) -> WindowedRecSysConfig:
    """`cfg` with the C2 window `window` (0 = none); `dataclasses.replace`
    keeps it, so the distilled student's config keeps it too."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(RecSysConfig)}
    return WindowedRecSysConfig(**fields, attn_window=int(window))


ARCH_NAMES = (
    "command_r_35b",
    "chatglm3_6b",
    "yi_6b",
    "olmoe_1b_7b",
    "llama4_maverick_400b_a17b",
    "nequip",
    "fm",
    "din",
    "autoint",
    "dien",
    "taobao_ssa",
)

RECSYS_ARCHS = ("taobao_ssa", "fm", "dien", "din", "autoint")


def get_config(name: str, **overrides):
    """Load `repro_torch.configs.<name>.config()`, optionally overriding fields."""
    name = name.replace("-", "_")
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = mod.config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def family_of(name: str) -> str:
    return get_config(name).family
