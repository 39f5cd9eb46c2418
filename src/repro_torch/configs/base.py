"""Recsys config dataclasses + the --arch registry (port of `repro.configs.base`).

Only the recsys family's dataclasses are kept here; `get_config` knows the
architectures the port has reached and raises `NotImplementedError` for
the rest, naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


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

# Architectures the port has reached, and the slice that brings each other one.
PORTED = ("taobao_ssa", "fm", "dien")
_LATER_SLICE = {
    "din": "the recsys-families slice",
    "autoint": "the recsys-families slice",
}


def get_config(name: str, **overrides):
    """Load `repro_torch.configs.<name>.config()`, optionally overriding fields."""
    name = name.replace("-", "_")
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    if name not in PORTED:
        later = _LATER_SLICE.get(name, "the off-paper-path slice (LM / GNN families)")
        raise NotImplementedError(f"arch {name!r} is not ported yet; it comes with {later}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = mod.config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
