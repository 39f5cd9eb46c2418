"""The paper's own Baseline model (§V.A): sequential self-attention ranker.

Taobao User Behavior: 1M users, 200K items, behaviour sequences truncated
to 100, candidate set 50. "original FP32 model with self-attention" at
32.0M parameters / 128 MB fp32 (Table I). Layout chosen to land on 32M:
  item table 200K x 64 = 12.8M, user 1M x 16 = 16M, cat 10K x 64 = 0.64M,
  2 self-attn blocks (d=64, 4H, ff=256) + MLP tower 200-80 ~= 2.5M.
The full compression ladder (Quantized / Pruned / P+Q / Distilled) is
applied to THIS model by `core/compression_loop.py` — it is the subject of
benchmarks/bench_table1.py.
"""
from repro_torch.configs.base import FieldSpec, RecSysConfig


def _fields():
    return (
        FieldSpec(name="user", vocab=1_000_000, dim=16),
        FieldSpec(name="item", vocab=200_000),
        FieldSpec(name="category", vocab=10_000),
        FieldSpec(name="hist_item", vocab=200_000, multi_hot=100, shares="item"),
        FieldSpec(name="hist_category", vocab=10_000, multi_hot=100, shares="category"),
    )


def config() -> RecSysConfig:
    return RecSysConfig(
        name="taobao_ssa",
        family="recsys",
        interaction="self_attn_seq",
        embed_dim=64,
        fields=_fields(),
        seq_len=100,
        n_attn_layers=2,
        n_heads=4,
        d_attn=64,
        mlp_dims=(200, 80),
    )
