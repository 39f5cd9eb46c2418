"""DIN [arXiv:1706.06978] — Deep Interest Network (port of `repro.configs.din`).

embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80, target attention over
the user-behavior sequence. Taobao-scale tables: user / item / category,
which DIEN shares.
"""
from repro_torch.configs.base import FieldSpec, RecSysConfig


def _fields():
    return (
        FieldSpec(name="user", vocab=1_000_000),
        FieldSpec(name="item", vocab=50_000_000),
        FieldSpec(name="category", vocab=200_000),
        # behaviour history: seq_len lookups sharing the item/category tables
        FieldSpec(name="hist_item", vocab=50_000_000, multi_hot=100, shares="item"),
        FieldSpec(name="hist_category", vocab=200_000, multi_hot=100, shares="category"),
    )


def config() -> RecSysConfig:
    return RecSysConfig(
        name="din",
        family="recsys",
        interaction="target_attn",
        embed_dim=18,
        fields=_fields(),
        seq_len=100,
        attn_mlp_dims=(80, 40),
        mlp_dims=(200, 80),
    )
