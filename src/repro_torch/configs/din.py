"""DIN's Taobao-scale fields (the `_fields` of `repro.configs.din`), which
DIEN shares. The DIN model itself is not ported yet, so `get_config("din")`
raises; only the field layout is kept here.
"""
from repro_torch.configs.base import FieldSpec


def _fields():
    return (
        FieldSpec(name="user", vocab=1_000_000),
        FieldSpec(name="item", vocab=50_000_000),
        FieldSpec(name="category", vocab=200_000),
        # behaviour history: seq_len lookups sharing the item/category tables
        FieldSpec(name="hist_item", vocab=50_000_000, multi_hot=100, shares="item"),
        FieldSpec(name="hist_category", vocab=200_000, multi_hot=100, shares="category"),
    )
