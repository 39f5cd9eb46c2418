"""AutoInt [arXiv:1810.11921] — self-attention feature interaction
(port of `repro.configs.autoint`).

n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2 d_attn=32.
Same Criteo-style 39-field layout as `fm.py`.
"""
from repro_torch.configs.base import RecSysConfig
from repro_torch.configs.fm import _fields


def config() -> RecSysConfig:
    return RecSysConfig(
        name="autoint",
        family="recsys",
        interaction="self_attn",
        embed_dim=16,
        fields=_fields(),
        n_attn_layers=3,
        n_heads=2,
        d_attn=32,
        mlp_dims=(),  # AutoInt scores from the attention output directly
    )
