"""DIEN [arXiv:1809.03672; unverified] — Deep Interest Evolution Network
(port of `repro.configs.dien`).

embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80, interest extraction GRU +
AUGRU (attention-update-gate GRU) interest evolution.
"""
from repro_torch.configs.base import RecSysConfig
from repro_torch.configs.din import _fields


def config() -> RecSysConfig:
    return RecSysConfig(
        name="dien",
        family="recsys",
        interaction="augru",
        embed_dim=18,
        fields=_fields(),
        seq_len=100,
        gru_dim=108,
        attn_mlp_dims=(80, 40),
        mlp_dims=(200, 80),
    )
