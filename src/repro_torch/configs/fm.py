"""Factorization Machine [Rendle, ICDM'10] (port of `repro.configs.fm`).

n_sparse=39 fields, embed_dim=10, 2-way FM interaction via the O(nk)
sum-square trick. Criteo-style field layout: 13 dense + 26 categorical =
39 fields total; dense features are bucketized into small vocab tables
(standard production practice) so every field is an embedding lookup.
Vocab sizes follow the Criteo long-tail (three huge 10M-row tables).
"""
from repro_torch.configs.base import FieldSpec, RecSysConfig

# 13 bucketized-dense fields (small vocabs) + 26 categorical (Criteo tails).
_CRITEO_VOCABS = (
    # bucketized dense I1..I13
    [64] * 13
    # categorical C1..C26 — long-tailed, hashed to these sizes
    + [
        1_460, 583, 10_131_227, 2_202_608, 305, 24, 12_517, 633, 3, 93_145,
        5_683, 8_351_593, 3_194, 27, 14_992, 5_461_306, 10, 5_652, 2_173, 4,
        7_046_547, 18, 15, 286_181, 105, 142_572,
    ]
)

assert len(_CRITEO_VOCABS) == 39


def _fields():
    return tuple(
        FieldSpec(name=f"f{i:02d}", vocab=v) for i, v in enumerate(_CRITEO_VOCABS)
    )


def config() -> RecSysConfig:
    return RecSysConfig(
        name="fm",
        family="recsys",
        interaction="fm",
        embed_dim=10,
        fields=_fields(),
        n_dense_feat=0,  # dense feats bucketized into the first 13 fields
        mlp_dims=(),  # pure FM: linear + 2-way interactions, no deep tower
    )
