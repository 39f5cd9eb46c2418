"""Roofline terms of one rank's counted work, and the model flops of an LM
step (port of `repro.launch.analysis`).

`repro` reads XLA's compiled artifacts: `cost_analysis()`, the
post-SPMD HLO text (its collectives' bytes, `parse_collective_bytes`) and
`memory_analysis()`. PyTorch has no HLO text: the dry run's counter
(`launch/hlo_stats.Counter`) sees each `c10d` collective as it is
dispatched, and its `collectives` take the place of
`parse_collective_bytes`, under the same model.

Collective cost model (ring algorithms, per-device bytes over the slowest
link): all-gather -> output bytes x (n-1)/n ~= output bytes;
all-reduce -> 2x input; reduce-scatter -> input; all-to-all -> input;
collective-permute -> input.

The card's constants below are NVIDIA's published data-sheet peaks of one
card, not measurements: an NVIDIA H100 SXM5 80GB HBM3 at its 700 W power
limit, dense rates without sparsity. A card set to a lower power limit
runs slower under load.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

CARD = "NVIDIA H100 80GB HBM3 (SXM5), 700 W power limit"
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_INT8 = 1979e12  # dense int8 tensor-core OP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
NVLINK_BW = 450e9  # NVLink bytes/s, one direction (900 GB/s both ways)
HBM_BYTES = 80 * 10**9  # device memory, the card's data sheet


@dataclasses.dataclass
class Roofline:
    flops: float  # per-device dot flops
    hbm_bytes: float  # per-device bytes accessed
    coll_bytes: float  # per-device collective link bytes
    n_chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "n_chips": self.n_chips,
            "peaks": {"card": CARD, "flops_bf16": PEAK_FLOPS_BF16, "hbm_bytes_per_s": HBM_BW,
                      "link_bytes_per_s": NVLINK_BW},
        }


def model_flops_lm(cfg, tokens: int, kind: str) -> float:
    """6·N_active·D for train, 2·N_active·D for inference (+ attention)."""
    n = cfg.active_param_count()
    mult = 6 if kind == "train" else 2
    return mult * n * tokens


def mfu_ratio(model_flops: float, hlo_flops_total: float) -> float:
    """MODEL_FLOPS / counted dot flops — the fraction of the computed flops
    that is 'useful'; <1 means remat/dispatch overhead, >1 means the
    analytic count overestimates (e.g. MoE dropping)."""
    return model_flops / max(hlo_flops_total, 1.0)
