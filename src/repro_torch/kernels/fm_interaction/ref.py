"""Plain PyTorch version of the FM second-order kernel.

`½ Σ_c [(Σ_f e)² − Σ_f e²]` per example, as `repro.models.recsys.fm.fm_interaction`
computes it (the oracle of the Pallas kernel), in the same order: the field
sum and the sum of squares, then their difference summed over the factors.
"""
from __future__ import annotations

import torch


def fm_interaction_ref(e: torch.Tensor) -> torch.Tensor:
    """e: [B, F, k] -> [B]."""
    s = torch.sum(e, dim=1)  # Σ_f e
    sq = torch.sum(torch.square(e), dim=1)  # Σ_f e²
    return 0.5 * torch.sum(torch.square(s) - sq, dim=-1)
