"""Plain PyTorch version of the AUGRU kernel: DIEN's attention-gated GRU
recurrence, as `repro.kernels.augru.ref.augru_ref` computes it.

    h_t = (1 - a_t·u_t) ∘ h_{t-1} + a_t·u_t ∘ tanh(zc + r ∘ (h Whc))

with the masked steps keeping h_{t-1}. One Python step per t.
"""
from __future__ import annotations

import torch


def augru_ref(zx: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor, att: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """zx: [B,T,3g] precomputed input projections (x@Wx + b, gates [r,u,c]);
    wh: [g,3g]; h0: [B,g]; att: [B,T] attention scalars; mask: bool [B,T].
    Returns the final hidden state [B,g]."""
    g = h0.shape[-1]
    h = h0
    for t in range(zx.shape[1]):
        z_t = zx[:, t]
        zh = h @ wh
        r = torch.sigmoid(z_t[:, :g] + zh[:, :g])
        u = torch.sigmoid(z_t[:, g : 2 * g] + zh[:, g : 2 * g])
        c = torch.tanh(z_t[:, 2 * g :] + r * zh[:, 2 * g :])
        u = att[:, t, None] * u
        h_new = (1.0 - u) * h + u * c
        h = torch.where(mask[:, t, None], h_new, h)
    return h
