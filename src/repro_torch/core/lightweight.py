"""C1 — lightweight projection representations (port of `repro.core.lightweight`).

Every compressible linear is a representation-dispatched apply: the
parameter leaf decides the compute path. The reps are exactly `repro`'s:

  dense      : tensor [d_in, d_out]
  masked     : {"w": [d_in,d_out], "mask": same}          (C4 pruning)
  lowrank    : {"a": [d_in,r], "b": [r,d_out]}            (C1 low-rank heads)
  grouped    : {"gw": [k, d_in/k, d_out/k]}               (C1 grouped linear)
  dwsep      : {"dw": [3, d_in], "pw": [d_in, d_out]}     (C1 depthwise-separable,
                sequence inputs only)
  int8       : {"q": int8 [d_in,d_out], "s": f32 [d_out]} (C5 dynamic-range quant,
                per-output-channel scale)
  int8 + mask: {"q","s","mask"}                           (C4+C5 combined)

The int8 rep is weight-only: it dequantizes and runs an f32 matmul, as
`repro` does (not W8A8). The dense products are `torch.matmul`, as `repro`
leaves them to XLA outside any kernel.

A masked rep (with or without int8 weights) that also holds the int32 tile
mask "block_mask" of `core/pruning.with_block_masks` runs the hand-written
block-pruned kernel (`kernels/block_pruned_matmul`): the same product, with
the pruned tiles skipped. `with_block_masks` checked once that the mask is
block-constant, so no call here checks it again; an unstructured mask has
no "block_mask" and stays `x @ (w * mask)`, as in `repro`.
"""
from __future__ import annotations

from typing import Dict, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.block_pruned_matmul.ops import block_pruned_matmul_op

Rep = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _dequant(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    w = p["q"].to(torch.float32) * p["s"][None, :]
    return w * p["mask"] if "mask" in p else w


def _block_pruned(x: torch.Tensor, w: torch.Tensor, block_mask: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """x [..., K] @ (w ⊙ expand(block_mask)) through the kernel, on x as 2-D."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = block_pruned_matmul_op(x2, w.contiguous(), block_mask, mask)
    return y.reshape(x.shape[:-1] + (w.shape[1],))


def linear(p: Rep, x: torch.Tensor) -> torch.Tensor:
    """Apply a compressible linear on the last axis of x."""
    if not isinstance(p, dict):
        return x @ p
    if "q" in p:  # int8 dynamic-range weights
        if "block_mask" in p:  # plain dequantization, then the kernel applies the mask
            w = p["q"].to(torch.float32) * p["s"][None, :]
            return _block_pruned(x.to(torch.float32), w, p["block_mask"]).to(x.dtype)
        return (x.to(torch.float32) @ _dequant(p)).to(x.dtype)
    if "mask" in p:
        if "block_mask" in p:
            return _block_pruned(x, p["w"], p["block_mask"], p["mask"])
        return x @ (p["w"] * p["mask"])
    if "a" in p:  # low-rank
        return (x @ p["a"]) @ p["b"]
    if "gw" in p:  # grouped
        k, gin, gout = p["gw"].shape
        xg = x.reshape(x.shape[:-1] + (k, gin))
        out = torch.einsum("...ki,kio->...ko", xg, p["gw"])
        return out.reshape(x.shape[:-1] + (k * gout,))
    if "dw" in p:  # depthwise(3) over seq + pointwise
        dw, pw = p["dw"], p["pw"]
        pad = F.pad(x, (0, 0, 1, 1))  # one zero row either side of the seq axis
        y = (
            pad[..., :-2, :] * dw[0]
            + pad[..., 1:-1, :] * dw[1]
            + pad[..., 2:, :] * dw[2]
        )
        return y @ pw
    raise ValueError(f"unknown linear representation: {list(p.keys())}")


def weight_view(p: Rep) -> torch.Tensor:
    """Effective dense [d_in, d_out] weight of any representation."""
    if not isinstance(p, dict):
        return p
    if "q" in p:
        return _dequant(p)
    if "mask" in p:
        return p["w"] * p["mask"]
    if "a" in p:
        return p["a"] @ p["b"]
    if "gw" in p:
        k, gin, gout = p["gw"].shape
        blocks = [
            F.pad(p["gw"][i], (i * gout, (k - 1 - i) * gout))
            for i in range(k)
        ]
        return torch.cat(blocks, dim=0)
    raise ValueError(f"no dense view for: {list(p.keys())}")


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def nbytes(p: Rep) -> int:
    """Storage footprint of a representation (paper Fig. 7 resource accounting).
    Masked weights count only surviving entries (sparse storage)."""
    if not isinstance(p, dict):
        return _size(p)
    if "q" in p:
        if "mask" in p:
            nz = int(p["mask"].sum())
            return nz * 1 + p["s"].numel() * 4  # paper accounting: survivors only
        return p["q"].numel() * 1 + p["s"].numel() * 4
    if "mask" in p:
        return int(p["mask"].sum()) * 4  # paper's Table-I accounting: survivors x 4B
    return sum(_size(v) for v in p.values())


def low_rank_factorize(w: torch.Tensor, rank: int):
    """SVD truncation of a dense weight -> lowrank rep (C1)."""
    u, s, vt = torch.linalg.svd(w.to(torch.float32), full_matrices=False)
    r = min(rank, s.shape[0])
    a = u[:, :r] * s[None, :r]
    return {"a": a.to(w.dtype), "b": vt[:r].to(w.dtype)}


def to_grouped(w: torch.Tensor, k: int):
    """Keep only the block-diagonal groups of a dense weight (C1 grouped
    linear); information off the diagonal is discarded by design."""
    d_in, d_out = w.shape
    if d_in % k or d_out % k:
        raise ValueError(f"weight {tuple(w.shape)} does not split into {k} groups")
    gin, gout = d_in // k, d_out // k
    blocks = [w[i * gin : (i + 1) * gin, i * gout : (i + 1) * gout] for i in range(k)]
    return {"gw": torch.stack(blocks)}
