"""C4 — dynamic-threshold iterative pruning (port of `repro.core.pruning`,
paper §III.B, Formulas 5-7).

  θ⁽⁰⁾ from the target ratio p (Formula 5: the p-quantile of |w|),
  M⁽ᵏ⁾ = 1[|w| ≥ θ⁽ᵏ⁾]     (Formula 6),
  W⁽ᵏ⁾ = W⁽ᵏ⁻¹⁾ ⊙ M⁽ᵏ⁾     (Formula 7), fine-tune between rounds.

A block-structured variant prunes (block x block) weight tiles by mean |w|;
its linears run the hand-written block-pruned kernel
(`kernels/block_pruned_matmul`) once `with_block_masks` has given each
masked rep the int32 tile mask the kernel reads.

A one-ulp difference in a threshold flips an element or a tile, so the
quantile is `jnp.quantile`'s linear interpolation step by step in f32
(`_quantile`), and the tightening ratio of later rounds is formed in f32 as
`repro` forms it. The masks then come out equal to `repro`'s exactly.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.block_pruned_matmul.ref import BLOCK, expand_block_mask


def _quantile(a: torch.Tensor, q) -> torch.Tensor:
    """The q-quantile of the values of `a`, linearly interpolated, in f32:
    `jnp.quantile(a, q)`'s arithmetic (sort, q·(n−1), floor and ceil, then
    low·(1−h) + high·h). XLA fuses the last step into fma(high, h, low·(1−h)),
    one rounding; the f64 sum below rounds the same way (high·h is exact
    in f64)."""
    a = torch.sort(a.reshape(-1).to(torch.float32)).values
    n = torch.tensor(float(a.numel()), dtype=torch.float32, device=a.device)
    q = torch.as_tensor(q, dtype=torch.float32, device=a.device) * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_weight = q - low
    low_weight = 1 - high_weight
    low = torch.clamp(low, torch.zeros_like(n), n - 1).long()
    high = torch.clamp(high, torch.zeros_like(n), n - 1).long()
    low_part = a[low] * low_weight
    return (a[high].double() * high_weight.double() + low_part.double()).to(torch.float32)


def magnitude_threshold(w: torch.Tensor, p) -> torch.Tensor:
    """Formula 5: θ s.t. |{|w| < θ}| / nm = p (the p-quantile of |w|)."""
    return _quantile(torch.abs(w), p)


def prune_mask(w: torch.Tensor, p: float) -> torch.Tensor:
    """Formula 6 mask at the dynamic threshold."""
    return (torch.abs(w) >= magnitude_threshold(w, p)).to(w.dtype)


def block_prune_mask(w: torch.Tensor, p: float, block: int = BLOCK) -> torch.Tensor:
    """Structured variant: score (block x block) tiles by mean |w| over the
    zero-padded tile (so a ragged edge tile scores lower), prune the
    lowest-p fraction of tiles, expand back to an elementwise mask."""
    n, m = w.shape
    wp = F.pad(torch.abs(w), (0, (-m) % block, 0, (-n) % block))
    nb, mb = wp.shape[0] // block, wp.shape[1] // block
    scores = wp.reshape(nb, block, mb, block).mean(dim=(1, 3))  # [nb, mb]
    bmask = (scores >= _quantile(scores, p)).to(w.dtype)
    return expand_block_mask(bmask, (n, m), block, w.dtype)


def _prunable(path: Tuple[str, ...], leaf) -> bool:
    """Default selector: 2-D float weights outside embedding tables."""
    if any(k in ("tables", "table", "linear", "embed", "lm_head", "pos") for k in path):
        return False
    return torch.is_tensor(leaf) and leaf.ndim == 2 and leaf.is_floating_point()


def _walk(fn, node, path=()):
    """`fn(path, leaf)` over a tree whose leaves are tensors and the dicts
    that hold a "mask" (the leaves of `repro`'s walks here)."""
    if isinstance(node, dict) and "mask" not in node:
        return {k: _walk(fn, v, path + (k,)) for k, v in node.items()}
    return fn(path, node)


def prune_tree(
    params,
    ratio: float,
    *,
    structured: bool = False,
    block: int = BLOCK,
    selector: Optional[Callable] = None,
):
    """One pruning round over a parameter tree. Dense leaves become
    {"w", "mask"} reps (core/lightweight.py dispatch); already-masked reps
    get their masks tightened (Formula 7: masks compose multiplicatively).
    A tightened rep comes back as {"w", "mask"} only, as in `repro`."""
    sel = selector or _prunable
    mask_fn = (lambda w: block_prune_mask(w, ratio, block)) if structured else (
        lambda w: prune_mask(w, ratio)
    )

    def visit(path, leaf):
        if isinstance(leaf, dict) and "mask" in leaf and "w" in leaf:
            # Formula 7: tighten over SURVIVORS only — the total below-threshold
            # fraction is z + p(1−z) for current sparsity z, formed in f32
            w = leaf["w"] * leaf["mask"]
            m = leaf["mask"].to(torch.float32)
            z = 1.0 - torch.sum(m) / torch.tensor(float(m.numel()), device=m.device)
            eff = torch.clamp(z + ratio * (1.0 - z), 0.0, 1.0)
            if structured:
                new_mask = block_prune_mask(w, float(eff), block) * leaf["mask"]
            else:
                theta = _quantile(torch.abs(w), eff)
                new_mask = (torch.abs(w) >= theta).to(w.dtype) * leaf["mask"]
            return {"w": leaf["w"], "mask": new_mask}
        if sel(path, leaf):
            return {"w": leaf, "mask": mask_fn(leaf)}
        return leaf

    return _walk(visit, params)


def sparsity(params) -> float:
    """Fraction of pruned weights among maskable leaves."""
    zero, total = 0.0, 0.0

    def visit(path, leaf):
        nonlocal zero, total
        if isinstance(leaf, dict):
            zero += float(torch.sum(leaf["mask"] == 0))
            total += leaf["mask"].numel()
        return leaf

    _walk(visit, params)
    return zero / max(total, 1.0)


def prune_schedule(target: float, rounds: int) -> list:
    """Per-round incremental ratios reaching `target` total sparsity
    (paper: K=3 rounds to ~40%). Each round prunes the same fraction of the
    *surviving* weights: 1-(1-target)^(1/K)."""
    per = 1.0 - (1.0 - target) ** (1.0 / rounds)
    return [per] * rounds


def with_block_masks(params):
    """Give every masked rep ({"w","mask"} or {"q","s","mask"}) the int32
    tile mask [ceil(K/128), ceil(N/128)] the block-pruned kernel reads,
    under "block_mask"; `core/lightweight.linear` then routes the rep
    through the kernel. Raises ValueError if a mask is not exactly
    `expand(block_mask)[:K, :N]` in 128-tiles (an unstructured mask, or one
    pruned in other tiles, never reaches the kernel). The check runs once
    here, never per call, so a caller that trains the masks puts them back
    after every step, as `compression_loop._finetune` does: the kernel
    reads "block_mask"."""

    def visit(path, leaf):
        if not isinstance(leaf, dict):
            return leaf
        mask = leaf["mask"]
        K, N = mask.shape
        padded = F.pad(mask, (0, (-N) % BLOCK, 0, (-K) % BLOCK))
        nb, mb = padded.shape[0] // BLOCK, padded.shape[1] // BLOCK
        bm = (padded.reshape(nb, BLOCK, mb, BLOCK).amax(dim=(1, 3)) != 0).to(torch.int32)
        if not torch.equal(expand_block_mask(bm, (K, N), BLOCK, mask.dtype), mask):
            raise ValueError(f"mask of {'/'.join(path)} is not block-structured in "
                             f"{BLOCK}-tiles")
        return {**leaf, "block_mask": bm.contiguous()}

    return _walk(visit, params)


def without_block_masks(params):
    """The tree with every "block_mask" left out: `repro`'s keys, as
    `prune_tree`, `quantize_tree` and `run_ladder` hand it out."""
    return _walk(lambda path, leaf: {k: v for k, v in leaf.items() if k != "block_mask"}
                 if isinstance(leaf, dict) else leaf, params)
