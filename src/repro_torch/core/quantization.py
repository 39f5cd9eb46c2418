"""C5 — dynamic-range quantization + QAT (port of `repro.core.quantization`).

  s = (max W − min W) / (2^{b−1} − 1)                      (Formula 8)
  ŵ = clip(round(w/s)·s, min W, max W)                     (Formula 9)
  QAT: fake-quant nodes in the forward pass, straight-through gradients.

Storage representations (dispatched by core/lightweight.py):
  weights  -> {"q": int8 [din,dout], "s": f32 [dout]}  per-output-channel
  tables   -> {"q": int8 [V,d],      "s": f32 [V]}     per-row (gather-then-
              dequantize on the embedding path)

`torch.round` and `jnp.round` both round half to even, so `quantize_tree`
gives bit-equal `q` and `s` to `repro`'s on the same weights. A masked rep
that carries the derived `"block_mask"` of `core/pruning.with_block_masks`
keeps it through `quantize_tree` and `qat_params`.
"""
from __future__ import annotations

import torch

from repro_torch.core.lightweight import nbytes


def dynamic_range_step(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Formula 8 step size over the whole tensor."""
    return (w.max() - w.min()) / (2.0 ** (bits - 1) - 1.0)


def fake_quant(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Formula 9: quantize-dequantize (float in, float out)."""
    s = torch.clamp(dynamic_range_step(w, bits), min=1e-12)
    return torch.clamp(torch.round(w / s) * s, w.min(), w.max())


def ste_quant(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """QAT node: fake-quant forward, identity (straight-through) backward."""
    return w + (fake_quant(w, bits) - w).detach()


def quantize_weight(w: torch.Tensor, bits: int = 8) -> dict:
    """Per-output-channel symmetric int8 rep {"q", "s"}."""
    if bits != 8:
        raise ValueError("int8 storage path only (other widths use fake_quant)")
    s = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)  # [dout]
    q = torch.clamp(torch.round(w / s[None, :]), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(torch.float32)}


def quantize_table(t: torch.Tensor) -> dict:
    """Per-row int8 rep for embedding tables."""
    s = torch.clamp(t.abs().amax(dim=1) / 127.0, min=1e-12)  # [V]
    q = torch.clamp(torch.round(t / s[:, None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(torch.float32)}


def dequantize(rep: dict) -> torch.Tensor:
    if rep["s"].ndim == 1 and rep["q"].shape[0] == rep["s"].shape[0]:
        return rep["q"].to(torch.float32) * rep["s"][:, None]
    return rep["q"].to(torch.float32) * rep["s"][None, :]


_TABLE_KEYS = ("tables", "table", "linear", "embed")
# arrays used positionally by models (not through the linear dispatch)
_QUANT_EXCLUDE = ("pos",)


def _is_rep(x) -> bool:
    """A rep dict is a leaf of the walk, as `repro`'s `is_leaf` makes it."""
    return isinstance(x, dict) and ("w" in x or "q" in x)


def quantize_tree(params):
    """Whole-model post-training quantization of every table and weight.
    Masked reps keep their mask ({"q","s","mask"} = pruned+quantized, the
    paper's combined variant). Tables and exclusions are decided by the key
    names on a leaf's path, as in `repro`."""

    def visit(path, leaf):
        if isinstance(leaf, dict) and "w" in leaf and "mask" in leaf:
            rep = quantize_weight(leaf["w"] * leaf["mask"])
            rep["mask"] = leaf["mask"]
            if "block_mask" in leaf:
                rep["block_mask"] = leaf["block_mask"]
            return rep
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            return leaf
        if leaf.ndim != 2 or any(k in _QUANT_EXCLUDE for k in path):
            return leaf
        if any(k in _TABLE_KEYS for k in path):
            return quantize_table(leaf)
        return quantize_weight(leaf)

    def walk(path, node):
        if isinstance(node, dict) and not _is_rep(node):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        return visit(path, node)

    return walk((), params)


def qat_params(params, bits: int = 8):
    """Insert STE fake-quant on every 2-D float weight (Formula 9 forward,
    full-precision backward), tables and positions included, as in `repro`.
    Call inside the loss: loss(qat_params(p), ...)."""

    def walk(node):
        if isinstance(node, dict) and "mask" in node:  # a leaf of repro's walk
            if "w" not in node:
                return node
            return {**node, "w": ste_quant(node["w"] * node["mask"], bits)}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if torch.is_tensor(node) and node.ndim == 2 and node.is_floating_point():
            return ste_quant(node, bits)
        return node

    return walk(params)


def _model_leaves(node):
    if isinstance(node, dict) and not ("q" in node or "w" in node or "a" in node or "gw" in node):
        for v in node.values():
            yield from _model_leaves(v)
    else:
        yield node


def model_bytes(params) -> int:
    """Fig-7 storage accounting across representations."""
    return sum(nbytes(leaf) for leaf in _model_leaves(params))
