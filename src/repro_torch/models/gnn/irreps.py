"""Minimal SO(3) irrep algebra for l <= 2 (port of `repro.models.gnn.irreps`).

l=0 scalars, l=1 as 3-vectors acted on by R, l=2 as 5-vectors in an
orthonormal basis {Q_k} of symmetric-traceless 3x3 matrices acted on by
M -> R M Rᵀ. Every Clebsch-Gordan coupling path is explicit vector/matrix
algebra, so each is equivariant by construction (the tests rotate inputs
and check that outputs co-rotate). Parity is not tracked (SO(3), not O(3)).

Feature container: dict {0: [..., C, 1], 1: [..., C, 3], 2: [..., C, 5]}.
The paths and their order (`path_list`) are `repro`'s; each is written
with the same products, sums and contractions as `repro`'s `jnp` code.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

_s2 = 1.0 / np.sqrt(2.0)
_s6 = 1.0 / np.sqrt(6.0)

# Orthonormal (Frobenius) basis of symmetric traceless 3x3 matrices.
_Q = np.zeros((5, 3, 3), np.float32)
_Q[0, 0, 1] = _Q[0, 1, 0] = _s2  # xy
_Q[1, 1, 2] = _Q[1, 2, 1] = _s2  # yz
_Q[2, 0, 2] = _Q[2, 2, 0] = _s2  # xz
_Q[3, 0, 0], _Q[3, 1, 1] = _s2, -_s2  # x² − y²
_Q[4, 0, 0] = _Q[4, 1, 1] = -_s6
_Q[4, 2, 2] = 2 * _s6  # 2z² − x² − y²

_EPS = np.zeros((3, 3, 3), np.float32)  # Levi-Civita
_EPS[0, 1, 2] = _EPS[1, 2, 0] = _EPS[2, 0, 1] = 1
_EPS[0, 2, 1] = _EPS[2, 1, 0] = _EPS[1, 0, 2] = -1

DIM = {0: 1, 1: 3, 2: 5}


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The basis `Q` [5,3,3] or `eps` [3,3,3] on `device` (copied there once)."""
    return torch.from_numpy({"Q": _Q, "eps": _EPS}[name]).to(device=device, dtype=dtype)


def to_matrix(t5: torch.Tensor) -> torch.Tensor:
    """[..., 5] -> [..., 3, 3] symmetric traceless."""
    return torch.einsum("...k,kab->...ab", t5, _const("Q", t5.device, t5.dtype))


def to_vec5(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 5] (projects onto the symmetric-traceless part)."""
    return torch.einsum("...ab,kab->...k", m, _const("Q", m.device, m.dtype))


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _mm3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for [..., 3, 3] stacks (broadcast), as three elementwise
    products added in order: a batched GEMM of millions of 3x3 matrices
    runs one small product at a time on the CPU and badly on the card."""
    return (A[..., :, 0, None] * B[..., None, 0, :] + A[..., :, 1, None] * B[..., None, 1, :]
            + A[..., :, 2, None] * B[..., None, 2, :])


def spherical_harmonics(r: torch.Tensor) -> Dict[int, torch.Tensor]:
    """r: [..., 3] displacement -> {l: [..., 2l+1]} of the unit direction.
    Constant normalisation factors only (they fold into learned weights).
    The norm is clipped at 1e-9, so a zero displacement (a self-loop) gives
    y1 = y2 = 0."""
    norm = torch.sqrt(torch.sum(r * r, dim=-1, keepdim=True))
    n = r / torch.clamp(norm, min=1e-9)
    y0 = torch.ones(n.shape[:-1] + (1,), dtype=n.dtype, device=n.device)
    y1 = n
    outer = n[..., :, None] * n[..., None, :]
    y2 = to_vec5(outer - _eye(n) / 3.0)
    return {0: y0, 1: y1, 2: y2}


# ---------------------------------------------------------------------------
# Tensor-product coupling paths  tp[l1][l2] -> {l_out: fn(a, b)}
# a: [..., d1] feature; b: [..., d2] (broadcastable); out [..., d_out].
# ---------------------------------------------------------------------------


def _p000(a, b):
    return a * b


def _p011(a, b):
    return a * b  # scalar [..,1] × vector [..,3]


def _p022(a, b):
    return a * b


def _p101(a, b):
    return a * b[..., :1] if b.shape[-1] == 1 else a * b


def _p110(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _p111(a, b):
    """a × b, broadcast as `jnp.cross` broadcasts ([E,C,3] × [E,1,3])."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _p112(a, b):
    outer = 0.5 * (a[..., :, None] * b[..., None, :] + b[..., :, None] * a[..., None, :])
    tr = (torch.sum(a * b, dim=-1) / 3.0)[..., None, None]
    return to_vec5(outer - tr * _eye(a))


def _p121(a, b):
    """vector ⊗ 5-vec -> vector: M(b) · a."""
    return torch.sum(to_matrix(b) * a[..., None, :], dim=-1)


def _p122(a, b):
    """vector ⊗ 5-vec -> 5-vec: sym(ε a M), ε·a the cross-product matrix."""
    M = to_matrix(b)
    vxM = _mm3(torch.einsum("acd,...c->...ad", _const("eps", a.device, a.dtype), a), M)
    sym = 0.5 * (vxM + torch.swapaxes(vxM, -1, -2))
    return to_vec5(sym)


def _p220(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)  # Frobenius (basis orthonormal)


def _p221(a, b):
    Ma, Mb = to_matrix(a), to_matrix(b)
    comm = _mm3(Ma, Mb) - _mm3(Mb, Ma)
    return torch.stack(
        [comm[..., 1, 2] - comm[..., 2, 1],
         comm[..., 2, 0] - comm[..., 0, 2],
         comm[..., 0, 1] - comm[..., 1, 0]],
        dim=-1,
    ) * 0.5


def _p222(a, b):
    Ma, Mb = to_matrix(a), to_matrix(b)
    anti = 0.5 * (_mm3(Ma, Mb) + _mm3(Mb, Ma))
    tr = torch.diagonal(anti, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
    return to_vec5(anti - tr * _eye(a))


def _swap(fn):
    return lambda a, b: fn(b, a)


# (l_feat, l_sh) -> {l_out: fn(feat, sh)}
PATHS = {
    (0, 0): {0: _p000},
    (0, 1): {1: _p011},
    (0, 2): {2: _p022},
    (1, 0): {1: _p101},
    (1, 1): {0: _p110, 1: _p111, 2: _p112},
    (1, 2): {1: _p121, 2: _p122},
    (2, 0): {2: lambda a, b: a * b},
    (2, 1): {1: _swap(_p121), 2: _swap(_p122)},
    (2, 2): {0: _p220, 1: _p221, 2: _p222},
}

N_PATHS = sum(len(v) for v in PATHS.values())  # 15


def path_list():
    """Deterministic ordering of (l_feat, l_sh, l_out)."""
    out = []
    for (lf, ls), outs in sorted(PATHS.items()):
        for lo in sorted(outs):
            out.append((lf, ls, lo, PATHS[(lf, ls)][lo]))
    return out


def rotate_features(feats: Dict[int, torch.Tensor], R: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Apply a rotation to an irrep feature dict (for equivariance tests)."""
    out = {}
    if 0 in feats:
        out[0] = feats[0]
    if 1 in feats:
        out[1] = torch.einsum("ab,...b->...a", R, feats[1])
    if 2 in feats:
        M = to_matrix(feats[2])
        out[2] = to_vec5(torch.einsum("ac,...cd,bd->...ab", R, M, R))
    return out
