"""The port's C2 sparse-attention module against `repro`'s, on the CPU.

Masks: the strided global pattern equal bit for bit; the seeded one held to
its properties (a `torch.Generator` is not JAX's stream). Attention within
1e-5 absolute of `repro`'s on the same numpy inputs: f32 on both sides,
with other matmul backends and summation orders.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import sparse_attention as jax_sa  # noqa: E402
from repro_torch.core import sparse_attention as sa  # noqa: E402

ATOL = 1e-5


def _qkv(B, H, L, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, L, dh)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("L,window,n_global", [(16, 4, 0), (20, 3, 2), (64, 8, 5), (23, 5, 23),
                                               (100, 32, 7), (37, 1, 1), (12, 50, 3)])
@pytest.mark.parametrize("causal", [False, True])
def test_strided_mask_equals_repro(L, window, n_global, causal):
    ref = np.asarray(jax_sa.local_global_mask(L, window, n_global, causal=causal))
    got = sa.local_global_mask(L, window, n_global, causal=causal).numpy()
    np.testing.assert_array_equal(got, ref)


def test_strided_columns_equal_repro_over_a_sweep():
    """`jnp.linspace`'s float32 rounding truncates some columns below the
    exact ones, and the port must truncate the same ones."""
    for L in range(2, 130):
        for n in range(1, min(L, 24) + 1):
            ref = np.asarray(jnp.linspace(0, L - 1, n).astype(jnp.int32))
            np.testing.assert_array_equal(sa._strided_columns(L, n).numpy(), ref,
                                          err_msg=f"L={L} n={n}")


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_mask_has_the_patterns_properties(seed):
    """n_global distinct columns open to every row, the symmetric window
    kept, nothing else; the causal mask is that cut to j ≤ i; one seed
    gives one pattern."""
    L, window, n_global = 48, 5, 6
    m = sa.local_global_mask(L, window, n_global, seed=seed)
    i, j = torch.arange(L)[:, None], torch.arange(L)[None, :]
    band = (i - j).abs() < window  # no band column is open to every row at L = 48
    open_cols = [c for c in range(L) if bool(m[:, c].all())]
    assert len(open_cols) == n_global
    assert torch.equal(m, band | torch.isin(j, torch.tensor(open_cols)))
    causal = sa.local_global_mask(L, window, n_global, causal=True, seed=seed)
    assert torch.equal(causal, m & (j <= i))
    assert torch.equal(sa.local_global_mask(L, window, n_global, seed=seed), m)
    assert not torch.equal(sa.local_global_mask(L, window, n_global, seed=seed + 1), m)


@pytest.mark.parametrize("L,window,causal", [(16, 4, False), (20, 7, True), (33, 1, False),
                                             (24, 40, True)])
def test_masked_and_windowed_attention_match_repro(L, window, causal):
    q, k, v = _qkv(2, 3, L, 16, seed=L + window)
    mask = sa.local_global_mask(L, window, 2, causal=causal)
    ref = jax_sa.masked_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask.numpy()))
    out = sa.masked_attention(*map(torch.from_numpy, (q, k, v)), mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    ref = jax_sa.windowed_attention(*map(jnp.asarray, (q, k, v)), window, causal=causal)
    out = sa.windowed_attention(*map(torch.from_numpy, (q, k, v)), window, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_global,causal", [(0, False), (3, False), (5, True)])
def test_hybrid_sparse_attention_matches_repro(n_global, causal):
    q, k, v = _qkv(2, 2, 40, 32, seed=n_global)
    ref = jax_sa.hybrid_sparse_attention(*map(jnp.asarray, (q, k, v)), window=6,
                                         n_global=n_global, causal=causal)
    out = sa.hybrid_sparse_attention(*map(torch.from_numpy, (q, k, v)), window=6,
                                     n_global=n_global, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("L,d,window,n_global", [(100, 64, 32, 0), (2048, 64, 256, 11),
                                                 (16, 8, 64, 2)])
def test_attention_flops_equal_repro(L, d, window, n_global):
    assert sa.attention_flops(L, d, window, n_global) == jax_sa.attention_flops(
        L, d, window, n_global)
