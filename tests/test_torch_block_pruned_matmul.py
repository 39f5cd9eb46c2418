"""The block-pruned matmul's plain version, wrapper and gradient against
`repro`, on the CPU (the Hopper kernel itself runs in tests/test_torch_cuda.py).

Tolerances: rtol 1e-5, atol 1e-4 against `repro`'s ref at 256³, as
tests/test_kernels.py holds the TPU kernel; 1e-5 absolute at the ragged
serve shapes, whose outputs are O(1); gradients within 1e-5 absolute (f32
products of a few hundred terms in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import lightweight as jax_lw  # noqa: E402
from repro.core import pruning as jax_pruning  # noqa: E402
from repro.core import quantization as jax_quant  # noqa: E402
from repro.kernels.block_pruned_matmul.ref import block_pruned_matmul_ref as jax_ref  # noqa: E402
from repro_torch.core import lightweight, pruning, quantization  # noqa: E402
from repro_torch.kernels.block_pruned_matmul import ops  # noqa: E402
from repro_torch.kernels.block_pruned_matmul.ref import (  # noqa: E402
    block_pruned_matmul_ref, expand_block_mask,
)
from repro_torch.models.common import from_numpy_tree  # noqa: E402

RAGGED = [(40, 64, 64), (40, 64, 256), (40, 256, 64), (16, 208, 200), (16, 200, 80),
          (16, 80, 1), (3, 1, 1)]
ATOL = 1e-5


def _block_mask(K, N, density, seed, block=128):
    rng = np.random.default_rng(seed)
    return (rng.random((-(-K // block), -(-N // block))) < density).astype(np.int32)


@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_plain_version_matches_repro_ref(density):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 256)).astype(np.float32)
    w = rng.normal(size=(256, 256)).astype(np.float32)
    bm = (rng.random((2, 2)) < density).astype(np.int32)
    ref = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bm), block=128))
    out = ops.block_pruned_matmul_op(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(bm))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)
    assert ops.density(torch.from_numpy(bm)) == pytest.approx(bm.mean())


def _masked_rep(K, N, seed):
    """A structured-pruned {"w","mask"} rep as repro's prune_tree makes it."""
    w = np.random.default_rng(seed).normal(size=(K, N)).astype(np.float32) / np.sqrt(K)
    return jax_pruning.prune_tree({"w0": jnp.asarray(w)}, 0.4, structured=True)["w0"]


@pytest.mark.parametrize("M,K,N", RAGGED)
def test_masked_linear_through_the_wrapper_matches_repro(M, K, N):
    jrep = _masked_rep(K, N, seed=K + N)
    x = np.random.default_rng(1).normal(size=(2, M, K)).astype(np.float32)
    ref = np.asarray(jax_lw.linear(jrep, jnp.asarray(x)))
    trep = pruning.with_block_masks({"w0": from_numpy_tree(jax.tree.map(np.asarray, jrep),
                                                           "cpu")})["w0"]
    before = ops.launches
    out = lightweight.linear(trep, torch.from_numpy(x))
    assert ops.launches == before  # CPU tensors take the plain version
    assert out.shape == (2, M, N)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    # the int8 + mask rep: plain dequantization, then the same product
    jq = jax_quant.quantize_tree({"w0": jrep})["w0"]
    tq = quantization.quantize_tree({"w0": trep})["w0"]
    assert "block_mask" in tq
    np.testing.assert_allclose(lightweight.linear(tq, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_lw.linear(jq, jnp.asarray(x))), rtol=0, atol=ATOL)


@pytest.mark.parametrize("M,K,N", [(40, 64, 256), (16, 208, 200), (16, 80, 1)])
def test_gradients_match_jax_grad_of_the_masked_product(M, K, N):
    """dx, dw and the elementwise mask's gradient, as jax.grad gives them
    for x @ (w * mask): the mask's gradient is nonzero on pruned tiles too,
    and enters the clip as it does in repro."""
    jrep = _masked_rep(K, N, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(M, K)).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)

    def f(x, w, mask):
        return jnp.sum((x @ (w * mask)) * g)

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jrep["w"], jrep["mask"])
    trep = pruning.with_block_masks({"r": from_numpy_tree(jax.tree.map(np.asarray, jrep),
                                                          "cpu")})["r"]
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = trep["w"].clone().requires_grad_(True)
    tm = trep["mask"].clone().requires_grad_(True)
    y = ops.block_pruned_matmul_op(tx, tw, trep["block_mask"], tm)
    (y * torch.from_numpy(g)).sum().backward()
    for name, got, want in (("x", tx.grad, ref[0]), ("w", tw.grad, ref[1]),
                            ("mask", tm.grad, ref[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                                   err_msg=name)
    if float(trep["mask"].min()) == 0.0:
        assert float(tm.grad[trep["mask"] == 0].abs().max()) > 0


def test_without_the_elementwise_mask_the_tile_mask_gets_no_gradient():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(8, 200)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(200, 80)).astype(np.float32)).requires_grad_(True)
    bm = torch.tensor([[1], [0]], dtype=torch.int32)
    ops.block_pruned_matmul_op(x, w, bm).sum().backward()
    m = expand_block_mask(bm, (200, 80))
    torch.testing.assert_close(w.grad, (x.detach().T @ torch.ones(8, 80)) * m)
    torch.testing.assert_close(x.grad, torch.ones(8, 80) @ (w.detach() * m).T)


def test_expand_block_mask_cuts_ragged_tiles():
    bm = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    m = expand_block_mask(bm, (200, 130))
    assert m.shape == (200, 130)
    assert float(m[:128, :128].min()) == 1 and float(m[:128, 128:].max()) == 0
    assert float(m[128:, :128].max()) == 0 and float(m[128:, 128:].min()) == 1
    x, w = torch.randn(5, 200), torch.randn(200, 130)
    torch.testing.assert_close(block_pruned_matmul_ref(x, w, bm), x @ (w * m))


@pytest.mark.parametrize("case", ["x_dtype", "mask_dtype", "mask_shape", "k_mismatch", "empty",
                                  "w_dtype", "non_contiguous", "elementwise_mask_shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, w = torch.randn(4, 64), torch.randn(64, 32)
    bm = torch.ones((1, 1), dtype=torch.int32)
    kw = {}
    if case == "x_dtype":
        x = x.double()
    elif case == "mask_dtype":
        bm = bm.float()
    elif case == "mask_shape":
        bm = torch.ones((2, 1), dtype=torch.int32)
    elif case == "k_mismatch":
        w = torch.randn(63, 32)
    elif case == "empty":
        x = torch.randn(0, 64)
    elif case == "w_dtype":
        w = w.half()
    elif case == "non_contiguous":
        x = torch.randn(64, 4).T
    elif case == "elementwise_mask_shape":
        kw["mask"] = torch.ones(64, 31)
    with pytest.raises((ValueError, TypeError)):
        ops.block_pruned_matmul_op(x, w, bm, **kw)
