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


# ---------------------------------------------------------------- launch plan

from repro_torch.kernels.block_pruned_matmul import block_pruned_matmul as bpm_kernel  # noqa: E402

# (M, K, N): every masked linear of chip_smoke.py's kernels phase (a
# structured taobao_ssa serve call of 512 requests, 256^3) and the kernel
# benchmark's 512^3
MAIN_SHAPES = [(51200, 64, 64), (51200, 64, 256), (51200, 256, 64), (512, 208, 200),
               (512, 200, 80), (512, 80, 1), (256, 256, 256), (512, 512, 512)]


@pytest.mark.parametrize("M,K,N", MAIN_SHAPES + [(37, 300, 129), (1, 1, 1), (2, 600, 300),
                                                  (4096, 64, 64), (100, 7, 300), (3, 9, 7)])
def test_launch_plan_takes_only_launches_the_c_entry_accepts(M, K, N):
    plan = bpm_kernel.launch_plan(M, K, N)
    assert plan.tile == bpm_kernel.ROWS or plan.tile in bpm_kernel.TILES
    assert 1 <= plan.grid_m <= bpm_kernel.MAX_GRID_M
    assert plan.splits in (1, 2, 4, 8) and (plan.splits == 1 or plan.tile not in (0, 1))
    if N < 8 or K < bpm_kernel.MIN_K_TC:  # the rows path: f32 FMA, no tensor-core tile
        assert plan.tile == bpm_kernel.ROWS
        lanes = bpm_kernel.rows_lanes(K, N)
        assert lanes in (1, 2, 4, 8, 16, 32)
        assert plan.blocks * bpm_kernel.ROWS_WARPS * (32 // lanes) >= M
    else:
        bm, bn = bpm_kernel.TILES[plan.tile]
        assert plan.blocks == plan.grid_m * -(-N // bn) * plan.splits
        assert plan.grid_m <= -(-M // bm)  # no block along M without a tile (they walk the rest)


@pytest.mark.parametrize("M,K,N", MAIN_SHAPES)
def test_launch_plan_puts_work_on_every_sm_where_the_shape_allows(M, K, N):
    """The encoder's 51,200-token calls take the tall tile, a grid of at
    least 132 blocks; M <= 512 takes the small kernel, whose blocks times
    warp groups over K cover the 132 SMs; N = 1 takes the rows path."""
    plan = bpm_kernel.launch_plan(M, K, N)
    if N < 8:
        assert plan.tile == bpm_kernel.ROWS and plan.blocks == -(-M // bpm_kernel.ROWS_WARPS)
    elif M >= 51200:
        assert plan.tile == bpm_kernel.TALL and plan.blocks >= 132
        assert -(-(-(-M // 64)) // plan.grid_m) in bpm_kernel.TALL_TILES_PER_BLOCK  # tiles a block
    else:
        assert plan.tile in (2, 3) and plan.blocks * bpm_kernel.K_GROUPS[plan.tile] >= 132


def test_launch_plan_splits_k_over_a_cluster_only_for_few_tiles_and_long_k():
    assert bpm_kernel.launch_plan(2, 600, 300).splits == 8      # one row of tiles, K 600
    assert bpm_kernel.launch_plan(256, 256, 256).splits == 2
    assert bpm_kernel.launch_plan(4096, 64, 64).splits == 1     # K 64: four steps of 16
    assert bpm_kernel.launch_plan(51200, 256, 64).splits == 1   # the tall tile never splits
    for M, K, N in MAIN_SHAPES:
        plan = bpm_kernel.launch_plan(M, K, N)
        assert plan.splits == 1 or -(-K // 16) >= 4 * plan.splits


@pytest.mark.parametrize("plan", [bpm_kernel.Plan(9, 1, 1), bpm_kernel.Plan(1, 0, 1),
                                  bpm_kernel.Plan(3, 1, 1, 3), bpm_kernel.Plan(1, 1, 1, 2),
                                  bpm_kernel.Plan(0, 1, 1, 2), bpm_kernel.Plan(2, 70000, 1)])
def test_the_binding_refuses_a_plan_the_c_entry_does_not_take(plan):
    x, w, bm = torch.zeros(4, 16), torch.zeros(16, 8), torch.ones((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        bpm_kernel.block_pruned_matmul(x, w, bm, plan)


def test_the_binding_refuses_a_tensor_core_tile_below_k_32():
    x, w, bm = torch.zeros(4, 31), torch.zeros(31, 8), torch.ones((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="K >= 32"):
        bpm_kernel.block_pruned_matmul(x, w, bm, bpm_kernel.Plan(3, 1, 1))


# ------------------------------------------------------ 3xTF32, in plain torch

def _rna_tf32(a: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties away from zero, at TF32's 10-bit mantissa:
    the kernel's two integer operations on the f32 bits."""
    return ((a.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(a):
    hi = _rna_tf32(a)
    return hi, _rna_tf32(a - hi)


def _emulate(x, w, terms=3):
    """The kernel's arithmetic: per 16 columns of k, the products (exact in
    f32: 11-bit times 11-bit significands) summed in f32, small terms first,
    into a fresh chunk, then added to the f32 accumulator. terms=1 is a
    single TF32 product."""
    (xh, xl), (wh, wl) = _split(x), _split(w)
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, x.shape[1], 16):
        s = slice(k0, k0 + 16)
        chunk = xh[:, s] @ wh[s]
        if terms == 3:
            chunk = (xl[:, s] @ wh[s] + xh[:, s] @ wl[s]) + chunk
        acc = acc + chunk
    return acc


@pytest.mark.parametrize("M,K,N", [(64, 8, 16), (40, 64, 64), (33, 200, 80), (16, 256, 64),
                                   (5, 300, 129)])
def test_3xtf32_is_as_close_to_an_f64_product_as_f32_is(M, K, N):
    """Against an f64 product, the emulated kernel's largest error is within
    2x the f32 matmul's; a single TF32 product misses that by orders of
    magnitude. This is the numerics the kernel promises."""
    gen = torch.Generator().manual_seed(M + K + N)
    x = torch.randn(M, K, generator=gen)
    w = torch.randn(K, N, generator=gen) / K ** 0.5
    exact = x.double() @ w.double()
    f32 = float((x @ w - exact).abs().max())
    three = float((_emulate(x, w) - exact).abs().max())
    one = float((_emulate(x, w, terms=1) - exact).abs().max())
    assert three <= 2 * f32
    assert one > 2 * f32


def test_rna_tf32_rounds_half_away_from_zero_and_keeps_the_split_exact():
    ulp = 2.0 ** -10  # TF32's step at 1.0
    a = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 3.0])
    assert _rna_tf32(a).tolist() == [1 + ulp, -(1 + ulp), 1.0, 3.0]
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi, lo = _split(x)
    assert torch.equal(_rna_tf32(hi), hi) and torch.equal(_rna_tf32(lo), lo)
    # x - hi - lo is what the two TF32 parts leave out: below 2^-21 of |x|
    left = (x.double() - hi.double() - lo.double()).abs() / x.double().abs()
    assert float(left.max()) < 2 ** -21


def test_few_terms_3xtf32_misses_f32_so_the_plan_takes_the_rows_path():
    """With K = 1 the split's per-term error (about 2^-22 of each part) shows
    against f32's single rounding; on the card it still shows at K = 8, 9
    and 16 (2.06x, 2.05x, 2.37x the f32 matmul's error), so the plan sends
    K < 32 to f32 FMA."""
    gen = torch.Generator().manual_seed(7)
    x, w = torch.randn(512, 1, generator=gen), torch.randn(1, 64, generator=gen)
    exact = x.double() @ w.double()
    assert float((_emulate(x, w) - exact).abs().max()) > 2 * float((x @ w - exact).abs().max())
    for K in (1, 8, 16, 31):
        assert bpm_kernel.launch_plan(512, K, 64).tile == bpm_kernel.ROWS
    assert bpm_kernel.launch_plan(512, 32, 64).tile != bpm_kernel.ROWS
