"""The W8A8 int8 matmul's plain version and wrappers against `repro`, on
the CPU (the Hopper kernel itself runs in tests/test_torch_cuda.py).

`quantize_activations` is bit-equal (both round half to even). Products
within rtol 1e-6, atol 1e-4 of `repro`'s Pallas kernel (interpret mode) and
of its ref fallback, as tests/test_kernels.py holds the TPU kernel: the
int32 accumulators are equal, and the two epilogues multiply the same
three factors in another association.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quantization import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.kernels.int8_matmul import ops as jax_ops  # noqa: E402
from repro.kernels.int8_matmul.int8_matmul import int8_matmul as jax_kernel  # noqa: E402
from repro.kernels.int8_matmul.ref import int8_matmul_ref as jax_ref  # noqa: E402
from repro.kernels.int8_matmul.ref import quantize_activations as jax_quantize  # noqa: E402
from repro_torch.core.quantization import quantize_tree  # noqa: E402
from repro_torch.kernels.int8_matmul import ops  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import (  # noqa: E402
    int32_product, int8_matmul_ref, pallas_epilogue, quantize_activations,
)

RTOL, ATOL = 1e-6, 1e-4


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,scale", [((128, 128), 1.0), ((100, 64), 3.0), ((7, 208), 1e-3),
                                         ((512, 200), 50.0), ((3, 5), 0.0)])
def test_quantize_activations_is_bit_equal(shape, scale):
    x = _normal(shape, seed=sum(shape), scale=scale)
    x[0, :2] = [0.5, -1.5] if scale == 0.0 else x[0, :2]  # ties round to even on both sides
    jq, js = jax_quantize(jnp.asarray(x))
    tq, ts = quantize_activations(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _operands(M, K, N):
    """As tests/test_kernels.py makes them: activations and weights
    quantized per row (the weights along N after a transpose)."""
    a, w = _normal((M, K), seed=M + K + N), _normal((K, N), seed=1)
    a_q, a_s = jax_quantize(jnp.asarray(a))
    w_q, w_s = jax_quantize(jnp.asarray(w).T)
    return a, w, np.array(a_q), np.array(a_s), np.ascontiguousarray(np.asarray(w_q).T), \
        np.array(w_s)


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 384, 128), (384, 256, 512)])
def test_ref_and_wrappers_match_repro_kernel(M, K, N):
    a, w, a_q, a_s, w_q, w_s = _operands(M, K, N)
    kernel = np.asarray(jax_kernel(*(jnp.asarray(t) for t in (a_q, w_q, a_s, w_s)),
                                   interpret=True))
    ta_q, tw_q, ta_s, tw_s = (torch.from_numpy(t) for t in (a_q, w_q, a_s, w_s))
    ref = int8_matmul_ref(ta_q, tw_q, ta_s, tw_s)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jax_ref(*(jnp.asarray(t) for t in
                                                                   (a_q, w_q, a_s, w_s)))))
    np.testing.assert_allclose(ref.numpy(), kernel, rtol=RTOL, atol=ATOL)
    before = ops.launches
    out = ops.int8_matmul_op(ta_q, tw_q, ta_s, tw_s)
    lin = ops.quantized_linear(torch.from_numpy(a), {"q": tw_q, "s": tw_s})
    assert ops.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(out.numpy(), kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lin.numpy(), kernel, rtol=RTOL, atol=ATOL)
    # the Pallas epilogue's association, on the exact accumulator, is the kernel's bit for bit
    acc = int32_product(ta_q, tw_q)
    np.testing.assert_array_equal(pallas_epilogue(acc, ta_s, tw_s).numpy(), kernel)
    # quantized matmul approximates the f32 one to ~1-2%, as the JAX test says
    f32 = a @ w
    assert float(np.abs(lin.numpy() - f32).max() / np.abs(f32).max()) < 0.05


def test_int32_accumulator_is_exact_at_the_extremes():
    """K·127² must not round: all +127 against all -127 at K = 4096."""
    a = torch.full((3, 4096), 127, dtype=torch.int8)
    b = torch.full((4096, 2), -127, dtype=torch.int8)
    b[0, 1] = 126
    acc = int32_product(a, b)
    assert acc.dtype == torch.int32
    assert acc[0, 0].item() == -127 * 127 * 4096
    assert acc[0, 1].item() == -127 * 127 * 4095 + 127 * 126
    assert torch.equal(acc, a.to(torch.int32) @ b.to(torch.int32))


@pytest.mark.parametrize("M,K,N", [(100, 64, 256), (512, 208, 200), (5, 80, 1), (1, 1, 1)])
def test_quantized_linear_matches_repro_at_ragged_shapes(M, K, N):
    """`repro`'s quantized_linear takes its ref fallback at shapes that do
    not tile by 128; the weights are the int8 rep `quantize_tree` makes."""
    w = (_normal((K, N), seed=K * N) / np.sqrt(K)).astype(np.float32)
    jrep = jax_quantize_tree({"w0": jnp.asarray(w)})["w0"]
    trep = quantize_tree({"w0": torch.from_numpy(w)})["w0"]
    np.testing.assert_array_equal(trep["q"].numpy(), np.asarray(jrep["q"]))
    np.testing.assert_array_equal(trep["s"].numpy(), np.asarray(jrep["s"]))
    x = _normal((M, K), seed=M)
    ref = np.asarray(jax_ops.quantized_linear(jnp.asarray(x), jrep))
    out = ops.quantized_linear(torch.from_numpy(x), trep)
    assert out.shape == (M, N) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["a_dtype", "b_dtype", "k_mismatch", "scale_shape",
                                  "scale_dtype", "empty", "non_contiguous", "x_dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    a = torch.zeros(4, 8, dtype=torch.int8)
    b = torch.zeros(8, 6, dtype=torch.int8)
    a_s, b_s = torch.ones(4), torch.ones(6)
    if case == "x_dtype":
        with pytest.raises(TypeError):
            ops.quantized_linear(torch.zeros(4, 8, dtype=torch.float64), {"q": b, "s": b_s})
        return
    if case == "a_dtype":
        a = a.to(torch.int32)
    elif case == "b_dtype":
        b = b.to(torch.uint8)
    elif case == "k_mismatch":
        b = torch.zeros(7, 6, dtype=torch.int8)
    elif case == "scale_shape":
        a_s = torch.ones(5)
    elif case == "scale_dtype":
        b_s = b_s.double()
    elif case == "empty":
        a, a_s = torch.zeros(0, 8, dtype=torch.int8), torch.ones(0)
    elif case == "non_contiguous":
        b = torch.zeros(6, 8, dtype=torch.int8).T
    with pytest.raises((ValueError, TypeError)):
        ops.int8_matmul_op(a, b, a_s, b_s)
