"""The LM layers (`repro_torch.models.layers`) against `repro.models.layers`
on the same numpy inputs from a seed, on the CPU.

Tolerances, on the largest |Δ| over the largest |output| of `repro`'s:
- f32: 1e-5 (the same arithmetic, sums in another order; measured 5e-8 to
  2.7e-7 here);
- bf16: 2^-8, one bf16 step at the largest output (measured 0 in every case
  here, from seed 0: both packages round the same f32 values once, and
  the f32 products of bf16 operands are exact);
- the port's streaming softmax against its dense one: 1e-5 in f32, 1.6e-2
  in bf16 (measured 3.3e-3 to 6.0e-3: each chunk's probabilities are
  rounded to bf16 under that chunk's running max).
A wrong mask, head grouping or rotation moves the output by O(1). The
sparse decode's global sample positions are floors of `jnp.linspace`
points, so they are compared exactly, as is the dense decode's equality
with the sparse one where the window covers the whole prefix.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_workers  # noqa: E402,F401
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.common import numpy_from_tensor, tensor_from_numpy  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2.0**-8
FLASH_VS_DENSE_BF16_TOL = 1.6e-2
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _inputs(seed, dtype, *shapes):
    """numpy arrays of `shapes` from `seed`, rounded to `dtype` (bf16 as
    `ml_dtypes.bfloat16`, which both packages read with the same bits)."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        out = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in out]
    return out


def _t(a):
    return tensor_from_numpy(a)


def _f32(x):
    """`repro`'s or the port's output as f32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(ref, got, tol):
    ref, got = _f32(ref), _f32(got)
    assert ref.shape == got.shape
    err = float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))
    assert err <= tol, (err, tol)
    return err


def test_bf16_inputs_carry_across_with_the_same_bits():
    (a,) = _inputs(0, "bfloat16", (5, 7))
    t = _t(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(numpy_from_tensor(t), a.view(np.uint16))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norms(dtype, norm_type):
    x, scale = _inputs(1, dtype, (2, 5, 64), (64,))
    x = x * 3 + 1 if dtype == "float32" else x
    ref = jl.apply_norm(jnp.asarray(x), jnp.asarray(scale), norm_type)
    got = tl.apply_norm(_t(x), _t(scale), norm_type)
    assert got.dtype == _t(x).dtype
    _close(ref, got, _tol(dtype))
    fn = {"rmsnorm": (jl.rms_norm, tl.rms_norm), "layernorm": (jl.layer_norm, tl.layer_norm)}
    _close(fn[norm_type][0](jnp.asarray(x), jnp.asarray(scale)),
           fn[norm_type][1](_t(x), _t(scale)), _tol(dtype))


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.3])
def test_rope_freqs(fraction):
    inv_j, rot_j = jl.rope_freqs(32, fraction, 10_000.0)
    inv_t, rot_t = tl.rope_freqs(32, fraction, 10_000.0)
    assert rot_j == rot_t
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=F32_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fraction,theta", [(1.0, 10_000.0), (0.5, 10_000.0),
                                            (1.0, 5_000_000.0)])
def test_apply_rope(dtype, fraction, theta):
    (x,) = _inputs(2, dtype, (2, 40, 4, 32))
    pos = np.random.default_rng(3).integers(0, 4000, (2, 40)).astype(np.int32)
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction)
    got = tl.apply_rope(_t(x), torch.from_numpy(pos), theta, fraction)
    assert got.dtype == _t(x).dtype
    # positions up to 4,000 (angles up to 4,000 radians)
    _close(ref, got, _tol(dtype))
    if fraction == 0.5:  # chatglm3's "2d" RoPE leaves the second half as it was
        np.testing.assert_array_equal(_f32(got)[..., 16:], _f32(_t(x))[..., 16:])


def _qkv(seed, dtype, B, S, T, K, G, hd):
    return _inputs(seed, dtype, (B, S, K, G, hd), (B, T, K, hd), (B, T, K, hd))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,q_offset,S,T", [(True, 0, 24, 24), (False, 0, 8, 24),
                                                 (True, 16, 8, 24)])
def test_dense_attention(dtype, causal, q_offset, S, T):
    q, k, v = _qkv(4, dtype, 2, S, T, 2, 3, 16)
    ref = jl.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             q_offset=q_offset)
    got = tl.dense_attention(_t(q), _t(k), _t(v), causal=causal, q_offset=q_offset)
    _close(ref, got, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,q_offset,S", [(True, 0, 32), (False, 0, 32), (True, 16, 16)])
def test_flash_attention_over_kv_chunks(dtype, causal, q_offset, S):
    """T = 32 over chunks of 8: four steps of the streaming softmax."""
    q, k, v = _qkv(5, dtype, 2, S, 32, 2, 2, 16)
    args = dict(causal=causal, kv_chunk=8, q_offset=q_offset)
    ref = jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **args)
    got = tl.flash_attention(_t(q), _t(k), _t(v), **args)
    _close(ref, got, _tol(dtype))
    # and the streaming softmax equals the dense one
    dense = tl.dense_attention(_t(q), _t(k), _t(v), causal=causal, q_offset=q_offset)
    _close(dense, got, F32_TOL if dtype == "float32" else FLASH_VS_DENSE_BF16_TOL)


def test_flash_attention_at_or_below_one_chunk_is_dense_and_a_ragged_t_is_refused():
    q, k, v = _qkv(6, "float32", 1, 8, 8, 1, 2, 16)
    got = tl.flash_attention(_t(q), _t(k), _t(v), causal=True, kv_chunk=8)
    assert torch.equal(got, tl.dense_attention(_t(q), _t(k), _t(v), causal=True))
    q, k, v = _qkv(6, "float32", 1, 12, 12, 1, 2, 16)
    with pytest.raises(ValueError, match="multiple of kv_chunk"):
        tl.flash_attention(_t(q), _t(k), _t(v), causal=True, kv_chunk=8)


def test_flash_attention_remat_step_changes_no_number():
    q, k, v = (_t(a).requires_grad_(True) for a in _qkv(7, "float32", 1, 16, 16, 1, 2, 16))
    grads = []
    for remat in (False, True):
        out = tl.flash_attention(q, k, v, causal=True, kv_chunk=4, remat_step=remat)
        grads.append((out.detach(), *torch.autograd.grad(out.square().sum(), (q, k, v))))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention(dtype):
    q, k, v = _qkv(8, dtype, 3, 1, 20, 2, 2, 16)
    pos = np.array([0, 7, 19], np.int32)
    ref = jl.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    got = tl.decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(pos))
    _close(ref, got, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,n_global", [(4, 5), (8, 3), (64, 16), (16, 64)])
def test_sparse_decode_attention(dtype, window, n_global):
    """A window below `pos` (globals outside it count) and above it (every
    global sample lies inside and is masked as a duplicate); pos at 0, in
    the middle and at T - 1, where the window's start is clamped."""
    q, k, v = _qkv(9, dtype, 4, 1, 40, 2, 2, 16)
    pos = np.array([0, 5, 23, 39], np.int32)
    args = dict(window=window, n_global=n_global)
    ref = jl.sparse_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pos), **args)
    got = tl.sparse_decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(pos), **args)
    _close(ref, got, _tol(dtype))
    if window >= 40:  # the window holds every position <= pos: dense decode
        dense = tl.decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(pos))
        assert torch.equal(dense, got)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 128, 1024, 1000])
def test_global_sample_positions_are_repros_to_the_index(n):
    pos = np.arange(0, 5000, 7, dtype=np.int32)
    frac = jnp.linspace(0.0, 1.0, n)
    ref = np.asarray(jnp.floor(frac[None] * jnp.maximum(jnp.asarray(pos)[:, None], 1))
                     .astype(jnp.int32))
    frac_t = tl.jnp_linspace(1.0, n, "cpu")
    np.testing.assert_array_equal(frac_t.numpy(), np.asarray(frac))
    got = torch.floor(frac_t[None] * torch.clamp(torch.from_numpy(pos)[:, None], min=1).float())
    np.testing.assert_array_equal(got.to(torch.int32).numpy(), ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu(dtype):
    x, wg, wu, wd = _inputs(10, dtype, (2, 6, 32), (32, 48), (32, 48), (48, 32))
    ref = jl.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    got = tl.swiglu(*(_t(a) for a in (x, wg, wu, wd)))
    assert got.dtype == _t(x).dtype
    _close(ref, got, _tol(dtype))
