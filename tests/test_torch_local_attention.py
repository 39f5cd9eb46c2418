"""The windowed-attention kernel's plain version, wrapper and gradient
against `repro`, on the CPU (the Hopper kernel itself runs in
tests/test_torch_cuda.py).

Tolerances: 1e-5 in f32 and 2e-2 in bf16 against `repro`'s Pallas kernel
(interpret mode) and its ref, as tests/test_kernels.py holds the TPU
kernel; 1e-5 absolute against `repro`'s taobao_ssa encoder block and for
gradients (f32 on both sides, other summation orders).
"""
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.local_attention.local_attention import local_attention as jax_kernel  # noqa: E402
from repro.kernels.local_attention.ops import windowed_attention_op as jax_op  # noqa: E402
from repro.kernels.local_attention.ref import local_attention_ref as jax_ref  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro.models.recsys import taobao_ssa as jax_ssa  # noqa: E402
from repro_torch.kernels.local_attention import ops  # noqa: E402
from repro_torch.kernels.local_attention.local_attention import (  # noqa: E402
    HEAD_DIMS, MAX_WARPS, ROWS_A_WARP, SMEM_BYTES, block_span, key_bytes, launch_plan, row_strides,
)
from repro_torch.kernels.local_attention.ref import local_attention_ref  # noqa: E402
from repro_torch.models.common import from_numpy_tree  # noqa: E402
from repro_torch.models.recsys import taobao_ssa  # noqa: E402
from torch_parity import small_configs  # noqa: E402

ATOL = 1e-5


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,window", [(256, 64), (512, 128), (512, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_and_op_match_repro_kernel_and_ref(causal, L, window, dtype):
    """The grid of tests/test_kernels.py: the same inputs through `repro`'s
    Pallas kernel (interpret mode), `repro`'s ref, the port's ref and the
    op on CPU tensors (which runs the ref)."""
    BH, dh = 2, 32
    q, k, v = _qkv((BH, L, dh), seed=L + window)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    kernel = np.asarray(jax_kernel(jq, jk, jv, window=window, causal=causal,
                                   interpret=True).astype(jnp.float32))
    ref32 = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, k, v)), window=window,
                               causal=causal))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    before = ops.launches
    out = ops.windowed_attention_op(tq[:, None], tk[:, None], tv[:, None], window=window,
                                    causal=causal)[:, 0]
    assert ops.launches == before  # CPU tensors take the plain version
    assert out.dtype == tdt and out.shape == (BH, L, dh)
    plain = local_attention_ref(tq, tk, tv, window=window, causal=causal)
    assert torch.equal(out, plain)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (kernel, ref32):
        np.testing.assert_allclose(out.float().numpy(), want, rtol=tol, atol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(
            plain.numpy(), np.asarray(jax_ref(jq, jk, jv, window=window, causal=causal)),
            rtol=0, atol=ATOL)


def _enc_params(d, seed):
    jcfg, _ = small_configs()
    enc = jax_init_params(jax_ssa.param_defs(jcfg), jax.random.key(seed))["enc0"]
    return enc, from_numpy_tree(jax.tree.map(np.asarray, enc), "cpu")


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("hist", ["zero", "one", "short", "mixed"])
def test_key_length_form_matches_repro_encoder_block(window, hist):
    """`repro`'s `_encoder_block` with its window and the history key mask,
    every row compared, rows with no valid key included (their output is
    the mean of v over all L positions, in both packages)."""
    B, L, d, H = 5, 20, 64, 4
    jenc, tenc = _enc_params(d, seed=window)
    x = np.random.default_rng(1).normal(size=(B, L, d)).astype(np.float32)
    hist_len = {"zero": [0] * B, "one": [1] * B, "short": [3, 2, 5, 1, 4],
                "mixed": [0, 1, 7, 20, 13]}[hist]
    hist_len = np.asarray(hist_len, np.int32)
    mask = np.arange(L)[None] < hist_len[:, None]
    ref_x, ref_p = jax_ssa._encoder_block(jenc, jnp.asarray(x), jnp.asarray(mask), H,
                                          window=window)
    before = ops.launches
    out, probs = taobao_ssa._encoder_block(tenc, torch.from_numpy(x), torch.from_numpy(mask), H,
                                           window=window, kv_len=torch.from_numpy(hist_len))
    assert probs is None and ops.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_x), rtol=0, atol=ATOL)
    out_c, probs_c = taobao_ssa._encoder_block(
        tenc, torch.from_numpy(x), torch.from_numpy(mask), H, window=window,
        kv_len=torch.from_numpy(hist_len), collect_attn=True)
    np.testing.assert_allclose(out_c.numpy(), np.asarray(ref_x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(probs_c.numpy(), np.asarray(ref_p), rtol=0, atol=ATOL)


def test_rows_without_a_valid_key_are_the_mean_of_v():
    B, H, L, dh = 2, 2, 12, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv((B, H, L, dh), seed=3))
    kv_len = torch.tensor([0, 2], dtype=torch.int32)
    out = ops.windowed_attention_op(q, k, v, window=3, kv_len=kv_len)
    mean = v.mean(dim=2, keepdim=True)
    torch.testing.assert_close(out[0], mean[0].expand(H, L, dh), rtol=0, atol=1e-6)
    # batch 1: rows 0..3 reach key 0 or 1; rows 4.. reach no key j < 2 within |i-j| < 3
    torch.testing.assert_close(out[1, :, 4:], mean[1].expand(H, L - 4, dh), rtol=0, atol=1e-6)
    assert float((out[1, :, :4] - mean[1]).abs().max()) > 1e-3
    assert bool(torch.isfinite(out).all())


def _jax_masked(q, k, v, window, causal, kv_len):
    """The model's jnp masked softmax: scores / sqrt(dh), -1e30 where masked."""
    L, dh = q.shape[2], q.shape[3]
    s = jnp.einsum("bhld,bhmd->bhlm", q, k) / jnp.sqrt(dh)
    i, j = jnp.arange(L)[:, None], jnp.arange(L)[None, :]
    valid = (jnp.abs(i - j) < window)[None, None]
    if causal:
        valid = valid & (j <= i)[None, None]
    if kv_len is not None:
        valid = valid & (jnp.arange(L)[None, :] < kv_len[:, None])[:, None, None, :]
    p = jax.nn.softmax(jnp.where(valid, s, -1e30).astype(jnp.float32), axis=-1)
    return jnp.einsum("bhlm,bhmd->bhld", p, v)


@pytest.mark.parametrize("window,causal,kv", [(4, False, True), (3, True, False),
                                              (30, False, True), (1, False, False)])
def test_gradients_match_jax_grad_of_the_masked_softmax(window, causal, kv):
    B, H, L, dh = 3, 2, 20, 16
    q, k, v = _qkv((B, H, L, dh), seed=window)
    g = np.random.default_rng(9).normal(size=(B, H, L, dh)).astype(np.float32)
    kv_len = np.asarray([0, 5, 20], np.int32) if kv else None

    def f(q, k, v):
        jk = None if kv_len is None else jnp.asarray(kv_len)
        return jnp.sum(_jax_masked(q, k, v, window, causal, jk) * g)

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.windowed_attention_op(tq, tk, tv, window=window, causal=causal,
                                    kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    (out * torch.from_numpy(g)).sum().backward()
    for name, got, want in (("q", tq.grad, ref[0]), ("k", tk.grad, ref[1]), ("v", tv.grad, ref[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL, err_msg=name)


def test_gradient_only_for_the_inputs_that_need_it():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 10, 16), seed=4))
    v.requires_grad_(True)
    ops.windowed_attention_op(q, k, v, window=2).sum().backward()
    assert q.grad is None and k.grad is None and v.grad.shape == v.shape


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "shape", "head_dim", "window_0",
                                  "window_float", "kv_dtype", "kv_shape", "non_contiguous",
                                  "misaligned_base", "ndim", "empty"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    q, k, v = (torch.randn(2, 2, 8, 16) for _ in range(3))
    kw = {"window": 3}
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "shape":
        v = torch.randn(2, 2, 9, 16)
    elif case == "head_dim":
        q, k, v = (torch.randn(2, 2, 8, 24) for _ in range(3))
    elif case == "window_0":
        kw["window"] = 0
    elif case == "window_float":
        kw["window"] = 3.0
    elif case == "kv_dtype":
        kw["kv_len"] = torch.tensor([3, 4])
    elif case == "kv_shape":
        kw["kv_len"] = torch.tensor([3, 4, 5], dtype=torch.int32)
    elif case == "non_contiguous":  # a strided last dimension (a transposed view is taken)
        q = torch.randn(2, 2, 8, 32)[..., ::2]
    elif case == "misaligned_base":
        q = torch.randn(2 * 2 * 8 * 16 + 1)[1:].view(2, 2, 8, 16)
    elif case == "ndim":
        q, k, v = q[0], k[0], v[0]
    elif case == "empty":
        q, k, v = (torch.randn(2, 2, 0, 16) for _ in range(3))
    with pytest.raises((ValueError, TypeError)):
        ops.windowed_attention_op(q, k, v, **kw)


def _views(B, L, H, dh, seed, bf16=False, grad=False):
    """q, k, v as `transpose(1, 2)` views [B, H, L, dh] of [B, L, H, dh]
    tensors (the taobao_ssa encoder's layout), their bases, and the same
    values as numpy [B, H, L, dh] arrays; `bf16`: values rounded to bf16."""
    rng = np.random.default_rng(seed)
    bases = []
    for _ in range(3):
        t = torch.from_numpy(rng.normal(size=(B, L, H, dh)).astype(np.float32))
        if bf16:
            t = t.bfloat16().float()
        bases.append(t.requires_grad_(grad))
    views = [t.transpose(1, 2) for t in bases]
    return views, bases, [np.ascontiguousarray(t.detach().numpy().transpose(0, 2, 1, 3))
                          for t in bases]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv", [False, True])
def test_op_on_transposed_views_matches_repro(bf16, causal, kv):
    """`windowed_attention_op` given `transpose(1, 2)` views of [B, L, H, dh]
    tensors, as the encoder hands them over, against `repro`'s op on the
    same values (its Pallas kernel in interpret mode at L = 128), or with a
    key mask against the model's masked softmax: f32 within 1e-5, bf16
    inputs cast to f32 likewise."""
    B, L, H, dh, window = 2, 128, 4, 16, 9
    views, _, arrs = _views(B, L, H, dh, seed=int(causal) + 2 * int(kv), bf16=bf16)
    assert not views[0].is_contiguous()
    kv_len = np.asarray([0, 70], np.int32) if kv else None
    before = ops.launches
    out = ops.windowed_attention_op(*views, window=window, causal=causal,
                                    kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    assert ops.launches == before and out.shape == (B, H, L, dh)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    if kv:
        want = _jax_masked(jq, jk, jv, window, causal, jnp.asarray(kv_len))
    else:
        want = jax_op(jq, jk, jv, window=window, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal,kv", [(False, True), (True, False)])
def test_gradients_through_views_match_jax_grad(causal, kv):
    """The gradient reaches the [B, L, H, dh] tensors behind the views and
    equals `jax.grad` of the model's masked softmax."""
    B, L, H, dh, window = 3, 20, 2, 16, 5
    views, bases, arrs = _views(B, L, H, dh, seed=11, grad=True)
    g = np.random.default_rng(12).normal(size=(B, H, L, dh)).astype(np.float32)
    kv_len = np.asarray([0, 7, 20], np.int32) if kv else None

    def f(q, k, v):
        jk = None if kv_len is None else jnp.asarray(kv_len)
        return jnp.sum(_jax_masked(q, k, v, window, causal, jk) * g)

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    out = ops.windowed_attention_op(*views, window=window, causal=causal,
                                    kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    (out * torch.from_numpy(g)).sum().backward()
    for name, base, want in zip("qkv", bases, ref):
        np.testing.assert_allclose(base.grad.numpy().transpose(0, 2, 1, 3), np.asarray(want),
                                   rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("BH,L,dh,window,causal,elem", [
    (2048, 100, 16, 32, False, 4), (148, 100, 16, 32, False, 2), (8, 2048, 64, 256, False, 4),
    (6, 200, 32, 64, True, 4), (4, 300, 128, 50, True, 2), (6, 1, 16, 4, False, 4),
    (1, 65, 32, 64, True, 4), (6, 130, 64, 17, False, 4), (2, 300, 128, 50, False, 4),
    (4096, 4096, 128, 4096, False, 4)])
def test_launch_plan_covers_every_row_within_shared_memory(BH, L, dh, window, causal, elem):
    """The pure launch plan: every query row in one block, 16 rows a warp,
    enough threads for v's mean, the staged tiles within SMEM_BYTES (one
    tile where a block's key span fits, else two buffers of a multiple of 8
    keys), and at the C2 ranker's call four warps a block, two blocks a
    (b, h), each with its whole key span in one tile."""
    plan = launch_plan(BH, L, dh, window, causal, elem)
    assert dh in HEAD_DIMS and plan.rows == plan.warps * ROWS_A_WARP
    assert 1 <= plan.warps <= MAX_WARPS and 32 * plan.warps >= dh
    assert plan.q_tiles * plan.rows >= L > (plan.q_tiles - 1) * plan.rows
    row_bytes = key_bytes(dh, elem)
    assert plan.smem == plan.buffers * plan.keys * row_bytes <= SMEM_BYTES
    span = block_span(L, plan.rows, window, causal)
    if span * row_bytes <= SMEM_BYTES:
        assert (plan.keys, plan.buffers) == (span, 1)
    else:
        assert plan.buffers == 2 and plan.keys % 8 == 0 and 8 <= plan.keys < span
    if (BH, L, dh, window) == (2048, 100, 16, 32):
        assert (plan.warps, plan.rows, plan.keys, plan.q_tiles) == (4, 64, 100, 2)


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_staged_rows_put_a_fragments_loads_in_other_banks(dh, elem):
    """A fragment of q·kᵀ reads rows (of q or k) g = 0..7 at dims 2t, 2t + 1
    (t = 0..3) at once; one of p·v reads keys 2t, then 2t + 1, at dim g. Padded as the
    kernel pads them, the lanes' 4-byte words fall in distinct banks (f32:
    a half-warp's 8-byte loads, then each 4-byte load; bf16: two lanes may
    share a word), and every row is a whole number of 16-byte copies."""
    ks, vs = row_strides(dh, elem)
    assert ks >= dh and vs >= dh and ks * elem % 16 == 0 and vs * elem % 16 == 0
    assert key_bytes(dh, elem) == (ks + vs) * elem
    if elem == 4:
        for half in (range(0, 4), range(4, 8)):
            words = [g * ks + 2 * t + i for g in half for t in range(4) for i in range(2)]
            assert len({w % 32 for w in words}) == 32
        for key in (0, 1):
            assert len({((2 * t + key) * vs + g) % 32 for t in range(4) for g in range(8)}) == 32
    else:
        assert len({(g * ks + 2 * t) // 2 % 32 for g in range(8) for t in range(4)}) == 32
        for key in (0, 1):
            words = {((2 * t + key) * vs + g) // 2 for t in range(4) for g in range(8)}
            assert len({w % 32 for w in words}) == len(words) == 16
