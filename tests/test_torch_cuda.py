"""The Hopper kernels (embedding_bag, fm_interaction, augru,
block_pruned_matmul, local_attention, int8_matmul) against their plain
PyTorch versions, and the gradients through them, on the card.

Every test here is marked `cuda` and skips without an NVIDIA card: a CUDA
kernel has no CPU mode. The file imports no JAX (the card's machine has
none), so it runs there with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances:
- embedding_bag: exact where every bag is one row (the kernel stores the
  gathered row), 1e-5 of the largest output otherwise (f32 sums in another
  order);
- fm_interaction: rtol 1e-4, atol 1e-3, as the JAX kernel test, for the
  cancellation in (Σe)² − Σe²;
- augru: 1e-5 absolute (h lies in (-1, 1); f32 throughout, TF32 off);
- block_pruned_matmul: rtol 1e-5, atol 1e-4, as the JAX kernel test
  (f32 products of up to 300 terms in another order); its gradients and
  embedding_bag's table gradients against the CPU's within 1e-4 of their
  largest entry (matmul sums in another order); the table gradient of a
  lookup alone is the CPU's to the bit (each row summed in batch order);
- local_attention: 1e-5 absolute in f32 (outputs are means of O(1)
  values; f32 softmax in another order), 2e-2 in bf16 against the f32
  plain version of the same inputs, as the JAX kernel test;
- int8_matmul: the int32 accumulator equal to the plain version's (unit
  scales make it the output, exact in f32 below 2^24), the Pallas
  epilogue of it to the bit, `repro`'s ref within rtol 1e-6, atol 1e-4.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.augru import ops as augru_ops  # noqa: E402
from repro_torch.kernels.augru.ref import augru_ref  # noqa: E402
from repro_torch.kernels.block_pruned_matmul import ops as bpm_ops  # noqa: E402
from repro_torch.kernels.block_pruned_matmul.ref import (  # noqa: E402
    block_pruned_matmul_ref, expand_block_mask,
)
from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.fm_interaction import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as int8_ops  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import (  # noqa: E402
    int8_matmul_ref, int32_product, pallas_epilogue, quantize_activations,
)
from repro_torch.kernels.local_attention import ops as la_ops  # noqa: E402
from repro_torch.kernels.local_attention.ref import local_attention_ref  # noqa: E402

# taobao_ssa's widths (16, 64), FM's (1 with 39 ids a bag, 10) and DIEN's (18)
SHAPES = [(4, 5, 16), (16, 10, 32), (8, 1, 64), (32, 1, 16), (32, 1, 64),
          (512, 100, 64), (51200, 1, 64), (512, 1, 16),
          (512, 39, 1), (37, 39, 1), (19968, 1, 10), (300, 7, 10), (51200, 1, 18), (37, 5, 18)]


def _inputs(B, nnz, d, seed=0, V=4096):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V, (B, nnz)).astype(np.int32)
    w = rng.uniform(size=(B, nnz)).astype(np.float32)
    return table, idx, w


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,nnz,d", SHAPES)
@pytest.mark.parametrize("weighted", [True, False])
def test_kernel_matches_plain_version_on_card(cuda_device, B, nnz, d, weighted):
    table, idx, w = (torch.from_numpy(a).to(cuda_device) for a in _inputs(B, nnz, d))
    w = w if weighted else None
    before = ops.launches
    out = ops.embedding_bag_op(table, idx, w)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = embedding_bag_ref(table, idx, w)
    if nnz == 1 and not weighted:
        assert torch.equal(out, table[idx[:, 0].long()])
    elif nnz == 1:
        assert torch.equal(out, ref)
    else:
        tol = 1e-5 * float(ref.abs().max())
        assert float((out - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["width_not_multiple_of_4", "misaligned_table"])
def test_wrapper_takes_odd_widths_and_4_byte_aligned_tables_on_card(cuda_device, case):
    """A width that is not a multiple of 4, or a table that is only 4-byte
    aligned, takes the narrower loads and matches the plain version exactly."""
    if case == "width_not_multiple_of_4":
        table = torch.randn(64, 10, device=cuda_device)
    else:
        table = torch.randn(64 * 16 + 1, device=cuda_device)[1:].view(64, 16)
    idx = torch.randint(0, 64, (8, 1), dtype=torch.int32, device=cuda_device)
    before = ops.launches
    out = ops.embedding_bag_op(table, idx)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.equal(out, table[idx[:, 0].long()])


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,k", [(512, 39, 10), (37, 39, 10), (1, 39, 10), (256, 8, 16),
                                   (33, 5, 64), (9, 3, 40)])
def test_fm_interaction_matches_plain_version_on_card(cuda_device, B, F, k):
    e = torch.from_numpy(np.random.default_rng(B).normal(size=(B, F, k)).astype(np.float32))
    e = e.to(cuda_device)
    before = fm_ops.launches
    out = fm_ops.fm_interaction_op(e)
    torch.cuda.synchronize()
    assert fm_ops.launches == before + 1 and out.shape == (B,)
    torch.testing.assert_close(out, fm_interaction_ref(e), rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,g", [(512, 100, 108), (37, 100, 108), (1, 20, 108),
                                   (128, 20, 16), (5, 50, 32), (3, 7, 9)])
def test_augru_matches_plain_version_on_card(cuda_device, B, T, g):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(B + T + g)
    zx = rng.normal(size=(B, T, 3 * g)).astype(np.float32)
    wh = (rng.normal(size=(g, 3 * g)) * 0.3).astype(np.float32)
    h0 = (rng.normal(size=(B, g)) * 0.1).astype(np.float32)
    att = rng.uniform(size=(B, T)).astype(np.float32)
    mask = rng.uniform(size=(B, T)) > 0.2
    args = [torch.from_numpy(a).to(cuda_device) for a in (zx, wh, h0, att, mask)]
    before = augru_ops.launches
    out = augru_ops.augru_op(*args)
    torch.cuda.synchronize()
    assert augru_ops.launches == before + 1 and out.shape == (B, g)
    assert float((out - augru_ref(*args)).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_augru_refuses_a_state_too_wide_for_shared_memory(cuda_device):
    g = 137
    args = [torch.zeros(2, 3, 3 * g, device=cuda_device), torch.zeros(g, 3 * g, device=cuda_device),
            torch.zeros(2, g, device=cuda_device), torch.zeros(2, 3, device=cuda_device),
            torch.ones(2, 3, dtype=torch.bool, device=cuda_device)]
    before = augru_ops.launches
    with pytest.raises(ValueError, match="shared memory"):
        augru_ops.augru_op(*args)
    assert augru_ops.launches == before


# taobao_ssa's masked linears at a serve call of 512 requests (M = 512 or
# 512 x 100 tokens), densities 0 and 1, and ragged edges
BPM_SHAPES = [(51200, 64, 256, 0.5), (51200, 256, 64, 0.5), (51200, 64, 64, 1.0),
              (512, 208, 200, 0.75), (512, 200, 80, 0.5), (512, 80, 1, 1.0),
              (256, 256, 256, 0.0), (256, 256, 256, 1.0), (37, 300, 129, 0.5), (1, 1, 1, 1.0)]


def _bpm_inputs(M, K, N, density, device, seed=0):
    rng = np.random.default_rng(seed + M + K + N)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(device)
    bm = (rng.random((-(-K // 128), -(-N // 128))) < density).astype(np.int32)
    return x, w, torch.from_numpy(bm).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,density", BPM_SHAPES)
def test_block_pruned_matmul_matches_plain_version_on_card(cuda_device, M, K, N, density):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, bm = _bpm_inputs(M, K, N, density, cuda_device)
    before = bpm_ops.launches
    out = bpm_ops.block_pruned_matmul_op(x, w, bm)
    torch.cuda.synchronize()
    assert bpm_ops.launches == before + 1 and out.shape == (M, N)
    if density == 0.0:
        assert not bool(out.any())  # every tile pruned: zeros, written
    torch.testing.assert_close(out, block_pruned_matmul_ref(x, w, bm), rtol=1e-5, atol=1e-4)


def _close_to_cpu(card, host, name):
    scale = max(float(host.abs().max()), 1e-30)
    assert float((card.cpu() - host).abs().max()) <= 1e-4 * scale, name


@pytest.mark.cuda
def test_block_pruned_matmul_gradients_on_card_match_the_cpu(cuda_device):
    x, w, bm = _bpm_inputs(25600, 200, 80, 0.5, "cpu")
    bm[0, 0] = 1
    mask = expand_block_mask(bm, w.shape)
    g = torch.randn(25600, 80, generator=torch.Generator().manual_seed(0))
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev, copy=True).requires_grad_(True) for t in (x, w, mask)]
        before = bpm_ops.launches
        y = bpm_ops.block_pruned_matmul_op(leaves[0], leaves[1], bm.to(dev), leaves[2])
        (y * g.to(dev)).sum().backward()
        assert bpm_ops.launches == before + (dev != "cpu")
        grads[str(dev)] = [t.grad for t in leaves]
    for name, card, host in zip(("x", "w", "mask"), grads[str(cuda_device)], grads["cpu"]):
        _close_to_cpu(card, host, name)


@pytest.mark.cuda
def test_embedding_bag_backward_on_card_matches_the_cpu(cuda_device):
    table, idx, w = _inputs(512, 39, 10)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(512, 10)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        t = torch.from_numpy(table).to(dev).requires_grad_(True)
        wt = torch.from_numpy(w).to(dev).requires_grad_(True)
        out = ops.embedding_bag_op(t, torch.from_numpy(idx).to(dev), wt)
        assert out.grad_fn is not None
        (out * g.to(dev)).sum().backward()
        grads[str(dev)] = (t.grad, wt.grad)
    for name, card, host in zip(("table", "weights"), grads[str(cuda_device)], grads["cpu"]):
        _close_to_cpu(card, host, name)


@pytest.mark.cuda
def test_embedding_bag_table_gradient_repeats_bit_for_bit_on_card(cuda_device):
    """Rows read many times in a batch (V 64, 512 x 39 ids) sum their terms
    in batch order: two backwards give the same bits, the CPU's."""
    table, idx, w = _inputs(512, 39, 16, V=64)
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(512, 16)).astype(np.float32))
    grads = []
    for _ in range(2):
        t = torch.from_numpy(table).to(cuda_device).requires_grad_(True)
        out = ops.embedding_bag_op(t, torch.from_numpy(idx).to(cuda_device),
                                   torch.from_numpy(w).to(cuda_device))
        (out * g.to(cuda_device)).sum().backward()
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])
    want = torch.zeros(64, 16).index_add_(
        0, torch.from_numpy(idx).reshape(-1),
        (torch.from_numpy(w)[..., None] * g[:, None, :]).reshape(-1, 16))
    assert torch.equal(grads[0].cpu(), want)


@pytest.mark.cuda
def test_every_table_gets_its_gradient_through_the_kernel_on_card(cuda_device):
    """loss.backward() through taobao_ssa's lookups gives every f32 table a
    gradient, equal to the CPU's (the kernel's output used to carry none)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import taobao_batches
    from repro_torch.launch.serve import make_params
    from repro_torch.models.common import tree_from_leaves, tree_leaves
    from repro_torch.models.recsys import api

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("taobao_ssa")
    cfg = dataclasses.replace(cfg, fields=tuple(
        dataclasses.replace(f, vocab=min(f.vocab, 1000)) for f in cfg.fields), seq_len=20)
    params = make_params(cfg, torch.device("cpu"), seed=0)
    batch = next(taobao_batches(cfg, 64, 1, seed=3))
    grads = {}
    for dev in ("cpu", cuda_device):
        p = dict(tree_leaves(params))
        leaves = {k: v.detach().to(dev, copy=True).requires_grad_(True) for k, v in p.items()}
        tree = tree_from_leaves(leaves.items())
        before = ops.launches
        loss, _ = api.loss(tree, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, cfg)
        loss.backward()
        assert ops.launches == before + (5 if dev != "cpu" else 0)
        grads[str(dev)] = {k: t.grad for k, t in leaves.items()}
    for path, host in grads["cpu"].items():
        card = grads[str(cuda_device)][path]
        assert card is not None, path
        _close_to_cpu(card, host, path)
    for name in ("user", "item", "category"):
        assert float(grads[str(cuda_device)][("tables", name)].abs().sum()) > 0


@pytest.mark.cuda
def test_kernels_without_a_backward_raise_under_grad(cuda_device):
    e = torch.randn(8, 3, 5, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fm_ops.fm_interaction_op(e)
    with torch.no_grad():
        assert fm_ops.fm_interaction_op(e).shape == (8,)
    g = 9
    wh = torch.randn(g, 3 * g, device=cuda_device, requires_grad=True)
    args = [torch.randn(2, 4, 3 * g, device=cuda_device), wh, torch.zeros(2, g, device=cuda_device),
            torch.rand(2, 4, device=cuda_device), torch.ones(2, 4, dtype=torch.bool,
                                                            device=cuda_device)]
    with pytest.raises(RuntimeError, match="no backward"):
        augru_ops.augru_op(*args)
    with torch.no_grad():
        assert augru_ops.augru_op(*args).shape == (2, g)


# (B, H, L, dh, window, causal, kv_len): the C2 ranker's call (L 100, dh 16,
# window 32, history lengths from 0 to L), ragged L, causal, window 1 and
# >= L, the kernel benchmark's dh 64 at L 2048, dh 128
LA_SHAPES = [
    (64, 4, 100, 16, 32, False, "hist"), (37, 4, 100, 16, 32, False, "ragged"),
    (37, 4, 100, 16, 1, False, "ragged"), (37, 4, 100, 16, 100, False, "ragged"),
    (3, 2, 77, 32, 5, True, None), (2, 1, 2048, 64, 256, False, None),
    (1, 2, 300, 128, 50, True, None), (3, 2, 130, 64, 17, False, "zero_one_full"),
    (2, 3, 1, 16, 4, False, None), (1, 1, 65, 32, 64, True, None),
]


def _la_inputs(B, H, L, dh, kv, device, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed + B + L + dh)
    q, k, v = (torch.randn((B, H, L, dh), generator=gen).to(dtype).to(device) for _ in range(3))
    if kv is None:
        return q, k, v, None
    if kv == "hist":
        lens = torch.randint(L // 4, L + 1, (B,), generator=gen)
    elif kv == "ragged":
        lens = torch.tensor(([0, 1, 2, 25, 31, 32, 33, 99, 100] * 5)[:B])
    else:
        lens = torch.tensor([0, 1, L])[:B]
    return q, k, v, lens.to(torch.int32).to(device)


def _la_plain(q, k, v, window, causal, kv_len):
    B, H, L, dh = q.shape
    rows = None if kv_len is None else kv_len.repeat_interleave(H)
    flat = [t.float().reshape(B * H, L, dh) for t in (q, k, v)]
    return local_attention_ref(*flat, window=window, causal=causal,
                               kv_len=rows).reshape(B, H, L, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,dh,window,causal,kv", LA_SHAPES)
def test_local_attention_matches_plain_version_on_card(cuda_device, B, H, L, dh, window, causal,
                                                       kv):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, kv_len = _la_inputs(B, H, L, dh, kv, cuda_device)
    before = la_ops.launches
    out = la_ops.windowed_attention_op(q, k, v, window=window, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert la_ops.launches == before + 1 and out.shape == q.shape and out.dtype == q.dtype
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, _la_plain(q, k, v, window, causal, kv_len), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,dh,window,causal,kv", [LA_SHAPES[1], LA_SHAPES[4], LA_SHAPES[6]])
def test_local_attention_in_bf16_on_card(cuda_device, B, H, L, dh, window, causal, kv):
    q, k, v, kv_len = _la_inputs(B, H, L, dh, kv, cuda_device, dtype=torch.bfloat16)
    out = la_ops.windowed_attention_op(q, k, v, window=window, causal=causal, kv_len=kv_len)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), _la_plain(q, k, v, window, causal, kv_len),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_local_attention_rows_without_a_key_are_the_mean_of_v_on_card(cuda_device):
    q, k, v, _ = _la_inputs(2, 4, 100, 16, None, cuda_device)
    kv_len = torch.tensor([0, 25], dtype=torch.int32, device=cuda_device)
    out = la_ops.windowed_attention_op(q, k, v, window=32, kv_len=kv_len)
    mean = v.mean(dim=2, keepdim=True)
    torch.testing.assert_close(out[0], mean[0].expand(4, 100, 16), rtol=0, atol=1e-6)
    # rows 56..99 of a history of 25 reach no key j < 25 within |i - j| < 32
    torch.testing.assert_close(out[1, :, 56:], mean[1].expand(4, 44, 16), rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_local_attention_gradients_on_card_match_the_cpu(cuda_device):
    q, k, v, kv_len = _la_inputs(16, 4, 100, 16, "hist", "cpu")
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev, copy=True).requires_grad_(True) for t in (q, k, v)]
        before = la_ops.launches
        out = la_ops.windowed_attention_op(*leaves, window=32, kv_len=kv_len.to(dev))
        (out * g.to(dev)).sum().backward()
        assert la_ops.launches == before + (dev != "cpu")
        grads[str(dev)] = [t.grad for t in leaves]
    for name, card, host in zip("qkv", grads[str(cuda_device)], grads["cpu"]):
        _close_to_cpu(card, host, name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["head_dim", "non_contiguous", "kv_len_on_cpu", "dtype"])
def test_local_attention_refuses_what_the_kernel_does_not_take_on_card(cuda_device, case):
    q, k, v, kv_len = _la_inputs(2, 2, 40, 16, "ragged", cuda_device)
    if case == "head_dim":
        q, k, v = (torch.randn(2, 2, 40, 24, device=cuda_device) for _ in range(3))
    elif case == "non_contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "kv_len_on_cpu":
        kv_len = kv_len.cpu()
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    before = la_ops.launches
    with pytest.raises((ValueError, TypeError)):
        la_ops.windowed_attention_op(q, k, v, window=4, kv_len=kv_len)
    assert la_ops.launches == before


@pytest.mark.cuda
def test_windowed_taobao_ssa_on_card_matches_the_cpu(cuda_device):
    """The C2 ranker at a small size: serve probabilities within 1e-5 of the
    CPU's, two local-attention launches a call, the loss gradient of every
    leaf within 1e-4 of its largest entry."""
    import dataclasses

    from repro_torch.configs.base import get_config, with_attn_window
    from repro_torch.data.synthetic import taobao_batches
    from repro_torch.launch.serve import make_params
    from repro_torch.models.common import tree_from_leaves, tree_leaves
    from repro_torch.models.recsys import api

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("taobao_ssa")
    cfg = with_attn_window(dataclasses.replace(cfg, fields=tuple(
        dataclasses.replace(f, vocab=min(f.vocab, 1000)) for f in cfg.fields), seq_len=20), 4)
    params = make_params(cfg, torch.device("cpu"), seed=0)
    batch = next(taobao_batches(cfg, 64, 1, seed=3))
    batch["hist_len"][:3] = [0, 1, 2]
    probs, grads = {}, {}
    for dev in ("cpu", cuda_device):
        p = dict(tree_leaves(params))
        leaves = {k: v.detach().to(dev, copy=True).requires_grad_(True) for k, v in p.items()}
        tree = tree_from_leaves(leaves.items())
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = la_ops.launches
        with torch.no_grad():
            probs[str(dev)] = api.serve(tree, b, cfg).cpu()
        loss, _ = api.loss(tree, b, cfg)
        loss.backward()
        assert la_ops.launches == before + (4 if dev != "cpu" else 0)
        grads[str(dev)] = {k: t.grad for k, t in leaves.items()}
    assert float((probs[str(cuda_device)] - probs["cpu"]).abs().max()) <= 1e-5
    for path, host in grads["cpu"].items():
        _close_to_cpu(grads[str(cuda_device)][path], host, path)


# (M, K, N): the quantized ranker's FFN w1 at 512 requests, the kernel
# benchmark's 512³, the tower, ragged edges, one element, a K past 1000
INT8_SHAPES = [(51200, 64, 256), (512, 512, 512), (512, 208, 200), (513, 300, 129), (1, 1, 1),
               (37, 1001, 65), (100, 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_int8_matmul_matches_plain_version_on_card(cuda_device, M, K, N):
    gen = torch.Generator().manual_seed(M + K + N)
    x = torch.randn((M, K), generator=gen).to(cuda_device)
    w = (torch.randn((N, K), generator=gen) * 0.1).to(cuda_device)
    a_q, a_s = quantize_activations(x)
    w_q, w_s = quantize_activations(w)
    b_q = w_q.T.contiguous()
    acc = int32_product(a_q, b_q)
    before = int8_ops.launches
    unit = int8_ops.int8_matmul_op(a_q, b_q, torch.ones(M, device=cuda_device),
                                   torch.ones(N, device=cuda_device))
    out = int8_ops.quantized_linear(x, {"q": b_q, "s": w_s})
    torch.cuda.synchronize()
    assert int8_ops.launches == before + 2 and out.shape == (M, N)
    assert torch.equal(unit, acc.float())
    assert torch.equal(out, pallas_epilogue(acc, a_s, w_s))
    torch.testing.assert_close(out, int8_matmul_ref(a_q, b_q, a_s, w_s), rtol=1e-6, atol=1e-4)


@pytest.mark.cuda
def test_int8_matmul_accumulates_the_extremes_exactly_on_card(cuda_device):
    a = torch.full((70, 1000), 127, dtype=torch.int8, device=cuda_device)
    b = torch.full((1000, 70), -127, dtype=torch.int8, device=cuda_device)
    b[::3] = 127
    ones = torch.ones(70, device=cuda_device)
    out = int8_ops.int8_matmul_op(a, b, ones, ones)
    assert torch.equal(out, int32_product(a, b).float())


@pytest.mark.cuda
def test_int8_matmul_has_no_backward_and_refuses_bad_inputs_on_card(cuda_device):
    x = torch.randn(8, 16, device=cuda_device, requires_grad=True)
    rep = {"q": torch.ones(16, 4, dtype=torch.int8, device=cuda_device),
           "s": torch.ones(4, device=cuda_device)}
    with pytest.raises(RuntimeError, match="no backward"):
        int8_ops.quantized_linear(x, rep)
    with torch.no_grad():
        assert int8_ops.quantized_linear(x, rep).shape == (8, 4)
    before = int8_ops.launches
    with pytest.raises((ValueError, TypeError)):
        int8_ops.int8_matmul_op(torch.ones(8, 16, dtype=torch.int32, device=cuda_device),
                                rep["q"], torch.ones(8, device=cuda_device), rep["s"])
    with pytest.raises(ValueError):
        int8_ops.int8_matmul_op(torch.ones(8, 16, dtype=torch.int8, device=cuda_device),
                                rep["q"], torch.ones(8), rep["s"])
    assert int8_ops.launches == before


# ---------------------------------- the redesigned kernels under every launch

from repro_torch.kernels.block_pruned_matmul import block_pruned_matmul as bpm_kernel  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag as eb_kernel  # noqa: E402

# ragged M, K, N; masks whose every column keeps 32 or more rows of k (a
# checkerboard of 128-row stripes: a column's first stripe is whole, or K
# itself is short), where 3xTF32 promises f32's error
BPM_PLAN_SHAPES = [(37, 300, 129), (300, 257, 100), (2, 600, 300), (64, 160, 130), (513, 200, 80),
                   (5000, 36, 260), (1000, 8, 8), (3000, 130, 72), (7, 9, 3), (700, 16, 24),
                   (700, 32, 24), (900, 40, 72)]


def _checker_mask(K, N, density, device):
    kb, nb = -(-K // 128), -(-N // 128)
    if density == 0.5:
        m = [[int((i + j) % 2 == 0) for j in range(nb)] for i in range(kb)]
    else:
        m = [[int(density)] * nb for _ in range(kb)]
    return torch.tensor(m, dtype=torch.int32, device=device)


def _plans(M, K, N):
    plans = {"auto": None, "rows": bpm_kernel.Plan(0, 1, 1)}
    if K >= bpm_kernel.MIN_K_TC:
        for tile, (bm, bn) in bpm_kernel.TILES.items():
            gm = -(-M // bm)
            for splits in ((1,) if tile == bpm_kernel.TALL else (1, 2, 8)):
                plans[f"tile{tile}x{splits}"] = bpm_kernel.Plan(tile, min(gm, 65535), 1, splits)
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", BPM_PLAN_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_block_pruned_matmul_under_every_launch_plan_on_card(cuda_device, M, K, N, density):
    """Every tile the C entry takes (rows, tall, small with 1, 2 and 8 blocks
    of a cluster over K): within rtol 1e-5, atol 1e-4 of the plain version,
    within 2x the plain f32 version's error against an f64 product, and the
    same bits from two launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(M + K + N)
    x = torch.randn((M, K), generator=gen).to(cuda_device)
    w = (torch.randn((K, N), generator=gen) / K ** 0.5).to(cuda_device)
    bm = _checker_mask(K, N, density, cuda_device)
    ref = block_pruned_matmul_ref(x, w, bm)
    exact = x.double() @ (w * expand_block_mask(bm, (K, N))).double()
    plain_err = float((ref.double() - exact).abs().max())
    for name, plan in _plans(M, K, N).items():
        out = bpm_kernel.block_pruned_matmul(x, w, bm, plan)
        again = bpm_kernel.block_pruned_matmul(x, w, bm, plan)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4, msg=name)
        assert float((out.double() - exact).abs().max()) <= 2 * plain_err, name
        assert torch.equal(out, again), name
        if density == 0.0:
            assert not bool(out.any()), name


@pytest.mark.cuda
def test_block_pruned_matmul_where_a_column_keeps_fewer_than_32_rows_of_k(cuda_device):
    """K = 129 with only the last stripe (one row) kept: each output is one
    product, and on the tensor cores it carries 3xTF32's per-term error, not
    f32's single rounding; it stays within 2^-20 of |x||w|, and the rows
    path (f32 FMA) gives the plain version's bits."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((64, 129), generator=gen).to(cuda_device)
    w = torch.randn((129, 40), generator=gen).to(cuda_device)
    bm = torch.tensor([[0], [1]], dtype=torch.int32, device=cuda_device)
    exact = x[:, 128:].double() @ w[128:].double()
    for plan in (None, bpm_kernel.Plan(3, 2, 1)):
        out = bpm_kernel.block_pruned_matmul(x, w, bm, plan)
        assert bool(((out.double() - exact).abs() <= 2 ** -20 * exact.abs()).all())
    rows = bpm_kernel.block_pruned_matmul(x, w, bm, bpm_kernel.Plan(0, 1, 1))
    assert torch.equal(rows, block_pruned_matmul_ref(x, w, bm))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 10, 18, 32, 64])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("nnz", [2, 39, 100])
def test_embedding_bag_split_over_lanes_on_card(cuda_device, d, weighted, nnz):
    """Every split a bag of nnz ids can take at width d (and the plan's):
    within 1e-5 of the largest output of the plain version, the same bits
    from two launches."""
    table, idx, w = (torch.from_numpy(a).to(cuda_device) for a in _inputs(300, nnz, d, seed=d))
    w = w if weighted else None
    ref = embedding_bag_ref(table, idx, w)
    tol = 1e-5 * float(ref.abs().max())
    plan = eb_kernel.launch_plan(300, nnz, d, eb_kernel.load_width(table))
    splits = [s for s in (1, 2, 4, 8, 16, 32) if plan.group * s <= 32 and s <= nnz]
    assert plan.split in splits
    for split in splits:
        out = eb_kernel.embedding_bag(table, idx, w, split)
        again = eb_kernel.embedding_bag(table, idx, w, split)
        torch.cuda.synchronize()
        assert float((out - ref).abs().max()) <= tol, split
        assert torch.equal(out, again), split


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 10, 18, 64])
def test_embedding_bag_of_one_is_the_gathered_row_on_card(cuda_device, d):
    table, idx, w = (torch.from_numpy(a).to(cuda_device) for a in _inputs(5000, 1, d, seed=d))
    assert eb_kernel.launch_plan(5000, 1, d, eb_kernel.load_width(table)).split == 1
    assert torch.equal(ops.embedding_bag_op(table, idx), table[idx[:, 0].long()])
    assert torch.equal(ops.embedding_bag_op(table, idx, w), embedding_bag_ref(table, idx, w))


_OUT_OF_RANGE = """
import sys, torch
sys.path.insert(0, {src!r})
from repro_torch.kernels.embedding_bag import ops
table = torch.randn(100, {d}, device="cuda")
idx = torch.randint(0, 100, (64, {nnz}), dtype=torch.int32, device="cuda")
idx[5, {nnz} - 1] = {bad}
out = ops.embedding_bag_op(table, idx)
torch.cuda.synchronize()
print("NO FAULT", float(out.sum()))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("nnz,bad", [(1, 100), (39, 100), (39, -1)])
def test_embedding_bag_out_of_range_id_faults_on_card(cuda_device, nnz, bad):
    """An id outside [0, V) traps in the kernel before any read of the table
    (a bag of one, and a bag split over lanes): the launch fails and the
    process's next synchronise raises. In a subprocess, since the CUDA
    context is lost."""
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    code = _OUT_OF_RANGE.format(src=src, d=16, nnz=nnz, bad=bad)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "NO FAULT" not in r.stdout, r.stdout + r.stderr
