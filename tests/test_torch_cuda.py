"""The Hopper kernels (embedding_bag, fm_interaction, augru,
block_pruned_matmul) against their plain PyTorch versions, and the
gradients through them, on the card.

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
  lookup alone is the CPU's to the bit (each row summed in batch order).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.augru import ops as augru_ops  # noqa: E402
from repro_torch.kernels.augru.ref import augru_ref  # noqa: E402
from repro_torch.kernels.block_pruned_matmul import ops as bpm_ops  # noqa: E402
from repro_torch.kernels.block_pruned_matmul.ref import block_pruned_matmul_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.fm_interaction import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref  # noqa: E402

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
    from repro_torch.kernels.block_pruned_matmul.ref import expand_block_mask

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
