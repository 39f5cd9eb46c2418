"""The Hopper kernels (embedding_bag, fm_interaction, augru) against their
plain PyTorch versions, on the card.

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
- augru: 1e-5 absolute (h lies in (-1, 1); f32 throughout, TF32 off).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.augru import ops as augru_ops  # noqa: E402
from repro_torch.kernels.augru.ref import augru_ref  # noqa: E402
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
