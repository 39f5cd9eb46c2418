"""The Hopper kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA card: a CUDA
kernel has no CPU mode. The file imports no JAX (the card's machine has
none), so it runs there with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance: exact where every bag is one row (the kernel stores the gathered
row), 1e-5 of the largest output otherwise (f32 sums in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402

SHAPES = [(4, 5, 16), (16, 10, 32), (8, 1, 64), (32, 1, 16), (32, 1, 64),
          (512, 100, 64), (51200, 1, 64), (512, 1, 16)]


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
def test_wrapper_refuses_what_the_kernel_does_not_take_on_card(cuda_device, case):
    """The kernel reads rows in 16-byte chunks: nothing else reaches it."""
    if case == "width_not_multiple_of_4":
        table = torch.randn(64, 10, device=cuda_device)
    else:
        table = torch.randn(64 * 16 + 1, device=cuda_device)[1:].view(64, 16)
    idx = torch.zeros(8, 3, dtype=torch.int32, device=cuda_device)
    before = ops.launches
    with pytest.raises(ValueError):
        ops.embedding_bag_op(table, idx)
    assert ops.launches == before
