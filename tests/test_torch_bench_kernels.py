"""The port's kernel benchmark on the CPU: it refuses to time anything
without a card, and its bounds are the H100's for the work each row does,
counted from the shapes (the rows themselves run on the card, in
chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

from repro_torch.launch import bench_kernels as bk  # noqa: E402


def test_the_benchmark_times_cuda_kernels_only():
    with pytest.raises(ValueError, match="CUDA"):
        bk.run("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bk.run()


def test_bound_is_the_larger_of_bytes_and_operations():
    b = bk.bound(3.35e9, 67e9)  # 1 ms of bytes, 1 ms of f32 operations
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = bk.bound(3.35e9, 2 * 67e9)
    assert b["bound_ms"] == pytest.approx(2.0) and b["bound_by"] == "operations"
    assert bk.bound(0, 1979e9, bk.INT8_OPS)["bound_ms"] == pytest.approx(1.0)


@pytest.mark.parametrize("M,K,N,nbytes,ms", [(512, 512, 512, 1_576_960, 0.000471),
                                             (51200, 64, 256, 55_927_808, 0.016695)])
def test_int8_matmul_bound(M, K, N, nbytes, ms):
    b = bk.int8_matmul_work(M, K, N)
    assert b["bytes"] == nbytes and b["flops"] == 2 * M * N * K
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(ms, rel=1e-3)


def test_local_attention_bound_at_the_benchmark_shape():
    """BH 8, L 2048, window 256: 511 keys a row but fewer at both ends."""
    q = torch.empty(8, 1, 2048, 64)
    b = bk.local_attention_work(q, 256)
    assert b["pairs"] == 8 * (2048 * 511 - 255 * 256)
    assert b["bytes"] == 4 * 8 * 2048 * 64 * 4
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx((b["pairs"] * 259 + q.numel()) / 67e12 * 1e3)


def test_local_attention_bound_counts_the_key_lengths():
    """The C2 ranker's call: bytes bound it; only the valid pairs are
    counted, so shorter histories mean fewer operations."""
    q = torch.empty(512, 4, 100, 16)
    full = bk.local_attention_work(q, 32, kv_len=torch.full((512,), 100, dtype=torch.int32))
    short = bk.local_attention_work(q, 32, kv_len=torch.full((512,), 25, dtype=torch.int32))
    assert full["bytes"] == 4 * 512 * 4 * 100 * 16 * 4 + 512 * 4
    assert full["bound_by"] == "bytes" and full["bound_ms"] == pytest.approx(0.01565, rel=1e-3)
    rows = sum(min(i + 31, 99) - max(0, i - 31) + 1 for i in range(100))
    assert full["pairs"] == 512 * 4 * rows
    # a history of 25: row i reaches keys max(0, i-31) .. 24
    assert short["pairs"] == 512 * 4 * sum(max(0, 24 - max(0, i - 31) + 1) for i in range(100))
    # q's 56 rows that have a key, k's 25 keys, all of v (rows 56..99 are its mean), the output
    assert short["rows_without_keys"] == 512 * 4 * 44
    assert short["bytes"] == 512 * 4 * 16 * 4 * (56 + 25 + 100 + 100) + 512 * 4


def _needed_rows(n, L, window, causal):
    """Brute force over one request with history n: the query rows that have
    a valid key, the keys some query attends, the v rows the output reads,
    and the valid pairs."""
    def valid(i, j):
        return abs(i - j) < window and j < n and (not causal or j <= i)
    pairs = [(i, j) for i in range(L) for j in range(L) if valid(i, j)]
    live = {i for i, _ in pairs}
    keys = {j for _, j in pairs}
    return len(live), len(keys), L if len(live) < L else len(keys), len(pairs)


@pytest.mark.parametrize("kv_len,window,causal", [
    ([0], 4, False), ([1], 1, False), ([25], 32, False), ([25, 100, 56, 0], 32, True),
    ([30, 30, 30], 30, False), ([7, 3], 1, True)])
def test_local_attention_bound_reads_only_the_rows_the_function_needs(kv_len, window, causal):
    B, H, L, dh = len(kv_len), 3, 30, 16
    q = torch.empty(B, H, L, dh)
    b = bk.local_attention_work(q, window, causal, torch.tensor(kv_len, dtype=torch.int32))
    need = [_needed_rows(n, L, window, causal) for n in kv_len]
    rows = sum(r + k + v for r, k, v, _ in need)
    dead = sum(L - r for r, _, _, _ in need)
    pairs = H * sum(p for *_, p in need)
    assert b["bytes"] == H * dh * 4 * rows + q.numel() * 4 + 4 * B
    assert b["pairs"] == pairs and b["rows_without_keys"] == H * dead
    assert b["flops"] == pairs * (4 * dh + 3) + H * dead * L * dh + q.numel()


def test_local_attention_bound_at_the_rankers_histories():
    """Histories drawn as `taobao_batches` draws them (25..100) at window 32:
    the rows the function needs are well under all four tensors."""
    hist = np.random.default_rng(0).integers(25, 101, 512)
    b = bk.local_attention_work(torch.empty(512, 4, 100, 16), 32,
                                kv_len=torch.tensor(hist, dtype=torch.int32))
    need = [_needed_rows(int(n), 100, 32, False) for n in hist]
    tensor = 512 * 4 * 100 * 16 * 4  # one of q, k, v or the output, in bytes
    assert b["bytes"] == 4 * 16 * 4 * sum(r + k + v for r, k, v, _ in need) + tensor + 512 * 4
    assert 3.3 < b["bytes"] / tensor < 3.6
    assert b["bound_by"] == "bytes" and b["bound_ms"] < 0.01565


def test_kernel_cases_hold_the_wrapper_against_its_plain_version(monkeypatch):
    """The check half of the cases that chip_smoke.py and the benchmark share,
    on CPU tensors (whose wrappers take the plain path): it passes, and it
    fails once the wrapper's result is off by more than the tolerance. On
    the CPU `quantized_linear` multiplies in the ref's order, so a stand-in
    with the kernel's epilogue order takes its place."""
    from repro_torch.core.quantization import quantize_weight
    from repro_torch.kernels.int8_matmul.ref import (
        int32_product, pallas_epilogue, quantize_activations)

    def kernel_order(x, rep):
        x_q, x_s = quantize_activations(x)
        return pallas_epilogue(int32_product(x_q, rep["q"]), x_s, rep["s"])

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((3, 2, 40, 16), generator=gen) for _ in range(3))
    kv_len = torch.tensor([0, 5, 40], dtype=torch.int32)
    x = torch.randn((33, 70), generator=gen)
    rep = quantize_weight(torch.randn((70, 9), generator=gen) / 70 ** 0.5)
    la = bk.local_attention_case(q, k, v, window=8, kv_len=kv_len)
    assert la["ok"] and la["max_abs_err"] == 0.0 and la["kv_len_min"] == 0
    monkeypatch.setattr(bk.int8_ops, "quantized_linear", kernel_order)
    i8 = bk.int8_case(x, rep)
    assert i8["ok"] and i8["accumulator_equal"] and i8["equals_pallas_epilogue"]

    wrapper = bk.la_ops.windowed_attention_op
    monkeypatch.setattr(bk.la_ops, "windowed_attention_op",
                        lambda *a, **kw: wrapper(*a, **kw) + 2 * bk.LA_TOL)
    assert not bk.local_attention_case(q, k, v, window=8, kv_len=kv_len)["ok"]
    monkeypatch.setattr(bk.int8_ops, "quantized_linear", lambda x, rep: kernel_order(x, rep) + 1)
    assert not bk.int8_case(x, rep)["ok"]


def test_block_pruned_matmul_case_holds_the_plain_version_an_f64_product_and_repeats(monkeypatch):
    """The check half of the case chip_smoke.py and the benchmark share, on
    CPU tensors: it passes; an output within the plain version's rtol/atol
    but several times its f64 error fails it, as does one that changes
    between two launches."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((40, 200), generator=gen)
    w = torch.randn((200, 80), generator=gen) / 200 ** 0.5
    bm = torch.tensor([[1], [0]], dtype=torch.int32)
    rec = bk.block_pruned_matmul_case(x, w, bm)
    assert rec["ok"] and rec["bit_equal"] and rec["f64_ratio"] == 1.0
    assert rec["density"] == 0.5 and "plan" not in rec  # a plan is the card's
    op = bk.bpm_ops.block_pruned_matmul_op
    off = 10 * rec["plain_err_f64"]
    monkeypatch.setattr(bk.bpm_ops, "block_pruned_matmul_op", lambda *a: op(*a) + off)
    rec = bk.block_pruned_matmul_case(x, w, bm)
    assert rec["max_abs_err"] <= bk.BPM_ATOL and rec["f64_ratio"] > bk.BPM_F64_FACTOR
    assert not rec["ok"]
    calls = iter(range(10))
    monkeypatch.setattr(bk.bpm_ops, "block_pruned_matmul_op",
                        lambda *a: op(*a) + 1e-7 * next(calls))
    assert not bk.block_pruned_matmul_case(x, w, bm)["bit_equal"]


def test_block_pruned_matmul_bound_counts_3xtf32_and_keeps_the_f32_cores_beside_it():
    """The benchmark's 512^3 at 9 of 16 tiles: 2 operations a surviving
    weight and row at 165 TFLOP/s; bytes bound it either way."""
    x, w = torch.empty(512, 512), torch.empty(512, 512)
    bm = torch.zeros(4, 4, dtype=torch.int32)
    bm[:3, :3] = 1
    b = bk.block_pruned_matmul_work(x, w, bm)
    surviving = 9 * 128 * 128
    assert b["flops"] == 2 * 512 * surviving
    assert b["bytes"] == 4 * (512 * 384 + surviving + 16 + 512 * 512)
    ops_ms = b["flops"] / (495e12 / 3) * 1e3
    assert b["bound_ms"] == pytest.approx(max(ops_ms, b["bytes"] / 3.35e12 * 1e3))
    assert b["bound_ms_f32_cores"] == pytest.approx(max(b["flops"] / 67e12, b["bytes"] / 3.35e12)
                                                    * 1e3)
    assert b["bound_ms_f32_cores"] >= b["bound_ms"] and "3xTF32" in b["bound_peak"]


@pytest.mark.parametrize("nnz,weighted", [(1, False), (1, True), (7, True)])
def test_embedding_bag_case_holds_the_plain_version_and_repeats(monkeypatch, nnz, weighted):
    gen = torch.Generator().manual_seed(nnz)
    table = torch.randn((50, 10), generator=gen)
    idx = torch.randint(0, 50, (9, nnz), generator=gen, dtype=torch.int32)
    w = torch.rand((9, nnz), generator=gen) if weighted else None
    rec = bk.embedding_bag_case(table, idx, w)
    assert rec["ok"] and rec["bit_equal"] and rec["tol"] == (0.0 if nnz == 1 else rec["tol"])
    op = bk.eb_ops.embedding_bag_op
    monkeypatch.setattr(bk.eb_ops, "embedding_bag_op",
                        lambda *a: op(*a) + (1e-7 if nnz == 1 else 1e-3))
    assert not bk.embedding_bag_case(table, idx, w)["ok"]
    calls = iter(range(10))
    monkeypatch.setattr(bk.eb_ops, "embedding_bag_op", lambda *a: op(*a) * (1 + next(calls)))
    assert not bk.embedding_bag_case(table, idx, w)["bit_equal"]


def test_embedding_bag_bound_reads_each_distinct_row_once():
    table = torch.empty(100, 16)
    idx = torch.tensor([[1, 1, 2], [2, 3, 1]], dtype=torch.int32)
    b = bk.embedding_bag_work(table, idx, torch.empty(2, 3))
    assert b["distinct_rows"] == 3
    assert b["bytes"] == 3 * 16 * 4 + 6 * 4 + 6 * 4 + 2 * 16 * 4 and b["bound_by"] == "bytes"
