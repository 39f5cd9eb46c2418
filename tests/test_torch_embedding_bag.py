"""The port's EmbeddingBag (plain version, wrapper and model-level functions)
against `repro`'s Pallas kernel in interpret mode and its jnp oracle.

Tolerance: rtol=atol=1e-5 where a bag sums more than one row (the two
packages sum in different orders); exact where every bag is one row.
The Hopper kernel itself is held against the plain version on the card
by `test_torch_cuda.py`.
"""
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.embedding_bag.embedding_bag import embedding_bag as jax_kernel  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref  # noqa: E402
from repro.models.recsys import embedding as jax_emb  # noqa: E402
from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.models.recsys import embedding as emb  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(4, 5, 16), (16, 10, 32), (8, 1, 64), (32, 1, 16), (32, 1, 64)]


def _inputs(B, nnz, d, seed=0, V=500):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V, (B, nnz)).astype(np.int32)
    w = rng.uniform(size=(B, nnz)).astype(np.float32)
    return table, idx, w


def _check(ref, out, nnz):
    if nnz == 1:
        np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    else:
        np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,nnz,d", SHAPES)
@pytest.mark.parametrize("weighted", [True, False])
def test_plain_version_matches_pallas_kernel(B, nnz, d, weighted):
    table, idx, w = _inputs(B, nnz, d)
    if not weighted:
        w = np.ones_like(w)
    ref = jax_kernel(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), interpret=True)
    t_w = torch.from_numpy(w) if weighted else None
    out = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx), t_w)
    _check(ref, out, nnz)
    _check(jax_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)), out, nnz)


@pytest.mark.parametrize("B,nnz,d", SHAPES)
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_model_embedding_bag_matches_jax(B, nnz, d, combiner, masked):
    table, idx, _ = _inputs(B, nnz, d, seed=1)
    mask = (np.random.default_rng(2).random((B, nnz)) < 0.6) if masked else None
    ref = jax_emb.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                None if mask is None else jnp.asarray(mask), combiner)
    out = emb.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                            None if mask is None else torch.from_numpy(mask), combiner)
    if nnz == 1 and combiner == "sum":
        _check(ref, out, nnz)
    else:
        np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5, atol=1e-5)


def test_take_rows_f32_is_exact_and_int8_within_1e7():
    table, _, _ = _inputs(1, 1, 64, seed=3, V=1024)
    rows = np.random.default_rng(4).integers(0, 1000, (6, 20)).astype(np.int32)
    ref = jax_emb._take_rows(jnp.asarray(table), jnp.asarray(rows))
    out = emb._take_rows(torch.from_numpy(table), torch.from_numpy(rows))
    assert out.shape == (6, 20, 64)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())

    from repro.core.quantization import quantize_table as jax_quantize_table

    q = {k: np.array(v) for k, v in jax_quantize_table(jnp.asarray(table)).items()}
    ref = jax_emb._take_rows({k: jnp.asarray(v) for k, v in q.items()}, jnp.asarray(rows))
    out = emb._take_rows({k: torch.from_numpy(v) for k, v in q.items()}, torch.from_numpy(rows))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=0, atol=1e-7)


def test_wrapper_on_cpu_takes_plain_path_and_counts_nothing():
    table, idx, w = _inputs(8, 3, 16)
    before = ops.launches
    out = ops.embedding_bag_op(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w))
    assert ops.launches == before
    ref = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", ["f32_idx", "3d_table", "noncontig_table", "f64_table",
                                  "weights_shape", "empty_bag"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    table = torch.randn(50, 16)
    idx = torch.randint(0, 50, (4, 3), dtype=torch.int32)
    w = None
    expect = (TypeError, ValueError)
    if case == "f32_idx":
        idx = idx.float()
    elif case == "3d_table":
        table = table.reshape(50, 4, 4)
    elif case == "noncontig_table":
        table = torch.randn(16, 50).t()
    elif case == "f64_table":
        table = table.double()
    elif case == "weights_shape":
        w = torch.ones(4, 2)
    elif case == "empty_bag":
        idx = idx[:, :0].contiguous()
    with pytest.raises(expect):
        ops.embedding_bag_op(table, idx, w)


def _misaligned(V, d, offset):
    """A [V, d] view that starts `offset` floats into its storage."""
    return torch.from_numpy(np.random.default_rng(9).normal(size=V * d + offset).astype(np.float32)
                            )[offset:].view(V, d)


# FM's first-order (d=1, 39 ids a bag) and unified (d=10) tables, DIEN's
# d=18 tables, and tables whose data is only 4- or 8-byte aligned
@pytest.mark.parametrize("case", ["width_1", "width_10_not_multiple_of_4", "width_18",
                                  "misaligned_table", "table_8_byte_aligned"])
@pytest.mark.parametrize("nnz", [1, 39])
def test_wrapper_takes_any_width_and_a_4_byte_aligned_table(case, nnz):
    d = {"width_1": 1, "width_10_not_multiple_of_4": 10, "width_18": 18}.get(case, 16)
    table, idx, w = _inputs(24, nnz, d, seed=nnz + d)
    t = torch.from_numpy(table)
    if case == "misaligned_table":
        t = _misaligned(500, 16, 1)
    elif case == "table_8_byte_aligned":
        t = _misaligned(500, 16, 2)
    table = t.numpy()
    for weights in (None, w):
        out = ops.embedding_bag_op(t, torch.from_numpy(idx),
                                   None if weights is None else torch.from_numpy(weights))
        assert out.shape == (24, d)
        ref_w = np.ones_like(w) if weights is None else weights
        ref = jax_kernel(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(ref_w), interpret=True)
        _check(ref, out, nnz)
        plain = embedding_bag_ref(t, torch.from_numpy(idx),
                                  None if weights is None else torch.from_numpy(weights))
        assert torch.equal(out, plain)


@pytest.mark.parametrize("d,offset,vec", [(64, 0, 4), (16, 0, 4), (18, 0, 2), (10, 0, 2),
                                          (1, 0, 1), (16, 1, 1), (16, 2, 2), (18, 1, 1)])
def test_load_width_keeps_16_byte_loads_where_the_table_allows(d, offset, vec):
    """taobao_ssa's d=64 and d=16 tables keep the 16-byte path; d=10 and 18
    take 8 bytes, d=1 and a 4-byte-aligned table 4."""
    from repro_torch.kernels.embedding_bag.embedding_bag import load_width

    t = torch.zeros(8 * d + 4)[offset:offset + 8 * d].view(8, d)
    assert t.data_ptr() % 4 == 0 and (t.data_ptr() - offset * 4) % 16 == 0
    assert load_width(t) == vec


def test_importing_the_kernel_modules_needs_no_nvcc(tmp_path):
    """With no nvcc on PATH and no CUDA_HOME, every kernel module imports."""
    code = (
        "import shutil; assert shutil.which('nvcc') is None; "
        "import repro_torch.kernels._build, repro_torch.kernels.embedding_bag.ops, "
        "repro_torch.kernels.embedding_bag.embedding_bag, repro_torch.models.recsys.embedding, "
        "repro_torch.kernels.fm_interaction.ops, repro_torch.kernels.augru.ops, "
        "repro_torch.models.recsys.api"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO / "src"), "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("quantized", [False, True])
def test_unified_lookup_matches_jax(quantized, rec_rules):
    from repro.configs.base import FieldSpec as JField, RecSysConfig as JConfig
    from repro.core.quantization import quantize_table as jax_quantize_table
    from repro_torch.configs.base import FieldSpec, RecSysConfig

    vocabs = (30, 200, 7)
    jcfg = JConfig("u", "recsys", "fm", 16, tuple(JField(f"f{i}", v) for i, v in enumerate(vocabs)))
    tcfg = RecSysConfig("u", "recsys", "fm", 16, tuple(FieldSpec(f"f{i}", v) for i, v in enumerate(vocabs)))
    np.testing.assert_array_equal(jax_emb.unified_offsets(jcfg), emb.unified_offsets(tcfg))
    table, _, _ = _inputs(1, 1, 16, seed=5, V=256)
    rng = np.random.default_rng(6)
    sparse = np.stack([rng.integers(0, v, 12) for v in vocabs], axis=1).astype(np.int32)
    jt = jnp.asarray(table)
    tt = torch.from_numpy(table)
    if quantized:
        jt = jax_quantize_table(jt)
        tt = {k: torch.from_numpy(np.array(v)) for k, v in jt.items()}
    ref = jax_emb.unified_lookup(jt, jnp.asarray(sparse), jcfg, rec_rules)
    out = emb.unified_lookup(tt, torch.from_numpy(sparse), tcfg)
    assert out.shape == (12, 3, 16)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=0, atol=0 if not quantized else 1e-7)


@pytest.mark.parametrize("B,nnz,d", [(6, 1, 16), (5, 4, 64), (7, 3, 10), (4, 39, 1)])
@pytest.mark.parametrize("weighted", [True, False])
def test_gradients_match_jax_grad_of_the_gather(B, nnz, d, weighted):
    """d_table is the scatter-add of w·dy over the ids (repeated ids add up),
    d_weights the row-dy dot product: what jax.grad gives for repro's ref,
    within 1e-6 absolute for d_table (f32 sums of a few terms) and 1e-5
    relative for d_weights (a d-term dot product, up to ~16 here)."""
    import jax

    table, idx, w = _inputs(B, nnz, d, seed=B + d, V=9)  # few rows: ids repeat
    g = np.random.default_rng(0).normal(size=(B, d)).astype(np.float32)

    def f(t, wt):
        return jnp.sum(jax_ref(t, jnp.asarray(idx), wt if weighted else None) * g)

    ref_t, ref_w = jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(w))
    tt = torch.from_numpy(table).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True) if weighted else None
    out = ops.embedding_bag_op(tt, torch.from_numpy(idx), tw)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref_t), rtol=0, atol=1e-6)
    if weighted:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref_w), rtol=1e-5, atol=1e-6)


def test_table_gradient_sums_each_row_in_batch_order():
    """Ids read many times (V 16, 64 x 39 ids): each row's gradient is its
    terms added from the first to the last, the same bits every time."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 14, (64, 39)).astype(np.int32))  # rows 14, 15 unread
    rows = torch.from_numpy(rng.normal(size=(64 * 39, 8)).astype(np.float32))
    want = torch.zeros_like(table)
    for i, v in enumerate(idx.reshape(-1).tolist()):
        want[v] = want[v] + rows[i]
    for _ in range(3):
        assert torch.equal(ops._table_grad(table, idx, rows), want)


# ---------------------------------------------------------------- launch plan

from repro_torch.kernels.embedding_bag import embedding_bag as eb_kernel  # noqa: E402

# (B, nnz, d, vec): chip_smoke.py's lookups (taobao_ssa's history and user
# ids, its weighted item bag, FM's first-order and unified lookups, DIEN's
# history) and the kernel benchmark's 4096 bags of 20
MAIN_BAGS = [(51200, 1, 64, 4), (512, 1, 16, 4), (512, 100, 64, 4), (512, 39, 1, 1),
             (19968, 1, 10, 2), (51200, 1, 18, 2), (4096, 20, 32, 4)]


@pytest.mark.parametrize("B,nnz,d,vec", MAIN_BAGS + [(37, 3, 300, 4), (5, 2, 1, 1), (1, 1, 1, 1)])
def test_launch_plan_takes_only_splits_the_c_entry_accepts(B, nnz, d, vec):
    plan = eb_kernel.launch_plan(B, nnz, d, vec)
    chunks = d // vec
    assert plan.group in (1, 2, 4, 8, 16, 32) and (plan.group >= chunks or plan.group == 32)
    assert plan.group == 1 or plan.group // 2 < chunks  # the least power of two that covers d
    assert plan.split in (1, 2, 4, 8, 16, 32) and plan.group * plan.split <= 32
    assert plan.split <= nnz
    if nnz == 1:
        assert plan.split == 1  # a bag of one never splits: the gathered row, to the bit


@pytest.mark.parametrize("B,nnz,d,vec", MAIN_BAGS)
def test_launch_plan_fills_the_card_where_the_bags_allow(B, nnz, d, vec):
    """The lanes of all bags reach 132 x 1,024 unless the bags run out of ids
    to split or a bag's lanes fill a warp."""
    plan = eb_kernel.launch_plan(B, nnz, d, vec)
    threads = B * plan.group * plan.split
    assert threads >= eb_kernel.TARGET_THREADS or plan.group * plan.split * 2 > 32 \
        or plan.split * 2 > nnz


def test_fm_first_order_bags_spread_over_a_warp():
    """FM's d = 1 bags of 39: 32 lanes a bag, runs of 2 ids, where the old
    kernel walked all 39 with one lane."""
    assert eb_kernel.launch_plan(512, 39, 1, 1) == eb_kernel.Plan(group=1, split=32)
    assert eb_kernel.launch_plan(512, 100, 64, 4) == eb_kernel.Plan(group=16, split=2)


def _kernel_order(table, idx, w, split):
    """The kernel's order of the sum, in plain torch: each of `split` runs of
    ceil(nnz / split) contiguous ids from its first term (w·row, not
    0 + w·row), then the runs in a fixed tree (run s += run s + split/2,
    then /4, ...)."""
    B, nnz = idx.shape
    rows = table[idx.long()]
    if w is not None:
        rows = rows * w[..., None]
    run = -(-nnz // split)
    parts = []
    for s in range(split):
        part = torch.zeros(B, table.shape[1])
        for j in range(s * run, min(nnz, s * run + run)):
            part = rows[:, j] if j == s * run else part + rows[:, j]
        parts.append(part)
    off = split // 2
    while off >= 1:
        parts = [parts[s] + parts[s + off] for s in range(off)]
        off //= 2
    return parts[0]


@pytest.mark.parametrize("split,nnz", [(1, 1), (1, 2), (2, 2), (1, 39), (4, 39), (32, 39),
                                       (1, 100), (2, 100), (8, 100), (32, 100)])
@pytest.mark.parametrize("weighted", [False, True])
def test_the_split_order_is_within_the_tolerance_and_exact_for_bags_of_one(split, nnz, weighted):
    """Only the order of the sum changes with `split`: within 1e-5 of the
    largest output of the plain version (the tolerance the card holds the
    kernel to), and the bits of the plain version for bags of one."""
    table, idx, w = _inputs(24, nnz, 10, seed=nnz + split)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    tw = torch.from_numpy(w) if weighted else None
    ref = embedding_bag_ref(t, i, tw)
    got = _kernel_order(t, i, tw, split)
    if nnz == 1:
        assert torch.equal(got, ref)
    else:
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# ---------------------------------------------------------------- row range

RANGES = [(0, 128), (128, 128), (384, 116)]  # (row0, rows) blocks of a 500-row table


@pytest.mark.parametrize("row0,rows", RANGES)
@pytest.mark.parametrize("B,nnz,d", SHAPES)
@pytest.mark.parametrize("weighted", [True, False])
def test_row_range_is_repros_bag_over_the_ids_in_range(row0, rows, B, nnz, d, weighted):
    """The block [row0, row0 + rows) of a 500-row table: `repro`'s
    `embedding_bag_ref` over the ids in the block (weight 0 elsewhere), a
    bag with none of them 0; summed over the blocks that tile the table,
    the whole table's bag (each id in one block: bags of one exactly)."""
    table, idx, w = _inputs(B, nnz, d, seed=row0 + B)
    w = w if weighted else np.ones_like(w)
    mine = (idx >= row0) & (idx < row0 + rows)
    ref = jax_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w * mine))
    t_w = torch.from_numpy(w) if weighted else None
    block = torch.from_numpy(table[row0:row0 + rows])
    out = ops.embedding_bag_op(block, torch.from_numpy(idx), t_w, row0=row0, id_limit=500)
    _check(ref, out, nnz)
    assert torch.equal(out[torch.from_numpy(~mine.any(axis=1))], torch.zeros(1, d).expand(
        int((~mine.any(axis=1)).sum()), d))
    tiles = [(0, 100), (100, 300), (400, 100)]
    whole = sum(ops.embedding_bag_op(torch.from_numpy(table[a:a + n]), torch.from_numpy(idx), t_w,
                                     row0=a, id_limit=500) for a, n in tiles)
    _check(embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx), t_w), whole, nnz)


def test_row_range_reads_no_row_of_an_id_outside_it():
    """The plain version reads the block's rows only: a block of NaN rows
    past the ids' range leaves every output finite, and an id outside the
    whole table raises as the kernel traps."""
    block = torch.full((64, 8), float("nan"))
    idx = torch.tensor([[0, 5, 63], [64, 100, 127]], dtype=torch.int32)
    out = ops.embedding_bag_op(block, idx, row0=128, id_limit=256)
    assert torch.equal(out, torch.zeros(2, 8))
    with pytest.raises(IndexError):
        ops.embedding_bag_op(block, idx + 200, row0=128, id_limit=256)
    with pytest.raises(ValueError, match="not a block"):
        ops.embedding_bag_op(block, idx, row0=200, id_limit=256)


def test_row_range_table_gradient_adds_only_its_rows_in_batch_order():
    """The block [16, 24) of a 40-row table: each of its rows' gradient is
    its ids' terms added from the first to the last (the same bits every
    time), and an id outside the block adds to no row."""
    rng = np.random.default_rng(5)
    block = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (64, 9)).astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(64 * 9, 4)).astype(np.float32))
    want = torch.zeros_like(block)
    for i, v in enumerate(idx.reshape(-1).tolist()):
        if 16 <= v < 24:
            want[v - 16] = want[v - 16] + rows[i]
    for _ in range(3):
        assert torch.equal(ops._table_grad(block, idx, rows, 16, True), want)
    t = block.clone().requires_grad_()
    dy = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    (ops.embedding_bag_op(t, idx, row0=16, id_limit=40) * dy).sum().backward()
    assert torch.equal(t.grad, ops._table_grad(block, idx, dy[:, None, :].expand(64, 9, 4)
                                               .reshape(-1, 4), 16, True))
