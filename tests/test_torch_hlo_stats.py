"""The dry run's counter (`launch/hlo_stats.Counter`) and the kernel wrappers'
shape-only path, on the CPU.

The counter's flops mirror `tests/test_sharding_and_hlo.py`'s checks of
`repro`'s HLO statistics: a loop of 8 products counts 8 of them, a nested
8 x 4 loop 32, the gradient 3x the forward and 4x under
`torch.utils.checkpoint`, its bytes exceed the operands', and the one
function's `top_computations` entry is all of `flops`. Each holds on real
tensors and on fake ones (`FakeTensorMode`, the dry run's). The memory
count holds a program of three 4 MiB temporaries, two alive at once, to
8 MiB exactly. The collectives of `distributed/collectives.py` on a fake
process group of 4 ranks (in a subprocess: the group is process-global)
count `repro`'s ring model's bytes. Under `FakeTensorMode` each of the six
kernel wrappers gives the plain version's shape and dtype on real tensors
of the same shapes, counts no launch, and hands the counter the work of its
`kernels/work` formula; on real CPU tensors it still runs the plain version.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.kernels import work  # noqa: E402
from repro_torch.kernels.augru import ops as augru_ops  # noqa: E402
from repro_torch.kernels.augru.ref import augru_ref  # noqa: E402
from repro_torch.kernels.block_pruned_matmul import ops as bpm_ops  # noqa: E402
from repro_torch.kernels.block_pruned_matmul.ref import block_pruned_matmul_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.fm_interaction import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as int8_ops  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref  # noqa: E402
from repro_torch.kernels.local_attention import ops as la_ops  # noqa: E402
from repro_torch.kernels.local_attention.ref import local_attention_ref  # noqa: E402
from repro_torch.launch import bench_kernels as bk  # noqa: E402
from repro_torch.launch.hlo_stats import Counter, count  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FWD = 2 * 64 * 128 * 128 * 8  # 8 products of [64,128] @ [128,128]
MiB4 = 4 * 2**20


def _mode(fake):
    return FakeTensorMode() if fake else torch.no_grad()


def _loop(x, w):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def _inputs(grad=False):
    x = torch.randn(64, 128, requires_grad=grad)
    w = torch.randn(8, 128, 128, requires_grad=grad)
    return x, w


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_loop_flops_counted_once_a_product(fake):
    with _mode(fake):
        x, w = _inputs()
        st = count(_loop, (x, w))[1]
    assert st["flops"] == FWD


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_nested_loop_flops(fake):
    def f(x, w):
        for i in range(w.shape[0]):
            for _ in range(4):
                x = torch.tanh(x @ w[i])
        return x

    with _mode(fake):
        x, w = _inputs()
        st = count(f, (x, w))[1]
    assert st["flops"] == FWD * 4


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "checkpoint"])
def test_gradient_flops_are_the_forwards_and_two_products_a_product(fake, remat):
    """Forward 1x, backward 2x (each product's two operand gradients); a
    checkpointed forward is recomputed in the backward: 4x, as XLA counts
    remat."""
    def train(x, w):
        with torch.enable_grad():
            y = checkpoint(_loop, x, w, use_reentrant=False) if remat else _loop(x, w)
            return torch.autograd.grad(y.sum(), (x, w))

    ctx = FakeTensorMode() if fake else torch.enable_grad()
    with ctx:
        x, w = _inputs(grad=True)
        st = count(train, (x, w))[1]
    assert st["flops"] == FWD * (4 if remat else 3)


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_bytes_and_top_computations(fake):
    with _mode(fake):
        x, w = _inputs()
        st = count(_loop, (x, w))[1]
    assert st["bytes_hbm"] > 8 * (64 * 128 + 128 * 128) * 4
    (name, flops), = st["top_computations"]
    assert name.endswith("_loop") and flops == st["flops"]
    assert st["collectives"]["total"] == 0 and st["kernels"] == {}


def test_an_outer_product_is_not_a_dot():
    """A product over a contracted dim of 1 is an elementwise multiply in
    XLA's program, so `repro` counts no dot flops for it; nor does the
    counter."""
    a, b = torch.randn(512, 1), torch.randn(1, 80)
    assert count(torch.mm, (a, b))[1]["flops"] == 0
    assert count(torch.mm, (a.T, torch.randn(512, 80)))[1]["flops"] == 2 * 80 * 512
    assert count(torch.mv, (torch.randn(80, 512), torch.randn(512)))[1]["flops"] == 2 * 80 * 512


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_memory_peak_of_three_temporaries_two_alive(fake):
    n = MiB4 // 4

    def prog(x):
        a = x * 2.0
        b = a + 1.0  # a and b alive: the peak
        del a
        c = b * 3.0  # b and c
        del b
        return c

    with _mode(fake):
        _, _, mem = count(prog, (torch.empty(n),), donate=(0,))
    assert mem == {"argument_bytes": MiB4, "output_bytes": MiB4, "temp_bytes": 2 * MiB4,
                   "alias_bytes": 0}


def test_an_output_in_a_donated_argument_is_an_alias():
    _, _, mem = count(lambda x: x.add_(1.0), (torch.zeros(1000),), donate=(0,))
    assert mem["alias_bytes"] == 4000 and mem["temp_bytes"] == 0


_COLLECTIVES = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.distributed import collectives as C
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_stats import Counter
from repro_torch.launch.mesh import make_mesh

dryrun.start_fake_group(4, rank=1)
g = make_mesh((1, 4), ("data", "model"), "cpu").get_group("model")
calls = {"gather": lambda t: C.gather(t, 0, g),
         "reduce_scatter": lambda t: C.reduce_scatter(t, 0, g),
         "all_to_all": lambda t: C.all_to_all(t, g), "all_reduce": lambda t: C.all_reduce(t, g),
         "sum_forward": lambda t: C.sum_forward(t, [g])}
out = {}
for name, fn in calls.items():
    for backward in (False, True):
        with FakeTensorMode():
            t = torch.empty(8, 16, requires_grad=backward)
            c = Counter()
            with c:
                y = fn(t)
                if backward:
                    torch.autograd.grad(y.sum(), t)
        st = c.stats()
        out[f"{name}:{backward}"] = [list(y.shape), st["collectives"], st["collective_counts"]]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def collectives():
    r = subprocess.run([sys.executable, "-c", _COLLECTIVES], capture_output=True, text=True,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO / "src")},
                       timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.splitlines()[-1])


BLOCK = 8 * 16 * 4  # the rank's f32 [8, 16]
# name -> (output shape, forward {kind: bytes}, backward's added {kind: bytes})
RING = {
    "gather": ([32, 16], {"all-gather": 4 * BLOCK}, {"reduce-scatter": 4 * BLOCK}),
    "reduce_scatter": ([2, 16], {"reduce-scatter": BLOCK}, {"all-gather": BLOCK}),
    "all_to_all": ([8, 16], {"all-to-all": BLOCK}, {"all-to-all": BLOCK}),
    "all_reduce": ([8, 16], {"all-reduce": 2 * BLOCK}, {"all-reduce": 2 * BLOCK}),
    "sum_forward": ([8, 16], {"all-reduce": 2 * BLOCK}, {}),
}


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("name", sorted(RING))
def test_collectives_count_the_ring_model_on_a_fake_group_of_four(collectives, name, backward):
    shape, fwd, bwd = RING[name]
    got_shape, coll, counts = collectives[f"{name}:{backward}"]
    want = dict(fwd)
    for k, v in (bwd if backward else {}).items():
        want[k] = want.get(k, 0) + v
    assert got_shape == shape
    assert {k: v for k, v in coll.items() if v and k != "total"} == want
    assert coll["total"] == sum(want.values())
    n_ops = (1 if fwd else 0) + (1 if backward and bwd else 0)
    assert sum(counts.values()) == n_ops


# ---------------------------------------------------------------------------
# The kernel wrappers' shape-only path
# ---------------------------------------------------------------------------


def _embedding_bag():
    table, idx = torch.randn(300, 8), torch.randint(100, 400, (6, 3), dtype=torch.int32)
    w = torch.rand(6, 3)
    return ("embedding_bag", eb_ops, lambda t, i, ww: eb_ops.embedding_bag_op(
                t, i, ww, row0=100, id_limit=400),
            lambda t, i, ww: embedding_bag_ref(t, i, ww, 100, 400), (table, idx, w),
            lambda t, i, ww: work.embedding_bag_work(t, i, ww, 100, dense=True))


def _fm():
    e = torch.randn(6, 5, 4)
    return ("fm_interaction", fm_ops, fm_ops.fm_interaction_op, fm_interaction_ref, (e,),
            lambda e: work.fm_interaction_work(*e.shape))


def _augru():
    B, T, g = 3, 5, 8
    args = (torch.randn(B, T, 3 * g), torch.randn(g, 3 * g), torch.zeros(B, g),
            torch.rand(B, T), torch.ones(B, T, dtype=torch.bool))
    return ("augru", augru_ops, augru_ops.augru_op, augru_ref, args,
            lambda zx, wh, *_: work.augru_work(B, T, g))


def _bpm():
    x, w = torch.randn(5, 130), torch.randn(130, 140)
    bm = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    return ("block_pruned_matmul", bpm_ops, bpm_ops.block_pruned_matmul_op,
            block_pruned_matmul_ref, (x, w, bm),
            lambda x, w, bm: work.block_pruned_matmul_work(x, w, bm, dense=True))


def _la():
    q, k, v = (torch.randn(2, 3, 10, 16) for _ in range(3))
    kv = torch.tensor([7, 10], dtype=torch.int32)
    return ("local_attention", la_ops,
            lambda q, k, v, kv: la_ops.windowed_attention_op(q, k, v, window=3, causal=True,
                                                             kv_len=kv),
            lambda q, k, v, kv: local_attention_ref(q, k, v, window=3, causal=True, kv_len=kv),
            (q, k, v, kv), lambda q, k, v, kv: work.local_attention_work(q, 3, True, kv,
                                                                          dense=True))


def _int8():
    a, b = torch.randint(-127, 128, (5, 6), dtype=torch.int8), \
        torch.randint(-127, 128, (6, 7), dtype=torch.int8)
    return ("int8_matmul", int8_ops, int8_ops.int8_matmul_op, int8_matmul_ref,
            (a, b, torch.rand(5), torch.rand(7)), lambda a, b, *_: work.int8_matmul_work(5, 6, 7))


WRAPPERS = {f.__name__[1:]: f for f in (_embedding_bag, _fm, _augru, _bpm, _la, _int8)}


def _fake(mode, args):
    return tuple(mode.from_tensor(a) for a in args)


@pytest.mark.parametrize("case", sorted(WRAPPERS))
def test_shape_only_path_on_fake_tensors(case):
    name, ops, op, ref, args, work_of = WRAPPERS[case]()
    plain = ref(*args)
    before = ops.launches
    mode = FakeTensorMode()
    fakes = _fake(mode, args)
    c = Counter()
    with mode, c:
        out = op(*fakes)
    assert (out.shape, out.dtype, out.device) == (plain.shape, plain.dtype, plain.device)
    assert ops.launches == before
    w = work_of(*fakes)
    assert c.stats()["kernels"] == {name: {"calls": 1, "flops": w["flops"], "bytes": w["bytes"]}}
    assert w == work_of(*args)  # the dense work is a function of the shapes


@pytest.mark.parametrize("case", sorted(set(WRAPPERS) - {"int8"}))
def test_shape_only_path_traces_the_plain_backward(case):
    name, ops, op, ref, args, _ = WRAPPERS[case]()
    mode = FakeTensorMode()
    fakes = [a.requires_grad_() if a.is_floating_point() and a.dtype == torch.float32 else a
             for a in _fake(mode, args)]
    wrt = [a for a in fakes if a.requires_grad]
    c = Counter()
    with mode, c:
        grads = torch.autograd.grad(op(*fakes).sum(), wrt)
    assert [g.shape for g in grads] == [a.shape for a in wrt]
    assert c.stats()["kernels"][name]["calls"] == 1


@pytest.mark.parametrize("case", sorted(WRAPPERS))
def test_real_cpu_tensors_still_reach_the_plain_version(case):
    _, ops, op, ref, args, _ = WRAPPERS[case]()
    before = ops.launches
    c = Counter()
    with c, torch.no_grad():
        out = op(*args)
    assert torch.equal(out, ref(*args))
    assert ops.launches == before and c.stats()["kernels"] == {}


def test_fake_cuda_tensors_take_the_shape_only_path_without_a_card():
    """The path follows the tensor's type: a fake CUDA tensor launches
    nothing, so no card is needed (nor asked for the current device)."""
    mode = FakeTensorMode()
    with mode:
        e = torch.empty(4, 3, 5, device="cuda")
    with mode, Counter() as c:
        out = fm_ops.fm_interaction_op(e)
    assert out.shape == (4,) and out.device.type == "cuda"
    assert c.stats()["kernels"]["fm_interaction"]["calls"] == 1


def test_dense_work_equals_the_data_count_where_nothing_is_masked():
    q = torch.randn(2, 3, 40, 16)
    for window, causal in ((5, False), (5, True), (40, False), (60, True)):
        assert work.local_attention_work(q, window, causal, dense=True) == \
            work.local_attention_work(q, window, causal)
    x, w = torch.randn(5, 200), torch.randn(200, 130)
    ones = torch.ones(2, 2, dtype=torch.int32)
    assert work.block_pruned_matmul_work(x, w, ones, dense=True) == \
        work.block_pruned_matmul_work(x, w, ones)
    table, idx = torch.randn(50, 4), torch.randperm(50)[:12].reshape(4, 3).int()
    assert work.embedding_bag_work(table, idx, None, dense=True) == \
        work.embedding_bag_work(table, idx, None)


def test_bench_kernels_reads_the_moved_formulas():
    """The benchmark's rows take their work from `kernels/work`: the AUGRU
    row's formula (once written inline in the row) and the row range's."""
    B, T, g = 4096, 100, 108
    nbytes = 4 * B * T * 3 * g + 4 * g * 3 * g + 4 * B * g + 4 * B * T + B * T + 4 * B * g
    assert bk.augru_work(B, T, g) == bk.bound(nbytes, B * T * (6 * g * g + 16 * g))
    table = torch.randn(1000, 8)
    idx = torch.randint(0, 1000, (64, 1), dtype=torch.int32)
    block, row0 = table[500:750], 500
    local = idx.long() - row0
    mine = (local >= 0) & (local < 250)
    uniq = int(torch.unique(local[mine]).numel())
    assert bk.embedding_bag_work(block, idx, None, row0) == {
        **bk.bound(uniq * 8 * 4 + 64 * 4 + 64 * 8 * 4, 2 * int(mine.sum()) * 8),
        "distinct_rows": uniq}
