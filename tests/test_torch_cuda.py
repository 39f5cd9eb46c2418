"""The Hopper kernels (embedding_bag, fm_interaction, augru,
block_pruned_matmul, local_attention, int8_matmul) against their plain
PyTorch versions, the gradients through them, the cached lookup and
checkpoints, on the card.

Every test here is marked `cuda` and skips without an NVIDIA card: a CUDA
kernel has no CPU mode. The file imports no JAX (the card's machine has
none), so it runs there with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances:
- embedding_bag: exact where every bag is one row (the kernel stores the
  gathered row), 1e-5 of the largest output otherwise (f32 sums in another
  order);
- fm_interaction: rtol 1e-4, atol 1e-3, as the JAX kernel test, for the
  cancellation in (Σe)² − Σe²; two launches the same bits (every sum in
  a fixed order), under every launch plan;
- augru: 1e-5 absolute (h lies in (-1, 1); f32 throughout, TF32 off), and
  two launches the same bits (every sum in a fixed order);
- block_pruned_matmul: rtol 1e-5, atol 1e-4, as the JAX kernel test
  (f32 products of up to 300 terms in another order); its gradients and
  embedding_bag's table gradients against the CPU's within 1e-4 of their
  largest entry (matmul sums in another order); the table gradient of a
  lookup alone is the CPU's to the bit (each row summed in batch order);
- local_attention: 1e-5 absolute in f32 (outputs are means of O(1)
  values; f32 softmax in another order), 2e-2 in bf16 against the f32
  plain version of the same inputs, as the JAX kernel test; on views the
  same bits as on contiguous copies and as a second launch;
- fm_interaction's and augru's gradients (autograd Functions whose
  backward is plain PyTorch on either device): within 1e-4 of the largest
  entry of the CPU's, as the other gradients here, and two backwards the
  same bits; one kernel launch forward, none backward;
- the cached lookup (`core/caching.cached_embedding_bag`): bitwise the
  uncached lookup on the card, within 1e-5 of the largest output of the
  CPU's (f32 sums in another order); a checkpoint written from the card
  restores on the CPU, and back on the card, to the bit;
- int8_matmul: the int32 accumulator equal to the plain version's (unit
  scales make it the output, exact in f32 below 2^24), the Pallas
  epilogue of it to the bit, `repro`'s ref within rtol 1e-6, atol 1e-4;
  two launches the same bits, under every tile and grid;
- embedding_bag's row range: as embedding_bag above, against the plain
  version on the same block; the block's table gradient the CPU's bits;
- a recsys serve call through a one-rank NCCL mesh (`launch/cells`): the
  plain call's bits and launches;
- the LM's split-K decode attention (`layers.split_decode_attention`) over
  two gloo ranks sharing the card, each on its half of the cache: within
  1e-5 of the largest output of the whole cache's decode attention (f32:
  the softmax's sums in another order), 3e-2 in bf16 (the plain version
  rounds its probabilities to bf16), finite where a rank holds no key that
  counts, the same on both ranks;
- adam8bit across two gloo ranks sharing the card, on shared gradients:
  the CPU's one-rank update's bits (its scales divide by a tensor on the
  card, as the CPU divides); its update on the card waits for the card
  nowhere (the step count stays on the host), and three updates have the
  CPU's bits.
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


AUGRU_MODES = ["ragged", "mask_off", "mask_on", "att_0", "att_1"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", AUGRU_MODES)
@pytest.mark.parametrize("g", [1, 8, 18, 108, 136])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 37, 132, 133, 512, 4096])
def test_augru_under_every_launch_plan_on_card(cuda_device, B, g, mode):
    """Every rows-a-block the plan picks (4 up to 32 at B = 4096), every
    template instance of g, masks all off (h stays h0 to the bit), all on
    and ragged, attention 0 (the gate shut) and 1; two launches give the
    same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    T = 20
    rng = np.random.default_rng(B * 7 + g)
    zx = rng.normal(size=(B, T, 3 * g)).astype(np.float32)
    wh = (rng.normal(size=(g, 3 * g)) / np.sqrt(g)).astype(np.float32)
    h0 = (rng.normal(size=(B, g)) * 0.1).astype(np.float32)
    att = rng.uniform(size=(B, T)).astype(np.float32)
    mask = rng.uniform(size=(B, T)) > 0.2
    if mode == "mask_off":
        mask[:] = False
    elif mode == "mask_on":
        mask[:] = True
    elif mode in ("att_0", "att_1"):
        att[:] = float(mode[-1])
    args = [torch.from_numpy(a).to(cuda_device) for a in (zx, wh, h0, att, mask)]
    before = augru_ops.launches
    out = augru_ops.augru_op(*args)
    again = augru_ops.augru_op(*args)
    torch.cuda.synchronize()
    assert augru_ops.launches == before + 2 and out.shape == (B, g)
    assert torch.equal(out, again)
    assert float((out - augru_ref(*args)).abs().max()) <= 1e-5
    if mode == "mask_off":
        assert torch.equal(out, args[2])


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
    """int8_matmul has no backward and raises under grad; fm_interaction and
    augru, which had none before, now differentiate under grad on the card:
    one launch forward, none backward, and the CPU's gradient."""
    a = torch.randint(-127, 128, (4, 8), dtype=torch.int8, device=cuda_device)
    b = torch.randint(-127, 128, (8, 3), dtype=torch.int8, device=cuda_device)
    a_s = torch.rand(4, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        int8_ops.int8_matmul_op(a, b, a_s, torch.rand(3, device=cuda_device))
    e = torch.randn(8, 3, 5)
    grads = []
    for dev in ("cpu", cuda_device):
        et = e.to(dev).requires_grad_(True)
        before = fm_ops.launches
        out = fm_ops.fm_interaction_op(et)
        assert fm_ops.launches == before + (dev != "cpu")
        (g,) = torch.autograd.grad(out, et, torch.ones(8, device=dev))
        assert fm_ops.launches == before + (dev != "cpu")
        grads.append(g.cpu())
    _close_to_cpu(grads[1], grads[0], "fm e")
    gg = 9
    args = [torch.randn(2, 4, 3 * gg), torch.randn(gg, 3 * gg), torch.zeros(2, gg),
            torch.rand(2, 4), torch.ones(2, 4, dtype=torch.bool)]
    grads = []
    for dev in ("cpu", cuda_device):
        wh = args[1].to(dev).requires_grad_(True)
        before = augru_ops.launches
        out = augru_ops.augru_op(args[0].to(dev), wh, *(t.to(dev) for t in args[2:]))
        (g,) = torch.autograd.grad(out, wh, torch.ones(2, gg, device=dev))
        assert augru_ops.launches == before + (dev != "cpu")
        grads.append(g.cpu())
    _close_to_cpu(grads[1], grads[0], "augru wh")


def _small_recsys(arch):
    import dataclasses

    from repro_torch.configs.base import get_config

    cfg = get_config(arch)
    over = {"seq_len": 20} if arch in ("dien", "din") else {}
    return dataclasses.replace(cfg, fields=tuple(
        dataclasses.replace(f, vocab=min(f.vocab, 1000)) for f in cfg.fields), **over)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["fm", "dien"])
def test_fm_and_dien_gradients_on_card_match_the_cpu(cuda_device, arch):
    """The loss gradient of every leaf through fm_interaction's and augru's
    autograd Functions within 1e-4 of its largest entry of the CPU's; the
    kernel launches once a step, forward, and twice gives the same bits."""
    from repro_torch.data.synthetic import criteo_batches, taobao_batches
    from repro_torch.launch.serve import make_params
    from repro_torch.models.common import tree_from_leaves, tree_leaves
    from repro_torch.models.recsys import api

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _small_recsys(arch)
    params = make_params(cfg, torch.device("cpu"), seed=0)
    gen = criteo_batches if arch == "fm" else taobao_batches
    batch = next(gen(cfg, 64, 1, seed=3))
    kernel = fm_ops if arch == "fm" else augru_ops
    grads = {}
    for dev, runs in (("cpu", 1), (cuda_device, 2)):
        for run in range(runs):
            leaves = {k: v.detach().to(dev, copy=True).requires_grad_(True)
                      for k, v in tree_leaves(params)}
            tree = tree_from_leaves(leaves.items())
            before = kernel.launches
            loss, _ = api.loss(tree, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                               cfg)
            loss.backward()
            assert kernel.launches == before + (dev != "cpu")
            grads[(str(dev), run)] = {k: t.grad for k, t in leaves.items()}
    card, again = grads[(str(cuda_device), 0)], grads[(str(cuda_device), 1)]
    top = max(float(g.abs().max()) for g in grads[("cpu", 0)].values())
    for path, host in grads[("cpu", 0)].items():
        assert card[path] is not None, path
        # 1e-4 of the leaf's largest entry, or of a tenth of the whole
        # gradient's largest where the leaf's terms cancel: DIEN's output bias
        # at balanced labels is 3.9e-5, a sum of 64 terms of ~8e-3, and the
        # gradient's largest entry 6.4e-3 (measured on the card: 8.4e-9 from
        # the CPU's, against 6.4e-8 allowed)
        scale = max(float(host.abs().max()), 0.1 * top)
        assert float((card[path].cpu() - host).abs().max()) <= 1e-4 * scale, path
        assert torch.equal(card[path], again[path]), path
    assert float(card[("table",) if arch == "fm" else ("augru_wh",)].abs().sum()) > 0


def _recsys_batch(cfg, n, seed):
    from repro_torch.data.synthetic import criteo_batches, taobao_batches

    gen = criteo_batches if cfg.interaction in ("fm", "self_attn") else taobao_batches
    return next(gen(cfg, n, 1, seed=seed))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,variant,launches", [("din", "baseline", 5), ("din", "quantized", 0),
                                                   ("autoint", "baseline", 1)])
def test_din_and_autoint_serve_on_card_matches_the_cpu(cuda_device, arch, variant, launches):
    """DIN's and AutoInt's serve call on the card against the CPU's plain
    path from the same parameters, within 1e-5 on probabilities (f32 sums
    in another order, TF32 off), with the serve call's embedding_bag
    launches (an int8 table is gathered plainly); DIN's retrieval too."""
    from repro_torch.core.quantization import quantize_tree
    from repro_torch.launch.serve import make_params
    from repro_torch.models.common import tree_map
    from repro_torch.models.recsys import api

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _small_recsys(arch)
    params = make_params(cfg, torch.device("cpu"), seed=0)
    if variant == "quantized":
        params = quantize_tree(params)
    batch = {k: torch.from_numpy(v) for k, v in _recsys_batch(cfg, 64, 3).items()
             if k != "label"}
    card_params = tree_map(lambda t: t.to(cuda_device), params)
    before = ops.launches
    card = api.serve(card_params, {k: v.to(cuda_device) for k, v in batch.items()}, cfg)
    torch.cuda.synchronize()
    assert ops.launches == before + launches
    host = api.serve(params, batch, cfg)
    assert card.shape == host.shape == (64,)
    assert float((card.cpu() - host).abs().max()) <= 1e-5
    if arch == "din":
        query = {k: batch[k][:1] for k in ("user", "hist_item", "hist_category", "hist_len")}
        query["cand_category"] = batch["category"][:32]
        cand = batch["item"][:32]
        card = api.retrieval(card_params, {k: v.to(cuda_device) for k, v in query.items()},
                             cand.to(cuda_device), cfg)
        host = api.retrieval(params, query, cand, cfg)
        assert float((card.cpu() - host).abs().max()) <= 1e-5 * max(1.0, float(host.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["din", "autoint"])
def test_din_and_autoint_gradients_and_train_step_on_card_match_the_cpu(cuda_device, arch):
    """The loss gradient of every leaf through the lookups within 1e-4 of
    its largest entry of the CPU's (or of a tenth of the whole gradient's
    largest, where a leaf's terms cancel), the same bits twice, the serve
    call's lookups a step; then one AdamW `make_train_step` on each device,
    losses within 1e-5 relative and every updated leaf finite."""
    from repro_torch.launch.serve import make_params
    from repro_torch.models.common import tree_from_leaves, tree_leaves, tree_map
    from repro_torch.models.recsys import api
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.train_loop import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _small_recsys(arch)
    params = make_params(cfg, torch.device("cpu"), seed=0)
    batch = _recsys_batch(cfg, 64, 3)
    per_call = 5 if arch == "din" else 1
    grads = {}
    for dev, runs in (("cpu", 1), (cuda_device, 2)):
        for run in range(runs):
            leaves = {k: v.detach().to(dev, copy=True).requires_grad_(True)
                      for k, v in tree_leaves(params)}
            tree = tree_from_leaves(leaves.items())
            before = ops.launches
            loss, _ = api.loss(tree, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                               cfg)
            loss.backward()
            assert ops.launches == before + (per_call if dev != "cpu" else 0)
            grads[(str(dev), run)] = {k: t.grad for k, t in leaves.items()}
    card, again = grads[(str(cuda_device), 0)], grads[(str(cuda_device), 1)]
    top = max(float(g.abs().max()) for g in grads[("cpu", 0)].values())
    for path, host in grads[("cpu", 0)].items():
        assert card[path] is not None, path
        scale = max(float(host.abs().max()), 0.1 * top)
        assert float((card[path].cpu() - host).abs().max()) <= 1e-4 * scale, path
        assert torch.equal(card[path], again[path]), path
    opt = adamw(1e-3)
    step = make_train_step(lambda p, b: api.loss(p, b, cfg), opt)
    out = {}
    for dev in ("cpu", cuda_device):
        tree = tree_map(lambda t: t.to(dev), params)
        new, _, m = step(tree, opt.init(tree), {k: torch.from_numpy(v).to(dev)
                                                 for k, v in batch.items()})
        out[str(dev)] = (float(m["loss"]), new)
    (loss_h, _), (loss_c, new_c) = out["cpu"], out[str(cuda_device)]
    assert abs(loss_c - loss_h) <= 1e-5 * abs(loss_h)
    assert all(bool(torch.isfinite(t).all()) for _, t in tree_leaves(new_c))


@pytest.mark.cuda
@pytest.mark.parametrize("d,nnz,weighted,combiner", [
    (64, 16, False, "sum"), (64, 16, True, "mean"), (64, 1, False, "sum"), (18, 100, True, "sum"),
    (1, 39, False, "mean"), (10, 7, True, "sum")])
def test_cached_embedding_bag_equals_the_uncached_lookup_on_card(cuda_device, d, nnz, weighted,
                                                                 combiner):
    """Bitwise, for any mix of hits and misses: one kernel launch reduces the
    selected rows under the uncached call's launch plan."""
    from repro_torch.core import caching
    from repro_torch.data.synthetic import zipf_id_stream
    from repro_torch.models.recsys.embedding import embedding_bag

    V, B = 5000, 256
    gen = torch.Generator().manual_seed(d + nnz)
    table = torch.randn(V, d, generator=gen).to(cuda_device)
    stream = zipf_id_stream(40_000, V, 1.1, seed=11)
    resident = caching.build_resident_table(table, caching.hot_ids(stream, 512))
    idx = torch.from_numpy(stream[: B * nnz].reshape(B, nnz).astype(np.int32)).to(cuda_device)
    w = torch.rand(B, nnz, generator=gen).to(cuda_device) if weighted else None
    hits = caching.residency_mask(resident, idx)
    assert 0 < int(hits.sum()) < idx.numel()
    before = ops.launches
    cached = caching.cached_embedding_bag(table, resident, idx, mask=w, combiner=combiner)
    assert ops.launches == before + 1
    assert torch.equal(cached, embedding_bag(table, idx, mask=w, combiner=combiner))
    host = caching.cached_embedding_bag(table.cpu(), caching.build_resident_table(
        table.cpu(), caching.hot_ids(stream, 512)), idx.cpu(), None if w is None else w.cpu(),
        combiner)
    scale = float(host.abs().max())
    assert float((cached.cpu() - host).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_cached_embedding_bag_refuses_a_table_whose_rows_load_otherwise(cuda_device):
    from repro_torch.core import caching

    base = torch.randn(1001 * 64 + 1, device=cuda_device)
    table = base[1:].view(1001, 64)  # 4 bytes past a 16-byte boundary: 1 float a load
    resident = caching.build_resident_table(table, np.arange(8))
    idx = torch.randint(0, 1001, (16, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="floats at a time"):
        caching.cached_embedding_bag(table, resident, idx)


@pytest.mark.cuda
def test_a_checkpoint_written_from_the_card_restores_on_the_cpu(cuda_device, tmp_path):
    """A train step's parameters and AdamW and adam8bit state (int8 codes,
    the 0-d count) saved from the card restore on the CPU to the bit, and
    back on the card."""
    from repro_torch.data.synthetic import taobao_batches
    from repro_torch.launch.serve import make_params
    from repro_torch.models.recsys import api
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import get_optimizer
    from repro_torch.training.train_loop import make_train_step

    cfg = _small_recsys("taobao_ssa")
    params = make_params(cfg, cuda_device, seed=0)
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in next(taobao_batches(cfg, 32, 1, seed=3)).items()}
    for i, name in enumerate(("adamw", "adam8bit")):
        opt = get_optimizer(name, 1e-3)
        tree = make_train_step(lambda p, b: api.loss(p, b, cfg), opt)(
            params, opt.init(params), batch)[:2]
        checkpoint.save(tmp_path / name, 1, tree)
        leaves, _ = checkpoint.flatten(tree)
        for device in ("cpu", cuda_device):
            back, _ = checkpoint.flatten(checkpoint.restore(tmp_path / name, 1, tree,
                                                            device=device))
            assert len(back) == len(leaves)
            for a, b in zip(leaves, back):
                assert b.device.type == torch.device(device).type and b.dtype == a.dtype
                assert torch.equal(a.cpu(), b.cpu())
        assert any(x.dtype == torch.int8 for x in leaves) == (name == "adam8bit")


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


def _la_views(B, H, L, dh, kv, device, dtype=torch.float32, seed=0):
    """q, k, v as `transpose(1, 2)` views [B, H, L, dh] of [B, L, H, dh]
    tensors, the layout the taobao_ssa encoder hands over."""
    q, k, v, kv_len = _la_inputs(B, H, L, dh, kv, device, dtype, seed)
    return (*(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)), kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,L,dh,window,causal,kv", LA_SHAPES)
def test_local_attention_on_views_matches_plain_version_on_card(cuda_device, B, H, L, dh, window,
                                                                causal, kv, dtype):
    """On [B, L, H, dh] memory through [B, H, L, dh] views: within the
    tolerance of the plain version, the same bits as on contiguous copies
    of the same values and as a second launch, and the output a view of
    [B, L, H, dh] memory (the encoder reshapes it without a copy)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, kv_len = _la_views(B, H, L, dh, kv, cuda_device, dtype)
    assert not q.is_contiguous() or H == 1 or L == 1
    before = la_ops.launches
    out = la_ops.windowed_attention_op(q, k, v, window=window, causal=causal, kv_len=kv_len)
    again = la_ops.windowed_attention_op(q, k, v, window=window, causal=causal, kv_len=kv_len)
    copies = la_ops.windowed_attention_op(q.contiguous(), k.contiguous(), v.contiguous(),
                                          window=window, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert la_ops.launches == before + 3 and out.shape == q.shape and out.dtype == dtype
    assert torch.equal(out, again) and torch.equal(out, copies)
    assert out.transpose(1, 2).is_contiguous()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), _la_plain(q, k, v, window, causal, kv_len),
                               rtol=0 if dtype == torch.float32 else tol, atol=tol)


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
@pytest.mark.parametrize("case", ["head_dim", "non_contiguous", "misaligned_base",
                                  "kv_len_on_cpu", "dtype"])
def test_local_attention_refuses_what_the_kernel_does_not_take_on_card(cuda_device, case):
    q, k, v, kv_len = _la_inputs(2, 2, 40, 16, "ragged", cuda_device)
    if case == "head_dim":
        q, k, v = (torch.randn(2, 2, 40, 24, device=cuda_device) for _ in range(3))
    elif case == "non_contiguous":  # a strided last dimension (a transposed view is taken)
        q = torch.randn(2, 2, 40, 32, device=cuda_device)[..., ::2]
    elif case == "misaligned_base":
        q = torch.randn(2 * 2 * 40 * 16 + 1, device=cuda_device)[1:].view(2, 2, 40, 16)
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


# ------------------- fm_interaction and int8_matmul under their launch plans

from repro_torch.kernels.fm_interaction import fm_interaction as fm_kernel  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul as int8_kernel  # noqa: E402


def _fm_e(B, F, k, device, offset=0, seed=0):
    """e [B, F, k] normal, `offset` floats into its allocation (offset 1 puts
    its base off a 16-byte boundary)."""
    flat = np.random.default_rng(seed).normal(size=offset + B * F * k).astype(np.float32)
    return torch.from_numpy(flat).to(device)[offset:].view(B, F, k)


def _fm_holds(e, plan=None):
    """Within rtol 1e-4, atol 1e-3 of the plain version, and the same bits
    from a second launch."""
    out = fm_kernel.fm_interaction(e, plan)
    again = fm_kernel.fm_interaction(e, plan)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fm_interaction_ref(e), rtol=1e-4, atol=1e-3,
                               msg=lambda m: f"{plan}: {m}")
    assert torch.equal(out, again), plan


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 10, 16, 33])
@pytest.mark.parametrize("B", [1, 37, 511, 512, 65536])
def test_fm_interaction_at_every_batch_and_width_on_card(cuda_device, B, k):
    e = _fm_e(B, 39, k, cuda_device, seed=B + k)
    before = fm_ops.launches
    out = fm_ops.fm_interaction_op(e)
    assert fm_ops.launches == before + 1 and out.shape == (B,)
    _fm_holds(e)


@pytest.mark.cuda
@pytest.mark.parametrize("F,k", [(40, 2000), (60000, 1), (1, 60000), (3, 300)])
def test_fm_interaction_of_examples_too_wide_for_shared_memory_on_card(cuda_device, F, k):
    """F·k over the block's shared memory takes the wide kernel (an example
    a block, e read directly), never the plain version; (3, 300) runs it
    forced, at an example that would fit."""
    e = _fm_e(3, F, k, cuda_device, seed=F)
    plan = fm_kernel.launch_plan(3, F, k)
    assert plan.wide == (F * k > 3 * 300)
    _fm_holds(e)
    _fm_holds(e, fm_kernel.wide_plan(3, F, k))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("B,F,k", [(37, 39, 10), (512, 39, 10), (5, 3, 33), (9, 1, 1),
                                   (70, 7, 5)])
def test_fm_interaction_under_every_launch_plan_on_card(cuda_device, B, F, k, offset):
    """Chunks of 1, 2, 3, 4, 10 and B examples (where they fit in shared
    memory) and the wide branch, on e whose base lies 0-3 floats past a
    16-byte boundary (the chunk's 4-byte head and tail)."""
    e = _fm_e(B, F, k, cuda_device, offset=offset, seed=B)
    plans = [fm_kernel.chunk_plan(B, F, k, E) for E in (1, 2, 3, 4, 10, B)
             if fm_kernel.fits(E, F, k)]  # B = 512: 800 KB
    plans.append(fm_kernel.wide_plan(B, F, k))
    for plan in plans:
        _fm_holds(e, plan)


def _int8_operands(M, K, N, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    a_q = torch.randint(-128, 128, (M, K), generator=gen, dtype=torch.int8).to(device)
    b_q = torch.randint(-128, 128, (K, N), generator=gen, dtype=torch.int8).to(device)
    a_s = (torch.rand(M, generator=gen) * 0.02).to(device)
    b_s = (torch.rand(N, generator=gen) * 0.02).to(device)
    return a_q, b_q, a_s, b_s


def _int8_holds(a_q, b_q, a_s, b_s, plan=None):
    """With unit scales the output is the exact int32 accumulator (|acc| <
    2^24 here, so f32 holds it); with the scales, the Pallas epilogue of it
    to the bit; a second launch gives the same bits."""
    M, N = a_q.shape[0], b_q.shape[1]
    acc = int32_product(a_q, b_q)
    assert int(acc.abs().max()) < 2 ** 24
    ones_m, ones_n = torch.ones(M, device=a_q.device), torch.ones(N, device=a_q.device)
    unit = int8_kernel.int8_matmul(a_q, b_q, ones_m, ones_n, plan)
    out = int8_kernel.int8_matmul(a_q, b_q, a_s, b_s, plan)
    again = int8_kernel.int8_matmul(a_q, b_q, a_s, b_s, plan)
    torch.cuda.synchronize()
    assert torch.equal(unit, acc.float()), plan
    assert torch.equal(out, pallas_epilogue(acc, a_s, b_s)), plan
    assert torch.equal(out, again), plan


# ragged M, K and N on every side of the tiles and of the 64-byte K stages;
# K of 1,001 and 2,048 run 16 and 32 stages through the ring
INT8_PLAN_SHAPES = [(513, 300, 129), (37, 1001, 65), (1, 1, 1), (70, 2048, 40), (300, 64, 256),
                    (65, 200, 7), (129, 17, 250), (1000, 64, 256), (64, 128, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", INT8_PLAN_SHAPES)
def test_int8_matmul_under_every_tile_and_grid_on_card(cuda_device, M, K, N):
    """Each tile, with a block a tile, one block walking every M tile, and 2
    and 7 blocks along M walking theirs (the next tile's stages in flight
    while one is stored)."""
    ops_in = _int8_operands(M, K, N, cuda_device, seed=M + K + N)
    _int8_holds(*ops_in)
    for tile in int8_kernel.TILES:
        tiles_m = int8_kernel.m_tiles(M, tile)
        for grid_m in sorted({tiles_m, 1, min(2, tiles_m), min(7, tiles_m)}):
            _int8_holds(*ops_in, int8_kernel.tile_plan(M, K, N, tile, grid_m))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [0, 1])
@pytest.mark.parametrize("a_val,b_val", [(127, 127), (-128, -128), (127, -128), (-128, 127)])
def test_int8_matmul_accumulates_the_extremes_under_every_tile_on_card(cuda_device, tile, a_val,
                                                                       b_val):
    """All of a_q and b_q at the int8 extremes over K = 1,000 (|acc| up to
    16,384,000, just under 2^24), every third row of b_q flipped."""
    M, K, N = 70, 1000, 70
    a = torch.full((M, K), a_val, dtype=torch.int8, device=cuda_device)
    b = torch.full((K, N), b_val, dtype=torch.int8, device=cuda_device)
    b[::3] = 127 if b_val == -128 else -128
    ones = torch.ones(M, device=cuda_device)
    _int8_holds(a, b, ones, ones, int8_kernel.tile_plan(M, K, N, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("a_off,b_off", [(1, 0), (4, 0), (0, 1), (0, 8), (3, 12)])
def test_int8_matmul_on_views_off_16_byte_boundaries_on_card(cuda_device, a_off, b_off):
    """a_q and b_q views whose bases sit a_off and b_off bytes past 16: the
    binding lowers the copy widths to what the bases allow."""
    M, K, N = 96, 64, 48
    a_full, b_full, a_s, b_s = _int8_operands(M + 1, K, N + 1, cuda_device)
    a_q = a_full.flatten()[a_off:a_off + M * K].view(M, K)
    b_q = b_full.flatten()[b_off:b_off + K * N].view(K, N)
    assert (a_q.data_ptr() % 16 == 0) == (a_off % 16 == 0)
    _int8_holds(a_q, b_q, a_s[:M], b_s[:N])


@pytest.mark.cuda
def test_int8_matmul_refuses_a_forced_plan_of_another_shape_on_card(cuda_device):
    a_q, b_q, a_s, b_s = _int8_operands(64, 64, 64, cuda_device)
    with pytest.raises(ValueError):
        int8_kernel.int8_matmul(a_q, b_q, a_s, b_s, int8_kernel.launch_plan(640, 64, 64))
    with pytest.raises(ValueError):
        fm_kernel.fm_interaction(_fm_e(8, 39, 10, cuda_device), fm_kernel.chunk_plan(9, 39, 10, 4))


# The LM family (no kernel on its path): the training launcher's reduced
# config of each LM arch in f32, TF32 off, on the card against the CPU,
# within 1e-5 of the largest |logit| (f32 sums in another order); the loss
# within 1e-5 of itself. No kernel launches.
LM_ARCHS = ["yi_6b", "chatglm3_6b", "command_r_35b", "olmoe_1b_7b", "llama4_maverick_400b_a17b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_lm_forward_and_decode_on_card_match_the_cpu(cuda_device, arch):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.models.common import init_params, tree_map

    cfg = dataclasses.replace(train.reduced_config(get_config(arch)), dtype="float32")
    host = init_params(transformer.param_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(cuda_device), host)
    batch = next(train.make_data(cfg, 2, "cpu")(0))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    serve.reset_launch_counts()
    try:
        out = {}
        for dev, params in (("cpu", host), ("cuda", card)):
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.no_grad():
                loss, _ = transformer.loss(params, b, cfg)
                logits, (k, v) = transformer.prefill(params, b["tokens"], cfg)
                T = b["tokens"].shape[1]
                shape = transformer.cache_shape(cfg, 2, T + 4)
                kc = torch.zeros(shape, device=dev)
                vc = torch.zeros(shape, device=dev)
                kc[:, :, :T], vc[:, :, :T] = k, v
                steps, tok = [], torch.argmax(logits, -1)
                for i in range(4):
                    pos = torch.full((2,), T + i, device=dev)
                    lg, (kc, vc) = transformer.decode(params, (kc, vc), tok, pos, cfg)
                    steps.append(lg)
                    tok = torch.argmax(lg, -1)
            out[dev] = (loss.cpu(), logits.cpu(), [s.cpu() for s in steps])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert all(n == 0 for n in serve.launch_counts().values())
    (hl, hg, hs), (cl, cg, cs) = out["cpu"], out["cuda"]
    assert abs(float(hl) - float(cl)) <= 1e-5 * abs(float(hl))
    for a, b in zip([hg] + hs, [cg] + cs):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


# The GNN family (NequIP): its gathers and scatters are the fixed-order
# reduce (`kernels/embedding_bag/ops.segment_sum`), on the card the CPU's
# bits (`segment_reduce` adds each segment's rows in order on either
# device) and the same bits in every run; the model as configured on the
# training launcher's graphs, f32 with TF32 off, against the CPU within
# 1e-5 of the largest output, each gradient within 1e-4 of its leaf's
# largest entry (f32 sums in another order), two backwards the same bits,
# and one `embedding_bag` launch a forward (the species lookup), none in the
# backward, remat's recomputation included.


@pytest.mark.cuda
@pytest.mark.parametrize("M,n,inner", [(168960, 169984, (32, 5)), (10556, 2708, (32, 3)),
                                       (4096, 512, (32, 1)), (3840, 128, ())])
def test_fixed_order_scatter_and_gather_on_card_are_the_cpus_bits(cuda_device, M, n, inner):
    from repro_torch.models.gnn import nequip

    rng = np.random.default_rng(M)
    ids = torch.from_numpy(rng.integers(0, n, M).astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(M,) + inner).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n,) + inner).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        seg = ops.segments(ids.to(dev), n)
        xd = x.to(dev).requires_grad_(True)
        (dx,) = torch.autograd.grad(nequip.gather(xd, seg), xd, rows.to(dev))
        out[str(dev)] = (nequip.scatter_sum(rows.to(dev), seg), dx)
    (s_cpu, dx_cpu), (s_card, dx_card) = out["cpu"], out[str(cuda_device)]
    seg = ops.segments(ids.to(cuda_device), n)
    again = nequip.scatter_sum(rows.to(cuda_device), seg)
    assert torch.equal(s_card, again) and torch.equal(s_card.cpu(), dx_card.cpu())
    assert torch.equal(s_card.cpu(), s_cpu) and torch.equal(dx_card.cpu(), dx_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, False])
def test_nequip_on_card_matches_the_cpu_and_repeats_its_gradient(cuda_device, remat):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.models.gnn import nequip

    cfg = dataclasses.replace(get_config("nequip"), remat=remat)
    host = init_params(train.param_defs_for(cfg), torch.Generator().manual_seed(0), "cpu")
    batch = next(train.make_data(cfg, 1, "cpu")(0))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for dev, reps in (("cpu", 1), ("cuda", 2)):
            params = tree_map(lambda t: t.to(dev), host)
            paths, leaves = zip(*[(p, t.requires_grad_(True)) for p, t in tree_leaves(params)])
            b = {k: v.to(dev) for k, v in batch.items()}
            serve.reset_launch_counts()
            runs = []
            for _ in range(reps):
                out = nequip.forward(params, b, cfg)
                loss, _ = nequip.node_class_loss(params, b, cfg)
                runs.append((out.detach().cpu(), [g.cpu() for g in torch.autograd.grad(loss, leaves)]))
            torch.cuda.synchronize()
            res[dev] = (runs, serve.launch_counts())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (host_runs, _), (card_runs, launches) = res["cpu"], res["cuda"]
    assert launches == {**{k: 0 for k in launches}, "embedding_bag": 4}  # two forwards a run
    (h_out, h_grads), (c_out, c_grads) = host_runs[0], card_runs[0]
    assert float((h_out - c_out).abs().max()) <= 1e-5 * float(h_out.abs().max())
    for path, a, b in zip(paths, h_grads, c_grads):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(a.abs().max()), 1e-30), path
    assert all(torch.equal(a, b) for a, b in zip(c_grads, card_runs[1][1]))


# The distributed layer through NCCL at world size 1 (NCCL allows one rank
# per card): `moe_ffn_ep` over the (1, 1) mesh runs every collective and
# must give the one-group path's bits (output, aux, drops, every gradient;
# deterministic algorithms on, so each backward scatter-add sums in one
# order); `compress_allreduce_mean` on the card gives the CPU's bits.


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (NCCL runs on the card only)")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield make_test_mesh("cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,K,shared,cf", [(8, 2, 0, 1.25), (8, 2, 1, 0.5), (4, 4, 0, 0.5),
                                           (64, 8, 0, 1.25)])
def test_moe_ffn_ep_on_nccl_at_one_rank_gives_the_one_group_bits(nccl_mesh, E, K, shared, cf,
                                                                  dtype):
    from repro_torch.configs.base import LMConfig
    from repro_torch.distributed.expert_parallel import moe_ffn_ep
    from repro_torch.models.common import init_params
    from repro_torch.models.moe import moe_param_defs

    cfg = LMConfig(name="m", family="lm", n_layers=1, d_model=256, n_heads=4, n_kv_heads=2,
                   d_ff=512, vocab_size=64, n_experts=E, top_k=K, capacity_factor=cf,
                   n_shared_experts=shared, dtype=dtype)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(moe_param_defs(cfg, 1, dt), gen, "cuda")
    x = torch.randn((4, 256, 256), generator=gen, device="cuda").to(dt)
    cot = torch.randn(x.shape, generator=gen, device="cuda")
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mesh in (None, nccl_mesh):
            lp = {k: v[0].detach().requires_grad_() for k, v in params.items()}
            xi = x.detach().requires_grad_()
            stats = {}
            out, aux = moe_ffn_ep(xi, lp, cfg, stats, mesh=mesh)
            leaves = [xi] + [lp[k] for k in sorted(lp)]
            grads = torch.autograd.grad(torch.sum(out.float() * cot) + aux, leaves)
            runs.append((out, aux, [int(v[0]) for _, v in sorted(stats.items())], grads))
    finally:
        torch.use_deterministic_algorithms(False)
    (o1, a1, d1, g1), (o2, a2, d2, g2) = runs
    assert torch.equal(o1, o2) and torch.equal(a1, a2) and d1 == d2
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    if cf < 1:
        assert sum(d1) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300,), (4, 320), (64, 2048, 1024), (1,)])
def test_compress_allreduce_mean_on_card_gives_the_cpus_bits(nccl_mesh, shape):
    import torch.distributed as dist

    from repro_torch.distributed import grad_compression as gc

    gen = torch.Generator().manual_seed(len(shape))
    g = torch.randn(shape, generator=gen) * 1e-3
    r = torch.randn(shape, generator=gen) * 1e-5
    mean, res = gc.compress_allreduce_mean(g.cuda(), r.cuda(), dist.group.WORLD)
    cmean, cres = gc.compress_allreduce_mean(g, r)
    assert torch.equal(mean.cpu(), cmean) and torch.equal(res.cpu(), cres)


# The kernel's row range (a block of a table split by rows across ranks):
# against the plain version on the same block, bags of one exactly, else
# within 1e-5 of the largest output; an id outside the block reads no row
# (a block of NaN rows and only foreign ids gives zeros); the table
# gradient of the block on the card is the CPU's to the bit.

RANGE_SHAPES = [(512, 1, 64), (51200, 1, 18), (512, 39, 1), (19968, 1, 10), (512, 100, 64),
                (37, 5, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,nnz,d", RANGE_SHAPES)
@pytest.mark.parametrize("ways,index", [(2, 0), (2, 1), (4, 1), (4, 3)])
@pytest.mark.parametrize("weighted", [True, False])
def test_embedding_bag_row_range_matches_plain_version_on_card(cuda_device, B, nnz, d, ways,
                                                               index, weighted):
    table, idx, w = _inputs(B, nnz, d, seed=B + index)
    V = table.shape[0] // ways
    block = torch.from_numpy(table[index * V:(index + 1) * V]).to(cuda_device)
    t_idx = torch.from_numpy(idx).to(cuda_device)
    t_w = torch.from_numpy(w).to(cuda_device) if weighted else None
    before = ops.launches
    out = ops.embedding_bag_op(block, t_idx, t_w, row0=index * V, id_limit=table.shape[0])
    again = ops.embedding_bag_op(block, t_idx, t_w, row0=index * V, id_limit=table.shape[0])
    torch.cuda.synchronize()
    assert ops.launches == before + 2 and torch.equal(out, again)
    ref = embedding_bag_ref(block, t_idx, t_w, index * V, table.shape[0])
    if nnz == 1:
        assert torch.equal(out, ref)
    else:
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    # the table gradient: the CPU's bits, the block's rows only
    dy = torch.from_numpy(np.random.default_rng(1).normal(size=(B, d)).astype(np.float32))
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        t = block.to(dev).detach().requires_grad_()
        o = ops.embedding_bag_op(t, t_idx.to(dev), None if t_w is None else t_w.to(dev),
                                 row0=index * V, id_limit=table.shape[0])
        (o * dy.to(dev)).sum().backward()
        grads.append(t.grad.cpu())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,nnz,d", [(512, 1, 64), (512, 39, 1), (300, 7, 10)])
def test_embedding_bag_row_range_reads_no_row_of_a_foreign_id_on_card(cuda_device, B, nnz, d):
    block = torch.full((1024, d), float("nan"), device=cuda_device)
    idx = torch.randint(0, 1024, (B, nnz), dtype=torch.int32, device=cuda_device)
    for row0, ids in ((1024, idx), (0, idx + 1024)):  # every id in the other block
        out = ops.embedding_bag_op(block, ids, row0=row0, id_limit=2048)
        torch.cuda.synchronize()
        assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["taobao_ssa", "fm", "din", "dien", "autoint"])
def test_recsys_serve_through_a_one_rank_nccl_mesh_is_the_plain_call_on_card(nccl_mesh, arch):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import RecSysShape
    from repro_torch.launch.cells import build_cell
    from repro_torch.models.common import init_params
    from repro_torch.models.recsys import api

    cfg = get_config(arch)
    cfg = dataclasses.replace(
        cfg, fields=tuple(dataclasses.replace(f, vocab=min(f.vocab, 5000)) for f in cfg.fields))
    cell = build_cell(arch, "serve_p99", nccl_mesh, cfg=cfg,
                      shape=RecSysShape("serve_p99", 256, "serve"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(api.param_defs(cfg), gen, "cuda")
    batch = {}
    for k, a in cell.args[1].items():
        top = {"user": "user", "item": "item", "category": "category", "hist_item": "item",
               "hist_category": "category"}.get(k)
        vocab = (min(f.vocab for f in cfg.fields) if k == "sparse_idx" else
                 cfg.seq_len + 1 if k == "hist_len" else
                 {f.name: f.vocab for f in cfg.fields}[top])
        batch[k] = torch.randint(1 if k == "hist_len" else 0, vocab, a.shape, generator=gen,
                                 device="cuda", dtype=torch.int32)
    runs = []
    for fn in (lambda: cell.fn(params, batch), lambda: api.serve(params, batch, cfg)):
        before = ops.launches
        runs.append((fn(), ops.launches - before))
    torch.cuda.synchronize()
    (mesh_out, mesh_launches), (plain_out, plain_launches) = runs
    assert torch.equal(mesh_out, plain_out) and mesh_launches == plain_launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_decode_attention_over_two_ranks_on_card_matches_the_whole(cuda_device, dtype,
                                                                        tmp_path):
    import torch_ranks
    from repro_torch.models.layers import decode_attention, sparse_decode_attention

    rng = np.random.default_rng(0)
    B, T, K, G, hd = 4, 256, 2, 2, 32
    # rows at 0 and 100: no key on rank 1 (dense), none in its half for the
    # C2 pattern either; 127 ends rank 0's half; 250 spans both
    pos = np.array([0, 100, 127, 250], np.int64)
    cases = [{"q": rng.standard_normal((B, 1, K, G, hd)).astype(np.float32),
              "k": rng.standard_normal((B, T, K, hd)).astype(np.float32),
              "v": rng.standard_normal((B, T, K, hd)).astype(np.float32),
              "pos": pos, "sparse": sparse, "window": 64, "n_global": 16, "dtype": dtype}
             for sparse in (False, True)]
    ranks = torch_ranks.run_ranks(torch_ranks.split_decode_rank, 2, tmp_path, "cuda", cases)
    dt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for i, c in enumerate(cases):
        q, k, v = (torch.from_numpy(c[n]).to(cuda_device).to(dt) for n in ("q", "k", "v"))
        p = torch.from_numpy(c["pos"]).to(cuda_device)
        whole = (sparse_decode_attention(q, k, v, p, window=64, n_global=16) if c["sparse"]
                 else decode_attention(q, k, v, p)).float().cpu().numpy()
        for r in ranks:
            assert np.isfinite(r[i]).all()
            assert np.abs(r[i] - whole).max() <= tol * np.abs(whole).max(), (i, dtype)
        assert np.array_equal(ranks[0][i], ranks[1][i])


@pytest.mark.cuda
def test_nequip_across_two_ranks_on_card_matches_the_whole(cuda_device, tmp_path):
    """NequIP's molecule cell (2 layers of 8 channels) on the (2, 1) mesh of
    two gloo ranks sharing the card: each rank's forward block is the
    one-rank forward's block of the whole graph within 1e-5 of its largest
    |output| (a node's messages summed over the ranks in another order),
    both ranks take the same step, and each launches `embedding_bag` once
    a step, on its own block of the species."""
    import torch_ranks

    ranks = torch_ranks.run_ranks(torch_ranks.gnn_cell_rank, 2, tmp_path, (2, 1), "cuda")
    scale = max(float(np.abs(r["one_rank"]).max()) for r in ranks)
    for r in ranks:
        assert np.isfinite(r["out"]).all() and r["finite"] and r["same_shapes"]
        assert np.abs(r["out"] - r["one_rank"]).max() <= 1e-5 * scale, r["coord"]
        assert r["launches"] == 1, r["coord"]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


@pytest.mark.cuda
def test_adam8bit_across_ranks_on_card_is_the_cpus_whole_update(cuda_device, tmp_path):
    """adam8bit across two gloo ranks sharing the card, on shared gradients
    (`torch_ranks.adam8bit_rank`): three updates of each rank's blocks, on
    CUDA tensors, have the bits of the CPU's one-rank update's blocks
    (updates, codes and scales), on (1, 2) and (2, 1). The params are laid
    out as the yi-shaped LM's FSDP train cell lays them at d_ff 768 (wo's
    and w_down's last axis split: the ranks exchange the blocks' maxima)
    and as taobao_ssa's (tables split by rows)."""
    import dataclasses

    import torch_ranks
    from repro_torch.configs.base import get_config

    yi = dataclasses.replace(get_config("yi_6b"), n_layers=2, d_model=512, n_heads=4,
                             head_dim=32, n_kv_heads=2, d_ff=768, vocab_size=512,
                             dtype="float32", q_chunk=8)
    ssa = get_config("taobao_ssa")
    ssa = dataclasses.replace(ssa, seq_len=8, fields=tuple(
        dataclasses.replace(f, vocab=min(f.vocab, 1000)) for f in ssa.fields))
    cases = [{"arch": "yi_6b", "shape_name": "train_4k", "cfg": yi, "seed": 0},
             {"arch": "taobao_ssa", "shape_name": "train_batch", "cfg": ssa, "seed": 2}]
    meshes = ((1, 2), (2, 1))
    ranks = torch_ranks.run_ranks(torch_ranks.adam8bit_rank, 2, tmp_path, meshes, cases, "cuda")
    for r in ranks:
        for mesh in meshes:
            for case, got in zip(cases, r[mesh]):
                assert got["device"].startswith("cuda")
                assert all(got["same"].values()), (mesh, case["arch"],
                                                   [k for k, v in got["same"].items() if not v])
    split = {k for k, v in ranks[0][(2, 1)][0]["split_last"].items() if v}
    assert split == {"attn/wo", "ffn/w_down"}, split


@pytest.mark.cuda
def test_adam8bit_update_on_card_never_waits_for_it(cuda_device):
    """Three adam8bit updates of a leaf on the card under CUDA's sync
    debug mode "error", which raises at any host-card synchronisation:
    the bias corrections come from the count `init` keeps on the host. The
    updates, codes and scales have the CPU's bits."""
    from repro_torch.training.optimizer import adam8bit

    opt = adam8bit(1e-4)
    gen = np.random.default_rng(3)
    p_host = {"w": torch.from_numpy(gen.standard_normal((64, 600)).astype(np.float32))}
    grads = [{"w": torch.from_numpy(gen.standard_normal((64, 600)).astype(np.float32))}
             for _ in range(3)]
    p_card = {"w": p_host["w"].to(cuda_device)}
    g_card = [{"w": g["w"].to(cuda_device)} for g in grads]
    st_host, st_card = opt.init(p_host), opt.init(p_card)
    assert st_card["count"].device.type == "cpu"
    torch.cuda.synchronize()
    ups = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in g_card:
            u, st_card = opt.update(g, st_card, p_card)
            ups.append(u)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, u_card in zip(grads, ups):
        u_host, st_host = opt.update(g, st_host, p_host)
        assert torch.equal(u_card["w"].cpu(), u_host["w"])
    for mv in ("m", "v"):
        for k in ("q", "s"):
            assert torch.equal(st_card[mv]["w"][k].cpu(), st_host[mv]["w"][k])
    assert int(st_card["count"]) == int(st_host["count"]) == 3
