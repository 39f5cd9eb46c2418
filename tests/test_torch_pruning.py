"""The port's pruning and QAT against `repro`'s, on the CPU.

Masks must come out equal exactly: a one-ulp difference in a threshold
flips an element or a 128 x 128 tile, and the variants' sparsity and
storage are counted from the masks. The shapes are taobao_ssa's masked
linears: the encoder's 64 x 64 projections, its 64 x 256 and 256 x 64 FFN,
and the tower's 208 x 200, 200 x 80 and 80 x 1.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import pruning as jax_pruning  # noqa: E402
from repro.core import quantization as jax_quant  # noqa: E402
from repro_torch.core import pruning, quantization  # noqa: E402
from repro_torch.models.common import from_numpy_tree, tree_leaves  # noqa: E402
from torch_parity import to_numpy  # noqa: E402

SHAPES = [(64, 64), (64, 256), (256, 64), (208, 200), (200, 80), (80, 1)]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    tree = {f"w{i}": (rng.normal(size=s) * (1 + i)).astype(np.float32)
            for i, s in enumerate(SHAPES)}
    tree["tables"] = {"item": rng.normal(size=(512, 64)).astype(np.float32)}
    tree["pos"] = rng.normal(size=(20, 64)).astype(np.float32)
    tree["ln"] = np.ones(64, np.float32)
    return tree


def _assert_same_tree(ref, out):
    ref, out = dict(tree_leaves(to_numpy(ref))), dict(tree_leaves(out))
    assert ref.keys() == out.keys()
    for path, t in out.items():
        assert t.numpy().dtype == ref[path].dtype, path
        np.testing.assert_array_equal(t.numpy(), ref[path], err_msg=str(path))


def test_quantile_is_jnp_quantile_bit_for_bit():
    rng = np.random.default_rng(1)
    for _ in range(60):
        a = (rng.normal(size=int(rng.integers(1, 40)) * 64) * 10.0 ** rng.uniform(-3, 1)).astype(
            np.float32)
        q = np.float32(rng.uniform())
        ref = np.asarray(jnp.quantile(jnp.asarray(a), q))
        out = pruning._quantile(torch.from_numpy(a), float(q)).numpy()
        assert ref.tobytes() == out.tobytes(), (a.size, q)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [0.1, 0.1566, 0.4, 0.5, 0.7])
def test_masks_equal_repro_exactly(shape, p):
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    tw = torch.from_numpy(w)
    np.testing.assert_array_equal(pruning.prune_mask(tw, p).numpy(),
                                  np.asarray(jax_pruning.prune_mask(jnp.asarray(w), p)))
    np.testing.assert_array_equal(pruning.block_prune_mask(tw, p).numpy(),
                                  np.asarray(jax_pruning.block_prune_mask(jnp.asarray(w), p)))
    assert float(pruning.magnitude_threshold(tw, p)) == float(
        jax_pruning.magnitude_threshold(jnp.asarray(w), p))


@pytest.mark.parametrize("structured", [False, True])
def test_three_rounds_of_prune_tree_equal_repro(structured):
    tree = _tree()
    jt = jax.tree.map(jnp.asarray, tree)
    tt = from_numpy_tree(tree, "cpu")
    schedule = pruning.prune_schedule(0.4, 3)
    assert schedule == jax_pruning.prune_schedule(0.4, 3)
    for ratio in schedule:
        jt = jax_pruning.prune_tree(jt, ratio, structured=structured)
        tt = pruning.prune_tree(tt, ratio, structured=structured)
        _assert_same_tree(jt, tt)
        assert pruning.sparsity(tt) == jax_pruning.sparsity(jt)
    assert set(tt["tables"]) == {"item"} and torch.is_tensor(tt["pos"])  # never pruned
    if structured:  # the ragged tiles score lower: 208 x 200 and 200 x 80 lose one
        assert float(tt["w3"]["mask"].mean()) == pytest.approx(1 - 80 * 72 / (208 * 200))
        assert float(tt["w4"]["mask"].mean()) == pytest.approx(128 / 200)


def test_block_masks_derive_from_structured_masks_and_refuse_others():
    tt = pruning.prune_tree(from_numpy_tree(_tree(), "cpu"), 0.3, structured=True)
    bt = pruning.with_block_masks(tt)
    for i, (K, N) in enumerate(SHAPES):
        rep = bt[f"w{i}"]
        assert rep["block_mask"].dtype == torch.int32
        assert tuple(rep["block_mask"].shape) == (-(-K // 128), -(-N // 128))
        assert torch.equal(rep["mask"], tt[f"w{i}"]["mask"])
    assert bt["w3"]["block_mask"].tolist() == [[1, 1], [1, 0]]
    assert bt["w4"]["block_mask"].tolist() == [[1], [0]]
    back = pruning.without_block_masks(bt)
    assert all(set(back[f"w{i}"]) == {"w", "mask"} for i in range(len(SHAPES)))
    # the derived key counts for nothing
    assert pruning.sparsity(bt) == pruning.sparsity(tt)
    assert quantization.model_bytes(bt) == quantization.model_bytes(tt)
    unstructured = pruning.prune_tree(from_numpy_tree(_tree(), "cpu"), 0.3)
    with pytest.raises(ValueError, match="not block-structured"):
        pruning.with_block_masks(unstructured)
    in_64_tiles = pruning.prune_tree(from_numpy_tree(_tree(), "cpu"), 0.3, structured=True,
                                     block=64)
    with pytest.raises(ValueError, match="128-tiles"):  # the kernel's tile is compiled in
        pruning.with_block_masks(in_64_tiles)


def test_quantize_tree_keeps_block_masks_and_repro_keys():
    tt = pruning.prune_tree(from_numpy_tree(_tree(), "cpu"), 0.3, structured=True)
    jt = jax_pruning.prune_tree(jax.tree.map(jnp.asarray, _tree()), 0.3, structured=True)
    _assert_same_tree(jax_quant.quantize_tree(jt), quantization.quantize_tree(tt))
    q = quantization.quantize_tree(pruning.with_block_masks(tt))
    assert set(q["w1"]) == {"q", "s", "mask", "block_mask"}
    assert torch.equal(pruning.with_block_masks(q)["w1"]["block_mask"], q["w1"]["block_mask"])


def test_ste_quant_forward_and_straight_through_gradient():
    w = np.random.default_rng(3).normal(size=(64, 256)).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = quantization.ste_quant(tw)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jax_quant.ste_quant(jnp.asarray(w))))
    g = np.random.default_rng(4).normal(size=w.shape).astype(np.float32)
    (out * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(jax_quant.ste_quant(x) * g))(jnp.asarray(w))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jg))


def test_qat_params_matches_repro():
    tree = _tree()
    jt = jax_pruning.prune_tree(jax.tree.map(jnp.asarray, tree), 0.3)
    tt = pruning.prune_tree(from_numpy_tree(tree, "cpu"), 0.3)
    tt["pq"] = quantization.quantize_tree({"x": tt["w1"]})["x"]  # an int8+mask rep passes
    jt["pq"] = jax_quant.quantize_tree({"x": jt["w1"]})["x"]
    _assert_same_tree(jax_quant.qat_params(jt), quantization.qat_params(tt))
    bt = quantization.qat_params(pruning.with_block_masks(pruning.prune_tree(
        from_numpy_tree(tree, "cpu"), 0.3, structured=True)))
    assert "block_mask" in bt["w0"]
