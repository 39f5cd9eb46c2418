"""The port's checkpoints (`repro_torch.training.checkpoint`) against `repro`'s.

- The layout is `repro`'s, so a checkpoint crosses in both directions: the
  port's save restores in `repro`, and `repro`'s in the port, with every
  leaf equal (shape, dtype, bits), on a small taobao_ssa's parameters with
  AdamW's and with adam8bit's state (int8 codes, the 0-d step count), and
  on NequIP's (its stacked `[L, ...]` layer leaves) with AdamW's.
- The manifest is written by the port's own msgpack codec: its bytes are
  `msgpack.packb`'s, and `msgpack.unpackb` reads them back.
- `repro`'s own checkpoint tests (`tests/test_training.py`), on the port.
- A deviation from `repro`: `restore` refuses a leaf whose saved shape or
  dtype is not its `like` leaf's, naming the leaf's path; `repro` checks
  only the leaf count and hands back the saved leaf (shown below).
- bfloat16 (every LM config's dtype) crosses bit for bit: a `repro` bf16
  tree through `from_numpy_tree` / `to_numpy_tree`, a `repro` bf16
  checkpoint restored by the port, and the port's bf16 checkpoint written
  byte for byte as `repro` writes it. `repro`'s `restore` refuses bf16
  leaves, its own checkpoints' too (shown below).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402

from repro.training import checkpoint as jax_checkpoint  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro_torch.models.common import from_numpy_tree, to_numpy_tree, tree_leaves  # noqa: E402
from repro_torch.training import checkpoint, optimizer  # noqa: E402
from torch_parity import jax_params, small_configs, to_numpy, to_torch_params  # noqa: E402


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((7,), dtype=torch.int32)},
    }
    checkpoint.save(tmp_path, 5, tree, extra={"note": "x"})
    assert checkpoint.latest_step(tmp_path) == 5
    out = checkpoint.restore(tmp_path, 5, tree)
    for (path, a), (_, b) in zip(tree_leaves(tree), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_checkpoint_atomicity(tmp_path):
    tree = {"a": torch.ones((4,))}
    checkpoint.save(tmp_path, 1, tree)
    # a stale tmp dir from a crashed writer must not be visible
    (tmp_path / "step_00000002.tmp").mkdir()
    assert checkpoint.latest_step(tmp_path) == 1


def test_a_stale_tmp_dir_is_replaced_and_a_step_overwritten(tmp_path):
    stale = tmp_path / "step_00000003.tmp"
    stale.mkdir()
    (stale / "leaf_00000_0000.npy").write_bytes(b"junk from a crashed writer")
    checkpoint.save(tmp_path, 3, {"a": torch.zeros(2)})
    checkpoint.save(tmp_path, 3, {"a": torch.full((2,), 7.0)})
    assert not stale.exists() and checkpoint.latest_step(tmp_path) == 3
    assert torch.equal(checkpoint.restore(tmp_path, 3, {"a": torch.zeros(2)})["a"],
                       torch.full((2,), 7.0))


def test_latest_step_of_a_missing_or_empty_directory(tmp_path):
    assert checkpoint.latest_step(tmp_path / "none") is None
    assert checkpoint.latest_step(tmp_path) is None


# values across every boundary of the msgpack encodings a manifest can need
_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, 2**64 - 1,
         -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
_VALUES = {
    "ints": _INTS,
    "floats": [0.0, -0.0, 1.5, 1e-300, -3.25e12, float("inf")],
    "scalars": [True, False, None, "", "ü€"],
    "str_lengths": ["a" * n for n in (31, 32, 255, 256, 65535, 65536)],
    "array_lengths": [list(range(n)) for n in (15, 16, 65535, 65536)],
    "map_lengths": [{str(i): i for i in range(n)} for n in (15, 16, 65536)],
    "nested": {"a": [{"b": (1, 2.5, None)}, [], {}], "c": {"d": {"e": [True, "x"]}}},
    "manifest": {"step": 20, "treedef": "({'a': *}, {'count': *})", "n_leaves": 2,
                 "leaves": [{"shape": [3, 4], "dtype": "float32", "n_chunks": 1},
                            {"shape": [], "dtype": "int32", "n_chunks": 1}],
                 "extra": {"note": "x", "lr": 1e-3}},
}


@pytest.mark.parametrize("name", sorted(_VALUES))
def test_codec_writes_msgpacks_bytes_and_reads_them_back(name):
    obj = _VALUES[name]
    data = checkpoint.packb(obj)
    assert data == msgpack.packb(obj)
    assert checkpoint.unpackb(data) == msgpack.unpackb(data)


def test_codec_refuses_what_a_manifest_does_not_hold():
    with pytest.raises(TypeError):
        checkpoint.packb({"a": b"bytes"})
    with pytest.raises(ValueError, match="follow"):
        checkpoint.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="0xc4"):
        checkpoint.unpackb(msgpack.packb(b"bytes"))


def test_saved_manifest_is_msgpack(tmp_path):
    tree = ({"w": torch.ones(3, 2)}, {"count": torch.zeros((), dtype=torch.int32)})
    path = checkpoint.save(tmp_path, 7, tree, extra={"arch": "fm"})
    raw = (path / "manifest.msgpack").read_bytes()
    manifest = msgpack.unpackb(raw)
    assert raw == msgpack.packb(manifest)
    assert manifest["step"] == 7 and manifest["n_leaves"] == 2
    assert manifest["leaves"] == [{"shape": [3, 2], "dtype": "float32", "n_chunks": 1},
                                  {"shape": [], "dtype": "int32", "n_chunks": 1}]
    assert manifest["extra"] == {"arch": "fm"}


def test_chunked_leaves_round_trip_and_restore_in_repro(tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, "_CHUNK_BYTES", 64)  # a row of 5 f32: 3 rows a chunk
    tree = {"big": torch.arange(50, dtype=torch.float32).reshape(10, 5),
            "small": torch.arange(3, dtype=torch.int8), "scalar": torch.tensor(2.5)}
    path = checkpoint.save(tmp_path, 1, tree)
    chunks = sorted(p.name for p in path.glob("leaf_00000_*.npy"))
    assert chunks == [f"leaf_00000_{c:04d}.npy" for c in range(4)]  # 3 + 3 + 3 + 1 rows
    out = checkpoint.restore(tmp_path, 1, tree)
    for (path_, a), (_, b) in zip(tree_leaves(tree), tree_leaves(out)):
        assert torch.equal(a, b), path_
    ref = jax_checkpoint.restore(tmp_path, 1, jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                                          tree))
    for (path_, a), (_, b) in zip(tree_leaves(tree), tree_leaves(to_numpy(ref))):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(path_))


def test_flatten_order_is_jaxs():
    tree = ({"b": np.ones(1), "a": {"y": np.ones(2), "x": np.ones(3)}},
            [np.ones(4), None, (np.ones(5),)], {"count": np.ones(6)})
    leaves, _ = checkpoint.flatten(tree)
    assert [x.size for x in leaves] == [x.size for x in jax.tree.leaves(tree)]
    assert [x.size for x in checkpoint.flatten(checkpoint.unflatten(tree, leaves))[0]] == \
        [3, 2, 1, 4, 5, 6]


@pytest.fixture(scope="module")
def trees():
    """(repro tree, port tree) pairs of a small taobao_ssa's (params,
    optimizer state) after one update from the same random gradients: AdamW
    and adam8bit (int8 codes, f32 scales, the 0-d count)."""
    jcfg, _ = small_configs()
    jp = jax_params(jcfg, seed=0)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), to_numpy(jp))
    out = {}
    for name in ("adamw", "adam8bit"):
        jo, to = jax_opt.get_optimizer(name, 1e-3), optimizer.get_optimizer(name, 1e-3)
        tp = to_torch_params(jp)
        _, js = jo.update(jax.tree.map(jnp.asarray, grads), jo.init(jp), jp)
        _, ts = to.update(from_numpy_tree(grads, "cpu"), to.init(tp), tp)
        out[name] = ((jp, js), (tp, ts))
    return out


def _assert_same_leaves(jax_tree, port_tree):
    ref = jax.tree.leaves(to_numpy(jax_tree))
    got, _ = checkpoint.flatten(port_tree)
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        b = b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


@pytest.mark.parametrize("opt", ["adamw", "adam8bit"])
def test_port_checkpoint_restores_in_repro(trees, opt, tmp_path):
    (jp, js), (tp, ts) = trees[opt]
    checkpoint.save(tmp_path, 10, (tp, ts))
    assert jax_checkpoint.latest_step(tmp_path) == 10
    restored = jax_checkpoint.restore(tmp_path, 10, (jp, js))
    _assert_same_leaves(restored, (tp, ts))
    if opt == "adam8bit":
        codes = [x for x in jax.tree.leaves(restored[1]) if x.dtype == jnp.int8]
        assert codes and any(bool((c != 0).any()) for c in codes)


@pytest.mark.parametrize("opt", ["adamw", "adam8bit"])
def test_repro_checkpoint_restores_in_the_port(trees, opt, tmp_path):
    (jp, js), (tp, ts) = trees[opt]
    jax_checkpoint.save(tmp_path, 10, (jp, js), extra={"from": "repro"})
    assert checkpoint.latest_step(tmp_path) == 10
    leaves, _ = checkpoint.flatten((tp, ts))
    like = checkpoint.unflatten((tp, ts), [torch.zeros_like(x) for x in leaves])
    restored = checkpoint.restore(tmp_path, 10, like)
    _assert_same_leaves((jp, js), restored)
    count = restored[1]["count"]
    assert count.ndim == 0 and count.dtype == torch.int32 and int(count) == 1


def test_restore_puts_each_leaf_on_its_like_leafs_device_or_the_given_one(tmp_path):
    tree = {"w": torch.ones(2, 3), "q": torch.full((4,), -3, dtype=torch.int8)}
    checkpoint.save(tmp_path, 1, tree)
    like = {"w": np.zeros((2, 3), np.float32), "q": torch.zeros(4, dtype=torch.int8)}
    out = checkpoint.restore(tmp_path, 1, like)
    assert out["w"].device.type == "cpu" and out["q"].dtype == torch.int8
    assert torch.equal(out["q"], tree["q"])
    out = checkpoint.restore(tmp_path, 1, tree, device=torch.device("meta"))
    assert {t.device.type for t in out.values()} == {"meta"}


def test_a_leaf_count_mismatch_is_refused(tmp_path):
    checkpoint.save(tmp_path, 4, {"a": torch.ones(2), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="checkpoint has 2 leaves, target tree 3"):
        checkpoint.restore(tmp_path, 4, {"a": torch.ones(2), "b": torch.ones(3),
                                         "c": torch.ones(1)})


@pytest.mark.parametrize("saved,like,what", [
    (torch.ones(4, 2), torch.ones(3, 2), "float32 (4, 2), the target's float32 (3, 2)"),
    (torch.ones(4, 2), torch.ones(4, 2, dtype=torch.float64), "float32 (4, 2), the target's float64"),
    (torch.ones(4, 2), torch.ones(8), "float32 (4, 2), the target's float32 (8,)"),
    (torch.ones(4, dtype=torch.int8), np.ones(4, np.int32), "int8 (4,), the target's int32 (4,)"),
])
def test_a_leaf_of_another_shape_or_dtype_is_refused_by_its_path(tmp_path, saved, like, what):
    checkpoint.save(tmp_path, 3, ({"tables": {"item": saved}, "b": torch.ones(2)},
                                  {"count": torch.zeros((), dtype=torch.int32)}))
    target = ({"tables": {"item": like}, "b": torch.ones(2)},
              {"count": torch.zeros((), dtype=torch.int32)})
    with pytest.raises(ValueError, match=r"'0/tables/item'") as err:
        checkpoint.restore(tmp_path, 3, target)
    assert what in str(err.value)


def test_repro_restores_a_leaf_of_another_shape_as_it_was_saved(tmp_path):
    """The fault the port repairs: a (4, 2) leaf restored into a (3, 2)
    `like` comes back (4, 2) in `repro`, without an error."""
    jax_checkpoint.save(tmp_path, 1, {"a": jnp.ones((4, 2))})
    back = jax_checkpoint.restore(tmp_path, 1, {"a": jnp.ones((3, 2))})
    assert back["a"].shape == (4, 2)
    with pytest.raises(ValueError, match="'a'.*float32 \\(4, 2\\)"):
        checkpoint.restore(tmp_path, 1, {"a": torch.ones(3, 2)})


def test_leaf_paths_follow_the_flatten_order():
    tree = ({"b": torch.ones(1), "a": {"y": torch.ones(1), "x": None, "z": [torch.ones(1)]}},
            torch.ones(1))
    assert checkpoint.leaf_paths(tree) == ["0/a/y", "0/a/z/0", "0/b", "1"]
    assert len(checkpoint.leaf_paths(tree)) == len(checkpoint.flatten(tree)[0])


@pytest.fixture(scope="module")
def bf16_tree():
    """`repro`'s reduced yi_6b parameters (bf16) and AdamW state after one
    update (f32 moments, the int32 count), and a 0-d bf16 leaf."""
    from conftest import reduced_lm
    from repro.models import transformer as jtf
    from repro.models.common import init_params

    cfg = reduced_lm("yi_6b")
    params = init_params(jtf.param_defs(cfg), jax.random.key(0))
    grads = jax.tree.map(lambda p: jax.random.normal(jax.random.key(1), p.shape).astype(p.dtype),
                         params)
    opt = jax_opt.get_optimizer("adamw", 1e-3)
    _, state = opt.update(grads, opt.init(params), params)
    return {"params": params, "opt": state, "scalar": jnp.asarray(-2.75, jnp.bfloat16)}


def test_bf16_bits_cross_through_numpy_trees(bf16_tree):
    tree = to_numpy(bf16_tree)
    port = from_numpy_tree(tree, "cpu")
    assert port["params"]["embed"].dtype == torch.bfloat16 and port["scalar"].shape == ()
    assert port["opt"]["m"]["embed"].dtype == torch.float32
    back = to_numpy_tree(port)
    for (path, a), (_, b) in zip(tree_leaves(tree), tree_leaves(back)):
        bits = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert b.dtype == bits.dtype and b.shape == bits.shape, path
        np.testing.assert_array_equal(b, bits, err_msg=str(path))


def test_a_repro_bf16_checkpoint_restores_in_the_port(bf16_tree, tmp_path):
    jax_checkpoint.save(tmp_path, 4, bf16_tree)
    ref = from_numpy_tree(to_numpy(bf16_tree), "cpu")
    like = checkpoint.unflatten(ref, [torch.zeros_like(x) for x in checkpoint.flatten(ref)[0]])
    restored = checkpoint.restore(tmp_path, 4, like)
    for (path, a), (_, b) in zip(tree_leaves(ref), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8),
                                                  b.view(-1).view(torch.uint8)), path


def test_a_port_bf16_checkpoint_is_repros_bytes_and_reads_back_as_its_values(bf16_tree, tmp_path):
    """The port writes each leaf's `.npy` as `repro` does (a bf16 leaf under
    descr '<V2') and the manifest's leaves as `repro`'s ("bfloat16");
    only the structure string differs (see the module's docstring).
    `repro`'s own `restore` refuses a bf16 leaf of any checkpoint, its own
    included (`jnp.asarray` of the '<V2' array numpy loads), so `repro`
    reads the port's bf16 leaves as it would its own: `np.load` and a view
    as `ml_dtypes.bfloat16`."""
    import ml_dtypes

    port = from_numpy_tree(to_numpy(bf16_tree), "cpu")
    jax_checkpoint.save(tmp_path / "repro", 4, bf16_tree)
    checkpoint.save(tmp_path / "port", 4, port)
    a, b = tmp_path / "repro" / "step_00000004", tmp_path / "port" / "step_00000004"
    leaves = sorted(p.name for p in a.glob("leaf_*.npy"))
    assert leaves == sorted(p.name for p in b.glob("leaf_*.npy"))
    for name in leaves:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    ma, mb = (msgpack.unpackb((d / "manifest.msgpack").read_bytes()) for d in (a, b))
    assert {**ma, "treedef": None} == {**mb, "treedef": None}
    assert "bfloat16" in {m["dtype"] for m in mb["leaves"]}
    ref = jax.tree.leaves(to_numpy(bf16_tree))
    for i, r in enumerate(ref):
        got = np.load(b / f"leaf_{i:05d}_0000.npy")
        if r.dtype.name == "bfloat16":
            got = got.view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(got, r, err_msg=str(i))
    with pytest.raises(TypeError, match="V2"):
        jax_checkpoint.restore(tmp_path / "repro", 4, bf16_tree)


@pytest.fixture(scope="module")
def nequip_trees():
    """(repro tree, port tree) of NequIP's launcher parameters (stacked
    `[L, ...]` layer leaves under "layers") and AdamW's state, after one
    update from the same random gradients."""
    from repro.configs.base import get_config as jax_get_config
    from repro.models.common import init_params as jax_init_params
    from repro.models.gnn import nequip as jax_nequip

    jp = jax_init_params(jax_nequip.param_defs(jax_get_config("nequip"), n_classes=7),
                         jax.random.key(3))
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), to_numpy(jp))
    jo, to = jax_opt.get_optimizer("adamw", 1e-3), optimizer.get_optimizer("adamw", 1e-3)
    tp = to_torch_params(jp)
    _, js = jo.update(jax.tree.map(jnp.asarray, grads), jo.init(jp), jp)
    _, ts = to.update(from_numpy_tree(grads, "cpu"), to.init(tp), tp)
    assert tp["layers"]["rad_w2"].shape == (5, 32, 15 * 32)
    return (jp, js), (tp, ts)


def test_a_nequip_checkpoint_of_the_port_restores_in_repro(nequip_trees, tmp_path):
    (jtree, ptree) = nequip_trees
    checkpoint.save(tmp_path, 7, ptree)
    _assert_same_leaves(jax_checkpoint.restore(tmp_path, 7, jtree), ptree)


def test_a_nequip_checkpoint_of_repro_restores_in_the_port(nequip_trees, tmp_path):
    (jtree, ptree) = nequip_trees
    jax_checkpoint.save(tmp_path, 7, jtree)
    leaves, _ = checkpoint.flatten(ptree)
    like = checkpoint.unflatten(ptree, [torch.zeros_like(x) for x in leaves])
    _assert_same_leaves(jtree, checkpoint.restore(tmp_path, 7, like))
