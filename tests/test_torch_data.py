"""The port's copy of the Taobao and Criteo generators gives `repro.data.synthetic`'s arrays."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import synthetic as jdata  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from torch_parity import small_configs  # noqa: E402


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 17])
def test_taobao_batches_identical(seed):
    jcfg, tcfg = small_configs(seq_len=30)
    ref = list(jdata.taobao_batches(jcfg, 32, 3, seed=seed))
    out = list(tdata.taobao_batches(tcfg, 32, 3, seed=seed))
    assert len(ref) == len(out) == 3
    for a, b in zip(ref, out):
        _equal(a, b)


@pytest.mark.parametrize("seed", [10, 23])
def test_taobao_eval_candidates_identical(seed):
    jcfg, tcfg = small_configs(seq_len=30)
    ref = jdata.taobao_eval_candidates(jcfg, 8, 50, seed=seed)
    out = tdata.taobao_eval_candidates(tcfg, 8, 50, seed=seed)
    _equal(ref["batch"], out["batch"])
    np.testing.assert_array_equal(ref["pos_idx"], out["pos_idx"])
    assert ref["n_cand"] == out["n_cand"] == 50


def test_world_identical():
    a = jdata.TaobaoWorld(500, 300, 40, seed=4)
    b = tdata.TaobaoWorld(500, 300, 40, seed=4)
    for k in ("item_cat", "user_pref", "cat_vec", "item_pop"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("seed", [0, 2])
def test_criteo_batches_identical(seed):
    """At FM's full Criteo vocabularies (the generator holds no table)."""
    from repro.configs.base import get_config as jax_get_config
    from repro_torch.configs.base import get_config

    ref = list(jdata.criteo_batches(jax_get_config("fm"), 64, 2, seed=seed))
    out = list(tdata.criteo_batches(get_config("fm"), 64, 2, seed=seed))
    assert len(ref) == len(out) == 2
    for a, b in zip(ref, out):
        _equal(a, b)
    assert out[0]["sparse_idx"].shape == (64, 39)


@pytest.mark.parametrize("arch", ["taobao_ssa", "fm", "dien"])
def test_training_data_and_reduced_config_match_repro_launch_train(arch):
    """`launch/train.make_data` yields repro's `make_data` batches (as
    tensors), replayed afresh each call, and `reduced_config` cuts the same
    vocabularies."""
    import dataclasses

    from repro.configs.base import get_config as jget
    from repro.launch import train as jtrain
    from repro_torch.configs.base import get_config as tget
    from repro_torch.launch import train as ttrain

    jcfg, tcfg = jtrain.reduced_config(jget(arch)), ttrain.reduced_config(tget(arch))
    assert [f.vocab for f in jcfg.fields] == [f.vocab for f in tcfg.fields]
    assert max(f.vocab for f in tcfg.fields) == 5000
    jcfg = dataclasses.replace(jcfg, seq_len=12)
    tcfg = dataclasses.replace(tcfg, seq_len=12)
    jdata_fn, tdata_fn = jtrain.make_data(jcfg, 16, seed_base=3), ttrain.make_data(tcfg, 16, "cpu", 3)
    for step in (0, 1):
        for _ in range(2):  # a second call starts the same batches again
            ref = next(jdata_fn(step))
            out = next(tdata_fn(step))
            _equal({k: np.asarray(v) for k, v in ref.items()},
                   {k: v.numpy() for k, v in out.items()})
