"""The port's copy of the Taobao generators gives `repro.data.synthetic`'s arrays."""
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
