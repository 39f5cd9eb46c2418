"""The port's host input pipeline (`repro_torch.data.pipeline`) against
`repro.data.pipeline`, on the same numpy batches; every comparison exact.

- `host_shard`: the same slices for explicit process indices and counts,
  and, without them, the process index and count of `torch.distributed`
  where a process group is initialised (emulated here) and 0 of 1 where
  none is, as `repro`'s takes `jax.process_index()` and
  `jax.process_count()` (0 of 1 on this machine).
- `prefetch`: the same items in the same order at every depth.
- `device_put_batches`: tensors equal to the numpy arrays, on the device
  asked for; `seeded_batches`: the stream from the restart step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_workers  # noqa: E402,F401  (one torch thread per xdist worker)
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data.synthetic import taobao_batches as jax_taobao_batches  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.synthetic import taobao_batches  # noqa: E402
from torch_parity import reduced_pair  # noqa: E402


def _batches(n=4, size=24):
    jcfg, _ = reduced_pair("din", seq_len=10)
    return list(jax_taobao_batches(jcfg, size, n, seed=5))


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("index,count", [(0, 1), (0, 4), (3, 4), (1, 5), (2, 3)])
def test_host_shard_matches_repro(index, count):
    for b in _batches():
        ours = pipeline.host_shard(b, process_index=index, process_count=count)
        _equal(ours, jax_pipeline.host_shard(b, process_index=index, process_count=count))
        assert len(ours["user"]) == len(b["user"]) // count


def test_host_shard_reads_the_process_group(monkeypatch):
    b = _batches(1)[0]
    _equal(pipeline.host_shard(b), jax_pipeline.host_shard(b))  # no group: 0 of 1, the batch
    assert pipeline.host_shard(b) is b
    monkeypatch.setattr(pipeline.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pipeline.dist, "get_rank", lambda: 2)
    monkeypatch.setattr(pipeline.dist, "get_world_size", lambda: 4)
    _equal(pipeline.host_shard(b), jax_pipeline.host_shard(b, process_index=2, process_count=4))
    # an explicit index or count wins over the group's
    _equal(pipeline.host_shard(b, process_index=0),
           jax_pipeline.host_shard(b, process_index=0, process_count=4))


@pytest.mark.parametrize("depth", [1, 2, 8])
def test_prefetch_matches_repro(depth):
    batches = _batches(6)
    ours = list(pipeline.prefetch(iter(batches), depth=depth))
    ref = list(jax_pipeline.prefetch(iter(batches), depth=depth))
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        _equal(a, b)


def test_prefetch_of_an_empty_stream_ends_as_repros():
    assert list(pipeline.prefetch(iter(()))) == list(jax_pipeline.prefetch(iter(()))) == []


def test_device_put_batches_and_seeded_batches():
    cfg = dataclasses.replace(get_config("din"), seq_len=10)
    put = list(pipeline.device_put_batches(iter(_batches(2)), "cpu"))
    for t, b in zip(put, _batches(2)):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in t.values())
        _equal({k: v.numpy() for k, v in t.items()}, b)

    def make(step):
        return taobao_batches(cfg, 4, 3, seed=step)

    _equal(next(pipeline.seeded_batches(make, 7)), next(make(7)))
