"""Host-side input pipeline (port of `repro.data.pipeline`): deterministic
seeding, prefetch, per-host sharding. At 1000-node scale every host
materializes only its slice of the global batch; here the process index
and count come from `torch.distributed` when a process group is
initialised (else 0 and 1), and either can be passed instead.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np
import torch
import torch.distributed as dist


def _process_index_and_count():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(batch: Dict[str, np.ndarray], *, process_index=None, process_count=None):
    """Slice the leading axis to this host's shard."""
    rank, world = _process_index_and_count()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if pc == 1:
        return batch

    def sl(x):
        n = x.shape[0]
        per = n // pc
        return x[pi * per : (pi + 1) * per]

    return {k: sl(v) for k, v in batch.items()}


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch (overlaps host data gen with device step)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item


def device_put_batches(it: Iterator, device) -> Iterator:
    """Each numpy batch of `it` as tensors on `device`."""
    for batch in it:
        yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def seeded_batches(make: Callable[[int], Iterator], start_step: int) -> Iterator:
    """Deterministic resume: the generator is re-created at the restart
    step so replayed data matches what the failed run would have seen."""
    return make(start_step)
