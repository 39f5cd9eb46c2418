"""The serve call replayed as a CUDA graph, one graph a repeated batch signature.

A serve call on the card enqueues some 40 (DIN) to 100 (taobao_ssa) small
kernels from Python, wrapper checks and autograd's `Function.apply`
included, and at a few thousand rows a call the card waits on that
enqueue. A CUDA graph enqueues the whole call in one launch: the same
kernels, in the same order, on the same shapes. `api.serve` asks
`GRAPHS.path` which way each call goes:

  eager     the call runs as written (`module_for(cfg).serve`), on the
            caller's stream; a signature's first sighting is noted (the
            signature alone, no buffer)
  capture   the second sighting: on the capture stream, in the graphs'
            memory pool, the batch is copied into static inputs (`pack`),
            the call runs once on them as the capture's warm-up, with
            CUDA's sync debug mode at error, and is then captured as a
            graph that writes a static output; then replayed
  replay    the batch copied into the static inputs (one copy a dtype), the
            graph replayed, a clone of its static output returned (the
            caller may keep the scores across calls)

A signature is the batch's keys with each tensor's shape, dtype and
device; the identity of `cfg`; the address, shape, strides and dtype of
every parameter leaf. A graph reads the parameters where they lie, so a
leaf changed in place is read afresh and a leaf replaced is another
signature.

A call runs as written, on the caller's stream, wherever its input shows
one of these (no option chooses the path):

  - a tensor of the batch or of the parameters is not on the card, or is
    fake (the CPU tests, the dry run), or a tensor of the batch is not
    contiguous;
  - `rules` is given (a call across ranks);
  - grad is enabled and a parameter requires grad;
  - a dispatch mode is active (`FakeTensorMode`, `launch/hlo_stats.Counter`);
  - torch's profiler records and the signature has no graph yet: nothing
    is captured or warmed up under the profiler;
  - the cache holds a graph or a failed capture for as many signatures as
    it may (`MAX_GRAPHS`);
  - the signature's capture failed: the warm-up waited for the card on the
    host, or CUDA refused the capture. It stays eager for good; a capture
    refused midway has its allocator routing and the card's random
    generator put back (`_abandon`), and the graphs to come take a new
    pool (torch 2.11 takes no capture again into a pool where one failed).

The kernel wrappers' `launches` count where the wrappers launch: an eager
call adds its launches once, a capture twice (the warm-up, and the
capture, which its first replay runs), a replay nothing. What a replay
runs on the card is read from the device trace, by kernel name.

All graphs of a `Graphs` share one memory pool and one capture stream and
replay on the caller's stream, one at a time: a graph's intermediates may
lie where another's lie, so each graph holds its static inputs and output
for its whole lifetime, a replay fills its inputs just before it, and a
replay's output is cloned before the next replay. The pool also holds the
graphs' intermediates between replays: the card's memory they take reads
in `torch.cuda.memory_reserved`, not in `memory_allocated`.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, List, NamedTuple, Optional, Set, Tuple

import torch
import torch.autograd.profiler as _profiler
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

MAX_GRAPHS = 8  # signatures that hold a graph or a failed capture, at most
MAX_ONCE = 1024  # signatures seen once that are remembered, at most (then forgotten, all)
# where each static input starts in its dtype's buffer: on the caching
# allocator's block size, as a tensor of its own would
ALIGN_BYTES = 512


def on_card(t: torch.Tensor) -> bool:
    """A real tensor on a CUDA device (a plain tensor is never fake: the
    type check spares most calls the slower `is_fake`)."""
    return t.is_cuda and (type(t) is torch.Tensor or not is_fake(t))


def _add_leaves(tree, key: List, grad: bool) -> bool:
    """Append each parameter leaf's (address, shape, strides, dtype) to
    `key`; False where a leaf is not a card tensor, or requires grad under
    grad mode, or the tree holds anything but tensors, dicts, lists and
    tuples."""
    if isinstance(tree, torch.Tensor):
        if not on_card(tree) or (grad and tree.requires_grad):
            return False
        key.append((tree.data_ptr(), tree.shape, tree.stride(), tree.dtype))
        return True
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return False
    for v in tree:
        if not _add_leaves(v, key, grad):
            return False
    return True


def signature(params, batch: Dict, cfg) -> Optional[Tuple]:
    """The call's signature, or None where a tensor is not on the card (or
    is fake), a batch entry is not a contiguous tensor, or grad would flow
    into a parameter."""
    key: List = [id(cfg)]
    for k, t in batch.items():
        if not isinstance(t, torch.Tensor) or not on_card(t) or not t.is_contiguous():
            return None
        key.append((k, t.shape, t.dtype, t.device))
    if not _add_leaves(params, key, torch.is_grad_enabled()):
        return None
    return tuple(key)


def pack(batch: Dict) -> Tuple[Dict, List]:
    """Static inputs for `batch`: the tensors of each dtype as views of one
    buffer, each view starting on `ALIGN_BYTES`, so that `fill` copies a
    batch in with one launch a dtype rather than one a tensor; returns
    (the views by key, [(buffer, its parts: keys, and fillers of the gaps)])."""
    groups: Dict[torch.dtype, List] = {}
    for k, t in batch.items():
        groups.setdefault(t.dtype, []).append(k)
    inputs, packs = {}, []
    for dtype, keys in groups.items():
        device = batch[keys[0]].device
        step = max(1, ALIGN_BYTES // batch[keys[0]].element_size())
        parts, at, n = [], [], 0
        for k in keys:
            size = batch[k].numel()
            gap = -size % step
            parts.append(k)
            if gap:
                parts.append(torch.zeros(gap, dtype=dtype, device=device))
            at.append(n)
            n += size + gap
        flat = torch.empty(n, dtype=dtype, device=device)
        for k, a in zip(keys, at):
            inputs[k] = flat[a:a + batch[k].numel()].view(batch[k].shape)
        packs.append((flat, parts))
    fill(packs, batch)
    return inputs, packs


def fill(packs: List, batch: Dict) -> None:
    """Copy `batch` into the static inputs that `pack` laid out."""
    for flat, parts in packs:
        torch.cat([p if isinstance(p, torch.Tensor) else batch[p].view(-1) for p in parts],
                  out=flat)


class _Graph(NamedTuple):
    """A captured call."""
    graph: torch.cuda.CUDAGraph
    packs: List  # its static inputs: `pack`'s buffers and parts
    out: torch.Tensor  # its static output
    cfg: object  # whose identity the signature holds: kept, so no other config takes it


class Graphs:
    """The graphs of one process's serve calls, by signature; `most`: the
    signatures it holds a graph or a failed capture for, at most (with 0,
    every call runs as written)."""

    def __init__(self, most: int = MAX_GRAPHS):
        self.most = most
        # in the order they go with the object: the graphs and their
        # static inputs before the pool they lie in
        self.graphs: Dict[Tuple, Optional[_Graph]] = {}  # None: the capture failed
        self.once: Set[Tuple] = set()  # signatures seen once
        self.stream: Optional[torch.cuda.Stream] = None  # the capture stream
        self.spent: List = []  # pools a capture failed in, kept for the graphs that lie there
        self.pool = None  # the memory pool of the graphs to come, a `torch.cuda.MemPool`

    def path(self, params, batch: Dict, cfg, rules) -> Tuple[str, Optional[Tuple]]:
        """("eager" | "capture" | "replay", the signature); the signature is
        None where the call runs as written, on the caller's stream."""
        if rules is not None or _get_current_dispatch_mode_stack():
            return "eager", None
        sig = signature(params, batch, cfg)
        if sig is None:
            return "eager", None
        if sig in self.graphs:
            return ("eager", None) if self.graphs[sig] is None else ("replay", sig)
        if _profiler._is_profiler_enabled or len(self.graphs) >= self.most:
            return "eager", None
        if sig in self.once:
            return "capture", sig
        if len(self.once) >= MAX_ONCE:
            self.once.clear()
        self.once.add(sig)
        return "eager", None

    def run(self, how: str, sig: Tuple, fn: Callable, params, batch: Dict, cfg):
        """The scores of a call that `path` sent to "capture" or "replay"."""
        if how == "capture":
            self.once.discard(sig)
            self.graphs[sig] = self._capture(fn, params, batch, cfg)
            if self.graphs[sig] is None:
                return fn(params, batch, cfg, None)
        return _replay(self.graphs[sig], batch)

    def _capture(self, fn: Callable, params, batch: Dict, cfg) -> Optional[_Graph]:
        """The call captured on static inputs that hold `batch`, after a
        warm-up on them: both on the capture stream, every tensor they make
        in the pool. None where the warm-up waits for the card on the host
        (CUDA's sync debug mode at error finds it before any capture) or
        CUDA refuses the capture; the caller's stream and the sync debug
        mode read as before either way."""
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        if self.pool is None:
            self.pool = torch.cuda.MemPool()
        stream, caller = self.stream, torch.cuda.current_stream()
        mode, collecting = torch.cuda.get_sync_debug_mode(), gc.isenabled()
        stream.wait_stream(caller)
        # no collection while the pool takes the allocations: a pool freed
        # meanwhile (another `Graphs` in a reference cycle) would stop the process
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                with torch.cuda.use_mem_pool(self.pool):
                    inputs, packs = pack(batch)
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        fn(params, inputs, cfg, None)
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
                try:
                    graph, out = self._record(fn, params, inputs, cfg)
                except RuntimeError:
                    # torch takes no capture again into a pool where one
                    # failed: the next capture opens a new one
                    self.spent.append(self.pool)
                    self.pool = None
                    raise
        except RuntimeError:  # the warm-up synchronised with the host, or the capture failed
            return None
        finally:
            if collecting:
                gc.enable()
            caller.wait_stream(stream)
        return _Graph(graph, packs, out, cfg)

    def _record(self, fn: Callable, params, inputs: Dict, cfg):
        """(the graph, its static output) of the call captured on the
        current stream, into the pool; raises RuntimeError where CUDA
        refuses it, with what the refusal left set put back."""
        device = torch.cuda.current_device()
        generator = torch.cuda.default_generators[device]
        before = generator.clone_state()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(self.pool.id)
        try:
            out = fn(params, inputs, cfg, None)
        finally:
            try:
                graph.capture_end()
            except RuntimeError:
                _abandon(device, self.pool, generator, before)
                raise
        return graph, out


def _abandon(device: int, pool, generator: torch.Generator, before: torch.Generator) -> None:
    """What a capture that CUDA refused leaves set, put back. `capture_end`
    raises before it ends the pool's capture: the allocator would still
    take the pool as in use by a capture (its blocks never freed, the
    capture stream's later allocations put in it), and the card's random
    generator would stay marked as capturing, so that every later draw
    raised. The pool's capture is ended and released; the generator takes
    a copy of its state from before the capture. Where `capture_end` got
    as far as ending the pool's capture, the pool is not released again:
    the object's own hold on it stays whole."""
    try:
        torch._C._cuda_endAllocateToPool(device, pool.id)
    except RuntimeError:  # not recording to the pool: the capture ended that
        pass
    else:
        torch._C._cuda_releasePool(device, pool.id)
    generator.graphsafe_set_state(before)


def _replay(entry: _Graph, batch: Dict) -> torch.Tensor:
    fill(entry.packs, batch)
    entry.graph.replay()
    return entry.out.clone()


GRAPHS = Graphs()
