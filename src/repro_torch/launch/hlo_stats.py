"""What one rank computes, counted over the ops it dispatches (port of
`repro.launch.hlo_stats`).

`repro` parses the HLO text of XLA's compiled, SPMD-partitioned program.
PyTorch runs eagerly and has no such program: here a `TorchDispatchMode`,
`Counter`, sees every ATen op and every `c10d` collective that the call
dispatches below autograd, forward, backward and recompute alike, on real
or on fake tensors (`torch._subclasses.fake_tensor`, which the dry run
uses: shapes, no storage). `stats()` returns `repro`'s `analyze` keys:

  * flops          dot flops only, as `repro` defines them: 2 · output
                   elements · contracted size, for mm, bmm, addmm, baddbmm,
                   mv, convolution and SDPA (`torch.utils.flop_counter`'s
                   formulas), but not a product whose contracted dim has size
                   1 (an outer product, which XLA's compiled program holds as
                   an elementwise multiply). Eager torch has no loops to scale: a layer run
                   8 times is counted 8 times, and a `torch.utils.checkpoint`
                   recompute again, as XLA counts remat. A hand-written
                   kernel's work goes under `kernels`, not here.
  * bytes_hbm      per op its operands plus its new outputs, each tensor
                   once (an operand written in place once): views and
                   metadata ops count nothing, a gather-like op 2 · output +
                   indices, a scatter-like op 2 · update, a kernel its
                   work's bytes (`kernels/work`). Eager ops materialise
                   what XLA fuses, so this is the eager program's traffic,
                   not `repro`'s.
  * collectives    per-device link bytes by kind under `repro`'s ring model
                   (`launch/analysis`): all-gather its output, all-reduce
                   2 × its input, the rest their input; `total`.
  * collective_counts  ops by kind.
  * top_computations  the 12 flop-heaviest functions that issued dot ops
                   (the innermost frame outside torch, as
                   "models.transformer._layer"), with their flops.
  * kernels        per hand-written kernel: calls, flops and bytes, from
                   the wrappers' `kernels/work.record` (a launch, or the
                   shape-only path on fake tensors; each call's dense work).

and `memory()`, the memory of the call: `argument_bytes` (the storages
given to `track_arguments`), `output_bytes`, `temp_bytes` (the peak of
bytes allocated during the call and alive at once: each op's new output
storage is held from its op until it is freed, through a weakref) and
`alias_bytes` (outputs that reuse a donated argument's storage).
"""
from __future__ import annotations

import os
import sys
import weakref
from collections import defaultdict
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# c10d op -> (kind, which of its arguments the ring model counts, whether
# argument 0 is an output buffer beside an input in argument 1): the
# gathers count their output, the rest their input; an op of one argument
# (all-reduce, broadcast, send) works in place
_COLLECTIVES = {
    "_allgather_base_": ("all-gather", 0, True), "allgather_": ("all-gather", 0, True),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, True),
    "allreduce_": ("all-reduce", 0, False), "allreduce_coalesced_": ("all-reduce", 0, False),
    "_reduce_scatter_base_": ("reduce-scatter", 1, True),
    "reduce_scatter_": ("reduce-scatter", 1, True),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, True),
    "alltoall_base_": ("all-to-all", 1, True), "alltoall_": ("all-to-all", 1, True),
    "broadcast_": ("collective-permute", 0, False), "send": ("collective-permute", 0, False),
}


def _mv_flops(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.numel()


# torch's formulas, and a matrix-vector product's (FM's retrieval scores)
_FLOPS = {**flop_registry, aten.mv: _mv_flops}
# products over a contracted dim: the operand whose last dim it is
_PRODUCTS = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.addmm: 1, aten.baddbmm: 1}
# allocations: no traffic (views count none either: `func.is_view`)
_NO_BYTES = {aten.empty, aten.empty_like, aten.new_empty, aten.empty_strided,
             aten.new_empty_strided}
# gather-like: 2 · output + the index operands
_GATHERS = {aten.index_select, aten.embedding, aten.gather, aten.index}
# scatter-like: 2 · the update operand
_SCATTERS = {aten.index_add_: "source", aten.index_add: "source",
             aten.scatter_add_: "src", aten.scatter_add: "src",
             aten.index_put_: "values", aten.index_put: "values",
             aten._index_put_impl_: "values"}

_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _unique(tensors: Iterable[torch.Tensor]) -> list:
    seen, out = set(), []
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _named(func, args, kwargs) -> Dict:
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    return named


def _outer(packet, args) -> bool:
    """A product whose contracted dim has size 1: an outer product, which
    XLA rewrites into an elementwise multiply (no dot in `repro`'s count)."""
    i = _PRODUCTS.get(packet)
    return i is not None and args[i].shape[-1] == 1


def _caller() -> str:
    """The innermost Python frame outside torch and this module: its
    module (without "repro_torch.") and qualified name."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if not path.startswith(_TORCH_DIR) and path != __file__:
            module = f.f_globals.get("__name__", "?").removeprefix("repro_torch.")
            return f"{module}.{f.f_code.co_qualname}"
        f = f.f_back
    return "?"


class Counter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (`with Counter() as c:`),
    on any device; `stats()` and `memory()` read the counts."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_hbm = 0.0
        self.collectives = {k: 0.0 for k in COLL_KINDS}
        self.collective_counts = {k: 0 for k in COLL_KINDS}
        self.by_function: Dict[str, float] = defaultdict(float)
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._arguments: Dict[int, int] = {}  # storage -> bytes
        self._live: Dict[int, int] = {}  # storage made during the call -> bytes
        self._now = 0
        self.peak = 0

    # -- what the wrappers and the dry run call ------------------------------

    def add_kernel(self, name: str, work: Dict) -> None:
        """One call of hand-written kernel `name` doing `work` (a
        `kernels/work` dict: its "flops" and "bytes")."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += work["flops"]
        k["bytes"] += work["bytes"]
        self.bytes_hbm += work["bytes"]

    def track_arguments(self, tree) -> None:
        """The call's arguments: their storages count as `argument_bytes`,
        not as temporaries."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            self._arguments[st._cdata] = st.nbytes()

    # -- the dispatch hook ---------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.namespace == "c10d":
            self._collective(func, args)
        else:
            if packet in _FLOPS and not _outer(packet, args):
                f = float(_FLOPS[packet](*args, **kwargs, out_val=out))
                if f:
                    self.flops += f
                    self.by_function[_caller()] += f
            self.bytes_hbm += self._op_bytes(func, packet, args, kwargs, out)
        for t in _tensors(out):
            self._hold(t)
        return out

    def _collective(self, func, args) -> None:
        kind, arg, paired = _COLLECTIVES.get(func.overloadpacket.__name__, (None, 0, False))
        if kind is None:
            return
        counted = _nbytes(_unique(_tensors(args[arg])))
        self.collectives[kind] += 2 * counted if kind == "all-reduce" else counted
        self.collective_counts[kind] += 1
        # HBM: the input read and the output written; in place, one buffer twice
        self.bytes_hbm += _nbytes(_unique(_tensors(args[:2]))) if paired else 2 * counted

    def _op_bytes(self, func, packet, args, kwargs, out) -> int:
        if func.is_view or packet in _NO_BYTES:
            return 0
        if packet in _GATHERS:
            named = _named(func, args, kwargs)
            index = named.get("index", named.get("indices"))
            return 2 * _nbytes(_tensors(out)) + _nbytes(_unique(_tensors(index)))
        if packet in _SCATTERS:
            named = _named(func, args, kwargs)
            return 2 * _nbytes(_tensors(named[_SCATTERS[packet]]))
        operands = _unique(_tensors((args, kwargs)))
        ids = {id(t) for t in operands}
        return _nbytes(operands) + _nbytes(t for t in _unique(_tensors(out)) if id(t) not in ids)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._arguments:
            return
        n = st.nbytes()
        self._live[key] = n
        self._now += n
        self.peak = max(self.peak, self._now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._now -= self._live.pop(key, 0)

    # -- readings ------------------------------------------------------------

    def stats(self) -> Dict:
        """`repro`'s `analyze` keys, and `kernels`."""
        top = sorted(self.by_function.items(), key=lambda kv: -kv[1])[:12]
        coll = dict(self.collectives)
        coll["total"] = sum(coll[k] for k in COLL_KINDS)
        return {
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "collectives": coll,
            "collective_counts": dict(self.collective_counts),
            "top_computations": [(n, f) for n, f in top],
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
        }

    def memory(self, outputs=None, donated=None) -> Dict:
        """`repro`'s `memory_analysis` fields: the arguments' bytes, the
        outputs' (`outputs`, a tree), the peak of bytes made during the call
        and alive at once, and the outputs' bytes that reuse a storage of
        `donated` (a tree of the donated arguments)."""
        outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(outputs)}
        gave = {t.untyped_storage()._cdata for t in _tensors(donated)}
        return {"argument_bytes": sum(self._arguments.values()),
                "output_bytes": sum(outs.values()),
                "temp_bytes": self.peak,
                "alias_bytes": sum(n for k, n in outs.items() if k in gave)}


def count(fn, args, donate: Iterable[int] = ()) -> tuple:
    """`fn(*args)` under a `Counter` with `args` its arguments: (its
    output, `stats()`, `memory()` with `args[i]` for i in `donate`
    donated). On fake tensors, call it inside their `FakeTensorMode`."""
    c = Counter()
    c.track_arguments(args)
    with c:
        out = fn(*args)
    return out, c.stats(), c.memory(out, [args[i] for i in donate])
