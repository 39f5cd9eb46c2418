"""Chunked, atomic checkpoints (port of `repro.training.checkpoint`).

Layout, the same as `repro`'s, so that a checkpoint crosses between the
packages in both directions: <dir>/step_<N:08d>/
    manifest.msgpack     — step, a structure string, the leaf count, per-leaf
                           shape/dtype/chunking, and `extra`
    leaf_<i:05d>_<c:04d>.npy — row-chunked leaf data, leaves in JAX's
                           flatten order
A save goes to step_<N>.tmp/, then `os.replace` publishes it: a crashed
writer never leaves a half-written step that `latest_step` would pick.

Leaf order is `jax.tree.flatten`'s: dict keys sorted, tuple and list
entries in position. The manifest is written by this module's own small
msgpack codec (`packb`/`unpackb`: maps, arrays, str, int, float64, bool and
nil), byte for byte what `msgpack.packb` writes, so the port needs no
`msgpack` package. `repro` writes `str(treedef)` into the manifest and never
reads it; this module writes its own structure string and, like `repro`,
reads only the leaves and their count.
"""
from __future__ import annotations

import os
import shutil
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import PartitionSpec, distribute_one, spec_of
from repro_torch.models.common import numpy_from_tensor, tensor_from_numpy

_CHUNK_BYTES = 256 * 2**20


# ---------------------------------------------------------------------------
# msgpack, the subset a manifest needs
# ---------------------------------------------------------------------------


def _pack_len(n: int, fix_base: int, fix_max: int, codes: Tuple[int, int, int]) -> bytes:
    """A str, array or map header: the fix form up to `fix_max`, else the
    first of `codes` (8, 16, 32-bit lengths; 0 where the type has none)
    that holds n."""
    if n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack length of {n} is too long")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16), (0xCE, ">I", 2**32),
                                 (0xCF, ">Q", 2**64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15), (0xD2, ">i", 2**31),
                                 (0xD3, ">q", 2**63)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"{v} does not fit msgpack's 64-bit integers")


def _pack(obj, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data)
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 15, (0, 0xDC, 0xDD)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_pack_len(len(obj), 0x80, 15, (0, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into a manifest")


def packb(obj) -> bytes:
    """`obj` (dicts, lists/tuples, str, int, float, bool, None) as msgpack,
    the bytes `msgpack.packb(obj)` gives."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _unpack(buf: bytes, i: int):
    b = buf[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, i, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, i, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return buf[i:i + n].decode("utf-8"), i + n
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b], i
    fixed = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
             0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        (v,) = struct.unpack_from(fixed[b], buf, i)
        return v, i + struct.calcsize(fixed[b])
    lengths = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
               0xDC: (">H", "array"), 0xDD: (">I", "array"),
               0xDE: (">H", "map"), 0xDF: (">I", "map")}
    if b not in lengths:
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one a manifest holds")
    fmt, kind = lengths[b]
    (n,) = struct.unpack_from(fmt, buf, i)
    i += struct.calcsize(fmt)
    if kind == "str":
        return buf[i:i + n].decode("utf-8"), i + n
    return (_unpack_array if kind == "array" else _unpack_map)(buf, i, n)


def _unpack_array(buf: bytes, i: int, n: int):
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _unpack_map(buf: bytes, i: int, n: int):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(data: bytes):
    """msgpack bytes -> Python objects (arrays as lists, as `msgpack.unpackb`)."""
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes follow the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# trees in JAX's flatten order
# ---------------------------------------------------------------------------


def flatten(tree) -> Tuple[List[Any], str]:
    """Leaves of nested dicts / tuples / lists in `jax.tree.flatten` order
    (dict keys sorted, sequences in position; None is an empty node), and a
    string of the structure."""
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, s = flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {s}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (tuple, list)):
        leaves, parts = [], []
        for v in tree:
            sub, s = flatten(v)
            leaves += sub
            parts.append(s)
        open_, close = ("(", ")") if isinstance(tree, tuple) else ("[", "]")
        return leaves, open_ + ", ".join(parts) + close
    if tree is None:
        return [], "None"
    return [tree], "*"


def leaf_paths(tree, prefix: str = "") -> List[str]:
    """The path of each leaf of `tree`, in `flatten` order: dict keys and
    sequence positions joined by "/" (e.g. "0/tables/item")."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}{i}/")]
    return [] if tree is None else [prefix.rstrip("/")]


def unflatten(like, leaves: List[Any]):
    """`like`'s structure with its leaves replaced, in `flatten` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(like)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def _leaf_chunks(arr: np.ndarray):
    if arr.ndim == 0 or arr.nbytes <= _CHUNK_BYTES:
        return [arr]
    rows_per = max(1, _CHUNK_BYTES // max(arr[0:1].nbytes, 1))
    return [arr[i : i + rows_per] for i in range(0, arr.shape[0], rows_per)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as numpy, and the dtype name its manifest entry records: a
    bfloat16 tensor as its 16-bit patterns, recorded "bfloat16" as `repro`
    records an `ml_dtypes.bfloat16` array."""
    if torch.is_tensor(leaf):
        arr = numpy_from_tensor(leaf)
        return arr, "bfloat16" if leaf.dtype == torch.bfloat16 else str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    """`np.save(path, arr)`; a bfloat16 chunk (`arr` its uint16 patterns)
    under the header `np.save` writes for an `ml_dtypes.bfloat16` array,
    descr '<V2', so the file is byte for byte `repro`'s."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes(order="C"))


def save(ckpt_dir, step: int, tree: Any, extra: Optional[Dict] = None) -> Path:
    """Write `tree` (nested dicts / tuples of tensors or arrays, on any
    device) as step `step`; returns the published directory."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, structure = flatten(tree)
    meta = []
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        chunks = _leaf_chunks(arr)
        for c, chunk in enumerate(chunks):
            _save_npy(tmp / f"leaf_{i:05d}_{c:04d}.npy", chunk, dtype)
        meta.append({"shape": list(arr.shape), "dtype": dtype, "n_chunks": len(chunks)})

    manifest = {
        "step": step,
        "treedef": structure,
        "n_leaves": len(leaves),
        "leaves": meta,
        "extra": extra or {},
    }
    (tmp / "manifest.msgpack").write_bytes(packb(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and not p.name.endswith(".tmp")
        and (p / "manifest.msgpack").exists()
    ]
    return max(steps) if steps else None


def _shape_dtype(leaf) -> Tuple[List[int], str]:
    """A leaf's shape and its dtype's name, as a manifest records them
    (numpy's name; "bfloat16" for a bfloat16 tensor)."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return list(leaf.shape), "bfloat16"
        return list(leaf.shape), str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    arr = np.asarray(leaf)
    return list(arr.shape), str(arr.dtype)


def _layout_leaves(shardings, like) -> List[Any]:
    """The leaf of `shardings` at each leaf of `like`, in `flatten` order:
    `shardings` has `like`'s structure down to its leaves, and each of its
    leaves is a PartitionSpec, a (mesh, placements) pair or None."""
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _layout_leaves(shardings[k], like[k])]
    if isinstance(like, (tuple, list)):
        return [s for sub, ref in zip(shardings, like) for s in _layout_leaves(sub, ref)]
    return [] if like is None else [shardings]


def _laid_out(tensor: torch.Tensor, layout, mesh):
    """`tensor` as a `DTensor` under `layout` (a spec on `mesh`, or a
    (mesh, placements) pair), or as it is where `layout` is None."""
    if layout is None:
        return tensor
    if isinstance(layout, PartitionSpec):
        if mesh is None:
            raise ValueError("a PartitionSpec layout needs restore's `mesh`")
        return distribute_one(tensor, layout, mesh)
    leaf_mesh, placements = layout
    return distribute_one(tensor, spec_of(placements, leaf_mesh), leaf_mesh)


def restore(ckpt_dir, step: int, like: Any, device=None, shardings=None, mesh=None) -> Any:
    """Step `step` in `like`'s structure, each leaf a tensor of the dtype
    it was saved in (a "bfloat16" leaf, which numpy loads as '<V2' bytes, a
    `torch.bfloat16` tensor of the same bits), on `device` if given, else on the device of its `like`
    leaf (the CPU where that leaf is not a tensor). Refuses a checkpoint
    whose leaf count is not `like`'s, and one with a leaf whose shape or
    dtype is not its `like` leaf's, naming the leaf's path (`repro` checks
    the count only, and restores a leaf of another shape as it was saved).

    Reshard-on-restore: `shardings`, a tree of `like`'s structure whose
    leaves are PartitionSpecs (on `mesh`) or (DeviceMesh, placements)
    pairs, makes each leaf a `DTensor` holding this rank's block on the
    mesh's device (`distributed/sharding.distribute_one`); the same
    checkpoint restores onto any mesh whose dims divide its leaves."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = unpackb((path / "manifest.msgpack").read_bytes())
    leaves_like, _ = flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target tree {len(leaves_like)}")
    for name, m, ref in zip(leaf_paths(like), manifest["leaves"], leaves_like):
        shape, dtype = _shape_dtype(ref)
        if (list(m["shape"]), m["dtype"]) != (shape, dtype):
            raise ValueError(
                f"checkpoint leaf {name!r} in {path} is {m['dtype']} {tuple(m['shape'])}, "
                f"the target's {dtype} {tuple(shape)}")

    layouts = ([None] * len(leaves_like) if shardings is None
               else _layout_leaves(shardings, like))
    out = []
    for i, (m, ref, layout) in enumerate(zip(manifest["leaves"], leaves_like, layouts)):
        chunks = [np.load(path / f"leaf_{i:05d}_{c:04d}.npy") for c in range(m["n_chunks"])]
        arr = chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=0)
        tensor = tensor_from_numpy(arr)  # a writable copy; '<V2' as bfloat16
        if layout is not None:
            out.append(_laid_out(tensor, layout, mesh))
            continue
        dev = device if device is not None else (ref.device if torch.is_tensor(ref) else "cpu")
        out.append(tensor.to(dev))
    return unflatten(like, out)
