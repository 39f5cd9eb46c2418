"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` into its own shared library with a
plain C interface, loaded with ctypes. The libraries go to `build/repro_torch/`
at the root of the checkout (listed in `.gitignore`), named by a hash of
the source and the flags, so a second run reuses them and an edited source
is rebuilt. Nothing here runs at import: a machine without `nvcc` imports
every module of the port, and only a launch on a CUDA tensor needs a
library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def lib_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` lives, keyed by source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing; returns
    {"seconds", "built": [names], "cached": [names], "ptxas": {name: text}}."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not lib_path(n).exists()]
    ptxas = {}
    for n in todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        ptxas[n] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {n}.cu:\n{proc.stdout}")
        os.replace(tmp, lib_path(n))  # atomic: a concurrent loader sees all or nothing
    return {
        "seconds": time.perf_counter() - t0,
        "built": todo,
        "cached": [n for n in names if n not in todo],
        "ptxas": ptxas,
    }


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if it is missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
