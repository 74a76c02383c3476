"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface
(``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
-Xcompiler -fPIC``), built at first use into ``build/kernels/`` at the
repository root and named by a hash of its source, every header under
``csrc/`` (in sorted order) and the flags, so an unchanged source is never
rebuilt and an edit to any header rebuilds every library.  All missing
libraries build in parallel, one nvcc process per source.  No ``--use_fast_math``:
``walk_step`` must stay bit-exact.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {
    "walk_step": "walk_step.cu",
    "frontier_push": "frontier_push.cu",
    "index_combine_sparse": "index_combine.cu",
    "index_combine": "index_combine_dense.cu",
    "ell_spmm": "ell_spmm.cu",
    "sharded_frontier_push": "sharded_frontier_push.cu",
    "embedding_bag": "embedding_bag.cu",
    "embedding_bag_backward": "embedding_bag_backward.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}   # name -> nvcc's stderr (ptxas register use)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda)")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet,
    every nvcc in parallel; raises with nvcc's output if one fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: library_path(name) for name in names}
    procs = {}
    for name, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        stdout, stderr = proc.communicate()
        build_log[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{stderr}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def next_pow2(w: int) -> int:
    p = 1
    while p < w:
        p <<= 1
    return p


def check_launch(status: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {status}")
