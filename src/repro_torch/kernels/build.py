"""Build ``kernels/<family>/csrc/<family>.cu`` with ``nvcc`` into shared
libraries, load them with ctypes.

Each source becomes one library with a plain C interface (no PyTorch
headers, so a build takes seconds).  The library's name carries a hash of
its source, so an edit rebuilds and a stale library is never loaded.  The
output goes to ``build/repro_torch/`` at the root of the checkout.  A
failed build raises with the compiler's output.  ``load`` of several
families starts their ``nvcc`` processes together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# every family of the port, each built from kernels/<family>/csrc/<family>.cu
FAMILIES = ("ne_round", "block_spmm", "embedding_bag", "flash_attention")

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _library(family: str) -> Path:
    src = KERNELS / family / "csrc" / f"{family}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{family}-{digest}.so"


def load(*families: str) -> ctypes.CDLL:
    """The loaded library of ``<family>/csrc/<family>.cu`` for each family
    (the last one's is returned), built at first use: one ``nvcc`` for each
    source not built yet, all started together."""
    runs = {}
    for family in families:
        if family in _loaded:        # the wrappers call this every launch
            continue
        lib = _library(family)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(KERNELS / family / "csrc" / f"{family}.cu")]
        runs[family] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for family, (_, _, proc) in runs.items():
        build_logs[family] = proc.communicate()[0]
    for family, (cmd, tmp, proc) in runs.items():
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{family}: {' '.join(cmd)}\n"
                               f"{build_logs[family]}")
        os.replace(tmp, _library(family))
    for family in families:
        if family not in _loaded:
            _loaded[family] = ctypes.CDLL(str(_library(family)))
    return _loaded[families[-1]]
