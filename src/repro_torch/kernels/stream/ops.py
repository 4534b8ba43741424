"""Front door of the streaming scans: ``hdrf_scan(edges, p, n, lam)`` and
``oblivious_scan(edges, p, n, limit)``, each the (M,) int32 partition of
every edge of the stream, in stream order, as the reference package's
``_hdrf_scan`` and ``_oblivious_scan`` return it.

The tensor's device decides the route: a CPU tensor goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written kernel in
``csrc/stream.cu`` (built with ``nvcc`` at first use); anything else
raises.  There is no fallback from the kernel to the plain version.
Each wrapper checks its inputs, then :func:`prepare` allocates the zeroed
replica flags, the partial degrees and the output, and :func:`launch`
launches on the current stream and adds one to ``launches[name]``: the
one place a stream kernel is launched.  An empty stream launches
nothing.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.stream import ref

launches = {"hdrf_scan": 0, "oblivious_scan": 0}

_P = ctypes.c_void_p
_ARGTYPES = {
    "stream_hdrf": [_P, ctypes.c_longlong, ctypes.c_int, _P, _P,
                    ctypes.c_float, ctypes.c_int, _P, _P],
    "stream_oblivious": [_P, ctypes.c_longlong, ctypes.c_int, _P,
                         ctypes.c_int, ctypes.c_int, _P, _P],
}
MAX_THREADS = 1024


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def threads(p: int) -> int:
    """The block's threads: P rounded up to a warp, at most 1,024 (a
    thread then owns several partitions)."""
    return min(MAX_THREADS, -(-p // 32) * 32)


def _lib():
    """The built library, its argument types set (built at first use)."""
    from repro_torch.kernels import build

    lib = build.load("stream")
    if lib.stream_hdrf.argtypes is None:
        for fn, argtypes in _ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check(edges: torch.Tensor, p: int, n: int) -> str:
    """'cpu' or 'cuda'; raises on anything the kernels do not take."""
    if edges.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stream kernel for device {edges.device}")
    if edges.dim() != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges (M, 2) expected, got {tuple(edges.shape)}")
    if edges.dtype != torch.int32:
        raise TypeError(f"edges must be int32, got {edges.dtype}")
    if p < 1 or n < 0:
        raise ValueError(f"p={p}, n={n}: need p >= 1 and n >= 0")
    if edges.numel():        # the kernels index (N, P) rows by vertex id
        lo, hi = (int(x) for x in torch.aminmax(edges))
        if lo < 0 or hi >= n:
            raise ValueError(f"vertex ids in [{lo}, {hi}] outside "
                             f"[0, {n})")
    return edges.device.type


class Scan(NamedTuple):
    """One scan on the card: its kernel, its inputs and its state."""

    name: str                      # "hdrf_scan" or "oblivious_scan"
    edges: torch.Tensor            # (M, 2) int32, contiguous, 8-byte aligned
    p: int
    arg: float | int               # HDRF's lambda, Oblivious' limit
    vparts: torch.Tensor           # (N, P) uint8 replica flags
    degree: torch.Tensor | None    # (N,) int32 partial degrees (HDRF)
    out: torch.Tensor              # (M,) int32 partitions


def prepare(name: str, edges: torch.Tensor, p: int, n: int,
            arg: float | int) -> Scan:
    """The scan ``name`` of the CUDA stream ``edges`` (M >= 1, checked by
    the caller) with its state zeroed: what :func:`launch` runs."""
    if name not in launches:
        raise ValueError(f"no stream kernel {name!r}")
    edges = edges.contiguous()
    if edges.data_ptr() % 8:             # the kernel reads int2 rows
        edges = edges.clone()
    dev = edges.device
    degree = (torch.zeros(n, dtype=torch.int32, device=dev)
              if name == "hdrf_scan" else None)
    return Scan(name, edges, p, arg,
                torch.zeros((n, p), dtype=torch.uint8, device=dev), degree,
                torch.empty(edges.shape[0], dtype=torch.int32, device=dev))


def launch(scan: Scan) -> torch.Tensor:
    """One launch of ``scan``'s kernel on the current stream over its
    state as it stands (zeroed by :func:`prepare`); returns ``scan.out``."""
    lib = _lib()
    m = scan.edges.shape[0]
    if scan.name == "hdrf_scan":
        fn = "stream_hdrf"
        args = (scan.degree.data_ptr(), ctypes.c_float(scan.arg))
    else:
        fn = "stream_oblivious"
        args = (int(scan.arg),)
    err = getattr(lib, fn)(
        scan.edges.data_ptr(), m, scan.p, scan.vparts.data_ptr(), *args,
        threads(scan.p), scan.out.data_ptr(),
        torch.cuda.current_stream(scan.edges.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn} failed with cudaError_t {err} "
                           f"(M={m}, P={scan.p}, N={scan.vparts.shape[0]})")
    launches[scan.name] += 1
    return scan.out


def hdrf_scan(edges: torch.Tensor, p: int, n: int,
              lam: float = 1.0) -> torch.Tensor:
    """HDRF over the stream ``edges`` (M, 2) int32 of a graph with ``n``
    vertices, into ``p`` partitions with balance weight ``lam``."""
    route = _check(edges, p, n)
    if route == "cpu":
        return ref.hdrf_scan_ref(edges, p, n, lam)
    if edges.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=edges.device)
    return launch(prepare("hdrf_scan", edges, p, n, lam))


def oblivious_scan(edges: torch.Tensor, p: int, n: int,
                   limit: int) -> torch.Tensor:
    """Oblivious greedy over the stream ``edges`` (M, 2) int32 of a graph
    with ``n`` vertices, into ``p`` partitions of room ``limit`` each."""
    route = _check(edges, p, n)
    if route == "cpu":
        return ref.oblivious_scan_ref(edges, p, n, limit)
    if edges.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=edges.device)
    # |E_p| never passes M < 2^31, so a larger limit acts as 2^31 - 1
    return launch(prepare("oblivious_scan", edges, p, n,
                          min(int(limit), 2**31 - 1)))
