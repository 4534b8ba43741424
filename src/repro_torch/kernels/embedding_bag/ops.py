"""Front door of the embedding bag: ``embedding_bag(table, ids, weights,
mode)`` with the reference package's signature and modes.

The tensor's device decides the route: a CPU tensor goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written kernel in
``csrc/embedding_bag.cu`` (built with ``nvcc`` at first use); anything
else raises.  There is no fallback from the kernel to the plain version.
The wrapper checks its inputs, allocates the output, launches on the
current stream and adds one to ``launches["embedding_bag"]`` per kernel
call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.embedding_bag import ref

launches = {"embedding_bag": 0}

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_int, _P, _P, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, _P, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    """The built library, its argument types set (built at first use)."""
    from repro_torch.kernels import build

    lib = build.load("embedding_bag")
    if lib.embedding_bag.argtypes is None:
        lib.embedding_bag.argtypes = _ARGTYPES
        lib.embedding_bag.restype = ctypes.c_int
    return lib


def _route(*tensors) -> str:
    """'cpu' or 'cuda' from the tensors' common device; raises otherwise."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no embedding_bag kernel for device {dev}")
    return dev.type


def _bag_sum(table, ids, weights):
    """Σ_k w · table[ids]: the plain version on the CPU, else one launch.
    ``weights=None`` means weight 1 in every slot (the kernel then reads
    no weights)."""
    if _route(table, ids, weights) == "cpu":
        if weights is None:
            weights = torch.ones(ids.shape, dtype=torch.float32)
        return ref.embedding_bag_ref(table, ids, weights)
    if table.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag takes a float32 or bfloat16 table, "
                        f"got {table.dtype}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table (V, D) and ids (B, K) expected, got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if weights is not None and (weights.dtype != torch.float32
                                or weights.shape != ids.shape):
        raise ValueError(f"weights: {weights.dtype} "
                         f"{tuple(weights.shape)}, expected float32 "
                         f"{tuple(ids.shape)}")
    for t, name in ((table, "table"), (ids, "ids"), (weights, "weights")):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    (b, k), d = ids.shape, table.shape[1]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    err = _lib().embedding_bag(
        table.data_ptr(), _DTYPES[table.dtype], ids.data_ptr(),
        None if weights is None else weights.data_ptr(), b, k, d,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"embedding_bag failed with cudaError_t {err}")
    launches["embedding_bag"] += 1
    return out


def embedding_bag(table, ids, weights=None, mode: str = "sum"):
    """table (V, D), ids (B, K), optional weights (B, K) (0 = padding).
    mode ``sum``: (B, D) in the table's type; ``mean``: that sum divided
    by Σ_k weights[b, k] clamped at 1e-9 (by K without weights), which
    promotes a bf16 sum to float32, as in the reference."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', not {mode!r}")
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    if weights is not None and weights.dtype != torch.float32:
        weights = weights.to(torch.float32)
    out = _bag_sum(table, ids, weights)
    if mode == "mean":
        den = (weights.sum(1, keepdim=True) if weights is not None else
               torch.full((ids.shape[0], 1), float(ids.shape[1]),
                          device=ids.device))
        out = out / torch.clamp(den, min=1e-9)
    return out
