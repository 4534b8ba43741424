"""Front door of the block-sparse SpMM: the host block-CSR builder, the
kernel wrapper ``block_spmm`` (differentiable in ``x``) and
``aggregate_neighbors``, with the reference package's signatures.

The tensor's device decides the route: a CPU tensor goes to the plain
version in ``ref.py``; a CUDA tensor goes to a hand-written kernel in
``csrc/block_spmm.cu`` (built with ``nvcc`` at first use); anything else
raises.  There is no fallback from the kernel to the plain version.  On
the card, :func:`design` picks one of the source's two kernels by shape:
``"tc"`` (split-TF32 tensor cores, slots split over blocks and summed in
a fixed order) or ``"fma"`` (FP32 CUDA cores).  The wrapper checks its
inputs, allocates the output (and the tensor-core kernel's workspace of
partial sums), launches on the current stream and adds one to
``launches["block_spmm"]`` per kernel call (the tensor-core kernel's
second launch, which sums the partials, is part of that call).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.block_spmm import ref

launches = {"block_spmm": 0}

_P = ctypes.c_void_p
_I, _L = ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "block_spmm_fma": [_P, _P, _P, _L, _I, _I, _I, _L, _I, _P, _P],
    "block_spmm_tc": [_P, _P, _P, _L, _I, _I, _I, _L, _I, _I, _I, _P, _P,
                      _P],
}
TC_ROWS = 128                  # rows of the tensor-core kernel's block
MAX_SPLITS = 64                # slot ranges of one row tile, at most


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    """The built library, its argument types set (built at first use)."""
    from repro_torch.kernels import build

    lib = build.load("block_spmm")
    if lib.block_spmm_tc.argtypes is None:
        for fn, argtypes in _ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def design(bm: int, bn: int) -> str:
    """The card's kernel for (bm, bn) blocks: ``"tc"``, the split-TF32
    tensor-core kernel, for bm >= 64 a multiple of 16 and bn a multiple of
    32 (the GNN path's 128 x 128); ``"fma"``, the FP32 CUDA-core kernel,
    for the rest (16 x 16, 32 x 32 and ragged blocks)."""
    return "tc" if bm >= 64 and bm % 16 == 0 and bn % 32 == 0 else "fma"


def tc_cols(f: int) -> int:
    """Columns of F a tensor-core block covers: 64 (4 warps, two blocks an
    SM) for F <= 64, else 128 (8 warps, one block an SM: half the re-reads
    of A at F = 1,433)."""
    return 64 if f <= 64 else 128


def tc_slots_per_split(r: int, nb: int, bm: int, f: int, sms: int) -> int:
    """Slots per block of the tensor-core kernel: all NB when the (row
    tile, 128 rows, ``tc_cols(f)`` columns of F) blocks fill the SMs on
    their own (two blocks an SM at 64 columns, one at 128), else the slots
    split into enough ranges to do so (at most ``MAX_SPLITS``), each range
    a block whose partial sums a second launch adds in range order.  The
    split depends on the shape and the card only, so the same inputs give
    the same bits."""
    cols = tc_cols(f)
    units = r * -(-bm // TC_ROWS) * -(-f // cols)
    per_sm = 2 if cols == 64 else 1
    splits = min(max(-(-per_sm * sms // units), 1), nb, MAX_SPLITS)
    return -(-nb // splits)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class BlockCSR(tuple):
    """``build_block_csr``'s (cols, blocks, n_pad), with ``symmetric``:
    whether A equals A^T, which the gradient of :func:`block_spmm` needs
    (it takes A^T as A's own block-CSR)."""

    symmetric: bool

    def __new__(cls, cols, blocks, n_pad, symmetric: bool):
        self = super().__new__(cls, (cols, blocks, n_pad))
        self.symmetric = bool(symmetric)
        return self


def build_block_csr(edges: np.ndarray, num_nodes: int, bm: int = 128,
                    bn: int = 128, directed_both: bool = True) -> BlockCSR:
    """Host-side: edge list → block-CSR (cols, blocks) with padding.

    Returns (cols (R, NB) int32, blocks (R, NB, bm, bn) f32, n_pad), with
    out[v] = Σ_{(u,v)∈E} x[u] (sum aggregation; both directions of each
    edge when ``directed_both``).  Row tile i lists its nonzero column
    blocks in increasing order; NB is the most any row tile has (at least
    1); the other slots are padding, column block 0 with a zero block.
    An entry counts its edge's copies, self loops included.  The result's
    ``symmetric`` is True for ``directed_both`` (by construction) and
    otherwise says whether every (u, v) is listed as often as (v, u).
    """
    e = np.asarray(edges)
    if directed_both:
        src = np.concatenate([e[:, 0], e[:, 1]])
        dst = np.concatenate([e[:, 1], e[:, 0]])
    else:
        src, dst = e[:, 0], e[:, 1]
    n_pad = -(-num_nodes // max(bm, bn)) * max(bm, bn)
    symmetric = directed_both or np.array_equal(
        np.sort(dst.astype(np.int64) * n_pad + src),
        np.sort(src.astype(np.int64) * n_pad + dst))
    r, c = n_pad // bm, n_pad // bn
    key = (dst // bm).astype(np.int64) * c + src // bn   # the edge's tile
    uniq, inv = np.unique(key, return_inverse=True)
    row_of = uniq // c
    # a tile's slot: its rank among the sorted nonzero tiles of its row
    slot = np.arange(uniq.size) - np.searchsorted(row_of, row_of)
    nb = int(slot.max()) + 1 if slot.size else 1
    cols = np.zeros((r, nb), np.int32)
    cols[row_of, slot] = uniq % c
    blocks = np.zeros((r, nb, bm, bn), np.float32)
    np.add.at(blocks, (row_of[inv], slot[inv], dst % bm, src % bn), 1.0)
    return BlockCSR(cols, blocks, n_pad, symmetric)


def _route(*tensors) -> str:
    """'cpu' or 'cuda' from the tensors' common device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no block_spmm kernel for device {dev}")
    return dev.type


def _spmm(cols, blocks, x):
    """One product A @ x: the plain version on the CPU, else one launch."""
    if _route(cols, blocks, x) == "cpu":
        return ref.block_spmm_ref(cols, blocks, x)
    r, nb, bm, bn = blocks.shape
    n, f = x.shape
    if blocks.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"block_spmm takes float32 blocks and x, got "
                        f"{blocks.dtype} and {x.dtype}")
    if cols.dtype != torch.int32 or tuple(cols.shape) != (r, nb):
        raise ValueError(f"cols: {cols.dtype} {tuple(cols.shape)}, expected "
                         f"int32 {(r, nb)}")
    if n % bn:
        raise ValueError(f"x has {n} rows, not a multiple of bn={bn}")
    if -(-bm // 16) > 65535 or -(-f // 64) > 65535:
        raise ValueError(f"bm={bm} or F={f} too large for the launch grid")
    for t, name in ((cols, "cols"), (blocks, "blocks"), (x, "x")):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((r * bm, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or nb == 0:
        return out.zero_()
    stream = torch.cuda.current_stream().cuda_stream
    if design(bm, bn) == "tc" and blocks.data_ptr() % 16 == 0:
        per = tc_slots_per_split(r, nb, bm, f, _sm_count(x.device.index))
        splits = -(-nb // per)
        part = (torch.empty((splits, r * bm, f), dtype=x.dtype,
                            device=x.device) if splits > 1 else None)
        ldx = -(-f // 4) * 4
        if ldx != f or x.data_ptr() % 16:
            # the kernel copies x 16 bytes at a time: rows of a multiple of
            # 4 floats, 16-byte aligned (F = 1,433: a 16 MB copy); the pad
            # columns only reach output columns that are not written
            xp = torch.empty((n, ldx), dtype=x.dtype, device=x.device)
            xp[:, :f].copy_(x)
            x = xp
        err = _lib().block_spmm_tc(
            cols.data_ptr(), blocks.data_ptr(), x.data_ptr(), r, nb, bm, bn,
            n, f, ldx, per, 0 if part is None else part.data_ptr(),
            out.data_ptr(), stream)
    else:
        err = _lib().block_spmm_fma(cols.data_ptr(), blocks.data_ptr(),
                                    x.data_ptr(), r, nb, bm, bn, n, f,
                                    out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"block_spmm failed with cudaError_t {err}")
    launches["block_spmm"] += 1
    return out


class BlockSpmm(torch.autograd.Function):
    """out = A @ x for a symmetric A, whose gradient in x, A^T @ grad, is
    the same kernel on the same (cols, blocks).  ``cols`` and ``blocks``
    take no gradient."""

    @staticmethod
    def forward(ctx, cols, blocks, x, symmetric):
        ctx.save_for_backward(cols, blocks)
        ctx.symmetric = symmetric
        return _spmm(cols, blocks, x)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[2]:
            return None, None, None, None
        cols, blocks = ctx.saved_tensors
        bm, bn = blocks.shape[2:]
        if bm != bn:
            raise ValueError(f"the gradient of block_spmm takes A^T as A's "
                             f"own block-CSR, which needs bm == bn, not "
                             f"{bm} x {bn}")
        if not ctx.symmetric:
            raise ValueError("the gradient of block_spmm takes A^T as A's "
                             "own block-CSR, which needs a symmetric A: "
                             "pass build_block_csr(...).symmetric")
        return None, None, _spmm(cols, blocks, grad.contiguous()), None


def block_spmm(cols, blocks, x, symmetric: bool = False):
    """out = A @ x for block-CSR A (``build_block_csr``'s cols and blocks
    as tensors); x is (C·bn, F), out (R·bm, F).  The gradient in x runs the
    kernel on A^T taken as A itself, so it needs bm == bn and
    ``symmetric`` (``build_block_csr``'s record, True for
    ``directed_both=True``); the backward raises otherwise."""
    return BlockSpmm.apply(cols, blocks, x, symmetric)


def aggregate_neighbors(edges: np.ndarray, x: torch.Tensor, num_nodes: int,
                        bm: int = 128, bn: int = 128) -> torch.Tensor:
    """Sum-aggregate neighbor features (both directions of each edge) with
    the block-sparse kernel: a host block build (one-off per graph), then
    one kernel call on ``x``'s device."""
    csr = build_block_csr(edges, num_nodes, bm, bn)
    cols, blocks, n_pad = csr
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_pad - x.shape[0]))
    out = block_spmm(torch.from_numpy(cols).to(x.device),
                     torch.from_numpy(blocks).to(x.device), xp,
                     csr.symmetric)
    return out[:num_nodes]
