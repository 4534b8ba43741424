"""Front door of the embedding bag: ``embedding_bag(table, ids, weights,
mode)`` with the reference package's signature and modes.

The tensor's device decides the route: a CPU tensor goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written kernel in
``csrc/embedding_bag.cu`` (built with ``nvcc`` at first use); anything
else raises.  There is no fallback from the kernel to the plain version.
The wrapper checks its inputs, allocates the output, launches on the
current stream and adds one to ``launches["embedding_bag"]`` per kernel
call.  :func:`plan` decides how the kernel cuts the bags into blocks.

The sum carries a gradient (:class:`EmbeddingBagFn`) to the table and,
where they require one, to the weights: on the card through the
``embedding_bag_backward`` kernel (one count in
``launches["embedding_bag_backward"]`` a call; a stable ``torch.sort``
of the flat ids prepares it; :func:`backward_plan` cuts the gradient
into the tiles each block writes once), on the CPU through the plain
``ref.embedding_bag_backward_ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.embedding_bag import ref

launches = {"embedding_bag": 0, "embedding_bag_backward": 0}

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_int, _P, _P, ctypes.c_longlong,
             *[ctypes.c_int] * 8, _P, _P]
_BWD_ARGTYPES = [_P, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                 *[ctypes.c_int] * 4, _P, _P, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SMS = 132                  # the H100's SMs: at least 2 blocks an SM
THREADS = 256              # the most threads a block
SMEM_BUDGET = 48 * 1024    # a block's shared memory without opting in
MAX_COLS = 1024            # columns of the output a block
UNITS = 4 * THREADS        # row loads a block aims at where B allows
BWD_TILE = 8192            # float32 values of a backward tile
BWD_COLS = 256             # the most columns a backward tile
BWD_THREADS = 256          # the most threads a backward block (>= BWD_COLS)
BWD_STAGE = 2              # sorted entries a backward thread stages


class Plan(NamedTuple):
    """How the kernel cuts a call: ``g`` bags a block, slots in tiles of
    ``kt`` (``kt < K`` only with ``g == 1``), ``dt`` columns a block,
    ``vec`` elements a load, ``threads`` a block, ``smem`` bytes of
    dynamic shared memory."""
    g: int
    kt: int
    dt: int
    vec: int
    threads: int
    smem: int


def plan(b: int, k: int, d: int, size: int, weighted: bool,
         table_ptr: int) -> Plan:
    """The kernel's cut of a (B, K) call on a (V, D) table of ``size``-byte
    elements at address ``table_ptr``.  A load takes 16, 8 or 4 bytes of a
    row where D and the address allow.  Whole bags fit in shared memory
    (ids, weights and K·dt float32 values a bag) unless K·D is large; then
    one bag a block, in tiles of slots.  G is the least of what fits, what
    gives a block ~UNITS row loads, and B / (2 · SMS)."""
    vec = next((n for n in (16 // size, 8 // size, 4 // size)
                if n > 1 and d % n == 0 and table_ptr % (n * size) == 0), 1)
    dt = min(d, MAX_COLS)
    per_slot = 4 * (2 if weighted else 1) + 4 * dt
    if k * per_slot <= SMEM_BUDGET:
        kt = k
        g = max(1, min(SMEM_BUDGET // (k * per_slot),
                       -(-UNITS // (k * (dt // vec))), b // (2 * SMS), b))
        smem = g * k * per_slot
    else:
        g = 1
        kt = (SMEM_BUDGET - 4 * dt) // per_slot
        smem = kt * per_slot + 4 * dt
    work = g * max(kt * (dt // vec), dt)
    threads = min(THREADS, max(32, -(-work // 32) * 32))
    return Plan(g, kt, dt, vec, threads, smem)


class BackwardPlan(NamedTuple):
    """How the backward cuts the (V, D) table gradient: tiles of ``rows``
    rows (a multiple of 8, so a tile of all D columns starts 16 bytes on
    from the one before) and ``dt`` columns, blocks of ``threads`` (each
    writes four consecutive tiles and searches the sorted ids once) with
    ``smem`` bytes of shared memory: an (rows, dt) float32 tile and
    :data:`BWD_STAGE` sorted ids and slots a thread."""
    rows: int
    dt: int
    threads: int
    smem: int


def backward_plan(v: int, d: int, size: int) -> BackwardPlan:
    """The backward's cut of a (V, D) table gradient of ``size``-byte
    elements: at most :data:`BWD_COLS` columns and :data:`BWD_TILE`
    float32 values a tile (32 KB, with the stage 36 KB of shared memory),
    no more rows than V rounded up to 8.  Blocks of :data:`BWD_THREADS`
    threads, fewer where a small tile's 16-byte stores leave them idle,
    never fewer than the tile's columns (a thread sums one column of a
    run).  The sizes were picked by timing DeepFM's two calls on an
    H100."""
    if d < 1 or v < 0 or size not in (2, 4):
        raise ValueError(f"no backward plan for V={v}, D={d}, "
                         f"{size}-byte elements")
    dt = min(d, BWD_COLS)
    rows = min(BWD_TILE // dt // 8 * 8, max(8, -(-v // 8) * 8))
    stores = -(-rows * dt * size // 16)
    threads = min(BWD_THREADS, -(-max(dt, stores) // 32) * 32)
    return BackwardPlan(rows, dt, threads,
                        4 * rows * dt + 8 * BWD_STAGE * threads)


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
        lib.embedding_bag_backward.argtypes = _BWD_ARGTYPES
        lib.embedding_bag_backward.restype = ctypes.c_int
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
    cut = plan(b, k, d, table.element_size(), weights is not None,
               table.data_ptr())
    err = _lib().embedding_bag(
        table.data_ptr(), _DTYPES[table.dtype], ids.data_ptr(),
        None if weights is None else weights.data_ptr(), b, k, d, *cut,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"embedding_bag failed with cudaError_t {err}")
    launches["embedding_bag"] += 1
    return out


def embedding_bag_backward(table, ids, weights, grad_out,
                           need_table: bool = True,
                           need_weights: bool = False):
    """The gradient of the bag sum for ``grad_out`` (B, D): (grad_table
    (V, D) in the table's type, dense; grad_weights (B, K) float32), each
    None where not asked for.  The plain version on the CPU, else one
    ``embedding_bag_backward`` call (the same bits from call to call)."""
    if _route(table, ids, weights, grad_out) == "cpu":
        return ref.embedding_bag_backward_ref(table, ids, weights, grad_out,
                                              need_table, need_weights)
    grad_out = grad_out.to(table.dtype).contiguous()
    (b, k), d = ids.shape, table.shape[1]
    if grad_out.shape != (b, d):
        raise ValueError(f"grad_out {tuple(grad_out.shape)}, expected "
                         f"{(b, d)}")
    gt = gw = None
    sorted_ids = perm = None
    if need_table:
        gt = torch.empty_like(table)
        sorted_ids, perm = torch.sort(ids.reshape(-1), stable=True)
        perm = perm.to(torch.int32)
    if need_weights:
        gw = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    if gt is None and gw is None:
        return None, None
    err = _lib().embedding_bag_backward(
        table.data_ptr(), _DTYPES[table.dtype], ids.data_ptr(),
        None if sorted_ids is None else sorted_ids.data_ptr(),
        None if perm is None else perm.data_ptr(),
        None if weights is None else weights.data_ptr(), grad_out.data_ptr(),
        b, k, d, table.shape[0],
        *backward_plan(table.shape[0], d, table.element_size()),
        None if gt is None else gt.data_ptr(),
        None if gw is None else gw.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"embedding_bag_backward failed with "
                           f"cudaError_t {err}")
    launches["embedding_bag_backward"] += 1
    return gt, gw


class EmbeddingBagFn(torch.autograd.Function):
    """The bag sum with its gradient: forward :func:`_bag_sum`, backward
    :func:`embedding_bag_backward` (ids take no gradient)."""

    @staticmethod
    def forward(ctx, table, ids, weights):
        ctx.save_for_backward(table, ids, weights)
        return _bag_sum(table, ids, weights)

    @staticmethod
    def backward(ctx, grad_out):
        table, ids, weights = ctx.saved_tensors
        need_w = weights is not None and ctx.needs_input_grad[2]
        gt, gw = embedding_bag_backward(table, ids, weights, grad_out,
                                        ctx.needs_input_grad[0], need_w)
        return gt, None, gw


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
    if torch.is_grad_enabled() and (table.requires_grad or (
            weights is not None and weights.requires_grad)):
        out = EmbeddingBagFn.apply(table, ids, weights)
    else:
        out = _bag_sum(table, ids, weights)
    if mode == "mean":
        den = (weights.sum(1, keepdim=True) if weights is not None else
               torch.full((ids.shape[0], 1), float(ids.shape[1]),
                          device=ids.device))
        out = out / torch.clamp(den, min=1e-9)
    return out
