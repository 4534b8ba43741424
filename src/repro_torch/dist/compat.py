"""The one place where the port handles a torch.distributed process group.

* :func:`process_env` — this process's (rank, world size);
* :func:`or_all_reduce` — the bitwise-OR all-reduce of packed replica
  words that ends every SPMD round (*SyncVertexAllocations*);
* :func:`all_gather_rows` — the all-gather of one tensor per rank;
* :func:`all_to_all_rows` and :func:`all_reduce_sum` — the vertex-cut
  engine's mirror/master exchange and its loss sums, differentiable;
* :func:`all_gather_tiled` (backward: a reduce-scatter) and
  :func:`copy_to_group` (backward: an all-reduce) — the expert-parallel
  MoE's FSDP gather of expert weights and its entry into the experts;
* :func:`shard_tree` and :func:`gather_tree` — a rank's slices of full
  tensors by a spec tree (``dist.sharding.P`` leaves), and back;
* :func:`barrier`, :func:`all_processes_min`, :func:`all_processes_sum`
  and :func:`all_processes_any` — the host-side collectives of a
  multi-controller run (snapshot and artifact protocols, resume, the
  sharded finalize), each a no-op at world 1;
* :func:`world1` and :func:`spawn` — open a group: a world-1 group in this
  process, or ``world_size`` new processes, one rank each.

Groups initialise through a ``file://`` store in a fresh temporary
directory: no network, and no port that two runs could both claim.  The
backend is NCCL for ranks on a card and gloo for ranks on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.ne_round import ops as ne_ops
from repro_torch.kernels.ne_round import ref as ne_ref

SPAWN_TIMEOUT_S = 900.0
_CALL = "call.pkl"       # spawn's (fn, args), beside the group's store


def process_env() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(D, *x.shape): row d is rank d's ``x``.  One all-gather into a flat
    buffer, a layout that both gloo and NCCL take.  Newer torch releases
    rename ``all_gather_into_tensor`` to ``all_gather_single`` and keep
    the old name, which every release this runs on has."""
    d = dist.get_world_size(group)
    out = torch.empty((d * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view((d,) + tuple(x.shape))


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        # an all-to-all of equal chunks is its own transpose: chunk t of
        # my output came from rank t, so its gradient goes back to rank t
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None


def all_to_all_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(D·L, ...) rows, chunk t of them sent to rank t; returns the
    (D·L, ...) rows received, chunk s from rank s (``jax.lax.all_to_all``
    with ``tiled=True`` on the leading axis).  Differentiable: the
    backward is the reverse all-to-all."""
    return _AllToAllRows.apply(x.contiguous(), group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank (``jax.lax.psum``).

    Every rank goes on with the same total and differentiates its own
    copy, so the backward passes the gradient through to this rank's
    term: the gradient of a parameter that every rank holds is then the
    sum of the ranks' gradients (``all_reduce`` them after the backward),
    as for a replicated input of ``shard_map``."""
    return _AllReduceSum.apply(x, group)


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        rows = all_gather_rows(x.movedim(dim, 0), group)    # (D, n, ...)
        return rows.reshape((-1,) + tuple(rows.shape[2:])).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        d = dist.get_world_size(ctx.group)
        g = grad.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((g.shape[0] // d,) + tuple(g.shape[1:]),
                          dtype=g.dtype, device=g.device)
        if dist.get_backend(ctx.group) == "nccl":
            dist.reduce_scatter_tensor(out, g, group=ctx.group)
        else:   # gloo has no reduce-scatter: the sum, and this rank's tile
            dist.all_reduce(g, group=ctx.group)
            out.copy_(g[dist.get_rank(ctx.group) * out.shape[0]:][
                :out.shape[0]])
        return out.movedim(0, ctx.dim), None, None


def all_gather_tiled(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order
    (``jax.lax.all_gather(..., axis=dim, tiled=True)``).  Differentiable:
    the backward sums the gradient over the ranks and gives each rank its
    own tile (a reduce-scatter), the gradient of a tensor that every rank
    holds a tile of."""
    return _AllGatherTiled.apply(x, group, dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, entering a computation that each rank of ``group``
    does a part of on the same ``x`` (Megatron's *f*): the backward sums
    the ranks' partial gradients, so every rank gets the whole."""
    return _CopyToGroup.apply(x, group)


def _axes_cut(mesh, entry):
    from repro_torch.dist.context import axes_index, axes_size
    from repro_torch.dist.sharding import spec_axes

    axes = spec_axes(entry)
    return axes, axes_size(mesh, axes), axes_index(mesh, axes)


def shard_tree(tree, specs, mesh):
    """This rank's slices of the full tensors of ``tree``: dimension i
    of a leaf cut into the product of its spec entry's axis sizes, the
    rank taking the tile of its row-major coordinate over those axes (as
    a ``NamedSharding`` places it).  No collective."""
    from repro_torch.tree import tree_map

    def cut(x, spec):
        for dim, entry in enumerate(spec):
            _, n, i = _axes_cut(mesh, entry)
            if n > 1:
                if x.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of {tuple(x.shape)} "
                                     f"does not divide into {n}")
                step = x.shape[dim] // n
                x = x.narrow(dim, i * step, step)
        return x.contiguous()

    return tree_map(cut, tree, specs)


def gather_tree(tree, specs, mesh):
    """The inverse of :func:`shard_tree`: each leaf's full tensor on
    every rank (an all-gather for each cut dimension)."""
    from repro_torch.dist.context import axes_group
    from repro_torch.tree import tree_map

    def join(x, spec):
        with torch.no_grad():
            for dim in reversed(range(len(spec))):
                axes, n, _ = _axes_cut(mesh, spec[dim])
                if n > 1:
                    x = all_gather_tiled(x.contiguous(),
                                         axes_group(mesh, axes), dim)
        return x

    return tree_map(join, tree, specs)


def or_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Bitwise-OR all-reduce of int32 words across the ranks of ``group``.

    NCCL has no bitwise reduction, so neither backend uses one: at a
    power-of-two world, recursive doubling (log2 D exchanges with partner
    ``rank ^ step``, each moving only the packed words, each merged with
    ``ne_ops.or_words``); otherwise one all-gather and a fold with
    ``or_words``.  Both are exact, so the result is the same either way.
    At world 1 ``x`` itself is returned.
    """
    d = dist.get_world_size(group)
    if d == 1:
        return x
    if d & (d - 1) == 0:
        rank = dist.get_rank(group)
        base = group if group is not None else dist.group.WORLD
        step = 1
        while step < d:
            peer = dist.get_global_rank(base, rank ^ step)
            got = torch.empty_like(x)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, peer, group),
                    dist.P2POp(dist.irecv, got, peer, group)]):
                req.wait()
            x = ne_ops.or_words(x, got)
            step *= 2
        return x
    rows = all_gather_rows(x, group)
    out = rows[0]
    for i in range(1, d):
        out = ne_ops.or_words(out, rows[i])
    return out


def _world(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _host_device(group=None) -> torch.device:
    """Where a host value goes for a collective: the card for NCCL (it
    takes CUDA tensors only), the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str, group=None) -> None:
    """Cross-process sync point; a no-op at world 1.

    A collective, so it doubles as a liveness check: if a peer died, it
    fails instead of going on with a torn gang.  ``name`` says which
    sync point of the protocol this is; every rank passes the same names
    in the same order.
    """
    del name
    if _world(group) > 1:
        dist.barrier(group=group)


def _reduce_int(value: int, op, group) -> int:
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_host_device(group))
    dist.all_reduce(t, op, group=group)
    return int(t.item())


def all_processes_min(value: int, group=None) -> int:
    """Minimum of a host-side int over the ranks (itself at world 1).

    Resume uses it to agree on the newest snapshot round that every rank
    can read in full."""
    if _world(group) == 1:
        return int(value)
    return _reduce_int(value, dist.ReduceOp.MIN, group)


def all_processes_sum(value: int, group=None) -> int:
    """Sum of a host-side int over the ranks (itself at world 1): the
    sharded finalize's global leftover count from per-rank partials."""
    if _world(group) == 1:
        return int(value)
    return _reduce_int(value, dist.ReduceOp.SUM, group)


# bytes of packed words a chunk of all_processes_any sends: the OR
# all-reduce holds two such buffers, whatever the world size
_ANY_CHUNK_BYTES = 64 << 20


def all_processes_any(mask: np.ndarray, group=None) -> np.ndarray:
    """Element-wise OR of a host-side (N, P) bool map over the ranks
    (itself at world 1): the sharded finalize's replica-map combine.

    The map goes as packed words (``ne_ops.pack_bits``, 1/8 of the bool
    bytes) through :func:`or_all_reduce` (NCCL has no bitwise
    reduction), in chunks of ``_ANY_CHUNK_BYTES`` of words; every rank
    holds a map of the same shape, so all iterate the same boundaries and
    the chunks stay one valid sequence of collectives.
    """
    mask = np.asarray(mask, bool)
    if _world(group) == 1:
        return mask
    n, p = mask.shape
    dev = _host_device(group)
    rows = max(1, _ANY_CHUNK_BYTES // (4 * ne_ref.replica_words(p)))
    out = np.empty_like(mask)
    for s in range(0, n, rows):
        words = ne_ops.pack_bits(torch.from_numpy(
            np.ascontiguousarray(mask[s:s + rows])).to(dev))
        words = or_all_reduce(words, group)
        out[s:s + rows] = ne_ops.unpack_bits(words, p).cpu().numpy()
    return out


def init_group(backend: str, rank: int, world_size: int,
               store_dir: str) -> None:
    """Join rank ``rank`` of a ``world_size`` group whose ``file://``
    store lives in ``store_dir`` (fresh for each group); an NCCL rank
    takes the card ``rank % count``."""
    kw = {}
    if backend == "nccl":
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(backend, init_method=f"file://{store_dir}/store",
                            world_size=world_size, rank=rank, **kw)


@contextlib.contextmanager
def world1(backend: str):
    """A world-1 group in this process for the ``with`` block, then gone."""
    with tempfile.TemporaryDirectory() as store_dir:
        init_group(backend, 0, 1, store_dir)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank, world_size, backend, store_dir, results):
    # the ranks share the host's cores; torch's default of one intra-op
    # thread per core in every rank oversubscribes them many times over
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        with open(os.path.join(store_dir, _CALL), "rb") as f:
            fn, args = pickle.load(f)
        init_group(backend, rank, world_size, store_dir)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except Exception:
        results.put((rank, traceback.format_exc(), None))


def spawn(fn, world_size: int, backend: str, *args) -> list:
    """Run ``fn(*args)`` in ``world_size`` new processes, each a rank of
    one group (``process_env`` gives its rank); returns their return
    values in rank order.  ``fn``, ``args`` and the values are pickled.

    Raises if a rank fails (with every failed rank's traceback: a rank
    that fails first makes its peers' collectives fail too), if a rank
    dies, or after ``SPAWN_TIMEOUT_S``; the ranks still running are then
    terminated.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    errors: dict = {}
    with tempfile.TemporaryDirectory() as store_dir:
        # the call goes through a file: a large one pickled into each
        # Process would hold up every start until that child had imported
        # torch and read it, one child after the other
        with open(os.path.join(store_dir, _CALL), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, store_dir,
                                   results), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + SPAWN_TIMEOUT_S
            while len(out) + len(errors) < world_size:
                try:
                    rank, err, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    if errors:
                        break         # the rest are stuck or gone
                    _check_ranks(procs, out, deadline)
                    continue
                if err is None:
                    out[rank] = value
                else:
                    errors[rank] = err
            if errors:
                raise RuntimeError("\n".join(
                    f"rank {r} failed:\n{e}"
                    for r, e in sorted(errors.items())))
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
    return [out[r] for r in range(world_size)]


def _check_ranks(procs, done: dict, deadline: float) -> None:
    """Raise if a rank that has not reported died, or time ran out."""
    for r, p in enumerate(procs):
        if r not in done and p.exitcode not in (None, 0):
            raise RuntimeError(f"rank {r} died with exit code {p.exitcode}")
    if time.monotonic() > deadline:
        raise TimeoutError(f"ranks did not finish in {SPAWN_TIMEOUT_S} s")
