"""Multi-host ingestion: canonical EdgeFile block ranges → SPMD edge shards.

The paper's 256-machine runs never materialize the full edge list anywhere:
each machine reads a slice of the store and hashes its edges to owning
allocation processes.  This module reproduces that shape on top of the
``repro_torch.io`` store:

* :func:`host_block_ranges` cuts the canonical EdgeFile's block index into
  ``num_hosts`` contiguous ranges balanced by edge count — a pure function
  of the manifest (the block index), so every host computes the same plan
  with no coordination;
* :func:`ingest_host_range` is the per-host unit of work: stream only your
  block range (``EdgeFile.iter_blocks(start, stop)``), 2D-hash each edge to
  its owning device, return per-device rows — peak memory O(range), never
  O(M);
* :func:`ingest_edgefile` assembles the per-range results into the padded
  (D, C, 2) shard layout the runtime driver consumes.  This assembly is
  *single-controller*: the calling process ends up holding the full shard
  layout (each rank of the driver keeps its own row).  With ``processes=True`` each range is read and hashed
  in its own worker process — the honest local rehearsal of the per-host
  memory envelope, where no *reader* ever holds more than its range.

A multi-controller deployment (one process per host) calls
:func:`my_block_range` — which uses the rank and world size of the
initialised ``torch.distributed`` group to pick this process's slice of
the shared plan — and :func:`ingest_host_range` on it; driving the SPMD
round state machine that way is a later ROADMAP item, not something this
module does by itself.  A copy of the reference package's
``runtime/cluster.py``.

Because hosts own *contiguous* ranges processed in host order, the
assembled shards are bit-identical to the single-host
``repro_torch.io.stream.shard_edges_stream`` (asserted by
tests/test_torch_runtime.py) — range-based ingestion changes where bytes flow, not what the partitioner
sees.
"""
from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from repro_torch.io.csr import grid_assign_host
from repro_torch.io.edgefile import EdgeFile


def process_info() -> tuple[int, int]:
    """(rank, world size) of an initialised ``torch.distributed`` group;
    (0, 1) otherwise.

    Import is lazy so the ingestion plan stays usable without torch (the
    spawn workers of :func:`ingest_edgefile` never load it); the probe
    itself is the single definition in
    ``repro_torch.dist.compat.process_env``.
    """
    try:
        from repro_torch.dist.compat import process_env
    except ImportError:          # no torch installed at all
        return 0, 1
    return process_env()


def host_block_ranges(ef: EdgeFile, num_hosts: int) -> list[tuple[int, int]]:
    """Contiguous block ranges ``[(start, stop), ...]``, one per host,
    balanced by edge count via the block index (no data reads).

    Every host gets a range (possibly empty); ranges tile ``[0,
    num_blocks)`` in order, which is what keeps multi-host assembly
    bit-identical to the sequential pass.
    """
    if num_hosts < 1:
        raise ValueError("num_hosts must be >= 1")
    counts = np.asarray(ef.block_counts, np.int64)
    total = int(counts.sum())
    bounds = [0]
    cum = np.concatenate([[0], np.cumsum(counts)])
    for h in range(1, num_hosts):
        target = total * h // num_hosts
        cut = int(np.searchsorted(cum, target, side="left"))
        bounds.append(min(max(cut, bounds[-1]), ef.num_blocks))
    bounds.append(ef.num_blocks)
    return [(bounds[h], bounds[h + 1]) for h in range(num_hosts)]


def my_block_range(ef: EdgeFile, num_hosts: int | None = None,
                   ) -> tuple[int, int]:
    """This process's range under the shared plan (process-group aware)."""
    idx, count = process_info()
    hosts = num_hosts or count
    if idx >= hosts:
        raise ValueError(f"process index {idx} has no range in a "
                         f"{hosts}-host plan — num_hosts must be >= "
                         f"the world size ({count})")
    return host_block_ranges(ef, hosts)[idx]


def ingest_host_range(path: str | os.PathLike, start: int, stop: int,
                      num_devices: int, salt: int = 0,
                      ) -> tuple[list[np.ndarray], np.ndarray]:
    """One host's ingestion: stream blocks ``[start, stop)`` of the
    EdgeFile at ``path``, hash every edge to its owning device.

    Returns ``(rows, dev)``: ``rows[d]`` is the (k_d, 2) int32 edges this
    range contributes to device ``d`` (file order preserved) and ``dev``
    the (range_edges,) int32 per-edge device assignment.  Opens its own
    file handle so it is safe to run in a worker process.
    """
    with EdgeFile(path) as ef:
        parts: list[list[np.ndarray]] = [[] for _ in range(num_devices)]
        devs = []
        for blk in ef.iter_blocks(start, stop):
            dev = grid_assign_host(blk, num_devices, salt=salt)
            devs.append(dev)
            present = np.flatnonzero(np.bincount(dev, minlength=num_devices))
            if len(present) == 1:        # the whole block to one device
                parts[present[0]].append(np.array(blk, dtype=np.int32))
                continue
            for d in present:
                parts[d].append(np.ascontiguousarray(blk[dev == d],
                                                     dtype=np.int32))
    rows = [np.concatenate(p) if p else np.zeros((0, 2), np.int32)
            for p in parts]
    dev = (np.concatenate(devs).astype(np.int32) if devs
           else np.zeros((0,), np.int32))
    return rows, dev


def range_flat_edges(rows: list[np.ndarray], dev: np.ndarray) -> np.ndarray:
    """Reassemble a range's flat (k, 2) edge list from its per-device rows.

    ``rows[d]`` holds the range's device-``d`` edges in file order, so a
    scatter by assignment position restores the original order — the
    load-bearing trick that keeps every ingestion path bit-identical to
    the sequential ``shard_edges_stream`` pass.
    """
    flat = np.empty((dev.shape[0], 2), np.int32)
    for d, r in enumerate(rows):
        if r.shape[0] == dev.shape[0]:      # every edge on device d
            flat[:] = r
        elif r.shape[0]:
            flat[np.flatnonzero(dev == d)] = r
    return flat


def _ingest_worker(args):
    return ingest_host_range(*args)


def ingest_edgefile(ef: EdgeFile, num_devices: int,
                    num_hosts: int | None = None, salt: int = 0,
                    processes: bool = False, with_edges: bool = False):
    """Range-planned ingestion into the padded shard layout
    (single-controller assembly — the caller holds the full result).

    Same return contract as ``repro_torch.io.stream.shard_edges_stream``:
    ``(shards (D, C, 2), masks (D, C), cap, dev (M,))`` plus the flat edge
    list when ``with_edges`` — and bit-identical output, because host
    ranges are contiguous and assembled in host order.

    ``num_hosts`` defaults to the process group's world size (1 locally)
    so the plan matches a co-running multi-process job.  With
    ``processes=True``
    each host range is read and hashed in its own worker process, so no
    reader holds more than its range.
    """
    if num_hosts is None:
        num_hosts = max(process_info()[1], 1)
    m = int(ef.num_edges)
    if int(ef.num_vertices) > (1 << 31):
        raise ValueError("shard arrays are int32 — vertex ids >= 2^31 "
                         "would wrap silently")
    ranges = host_block_ranges(ef, num_hosts)
    jobs = [(ef.path, start, stop, num_devices, salt)
            for start, stop in ranges]
    if processes and num_hosts > 1:
        # spawn, not fork: the caller usually has torch (and its threads)
        # loaded, and forking a multithreaded process can deadlock.  The
        # workers themselves load numpy only (grid_assign_host).
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(num_hosts,
                                                 os.cpu_count() or 1),
                                 mp_context=ctx) as ex:
            results = list(ex.map(_ingest_worker, jobs))
    else:
        results = [ingest_host_range(*j) for j in jobs]

    counts = np.zeros(num_devices, np.int64)
    for rows, _ in results:
        for d in range(num_devices):
            counts[d] += rows[d].shape[0]
    cap = int(counts.max()) if m else 1
    shards = np.zeros((num_devices, cap, 2), np.int32)
    masks = np.zeros((num_devices, cap), bool)
    dev_full = np.empty(m, np.int32)
    edges = np.empty((m, 2), np.int32) if with_edges else None
    cursors = np.zeros(num_devices, np.int64)
    off = 0
    for (rows, dev), (start, stop) in zip(results, ranges):
        k = dev.shape[0]
        dev_full[off:off + k] = dev
        if with_edges and k:
            edges[off:off + k] = range_flat_edges(rows, dev)
        off += k
        for d in range(num_devices):
            c = int(cursors[d])
            shards[d, c:c + rows[d].shape[0]] = rows[d]
            masks[d, c:c + rows[d].shape[0]] = True
            cursors[d] += rows[d].shape[0]
    if with_edges:
        return shards, masks, cap, dev_full, edges
    return shards, masks, cap, dev_full


# ---------------------------------------------------------------------------
# exchange-dir ingestion (true multi-controller, one process per host)
# ---------------------------------------------------------------------------
#
# With one process per host no process may hold the full shard layout,
# but edges from host h's block range hash to *every* device, including ones
# owned by other processes.  The exchange realizes the paper's
# read-your-slice → shuffle-to-owners step through the shared store instead
# of an in-memory all_to_all: host h streams only its range and spills one
# raw file per destination device; after a barrier, host h assembles only
# the shards of devices it owns by concatenating every host's contribution
# *in host order* — which, because ranges tile the block index in order, is
# bit-identical to the single-controller ``shard_edges_stream`` layout.
# Peak memory per process: O(own range) during write, O(owned shards)
# during assembly — never O(M).

def _write_raw(path: str, arr: np.ndarray) -> None:
    """Write raw bytes + fsync: the barrier publishes completeness, the
    fsync makes sure completeness means bytes-on-disk."""
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(arr).tobytes())
        f.flush()
        os.fsync(f.fileno())


def _read_raw(path: str, dtype, shape) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype).reshape(shape)


def exchange_write_range(exchange_dir: str | os.PathLike,
                         ef_path: str | os.PathLike, host: int,
                         num_hosts: int, num_devices: int,
                         salt: int = 0) -> np.ndarray:
    """Stage 1 of multi-controller ingestion: stream *only this host's*
    block range, hash each edge to its owning device, and spill per-device
    row files plus the range's flat edges / device assignment / partial
    degree into ``exchange_dir``.  Returns this range's per-device counts.

    Idempotent: a resumed run rewrites the same deterministic bytes.
    """
    exchange_dir = os.fspath(exchange_dir)
    os.makedirs(exchange_dir, exist_ok=True)
    with EdgeFile(ef_path) as ef:
        n = int(ef.num_vertices)
        if n > (1 << 31):
            raise ValueError("shard arrays are int32 — vertex ids >= 2^31 "
                             "would wrap silently")
        start, stop = host_block_ranges(ef, num_hosts)[host]
    rows, dev = ingest_host_range(ef_path, start, stop, num_devices, salt)
    k = int(dev.shape[0])
    for d in range(num_devices):
        _write_raw(os.path.join(exchange_dir, f"h{host:03d}_d{d:03d}.rows"),
                   rows[d])
    flat = range_flat_edges(rows, dev)
    deg = np.zeros(n, np.int64)
    np.add.at(deg, flat[:, 0], 1)
    np.add.at(deg, flat[:, 1], 1)
    _write_raw(os.path.join(exchange_dir, f"h{host:03d}.edges"), flat)
    _write_raw(os.path.join(exchange_dir, f"h{host:03d}.dev"), dev)
    _write_raw(os.path.join(exchange_dir, f"h{host:03d}.deg"), deg)
    counts = np.array([r.shape[0] for r in rows], np.int64)
    marker = os.path.join(exchange_dir, f"h{host:03d}.json")
    with open(marker, "w") as f:
        f.write(json.dumps({"host": host, "edges": k, "num_vertices": n,
                            "counts": counts.tolist()}))
        f.flush()
        os.fsync(f.fileno())
    return counts


def exchange_counts(exchange_dir: str | os.PathLike,
                    num_hosts: int) -> np.ndarray:
    """(H, D) per-host per-device contribution counts from the markers."""
    exchange_dir = os.fspath(exchange_dir)
    out = []
    for h in range(num_hosts):
        with open(os.path.join(exchange_dir, f"h{h:03d}.json")) as f:
            out.append(json.loads(f.read())["counts"])
    return np.asarray(out, np.int64)


def exchange_assemble(exchange_dir: str | os.PathLike, num_hosts: int,
                      num_devices: int, owned: list[int],
                      ) -> tuple[dict, dict, int, np.ndarray]:
    """Stage 2 (after the cross-process barrier): assemble only the shards
    of the ``owned`` devices from every host's spilled contributions, in
    host order.  Returns ``(shards, masks, cap, degree)`` where
    ``shards[d]`` is the padded (cap, 2) int32 shard of owned device ``d``,
    ``masks[d]`` its validity mask, ``cap`` the *global* shard capacity
    (max total per-device count — identical to ``shard_edges_stream``), and
    ``degree`` the global (N,) int64 degree (sum of per-host partials).
    """
    exchange_dir = os.fspath(exchange_dir)
    per_host = exchange_counts(exchange_dir, num_hosts)        # (H, D)
    totals = per_host.sum(axis=0)                              # (D,)
    cap = int(totals.max()) if int(totals.sum()) else 1
    shards: dict[int, np.ndarray] = {}
    masks: dict[int, np.ndarray] = {}
    for d in owned:
        shard = np.zeros((cap, 2), np.int32)
        mask = np.zeros((cap,), bool)
        c = 0
        for h in range(num_hosts):
            kh = int(per_host[h, d])
            shard[c:c + kh] = _read_raw(
                os.path.join(exchange_dir, f"h{h:03d}_d{d:03d}.rows"),
                np.int32, (kh, 2))
            mask[c:c + kh] = True
            c += kh
        shards[d] = shard
        masks[d] = mask
    with open(os.path.join(exchange_dir, "h000.json")) as f:
        n = json.loads(f.read())["num_vertices"]
    degree = np.zeros(n, np.int64)
    for h in range(num_hosts):
        degree += _read_raw(os.path.join(exchange_dir, f"h{h:03d}.deg"),
                            np.int64, (n,))
    return shards, masks, cap, degree


def exchange_read_global(exchange_dir: str | os.PathLike, num_hosts: int,
                         ) -> tuple[np.ndarray, np.ndarray]:
    """The flat (M, 2) edge list + (M,) per-edge device assignment, in file
    order (host ranges concatenated in host order).  Only the finalize
    epilogue calls this — the round loop never holds O(M) state."""
    exchange_dir = os.fspath(exchange_dir)
    per_host = exchange_counts(exchange_dir, num_hosts)
    edges, dev = [], []
    for h in range(num_hosts):
        kh = int(per_host[h].sum())
        edges.append(_read_raw(os.path.join(exchange_dir, f"h{h:03d}.edges"),
                               np.int32, (kh, 2)))
        dev.append(_read_raw(os.path.join(exchange_dir, f"h{h:03d}.dev"),
                             np.int32, (kh,)))
    return (np.concatenate(edges) if edges else np.zeros((0, 2), np.int32),
            np.concatenate(dev) if dev else np.zeros((0,), np.int32))


def shard_eids(exchange_dir: str | os.PathLike, num_hosts: int,
               devices: list,
               ) -> dict[int, np.ndarray]:
    """Global edge ids of each requested device's shard, in slot order.

    Because host ranges tile the block index in order, shard ``d`` holds
    the file-order subsequence of edges hashing to ``d`` — so its slot
    ``k`` is the ``k``-th such edge.  Streams one host's ``.dev`` spill
    at a time: peak memory O(max range + requested shards), never O(M).
    The sharded finalize epilogue maps its owned slices back to edge
    identity with this instead of ``exchange_read_global``.
    """
    exchange_dir = os.fspath(exchange_dir)
    per_host = exchange_counts(exchange_dir, num_hosts)
    out: dict[int, list] = {d: [] for d in devices}
    off = 0
    for h in range(num_hosts):
        kh = int(per_host[h].sum())
        dev = _read_raw(os.path.join(exchange_dir, f"h{h:03d}.dev"),
                        np.int32, (kh,))
        for d in devices:
            out[d].append(np.flatnonzero(dev == d).astype(np.int64) + off)
        off += kh
    return {d: (np.concatenate(c) if c else np.zeros((0,), np.int64))
            for d, c in out.items()}


# ---------------------------------------------------------------------------
# elastic resume: reshard edge_part slices onto a different device count
# ---------------------------------------------------------------------------
#
# A snapshot stores edge_part as one slice per *device* of the run that
# took it.  Restoring onto the same global device count only moves slice
# ownership between processes (the shard layout is a pure function of the
# 2D hash), but a different device count re-hashes every edge to a new
# shard — the slices must be resharded.  Like ingestion, this runs as a
# store-backed exchange so no process ever holds the global assignment:
#
#   every host:  reshard_write    — stream the exchange ranges in file
#                                   order, recompute the OLD device of
#                                   every edge (grid_assign_host is
#                                   deterministic), walk a cursor through
#                                   the old slices this host was assigned
#                                   (old shard i → host i % H), and spill
#                                   (eid, value) pairs per NEW device.
#   <barrier>                       all pairs durably staged
#   every host:  reshard_assemble — for each owned new device, merge all
#                                   hosts' pairs by eid; ascending eid IS
#                                   slot order, so the values drop into
#                                   the new padded slice directly.
#
# Peak memory per process: O(m/H) during write, O(owned shards) during
# assembly.  Per-eid values are preserved exactly, so resuming on the
# same device count remains bit-identical and a fixed-point snapshot
# reshards to the identical final assignment.

def reshard_write(spill_dir: str | os.PathLike,
                  exchange_dir: str | os.PathLike, num_hosts: int,
                  old_slices: dict, d_old: int, d_new: int, host: int,
                  salt: int = 0) -> None:
    """Stage this host's share of an elastic reshard (see above).

    ``old_slices[i]`` is the (cap_old,) assignment slice of *old* shard
    ``i`` for each old shard assigned to this host (``i % num_hosts ==
    host``) — the slices ``RunSnapshot.restore_state_multihost`` hands
    back on a device-count mismatch.
    """
    spill_dir = os.fspath(spill_dir)
    os.makedirs(spill_dir, exist_ok=True)
    per_host = exchange_counts(exchange_dir, num_hosts)
    mine = sorted(old_slices)
    cursors = {i: 0 for i in mine}
    acc: dict[int, list] = {d: [] for d in range(d_new)}
    off = 0
    for h in range(num_hosts):
        kh = int(per_host[h].sum())
        flat = _read_raw(os.path.join(os.fspath(exchange_dir),
                                      f"h{h:03d}.edges"), np.int32, (kh, 2))
        dev_new = _read_raw(os.path.join(os.fspath(exchange_dir),
                                         f"h{h:03d}.dev"), np.int32, (kh,))
        dev_old = grid_assign_host(flat, d_old, salt=salt)
        for i in mine:
            sel = np.flatnonzero(dev_old == i)
            k = sel.size
            vals = np.asarray(old_slices[i])[cursors[i]:cursors[i] + k]
            cursors[i] += k
            dn = dev_new[sel]
            eids = sel.astype(np.int64) + off
            for d in np.unique(dn):
                pick = dn == d
                pair = np.empty((int(pick.sum()), 2), np.int64)
                pair[:, 0] = eids[pick]
                pair[:, 1] = vals[pick]
                acc[int(d)].append(pair)
        off += kh
    for d in range(d_new):
        arr = (np.concatenate(acc[d]) if acc[d]
               else np.zeros((0, 2), np.int64))
        _write_raw(os.path.join(spill_dir, f"h{host:03d}_d{d:03d}.pairs"),
                   arr)


def reshard_assemble(spill_dir: str | os.PathLike, num_hosts: int,
                     owned_new: list, cap_new: int) -> dict:
    """Assemble the owned *new* slices from every host's staged pairs
    (after the cross-process barrier).  Unfilled tail slots stay -1,
    matching the padded shard convention."""
    spill_dir = os.fspath(spill_dir)
    out: dict[int, np.ndarray] = {}
    for d in owned_new:
        chunks = []
        for h in range(num_hosts):
            path = os.path.join(spill_dir, f"h{h:03d}_d{d:03d}.pairs")
            chunks.append(_read_raw(path, np.int64,
                                    (os.path.getsize(path) // 16, 2)))
        pairs = (np.concatenate(chunks) if chunks
                 else np.zeros((0, 2), np.int64))
        order = np.argsort(pairs[:, 0], kind="stable")
        sl = np.full((cap_new,), -1, np.int32)
        sl[: pairs.shape[0]] = pairs[order, 1].astype(np.int32)
        out[d] = sl
    return out


__all__ = ["exchange_assemble", "exchange_counts", "exchange_read_global",
           "exchange_write_range", "host_block_ranges", "ingest_edgefile",
           "ingest_host_range", "my_block_range", "process_info",
           "range_flat_edges", "reshard_assemble", "reshard_write",
           "shard_eids"]
