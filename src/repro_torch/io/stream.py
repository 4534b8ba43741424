"""Out-of-core edge pipeline: chunked canonicalization + streaming CSR build.

External-sort style, bounded peak RSS:

* :func:`canonicalize_stream` — dedup/canonicalize an arbitrary edge source
  (raw :class:`EdgeFile`, ndarray, or chunk iterator) without ever holding
  the full edge list: per-chunk ``np.unique`` runs are spilled to disk as
  sorted int64 ``u*n + v`` keys, then k-way merged with global dedup into a
  canonical :class:`EdgeFile`.  The result is byte-for-byte the edge order
  of ``core.graph.canonicalize_edges``.

* :func:`csr_slot_stream` — emit the CSR directed slots of a canonical
  EdgeFile in final order, in chunks.  The slot order of ``from_edges`` is a
  stable sort of ``concat([u, v])`` by source, i.e. for every vertex ``s``
  the forward slots (``u == s``, ascending edge id) precede the backward
  slots (``v == s``, ascending edge id).  The forward stream is the file
  itself; the backward stream is an external sort by ``(v, eid)``; a 2-way
  chunked merge on ``(src, origin, eid)`` reproduces the exact order — so
  :func:`graph_from_edgefile` is bit-identical to ``from_edges`` while its
  transient memory stays O(chunk), not O(M) int64 temporaries.

* :func:`shard_edges_stream` — 2D-hash distribution into padded shards for
  the SPMD partitioner, two block passes instead of a resident edge list.

A copy of the reference package's ``io/stream.py`` (the same files, the
same arrays).  Only :func:`graph_from_edgefile` touches torch, and it
imports it when called.
"""
from __future__ import annotations

import os
import tempfile
from typing import Iterable, Iterator

import numpy as np

from repro_torch.io.csr import CSRArrays, grid_assign_host
from repro_torch.io.edgefile import FLAG_CANONICAL, EdgeFile, EdgeFileWriter

DEFAULT_CHUNK = 1 << 20


# ---------------------------------------------------------------------------
# chunk sources
# ---------------------------------------------------------------------------

def iter_edge_chunks(source, chunk_size: int = DEFAULT_CHUNK,
                     ) -> Iterator[np.ndarray]:
    """Yield (k, 2) chunks of ≤ ``chunk_size`` edges from an EdgeFile, an
    ndarray, or an iterable — EdgeFile blocks larger than ``chunk_size``
    are re-sliced so the O(chunk) peak-RSS contract holds regardless of
    how the file was blocked."""
    if isinstance(source, EdgeFile):
        for blk in source.iter_blocks():
            for off in range(0, blk.shape[0], chunk_size):
                yield blk[off:off + chunk_size]
    elif isinstance(source, np.ndarray):
        for off in range(0, source.shape[0], chunk_size):
            yield source[off:off + chunk_size]
    else:
        yield from source


def infer_num_vertices(source, chunk_size: int = DEFAULT_CHUNK) -> int:
    """Max non-loop endpoint + 1 — same inference as canonicalize_edges."""
    if isinstance(source, EdgeFile) and source.canonical:
        return int(source.num_vertices)     # canonical ⇒ loop-free metadata
    top = -1
    for chunk in iter_edge_chunks(source, chunk_size):
        if chunk.shape[0] == 0:
            continue
        keep = chunk[:, 0] != chunk[:, 1]
        if keep.any():
            top = max(top, int(chunk[keep].max()))
    return top + 1


# ---------------------------------------------------------------------------
# sorted-run spill + k-way chunked merge
# ---------------------------------------------------------------------------

class _Run:
    """A sorted array spilled to disk, read back in bounded chunks.

    ``cols`` holds parallel payload files (same length as the key file).
    """

    def __init__(self, tmpdir: str, tag: str, key: np.ndarray,
                 cols: tuple[np.ndarray, ...] = ()):
        self.size = int(key.shape[0])
        self._paths = []
        self._dtypes = []
        for name, arr in (("key", key),) + tuple(
                (f"c{i}", c) for i, c in enumerate(cols)):
            p = os.path.join(tmpdir, f"{tag}.{name}.bin")
            arr.tofile(p)
            self._paths.append(p)
            self._dtypes.append(arr.dtype)
        self._off = 0

    def read(self, k: int) -> tuple[np.ndarray, ...]:
        k = min(k, self.size - self._off)
        out = tuple(
            np.fromfile(p, dtype=dt, count=k, offset=self._off * dt.itemsize)
            for p, dt in zip(self._paths, self._dtypes))
        self._off += k
        return out

    @property
    def exhausted(self) -> bool:
        return self._off >= self.size


def _sliced(chunks: Iterable[tuple[np.ndarray, ...]], chunk_size: int,
            ) -> Iterator[tuple[np.ndarray, ...]]:
    """Re-slice a chunk stream so no yielded chunk exceeds ``chunk_size`` —
    keeps downstream buffering bounded no matter how a merge batches."""
    for cols in chunks:
        total = cols[0].shape[0]
        for off in range(0, total, chunk_size):
            yield tuple(c[off:off + chunk_size] for c in cols)


def _merge_runs(runs: list[_Run], chunk_size: int, dedup: bool,
                ) -> Iterator[tuple[np.ndarray, ...]]:
    """K-way merge of sorted runs, yielding globally sorted chunks.

    Standard safe-boundary merge: everything ≤ the minimum of the buffered
    tails is fully present across buffers, so it can be emitted.  With
    ``dedup`` the keys are deduplicated globally (keys must then be the only
    column); without, keys must be globally unique and payload columns ride
    along.  Per-run reads are ``chunk_size / K`` and emitted chunks are
    re-sliced, so peak memory stays O(chunk_size), not O(K × chunk_size).
    """
    per = max(chunk_size // max(len(runs), 1), 1 << 12)
    yield from _sliced(_merge_runs_raw(runs, per, dedup), chunk_size)


def _merge_runs_raw(runs: list[_Run], per: int, dedup: bool,
                    ) -> Iterator[tuple[np.ndarray, ...]]:
    bufs: list[tuple[np.ndarray, ...] | None] = [None] * len(runs)
    while True:
        for i, r in enumerate(runs):
            if (bufs[i] is None or bufs[i][0].size == 0) and not r.exhausted:
                bufs[i] = r.read(per)
        live = [i for i in range(len(runs))
                if bufs[i] is not None and bufs[i][0].size]
        if not live:
            return
        cut = min(int(bufs[i][0][-1]) for i in live)
        parts = []
        for i in live:
            key = bufs[i][0]
            take = int(np.searchsorted(key, cut, side="right"))
            parts.append(tuple(c[:take] for c in bufs[i]))
            bufs[i] = tuple(c[take:] for c in bufs[i])
        cat = tuple(np.concatenate([p[j] for p in parts])
                    for j in range(len(parts[0])))
        if dedup:
            yield (np.unique(cat[0]),)
        else:
            order = np.argsort(cat[0], kind="stable")
            yield tuple(c[order] for c in cat)


# ---------------------------------------------------------------------------
# out-of-core canonicalization
# ---------------------------------------------------------------------------

def canonicalize_stream(source, out_path: str | os.PathLike,
                        num_vertices: int | None = None,
                        chunk_size: int = DEFAULT_CHUNK,
                        block_size: int | None = None,
                        tmpdir: str | None = None) -> EdgeFile:
    """Canonicalize + dedup ``source`` into a canonical EdgeFile at
    ``out_path`` with O(chunk_size) peak RSS (plus one spilled-run frontier
    per ~chunk of input during the merge).
    """
    if num_vertices is None:
        if isinstance(source, EdgeFile):
            num_vertices = int(source.num_vertices)
        else:
            raise ValueError("num_vertices is required for non-EdgeFile "
                             "sources (would need a second pass to infer)")
    n = int(num_vertices)
    if n and n * n >= 2 ** 63:
        raise ValueError("canonical key space u*n+v exceeds int64 — shrink "
                         "the vertex space or widen the key encoding")
    out_dtype = np.int32 if n <= (1 << 31) else np.int64
    with tempfile.TemporaryDirectory(dir=tmpdir) as td:
        runs: list[_Run] = []
        for i, chunk in enumerate(iter_edge_chunks(source, chunk_size)):
            if chunk.shape[0] == 0:
                continue
            u = np.minimum(chunk[:, 0], chunk[:, 1]).astype(np.int64)
            v = np.maximum(chunk[:, 0], chunk[:, 1]).astype(np.int64)
            keep = u != v
            if not keep.any():
                continue
            key = np.unique(u[keep] * n + v[keep])
            runs.append(_Run(td, f"canon{i}", key))
        writer = EdgeFileWriter(out_path, num_vertices=n,
                                block_size=block_size or chunk_size,
                                dtype=out_dtype, flags=FLAG_CANONICAL)
        with writer:
            for (key,) in _merge_runs(runs, chunk_size, dedup=True):
                uv = np.empty((key.shape[0], 2), out_dtype)
                uv[:, 0] = key // n
                uv[:, 1] = key % n
                writer.append(uv)
    return EdgeFile(os.fspath(out_path))


# ---------------------------------------------------------------------------
# streaming CSR build
# ---------------------------------------------------------------------------

def degree_indptr(ef: EdgeFile) -> tuple[np.ndarray, np.ndarray]:
    """(degree int32, indptr int32) of a canonical EdgeFile, one block pass."""
    n = int(ef.num_vertices)
    degree = np.zeros(n, np.int64)
    for blk in ef.iter_blocks():
        degree += np.bincount(blk[:, 0], minlength=n)
        degree += np.bincount(blk[:, 1], minlength=n)
    degree = degree.astype(np.int32)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(degree, out=indptr[1:])
    return degree, indptr


def require_canonical(ef: EdgeFile) -> None:
    """Single guard for every consumer that assumes FLAG_CANONICAL order."""
    if not ef.canonical:
        raise ValueError("EdgeFile is not canonical — run "
                         "repro_torch.io.canonicalize_stream first")


def csr_slot_stream(ef: EdgeFile, tmpdir: str,
                    chunk_size: int = DEFAULT_CHUNK,
                    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (slot_src, adj_dst, adj_eid) int32 chunks in final CSR order.

    Bit-identical to the slot order of ``csr_from_canonical`` (see module
    docstring).  ``tmpdir`` hosts the backward-half sorted runs; peak RSS is
    O(chunk_size), independent of |E|.
    """
    require_canonical(ef)
    m = int(ef.num_edges)
    if m == 0:
        return
    n = int(ef.num_vertices)
    if n * 2 * m >= 2 ** 62:
        raise ValueError("merge key space exceeds int64 — shrink the graph "
                         "or widen the key encoding")
    two_m = np.int64(2 * m)

    # backward half: slots (src=v, dst=u, eid), externally sorted by (v, eid)
    runs: list[_Run] = []
    off = 0
    for i, blk in enumerate(iter_edge_chunks(ef, chunk_size)):
        k = blk.shape[0]
        eid = np.arange(off, off + k, dtype=np.int64)
        off += k
        order = np.argsort(blk[:, 1], kind="stable")   # eid already ascending
        key = blk[:, 1].astype(np.int64)[order] * m + eid[order]
        runs.append(_Run(tmpdir, f"bwd{i}", key,
                         (blk[:, 0][order].astype(np.int32),)))

    def forward() -> Iterator[tuple[np.ndarray, ...]]:
        off = 0
        for blk in iter_edge_chunks(ef, chunk_size):
            k = blk.shape[0]
            eid = np.arange(off, off + k, dtype=np.int64)
            off += k
            key = blk[:, 0].astype(np.int64) * two_m + eid
            yield (key, blk[:, 0].astype(np.int32),
                   blk[:, 1].astype(np.int32), eid.astype(np.int32))

    def backward() -> Iterator[tuple[np.ndarray, ...]]:
        for key, u in _merge_runs(runs, chunk_size, dedup=False):
            src = (key // m).astype(np.int32)
            eid = (key % m).astype(np.int64)
            gkey = src.astype(np.int64) * two_m + m + eid
            yield (gkey, src, u, eid.astype(np.int32))

    fwd_run = _StreamRun(_sliced(forward(), chunk_size))
    bwd_run = _StreamRun(backward())
    for key, src, dst, eid in _sliced(_merge_streams(fwd_run, bwd_run),
                                      chunk_size):
        yield src, dst, eid


class _StreamRun:
    """Adapter giving generator-backed streams the _Run read interface."""

    def __init__(self, gen: Iterable[tuple[np.ndarray, ...]]):
        self._gen = iter(gen)
        self._buf: tuple[np.ndarray, ...] | None = None
        self.exhausted = False

    def peek(self) -> tuple[np.ndarray, ...] | None:
        if self._buf is not None and self._buf[0].size:
            return self._buf
        try:
            self._buf = next(self._gen)
            while self._buf[0].size == 0:
                self._buf = next(self._gen)
        except StopIteration:
            self._buf = None
            self.exhausted = True
        return self._buf

    def advance(self, k: int) -> None:
        assert self._buf is not None
        self._buf = tuple(c[k:] for c in self._buf)


def _merge_streams(a: _StreamRun, b: _StreamRun,
                   ) -> Iterator[tuple[np.ndarray, ...]]:
    """2-way merge of chunked sorted streams with globally unique keys."""
    while True:
        ba, bb = a.peek(), b.peek()
        if ba is None and bb is None:
            return
        if bb is None:
            yield ba
            a.advance(ba[0].size)
            continue
        if ba is None:
            yield bb
            b.advance(bb[0].size)
            continue
        cut = min(int(ba[0][-1]), int(bb[0][-1]))
        ka = int(np.searchsorted(ba[0], cut, side="right"))
        kb = int(np.searchsorted(bb[0], cut, side="right"))
        cat = tuple(np.concatenate([ca[:ka], cb[:kb]])
                    for ca, cb in zip(ba, bb))
        order = np.argsort(cat[0], kind="stable")
        yield tuple(c[order] for c in cat)
        a.advance(ka)
        b.advance(kb)


def csr_arrays_from_edgefile(ef: EdgeFile, chunk_size: int = DEFAULT_CHUNK,
                             tmpdir: str | None = None) -> CSRArrays:
    """Materialize the host CSR arrays of a canonical EdgeFile.

    Output-sized allocations only (the arrays a Graph needs anyway);
    transients stay O(chunk_size).  Bit-identical to
    ``csr_from_canonical(ef.read_all(), ef.num_vertices)``.
    """
    require_canonical(ef)
    n, m = int(ef.num_vertices), int(ef.num_edges)
    degree, indptr = degree_indptr(ef)
    dst = np.empty(2 * m, np.int32)
    eid = np.empty(2 * m, np.int32)
    src = np.empty(2 * m, np.int32)
    pos = 0
    with tempfile.TemporaryDirectory(dir=tmpdir) as td:
        for s, d, e in csr_slot_stream(ef, td, chunk_size):
            k = s.shape[0]
            src[pos:pos + k] = s
            dst[pos:pos + k] = d
            eid[pos:pos + k] = e
            pos += k
    assert pos == 2 * m, f"slot stream produced {pos} of {2 * m} slots"
    return CSRArrays(edges=ef.read_all().astype(np.int32, copy=False),
                     indptr=indptr, adj_dst=dst, adj_eid=eid, slot_src=src,
                     degree=degree)


def graph_from_edgefile(source, num_vertices: int | None = None,
                        chunk_size: int = DEFAULT_CHUNK,
                        tmpdir: str | None = None, device=None):
    """Build a :class:`repro_torch.core.graph.Graph` from the store, on
    ``device`` (``None`` means the card; raises without one).

    Accepts a canonical EdgeFile (zero-copy path), a raw EdgeFile or an edge
    ndarray / chunk iterator (canonicalized out-of-core first).  The result
    is bit-identical to ``from_edges`` on the same edges.
    """
    from repro_torch.core.graph import graph_from_csr, resolve_device

    device = resolve_device(device)     # raise before the host work

    if isinstance(source, EdgeFile) and source.canonical:
        if (num_vertices is not None
                and num_vertices != int(source.num_vertices)):
            # the canonical file fixes the vertex space; silently ignoring
            # a conflicting request would diverge from from_edges(edges, n)
            raise ValueError(f"num_vertices={num_vertices} conflicts with "
                             f"the canonical file's {source.num_vertices}")
        arrs = csr_arrays_from_edgefile(source, chunk_size, tmpdir)
    else:
        if num_vertices is None and not isinstance(source, EdgeFile):
            if not isinstance(source, np.ndarray):
                # a one-shot chunk iterator cannot be read twice: inferring
                # n here would exhaust it before canonicalization sees it
                raise ValueError("num_vertices is required for chunk-"
                                 "iterator sources")
            num_vertices = infer_num_vertices(source, chunk_size)
        with tempfile.TemporaryDirectory(dir=tmpdir) as td:
            can = canonicalize_stream(source, os.path.join(td, "canon.edges"),
                                      num_vertices=num_vertices,
                                      chunk_size=chunk_size, tmpdir=td)
            with can:
                arrs = csr_arrays_from_edgefile(can, chunk_size, td)
    return graph_from_csr(arrs, device)


# ---------------------------------------------------------------------------
# streaming 2D-hash sharding (SPMD partitioner front door)
# ---------------------------------------------------------------------------

def shard_edges_stream(ef: EdgeFile, num_devices: int, salt: int = 0,
                       with_edges: bool = False):
    """2D-hash distribution of an EdgeFile into equal-length padded shards.

    Same contract as ``core.graph.shard_edges`` (shards, masks, capacity,
    per-edge device), built in two block passes so the only O(M) arrays are
    the outputs themselves.  With ``with_edges`` the flat (M, 2) int32 edge
    list is assembled during the second pass and appended to the return
    tuple — saving callers that need both a third file pass and the
    ``read_all`` concatenation spike.
    """
    m = int(ef.num_edges)
    if int(ef.num_vertices) > (1 << 31):
        raise ValueError("shard arrays are int32 — vertex ids >= 2^31 "
                         "would wrap silently")
    dev_full = np.empty(m, np.int32)
    off = 0
    for blk in ef.iter_blocks():       # pass 1: hash once into dev_full
        dev_full[off:off + blk.shape[0]] = grid_assign_host(blk, num_devices,
                                                            salt=salt)
        off += blk.shape[0]
    counts = np.bincount(dev_full, minlength=num_devices)
    cap = int(counts.max()) if m else 1
    shards = np.zeros((num_devices, cap, 2), np.int32)
    masks = np.zeros((num_devices, cap), bool)
    edges = np.empty((m, 2), np.int32) if with_edges else None
    cursors = np.zeros(num_devices, np.int64)
    off = 0
    for blk in ef.iter_blocks():       # pass 2: reuse the assignments
        dev = dev_full[off:off + blk.shape[0]]
        if with_edges:
            edges[off:off + blk.shape[0]] = blk
        off += blk.shape[0]
        for d in np.unique(dev):
            rows = blk[dev == d]
            c = int(cursors[d])
            shards[d, c:c + rows.shape[0]] = rows
            masks[d, c:c + rows.shape[0]] = True
            cursors[d] += rows.shape[0]
    if with_edges:
        return shards, masks, cap, dev_full, edges
    return shards, masks, cap, dev_full
