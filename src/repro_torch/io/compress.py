"""Compressed on-disk CSR: zigzag-delta varint adjacency in row shards.

The paper's space-efficiency headline comes from never holding the graph
uncompressed: adjacency is stored as per-row deltas (sorted runs compress
to small positives) varint-encoded, grouped into shards of
``rows_per_shard`` CSR rows that decompress independently — so a consumer
touches O(shard) host/device memory, not O(2M).

File layout (little-endian)::

    header      64 bytes: magic "RCSR", version, rows_per_shard,
                num_vertices, num_edges, num_shards
    indptr      (N+1) int64
    shard table num_shards × (blob_offset u64, dst_nbytes u64, eid_nbytes u64)
    blobs       per shard: varint(zigzag(delta(adj_dst))) ‖
                varint(zigzag(delta(adj_eid))), deltas restarting at every
                row boundary (first element of a row is stored absolute).

All codec paths are vectorized numpy — no per-element Python loops.  A
copy of the reference package's ``io/compress.py``: the files are
byte-identical.  Only ``shard_device`` and ``to_graph`` touch torch, and
they import it when called, so this module loads without it.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from repro_torch.io.csr import CSRArrays, to_numpy

MAGIC = b"RCSR"
VERSION = 1
DEFAULT_ROWS = 1 << 15

_HEADER = struct.Struct("<4sIIQQQ28x")
assert _HEADER.size == 64

_MAX_VARINT = 10                 # 64 bits / 7 bits-per-byte, rounded up


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

def zigzag_encode(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.int64)
    return ((x << np.int64(1)) ^ (x >> np.int64(63))).astype(np.uint64)


def zigzag_decode(u: np.ndarray) -> np.ndarray:
    u = np.asarray(u, np.uint64)
    return ((u >> np.uint64(1)) ^ (np.uint64(0) - (u & np.uint64(1)))
            ).astype(np.int64)


def varint_encode(values: np.ndarray) -> np.ndarray:
    """LEB128-style varint encode of uint64 values → uint8 buffer."""
    u = np.asarray(values, np.uint64)
    if u.size == 0:
        return np.zeros(0, np.uint8)
    # a value's bytes: 1 + the 7-bit thresholds it reaches, counted only up
    # to the largest value present (deltas are small: 2-4 passes, not 9)
    top = int(u.max())
    nb = np.ones(u.shape, np.int64)
    for k in range(1, _MAX_VARINT):
        if top < 1 << (7 * k):
            break
        nb += u >= np.uint64(1 << (7 * k))
    starts = np.cumsum(nb) - nb
    out = np.zeros(int(starts[-1] + nb[-1]), np.uint8)
    # byte 0 of every value, with no mask to gather through
    out[starts] = ((u & np.uint64(0x7F)).astype(np.uint8)
                   | ((nb > 1).astype(np.uint8) << 7))
    for k in range(1, _MAX_VARINT):
        mask = nb > k
        if not mask.any():
            break
        byte = (u[mask] >> np.uint64(7 * k)) & np.uint64(0x7F)
        cont = (nb[mask] - 1 > k).astype(np.uint8) << 7
        out[starts[mask] + k] = byte.astype(np.uint8) | cont
    return out


def varint_decode(buf: np.ndarray, count: int) -> np.ndarray:
    """Decode ``count`` varints from a uint8 buffer → uint64 values."""
    buf = np.asarray(buf, np.uint8)
    if count == 0:
        return np.zeros(0, np.uint64)
    last = (buf & 0x80) == 0
    ends = np.flatnonzero(last)
    if ends.size != count:
        raise ValueError(f"corrupt varint stream: {ends.size} terminators "
                         f"for {count} values")
    starts = np.empty(count, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    if int(lens.max()) > _MAX_VARINT:
        raise ValueError("corrupt varint stream: value wider than 64 bits")
    out = (buf[starts] & 0x7F).astype(np.uint64)      # byte 0 of every value
    for k in range(1, int(lens.max())):
        mask = lens > k
        out[mask] |= ((buf[starts[mask] + k].astype(np.uint64)
                       & np.uint64(0x7F)) << np.uint64(7 * k))
    return out


def _row_starts_mask(length: int, row_bounds: np.ndarray) -> np.ndarray:
    """Bool mask of positions that start a (non-empty) row."""
    mask = np.zeros(length, bool)
    starts = row_bounds[:-1]
    starts = starts[starts < length]          # empty trailing rows
    mask[np.unique(starts)] = True            # empty rows collapse onto next
    return mask


def delta_encode_rows(values: np.ndarray, row_bounds: np.ndarray,
                      ) -> np.ndarray:
    """Per-row delta: first element absolute, rest vs predecessor. int64."""
    values = np.asarray(values, np.int64)
    if values.size == 0:
        return values
    prev = np.empty_like(values)
    prev[0] = 0
    prev[1:] = values[:-1]
    prev[_row_starts_mask(values.size, row_bounds)] = 0
    return values - prev


def delta_decode_rows(deltas: np.ndarray, row_bounds: np.ndarray,
                      ) -> np.ndarray:
    """Inverse of :func:`delta_encode_rows` — segmented cumsum."""
    deltas = np.asarray(deltas, np.int64)
    if deltas.size == 0:
        return deltas
    c = np.cumsum(deltas)
    starts = np.flatnonzero(_row_starts_mask(deltas.size, row_bounds))
    lens = np.diff(np.append(starts, deltas.size))
    base = c[starts] - deltas[starts]         # cumsum before each row
    return c - np.repeat(base, lens)


def _compress_cols(dst: np.ndarray, eid: np.ndarray, bounds: np.ndarray,
                   ) -> tuple[bytes, bytes]:
    b_dst = varint_encode(zigzag_encode(delta_encode_rows(dst, bounds)))
    b_eid = varint_encode(zigzag_encode(delta_encode_rows(eid, bounds)))
    return b_dst.tobytes(), b_eid.tobytes()


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------

class PackedCSRWriter:
    """Streaming writer: feed CSR slots in order via ``append_slots``; shards
    are compressed and flushed as soon as their row span is complete.
    """

    def __init__(self, path: str | os.PathLike, indptr: np.ndarray,
                 num_edges: int, rows_per_shard: int = DEFAULT_ROWS):
        self.path = os.fspath(path)
        self.indptr = np.asarray(indptr, np.int64)
        self.n = int(self.indptr.shape[0] - 1)
        self.m = int(num_edges)
        self.rows_per_shard = int(rows_per_shard)
        self.num_shards = max(
            (self.n + self.rows_per_shard - 1) // self.rows_per_shard, 0)
        self._f = open(self.path, "wb")
        self._f.write(_HEADER.pack(MAGIC, VERSION, self.rows_per_shard,
                                   self.n, self.m, self.num_shards))
        self._f.write(self.indptr.astype("<i8").tobytes())
        self._table_pos = self._f.tell()
        self._f.write(b"\0" * (self.num_shards * 24))
        self._table: list[tuple[int, int, int]] = []
        self._pend: list[tuple[np.ndarray, np.ndarray]] = []
        self._slot_cursor = 0
        self._next_shard = 0
        self._closed = False

    def append_slots(self, dst: np.ndarray, eid: np.ndarray) -> None:
        if dst.shape[0] == 0:
            return
        self._pend.append((np.asarray(dst), np.asarray(eid)))
        self._slot_cursor += dst.shape[0]
        self._flush_ready()

    def _shard_bounds(self, s: int) -> tuple[int, int, np.ndarray]:
        r0 = s * self.rows_per_shard
        r1 = min(r0 + self.rows_per_shard, self.n)
        return int(self.indptr[r0]), int(self.indptr[r1]), \
            self.indptr[r0:r1 + 1] - self.indptr[r0]

    def _flush_ready(self) -> None:
        while self._next_shard < self.num_shards:
            lo, hi, bounds = self._shard_bounds(self._next_shard)
            if self._slot_cursor < hi:
                return
            # single-element remainders slice as views — no per-shard
            # recopy of everything still pending
            if not self._pend:
                dst = eid = np.zeros(0, np.int32)
            elif len(self._pend) == 1:
                dst, eid = self._pend[0]
            else:
                dst = np.concatenate([p[0] for p in self._pend])
                eid = np.concatenate([p[1] for p in self._pend])
            base = self._slot_cursor - dst.shape[0]     # first buffered slot
            take = hi - base
            b_dst, b_eid = _compress_cols(dst[lo - base:take],
                                          eid[lo - base:take], bounds)
            off = self._f.tell()
            self._f.write(b_dst)
            self._f.write(b_eid)
            self._table.append((off, len(b_dst), len(b_eid)))
            rest_dst, rest_eid = dst[take:], eid[take:]
            self._pend = [(rest_dst, rest_eid)] if rest_dst.size else []
            self._next_shard += 1

    def close(self) -> "PackedCSR":
        self._finalize()
        return PackedCSR(self.path)

    def _finalize(self) -> None:
        if self._closed:
            return
        if self._slot_cursor != 2 * self.m:
            self._f.close()
            self._closed = True
            raise ValueError(f"received {self._slot_cursor} slots, "
                             f"expected {2 * self.m}")
        self._flush_ready()      # trailing empty-row shards
        assert self._next_shard == self.num_shards
        table = np.asarray(self._table, "<u8").reshape(-1, 3)
        self._f.seek(self._table_pos)
        self._f.write(table.tobytes())
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._finalize()     # same contract as EdgeFileWriter
        elif not self._closed:
            self._f.close()


class PackedCSR:
    """Reader with lazy per-shard decompression.

    ``shard(s)`` returns host arrays; ``shard_device(s, device)`` stages
    them onto a torch device — the unit a future multi-host loader would
    prefetch.  ``to_graph(device)`` reconstructs the full bit-identical
    Graph.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        (magic, version, self.rows_per_shard, self.n, self.m,
         self.num_shards) = _HEADER.unpack(self._f.read(_HEADER.size))
        if magic != MAGIC:
            raise ValueError(f"{self.path}: not a PackedCSR (bad magic)")
        if version != VERSION:
            raise ValueError(f"{self.path}: unsupported version {version}")
        self.indptr = np.frombuffer(self._f.read((self.n + 1) * 8),
                                    dtype="<i8").copy()
        self._table = np.frombuffer(self._f.read(self.num_shards * 24),
                                    dtype="<u8").reshape(-1, 3).copy()

    @property
    def num_vertices(self) -> int:
        return int(self.n)

    @property
    def num_edges(self) -> int:
        return int(self.m)

    def _shard_rows(self, s: int) -> tuple[int, int]:
        r0 = s * self.rows_per_shard
        return r0, min(r0 + self.rows_per_shard, self.n)

    def shard(self, s: int) -> tuple[np.ndarray, np.ndarray]:
        """(adj_dst, adj_eid) int32 of shard ``s`` — decompressed on demand."""
        if not 0 <= s < self.num_shards:
            raise IndexError(f"shard {s} out of range [0, {self.num_shards})")
        off, n_dst, n_eid = (int(x) for x in self._table[s])
        r0, r1 = self._shard_rows(s)
        bounds = self.indptr[r0:r1 + 1] - self.indptr[r0]
        count = int(bounds[-1])
        self._f.seek(off)
        raw = np.frombuffer(self._f.read(n_dst + n_eid), np.uint8)
        dst = delta_decode_rows(
            zigzag_decode(varint_decode(raw[:n_dst], count)), bounds)
        eid = delta_decode_rows(
            zigzag_decode(varint_decode(raw[n_dst:], count)), bounds)
        return dst.astype(np.int32), eid.astype(np.int32)

    def shard_device(self, s: int, device=None):
        """Lazy decompression straight into torch tensors on ``device``
        (``None`` means the card; raises without one)."""
        from repro_torch.core.graph import to_device

        return tuple(to_device(a, device) for a in self.shard(s))

    def iter_slots(self):
        """Yield (slot_src, adj_dst, adj_eid) int32 per shard, CSR order."""
        for s in range(self.num_shards):
            r0, r1 = self._shard_rows(s)
            dst, eid = self.shard(s)
            deg = np.diff(self.indptr[r0:r1 + 1]).astype(np.int64)
            src = np.repeat(np.arange(r0, r1, dtype=np.int32), deg)
            yield src, dst, eid

    def row(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        """Adjacency of one vertex (decompresses its shard)."""
        s = v // self.rows_per_shard
        dst, eid = self.shard(s)
        lo = int(self.indptr[v] - self.indptr[s * self.rows_per_shard])
        hi = lo + int(self.indptr[v + 1] - self.indptr[v])
        return dst[lo:hi], eid[lo:hi]

    def to_graph(self, device=None):
        """Reconstruct the full in-memory Graph (bit-identical) on
        ``device`` (``None`` means the card; raises without one)."""
        from repro_torch.core.graph import graph_from_csr, resolve_device

        device = resolve_device(device)     # raise before the host work

        dst = np.empty(2 * self.m, np.int32)
        eid = np.empty(2 * self.m, np.int32)
        src = np.empty(2 * self.m, np.int32)
        pos = 0
        for s_arr, d_arr, e_arr in self.iter_slots():
            k = s_arr.shape[0]
            src[pos:pos + k] = s_arr
            dst[pos:pos + k] = d_arr
            eid[pos:pos + k] = e_arr
            pos += k
        assert pos == 2 * self.m
        # each undirected edge has exactly one forward slot (src < dst,
        # canonical u < v); scatter by edge id to recover the edge list
        fwd = src < dst
        edges = np.empty((self.m, 2), np.int32)
        edges[eid[fwd], 0] = src[fwd]
        edges[eid[fwd], 1] = dst[fwd]
        degree = np.diff(self.indptr).astype(np.int32)
        return graph_from_csr(CSRArrays(
            edges=edges, indptr=self.indptr.astype(np.int32), adj_dst=dst,
            adj_eid=eid, slot_src=src, degree=degree), device)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()


def pack_csr(source, path: str | os.PathLike,
             rows_per_shard: int = DEFAULT_ROWS,
             chunk_size: int | None = None,
             tmpdir: str | None = None) -> PackedCSR:
    """Build a PackedCSR container from a canonical EdgeFile (streamed,
    O(chunk) RSS) or an in-memory Graph (direct).
    """
    import tempfile

    from repro_torch.io.edgefile import EdgeFile
    from repro_torch.io.stream import (DEFAULT_CHUNK, csr_slot_stream,
                                 degree_indptr, require_canonical)

    if isinstance(source, EdgeFile):
        require_canonical(source)
        _, indptr = degree_indptr(source)
        with PackedCSRWriter(path, indptr, int(source.num_edges),
                             rows_per_shard) as w:
            with tempfile.TemporaryDirectory(dir=tmpdir) as td:
                for _, dst, eid in csr_slot_stream(
                        source, td, chunk_size or DEFAULT_CHUNK):
                    w.append_slots(dst, eid)
            return w.close()
    # in-memory Graph (duck-typed: has .indptr/.adj_dst/.adj_eid)
    edges = to_numpy(source.edges)
    if edges.size and not (edges[:, 0] < edges[:, 1]).all():
        # to_graph reconstructs the edge list from the unique u<v forward
        # slot of each edge — a non-canonical graph (from_edges(dedup=False)
        # with loops or u>v rows) would round-trip as silent garbage
        raise ValueError("pack_csr requires a canonical Graph (u < v, no "
                         "self-loops) — build it with from_edges(dedup=True)")
    indptr = to_numpy(source.indptr)
    with PackedCSRWriter(path, indptr, int(source.num_edges),
                         rows_per_shard) as w:
        w.append_slots(to_numpy(source.adj_dst), to_numpy(source.adj_eid))
        return w.close()
