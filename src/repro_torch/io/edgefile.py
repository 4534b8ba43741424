"""Chunked binary edge-shard format — the on-disk unit of the graph store.

Layout (little-endian)::

    header   64 bytes: magic "REDG", version, flags, itemsize, block_size,
                       num_edges, num_vertices, num_blocks, index_offset
    data     num_blocks blocks at a *fixed stride* of
             block_size * 2 * itemsize bytes (the last block is zero-padded),
             so block ``i`` starts at ``64 + i * stride`` — an O(1) seek.
    index    num_blocks × 3 int64 rows: (count, vmin, vmax) per block.

The per-block min/max vertex metadata lets readers prune blocks by vertex
range and lets the streaming canonicalizer size its key space without a
second pass over the data.  ``FLAG_CANONICAL`` marks a file whose edges are
loop-free, deduplicated, ``u < v`` and sorted by ``(u, v)`` — exactly the
order ``io.csr.canonicalize_host`` produces, which is what makes
stream-built CSRs bit-identical to the in-memory path.  A copy of the
reference package's ``io/edgefile.py``: the files are byte-identical.
"""
from __future__ import annotations

import os
import struct

import numpy as np

MAGIC = b"REDG"
VERSION = 1
FLAG_CANONICAL = 1
DEFAULT_BLOCK = 1 << 20          # edges per block (8 MiB of int32 pairs)

_HEADER = struct.Struct("<4sIIIIQQQQ12x")
assert _HEADER.size == 64


def _dtype_for(itemsize: int) -> np.dtype:
    if itemsize == 4:
        return np.dtype("<i4")
    if itemsize == 8:
        return np.dtype("<i8")
    raise ValueError(f"unsupported itemsize {itemsize}")


class EdgeFileWriter:
    """Streaming writer: ``append`` edge chunks of any size, blocks are cut
    at ``block_size`` edges and flushed immediately — peak RSS is one block.
    """

    def __init__(self, path: str | os.PathLike, num_vertices: int | None = None,
                 block_size: int = DEFAULT_BLOCK, dtype=np.int32,
                 flags: int = 0):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.path = os.fspath(path)
        self.block_size = int(block_size)
        self.dtype = _dtype_for(np.dtype(dtype).itemsize)
        self.flags = int(flags)
        self._given_n = None if num_vertices is None else int(num_vertices)
        self._stride = self.block_size * 2 * self.dtype.itemsize
        self._f = open(self.path, "wb")
        self._f.write(b"\0" * _HEADER.size)          # header placeholder
        self._pend: list[np.ndarray] = []
        self._pend_rows = 0
        self._meta: list[tuple[int, int, int]] = []
        self._num_edges = 0
        self._max_seen = -1
        self._closed = False

    # -- context manager ----------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._finalize()
        else:
            self._f.close()

    def append(self, edges: np.ndarray) -> None:
        edges = np.asarray(edges)
        if edges.ndim != 2 or edges.shape[1] != 2:
            raise ValueError(f"expected (k, 2) edge chunk, got {edges.shape}")
        if edges.shape[0] == 0:
            return
        if edges.dtype != self.dtype:
            # validate before the cast — numpy wraps out-of-range ints
            # silently (wider ints and same-width unsigned alike), and the
            # finalize-time guard only sees wrapped values
            info = np.iinfo(self.dtype)
            if int(edges.max()) > info.max or int(edges.min()) < info.min:
                raise ValueError(f"edge ids do not fit an {self.dtype} edge "
                                 f"file — pass a wider dtype to the writer")
        self._pend.append(np.ascontiguousarray(edges, dtype=self.dtype))
        self._pend_rows += edges.shape[0]
        if self._pend_rows >= self.block_size:
            self._drain(final=False)

    def _drain(self, final: bool) -> None:
        if not self._pend:
            return
        buf = (self._pend[0] if len(self._pend) == 1
               else np.concatenate(self._pend))
        self._pend = []
        off = 0
        while buf.shape[0] - off >= self.block_size:
            self._write_block(buf[off:off + self.block_size])
            off += self.block_size
        if off < buf.shape[0]:
            if final:
                self._write_block(buf[off:])
            else:
                self._pend = [buf[off:]]
        self._pend_rows = buf.shape[0] - off if not final else 0

    def _write_block(self, blk: np.ndarray) -> None:
        count = blk.shape[0]
        vmin, vmax = int(blk.min()), int(blk.max())
        raw = blk.tobytes()
        self._f.write(raw)
        self._f.write(b"\0" * (self._stride - len(raw)))
        self._meta.append((count, vmin, vmax))
        self._num_edges += count
        # track the max non-self-loop endpoint: num_vertices inference
        # excludes loop-only vertices (the same rule as canonicalize_edges,
        # so stream-built graphs stay bit-identical to from_edges on raw
        # inputs), and a caller-given num_vertices is validated against it
        nl = blk[blk[:, 0] != blk[:, 1]]
        if nl.size:
            self._max_seen = max(self._max_seen, int(nl.max()))

    def close(self) -> "EdgeFile":
        self._finalize()
        return EdgeFile(self.path)

    def _finalize(self) -> None:
        if self._closed:
            return
        self._drain(final=True)
        n = (self._given_n if self._given_n is not None
             else self._max_seen + 1 if self._num_edges else 0)
        err = None
        if self._given_n is not None and self._max_seen >= self._given_n:
            # a lying num_vertices would corrupt every consumer that
            # encodes keys as u*n + v (canonicalize_stream) — fail loudly
            err = (f"num_vertices={self._given_n} but the file contains "
                   f"non-loop vertex id {self._max_seen}")
        elif self.dtype.itemsize == 4 and n > (1 << 31):
            err = "int32 edge file cannot hold vertex ids >= 2^31"
        if err is not None:
            self._f.close()
            self._closed = True
            raise ValueError(err)
        index = np.asarray(self._meta, dtype="<i8").reshape(-1, 3)
        index_offset = _HEADER.size + len(self._meta) * self._stride
        self._f.write(index.tobytes())
        self._f.seek(0)
        self._f.write(_HEADER.pack(MAGIC, VERSION, self.flags,
                                   self.dtype.itemsize, self.block_size,
                                   self._num_edges, n, len(self._meta),
                                   index_offset))
        self._f.close()
        self._closed = True


class EdgeFile:
    """Reader handle.  ``block(i)`` is an O(1) seek; ``iter_blocks`` is the
    sequential-streaming interface every out-of-core pass is built on.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        hdr = self._f.read(_HEADER.size)
        (magic, version, self.flags, itemsize, self.block_size,
         self.num_edges, self.num_vertices, self.num_blocks,
         index_offset) = _HEADER.unpack(hdr)
        if magic != MAGIC:
            raise ValueError(f"{self.path}: not an EdgeFile (bad magic)")
        if version != VERSION:
            raise ValueError(f"{self.path}: unsupported version {version}")
        self.dtype = _dtype_for(itemsize)
        self._stride = self.block_size * 2 * itemsize
        self._f.seek(index_offset)
        index = np.frombuffer(
            self._f.read(self.num_blocks * 3 * 8), dtype="<i8",
        ).reshape(-1, 3)
        self.block_counts = index[:, 0].copy()
        self.block_vmin = index[:, 1].copy()
        self.block_vmax = index[:, 2].copy()

    @property
    def canonical(self) -> bool:
        return bool(self.flags & FLAG_CANONICAL)

    def __len__(self) -> int:
        return int(self.num_edges)

    def block(self, i: int) -> np.ndarray:
        """Edges of block ``i`` as an (count_i, 2) array — one seek + read."""
        if not 0 <= i < self.num_blocks:
            raise IndexError(f"block {i} out of range [0, {self.num_blocks})")
        count = int(self.block_counts[i])
        self._f.seek(_HEADER.size + i * self._stride)
        raw = self._f.read(count * 2 * self.dtype.itemsize)
        return np.frombuffer(raw, dtype=self.dtype).reshape(count, 2)

    def iter_blocks(self, start: int = 0, stop: int | None = None):
        """Yield blocks ``[start, stop)`` — the shard-range read every
        multi-host ingestion plan is built on (``runtime.cluster`` hands
        each host a contiguous block range, so no host touches the rest
        of the file)."""
        stop = self.num_blocks if stop is None else min(stop, self.num_blocks)
        for i in range(start, stop):
            yield self.block(i)

    def edges_in_blocks(self, start: int = 0, stop: int | None = None) -> int:
        """Edge count of block range ``[start, stop)`` from the index —
        no data read."""
        stop = self.num_blocks if stop is None else min(stop, self.num_blocks)
        return int(self.block_counts[start:stop].sum()) if stop > start else 0

    def read_blocks(self, start: int = 0, stop: int | None = None,
                    ) -> np.ndarray:
        """Materialize block range ``[start, stop)`` as one (k, 2) array."""
        blocks = list(self.iter_blocks(start, stop))
        if not blocks:
            return np.zeros((0, 2), self.dtype)
        return np.concatenate(blocks)

    def read_all(self) -> np.ndarray:
        if self.num_blocks == 0:
            return np.zeros((0, 2), self.dtype)
        return np.concatenate(list(self.iter_blocks()))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()


def write_edgefile(path: str | os.PathLike, edges, num_vertices=None,
                   block_size: int = DEFAULT_BLOCK, dtype=np.int32,
                   flags: int = 0) -> EdgeFile:
    """Write an edge array or an iterable of edge chunks to ``path``."""
    with EdgeFileWriter(path, num_vertices=num_vertices,
                        block_size=block_size, dtype=dtype,
                        flags=flags) as w:
        if isinstance(edges, np.ndarray):
            w.append(edges)
        else:
            for chunk in edges:
                w.append(chunk)
    return EdgeFile(path)
