"""Sharded graph/feature store over a partition artifact.

A copy of the reference package's ``serve/store.py``: the same row
shards, byte for byte, the same ``verts`` and ``indptr``.  The
serving-side consumer of ``repro_torch.runtime.artifact``: it loads the
partitions a serving process *owns* (its partition group) out of the
durable artifact — per-partition zigzag-delta varint edge shards — and
re-packs each partition's adjacency into compressed **row shards** that
decode independently, exactly the PackedCSR discipline of the training
path (``repro_torch.io.compress``), but keyed by the partition's own
vertex set:

* ``verts``  — the sorted global vertex ids present in partition ``p``
  (a vertex is in ``p`` iff ``p`` holds one of its edges — the
  vertex-cut invariant the replica map encodes);
* ``indptr`` — local CSR row pointers over ``verts``;
* ``shards[s]`` — the adjacency of rows ``[s·R, (s+1)·R)`` as one
  varint(zigzag(per-row delta)) blob.

A partition encodes in one pass over all its rows, then its byte stream
is cut at the shards' first rows: a row's deltas and a value's varint
bytes do not depend on the values beside them, so each cut is the
reference's shard.  Partitions build in threads (numpy releases the GIL
in the sorts and the codec); the bytes do not depend on the count.

A neighbor query binary-searches ``verts``, decodes the one shard that
holds the row — through the :class:`~repro_torch.serve.cache.LRUCache`,
so a Zipf-head vertex never pays the decode twice — and slices its row
out.  Everything here is numpy + stdlib (no torch, no jax): a serving
host must come up fast and run on boxes with no accelerator stack, like
the monitor.

Memory envelope: a store holds O(Σ_p |E_p| compressed + |V_p|) for its
owned partitions only, never O(M) — partition groups are how the gang
scales the graph past one host (docs/DESIGN-serve.md).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.io.compress import (delta_decode_rows, delta_encode_rows,
                                     varint_decode, varint_encode,
                                     zigzag_decode, zigzag_encode)
from repro_torch.serve.cache import LRUCache

#: row-shard size for the serving store — smaller than PackedCSR's
#: (1 << 15) training default because serving decodes per query, not
#: per sequential sweep
DEFAULT_ROWS = 256
# a store's partitions build in this many threads
_THREADS = min(8, os.cpu_count() or 1)


def _env_int(name: str, default: int) -> int:
    val = os.environ.get(name, "")
    return int(val) if val else default


def default_cache_entries() -> int:
    """``REPRO_SERVE_CACHE`` (decoded shards kept hot; 0 disables)."""
    return _env_int("REPRO_SERVE_CACHE", 64)


def vertex_features(vs: np.ndarray, dim: int = 8,
                    seed: int = 0) -> np.ndarray:
    """Deterministic per-vertex feature vectors, (len(vs), dim) float32.

    A stand-in feature store: features are a pure splitmix hash of
    ``(vertex id, column, seed)``, uniform in [0, 1) — so every replica
    of a cut vertex serves bit-identical features with no feature
    exchange, and the multi- vs single-process consistency checks can
    compare exact bytes.  A real deployment would mmap an embedding
    table here; the routing/caching layers above don't care.
    """
    from repro_torch.io.csr import hash_u32_host

    vs = np.asarray(vs, np.int64)
    cols = [hash_u32_host(vs, salt=seed * 1024 + j).astype(np.float64)
            / 2.0 ** 32 for j in range(dim)]
    return np.stack(cols, axis=1).astype(np.float32)


class PartitionShards:
    """One partition's adjacency, compressed into row shards."""

    def __init__(self, edges: np.ndarray, rows_per_shard: int):
        edges = np.asarray(edges, np.int64)
        self.rows_per_shard = int(rows_per_shard)
        if edges.size == 0:
            self.verts = np.zeros(0, np.int64)
            self.indptr = np.zeros(1, np.int64)
            self.shards: list[bytes] = []
            return
        # both directed slots of every edge, rows sorted by (src, dst)
        # so each row decodes to an already-sorted neighbor list
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        self.verts, counts = np.unique(src, return_counts=True)
        self.indptr = np.zeros(self.verts.size + 1, np.int64)
        np.cumsum(counts, out=self.indptr[1:])
        # the whole partition's varints at once; a value ends at a byte
        # under 0x80, so value k starts at byte cut[k]
        buf = varint_encode(zigzag_encode(delta_encode_rows(
            dst, self.indptr)))
        cut = np.zeros(dst.size + 1, np.int64)
        cut[1:] = np.flatnonzero(buf < 0x80) + 1
        r = self.rows_per_shard
        rows = np.append(np.arange(0, self.verts.size, r), self.verts.size)
        at = cut[self.indptr[rows]]
        self.shards = [buf[a:b].tobytes()
                       for a, b in zip(at[:-1].tolist(), at[1:].tolist())]

    @property
    def num_shards(self) -> int:
        r = self.rows_per_shard
        return (self.verts.size + r - 1) // r

    def _shard_rows(self, s: int) -> tuple[int, int]:
        r0 = s * self.rows_per_shard
        return r0, min(r0 + self.rows_per_shard, self.verts.size)

    def decode_shard(self, s: int) -> np.ndarray:
        """The adjacency slice of row shard ``s`` (the unit the serving
        LRU caches)."""
        r0, r1 = self._shard_rows(s)
        bounds = self.indptr[r0:r1 + 1] - self.indptr[r0]
        count = int(bounds[-1])
        raw = np.frombuffer(self.shards[s], np.uint8)
        return delta_decode_rows(
            zigzag_decode(varint_decode(raw, count)), bounds)

    def row_of(self, v: int) -> int:
        """Local row index of global vertex ``v``, or -1 when absent."""
        i = int(np.searchsorted(self.verts, v))
        if i >= self.verts.size or self.verts[i] != v:
            return -1
        return i

    @property
    def nbytes(self) -> int:
        return sum(len(b) for b in self.shards)


class ShardStore:
    """The serving store: owned partitions of one artifact + hot cache.

    ``partitions`` selects the partition group this process serves
    (default: all of them — the single-process configuration).  The
    replica map stays global: routing needs to know *every* partition a
    vertex replicates into, including ones this store doesn't own.
    """

    def __init__(self, artifact, partitions=None,
                 rows_per_shard: int = DEFAULT_ROWS,
                 cache_entries: int | None = None,
                 feature_dim: int = 8, feature_seed: int = 0):
        from repro_torch.runtime.artifact import load_artifact

        if isinstance(artifact, (str, os.PathLike)):
            artifact = load_artifact(artifact)
        self.artifact = artifact
        self.num_vertices = artifact.num_vertices
        self.num_partitions = artifact.num_partitions
        self.partitions = (list(range(self.num_partitions))
                           if partitions is None
                           else sorted(int(p) for p in partitions))
        self.feature_dim = int(feature_dim)
        self.feature_seed = int(feature_seed)
        if cache_entries is None:
            cache_entries = default_cache_entries()
        self.cache = LRUCache(cache_entries)
        self.decodes = 0          # shard decodes actually performed
        for p in self.partitions:
            if not 0 <= p < self.num_partitions:
                raise ValueError(f"partition {p} out of range "
                                 f"[0, {self.num_partitions})")
        with ThreadPoolExecutor(_THREADS) as pool:
            built = pool.map(lambda p: PartitionShards(
                artifact.partition_edges(p), rows_per_shard),
                self.partitions)
            self._parts: dict[int, PartitionShards] = dict(
                zip(self.partitions, built))
        # verify the loaded edge sets against the manifest counts — a
        # store serving a torn artifact must fail at load, not at query
        for p, ps in self._parts.items():
            want = 2 * int(artifact.edges_per_part[p])
            if int(ps.indptr[-1]) != want:
                raise IOError(
                    f"partition {p}: decoded {int(ps.indptr[-1])} "
                    f"adjacency slots, manifest says {want}")

    # -- adjacency ----------------------------------------------------------

    def _shard_slice(self, p: int, s: int) -> np.ndarray:
        key = (p, s)
        dec = self.cache.get(key)
        if dec is None:
            dec = self._parts[p].decode_shard(s)
            self.decodes += 1
            self.cache.put(key, dec)
        return dec

    def neighbors(self, p: int, v: int) -> np.ndarray:
        """Sorted neighbors of ``v`` within partition ``p`` (int64);
        empty when ``v`` has no edge in ``p``."""
        ps = self._parts[p]
        i = ps.row_of(v)
        if i < 0:
            return np.zeros(0, np.int64)
        s = i // ps.rows_per_shard
        dec = self._shard_slice(p, s)
        base = int(ps.indptr[s * ps.rows_per_shard])
        lo = int(ps.indptr[i]) - base
        hi = int(ps.indptr[i + 1]) - base
        return dec[lo:hi]

    def degree(self, p: int, v: int) -> int:
        """Degree of ``v`` within partition ``p`` (no decode)."""
        ps = self._parts[p]
        i = ps.row_of(v)
        if i < 0:
            return 0
        return int(ps.indptr[i + 1] - ps.indptr[i])

    # -- routing ------------------------------------------------------------

    def partitions_of(self, v: int) -> np.ndarray:
        """Every partition holding a replica of ``v`` (the fan-out
        set) — delegates to the artifact's replica map."""
        return self.artifact.partitions_of(v)

    def owned_partitions_of(self, v: int) -> list[int]:
        """The replica partitions of ``v`` that this store serves."""
        return [int(p) for p in self.partitions_of(v)
                if p in self._parts]

    # -- features -----------------------------------------------------------

    def features(self, vs) -> np.ndarray:
        vs = np.atleast_1d(np.asarray(vs, np.int64))
        return vertex_features(vs, self.feature_dim, self.feature_seed)

    # -- metrics ------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "partitions": list(self.partitions),
            "compressed_bytes": sum(ps.nbytes
                                    for ps in self._parts.values()),
            "decodes": self.decodes,
            "cache": self.cache.stats(),
        }


__all__ = ["DEFAULT_ROWS", "PartitionShards", "ShardStore",
           "default_cache_entries", "vertex_features"]
