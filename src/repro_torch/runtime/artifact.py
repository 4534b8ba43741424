"""Durable partition artifacts: the run's output as a store object.

A copy of the reference package's ``runtime/artifact.py``: an artifact
the port writes is byte-identical to the reference driver's (run with
``use_pallas=True``) for the same result, and each package loads the
other's.

A finished partitioning run is worth exactly as much as the artifact it
leaves behind — the paper's 70-minute trillion-edge run is useless if the
assignment only ever lived in device memory.  ``save_artifact`` persists a
:class:`~repro_torch.core.partitioner.PartitionResult` as:

* ``part_<p>.bin`` — partition ``p``'s edge set, compressed with the
  ``repro_torch.io.compress`` codec (three zigzag-delta varint streams: u, v and
  the global edge ids).  A partition's edges are a sorted subset of the
  canonical edge list, so the deltas are small and the shards compress like
  PackedCSR adjacency (~3-4 B/edge vs 8 raw); each shard decodes
  independently, so a consumer that wants only partition ``p`` touches
  O(|E_p|), never O(M);
* ``replicas.bin`` — the (N, P) vertex replica map, bit-packed (1 bit per
  vertex-partition pair);
* ``manifest.json`` — schema version, sizes, per-file byte lengths +
  sha1s, per-partition edge counts, run stats (rounds, leftover,
  replication factor) and the config/graph fingerprints of the run that
  produced it.

Writes stage into a dot-prefixed tmp dir and publish with one fsynced
atomic rename (same crash-safety contract as the checkpoint store).

``load_artifact`` reverses it: per-partition edge sets feed
``apps.engine.build_sharded_graph`` / ``dist.redistribute`` directly, and
the full ``edge_part`` / ``vparts`` reconstruct bit-identically for the
GNN training path — no re-partitioning, ever.

**Cooperative multi-writer save** (the sharded finalize epilogue): with
one process per host no host holds the global assignment, so the artifact
is staged cooperatively, mirroring the snapshot
``begin_shared``/``publish_shared`` protocol —

  host 0:      ``begin_shared_artifact``    — staging dir
  <barrier>
  every host:  ``write_artifact_contrib``   — its slices' per-partition
                                              (eid, u, v) spills, fsynced
  <barrier>
  every host:  ``encode_shared_parts``      — owner of partition ``p``
                                              (``p % num_hosts``) merges
                                              all hosts' spills, encodes
                                              ``part_<p>.bin``, stages a
                                              per-host meta manifest
  <barrier>
  host 0:      ``publish_shared_artifact``  — merge metas (refusing torn
                                              staging), write replicas +
                                              manifest, atomic rename

The caller owns the barriers.  The published
bytes are identical to a single-writer ``save_artifact`` of the same
result — same shard files, checksums and manifest — because both paths
share :func:`_encode_partition` and partition edges are merged back into
ascending-eid order before encoding (asserted by tests/test_runtime.py
and the multihost CI checks).  A kill at any point before publish leaves
only the dot-prefixed staging dir; a pre-existing artifact at the target
stays intact.

This module imports numpy only (the ``PartitionResult`` and engine
imports are lazy).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from repro_torch.io.atomicdir import publish_dir
from repro_torch.io.compress import (varint_decode, varint_encode,
                                     zigzag_decode, zigzag_encode)

ARTIFACT_VERSION = 1
MANIFEST = "manifest.json"
# partitions encode and decode independently, in threads (numpy releases
# the GIL in the varint passes); the bytes do not depend on the count
_MAX_THREADS = 8
_THREADS = min(_MAX_THREADS, os.cpu_count() or 1)


def _each_part(fn, parts, threads: int = _THREADS) -> list:
    """``[fn(p) for p in parts]``, the calls spread over ``threads``
    threads."""
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(fn, parts))


def _delta(x: np.ndarray) -> np.ndarray:
    d = np.asarray(x, np.int64).copy()
    d[1:] -= np.asarray(x, np.int64)[:-1]
    return d


def _undelta(d: np.ndarray) -> np.ndarray:
    return np.cumsum(np.asarray(d, np.int64))


def _encode_stream(x: np.ndarray) -> bytes:
    return varint_encode(zigzag_encode(_delta(x))).tobytes()


def _decode_stream(raw: bytes, count: int) -> np.ndarray:
    buf = np.frombuffer(raw, np.uint8)
    return _undelta(zigzag_decode(varint_decode(buf, count)))


def _sha1(raw: bytes) -> str:
    return hashlib.sha1(raw).hexdigest()[:16]


def _encode_partition(u: np.ndarray, v: np.ndarray, eids: np.ndarray,
                      ) -> tuple[bytes, dict]:
    """One partition's shard bytes + manifest entry, from its edges in
    ascending-eid order.  The single encoder both the single-writer and
    the cooperative multi-writer save go through — byte-identity between
    the two is by construction, not by test luck."""
    blobs = (_encode_stream(u), _encode_stream(v), _encode_stream(eids))
    raw = b"".join(blobs)
    meta = {
        "edges": int(np.asarray(eids).shape[0]),
        "nbytes": [len(b) for b in blobs],
        "sha1": _sha1(raw),
    }
    return raw, meta


def _fsync_write(path: Path | str, raw: bytes) -> None:
    with open(path, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())


def _manifest_dict(*, num_vertices: int, num_edges: int,
                   num_partitions: int, rounds: int, leftover: int,
                   vparts_sum: int, edges_per_part, replicas_sha1: str,
                   parts_meta: list, config_fingerprint, graph_fingerprint,
                   ) -> dict:
    """The manifest in its one canonical key order — ``json.dumps`` of
    this dict must produce identical bytes from both save paths."""
    return {
        "version": ARTIFACT_VERSION,
        "num_vertices": int(num_vertices), "num_edges": int(num_edges),
        "num_partitions": int(num_partitions),
        "rounds": int(rounds), "leftover": int(leftover),
        "replication_factor": float(vparts_sum / max(num_vertices, 1)),
        "edges_per_part": [int(c) for c in edges_per_part],
        "replicas_sha1": replicas_sha1,
        "partitions": parts_meta,
        "config_fingerprint": config_fingerprint,
        "graph_fingerprint": graph_fingerprint,
    }


def save_artifact(dirpath: str | os.PathLike, result,
                  edges: np.ndarray, num_vertices: int,
                  config_fingerprint: str | None = None,
                  graph_fingerprint: str | None = None) -> "PartitionArtifact":
    """Persist ``result`` (+ the edges it partitioned) under ``dirpath``.

    ``result`` is a :class:`~repro_torch.core.partitioner.PartitionResult` (or
    anything exposing its fields).  This is the single-writer path; it
    reads the full ``edge_part``, so multi-controller drivers use the
    cooperative protocol below instead.
    """
    edges = np.asarray(edges)
    edge_part = np.asarray(result.edge_part)
    vparts = np.asarray(result.vparts, bool)
    n = int(num_vertices)
    m = int(edges.shape[0])
    p_num = int(vparts.shape[1])
    if edge_part.shape[0] != m:
        raise ValueError(f"edge_part has {edge_part.shape[0]} entries for "
                         f"{m} edges")
    if (edge_part < 0).any():
        raise ValueError("artifact requires a complete assignment — run the "
                         "cleanup pass first (finalize the driver)")

    final = Path(dirpath)
    tmp = final.parent / f".tmp_{final.name}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    # one stable sort gives every partition's (ascending) eid list — not
    # P full scans of the M-element assignment array; the ids in the
    # narrowest unsigned type that holds them: numpy's stable sort of 8- and
    # 16-bit keys is a radix sort (~6x its merge sort of int32 at 64 M
    # edges), and the order is the same
    keys = edge_part.astype(np.min_scalar_type(max(p_num - 1, 0)))
    order = np.argsort(keys, kind="stable")
    bounds = np.searchsorted(edge_part[order],
                             np.arange(p_num + 1, dtype=np.int64))

    def write_part(p: int) -> dict:
        eids = order[bounds[p]:bounds[p + 1]]
        e = edges[eids]
        raw, meta = _encode_partition(e[:, 0], e[:, 1], eids)
        _fsync_write(tmp / f"part_{p:05d}.bin", raw)
        return meta

    parts_meta = _each_part(write_part, range(p_num))

    rep_raw = np.packbits(vparts, axis=None).tobytes()
    _fsync_write(tmp / "replicas.bin", rep_raw)

    manifest = _manifest_dict(
        num_vertices=n, num_edges=m, num_partitions=p_num,
        rounds=result.rounds, leftover=result.leftover,
        vparts_sum=int(vparts.sum()), edges_per_part=result.edges_per_part,
        replicas_sha1=_sha1(rep_raw), parts_meta=parts_meta,
        config_fingerprint=config_fingerprint,
        graph_fingerprint=graph_fingerprint)
    _fsync_write(tmp / MANIFEST, json.dumps(manifest).encode())
    publish_dir(tmp, final)
    return PartitionArtifact(final)


# ---------------------------------------------------------------------------
# cooperative multi-writer save (sharded finalize epilogue)
# ---------------------------------------------------------------------------

def _shared_tmp(dirpath: str | os.PathLike) -> Path:
    final = Path(dirpath)
    return final.parent / f".tmp_{final.name}"


def begin_shared_artifact(dirpath: str | os.PathLike) -> Path:
    """Writer-0 half: create (reclaiming any torn leftover) the shared
    dot-prefixed staging dir every host writes into."""
    tmp = _shared_tmp(dirpath)
    if tmp.exists():
        shutil.rmtree(tmp)                 # leftover of a killed save
    tmp.mkdir(parents=True)
    return tmp


def write_artifact_contrib(dirpath: str | os.PathLike, host: int,
                           contribs: dict) -> None:
    """Any host: spill its slices' per-partition contributions.

    ``contribs[p] = (eids, u, v)`` — this host's partition-``p`` edges
    in ascending-eid order (the reference's
    ``runtime.finalize.partition_contribs`` makes them).
    Raw layout per file: int64 eids ‖ int32 u ‖ int32 v, so readers
    recover the count from the byte length alone.  Every host writes a
    file for every partition (possibly empty) — a missing file at encode
    time means a torn stage, not an empty contribution.
    """
    tmp = _shared_tmp(dirpath)
    for p, (eids, u, v) in contribs.items():
        raw = (np.ascontiguousarray(eids, np.int64).tobytes()
               + np.ascontiguousarray(u, np.int32).tobytes()
               + np.ascontiguousarray(v, np.int32).tobytes())
        _fsync_write(tmp / f".contrib_h{host:03d}_p{p:05d}.bin", raw)


def _read_contrib(tmp: Path, host: int, p: int,
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    path = tmp / f".contrib_h{host:03d}_p{p:05d}.bin"
    if not path.exists():
        raise IOError(f"multi-writer artifact: host {host} never staged "
                      f"its partition {p} contribution — torn stage")
    raw = path.read_bytes()
    k = len(raw) // 16
    eids = np.frombuffer(raw[:8 * k], np.int64)
    u = np.frombuffer(raw[8 * k:12 * k], np.int32)
    v = np.frombuffer(raw[12 * k:16 * k], np.int32)
    return eids, u, v


def encode_shared_parts(dirpath: str | os.PathLike, host: int,
                        parts: list, num_hosts: int,
                        threads: int | None = None) -> dict:
    """Any host, after every contribution staged: merge all hosts' spills
    for the partitions it owns, encode the ``part_<p>.bin`` shards, and
    stage a per-host meta manifest.  The partitions encode ``threads`` at
    a time (at most 8; the default is 8 or the host's core count), so the
    peak memory is O(threads · max |E_p|)."""
    threads = (_THREADS if threads is None
               else max(1, min(threads, _MAX_THREADS)))
    tmp = _shared_tmp(dirpath)

    def encode_part(p: int) -> dict:
        cols = [_read_contrib(tmp, h, p) for h in range(num_hosts)]
        eids = np.concatenate([c[0] for c in cols])
        u = np.concatenate([c[1] for c in cols])
        v = np.concatenate([c[2] for c in cols])
        # hosts own interleaved eid ranges; merge back to the ascending
        # eid order the single-writer path produces (one host's
        # contribution already has it)
        if eids.size > 1 and not bool((eids[1:] > eids[:-1]).all()):
            order = np.argsort(eids, kind="stable")
            eids, u, v = eids[order], u[order], v[order]
        raw, meta = _encode_partition(u, v, eids)
        _fsync_write(tmp / f"part_{p:05d}.bin", raw)
        return meta

    metas = {str(p): meta for p, meta in zip(
        parts, _each_part(encode_part, parts, threads))}
    _fsync_write(tmp / f".artmeta_h{host:03d}.json",
                 json.dumps(metas).encode())
    return metas


def publish_shared_artifact(dirpath: str | os.PathLike, *,
                            num_vertices: int, num_edges: int,
                            num_partitions: int, num_hosts: int,
                            vparts: np.ndarray, edges_per_part,
                            rounds: int, leftover: int,
                            config_fingerprint: str | None = None,
                            graph_fingerprint: str | None = None,
                            ) -> "PartitionArtifact":
    """Writer-0, after every host encoded: merge the per-host metas into
    the canonical manifest, write the replica map, clean the staging
    spills and publish atomically.  A partition nobody encoded — or eid
    streams that do not cover every edge — fails loudly instead of
    publishing a torn artifact."""
    tmp = _shared_tmp(dirpath)
    merged: list = [None] * num_partitions
    for hp in sorted(tmp.glob(".artmeta_h*.json")):
        for p, meta in json.loads(hp.read_text()).items():
            merged[int(p)] = meta
    missing = [p for p, m in enumerate(merged) if m is None]
    if missing:
        raise IOError(f"multi-writer artifact: no host encoded partitions "
                      f"{missing} — refusing to publish a torn artifact")
    covered = sum(m["edges"] for m in merged)
    if covered != int(num_edges):
        raise IOError(f"multi-writer artifact: partition shards cover "
                      f"{covered} of {num_edges} edges — refusing to "
                      f"publish a torn artifact")

    vparts = np.asarray(vparts, bool)
    rep_raw = np.packbits(vparts, axis=None).tobytes()
    _fsync_write(tmp / "replicas.bin", rep_raw)
    manifest = _manifest_dict(
        num_vertices=num_vertices, num_edges=num_edges,
        num_partitions=num_partitions, rounds=rounds, leftover=leftover,
        vparts_sum=int(vparts.sum()), edges_per_part=edges_per_part,
        replicas_sha1=_sha1(rep_raw), parts_meta=merged,
        config_fingerprint=config_fingerprint,
        graph_fingerprint=graph_fingerprint)
    for leftover_file in list(tmp.glob(".contrib_h*")) \
            + list(tmp.glob(".artmeta_h*")):
        leftover_file.unlink()
    _fsync_write(tmp / MANIFEST, json.dumps(manifest).encode())
    publish_dir(tmp, Path(dirpath))
    return PartitionArtifact(dirpath)


def load_artifact(dirpath: str | os.PathLike) -> "PartitionArtifact":
    return PartitionArtifact(dirpath)


class PartitionArtifact:
    """Loader over a saved partition artifact directory.

    Per-partition access (:meth:`partition_edges`, :meth:`partition_eids`)
    decodes one shard; the whole-run views (:attr:`edge_part`,
    :attr:`edges`, :attr:`vparts`) assemble lazily and are cached.
    """

    def __init__(self, dirpath: str | os.PathLike):
        self.dir = Path(dirpath)
        self.manifest = json.loads((self.dir / MANIFEST).read_text())
        if self.manifest.get("version") != ARTIFACT_VERSION:
            raise ValueError(f"{self.dir}: unsupported artifact version "
                             f"{self.manifest.get('version')}")
        self.num_vertices = int(self.manifest["num_vertices"])
        self.num_edges = int(self.manifest["num_edges"])
        self.num_partitions = int(self.manifest["num_partitions"])
        self.edges_per_part = np.asarray(self.manifest["edges_per_part"],
                                         np.int32)
        self.rounds = int(self.manifest["rounds"])
        self.leftover = int(self.manifest["leftover"])
        self.replication_factor = float(self.manifest["replication_factor"])
        self._cache: dict = {}

    def _part_blobs(self, p: int, verify: bool = True,
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        meta = self.manifest["partitions"][p]
        raw = (self.dir / f"part_{p:05d}.bin").read_bytes()
        if verify and _sha1(raw) != meta["sha1"]:
            raise IOError(f"checksum mismatch in partition {p} shard")
        k = meta["edges"]
        n0, n1, n2 = meta["nbytes"]
        u = _decode_stream(raw[:n0], k)
        v = _decode_stream(raw[n0:n0 + n1], k)
        eids = _decode_stream(raw[n0 + n1:n0 + n1 + n2], k)
        return u, v, eids

    def partition_edges(self, p: int) -> np.ndarray:
        """(|E_p|, 2) int32 edge endpoints of partition ``p``."""
        u, v, _ = self._part_blobs(p)
        return np.stack([u, v], axis=1).astype(np.int32)

    def partition_eids(self, p: int) -> np.ndarray:
        """Sorted global edge ids of partition ``p``."""
        return self._part_blobs(p)[2].astype(np.int64)

    def _assemble(self) -> None:
        """One pass over the partition shards fills both whole-run views —
        consumers that want ``edge_part`` *and* ``edges`` (``result()``,
        ``sharded_graph()``) must not decode every shard twice."""
        if "edge_part" in self._cache:
            return
        part = np.full(self.num_edges, -1, np.int32)
        edges = np.empty((self.num_edges, 2), np.int32)

        def fill(p: int) -> None:
            # partitions hold disjoint eids, so the threads' writes never
            # meet
            u, v, eids = self._part_blobs(p)
            part[eids] = p
            edges[eids, 0] = u
            edges[eids, 1] = v

        _each_part(fill, range(self.num_partitions))
        if not (part >= 0).all():
            # a real integrity check, not an assert — it must survive -O:
            # uncovered eids would surface as -1 assignments plus
            # uninitialized edge rows in every downstream consumer
            raise IOError(f"{self.dir}: partition eid streams cover only "
                          f"{int((part >= 0).sum())} of {self.num_edges} "
                          f"edges")
        self._cache["edge_part"] = part
        self._cache["edges"] = edges

    @property
    def edge_part(self) -> np.ndarray:
        """(M,) int32 — reassembled from the per-partition eid streams."""
        self._assemble()
        return self._cache["edge_part"]

    @property
    def edges(self) -> np.ndarray:
        """(M, 2) int32 — reassembled in global edge-id order."""
        self._assemble()
        return self._cache["edges"]

    @property
    def vparts(self) -> np.ndarray:
        """(N, P) bool vertex replica map."""
        if "vparts" not in self._cache:
            raw = (self.dir / "replicas.bin").read_bytes()
            if _sha1(raw) != self.manifest["replicas_sha1"]:
                raise IOError("checksum mismatch in replica map")
            bits = np.unpackbits(np.frombuffer(raw, np.uint8),
                                 count=self.num_vertices
                                 * self.num_partitions)
            self._cache["vparts"] = bits.reshape(
                self.num_vertices, self.num_partitions).astype(bool)
        return self._cache["vparts"]

    def replica_counts(self) -> np.ndarray:
        """(N,) int32 per-vertex replica count — the paper's replication
        cost, and the serving layer's per-query fan-out upper bound
        (a serving layer routes a vertex query only to partitions in its
        replica set, so fan-out ≤ this by construction)."""
        return self.vparts.sum(axis=1).astype(np.int32)

    def partitions_of(self, v: int) -> np.ndarray:
        """The partitions holding a replica of vertex ``v`` — the
        serving fan-out set.  Union of ``neighbors(p, v)`` over exactly
        these partitions is ``v``'s full adjacency (vertex-cut
        invariant: ``v ∈ p`` iff ``p`` owns an edge incident to
        ``v``)."""
        return np.flatnonzero(self.vparts[int(v)])

    def boundary_vertices(self) -> np.ndarray:
        """Vertices replicated into >1 partition (the cut set) —
        exactly the queries that fan out across a serving gang."""
        return np.flatnonzero(self.vparts.sum(axis=1) > 1)

    def result(self):
        """Reconstruct the :class:`PartitionResult` (bit-identical)."""
        # lazy: keep the artifact store importable without torch
        from repro_torch.core.partitioner import PartitionResult

        return PartitionResult(self.edge_part, self.vparts,
                               self.edges_per_part.copy(), self.rounds,
                               self.leftover)

    def sharded_graph(self, num_devices: int | None = None):
        """Feed the GAS engine directly from the artifact — the
        "no re-partitioning" hand-off (``apps.engine.build_sharded_graph``).
        """
        from repro_torch.apps.engine import build_sharded_graph

        d = num_devices or self.num_partitions
        return build_sharded_graph(self.edges, self.edge_part,
                                   self.num_vertices, d)


__all__ = ["ARTIFACT_VERSION", "PartitionArtifact",
           "begin_shared_artifact", "encode_shared_parts", "load_artifact",
           "publish_shared_artifact", "save_artifact",
           "write_artifact_contrib"]
