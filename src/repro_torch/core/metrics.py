"""Partition-quality metrics (paper §2.1, §7.6) — host-side numpy.

A copy of the reference package's metrics, with the same expressions, so
the port's stats equal the reference's to the last bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PartitionStats:
    replication_factor: float   # (1/|V|) Σ_p |V(E_p)|      (paper Eq. 1)
    edge_balance: float         # max|E_p| / mean|E_p|      (paper §7.6 EB)
    vertex_balance: float       # max|V(E_p)| / mean        (paper §7.6 VB)
    max_part_edges: int
    replicas_total: int         # Σ_p |V(E_p)|
    num_partitions: int


def vertex_replicas(edges: np.ndarray, edge_part: np.ndarray,
                    num_vertices: int, num_partitions: int) -> np.ndarray:
    """|V(E_p)| per partition, computed from the edge assignment alone."""
    edges = np.asarray(edges)
    ep = np.asarray(edge_part).astype(np.int64)
    assert (ep >= 0).all(), "unallocated edges"
    pairs = np.concatenate([edges[:, 0].astype(np.int64) * num_partitions + ep,
                            edges[:, 1].astype(np.int64) * num_partitions + ep])
    uniq = np.unique(pairs)
    return np.bincount((uniq % num_partitions).astype(np.int64),
                       minlength=num_partitions)


def stats_from_counts(replicas_per_part: np.ndarray,
                      edges_per_part: np.ndarray,
                      num_vertices: int) -> PartitionStats:
    """:class:`PartitionStats` from per-partition replica counts
    ``|V(E_p)|`` and edge counts ``|E_p|`` alone."""
    vrep = np.asarray(replicas_per_part, np.int64)
    ecnt = np.asarray(edges_per_part, np.int64)
    rf = float(vrep.sum()) / float(num_vertices)
    eb = float(ecnt.max()) / max(float(ecnt.mean()), 1e-9)
    vb = float(vrep.max()) / max(float(vrep.mean()), 1e-9)
    return PartitionStats(rf, eb, vb, int(ecnt.max()), int(vrep.sum()),
                          int(ecnt.shape[0]))


def evaluate(edges: np.ndarray, edge_part: np.ndarray, num_vertices: int,
             num_partitions: int) -> PartitionStats:
    vrep = vertex_replicas(edges, edge_part, num_vertices, num_partitions)
    ecnt = np.bincount(np.asarray(edge_part), minlength=num_partitions)
    return stats_from_counts(vrep, ecnt, num_vertices)


def comm_volume_model(stats: PartitionStats, num_vertices: int,
                      feat_dim: int, bytes_per_el: int = 4) -> int:
    """Vertex-cut engine traffic per superstep = 2·Σ|V(E_p)|·d bytes:
    the mirror→master accumulate and the master→mirror broadcast, which is
    how replication factor turns into wire bytes (paper Table 5)."""
    return 2 * stats.replicas_total * feat_dim * bytes_per_el


def theorem1_upper_bound(num_vertices: int, num_edges: int,
                         num_partitions: int) -> float:
    """RF ≤ (|E| + |V| + |P|) / |V|   (paper Theorem 1)."""
    return (num_edges + num_vertices + num_partitions) / num_vertices
