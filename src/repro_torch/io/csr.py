"""Host-side numpy CSR builders for the port's :class:`Graph`.

A copy of the reference package's ``io/csr.py`` canonicalize + CSR pair:
the port's graphs must be bit-identical to the reference's (same edge
order, same slot order), which the tests check array by array.  numpy
only, no torch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CSRArrays(NamedTuple):
    """Host-side mirror of :class:`repro_torch.core.graph.Graph` (numpy)."""

    edges: np.ndarray       # (M, 2) int32 canonical undirected edges
    indptr: np.ndarray      # (N+1,) int32
    adj_dst: np.ndarray     # (2M,) int32
    adj_eid: np.ndarray     # (2M,) int32
    slot_src: np.ndarray    # (2M,) int32
    degree: np.ndarray      # (N,) int32


def canonicalize_host(edges: np.ndarray, num_vertices: int | None = None,
                      ) -> tuple[np.ndarray, int]:
    """Drop self loops + duplicate edges, canonicalize u < v. numpy, host-side."""
    edges = np.asarray(edges, dtype=np.int64)
    if edges.size == 0:
        return np.zeros((0, 2), np.int32), int(num_vertices or 0)
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    u, v = u[keep], v[keep]
    n = int(num_vertices if num_vertices is not None
            else (max(u.max(), v.max()) + 1 if u.size else 0))
    key = u * n + v
    _, idx = np.unique(key, return_index=True)
    out = np.stack([u[idx], v[idx]], axis=1).astype(np.int32)
    return out, n


def csr_from_canonical(edges: np.ndarray, n: int) -> CSRArrays:
    """CSR over directed slots from a loop-free edge list (host-side numpy).

    The slot order is a stable sort of ``concat([u, v])`` by source: row
    ``s`` lists forward slots (edges with ``u == s``, in edge order) before
    backward slots (edges with ``v == s``, in edge order).
    """
    m = edges.shape[0]
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    eid = np.concatenate([np.arange(m, dtype=np.int32)] * 2)
    order = np.argsort(src, kind="stable")
    src, dst, eid = src[order], dst[order], eid[order]
    degree = np.bincount(src, minlength=n).astype(np.int32)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(degree, out=indptr[1:])
    return CSRArrays(
        edges=np.asarray(edges, np.int32),
        indptr=indptr,
        adj_dst=dst.astype(np.int32),
        adj_eid=eid.astype(np.int32),
        slot_src=src.astype(np.int32),
        degree=degree,
    )
