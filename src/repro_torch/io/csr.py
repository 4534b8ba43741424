"""Host-side numpy CSR builders for the port's :class:`Graph`.

A copy of the reference package's ``io/csr.py`` canonicalize + CSR pair
and its host 2D-hash (``grid_assign_host``): the port's graphs and edge
shards must be bit-identical to the reference's (same edge order, same
slot order, same device of each edge), which the tests check array by
array.  numpy only, no torch.
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


def to_numpy(x) -> np.ndarray:
    """A host numpy array of ``x``: a torch tensor on any device (copied
    to the host), or anything ``np.asarray`` takes.  Duck-typed, so the
    store's modules need no torch."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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


# ---------------------------------------------------------------------------
# Host copy of the 2D-hash edge distribution (paper §4), numpy uint32 as in
# the reference package; ``core.graph.hash_u32``/``grid_assign`` are the
# torch twins.
# ---------------------------------------------------------------------------

def _mix_host(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = (x ^ (x >> 16)) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * np.uint32(0x846CA68B)
    return x ^ (x >> 16)


def hash_u32_host(x: np.ndarray, salt: int = 0) -> np.ndarray:
    off = np.uint32((0x9E3779B9 * salt) & 0xFFFFFFFF)
    return _mix_host(np.asarray(x).astype(np.uint32) + off)


def grid_assign_host(edges: np.ndarray, num_devices: int,
                     salt: int = 0) -> np.ndarray:
    """2D-hash (grid) edge→device assignment over an r×c grid, r the
    largest divisor of D at most √D.  Returns (M,) int32."""
    r = int(np.floor(np.sqrt(num_devices)))
    while num_devices % r:
        r -= 1
    c = num_devices // r

    def cell(col, s, k):
        # a hash taken mod 1 is 0: a grid side of 1 needs no hash
        if k == 1:
            return np.zeros(edges.shape[0], np.int32)
        return (hash_u32_host(edges[:, col], s) % np.uint32(k)).astype(
            np.int32)

    return cell(0, salt, r) * c + cell(1, salt + 1, c)
