"""Undirected graph container in CSR form, as torch tensors on one device.

The same canonical representation as the reference package: an undirected
edge list expanded into 2M directed slots sorted by source vertex, with an
``adj_eid`` column mapping each directed slot back to its undirected edge.
The arrays are built on the host (``repro_torch.io``: in memory, or
streamed from the store) and moved to the device once; an in-memory edge
list bound for the card is copied there once and built there
(:func:`from_edges`).

The import between this module and ``repro_torch.io`` goes both ways on
purpose, as in the reference: ``as_graph`` takes the store's handles, and
the store's device builders (``graph_from_edgefile``,
``PackedCSR.to_graph``, ``PackedCSR.shard_device``) stage through
``graph_from_csr`` / ``to_device`` here.  The io side imports this module
inside those functions only, which keeps ``repro_torch.io`` importable
without torch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.io.compress import PackedCSR
from repro_torch.io.csr import (CSRArrays, canonicalize_host,
                                csr_from_canonical, grid_assign_host)
from repro_torch.io.edgefile import EdgeFile
from repro_torch.io.stream import graph_from_edgefile

_MASK32 = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raises when there is none.  Callers that
    want the CPU ask for it (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the host")
    return dev


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph, CSR over directed slots (all int32, one device).

    Attributes:
      edges:    (M, 2) undirected edge endpoints (deduplicated, no loops).
      indptr:   (N+1,) CSR row pointers over the 2M directed slots.
      adj_dst:  (2M,) destination vertex of each directed slot.
      adj_eid:  (2M,) undirected edge id of each directed slot.
      slot_src: (2M,) source vertex of each directed slot (CSR-expanded).
      degree:   (N,) vertex degrees.
    """

    edges: torch.Tensor
    indptr: torch.Tensor
    adj_dst: torch.Tensor
    adj_eid: torch.Tensor
    slot_src: torch.Tensor
    degree: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def device(self) -> torch.device:
        return self.edges.device


def from_edges(edges: np.ndarray, num_vertices: int | None = None,
               device=None, dedup: bool = True) -> Graph:
    """Build a Graph from an undirected edge list (host-side numpy) on
    ``device`` (``None`` means the card).

    For the CPU the canonical form and the CSR are built on the host
    (``io.csr``); for the card the edge list is copied once and the same
    integer steps run there (:func:`graph_from_edges_tensor`), which
    gives the same Graph bit for bit."""
    dev = resolve_device(device)
    if dev.type != "cpu":
        e = torch.from_numpy(np.ascontiguousarray(edges)).to(dev)
        return graph_from_edges_tensor(e.reshape(-1, 2), num_vertices,
                                       dedup)
    if dedup:
        edges, n = canonicalize_host(edges, num_vertices)
    else:
        edges = np.asarray(edges, dtype=np.int32)
        n = int(num_vertices if num_vertices is not None
                else (edges.max() + 1 if edges.size else 0))
    return graph_from_csr(csr_from_canonical(edges, n), dev)


def graph_from_edges_tensor(edges: torch.Tensor,
                            num_vertices: int | None = None,
                            dedup: bool = True) -> Graph:
    """:func:`from_edges` on the device that holds ``edges`` ((M, 2), any
    integer type), with torch ops: u < v, loops dropped, the sorted unique
    u·n + v keys (``dedup``), then the directed slots stably sorted by
    source, as ``io.csr.canonicalize_host`` + ``csr_from_canonical`` do
    on the host.  Vertex ids must lie in [0, n)."""
    dev = edges.device
    e = edges.to(torch.int64)
    if dedup:
        u = torch.minimum(e[:, 0], e[:, 1])
        v = torch.maximum(e[:, 0], e[:, 1])
        keep = u != v
        u, v = u[keep], v[keep]
    else:
        u, v = e[:, 0], e[:, 1]
    del e
    n = (int(num_vertices) if num_vertices is not None
         else (int(torch.maximum(u.max(), v.max())) + 1 if u.numel()
               else 0))
    if u.numel() and (int(torch.minimum(u.min(), v.min())) < 0
                      or int(torch.maximum(u.max(), v.max())) >= n):
        raise ValueError(f"vertex ids outside [0, {n})")
    if dedup:
        key = torch.unique(u * n + v)                        # sorted
        u, v = key // n, key % n
        del key
    u, v = u.to(torch.int32), v.to(torch.int32)
    src, dst = torch.cat([u, v]), torch.cat([v, u])
    eid = torch.arange(u.numel(), dtype=torch.int32, device=dev).repeat(2)
    slot_src, order = torch.sort(src, stable=True)
    degree = torch.bincount(src, minlength=n).to(torch.int32)
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(degree, 0, dtype=torch.int32)
    return Graph(edges=torch.stack([u, v], dim=1), indptr=indptr,
                 adj_dst=dst[order], adj_eid=eid[order], slot_src=slot_src,
                 degree=degree)


def to_device(a: np.ndarray, device=None) -> torch.Tensor:
    """A host array as a tensor on ``device`` (``None`` means the card)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        resolve_device(device))


def graph_from_csr(a: CSRArrays, device=None) -> Graph:
    """The Graph of host CSR arrays, on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    return Graph(*(to_device(x, dev) for x in a))


def as_graph(source, num_vertices: int | None = None, device=None) -> Graph:
    """Coerce any graph source to a :class:`Graph` on ``device``.

    A Graph is returned as it is.  An edge ndarray is built with
    :func:`from_edges`, an ``EdgeFile`` streamed through the bit-identical
    out-of-core builder (``io.stream.graph_from_edgefile``) and a
    ``PackedCSR`` decompressed shard by shard (``PackedCSR.to_graph``).
    """
    if isinstance(source, Graph):
        return source
    if isinstance(source, np.ndarray):
        return from_edges(source, num_vertices, device=device)
    if isinstance(source, EdgeFile):
        return graph_from_edgefile(source, num_vertices=num_vertices,
                                   device=device)
    if isinstance(source, PackedCSR):
        if (num_vertices is not None
                and num_vertices != source.num_vertices):
            raise ValueError(f"num_vertices={num_vertices} conflicts with "
                             f"the packed file's {source.num_vertices}")
        return source.to_graph(device)
    raise TypeError(f"cannot build a Graph from {type(source).__name__}")


def exclusive_rank(cand: torch.Tensor, num_targets: int) -> torch.Tensor:
    """Per-item exclusive rank among earlier items with the same target.

    ``cand``: (K,) int32 target ids, negatives meaning "no target".
    Returns (K,) int32: how many earlier items share item i's target.
    Value at negative-target items is that of target 0; guard with the
    candidate mask as the callers do.

    The one-hot matrix is laid out (targets, K) so that the prefix sum
    runs along the last dimension: on the card torch scans an outer
    dimension with one thread per column, which is slow at K = 2^18.
    """
    targets = torch.arange(num_targets, dtype=cand.dtype, device=cand.device)
    onehot = targets[:, None] == cand[None, :]
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    return torch.gather(rank, 0, cand.clamp(min=0)[None, :].long())[0]


# ---------------------------------------------------------------------------
# 2D-hash initial distribution (paper §4): edges go to one process of a
# √D×√D grid by hashing both endpoints, so a vertex's replica locations
# follow from its id.  uint32 words live in int64 masked to 32 bits (torch
# uint32 lacks basic ops), as in ``repro_torch.random``.
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for x, c < 2^32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """Cheap deterministic integer hash (xorshift-multiply, 32-bit)."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def hash_u32(x: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """The reference's ``hash_u32``: int64 values in [0, 2^32)."""
    off = (0x9E3779B9 * salt) & _MASK32
    return _mix(((x.to(torch.int64) & _MASK32) + off) & _MASK32)


def grid_assign(edges: torch.Tensor, num_devices: int,
                salt: int = 0) -> torch.Tensor:
    """2D-hash (grid) edge→device assignment over an r×c grid, r the
    largest divisor of D at most √D.  Returns (M,) int32 ids."""
    r = int(np.floor(np.sqrt(num_devices)))
    while num_devices % r:
        r -= 1
    c = num_devices // r
    hu = hash_u32(edges[:, 0], salt) % r
    hv = hash_u32(edges[:, 1], salt + 1) % c
    return (hu * c + hv).to(torch.int32)


def shard_edges(edges: np.ndarray, num_devices: int, salt: int = 0,
                ) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Host-side 2D-hash distribution into equal-length padded shards.

    Returns (shards, masks, capacity, dev): shards is (D, C, 2) int32 with
    invalid rows = 0, masks is (D, C) bool, and dev is the (M,) int32
    per-edge device, so callers can stitch shard-order results back to
    edge order.  Shard ``d`` holds ``edges[dev == d]`` in edge order.
    """
    dev = grid_assign_host(edges, num_devices, salt=salt)
    counts = np.bincount(dev, minlength=num_devices)
    cap = int(counts.max()) if counts.size else 1
    shards = np.zeros((num_devices, cap, 2), np.int32)
    masks = np.zeros((num_devices, cap), bool)
    for d in range(num_devices):
        rows = edges[dev == d]
        shards[d, : rows.shape[0]] = rows
        masks[d, : rows.shape[0]] = True
    return shards, masks, cap, dev.astype(np.int32)
