"""Undirected graph container in CSR form, as torch tensors on one device.

The same canonical representation as the reference package: an undirected
edge list expanded into 2M directed slots sorted by source vertex, with an
``adj_eid`` column mapping each directed slot back to its undirected edge.
The arrays are built on the host (``repro_torch.io.csr``) and moved to the
device once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.io.csr import canonicalize_host, csr_from_canonical


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
    """Build a Graph from an undirected edge list (host-side numpy), then
    move it to ``device`` (``None`` means the card)."""
    dev = resolve_device(device)
    if dedup:
        edges, n = canonicalize_host(edges, num_vertices)
    else:
        edges = np.asarray(edges, dtype=np.int32)
        n = int(num_vertices if num_vertices is not None
                else (edges.max() + 1 if edges.size else 0))
    a = csr_from_canonical(edges, n)
    return Graph(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                   for x in a))


def as_graph(source, num_vertices: int | None = None, device=None) -> Graph:
    """Coerce a Graph (returned as-is) or an edge ndarray to a Graph."""
    if isinstance(source, Graph):
        return source
    if isinstance(source, np.ndarray):
        return from_edges(source, num_vertices, device=device)
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
