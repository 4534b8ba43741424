"""Distributed edge-partitioning baselines the paper compares against (§7.1).

Hash family (vectorized, O(M)): 1D Random, 2D Grid, DBH [Xie+ NIPS'14],
as torch ops on the graph's device.  Streaming family (one edge a step in
a hashed stream order): HDRF [Petroni+ CIKM'15] and Oblivious
(PowerGraph's greedy [Gonzalez+ OSDI'12]), through the
``kernels.stream`` scans: a CUDA kernel for a graph on the card, their
plain versions for one on the CPU.  A port of the reference package's
``core/baselines.py``: every function returns the reference's (M,) int32
assignment, bit for bit, as a host numpy array.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph, grid_assign, hash_u32
from repro_torch.kernels.stream import ops as stream_ops

# --------------------------------------------------------------------------
# Hash-based partitioners
# --------------------------------------------------------------------------


def _host(parts: torch.Tensor) -> np.ndarray:
    return parts.to(torch.int32).cpu().numpy()


def random_1d(g: Graph, p: int, seed: int = 0) -> np.ndarray:
    eid = torch.arange(g.num_edges, dtype=torch.int64, device=g.device)
    return _host(hash_u32(eid, seed) % p)


def grid_2d(g: Graph, p: int, seed: int = 0) -> np.ndarray:
    """2D-hash / Grid: partition grid r×c, row by h(u), col by h(v)."""
    return _host(grid_assign(g.edges, p, salt=seed))


def dbh(g: Graph, p: int, seed: int = 0) -> np.ndarray:
    """Degree-Based Hashing: hash the lower-degree endpoint."""
    u, v = g.edges[:, 0].long(), g.edges[:, 1].long()
    du, dv = g.degree[u], g.degree[v]
    pick = torch.where((du < dv) | ((du == dv) & (u < v)), u, v)
    return _host(hash_u32(pick, seed) % p)


# --------------------------------------------------------------------------
# Streaming partitioners (kernels.stream)
# --------------------------------------------------------------------------

def stream_order(g: Graph, seed: int) -> torch.Tensor:
    """The stream order: edge ids sorted by ``hash_u32(id, seed)``, a
    bijection on uint32, so no two keys tie and any sort gives it."""
    eid = torch.arange(g.num_edges, dtype=torch.int64, device=g.device)
    return torch.argsort(hash_u32(eid, seed))


def _unstream(parts: torch.Tensor, order: torch.Tensor) -> np.ndarray:
    out = torch.empty_like(parts)
    out[order] = parts
    return _host(out)


def hdrf(g: Graph, p: int, lam_balance: float = 1.0, seed: int = 0,
         ) -> np.ndarray:
    order = stream_order(g, seed)
    parts = stream_ops.hdrf_scan(g.edges[order], p, g.num_vertices,
                                 lam_balance)
    return _unstream(parts, order)


def oblivious(g: Graph, p: int, seed: int = 0, alpha: float = 1.1
              ) -> np.ndarray:
    order = stream_order(g, seed)
    limit = int(alpha * g.num_edges / p) + 1
    parts = stream_ops.oblivious_scan(g.edges[order], p, g.num_vertices,
                                      limit)
    return _unstream(parts, order)


PARTITIONERS = {
    "random": random_1d,
    "grid": grid_2d,
    "dbh": dbh,
    "hdrf": hdrf,
    "oblivious": oblivious,
}
