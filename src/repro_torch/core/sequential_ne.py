"""Sequential NE [Zhang et al., KDD'17] — the offline single-machine oracle.

The paper's Table 4 compares Distributed NE against this algorithm: one
partition is expanded at a time (not in parallel), always popping the single
min-D_rest boundary vertex and applying the same one-hop + two-hop rules.
Pure numpy + heapq; intended for small/medium graphs in tests & benchmarks.
A copy of the reference package's ``core/sequential_ne.py``: the same
assignment from the same edges and seed.
"""
from __future__ import annotations

import heapq

import numpy as np


def sequential_ne(edges: np.ndarray, num_vertices: int, p: int,
                  alpha: float = 1.1, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edges = np.asarray(edges, dtype=np.int64)
    m = edges.shape[0]
    n = num_vertices
    limit = alpha * m / p

    # CSR over directed slots
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    eid = np.concatenate([np.arange(m)] * 2)
    order = np.argsort(src, kind="stable")
    src, dst, eid = src[order], dst[order], eid[order]
    deg = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])

    edge_part = np.full(m, -1, np.int32)
    degree_rest = deg.copy()
    assigned = 0

    for part in range(p):
        if assigned == m:
            break
        in_part = np.zeros(n, bool)      # V(E_part)
        heap: list[tuple[int, int]] = []
        count = 0
        while count <= limit and assigned < m:
            # pop min-D_rest boundary vertex, else random re-seed
            vmin = -1
            while heap:
                d, cand = heapq.heappop(heap)
                if in_part[cand] and degree_rest[cand] == d and d > 0:
                    vmin = cand
                    break
            if vmin < 0:
                rest = np.nonzero(degree_rest > 0)[0]
                if rest.size == 0:
                    break
                vmin = int(rng.choice(rest))
            # one-hop: allocate all of vmin's unallocated edges
            sl = slice(indptr[vmin], indptr[vmin + 1])
            new_nbrs = []
            for s in range(sl.start, sl.stop):
                e = eid[s]
                if edge_part[e] < 0:
                    edge_part[e] = part
                    assigned += 1
                    count += 1
                    u = dst[s]
                    degree_rest[vmin] -= 1
                    degree_rest[u] -= 1
                    if not in_part[u]:
                        in_part[u] = True
                        new_nbrs.append(u)
            in_part[vmin] = True
            # two-hop: free edges among the new boundary's neighbors
            for u in new_nbrs:
                for s in range(indptr[u], indptr[u + 1]):
                    e = eid[s]
                    w = dst[s]
                    if edge_part[e] < 0 and in_part[w]:
                        edge_part[e] = part
                        assigned += 1
                        count += 1
                        degree_rest[u] -= 1
                        degree_rest[w] -= 1
            for u in new_nbrs:
                if degree_rest[u] > 0:
                    heapq.heappush(heap, (int(degree_rest[u]), int(u)))
            if degree_rest[vmin] > 0:
                heapq.heappush(heap, (int(degree_rest[vmin]), int(vmin)))
    # leftovers (last partition hit its cap): round-robin least-loaded
    rem = np.nonzero(edge_part < 0)[0]
    if rem.size:
        counts = np.bincount(edge_part[edge_part >= 0], minlength=p)
        for e in rem:
            t = int(np.argmin(counts))
            edge_part[e] = t
            counts[t] += 1
    return edge_part
