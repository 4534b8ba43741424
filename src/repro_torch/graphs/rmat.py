"""R-MAT recursive graph generator [Chakrabarti+ SDM'04] (paper §7.1).

Graph500 parameters (a,b,c,d) = (0.57, 0.19, 0.19, 0.05); edge factor EF
gives M = EF·2^scale sampled edges before dedup.  A copy of the reference
package's one-shot generator: the same seed gives the same edges, which
the tests check.  Vectorized numpy on the host.
"""
from __future__ import annotations

import numpy as np

GRAPH500 = (0.57, 0.19, 0.19, 0.05)


def edge_dtype(scale: int) -> np.dtype:
    """int32 while vertex ids fit (scale < 31), int64 above."""
    return np.dtype(np.int32 if scale < 31 else np.int64)


def _rmat_bits(rng: np.random.Generator, count: int, scale: int,
               probs: tuple[float, float, float, float], dtype: np.dtype,
               ) -> tuple[np.ndarray, np.ndarray]:
    a, b, c, d = probs
    u = np.zeros(count, dtype)
    v = np.zeros(count, dtype)
    for _ in range(scale):
        r = rng.random(count)
        right = r >= a + c          # column bit: quadrants b, d
        lower = ((r >= a) & (r < a + c)) | (r >= a + b + c)  # row bit: c, d
        u = (u << 1) | lower
        v = (v << 1) | right
    return u, v


def rmat_edges(scale: int, edge_factor: int, seed: int = 0,
               probs: tuple[float, float, float, float] = GRAPH500,
               ) -> np.ndarray:
    n = 1 << scale
    m = n * edge_factor
    dtype = edge_dtype(scale)
    rng = np.random.default_rng(seed)
    u, v = _rmat_bits(rng, m, scale, probs, dtype)
    # random vertex relabel so degree order isn't the identity
    perm = rng.permutation(n).astype(dtype)
    return np.stack([perm[u], perm[v]], axis=1)


def rmat(scale: int, edge_factor: int, seed: int = 0, device=None):
    """RMAT graph as a port :class:`~repro_torch.core.graph.Graph` on
    ``device`` (``None`` means the card)."""
    from repro_torch.core.graph import from_edges

    return from_edges(rmat_edges(scale, edge_factor, seed),
                      num_vertices=1 << scale, device=device)
