"""R-MAT recursive graph generator [Chakrabarti+ SDM'04] (paper §7.1).

Graph500 parameters (a,b,c,d) = (0.57, 0.19, 0.19, 0.05); edge factor EF
gives M = EF·2^scale sampled edges before dedup.  A copy of the reference
package's generators: the same seed gives the same edges, which the tests
check.  Vectorized numpy on the host.

* :func:`rmat_edges` — the one-shot array;
* :func:`rmat_edge_chunks` — a chunked generator with per-chunk spawned
  PRNG streams, the producer behind ``repro_torch.io.spill_rmat``: no
  chunk depends on the full edge list, so generation RSS is
  O(chunk_size).  The stream is deterministic for a fixed ``(seed,
  chunk_size)`` but is a *different* (equally distributed) sample than
  ``rmat_edges(seed)``.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

GRAPH500 = (0.57, 0.19, 0.19, 0.05)

DEFAULT_CHUNK = 1 << 20


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


def rmat_edge_chunks(scale: int, edge_factor: int, seed: int = 0,
                     chunk_size: int = DEFAULT_CHUNK,
                     probs: tuple[float, float, float, float] = GRAPH500,
                     ) -> Iterator[np.ndarray]:
    """Yield (k, 2) RMAT edge chunks without materializing the edge list.

    Each chunk draws from its own PRNG stream spawned off ``seed`` (the
    relabel permutation gets the first child), so the sequence is
    reproducible chunk-by-chunk and never needs a length-M random buffer.
    """
    n = 1 << scale
    m = n * edge_factor
    dtype = edge_dtype(scale)
    num_chunks = (m + chunk_size - 1) // chunk_size
    children = np.random.SeedSequence(seed).spawn(num_chunks + 1)
    perm = np.random.default_rng(children[0]).permutation(n).astype(dtype)
    for i in range(num_chunks):
        count = min(chunk_size, m - i * chunk_size)
        rng = np.random.default_rng(children[i + 1])
        u, v = _rmat_bits(rng, count, scale, probs, dtype)
        yield np.stack([perm[u], perm[v]], axis=1)


def rmat(scale: int, edge_factor: int, seed: int = 0, device=None):
    """RMAT graph as a port :class:`~repro_torch.core.graph.Graph` on
    ``device`` (``None`` means the card)."""
    from repro_torch.core.graph import from_edges

    return from_edges(rmat_edges(scale, edge_factor, seed),
                      num_vertices=1 << scale, device=device)
