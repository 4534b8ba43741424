"""Spillable RMAT: generate → disk, chunk by chunk, never the full list.

``spill_rmat`` is the scale unlock: an RMAT sample is written straight to
an :class:`EdgeFile` as it is generated, so peak RSS is O(chunk_size) and
scale-22+ graphs become benchable on a laptop.  Compose with
``canonicalize_stream`` + ``graph_from_edgefile`` / ``pack_csr`` for the
full out-of-core build, or hand the canonical file directly to
``partition_spmd`` (which needs no CSR at all).
"""
from __future__ import annotations

import os

from repro_torch.graphs.rmat import (DEFAULT_CHUNK, GRAPH500, edge_dtype,
                                     rmat_edge_chunks)
from repro_torch.io.edgefile import EdgeFile, EdgeFileWriter


def spill_rmat(path: str | os.PathLike, scale: int, edge_factor: int,
               seed: int = 0, chunk_size: int = DEFAULT_CHUNK,
               block_size: int | None = None,
               probs: tuple[float, float, float, float] = GRAPH500,
               ) -> EdgeFile:
    """Generate an RMAT edge sample directly into an EdgeFile at ``path``.

    The sample matches ``rmat_edge_chunks(scale, edge_factor, seed,
    chunk_size)`` exactly; it is *raw* (duplicates and self-loops included,
    like ``rmat_edges``) — canonicalize out-of-core before building a CSR.
    """
    with EdgeFileWriter(path, num_vertices=1 << scale,
                        block_size=block_size or chunk_size,
                        dtype=edge_dtype(scale)) as w:
        for chunk in rmat_edge_chunks(scale, edge_factor, seed=seed,
                                      chunk_size=chunk_size, probs=probs):
            w.append(chunk)
    return EdgeFile(os.fspath(path))


def spill_canonical_rmat(dirpath: str | os.PathLike, scale: int,
                         edge_factor: int, seed: int = 0,
                         chunk_size: int = DEFAULT_CHUNK,
                         probs: tuple[float, float, float, float] = GRAPH500,
                         ) -> EdgeFile:
    """``spill_rmat`` + out-of-core canonicalization in one call.

    Writes ``raw.edges`` and ``canonical.edges`` under ``dirpath`` and
    returns the canonical handle — the one-liner behind the streaming
    quickstart (``spill → partition`` without materializing edges).
    """
    from repro_torch.io.stream import canonicalize_stream

    dirpath = os.fspath(dirpath)
    os.makedirs(dirpath, exist_ok=True)
    raw_path = os.path.join(dirpath, "raw.edges")
    with spill_rmat(raw_path, scale, edge_factor, seed=seed,
                    chunk_size=chunk_size, probs=probs) as raw:
        can = canonicalize_stream(raw, os.path.join(dirpath,
                                                    "canonical.edges"),
                                  num_vertices=1 << scale,
                                  chunk_size=chunk_size)
    os.remove(raw_path)
    return can
