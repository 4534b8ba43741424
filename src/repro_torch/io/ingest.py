"""Real-graph ingest: whitespace edge-list text → canonical EdgeFile.

The SNAP / KONECT / WebGraph-dump family of formats is a text file of
``src dst`` pairs, one edge per line, ``#``/``%`` comment headers, often
gzip-compressed.  :func:`ingest_text` turns one into the canonical
:class:`~repro_torch.io.edgefile.EdgeFile` with the same bounded-RSS
contract as the rest of ``repro_torch.io``: the text is parsed in
fixed-size line batches, vertex-id inference is a first streaming pass
(text files are re-readable, unlike a generator), and canonicalization
goes through the external-sort
:func:`~repro_torch.io.stream.canonicalize_stream` — the full edge list
(let alone a CSR) is never resident.  A copy of the reference package's
``io/ingest.py``: the ingested files are byte-identical.

Downstream everything speaks EdgeFile: ``partition``, ``partition_spmd``
and the runtime's ``PartitionDriver`` consume the ingested handle
unchanged.
"""
from __future__ import annotations

import gzip
import os
from typing import Iterator

import numpy as np

from repro_torch.io.edgefile import EdgeFile
from repro_torch.io.stream import DEFAULT_CHUNK, canonicalize_stream

DEFAULT_COMMENTS = ("#", "%")


def _open_text(path: str | os.PathLike):
    path = os.fspath(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, "rt", encoding="utf-8", errors="replace")


def iter_text_edges(path: str | os.PathLike,
                    chunk_size: int = DEFAULT_CHUNK,
                    comments: tuple[str, ...] = DEFAULT_COMMENTS,
                    ) -> Iterator[np.ndarray]:
    """Yield (k, 2) int64 chunks of ≤ ``chunk_size`` edges from a
    whitespace edge-list text file (``.gz`` transparently decompressed).

    Lines starting with any of ``comments`` (after lstrip) and blank
    lines are skipped; the first two whitespace-separated fields are the
    endpoints (SNAP files sometimes carry weights/timestamps in extra
    columns — ignored).  Malformed lines raise — a silently dropped edge
    would make the ingest unreproducible.
    """
    buf: list[list[int]] = []
    with _open_text(path) as fh:
        for lineno, line in enumerate(fh, 1):
            s = line.strip()
            if not s or s.startswith(comments):
                continue
            fields = s.split()
            if len(fields) < 2:
                raise ValueError(
                    f"{path}:{lineno}: expected 'src dst', got {s!r}")
            try:
                buf.append([int(fields[0]), int(fields[1])])
            except ValueError as exc:
                raise ValueError(
                    f"{path}:{lineno}: non-integer endpoint in {s!r}"
                ) from exc
            if len(buf) >= chunk_size:
                yield np.asarray(buf, dtype=np.int64)
                buf = []
    if buf:
        yield np.asarray(buf, dtype=np.int64)


def ingest_text(path: str | os.PathLike, out_path: str | os.PathLike,
                num_vertices: int | None = None,
                chunk_size: int = DEFAULT_CHUNK,
                comments: tuple[str, ...] = DEFAULT_COMMENTS,
                tmpdir: str | None = None) -> EdgeFile:
    """Ingest a whitespace edge-list text file into a canonical EdgeFile.

    Two streaming passes: pass 1 infers ``num_vertices`` (max non-loop
    endpoint + 1, exactly ``canonicalize_edges``'s rule) unless the
    caller supplies it — text is seekable so a second parse is cheaper
    than buffering; pass 2 feeds the line chunks straight into the
    external-sort canonicalizer (dedup, drop loops, ``u < v``, sorted).
    Peak RSS is O(chunk_size) throughout.
    """
    if num_vertices is None:
        top = -1
        for chunk in iter_text_edges(path, chunk_size, comments):
            keep = chunk[:, 0] != chunk[:, 1]
            if keep.any():
                top = max(top, int(chunk[keep].max()))
        num_vertices = top + 1
    return canonicalize_stream(
        iter_text_edges(path, chunk_size, comments), out_path,
        num_vertices=num_vertices, chunk_size=chunk_size, tmpdir=tmpdir)


def dump_text(edges_source, path: str | os.PathLike,
              header: str | None = None,
              chunk_size: int = DEFAULT_CHUNK) -> None:
    """Write an edge source (EdgeFile / ndarray / chunk iterator) as SNAP
    style ``src dst`` text (gzip if the path ends in ``.gz``) — the
    round-trip half that lets tests and the shoot-out's bundled-graph
    fallback exercise the real ingest path end to end."""
    from repro_torch.io.stream import iter_edge_chunks

    with _open_text_w(path) as fh:
        if header:
            for line in header.splitlines():
                fh.write(f"# {line}\n")
        for chunk in iter_edge_chunks(edges_source, chunk_size):
            np.savetxt(fh, np.asarray(chunk), fmt="%d", delimiter="\t")


def _open_text_w(path: str | os.PathLike):
    path = os.fspath(path)
    if path.endswith(".gz"):
        return gzip.open(path, "wt", encoding="utf-8")
    return open(path, "wt", encoding="utf-8")


__all__ = ["dump_text", "ingest_text", "iter_text_edges"]
