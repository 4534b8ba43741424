"""Crash-safe directory publication — the one atomic-publish protocol.

A copy of the reference package's ``io/atomicdir.py``, shared by the
checkpoint store and the partition artifact store.  Lives under
``repro_torch.io`` (numpy and the standard library only) so the stores
stay importable from processes that never load torch, such as the
ingestion spawn workers.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path


def fsync_path(path: Path) -> None:
    """fsync a file or directory — the directory fsync is what makes the
    tmp→final rename durable across power loss, not just process crash."""
    flags = os.O_RDONLY | (os.O_DIRECTORY if path.is_dir() else 0)
    fd = os.open(path, flags)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def publish_dir(tmp: Path, final: Path) -> None:
    """Atomically publish a fully-staged ``tmp`` dir at ``final``.

    The one crash-safe publish protocol, shared by the checkpoint store
    and the partition artifact store: fsync the staged dir, swap with two
    renames when ``final`` already exists (the old version stays visible
    until the new one is fully in place, and the crash window is the
    instant between renames — during which both complete dirs still exist
    on disk), fsync the parent.  Stale ``.trash_*`` leftovers of an
    earlier crashed swap are reclaimed up front, whichever branch runs.
    """
    fsync_path(tmp)
    trash = final.parent / f".trash_{final.name}"
    if trash.exists():
        shutil.rmtree(trash)               # orphan of a killed swap
    if final.exists():
        final.rename(trash)
        tmp.rename(final)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        tmp.rename(final)
    fsync_path(final.parent)


def publish_file(final: Path, data: bytes | str) -> None:
    """Atomically publish a single file's contents at ``final``.

    The single-file twin of :func:`publish_dir`: stage to a dot-tmp
    sibling, fsync, rename over the target, fsync the parent.  A reader
    either sees the previous complete contents or the new complete
    contents — never a torn write.  Used for the live-metrics bus
    manifest (``repro_torch.obs.live``), where a monitor may attach at any
    instant, including mid-publish.
    """
    final = Path(final)
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = final.parent / f".tmp_{final.name}"
    mode = "wb" if isinstance(data, bytes) else "w"
    with open(tmp, mode) as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    tmp.rename(final)
    fsync_path(final.parent)


__all__ = ["fsync_path", "publish_dir", "publish_file"]
