"""Live run metrics bus: per-host heartbeat/quality snapshot streams.

A copy of the reference package's ``obs/live.py``, the live counterpart
of :mod:`repro_torch.obs.trace`: where the tracer records *what a run
did* for post-hoc aggregation, the bus publishes *what the run is doing
right now* so a monitor (the reference's ``obs.monitor`` reads the same
files) can watch a job in flight — per-host heartbeats, round progress, edges remaining, collective payload, RSS,
and the per-round quality gauges (live replication factor, partition
balance, boundary-set size) the SPMD state reduction emits
(``repro_torch.dist.partitioner_sm.round_quality``).

Store layout (the bus lives *in the run's store directory*, because a
shared filesystem is the one channel every host of a distributed run
already has):

``<dir>/run.json``
    run-identity manifest, written once by host 0 through the
    crash-safe single-file publish (:func:`repro_torch.io.atomicdir.
    publish_file`) — a monitor attaching mid-publish sees either no
    manifest or a complete one, never a torn JSON.

``<dir>/metrics_h{pid:03d}.jsonl``
    one append-only stream per host.  First line is a ``meta`` anchor
    (schema version, pid, wall-clock start); every subsequent line is
    one fixed-schema ``hb`` snapshot, flushed immediately so a tailing
    monitor sees it within one write.  Appends are not atomic — a
    killed publisher can tear the final line — so readers consume only
    ``\\n``-terminated lines (:func:`tail_snapshots`) and a torn tail
    is simply "the snapshot that never happened".

Snapshot schema (v2) — every ``hb`` line carries exactly these fields,
``None`` where a phase has nothing to report:

``ev, v, pid, seq, t_unix, phase, round, edges_remaining,
sync_payload_bytes, rss_kb, rss_peak_kb, rf, eb, vb, boundary, done,
qps, p99_ms, cache_hit, fanout``

``t_unix`` doubles as the heartbeat: the monitor's stall detector is
"now - last t_unix".  ``seq`` increments per snapshot so dropped or
reordered reads are detectable.  ``rf``/``eb``/``vb``/``boundary`` are
the live quality gauges; at the fixed point they equal the finalized
artifact's metrics exactly (no leftovers remain to clean up), which the
multihost integration checks assert to 1e-6.  The v2 additions
(``qps``/``p99_ms``/``cache_hit``/``fanout``) are the serving gauges,
which a serving host heartbeats under ``phase: "serve"``.  v1 streams
remain readable — readers treat absent fields as ``None``.

Like the tracer, the bus is near-zero cost when disabled: the
module-level :func:`publish` front door is one global load plus an
``is None`` check.  Everything here is standard library.
"""
from __future__ import annotations

import json
import os
import time

from repro_torch.obs import rss

SCHEMA_VERSION = 2

#: the conventional bus subdirectory of a run's store/output directory
BUS_DIRNAME = "live"

#: the fixed ``hb`` payload schema — publish() rejects anything else
SNAPSHOT_FIELDS = ("phase", "round", "edges_remaining",
                   "sync_payload_bytes", "rss_kb", "rss_peak_kb",
                   "rf", "eb", "vb", "boundary", "done",
                   "qps", "p99_ms", "cache_hit", "fanout")


def metrics_name(process: int) -> str:
    """Canonical per-host metrics file name — what the monitor globs."""
    return f"metrics_h{process:03d}.jsonl"


def host_metrics(bus_dir) -> list:
    """The per-host metrics files under a bus (or run) directory, sorted
    by host id.  Looks in ``bus_dir`` itself and one level of
    subdirectories (runs publish to ``<out>/live/``)."""
    from pathlib import Path

    root = Path(bus_dir)
    found = sorted(root.glob("metrics_h*.jsonl"))
    if not found:
        found = sorted(root.glob("*/metrics_h*.jsonl"))
    return found


class LiveBus:
    """One host's publisher: an append-only fixed-schema snapshot stream.

    ``manifest`` (host 0 only, by convention) is published atomically as
    ``<dir>/run.json`` before the stream opens, so any monitor that can
    see this host's metrics file can also read the run identity.
    """

    def __init__(self, dirpath: str | os.PathLike, process: int = 0,
                 meta: dict | None = None, manifest: dict | None = None):
        from pathlib import Path

        self.process = int(process)
        self.dir = Path(os.fspath(dirpath))
        self.dir.mkdir(parents=True, exist_ok=True)
        if manifest is not None:
            # deferred: repro_torch.io's package import pulls numpy, and the
            # reading side of this module (monitor sidecars) must stay
            # numpy-free — only manifest *publishers* pay the import
            from repro_torch.io.atomicdir import publish_file

            publish_file(self.dir / "run.json",
                         json.dumps(dict(manifest, v=SCHEMA_VERSION,
                                         published_unix=time.time())))
        self.path = self.dir / metrics_name(self.process)
        self._fh = open(self.path, "w")
        self._seq = 0
        self._write({"ev": "meta", "v": SCHEMA_VERSION,
                     "pid": self.process, "t_unix": time.time(),
                     "args": dict(meta or {})})

    def _write(self, ev: dict):
        if self._fh is None:
            return
        self._fh.write(json.dumps(ev, separators=(",", ":"),
                                  default=float) + "\n")
        # flush per line: the heartbeat contract is "visible within one
        # write"; fsync is deliberately NOT called per snapshot (the
        # monitor tolerates losing the tail on power loss, and per-round
        # fsyncs would put the store's disk in the round hot path)
        self._fh.flush()

    def publish(self, **fields) -> dict:
        """Append one fixed-schema snapshot line; returns the record.

        Unknown keys raise — the schema is the cross-process contract
        (monitor, Prometheus names, report ingestion), so it only grows
        deliberately, with a version bump.
        """
        unknown = set(fields) - set(SNAPSHOT_FIELDS)
        if unknown:
            raise TypeError(f"unknown snapshot fields {sorted(unknown)}; "
                            f"schema v{SCHEMA_VERSION} has "
                            f"{SNAPSHOT_FIELDS}")
        self._seq += 1
        ev = {"ev": "hb", "v": SCHEMA_VERSION, "pid": self.process,
              "seq": self._seq, "t_unix": time.time()}
        for k in SNAPSHOT_FIELDS:
            ev[k] = fields.get(k)
        if ev["rss_kb"] is None:
            ev["rss_kb"] = rss.vm_rss_kb()
        if ev["rss_peak_kb"] is None:
            ev["rss_peak_kb"] = rss.vm_hwm_kb() or None
        if ev["done"] is None:
            ev["done"] = False
        self._write(ev)
        return ev

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------------
# reading side (shared by monitor, report, tests)
# ---------------------------------------------------------------------------

def tail_snapshots(path, offset: int = 0) -> tuple[list[dict], int]:
    """Read the complete snapshot lines appended since ``offset``.

    Returns ``(events, new_offset)`` where ``new_offset`` covers only
    ``\\n``-terminated bytes — a half-appended final line stays pending
    and is re-read once its publisher finishes it (or never, if the
    publisher was killed mid-append; either way the reader never parses
    a torn line).  Complete-but-corrupt lines are skipped, so one bad
    record can't wedge the tail.
    """
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read()
    except FileNotFoundError:
        return [], offset
    end = data.rfind(b"\n")
    if end < 0:
        return [], offset
    events = []
    for line in data[:end].split(b"\n"):
        line = line.strip()
        if not line:
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return events, offset + end + 1


def load_snapshots(path) -> list[dict]:
    """All complete records of one host's metrics file."""
    return tail_snapshots(path, 0)[0]


def read_manifest(bus_dir) -> dict | None:
    """The run manifest, or None when not (yet) published."""
    from pathlib import Path

    for p in (Path(bus_dir) / "run.json",
              Path(bus_dir) / BUS_DIRNAME / "run.json"):
        if p.exists():
            try:
                return json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                return None
    return None


# ---------------------------------------------------------------------------
# module-level front door (the near-zero-cost disabled path)
# ---------------------------------------------------------------------------

_BUS: LiveBus | None = None


def get_bus() -> LiveBus | None:
    return _BUS


def live_enabled() -> bool:
    return _BUS is not None


def configure(dirpath: str | os.PathLike, process: int = 0,
              meta: dict | None = None,
              manifest: dict | None = None) -> LiveBus:
    """Install the global bus (replacing and closing any previous)."""
    global _BUS
    old, _BUS = _BUS, None
    if old is not None:
        old.close()
    _BUS = LiveBus(dirpath, process=process, meta=meta, manifest=manifest)
    return _BUS


def disable():
    """Close and remove the global bus (no-op when already off)."""
    global _BUS
    old, _BUS = _BUS, None
    if old is not None:
        old.close()


def from_env(default_dir: str | os.PathLike | None = None,
             process: int = 0, meta: dict | None = None,
             manifest: dict | None = None) -> LiveBus | None:
    """Configure the global bus from ``REPRO_LIVE_METRICS``.

    Unset / ``""`` / ``"0"`` → disabled (returns None; any existing bus
    is left alone).  ``"1"`` → enabled under ``default_dir`` (no-op when
    no dir is known).  Any other value is itself the bus directory.
    """
    val = os.environ.get("REPRO_LIVE_METRICS", "")
    if val in ("", "0"):
        return None
    d = default_dir if val == "1" else val
    if d is None:
        return None
    return configure(d, process=process, meta=meta, manifest=manifest)


def publish(**fields):
    """Append one snapshot through the global bus; no-op when disabled."""
    b = _BUS
    if b is not None:
        b.publish(**fields)


__all__ = ["BUS_DIRNAME", "LiveBus", "SCHEMA_VERSION", "SNAPSHOT_FIELDS",
           "configure", "disable", "from_env", "get_bus", "host_metrics",
           "live_enabled", "load_snapshots", "metrics_name", "publish",
           "read_manifest", "tail_snapshots"]
