"""Round-level tracing: nested spans, counters, per-host JSONL event logs.

A copy of the reference package's ``obs/trace.py`` (the same event
schema, so the reference's exporters and reports read the port's logs).
One :class:`Tracer` per process writes an append-only JSONL event log —
one self-describing JSON object per line.  Three event kinds:

``{"ev": "meta", "v": 1, "pid": h, "start_unix": t, "args": {...}}``
    first line of every log.  ``start_unix`` (epoch seconds,
    ``time.time()``) is the *only* wall-clock timestamp — it anchors
    this host's monotonic timeline so multiple hosts' logs merge onto
    one axis.  ``args`` carries run identity (process count, devices,
    config fingerprint, …).

``{"ev": "span", "pid": h, "tid": t, "name": n, "cat": c,
   "ts": us, "dur": us, "args": {...}}``
    one completed (possibly nested) span.  ``ts`` is microseconds since
    the tracer started, measured with ``time.perf_counter`` — monotonic,
    NTP-immune.  Nesting is implied by time containment per ``tid``
    (exactly Chrome's complete-event model).

``{"ev": "counter", "pid": h, "name": n, "ts": us, "value": v}``
    a point-in-time sample: a gauge (``counter``) or the running total
    of an accumulating counter (``add``).

Everything here is standard library and near-zero cost when disabled: the
module-level :func:`span` / :func:`counter` / :func:`add` check one
global and return a shared no-op when no tracer is configured, so the
instrumented round loop pays one attribute load per call site.  All
recording is thread-safe (one re-entrant lock around the event buffer).
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time

from repro_torch.obs import rss

SCHEMA_VERSION = 1


def log_name(process: int) -> str:
    """Canonical per-host log file name — what export/report glob for."""
    return f"trace_h{process:03d}.jsonl"


class _NullSpan:
    """Shared do-nothing span for disabled tracing (one global instance)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def set(self, **args):
        """Attach result args discovered while the span is open."""
        self.args.update(args)

    def __exit__(self, etype, exc, tb):
        t1 = time.perf_counter()
        if etype is not None:
            # exception safety: the span is recorded either way, tagged
            # with the error type, and the exception propagates
            self.args["err"] = etype.__name__
        self._tracer._emit_span(self.name, self.cat, self._t0, t1,
                                self.args)
        return False


class Tracer:
    """Per-process event recorder.

    ``path=None`` keeps events in memory only (``events``); with a path,
    events stream
    to the JSONL log in ``flush_every``-event batches plus explicit
    :meth:`flush`/:meth:`close`.
    """

    def __init__(self, path: str | os.PathLike | None = None,
                 process: int = 0, meta: dict | None = None,
                 flush_every: int = 256):
        self._lock = threading.RLock()
        self.events: list[dict] = []
        self._pending = 0                 # events not yet written to disk
        self._flush_every = int(flush_every)
        self._counters: dict[str, float] = {}
        self.process = int(process)
        self.path = os.fspath(path) if path is not None else None
        self._fh = None
        if self.path is not None:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "w")
        # start_unix is the one wall-clock anchor; every event timestamp
        # after this line is a perf_counter delta
        self.start_unix = time.time()
        self._t_start = time.perf_counter()
        self._record({"ev": "meta", "v": SCHEMA_VERSION,
                      "pid": self.process, "start_unix": self.start_unix,
                      "args": dict(meta or {})})

    # -- recording ----------------------------------------------------------

    def _now_us(self, t: float | None = None) -> float:
        t = time.perf_counter() if t is None else t
        return round((t - self._t_start) * 1e6, 1)

    def _record(self, ev: dict):
        with self._lock:
            self.events.append(ev)
            self._pending += 1
            if self._fh is not None and self._pending >= self._flush_every:
                self._drain()

    def _drain(self):
        # caller holds the lock
        if self._fh is None or self._pending == 0:
            return
        lines = self.events[-self._pending:]
        self._fh.write("".join(
            json.dumps(ev, separators=(",", ":"), default=float) + "\n"
            for ev in lines))
        self._fh.flush()
        self._pending = 0

    def _emit_span(self, name, cat, t0, t1, args):
        ev = {"ev": "span", "pid": self.process,
              "tid": threading.get_ident() & 0xFFFF, "name": name,
              "cat": cat, "ts": self._now_us(t0),
              "dur": round((t1 - t0) * 1e6, 1)}
        if args:
            ev["args"] = args
        self._record(ev)

    # -- public API ---------------------------------------------------------

    def span(self, name: str, cat: str = "run", **args) -> _Span:
        """Context manager timing one (possibly nested) span."""
        return _Span(self, name, cat, args)

    def counter(self, name: str, value, ts: float | None = None):
        """Record a point-in-time gauge sample."""
        self._record({"ev": "counter", "pid": self.process, "name": name,
                      "ts": self._now_us() if ts is None else ts,
                      "value": value})

    def add(self, name: str, delta) -> float:
        """Accumulate into a named counter; records the running total."""
        with self._lock:
            total = self._counters.get(name, 0) + delta
            self._counters[name] = total
            self.counter(name, total)
        return total

    def sample_rss(self):
        """Record this process's current and peak RSS as counters."""
        self.counter("vm_rss_kb", rss.vm_rss_kb())
        hwm = rss.vm_hwm_kb()
        if hwm:
            self.counter("vm_hwm_kb", hwm)

    def flush(self):
        with self._lock:
            self._drain()

    def close(self):
        """Final RSS watermark sample + drain; the tracer stays usable
        in memory but writes nothing further."""
        self.sample_rss()
        with self._lock:
            self._drain()
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# module-level front door (the near-zero-cost disabled path)
# ---------------------------------------------------------------------------

_TRACER: Tracer | None = None


def get_tracer() -> Tracer | None:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def configure(path: str | os.PathLike | None = None, process: int = 0,
              meta: dict | None = None) -> Tracer:
    """Install the global tracer (replacing and closing any previous)."""
    global _TRACER
    old, _TRACER = _TRACER, None
    if old is not None:
        old.close()
    _TRACER = Tracer(path=path, process=process, meta=meta)
    return _TRACER


def disable():
    """Close and remove the global tracer (no-op when already off)."""
    global _TRACER
    old, _TRACER = _TRACER, None
    if old is not None:
        old.close()


def from_env(default_dir: str | os.PathLike | None = None,
             process: int = 0, meta: dict | None = None) -> Tracer | None:
    """Configure the global tracer from ``REPRO_TRACE``.

    Unset / ``""`` / ``"0"`` → disabled (returns None, and any existing
    global tracer is left alone).  ``"1"`` → enabled, logging under
    ``default_dir`` (in-memory only when no dir is known).  Any other
    value is itself the log directory.  The log file is
    ``<dir>/trace_h{process:03d}.jsonl``.
    """
    val = os.environ.get("REPRO_TRACE", "")
    if val in ("", "0"):
        return None
    d = default_dir if val == "1" else val
    path = os.path.join(os.fspath(d), log_name(process)) if d else None
    return configure(path=path, process=process, meta=meta)


def span(name: str, cat: str = "run", **args):
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, cat, **args)


def counter(name: str, value):
    t = _TRACER
    if t is not None:
        t.counter(name, value)


def add(name: str, delta):
    t = _TRACER
    if t is not None:
        t.add(name, delta)


def flush():
    t = _TRACER
    if t is not None:
        t.flush()


def traced(name: str | None = None, cat: str = "run"):
    """Decorator: run the wrapped function inside a span (no-op when
    tracing is disabled — the undecorated call path is one ``is None``
    check)."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = _TRACER
            if t is None:
                return fn(*args, **kwargs)
            with t.span(label, cat):
                return fn(*args, **kwargs)

        return wrapper

    return deco


__all__ = ["NULL_SPAN", "SCHEMA_VERSION", "Tracer", "add", "configure",
           "counter", "disable", "enabled", "flush", "from_env",
           "get_tracer", "log_name", "span", "traced"]
