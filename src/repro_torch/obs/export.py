"""Render per-host JSONL event logs to Chrome ``trace_event`` JSON.

The output loads directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``: one track ("process") per partitioning host, span
slices from the ``span`` events and one counter track per counter name.
Host timelines are monotonic-clock deltas with arbitrary epochs, so the
merge rebases every log onto one axis using the ``start_unix`` wall-clock
anchor each meta line carries — exact across processes on one machine,
NTP-accurate across machines (good enough for eyeballing round skew; the
per-host durations themselves are always pure ``perf_counter`` deltas).

A copy of the reference package's ``obs/export.py``, whose optional
``jax_profile`` window becomes :func:`torch_profile`: a
``torch.profiler`` window over a flagged block, and a no-op when
disabled, so call sites can use it unconditionally.
"""
from __future__ import annotations

import contextlib
import json
import os
import warnings
from pathlib import Path


def load_events(path: str | os.PathLike) -> list[dict]:
    """Parse one host's JSONL log, skipping blank and torn lines.

    A crash can leave a half-written final line; telemetry must degrade
    to "events up to the crash", never refuse the whole log.
    """
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events


def host_logs(run_dir: str | os.PathLike) -> list[Path]:
    """The per-host trace logs under a run directory, sorted by host id.

    Looks in ``run_dir`` itself and one level of subdirectories (the
    launcher writes to ``<out>/trace/``).
    """
    root = Path(run_dir)
    found = sorted(root.glob("trace_h*.jsonl"))
    if not found:
        found = sorted(root.glob("*/trace_h*.jsonl"))
    return found


def merge_events(paths) -> tuple[list[dict], list[dict]]:
    """Merge host logs onto one timeline.

    Returns ``(metas, events)``: the per-host meta records, and every
    span/counter event with an added ``ts_abs`` (microseconds since the
    earliest host's start), sorted by ``ts_abs``.  A log with no meta
    anchor line (its host was killed before the first batch flush)
    cannot be placed on the shared axis — its events are skipped with a
    warning rather than failing the whole merge; the surviving hosts'
    telemetry is exactly what a post-mortem needs.
    """
    logs = [(p, load_events(p)) for p in paths]
    metas, timed = [], []
    starts = {}
    for path, events in logs:
        meta = next((e for e in events if e.get("ev") == "meta"), None)
        if meta is not None:
            meta = dict(meta, path=os.fspath(path))
            metas.append(meta)
            starts[id(events)] = float(meta.get("start_unix", 0.0))
    base = min(starts.values(), default=0.0)
    for path, events in logs:
        if id(events) not in starts:
            warnings.warn(
                f"{os.fspath(path)} has no meta anchor line (host killed "
                f"before its first flush?) — skipping its "
                f"{len(events)} event(s) in the merged timeline",
                stacklevel=2)
            continue
        off_us = (starts[id(events)] - base) * 1e6
        for e in events:
            if e.get("ev") in ("span", "counter"):
                e = dict(e, ts_abs=round(e.get("ts", 0.0) + off_us, 1))
                timed.append(e)
    timed.sort(key=lambda e: e["ts_abs"])
    metas.sort(key=lambda m: m.get("pid", 0))
    return metas, timed


def chrome_trace(paths) -> dict:
    """Chrome ``trace_event`` JSON (the ``traceEvents`` dict form) from
    per-host JSONL logs — one process track per host, spans as complete
    ("X") events, counters as counter ("C") tracks."""
    metas, events = merge_events(paths)
    out = []
    for meta in metas:
        pid = int(meta.get("pid", 0))
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name",
                    "args": {"name": f"host{pid}"}})
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_sort_index",
                    "args": {"sort_index": pid}})
    for e in events:
        pid = int(e.get("pid", 0))
        if e["ev"] == "span":
            out.append({"ph": "X", "pid": pid,
                        "tid": int(e.get("tid", 0)),
                        "name": e.get("name", "?"),
                        "cat": e.get("cat", "run"),
                        "ts": e["ts_abs"], "dur": e.get("dur", 0),
                        "args": e.get("args", {})})
        else:  # counter
            out.append({"ph": "C", "pid": pid, "tid": 0,
                        "name": e.get("name", "?"), "ts": e["ts_abs"],
                        "args": {"value": e.get("value", 0)}})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"hosts": len(metas),
                          "schema": "repro.obs v1"}}


def write_chrome_trace(out_path: str | os.PathLike, paths) -> dict:
    """Write :func:`chrome_trace` of ``paths`` (an iterable of JSONL
    logs, or a run directory) to ``out_path``; returns the trace dict."""
    if isinstance(paths, (str, os.PathLike)):
        paths = host_logs(paths)
    trace = chrome_trace(list(paths))
    out_path = Path(out_path)
    if out_path.parent != Path(""):
        out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(trace))
    return trace


@contextlib.contextmanager
def torch_profile(logdir: str | os.PathLike | None, enabled: bool = True):
    """Optionally wrap a block in a ``torch.profiler`` window.

    Yields True when a profiler is actually running, and then writes its
    Chrome trace to ``logdir/torch_trace_<pid>.json`` at the end.
    No-ops (and never raises) when disabled or when ``logdir`` is None.
    Profiles the card's kernels too when one is present.  The profile
    is far heavier than the JSONL spans, so profile a few rounds, not
    the run.
    """
    if not enabled or logdir is None:
        yield False
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(os.fspath(logdir), exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield True
    prof.export_chrome_trace(os.path.join(
        os.fspath(logdir), f"torch_trace_{os.getpid()}.json"))


__all__ = ["chrome_trace", "host_logs", "load_events", "merge_events",
           "torch_profile", "write_chrome_trace"]
