"""Aggregate a run directory's telemetry into a human-readable summary.

A copy of the reference package's ``obs/report.py``.

Input: the per-host JSONL logs a traced run leaves behind (plus the
``timing.json`` the multihost worker publishes — itself derived from the
same events via :func:`legacy_timing`, so the two never disagree).
Output: a plain dict — per-phase time breakdown, per-round latency
percentiles (p50/p90/p99), counter summaries (collective payload bytes,
remaining-edge gauges) and per-host peak RSS — plus :func:`render` for
the fixed-width table ``python -m repro_torch.tools.report_run`` prints.

numpy is used only for percentiles; nothing here imports torch.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from repro_torch.obs import export

# counters that are running totals (emitted via Tracer.add) — summarized
# by their final value; everything else is a gauge (max/last)
CUMULATIVE = ("sync_payload_bytes",)


def _pcts(durs_us) -> dict:
    d = np.asarray(durs_us, dtype=np.float64) / 1e6
    if d.size == 0:
        # a run killed before its first round completes (or a trace of a
        # phase that never ran) still reports cleanly: null percentiles,
        # not a numpy empty-reduction crash
        return {"count": 0, "total_s": 0.0, "mean_s": None, "p50_s": None,
                "p90_s": None, "p99_s": None, "max_s": None}
    return {"count": int(d.size), "total_s": float(d.sum()),
            "mean_s": float(d.mean()), "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "p99_s": float(np.percentile(d, 99)), "max_s": float(d.max())}


def summarize_events(metas: list[dict], events: list[dict]) -> dict:
    """The report dict from merged events (see :func:`summarize_run`)."""
    hosts: dict[int, dict] = {}
    for m in metas:
        pid = int(m.get("pid", 0))
        hosts[pid] = {"start_unix": m.get("start_unix"),
                      "meta": m.get("args", {})}
    phases: dict[str, list] = {}
    rounds: list[float] = []
    counters: dict[str, dict] = {}
    for e in events:
        pid = int(e.get("pid", 0))
        if e["ev"] == "span":
            name = e.get("name", "?")
            phases.setdefault(name, []).append(float(e.get("dur", 0.0)))
            if name == "round":
                rounds.append(float(e.get("dur", 0.0)))
        elif e["ev"] == "counter":
            name = e.get("name", "?")
            v = e.get("value", 0)
            c = counters.setdefault(
                name, {"last": v, "max": v, "samples": 0, "per_host": {}})
            c["last"] = v
            c["max"] = max(c["max"], v)
            c["samples"] += 1
            c["per_host"][pid] = max(c["per_host"].get(pid, v), v) \
                if name.startswith("vm_") else v
    for pid, h in hosts.items():
        peak = counters.get("vm_hwm_kb", {}).get("per_host", {}).get(pid)
        if peak is None:
            peak = counters.get("vm_rss_kb", {}).get("per_host", {}).get(pid)
        h["peak_rss_kb"] = peak
    report = {
        "hosts": hosts,
        "phases": {n: _pcts(d) for n, d in sorted(phases.items())},
        "rounds": _pcts(rounds),
        "counters": counters,
    }
    return report


def summarize_live(paths) -> dict:
    """Aggregate per-host live-metrics streams (``repro_torch.obs.live``).

    The bus shares the report's schema conventions (meta anchor line,
    per-host pid files), so a finished run's metrics files summarize
    exactly like a trace: per-host snapshot counts, last round, final
    live quality gauges, and whether the host reached its ``done``
    snapshot (a host that never did is where the run wedged).
    """
    from repro_torch.obs import live

    hosts: dict[int, dict] = {}
    for p in paths:
        snaps = live.load_snapshots(p)
        meta = next((s for s in snaps if s.get("ev") == "meta"), None)
        hb = [s for s in snaps if s.get("ev") == "hb"]
        pid = int((meta or (hb[-1] if hb else {})).get("pid", 0))
        last = hb[-1] if hb else {}
        hosts[pid] = {
            "snapshots": len(hb),
            "last_round": last.get("round"),
            "last_phase": last.get("phase"),
            "done": bool(last.get("done")),
            "rf": last.get("rf"), "eb": last.get("eb"),
            "vb": last.get("vb"),
            "rss_peak_kb": last.get("rss_peak_kb"),
            "sync_payload_bytes": last.get("sync_payload_bytes"),
        }
    return {"hosts": hosts}


def summarize_run(run_dir: str | os.PathLike) -> dict:
    """Aggregate every ``trace_h*.jsonl`` under ``run_dir`` (and a
    ``timing.json`` if one is published there) into the report dict.
    When the run also published live metrics (``metrics_h*.jsonl``),
    their summary rides along under ``"live"``."""
    logs = export.host_logs(run_dir)
    if not logs:
        raise FileNotFoundError(
            f"no trace_h*.jsonl logs under {os.fspath(run_dir)} — was the "
            f"run launched with tracing enabled (REPRO_TRACE / "
            f"--trace-dir)?")
    metas, events = export.merge_events(logs)
    report = summarize_events(metas, events)
    report["logs"] = [os.fspath(p) for p in logs]
    timing = Path(run_dir) / "timing.json"
    if timing.exists():
        report["timing"] = json.loads(timing.read_text())
    from repro_torch.obs import live

    metrics = live.host_metrics(run_dir)
    if metrics:
        report["live"] = summarize_live(metrics)
    return report


def legacy_timing(tracer, extra: dict | None = None) -> dict:
    """The worker's ``timing.json`` payload, derived from the tracer's
    in-memory events — the same schema the JSONL log carries, so the
    published timings and the trace can never disagree.

    Keys: ``ingest_secs``, ``round_secs`` (per-round
    ``perf_counter`` span durations, in order), plus one ``<name>_secs``
    per other top-level phase span and the final value of every
    cumulative counter.  ``start_unix`` is the only epoch timestamp.
    ``extra`` entries are merged last (result fields like ``rounds`` or
    ``replication_factor`` that are not timings).
    """
    meta = next((e for e in tracer.events if e.get("ev") == "meta"), None)
    out: dict = dict((meta or {}).get("args", {}))
    out["start_unix"] = tracer.start_unix
    round_secs = []
    for e in tracer.events:
        if e.get("ev") != "span":
            continue
        dur_s = float(e.get("dur", 0.0)) / 1e6
        if e.get("name") == "round":
            round_secs.append(dur_s)
        else:
            out[f"{e['name']}_secs"] = dur_s
    out["round_secs"] = round_secs
    for name in CUMULATIVE:
        if name in tracer._counters:
            out[name] = tracer._counters[name]
    if extra:
        out.update(extra)
    return out


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"


def render(report: dict) -> str:
    """Fixed-width text summary of a report dict."""
    lines = []
    hosts = report.get("hosts", {})
    lines.append(f"run summary — {len(hosts)} host(s)")
    lines.append("")
    lines.append(f"{'host':>4}  {'peak RSS':>10}  meta")
    for pid in sorted(hosts):
        h = hosts[pid]
        peak = h.get("peak_rss_kb")
        peak = f"{peak / 1024:.1f}MiB" if peak else "-"
        meta = h.get("meta", {})
        keys = ("num_processes", "devices", "resume_round")
        desc = " ".join(f"{k}={meta[k]}" for k in keys if k in meta)
        lines.append(f"{pid:>4}  {peak:>10}  {desc}")
    lines.append("")
    rounds = report.get("rounds")
    if rounds and rounds["count"]:
        lines.append(
            f"rounds: {rounds['count']}  "
            f"p50={rounds['p50_s'] * 1e3:.1f}ms  "
            f"p90={rounds['p90_s'] * 1e3:.1f}ms  "
            f"p99={rounds['p99_s'] * 1e3:.1f}ms  "
            f"max={rounds['max_s'] * 1e3:.1f}ms")
        lines.append("")
    lines.append(f"{'phase':<18}{'count':>7}{'total':>10}{'mean':>10}"
                 f"{'p99':>10}")
    for name, p in report.get("phases", {}).items():
        lines.append(f"{name:<18}{p['count']:>7}"
                     f"{p['total_s']:>9.3f}s"
                     f"{p['mean_s'] * 1e3:>8.1f}ms"
                     f"{p['p99_s'] * 1e3:>8.1f}ms")
    counters = report.get("counters", {})
    if counters:
        lines.append("")
        lines.append(f"{'counter':<22}{'last':>14}{'max':>14}{'n':>6}")
        for name in sorted(counters):
            c = counters[name]
            last, mx = c["last"], c["max"]
            if name.endswith("bytes"):
                last, mx = _fmt_bytes(last), _fmt_bytes(mx)
            lines.append(f"{name:<22}{last:>14}{mx:>14}{c['samples']:>6}")
    live_hosts = report.get("live", {}).get("hosts", {})
    if live_hosts:
        lines.append("")
        lines.append("live bus — final snapshot per host")
        lines.append(f"{'host':>4}{'snaps':>7}{'round':>7}{'done':>6}"
                     f"{'rf':>8}{'eb':>7}")
        for pid in sorted(live_hosts):
            h = live_hosts[pid]
            rf = f"{h['rf']:.3f}" if h.get("rf") is not None else "-"
            eb = f"{h['eb']:.2f}" if h.get("eb") is not None else "-"
            rnd = h.get("last_round")
            lines.append(f"{pid:>4}{h['snapshots']:>7}"
                         f"{rnd if rnd is not None else '-':>7}"
                         f"{'yes' if h['done'] else 'NO':>6}{rf:>8}{eb:>7}")
    return "\n".join(lines)


__all__ = ["CUMULATIVE", "legacy_timing", "render", "summarize_events",
           "summarize_live", "summarize_run"]
