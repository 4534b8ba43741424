"""repro_torch.obs — telemetry for the partitioning runtime.

Copies of the reference package's round-level tracing (nested spans and
counters to per-host JSONL logs, ``trace``), its peak-RSS
implementation (``rss``), the Chrome ``trace_event`` / Perfetto export
with an optional ``torch.profiler`` window (``export``), run-directory
aggregation into per-phase and per-round summaries (``report``), the
store-backed live metrics bus (``live``) and the stall/straggler monitor
with its Prometheus exposition (``monitor``); the files they write and
read follow the reference's schemas.

Tracing is off by default and near-zero cost when off: the module-level
``trace.span`` / ``trace.counter`` front door checks one global.  Turn
it on with ``REPRO_TRACE=1`` (or ``REPRO_TRACE=<dir>``) through
``trace.from_env``, or by calling ``trace.configure``.

Re-exports resolve lazily (PEP 562).  Every submodule imports the
standard library only, but ``report`` (numpy, for percentiles) and
``export.torch_profile`` (torch, when it profiles).
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "Tracer": "repro_torch.obs.trace",
    "add": "repro_torch.obs.trace",
    "configure": "repro_torch.obs.trace",
    "counter": "repro_torch.obs.trace",
    "disable": "repro_torch.obs.trace",
    "enabled": "repro_torch.obs.trace",
    "from_env": "repro_torch.obs.trace",
    "get_tracer": "repro_torch.obs.trace",
    "log_name": "repro_torch.obs.trace",
    "span": "repro_torch.obs.trace",
    "traced": "repro_torch.obs.trace",
    "peak_rss_kb": "repro_torch.obs.rss",
    "vm_hwm_kb": "repro_torch.obs.rss",
    "vm_rss_kb": "repro_torch.obs.rss",
    "chrome_trace": "repro_torch.obs.export",
    "host_logs": "repro_torch.obs.export",
    "load_events": "repro_torch.obs.export",
    "merge_events": "repro_torch.obs.export",
    "torch_profile": "repro_torch.obs.export",
    "write_chrome_trace": "repro_torch.obs.export",
    "legacy_timing": "repro_torch.obs.report",
    "render": "repro_torch.obs.report",
    "summarize_run": "repro_torch.obs.report",
    "LiveBus": "repro_torch.obs.live",
    "host_metrics": "repro_torch.obs.live",
    "live_enabled": "repro_torch.obs.live",
    "load_snapshots": "repro_torch.obs.live",
    "metrics_name": "repro_torch.obs.live",
    "publish": "repro_torch.obs.live",
    "tail_snapshots": "repro_torch.obs.live",
    "BusMonitor": "repro_torch.obs.monitor",
    "MonitorConfig": "repro_torch.obs.monitor",
    "render_dashboard": "repro_torch.obs.monitor",
    "render_prometheus": "repro_torch.obs.monitor",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value          # cache for subsequent lookups
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
