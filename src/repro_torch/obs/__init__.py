"""repro_torch.obs — telemetry for the partitioning runtime.

Copies of the reference package's round-level tracing (nested spans and
counters to per-host JSONL logs, ``trace``), its peak-RSS
implementation (``rss``) and its store-backed live metrics bus
(``live``); the files they write follow the reference's schemas.

Tracing is off by default and near-zero cost when off: the module-level
``trace.span`` / ``trace.counter`` front door checks one global.  Turn
it on with ``REPRO_TRACE=1`` (or ``REPRO_TRACE=<dir>``) through
``trace.from_env``, or by calling ``trace.configure``.

Re-exports resolve lazily (PEP 562), and every submodule imports the
standard library only.
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
    "LiveBus": "repro_torch.obs.live",
    "host_metrics": "repro_torch.obs.live",
    "live_enabled": "repro_torch.obs.live",
    "load_snapshots": "repro_torch.obs.live",
    "metrics_name": "repro_torch.obs.live",
    "publish": "repro_torch.obs.live",
    "tail_snapshots": "repro_torch.obs.live",
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
