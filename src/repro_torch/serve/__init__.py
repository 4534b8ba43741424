"""repro_torch.serve — partition-serving layer over durable artifacts.

A copy of the reference package's ``serve`` package, the online
consumer of ``repro_torch.runtime.artifact``: load a partition artifact
into a sharded graph/feature store (``store``), answer neighbor / k-hop
/ feature / personalized-PageRank queries through a
replica-map-routed service (``service``), batch concurrent requests
until deadline-or-batch-size (``batch``), keep Zipf-head adjacency
decoded in an LRU (``cache``), and scale past one process with an HTTP
gang — one server per partition group, first death kills the gang
(``server``, ``gang``).  See docs/DESIGN-serve.md.  The public names,
the wire protocol, the environment variables and the metric names are
the reference's: either package's client queries the other's gang.

Re-exports resolve lazily (PEP 562).  Nothing here imports torch or
jax: the layer does no device work, so a serving host starts in
milliseconds and runs wherever the monitor runs.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "RequestBatcher": "repro_torch.serve.batch",
    "default_max_batch": "repro_torch.serve.batch",
    "default_max_delay_s": "repro_torch.serve.batch",
    "LRUCache": "repro_torch.serve.cache",
    "GangClient": "repro_torch.serve.gang",
    "ServingGang": "repro_torch.serve.gang",
    "launch_serving_gang": "repro_torch.serve.gang",
    "ServeServer": "repro_torch.serve.server",
    "group_partitions": "repro_torch.serve.server",
    "make_server": "repro_torch.serve.server",
    "FanoutViolation": "repro_torch.serve.service",
    "PartitionService": "repro_torch.serve.service",
    "k_hop": "repro_torch.serve.service",
    "ppr": "repro_torch.serve.service",
    "render_serve_prometheus": "repro_torch.serve.service",
    "ShardStore": "repro_torch.serve.store",
    "default_cache_entries": "repro_torch.serve.store",
    "vertex_features": "repro_torch.serve.store",
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
