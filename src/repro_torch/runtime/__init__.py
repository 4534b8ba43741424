"""repro_torch.runtime — the checkpointable partitioning runtime.

The operational layer around the partitioners, ported from the reference
package's ``repro.runtime``: a round-level state machine that can
pause/snapshot/resume a run bit-identically (``driver``), crash-safe
sharded snapshots with config/graph fingerprints (``snapshot``), durable
partition artifacts that feed the GAS / GNN consumers without
re-partitioning (``artifact``), range-planned EdgeFile ingestion
where each host-range reader streams only its slice of the store
(``cluster``), the sharded finalize of a multi-controller run
(``finalize``) and the process layer that launches and runs one
(``multihost``).

Re-exports resolve lazily (PEP 562): ``cluster``, ``artifact``,
``snapshot``, ``finalize`` and ``multihost`` import without torch, which
keeps the ``processes=True`` spawn workers of ``cluster.ingest_edgefile``
and the launcher's parent process lightweight — unpickling ``cluster._ingest_worker`` must not drag the
driver's torch import into every worker process.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "ARTIFACT_VERSION": "repro_torch.runtime.artifact",
    "PartitionArtifact": "repro_torch.runtime.artifact",
    "begin_shared_artifact": "repro_torch.runtime.artifact",
    "encode_shared_parts": "repro_torch.runtime.artifact",
    "load_artifact": "repro_torch.runtime.artifact",
    "publish_shared_artifact": "repro_torch.runtime.artifact",
    "save_artifact": "repro_torch.runtime.artifact",
    "write_artifact_contrib": "repro_torch.runtime.artifact",
    "exchange_assemble": "repro_torch.runtime.cluster",
    "exchange_counts": "repro_torch.runtime.cluster",
    "exchange_read_global": "repro_torch.runtime.cluster",
    "exchange_write_range": "repro_torch.runtime.cluster",
    "host_block_ranges": "repro_torch.runtime.cluster",
    "ingest_edgefile": "repro_torch.runtime.cluster",
    "ingest_host_range": "repro_torch.runtime.cluster",
    "my_block_range": "repro_torch.runtime.cluster",
    "process_info": "repro_torch.runtime.cluster",
    "reshard_assemble": "repro_torch.runtime.cluster",
    "reshard_write": "repro_torch.runtime.cluster",
    "shard_eids": "repro_torch.runtime.cluster",
    "apply_leftovers": "repro_torch.runtime.finalize",
    "leftover_assignments": "repro_torch.runtime.finalize",
    "partition_contribs": "repro_torch.runtime.finalize",
    "stage_leftovers": "repro_torch.runtime.finalize",
    "PartitionDriver": "repro_torch.runtime.driver",
    "initialize_distributed": "repro_torch.runtime.multihost",
    "launch_local": "repro_torch.runtime.multihost",
    "worker_main": "repro_torch.runtime.multihost",
    "RunSnapshot": "repro_torch.runtime.snapshot",
    "ShardedCheckpointManager": "repro_torch.runtime.snapshot",
    "SnapshotMismatch": "repro_torch.runtime.snapshot",
    "config_fingerprint": "repro_torch.runtime.snapshot",
    "graph_fingerprint": "repro_torch.runtime.snapshot",
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
