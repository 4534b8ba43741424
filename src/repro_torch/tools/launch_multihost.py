"""Launch a multi-controller partitioning job on this machine.

Parent mode (default) is a local stand-in for a cluster manager: it
starts ``--num-processes`` copies of this module in ``--worker`` mode,
one rank each of a ``torch.distributed`` group that meets through a
``file://`` store in a fresh directory, then watches them: the first
worker to die takes the whole gang down (exit code of the first
failure), since its peers wait in collectives whose counterpart is gone.

Worker mode ingests only this rank's host block range of the canonical
EdgeFile through the exchange, and drives the round state machine with
multi-writer snapshots; rank 0 publishes ``result.npz`` and
``timing.json`` under ``--out``.  One shard a rank: the device count is
the world size.  See ``repro_torch.runtime.multihost``.

Two gloo ranks on the CPU::

  PYTHONPATH=src python -m repro_torch.tools.launch_multihost \\
      --edgefile /tmp/graph/edges.canonical --partitions 8 \\
      --num-processes 2 --device cpu \\
      --snapshot-dir /tmp/run/snapshots --snapshot-every 1 \\
      --out /tmp/run/out

Without ``--device`` each rank runs on the card ``cuda:(rank % count)``
(NCCL takes one rank a card).  Resume the same job after a crash by
adding ``--resume`` (same snapshot dir; ingestion is re-derived,
fingerprints verified, and all ranks agree on the newest fully published
round before stepping); resuming at another ``--num-processes`` reshards
the snapshot through the store.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    job = ap.add_argument_group("job")
    job.add_argument("--edgefile", required=True,
                     help="canonical EdgeFile to partition")
    job.add_argument("--partitions", type=int, required=True)
    job.add_argument(
        "--partitioner", choices=["ne", "hybrid"], default="ne",
        help="ne: the paper's Distributed NE (SPMD, multi-process); "
        "hybrid: HEP-style NE-below-threshold + 2D-hash tail under "
        "--budget-frac (single-controller: --num-processes must be 1)")
    job.add_argument(
        "--budget-frac", type=float, default=0.5,
        help="hybrid memory budget tau: the NE phase's CSR may hold at "
        "most tau * 2M adjacency slots (1.0 degenerates to pure NE)")
    job.add_argument("--alpha", type=float, default=1.1)
    job.add_argument("--lam", type=float, default=0.1)
    job.add_argument("--k-sel", type=int, default=256)
    job.add_argument("--edge-chunk", type=int, default=1 << 18)
    job.add_argument("--max-rounds", type=int, default=4096)
    job.add_argument("--seed", type=int, default=0)
    job.add_argument("--snapshot-dir", default=None)
    job.add_argument("--snapshot-every", type=int, default=0)
    job.add_argument("--keep", type=int, default=3)
    job.add_argument(
        "--exchange-dir", default=None,
        help="shared spill dir for the ingestion exchange "
        "(default: <snapshot-dir>/exchange)")
    job.add_argument("--resume", action="store_true",
                     help="resume from the newest fully-published snapshot")
    job.add_argument(
        "--out", default=None,
        help="rank 0 writes result.npz + timing.json here (forces the "
        "lazy edge_part materialization — a debug/test surface)")
    job.add_argument(
        "--artifact-out", default=None,
        help="persist the result as a partition artifact via the "
        "multi-writer save (sharded: no rank ever holds the global "
        "assignment)")
    job.add_argument(
        "--trace-dir", default=None,
        help="write one trace_hNNN.jsonl event log per worker here "
        "(merge with repro_torch.tools.report_run; also enabled by the "
        "REPRO_TRACE env var)")
    job.add_argument(
        "--metrics-dir", default=None,
        help="publish one metrics_hNNN.jsonl live-metrics stream per "
        "worker here (watch with repro_torch.tools.monitor_run; also "
        "enabled by the REPRO_LIVE_METRICS env var)")
    job.add_argument(
        "--device", default=None,
        help="where the ranks run: 'cpu' (gloo), or by default the card "
        "cuda:(rank % count) (NCCL)")

    cl = ap.add_argument_group("cluster")
    cl.add_argument("--num-processes", type=int, default=2)
    cl.add_argument(
        "--log-dir", default=None,
        help="parent mode: one log file per worker (default: a temporary "
        "dir, the tails printed on failure)")
    cl.add_argument("--timeout", type=float, default=1800.0)

    wk = ap.add_argument_group("worker (internal)")
    wk.add_argument("--worker", action="store_true",
                    help="run as one rank (started by parent mode)")
    wk.add_argument("--process-id", type=int, default=0)
    wk.add_argument("--store-dir", default=None,
                    help="directory of the group's file:// store")

    fault = ap.add_argument_group("fault injection (integration tests)")
    fault.add_argument("--die-round", type=int, default=-1,
                       help="crash --die-process at this round (-1: never)")
    fault.add_argument(
        "--die-stage", default="after-round",
        choices=["after-round", "after-shards", "after-publish"],
        help="where in the round/snapshot protocol to die")
    fault.add_argument("--die-process", type=int, default=1)
    return ap


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    ns = parser.parse_args(argv)
    if ns.partitioner == "hybrid" and ns.num_processes != 1:
        parser.error(
            "--partitioner hybrid is single-controller: the expansion "
            "phase runs over the low subgraph on one process "
            "(use --num-processes 1, or --partitioner ne for SPMD)")
    from repro_torch.runtime import multihost as mh

    if ns.partitioner == "ne" and mh.exchange_dir_of(ns) is None:
        parser.error("multi-controller ingestion needs --exchange-dir (or "
                     "a --snapshot-dir to derive it from)")
    if ns.worker:
        if ns.store_dir is None:
            parser.error("--worker needs --store-dir")
        return mh.worker_main(ns)

    worker_argv = [sys.executable, "-m", "repro_torch.tools.launch_multihost",
                   *argv]
    rc, outputs = mh.launch_local(worker_argv,
                                  num_processes=ns.num_processes,
                                  log_dir=ns.log_dir, timeout=ns.timeout)
    if rc != 0:
        for i, out in enumerate(outputs):
            print(f"--- worker {i} (tail) ---\n{out[-3000:]}",
                  file=sys.stderr)
        print(f"multihost job failed with exit code {rc}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
