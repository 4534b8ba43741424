"""Multi-controller partitioning runs: one process a rank.

The port of the reference package's ``runtime/multihost.py``: the
process layer of the paper's deployment model (§7: one allocation
process a machine, rounds separated by real collectives).

* **worker side** — :func:`worker_main` drives one rank's share of a
  run: it joins the ``torch.distributed`` group through the ``file://``
  store the launcher names (:func:`initialize_distributed`; NCCL for a
  rank on the card, gloo on the CPU), ingests only its own host block
  range through the :mod:`repro_torch.runtime.cluster` exchange, steps
  :class:`repro_torch.runtime.driver.PartitionDriver` with multi-writer
  snapshots, finalizes sharded, and rank 0 publishes ``result.npz`` and
  ``timing.json``.  Rank ``h`` is host ``h`` and owns shard ``h``: one
  shard a rank, so the device count is the world size;
* **launcher side** — :func:`launch_local` starts N local workers (the
  local stand-in for N machines) and keeps the gang rule: the first
  worker to exit nonzero, or the deadline, takes the whole gang down,
  since its peers wait in collectives whose counterpart is gone.
  ``python -m repro_torch.tools.launch_multihost`` is the CLI over both.

Bit-identity: an N-rank run gives the same edge assignment, replica sets
and round count as ``partition_spmd`` at world N on the same canonical
EdgeFile (and as the reference's ``partition_spmd`` on N devices), since
the shard layout, the PRNG key and every collective are the same
(tests/test_torch_multihost_{2,4}.py).

Only the standard library and numpy are imported here: the launcher's
parent process never loads torch; :func:`worker_main` does.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

EXIT_FAULT = 17  # what an injected crash (test hook) exits with
GRACE_S = 10.0   # from a gang's SIGTERM to its SIGKILL


def initialize_distributed(store_dir: str | os.PathLike, num_processes: int,
                           process_id: int, backend: str) -> None:
    """Join this worker's group: rank ``process_id`` of ``num_processes``
    through the ``file://`` store in ``store_dir``."""
    from repro_torch.dist import compat

    compat.init_group(backend, process_id, num_processes,
                      os.fspath(store_dir))


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


def _trace_dir(ns) -> str | None:
    trace_dir = getattr(ns, "trace_dir", None)
    env_trace = os.environ.get("REPRO_TRACE", "")
    if trace_dir is None and env_trace not in ("", "0"):
        trace_dir = (env_trace if env_trace != "1"
                     else (os.path.join(ns.out, "trace") if ns.out else None))
    return trace_dir


def _metrics_dir(ns, bus_dirname: str) -> str | None:
    metrics_dir = getattr(ns, "metrics_dir", None)
    env_live = os.environ.get("REPRO_LIVE_METRICS", "")
    if metrics_dir is None and env_live not in ("", "0"):
        metrics_dir = (env_live if env_live != "1"
                       else (os.path.join(ns.out, bus_dirname) if ns.out
                             else None))
    return metrics_dir


def exchange_dir_of(ns) -> str | None:
    """The run's exchange dir: ``--exchange-dir``, else
    ``<snapshot-dir>/exchange``, else None."""
    if ns.exchange_dir is not None:
        return ns.exchange_dir
    if ns.snapshot_dir is not None:
        return os.path.join(os.fspath(ns.snapshot_dir), "exchange")
    return None


def worker_main(ns) -> int:
    """One rank's share of a multi-controller partitioning run.

    ``ns`` is the parsed namespace of
    ``python -m repro_torch.tools.launch_multihost`` (see there for the
    flags).  Flow: join the group → driver construction (this rank's
    block range through the exchange) or resume → round stepping with
    multi-writer snapshots → sharded finalize → the multi-writer artifact
    (``--artifact-out``) → rank 0 writes ``result.npz`` and
    ``timing.json`` under ``--out`` → a final barrier.
    """
    import torch

    from repro_torch.core.partitioner import NEConfig
    from repro_torch.dist import compat
    from repro_torch.io.edgefile import EdgeFile
    from repro_torch.obs import live
    from repro_torch.obs import report as obs_report
    from repro_torch.obs import trace as obs
    from repro_torch.runtime.driver import PartitionDriver

    rank, world = ns.process_id, ns.num_processes
    on_cpu = ns.device is not None and torch.device(ns.device).type == "cpu"
    if on_cpu:
        # the ranks share the host's cores (as compat.spawn sets them)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize_distributed(ns.store_dir, world, rank,
                           "gloo" if on_cpu else "nccl")
    hyper = dict(num_partitions=ns.partitions, alpha=ns.alpha, lam=ns.lam,
                 k_sel=ns.k_sel, edge_chunk=ns.edge_chunk,
                 max_rounds=ns.max_rounds, seed=ns.seed)
    if ns.partitioner == "hybrid":
        from repro_torch.core.hybrid import HybridConfig

        cfg = HybridConfig(budget_frac=ns.budget_frac, **hyper)
        driver_mode, exchange_dir = "hybrid", None
    else:
        cfg = NEConfig(**hyper)
        driver_mode, exchange_dir = "spmd", exchange_dir_of(ns)
    # one tracer a worker, always on: it is the source of every published
    # timing; with a trace dir it also streams the rank's JSONL log
    trace_dir = _trace_dir(ns)
    meta = {"process_id": rank, "num_processes": world, "devices": world}
    tracer = obs.configure(
        path=os.path.join(trace_dir, obs.log_name(rank)) if trace_dir
        else None, process=rank, meta=meta)
    # the live bus: each worker publishes its own stream; never a
    # collective, so a monitored run stays bit-identical to an
    # unmonitored one
    metrics_dir = _metrics_dir(ns, live.BUS_DIRNAME)
    if metrics_dir is not None:
        manifest = None
        if rank == 0:  # one atomic run.json, from rank 0
            manifest = {"num_processes": world, "devices": world,
                        "partitions": ns.partitions,
                        "edgefile": os.fspath(ns.edgefile)}
        live.configure(metrics_dir, process=rank,
                       meta={"process_id": rank, "num_processes": world},
                       manifest=manifest)
    extra: dict = {}
    with EdgeFile(ns.edgefile) as ef:
        kwargs = dict(mode=driver_mode, snapshot_every=ns.snapshot_every,
                      keep=ns.keep, exchange_dir=exchange_dir,
                      device=ns.device)
        if ns.resume:
            drv = PartitionDriver.resume(ef, cfg, ns.snapshot_dir, **kwargs)
            extra["resume_round"] = drv.rounds
        else:
            drv = PartitionDriver(ef, cfg, snapshot_dir=ns.snapshot_dir,
                                  **kwargs)
        dies = ns.die_round >= 0 and rank == ns.die_process
        if dies and ns.die_stage in ("after-shards", "after-publish"):

            def fault_hook(stage, round_k):
                if stage == ns.die_stage and round_k >= ns.die_round:
                    os._exit(EXIT_FAULT)

            drv.snapshot_fault_hook = fault_hook
        while not drv.done:
            drv.step()  # records the round span and its counters
            if (dies and ns.die_stage == "after-round"
                    and drv.rounds >= ns.die_round):
                tracer.flush()
                os._exit(EXIT_FAULT)
        res = drv.finalize()
        extra["rounds"] = int(res.rounds)
        if res.stats is not None:
            # from the sharded finalize's (P,) partials, without the
            # global assignment
            extra["replication_factor"] = res.stats.replication_factor
            extra["edge_balance"] = res.stats.edge_balance
            extra["vertex_balance"] = res.stats.vertex_balance
        if drv.snapshot is not None:
            extra["snapshot_rounds"] = drv.snapshot.rounds()
        if ns.artifact_out:
            # the multi-writer save: every rank takes part, none
            # materializes edge_part
            with obs.span("artifact_save", cat="runtime"):
                drv.save_artifact(ns.artifact_out)
        if ns.out:
            # materializing the lazy edge_part is a collective: every
            # rank forces it, not only the writer (a test and debug
            # surface; the production output is --artifact-out)
            with obs.span("gather_result", cat="runtime"):
                edge_part = res.edge_part
            if rank == 0:
                outd = Path(ns.out)
                outd.mkdir(parents=True, exist_ok=True)
                np.savez(outd / "result.npz", edge_part=edge_part,
                         vparts=res.vparts,
                         edges_per_part=res.edges_per_part,
                         rounds=res.rounds, leftover=res.leftover)
                timing = obs_report.legacy_timing(tracer, extra)
                (outd / "timing.json").write_text(json.dumps(timing))
    # the run's kernel launches (a fresh process: all of them are this
    # run's) and the card's peak memory, as counters of its trace
    from repro_torch.kernels.ne_round import ops as ne_ops

    for name, count in sorted(ne_ops.launches.items()):
        tracer.counter(f"launches_{name}", count)
    if not on_cpu:
        tracer.counter("cuda_peak_bytes", torch.cuda.max_memory_allocated())
    tracer.close()  # flush this rank's JSONL log (final RSS sample)
    live.disable()  # close this worker's metrics stream (no-op when off)
    compat.barrier("run-done")
    torch.distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# launcher side (local stand-in for a cluster manager)
# ---------------------------------------------------------------------------


def child_env() -> dict:
    """A worker's environment: this one, with the package's ``src`` dir
    first on ``PYTHONPATH``."""
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def launch_local(worker_argv: list[str], num_processes: int,
                 log_dir: str | os.PathLike | None = None,
                 timeout: float = 1800.0) -> tuple[int, list[str]]:
    """Start ``num_processes`` local workers and watch them.

    ``worker_argv`` is the command prefix (``[python, -m, module, *job
    flags]``); each worker gets ``--worker --process-id i
    --num-processes N --store-dir D`` appended, ``D`` a fresh directory
    for the group's ``file://`` store.  The gang rule: the first worker
    to exit nonzero, or a deadline overrun, has the whole gang torn down
    (SIGTERM, then SIGKILL after ``GRACE_S``), since its peers wait in a
    collective whose counterpart died.  Returns the first fault's exit
    code (124 for the deadline; 0 if all exit cleanly) and each worker's
    log.
    """
    # worker output always goes to files, never a pipe: this loop does
    # not drain pipes, and a worker that filled one would block forever
    own_logs = log_dir is None
    log_dir = Path(tempfile.mkdtemp(prefix="multihost_logs_") if own_logs
                   else log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="multihost_store_")
    env = child_env()
    procs, logs = [], []
    try:
        for i in range(num_processes):
            cmd = worker_argv + ["--worker", "--process-id", str(i),
                                 "--num-processes", str(num_processes),
                                 "--store-dir", store_dir]
            log = open(log_dir / f"proc{i:03d}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT,
                                          text=True, env=env))
        deadline = time.time() + timeout
        first_fault = None  # exit code of the first worker that died
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            fault = next((c for c in codes if c not in (None, 0)), None)
            if fault is not None:
                first_fault = fault
                break
            if time.time() > deadline:
                first_fault = 124  # the conventional timeout exit code
                break
            time.sleep(0.1)
        if first_fault is not None:
            # survivors wait in collectives whose peer died; SIGTERM may
            # not end them, so SIGKILL after grace
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            t0 = time.time()
            while (any(p.poll() is None for p in procs)
                   and time.time() - t0 < GRACE_S):
                time.sleep(0.1)
            for p in procs:
                if p.poll() is None:
                    p.kill()
        outputs = []
        for p, log in zip(procs, logs):
            p.wait()
            log.close()
            outputs.append(Path(log.name).read_text())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(store_dir, ignore_errors=True)
        if own_logs:
            shutil.rmtree(log_dir, ignore_errors=True)
    if first_fault is not None:
        return first_fault, outputs
    return next((p.returncode for p in procs if p.returncode != 0),
                0), outputs


__all__ = ["EXIT_FAULT", "GRACE_S", "child_env", "exchange_dir_of",
           "initialize_distributed", "launch_local", "worker_main"]
