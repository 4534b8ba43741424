"""Round-level state machine over Distributed NE — pause, snapshot, resume.

``partition`` / ``partition_spmd`` run every round in one call and
nothing survives a crash.  The :class:`PartitionDriver` re-expresses the
same computation as a host-driven state machine — one call per paper
round, of *exactly the round function those entry points loop over*
(``core.partitioner._round`` / ``dist.partitioner_sm.spmd_round_step``).
All round state is integer or counter-mode PRNG, so stepping is
bit-identical to the uninterrupted loop, and therefore so is
kill-at-round-k + resume-from-snapshot (tests/test_torch_runtime.py, and
``chip_smoke.py``'s phase 9 with a killed process on the card).

A port of the reference package's ``runtime/driver.py`` in two modes:

* ``mode="single"`` steps the single-controller round on a Graph built
  from the source on ``device`` (``core.graph.as_graph``: a Graph, an edge
  array, an ``EdgeFile`` or a ``PackedCSR``);
* ``mode="spmd"`` runs on every rank of an initialised
  ``torch.distributed`` group, as ``partition_spmd`` does, one shard per
  rank: each rank ingests the whole source the way ``partition_spmd``
  does (``dist.partitioner_sm.shard_input``: a Graph shards in memory, a
  canonical EdgeFile streams to the padded shards) and keeps its own row.

Snapshots go every ``snapshot_every`` rounds through
:class:`repro_torch.runtime.snapshot.RunSnapshot` (sharded files, fsync +
atomic rename, config/graph fingerprints) in the reference's layout and
dtypes: in spmd mode the ranks all-gather their ``edge_part`` rows and
rank 0 writes one ``edge_part.shard<i>.bin`` a rank.  Resume against the
wrong source, config or mode fails loudly; a snapshot taken at another
rank count reshards in memory (elastic resume).  ``save_artifact``
persists the finalized result (rank 0 writes).

Not in this slice, each raising ``NotImplementedError``: ``mode="hybrid"``
(``core/hybrid.py``, ROADMAP §1 item 3) and the reference's
multi-controller runs, where each rank ingests only its own block range
through an ``exchange_dir`` and finalize and artifact writing are sharded
(``runtime/{multihost,finalize}.py``, ROADMAP §1 item 2).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.epilogue import alpha_limit
from repro_torch.core.graph import as_graph
from repro_torch.core.partitioner import (NEConfig, NEState, PartitionResult,
                                          finalize_result, ne_done,
                                          ne_init_state, ne_round_step,
                                          state_from_numpy, state_to_numpy)
from repro_torch.dist import compat
from repro_torch.dist import partitioner_sm as sm
from repro_torch.io.csr import grid_assign_host
from repro_torch.io.edgefile import EdgeFile
from repro_torch.obs import live
from repro_torch.obs import trace as obs
from repro_torch.runtime.artifact import PartitionArtifact, save_artifact
from repro_torch.runtime.snapshot import (RunSnapshot, SnapshotMismatch,
                                          config_fingerprint,
                                          graph_fingerprint)


class PartitionDriver:
    """Interruptible, resumable Distributed NE run.

    ``mode="spmd"`` (default) drives the SPMD round on this rank of
    ``group`` (default the world; ``num_devices`` must be ``None`` or the
    world size), its shard on ``device`` (``None``: the card
    ``cuda:(rank % count)``); ``mode="single"`` drives the
    single-controller round on ``device`` (``None``: the card).  One
    :meth:`step` == one paper round; :meth:`run` loops to completion
    with periodic snapshots; :meth:`resume` rebuilds a driver from the
    latest (or a chosen) snapshot.
    """

    def __init__(self, source, cfg: NEConfig, num_devices: int | None = None,
                 mode: str = "spmd",
                 snapshot_dir: str | os.PathLike | None = None,
                 snapshot_every: int = 0, keep: int = 3,
                 exchange_dir: str | os.PathLike | None = None,
                 device=None, group=None):
        if mode == "hybrid":
            raise NotImplementedError(
                "mode='hybrid' needs core/hybrid.py, which ROADMAP §1 item 3 "
                "(baselines and the hybrid partitioner) ports")
        if mode not in ("spmd", "single"):
            raise ValueError(f"unknown mode {mode!r}")
        if exchange_dir is not None:
            raise NotImplementedError(
                "multi-controller runs (each rank ingests only its own block "
                "range through an exchange_dir; sharded finalize and "
                "artifact) need runtime/{multihost,finalize}.py, which "
                "ROADMAP §1 item 2 ports")
        self.mode = mode
        self.source = source
        self.snapshot_every = int(snapshot_every)
        self._group = group
        self._result: PartitionResult | None = None
        self._done: bool | None = None

        with obs.span("ingest", cat="runtime", mode=mode):
            if mode == "single":
                self._init_single(source, cfg, device)
            else:
                self._init_spmd(source, cfg, num_devices, device)

        # per-round SyncVertexAllocations traffic (per rank) — a pure
        # function of the config, recorded as a cumulative trace counter
        self._sync_bytes = (0 if mode == "single" else
                            sm.round_sync_payload_bytes(self.cfg, self.n,
                                                        self.num_devices))
        self._sync_total = 0
        if live.live_enabled():
            live.publish(phase="ingest", round=0, edges_remaining=self.m)
        self.snapshot = (RunSnapshot(snapshot_dir, self.cfg, self._graph_fp,
                                     keep=keep)
                         if snapshot_dir is not None else None)

    def _init_single(self, source, cfg: NEConfig, device):
        if compat.process_env()[1] > 1:
            raise ValueError("mode='single' is single-controller by "
                             "definition — multi-process runs drive the "
                             "SPMD partitioner (mode='spmd')")
        # a store handle is fingerprinted by its header and block index,
        # anything else by the edges of the Graph it builds
        g = as_graph(source, device=device)
        self._graph_fp = graph_fingerprint(
            source if isinstance(source, EdgeFile) else g)
        self.cfg = cfg.clamped(g.num_vertices)
        self._graph = g
        self._device = g.device
        self.num_devices = 1
        self.n, self.m = g.num_vertices, g.num_edges
        self._edges = g.edges.cpu().numpy()
        self.limit = alpha_limit(self.cfg.alpha, self.m,
                                 self.cfg.num_partitions)
        self.state: NEState | sm.SpmdState = ne_init_state(g, self.cfg)

    def _init_spmd(self, source, cfg: NEConfig, num_devices, device):
        sm.require_group()
        self._rank = dist.get_rank(self._group)
        world = dist.get_world_size(self._group)
        if num_devices not in (None, world):
            raise ValueError(f"num_devices={num_devices}: the SPMD driver "
                             f"runs one shard a rank of its group (world "
                             f"size {world})")
        self.num_devices = world
        self._device = sm.rank_device(self._rank, device)
        self._graph_fp = graph_fingerprint(source)
        self.n, self.m, self._edges, shards, masks, self._dev = \
            sm.shard_input(source, world)
        self.cfg = cfg.clamped(self.n)
        self.limit = alpha_limit(self.cfg.alpha, self.m,
                                 self.cfg.num_partitions)
        self._cap = masks.shape[1]
        self._u, self._v, self._mask = sm.rank_shard(shards, masks,
                                                     self._rank, self._device)
        self.state = sm.spmd_init_state(shards, masks, self.n, self.cfg,
                                        device=self._device)

    # -- state machine ------------------------------------------------------

    @property
    def rounds(self) -> int:
        return int(self.state.rounds)

    @property
    def done(self) -> bool:
        # cached per state: run() + step() both consult it every round
        if self._done is None:
            if self.m == 0:
                self._done = True
            elif self.mode == "single":
                self._done = ne_done(self.state, self.cfg)
            else:
                self._done = sm.spmd_done(self.state, self.cfg)
        return self._done

    def step(self) -> int:
        """Advance one paper round; returns the completed round count.

        Stepping past :attr:`done` is a no-op (the driver never runs the
        round function on a finished state, matching the loop condition).
        """
        if self.done:
            return self.rounds
        tr = obs.get_tracer()
        sp = (tr.span("round", cat="runtime") if tr is not None
              else obs.NULL_SPAN)
        # the round span covers the snapshot save too (nested "snapshot"
        # span): per-round cost as a long run pays it
        with sp:
            if self.mode == "single":
                self.state = ne_round_step(self._graph, self.cfg, self.limit,
                                           self.state)
            else:
                self.state = sm.spmd_round_step(
                    self.cfg, self.limit, self.n, self._u, self._v,
                    self._mask, self.state, self._group)
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)   # the span times it
            if tr is not None:
                sp.set(round=self.rounds)
                rem = getattr(self.state, "remaining", None)
                if rem is not None:
                    tr.counter("edges_remaining", int(rem))
                if self._sync_bytes:
                    tr.add("sync_payload_bytes", self._sync_bytes)
            self._sync_total += self._sync_bytes
            if live.live_enabled():
                # pure read of the replicated state (no RNG, no mutation),
                # so monitored runs stay bit-identical to unmonitored
                q = sm.round_quality(self.cfg, self.state, self.n)
                rem = getattr(self.state, "remaining", None)
                rem = (int(rem) if rem is not None
                       else q["degree_sum"] // 2)
                live.publish(phase="round", round=self.rounds,
                             edges_remaining=rem,
                             sync_payload_bytes=self._sync_total,
                             rf=q["rf"], eb=q["eb"], vb=q["vb"],
                             boundary=q["boundary"])
            self._result = None
            self._done = None
            if (self.snapshot is not None and self.snapshot_every
                    and self.rounds % self.snapshot_every == 0):
                self.save_snapshot()
        return self.rounds

    def run(self) -> PartitionResult:
        """Step to the fixed point (snapshotting as configured), finalize."""
        while not self.done:
            self.step()
        return self.finalize()

    def finalize(self) -> PartitionResult:
        """Cleanup epilogue, cached until the state advances: the shards'
        assignments gathered and stitched back to edge order (spmd), the
        replica words unpacked, the leftovers water-filled.  Every rank
        returns the same result."""
        if self._result is not None:
            return self._result
        if self.m == 0:
            self._result = sm.empty_result(self.n, self.cfg.num_partitions)
            self._publish_live_done()
            return self._result
        with obs.span("finalize", cat="runtime", mode=self.mode):
            if self.mode == "single":
                self._result = finalize_result(
                    self.state.edge_part, self.state.vparts,
                    self.state.edges_per_part, self._edges, self.cfg,
                    self.rounds)
            else:
                self._result = sm.spmd_result(self.state, self._dev,
                                              self._edges, self.cfg,
                                              self._group)
        self._publish_live_done()
        return self._result

    def _publish_live_done(self):
        """Terminal bus snapshot: the finalized (post-cleanup) quality,
        flagged ``done`` so the monitor can distinguish a finished run
        from a stalled one."""
        if not live.live_enabled():
            return
        st = self._result.stats if self._result is not None else None
        live.publish(
            phase="done", round=self.rounds, edges_remaining=0,
            sync_payload_bytes=self._sync_total,
            rf=st.replication_factor if st is not None else None,
            eb=st.edge_balance if st is not None else None,
            vb=st.vertex_balance if st is not None else None,
            done=True)

    # -- snapshots ----------------------------------------------------------

    def save_snapshot(self):
        """Persist the current round state (crash-safe, fingerprinted).

        In spmd mode every rank calls it: the ranks all-gather their
        ``edge_part`` rows, rank 0 writes the step (one shard file a rank)
        and every rank then meets a barrier, so no rank steps on before
        the round is published.  Returns the step dir on the writer,
        ``None`` on the other ranks.
        """
        if self.snapshot is None:
            raise RuntimeError("driver was built without a snapshot_dir")
        with obs.span("snapshot", cat="runtime", round=self.rounds):
            if self.mode == "single":
                return self.snapshot.save_state(
                    self.rounds, state_to_numpy(self.state), self.mode)
            fields = sm.spmd_state_to_numpy(self.state)
            fields["edge_part"] = compat.all_gather_rows(
                self.state.edge_part, self._group).cpu().numpy()
            path = None
            if self._rank == 0:
                path = self.snapshot.save_state(self.rounds, fields,
                                                self.mode)
            dist.barrier(group=self._group)
            return path

    def restore_snapshot(self, round_k: int | None = None) -> int:
        """Load round state from the snapshot store (latest by default).

        Every rank reads the same published step (a torn newest step
        falls back to the previous one on all of them alike) and keeps
        its own ``edge_part`` row.  A snapshot taken at another rank count
        reshards in memory first.
        """
        if self.snapshot is None:
            raise RuntimeError("driver was built without a snapshot_dir")
        with obs.span("restore", cat="runtime"):
            fields, rnd, mode = self.snapshot.restore_state(round_k)
            if mode != self.mode:
                raise SnapshotMismatch(f"snapshot was taken in mode "
                                       f"{mode!r}, driver is {self.mode!r}")
            want = (sm.SpmdState if self.mode == "spmd" else NEState)._fields
            missing = set(want) - set(fields)
            if missing:
                raise SnapshotMismatch(f"snapshot is missing fields "
                                       f"{missing}")
            if self.mode == "single":
                self.state = state_from_numpy(fields, device=self._device)
            else:
                if fields["edge_part"].shape != (self.num_devices,
                                                 self._cap):
                    # elastic resume: the snapshot was taken at another
                    # rank count — reshard the slices onto this layout
                    fields["edge_part"] = self._reshard_in_memory(
                        fields["edge_part"])
                self.state = sm.spmd_state_from_numpy(
                    fields, device=self._device, group=self._group)
        self._result = None
        self._done = None
        return rnd

    def _reshard_in_memory(self, old: np.ndarray) -> np.ndarray:
        """Elastic reshard: old (D_old, C_old) slices → the current
        (D, C) layout, preserving every per-edge value.  The shard layout
        is a pure function of the 2D hash, so the old per-edge device map
        re-derives deterministically."""
        dev_old = grid_assign_host(self._edges, old.shape[0])
        full = sm.stitch_edge_part(old, dev_old, self.m)
        new = np.full((self.num_devices, self._cap), -1, np.int32)
        for d in range(self.num_devices):
            sel = np.flatnonzero(self._dev == d)
            new[d, : sel.size] = full[sel]
        return new

    @classmethod
    def resume(cls, source, cfg: NEConfig,
               snapshot_dir: str | os.PathLike, round_k: int | None = None,
               **kwargs) -> "PartitionDriver":
        """Rebuild a driver from ``snapshot_dir`` and continue from the
        latest (or ``round_k``-th) snapshot.  The edge shards are re-derived
        from ``source``; the snapshot's fingerprints guarantee that is the
        same derivation the interrupted run made."""
        drv = cls(source, cfg, snapshot_dir=snapshot_dir, **kwargs)
        drv.restore_snapshot(round_k)
        return drv

    # -- durable output -----------------------------------------------------

    def save_artifact(self, dirpath: str | os.PathLike) -> PartitionArtifact:
        """Finalize and persist the run's output as a partition artifact
        (in spmd mode every rank calls it; rank 0 writes, then all meet a
        barrier)."""
        res = self.finalize()
        if self.mode == "single" or self._rank == 0:
            save_artifact(dirpath, res, self._edges, self.n,
                          config_fingerprint=config_fingerprint(self.cfg),
                          graph_fingerprint=self._graph_fp)
        if self.mode == "spmd":
            dist.barrier(group=self._group)
        return PartitionArtifact(dirpath)


__all__ = ["PartitionDriver"]
