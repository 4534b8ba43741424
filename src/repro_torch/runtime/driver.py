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

A port of the reference package's ``runtime/driver.py`` in three modes:

* ``mode="single"`` steps the single-controller round on a Graph built
  from the source on ``device`` (``core.graph.as_graph``: a Graph, an edge
  array, an ``EdgeFile`` or a ``PackedCSR``);
* ``mode="spmd"`` runs on every rank of an initialised
  ``torch.distributed`` group, as ``partition_spmd`` does, one shard per
  rank: each rank ingests the whole source the way ``partition_spmd``
  does (``dist.partitioner_sm.shard_input``: a Graph shards in memory, a
  canonical EdgeFile streams to the padded shards) and keeps its own row;
* ``mode="spmd"`` with an ``exchange_dir`` is a **multi-controller**
  run, the paper's deployment (§7, one process a machine): each rank
  streams only its own host block range of a canonical EdgeFile into the
  exchange (``runtime.cluster.exchange_write_range``), meets a barrier
  and assembles only its own shard (``exchange_assemble``), so no rank
  holds the O(M) edge list.  The finalize is sharded
  (``runtime.finalize``: each rank cleans up its own slice, the quality
  metrics combine from (P,) partials and the replica maps by an OR
  all-reduce) and returns a *lazy* ``edge_part``; snapshots and
  artifacts go through the multi-writer protocols, each rank writing its
  own shard.  The rule that picks this path: an ``exchange_dir`` in mode
  ``"spmd"``, at any world size, 1 included.  The reference takes it
  when ``jax.process_count() > 1``; the port runs one shard a rank at
  every world size, so rank ``h`` is host ``h``, the device count is the
  world size, and a rank owns shard ``[rank]``;
* ``mode="hybrid"`` drives the HEP-style hybrid (``cfg`` must then be a
  :class:`repro_torch.core.hybrid.HybridConfig`; the source a Graph or a
  canonical EdgeFile): the tail is grid-hashed at ingest, rounds step the
  same ``_round`` over the low subgraph from the seeded state on
  ``device``, and finalize stitches through ``hybrid_finalize``.  It is
  single-controller, and its snapshots are ``"single"``'s (the seeded
  state is just an NEState over the low edges).

Snapshots go every ``snapshot_every`` rounds through
:class:`repro_torch.runtime.snapshot.RunSnapshot` (sharded files, fsync +
atomic rename, config/graph fingerprints) in the reference's layout and
dtypes: in spmd mode the ranks all-gather their ``edge_part`` rows and
rank 0 writes one ``edge_part.shard<i>.bin`` a rank (a multi-controller
run writes the same files, each rank its own).  Resume against the
wrong source, config or mode fails loudly; a snapshot taken at another
rank count reshards (elastic resume): in memory, or through the store
(``cluster.reshard_write``) in a multi-controller run.
``save_artifact`` persists the finalized result (rank 0 writes; every
rank its own partitions' contributions in a multi-controller run).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.epilogue import alpha_limit
from repro_torch.core.graph import to_device
from repro_torch.core.graph import as_graph
from repro_torch.core.hybrid import (HybridConfig, hybrid_finalize,
                                     hybrid_init_state, hybrid_split)
from repro_torch.core.partitioner import (NEConfig, NEState, PartitionResult,
                                          finalize_result, ne_done,
                                          ne_init_state, ne_round_step,
                                          state_from_numpy, state_to_numpy)
from repro_torch.dist import compat
from repro_torch.dist import partitioner_sm as sm
from repro_torch.core.metrics import stats_from_counts
from repro_torch.io.csr import grid_assign_host
from repro_torch.io.edgefile import EdgeFile
from repro_torch.io.stream import require_canonical
from repro_torch.kernels.ne_round import ref as ne_ref
from repro_torch.obs import live
from repro_torch.obs import trace as obs
from repro_torch.runtime import artifact as art
from repro_torch.runtime import cluster
from repro_torch.runtime import finalize as fz
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
    single-controller round on ``device`` (``None``: the card);
    ``mode="hybrid"`` the hybrid's expansion rounds (``cfg`` a
    ``HybridConfig``; ``device=None``: a Graph's own device, the card
    for an EdgeFile).  An ``exchange_dir`` (mode ``"spmd"`` only, any
    world size) makes the run multi-controller: a canonical EdgeFile
    ingested a block range a rank through the exchange, the finalize
    sharded, snapshots and artifacts written by every rank (module
    docstring).  One
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
        if mode not in ("spmd", "single", "hybrid"):
            raise ValueError(f"unknown mode {mode!r}")
        if exchange_dir is not None and mode != "spmd":
            raise ValueError(f"mode={mode!r} is single-controller; an "
                             "exchange_dir drives a multi-controller run, "
                             "which is mode='spmd'")
        self.mode = mode
        self.source = source
        self.snapshot_every = int(snapshot_every)
        self._group = group
        self._result: PartitionResult | None = None
        self._done: bool | None = None
        self.multihost = exchange_dir is not None
        self._final_slices = None   # set by the sharded finalize
        # test-only crash-injection point of the multi-writer snapshot
        # protocol (RunSnapshot.save_state_multihost); never set in
        # production runs
        self.snapshot_fault_hook = None

        with obs.span("ingest", cat="runtime", mode=mode):
            if mode == "single":
                self._init_single(source, cfg, device)
            elif mode == "hybrid":
                self._init_hybrid(source, cfg, device)
            elif self.multihost:
                self._init_multihost(source, cfg, num_devices, exchange_dir,
                                     device)
            else:
                self._init_spmd(source, cfg, num_devices, device)

        # per-round SyncVertexAllocations traffic (per rank) — a pure
        # function of the config, recorded as a cumulative trace counter
        self._sync_bytes = (0 if mode in ("single", "hybrid") else
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

    def _init_hybrid(self, source, cfg, device):
        if compat.process_env()[1] > 1:
            raise ValueError("mode='hybrid' is single-controller by "
                             "definition — multi-process runs drive the "
                             "SPMD partitioner (mode='spmd')")
        if not isinstance(cfg, HybridConfig):
            raise TypeError("mode='hybrid' takes a HybridConfig, "
                            f"got {type(cfg).__name__}")
        self._graph_fp = graph_fingerprint(source)
        split = hybrid_split(source, cfg, device=device)
        self.cfg = cfg.clamped(split.num_vertices)
        self._necfg = self.cfg.ne_config()
        self._split = split
        self._graph = split.low
        self._device = split.low.device
        self.num_devices = 1
        # n and m are the whole graph's; the round state holds the low
        # edges only (edge_part is (M_low,)), as in the reference
        self.n, self.m = split.num_vertices, split.num_edges
        self._edges = None          # read back by save_artifact only
        self.limit = alpha_limit(self.cfg.alpha, self.m,
                                 self.cfg.num_partitions)
        self.state = hybrid_init_state(split, self._necfg)

    def _join_group(self, num_devices, device) -> int:
        """This rank, its device and the device count (the world size of
        the group); returns the world size."""
        sm.require_group()
        self._rank = dist.get_rank(self._group)
        world = dist.get_world_size(self._group)
        if num_devices not in (None, world):
            raise ValueError(f"num_devices={num_devices}: the SPMD driver "
                             f"runs one shard a rank of its group (world "
                             f"size {world})")
        self.num_devices = world
        self._device = sm.rank_device(self._rank, device)
        return world

    def _init_spmd(self, source, cfg: NEConfig, num_devices, device):
        world = self._join_group(num_devices, device)
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

    def _init_multihost(self, source, cfg: NEConfig, num_devices,
                        exchange_dir, device):
        """Multi-controller construction: this rank streams only its own
        host block range into the exchange, meets a barrier and
        assembles only its own shard.  The edge list and the per-edge
        device map are never built; the sharded finalize reads what it
        needs of them from the exchange."""
        if not isinstance(source, EdgeFile):
            raise TypeError(
                "multi-controller runs partition a canonical EdgeFile — "
                "every process must ingest its own block range, got "
                f"{type(source).__name__}")
        require_canonical(source)
        world = self._join_group(num_devices, device)
        self._graph_fp = graph_fingerprint(source)
        self._exchange_dir = os.fspath(exchange_dir)
        self.n, self.m = int(source.num_vertices), int(source.num_edges)
        self.cfg = cfg.clamped(self.n)
        self.limit = alpha_limit(self.cfg.alpha, self.m,
                                 self.cfg.num_partitions)
        r = self._rank
        with obs.span("exchange_write", cat="runtime"):
            cluster.exchange_write_range(self._exchange_dir, source.path, r,
                                         world, world)
        self._barrier("ingest-exchange")
        with obs.span("exchange_assemble", cat="runtime"):
            shards, masks, self._cap, degree = cluster.exchange_assemble(
                self._exchange_dir, world, world, [r])
        self._u, self._v, self._mask = (
            to_device(a, self._device)
            for a in (shards[r][:, 0], shards[r][:, 1], masks[r]))
        self.state = sm.spmd_state0(self._cap, degree, self.m, self.cfg,
                                    device=self._device)
        self._edges = None
        self._dev = None

    def _barrier(self, name: str) -> None:
        compat.barrier(name, self._group)

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
            elif self.mode in ("single", "hybrid"):
                # HybridConfig carries max_rounds, so ne_done reads either
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
            if self.mode in ("single", "hybrid"):
                cfg = self.cfg if self.mode == "single" else self._necfg
                self.state = ne_round_step(self._graph, cfg, self.limit,
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
            self._final_slices = None
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
            if self.mode == "hybrid":
                self._result = hybrid_finalize(self.state, self._split,
                                               self.cfg)
            elif self.mode == "single":
                self._result = finalize_result(
                    self.state.edge_part, self.state.vparts,
                    self.state.edges_per_part, self._edges, self.cfg,
                    self.rounds)
            elif self.multihost:
                self._result = self._finalize_multihost()
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

    def _finalize_multihost(self) -> PartitionResult:
        """The sharded finalize (see ``runtime.finalize``).

        Every per-edge array here is this rank's slice; what crosses
        ranks is the sorted leftover-eid spills in the exchange, a scalar
        sum and the O(N·P) replica-map OR.  The result's ``edge_part`` is
        lazy: forcing it is the one deliberate O(M) all-gather, a
        collective every rank makes together.
        """
        p_num = self.cfg.num_partitions
        r, world = self._rank, self.num_devices
        ep = {r: self.state.edge_part.cpu().numpy().copy()}
        us = {r: self._u.cpu().numpy()}
        vs = {r: self._v.cpu().numpy()}
        eids = cluster.shard_eids(self._exchange_dir, world, [r])
        counts = self.state.edges_per_part.cpu().numpy().copy()
        vparts = ne_ref.unpack_bits_np(self.state.vparts.cpu().numpy(),
                                       p_num)
        fin_dir = os.path.join(self._exchange_dir, "finalize")
        my_left = fz.stage_leftovers(fin_dir, r, ep, eids)
        total = compat.all_processes_sum(my_left.size, self._group)
        self._barrier("finalize-leftovers")
        take, _ = fz.apply_leftovers(
            fin_dir, r, world, my_left, ep, us, vs, eids, counts,
            self.limit, p_num, vparts, leftover_total=total)
        vparts = compat.all_processes_any(vparts, self._group)
        counts = (counts.astype(np.int64) + take).astype(np.int32)
        stats = stats_from_counts(vparts.sum(axis=0), counts, self.n)
        self._final_slices = (ep, us, vs, eids)
        # only what materializing needs: closing over the whole state
        # would pin every round tensor for the result's lifetime
        ep_rank, group = self.state.edge_part, self._group
        exchange_dir, m = self._exchange_dir, self.m

        def materialize() -> np.ndarray:
            if os.environ.get("REPRO_FORBID_EDGE_PART_MATERIALIZE"):
                raise RuntimeError(
                    "REPRO_FORBID_EDGE_PART_MATERIALIZE is set: the "
                    "multi-process epilogue must never materialize the "
                    "O(M) global edge assignment")
            ep_sh = compat.all_gather_rows(ep_rank, group).cpu().numpy()
            _, dev = cluster.exchange_read_global(exchange_dir, world)
            full = sm.stitch_edge_part(ep_sh, dev, m)
            left_eids, left_tgt = fz.leftover_assignments(fin_dir, world,
                                                          take)
            full[left_eids] = left_tgt
            return full

        return PartitionResult(materialize, vparts, counts, self.rounds,
                               int(total), stats)

    # -- snapshots ----------------------------------------------------------

    def save_snapshot(self):
        """Persist the current round state (crash-safe, fingerprinted).

        In spmd mode every rank calls it: the ranks all-gather their
        ``edge_part`` rows, rank 0 writes the step (one shard file a rank)
        and every rank then meets a barrier, so no rank steps on before
        the round is published.  A multi-controller run goes through the
        multi-writer protocol instead: each rank writes only its own
        shard, rank 0 stages the replicated fields and publishes the
        round once every rank's shard is staged
        (``RunSnapshot.save_state_multihost``).  Returns the step dir on
        the writer, ``None`` on the other ranks.
        """
        if self.snapshot is None:
            raise RuntimeError("driver was built without a snapshot_dir")
        with obs.span("snapshot", cat="runtime", round=self.rounds):
            if self.mode in ("single", "hybrid"):
                return self.snapshot.save_state(
                    self.rounds, state_to_numpy(self.state), self.mode)
            fields = sm.spmd_state_to_numpy(self.state)
            if self.multihost:
                row = fields.pop("edge_part")
                return self.snapshot.save_state_multihost(
                    self.rounds, fields, self.mode, self._rank,
                    {"edge_part": {self._rank: row}},
                    {"edge_part": self.num_devices}, self._barrier,
                    fault_hook=self.snapshot_fault_hook)
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
            if self.multihost:
                return self._restore_multihost(round_k)
            fields, rnd, mode = self.snapshot.restore_state(round_k)
            if mode != self.mode:
                raise SnapshotMismatch(f"snapshot was taken in mode "
                                       f"{mode!r}, driver is {self.mode!r}")
            want = (sm.SpmdState if self.mode == "spmd" else NEState)._fields
            missing = set(want) - set(fields)
            if missing:
                raise SnapshotMismatch(f"snapshot is missing fields "
                                       f"{missing}")
            if self.mode in ("single", "hybrid"):
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
        self._final_slices = None
        self._done = None
        return rnd

    def _restore_multihost(self, round_k: int | None) -> int:
        """Each rank loads only its own ``edge_part`` row of the newest
        round it can read in full; the ranks agree on the least such
        round (one rank's torn shard rolls every rank back alike), and
        meet a barrier before the first step."""
        r = self._rank
        load = dict(num_devices=self.num_devices, host=r,
                    num_hosts=self.num_devices)
        fields, rnd, mode, counts = \
            self.snapshot.restore_state_multihost([r], round_k, **load)
        if round_k is None:
            agreed = compat.all_processes_min(rnd, self._group)
            if agreed != rnd:
                fields, rnd, mode, counts = \
                    self.snapshot.restore_state_multihost(
                        [r], round_k=agreed, **load)
        if mode != self.mode:
            raise SnapshotMismatch(f"snapshot was taken in mode {mode!r}, "
                                   f"driver is {self.mode!r}")
        missing = set(sm.SpmdState._fields) - set(fields)
        if missing:
            raise SnapshotMismatch(f"snapshot is missing fields {missing}")
        d_old = counts.get("edge_part")
        if d_old != self.num_devices:
            # elastic resume onto another rank count: the loaded rows
            # follow the old layout; reshard them through the store
            fields["edge_part"] = self._reshard_multihost(
                fields["edge_part"], d_old, rnd)
        elif fields["edge_part"][r].shape != (self._cap,):
            raise SnapshotMismatch(
                f"snapshot edge_part shard {r} has shape "
                f"{fields['edge_part'][r].shape} != current capacity "
                f"({self._cap},)")
        self.state = sm.spmd_state_from_numpy(fields, device=self._device,
                                              group=self._group)
        self._result = None
        self._final_slices = None
        self._done = None
        self._barrier(f"resume-{rnd}")
        return rnd

    def _reshard_multihost(self, old_slices: dict, d_old: int,
                           rnd: int) -> dict:
        """Elastic reshard through the store: stage my old rows' (eid,
        value) pairs a new shard, barrier, assemble my own new row
        (``cluster.reshard_write`` / ``reshard_assemble``)."""
        spill = os.path.join(self._exchange_dir,
                             f"reshard_{rnd:010d}_{d_old}to"
                             f"{self.num_devices}")
        cluster.reshard_write(spill, self._exchange_dir, self.num_devices,
                              old_slices, d_old, self.num_devices,
                              self._rank)
        self._barrier(f"reshard-{rnd}")
        return cluster.reshard_assemble(spill, self.num_devices,
                                        [self._rank], self._cap)

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
        if self.multihost:
            return self._save_artifact_multihost(dirpath, res)
        if self._edges is None:
            # hybrid mode never holds the source edge list for the round
            # loop; the artifact save is the one consumer that needs it
            self._edges = (self.source.read_all()
                           if isinstance(self.source, EdgeFile)
                           else self.source.edges.cpu().numpy())
        if self.mode != "spmd" or self._rank == 0:
            save_artifact(dirpath, res, self._edges, self.n,
                          config_fingerprint=config_fingerprint(self.cfg),
                          graph_fingerprint=self._graph_fp)
        if self.mode == "spmd":
            dist.barrier(group=self._group)
        return PartitionArtifact(dirpath)

    def _save_artifact_multihost(self, dirpath, res) -> PartitionArtifact:
        """The multi-writer artifact: rank 0 begins, every rank spills
        its slice's contributions a partition, each rank encodes the
        partitions it owns (``p % world == rank``), rank 0 publishes.
        The bytes equal a single-writer save of the same result, and no
        rank holds the global assignment."""
        p_num = self.cfg.num_partitions
        r, world = self._rank, self.num_devices
        meta = dict(config_fingerprint=config_fingerprint(self.cfg),
                    graph_fingerprint=self._graph_fp)
        if self._final_slices is None:
            # m == 0: finalize took the empty-result path, nothing is
            # sharded; rank 0 runs the single-writer save
            if r == 0:
                save_artifact(dirpath, res, np.zeros((0, 2), np.int32),
                              self.n, **meta)
            self._barrier("artifact-empty")
            return PartitionArtifact(dirpath)
        ep, us, vs, eids = self._final_slices
        if r == 0:
            art.begin_shared_artifact(dirpath)
        self._barrier("artifact-begin")
        art.write_artifact_contrib(
            dirpath, r, fz.partition_contribs(ep, us, vs, eids, p_num))
        self._barrier("artifact-contrib")
        # as many encoding threads as torch's (a local gang's workers
        # split the host's cores between them)
        art.encode_shared_parts(dirpath, r, list(range(r, p_num, world)),
                                world, threads=torch.get_num_threads())
        self._barrier("artifact-encode")
        if r == 0:
            art.publish_shared_artifact(
                dirpath, num_vertices=self.n, num_edges=self.m,
                num_partitions=p_num, num_hosts=world, vparts=res.vparts,
                edges_per_part=res.edges_per_part, rounds=res.rounds,
                leftover=res.leftover, **meta)
        self._barrier("artifact-publish")
        return PartitionArtifact(dirpath)


__all__ = ["PartitionDriver"]
