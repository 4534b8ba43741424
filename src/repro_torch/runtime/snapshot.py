"""Per-round partitioner snapshots: sharded checkpoint layout + fingerprints.

A copy of the reference package's ``runtime/snapshot.py``; a snapshot
directory the port writes is byte-identical to the reference driver's
(run with ``use_pallas=True``) at the same round, and each package
restores the other's.  Two layers:

* :class:`ShardedCheckpointManager` — a ``train.checkpoint.CheckpointManager``
  extension where designated arrays are written one file per leading-axis
  shard (``<name>.shard<i>.bin``) instead of into the monolithic
  ``data.bin``.  In a multi-host deployment host ``h`` writes and reads only
  its own shard file; locally the manager stacks them back transparently.
  It inherits the crash-safety contract: everything stages in a dot-prefixed
  tmp dir, every file is fsynced, and the step publishes with one atomic
  rename — a kill at any point leaves the previous step intact.

* :class:`RunSnapshot` — the partitioner-specific façade: saves an
  ``SpmdState`` / ``NEState`` keyed by round number, stamps the manifest
  with config + graph fingerprints, and *refuses to restore* against a
  different ``NEConfig`` or a different edge source — a resume that
  silently mixed graphs would produce garbage partitions that still look
  plausible.

Snapshots hold only the round state (edge assignments, replica sets,
D_rest, |E_p|, PRNG key, counters), in the reference's dtypes (packed
replica words and the key as uint32) — never the edge shards themselves,
which are re-derived deterministically from the source; the graph
fingerprint is what makes that re-derivation safe.

**The config fingerprint.**  The reference hashes every field of its
``NEConfig``, which has two fields the port's lacks: ``sel_chunk`` (how
many partitions one selection call scores; the port selects all P rows
in one call, with the same result) and ``use_pallas`` (the fused kernels
and bit-packed SPMD replica sets, which the port always runs).  The
port's fingerprint hashes the reference's field set with
``sel_chunk = 8`` (its default) and ``use_pallas = True``, the
reference's behaviour that the port's matches.  So a port snapshot or
artifact is byte-identical to the one the reference's driver writes with
``use_pallas=True`` at the same other fields, and a resume across the
two packages checks the same fingerprint.

The module imports numpy only: tensors are copied to the host
duck-typed, and a config is read through ``dataclasses.asdict``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

import numpy as np

from repro_torch.io.atomicdir import fsync_path
from repro_torch.io.csr import to_numpy
from repro_torch.io.edgefile import EdgeFile
from repro_torch.obs import trace as obs
from repro_torch.train.checkpoint import CheckpointManager, host_flat

# the reference NEConfig fields the port's has not, at the values whose
# behaviour the port's round has (see the module docstring)
REFERENCE_ONLY_FIELDS = {"sel_chunk": 8, "use_pallas": True}


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def config_fingerprint(cfg) -> str:
    """Stable digest of every NEConfig field — any hyper-parameter change
    (partitions, α, λ, seed, chunking…) changes the expansion trajectory,
    so any change must invalidate a resume.  Hashes the reference's field
    set (see the module docstring), so it equals the reference's digest
    of the same config with ``use_pallas=True``."""
    fields = dict(REFERENCE_ONLY_FIELDS, **dataclasses.asdict(cfg))
    payload = json.dumps(fields, sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def graph_fingerprint(source) -> str:
    """Digest identifying the edge source a snapshot was taken against.

    For an :class:`EdgeFile` this hashes the header fields plus the full
    per-block (count, vmin, vmax) index — no data blocks are read, so it
    stays O(num_blocks) even for store-scale files while still catching
    any edge-content change that moves a block's count or vertex range.
    In-memory sources (a port Graph on any device, or an edge array)
    hash the edge bytes themselves, as int64.
    """
    h = hashlib.sha1()
    if isinstance(source, EdgeFile):
        h.update(f"edgefile:{source.num_vertices}:{source.num_edges}:"
                 f"{source.block_size}:{source.flags}".encode())
        h.update(np.ascontiguousarray(source.block_counts).tobytes())
        h.update(np.ascontiguousarray(source.block_vmin).tobytes())
        h.update(np.ascontiguousarray(source.block_vmax).tobytes())
        return h.hexdigest()[:16]
    edges = to_numpy(source.edges if hasattr(source, "edges") else source)
    n = (source.num_vertices if hasattr(source, "num_vertices")
         else int(edges.max()) + 1 if edges.size else 0)
    h.update(f"edges:{n}:{edges.shape[0]}".encode())
    h.update(np.ascontiguousarray(edges, dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# sharded checkpoint manager
# ---------------------------------------------------------------------------

class ShardedCheckpointManager(CheckpointManager):
    """Checkpoint dirs with per-shard array files alongside ``data.bin``.

    ``save(step, tree, sharded={...})`` splits each array in ``sharded``
    along its leading axis into one fsynced file per slice; the manifest
    records per-shard dtype/shape/sha1 so a restore can verify — or load —
    a single host's shard without touching the others.
    """

    def save(self, step: int, tree, sharded: dict | None = None,
             extra_meta: dict | None = None) -> Path:
        tmp, manifest = self._begin(step, extra_meta)
        self._write_data(tmp, host_flat(tree), manifest)
        manifest["shards"] = {}
        for name, arr in (sharded or {}).items():
            a = to_numpy(arr)
            entries = []
            for i in range(a.shape[0]):
                raw = np.ascontiguousarray(a[i]).tobytes()
                path = tmp / f"{name}.shard{i:05d}.bin"
                with open(path, "wb") as f:
                    f.write(raw)
                    f.flush()
                    os.fsync(f.fileno())
                entries.append({
                    "dtype": str(a.dtype), "shape": list(a.shape[1:]),
                    "sha1": hashlib.sha1(raw).hexdigest()[:16],
                })
            manifest["shards"][name] = entries
        with obs.span("snapshot_publish", cat="snapshot", step=step):
            return self._publish(step, tmp, manifest)

    def load_shard(self, step: int, name: str, index: int,
                   verify: bool = True) -> np.ndarray:
        """One shard slice — the only thing host ``index`` ever reads."""
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        meta = manifest["shards"][name][index]
        raw = (d / f"{name}.shard{index:05d}.bin").read_bytes()
        if verify and hashlib.sha1(raw).hexdigest()[:16] != meta["sha1"]:
            raise IOError(f"checksum mismatch in {name}.shard{index} "
                          f"@ step {step}")
        return np.frombuffer(raw, meta["dtype"]).reshape(meta["shape"])

    def load_sharded(self, step: int, name: str,
                     verify: bool = True) -> np.ndarray:
        """All shards of ``name`` stacked back along the leading axis."""
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        count = len(manifest["shards"][name])
        return np.stack([self.load_shard(step, name, i, verify)
                         for i in range(count)])

    def shard_names(self, step: int) -> list[str]:
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        return sorted(manifest.get("shards", {}))

    def shard_count(self, step: int, name: str) -> int:
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        return len(manifest["shards"][name])

    # -- multi-writer protocol (one process per host) ------------------------
    #
    # ``save`` above is single-writer: one process stages everything and
    # publishes atomically.  With one process per host each host must write
    # only its own shard slices, so a step is staged cooperatively:
    #
    #   host 0:      begin_shared   — tmp dir, replicated fields, partial
    #                                 manifest (fsynced)
    #   <barrier>                     (tmp dir exists everywhere)
    #   every host:  write_host_shards — own slice files + per-host manifest
    #   <barrier>                     (all slices durably staged)
    #   host 0:      publish_shared — merge per-host manifests, atomic rename
    #
    # The caller owns the barriers (they need the live distributed context);
    # see ``RunSnapshot.save_state_multihost``.  A kill at any point before
    # publish leaves only a dot-prefixed tmp dir, which ``steps()`` never
    # lists and the next save of that step reclaims — so the last *fully
    # published* step always wins, and torn per-host staging is skipped by
    # construction.  The published layout is byte-compatible with the
    # single-writer ``save``, so a snapshot taken by a 2-process run can be
    # restored by a single-process driver and vice versa.

    def shared_tmp(self, step: int) -> Path:
        return self.dir / f".tmp_step_{step:010d}"

    def begin_shared(self, step: int, tree,
                     extra_meta: dict | None = None) -> Path:
        """Writer-0 half of a cooperative save: stage the replicated fields
        and the partial manifest in the shared tmp dir."""
        tmp, manifest = self._begin(step, extra_meta)
        self._write_data(tmp, host_flat(tree), manifest)
        with open(tmp / ".manifest.partial.json", "w") as f:
            f.write(json.dumps(manifest))
            f.flush()
            os.fsync(f.fileno())
        return tmp

    def write_host_shards(self, step: int, host: int,
                          shards: dict[str, dict[int, np.ndarray]]) -> None:
        """Any host: write only its own shard slices + a per-host manifest.

        ``shards[name][i]`` is the slice this host owns for global shard
        index ``i`` (already squeezed of the leading device axis).
        """
        tmp = self.shared_tmp(step)
        entries: dict[str, dict[str, dict]] = {}
        for name, by_index in shards.items():
            entries[name] = {}
            for i, arr in sorted(by_index.items()):
                a = np.ascontiguousarray(np.asarray(arr))
                raw = a.tobytes()
                with open(tmp / f"{name}.shard{i:05d}.bin", "wb") as f:
                    f.write(raw)
                    f.flush()
                    os.fsync(f.fileno())
                entries[name][str(i)] = {
                    "dtype": str(a.dtype), "shape": list(a.shape),
                    "sha1": hashlib.sha1(raw).hexdigest()[:16],
                }
        with open(tmp / f".host{host:03d}.json", "w") as f:
            f.write(json.dumps(entries))
            f.flush()
            os.fsync(f.fileno())

    def publish_shared(self, step: int,
                       num_shards: dict[str, int]) -> Path:
        """Writer-0, after every host staged: merge the per-host manifests
        into the step manifest and publish atomically.  ``num_shards`` maps
        each sharded name to its expected global shard count — a missing
        slice (a host that lied about reaching the barrier) fails loudly
        instead of publishing a torn step."""
        tmp = self.shared_tmp(step)
        manifest = json.loads((tmp / ".manifest.partial.json").read_text())
        merged: dict[str, list] = {name: [None] * count
                                   for name, count in num_shards.items()}
        host_files = sorted(tmp.glob(".host*.json"))
        for hp in host_files:
            for name, by_index in json.loads(hp.read_text()).items():
                for i, meta in by_index.items():
                    merged[name][int(i)] = meta
        for name, ents in merged.items():
            missing = [i for i, e in enumerate(ents) if e is None]
            if missing:
                raise IOError(f"multi-writer step {step}: no host staged "
                              f"{name} shards {missing} — refusing to "
                              f"publish a torn step")
        manifest["shards"] = merged
        (tmp / ".manifest.partial.json").unlink()
        for hp in host_files:
            hp.unlink()
        with obs.span("snapshot_publish", cat="snapshot", step=step):
            return self._publish(step, tmp, manifest)


# ---------------------------------------------------------------------------
# partitioner-run façade
# ---------------------------------------------------------------------------

class SnapshotMismatch(RuntimeError):
    """Resume attempted against a different graph or NEConfig."""


class RunSnapshot:
    """Round-keyed snapshots of a partitioning run.

    ``save_state`` takes the raw field dict of an ``SpmdState`` /
    ``NEState`` (numpy arrays or tensors), stores ``edge_part`` sharded when it
    carries a leading device axis, and stamps fingerprints; ``restore_state``
    validates them and hands back plain numpy arrays keyed by field name.
    """

    def __init__(self, directory: str | os.PathLike, cfg,
                 graph_fp: str, keep: int = 3):
        self.mgr = ShardedCheckpointManager(directory, keep=keep)
        self.cfg_fp = config_fingerprint(cfg)
        self.graph_fp = graph_fp

    def save_state(self, round_k: int, fields: dict, mode: str) -> Path:
        fields = {k: to_numpy(v) for k, v in fields.items()}
        sharded = None
        if mode == "spmd":
            sharded = {"edge_part": fields.pop("edge_part")}
        meta = {"mode": mode, "round": int(round_k),
                "config_fingerprint": self.cfg_fp,
                "graph_fingerprint": self.graph_fp}
        return self.mgr.save(round_k, fields, sharded=sharded,
                             extra_meta=meta)

    def save_state_multihost(self, round_k: int, fields: dict, mode: str,
                             host: int, shard_slices: dict,
                             num_shards: dict, barrier,
                             fault_hook=None) -> Path | None:
        """Cooperative multi-writer save_state: host ``h`` writes only its
        own shard slices; host 0 stages the replicated ``fields`` and
        publishes after everyone staged.

        ``shard_slices`` maps sharded names to ``{global_index: slice}``
        for the indices this host owns; ``num_shards`` maps them to their
        global shard counts.  ``barrier(name)`` is the caller's
        cross-process sync (a ``torch.distributed`` barrier).  ``fault_hook``
        is a test-only crash-injection point called as
        ``fault_hook(stage, round_k)`` at each protocol stage.
        """
        fields = {k: to_numpy(v) for k, v in fields.items()}
        meta = {"mode": mode, "round": int(round_k),
                "config_fingerprint": self.cfg_fp,
                "graph_fingerprint": self.graph_fp}
        if host == 0:
            self.mgr.begin_shared(round_k, fields, extra_meta=meta)
        barrier(f"snap-begin-{round_k}")
        self.mgr.write_host_shards(round_k, host, shard_slices)
        if fault_hook is not None:
            fault_hook("after-shards", round_k)
        barrier(f"snap-shards-{round_k}")
        path = None
        if host == 0:
            path = self.mgr.publish_shared(round_k, num_shards)
        # the publish barrier precedes the fault hook so that "after-publish"
        # is true on *every* host — a non-publishing host reaching the hook
        # must not race writer-0's atomic rename
        barrier(f"snap-publish-{round_k}")
        if fault_hook is not None:
            fault_hook("after-publish", round_k)
        return path

    def restore_state_multihost(self, owned: list[int],
                                round_k: int | None = None,
                                num_devices: int | None = None,
                                host: int = 0, num_hosts: int = 1,
                                ) -> tuple[dict, int, str, dict]:
        """Like :meth:`restore_state`, but loads only the ``owned`` slices
        of each sharded array: sharded names map to ``{index: array}``
        instead of the stacked (D, …) array.  Also returns the global shard
        counts so the caller can validate the device layout.  Torn steps
        (unpublished staging, checksum mismatch) fall back to the previous
        published round, exactly as in the single-process path.

        **Elastic resume**: when ``num_devices`` is given and a stored
        shard count differs from it, the snapshot was taken on a different
        device count.  Instead of refusing, this process loads the slices
        of a balanced *old-layout* assignment (old shard ``i`` → host
        ``i % num_hosts``) so the caller can reshard them onto the new
        layout (``repro_torch.runtime.cluster.reshard_write``/``_assemble``) —
        the returned ``counts`` expose the mismatch.  Without
        ``num_devices`` an out-of-range ``owned`` index still raises
        :class:`SnapshotMismatch` (the pre-elastic contract)."""
        candidates = ([round_k] if round_k is not None
                      else list(reversed(self.mgr.steps())))
        last_err: Exception | None = None
        for step in candidates:
            try:
                meta = self.mgr.meta(step)
                self._check(meta)
                fields = dict(self.mgr._load_flat(step))
                counts = {}
                for name in self.mgr.shard_names(step):
                    counts[name] = n_sh = self.mgr.shard_count(step, name)
                    if num_devices is not None and n_sh != num_devices:
                        # elastic: balanced old-layout assignment
                        mine = [i for i in range(n_sh)
                                if i % num_hosts == host]
                    else:
                        bad = [i for i in owned if i >= n_sh]
                        if bad:
                            # a config problem, not corruption: falling
                            # back (or a raw IndexError escaping
                            # mid-collective) must not mask a
                            # device-count change
                            raise SnapshotMismatch(
                                f"snapshot {name} has {n_sh} shards; "
                                f"this process owns indices {bad} — "
                                f"resume needs the same device count "
                                f"(or an elastic caller)")
                        mine = owned
                    fields[name] = {i: self.mgr.load_shard(step, name, i)
                                    for i in mine}
            except SnapshotMismatch:
                raise
            except (IOError, json.JSONDecodeError, ValueError, KeyError) as e:
                last_err = e          # torn per-host shard → previous round
                continue
            return fields, int(meta["round"]), meta["mode"], counts
        raise FileNotFoundError(
            f"no restorable snapshot in {self.mgr.dir}"
            + (f" (last error: {last_err})" if last_err else ""))

    def rounds(self) -> list[int]:
        return self.mgr.steps()

    def restore_state(self, round_k: int | None = None,
                      ) -> tuple[dict, int, str]:
        """(fields, round, mode) of the requested (default: latest) valid
        snapshot.  Fingerprint mismatch raises :class:`SnapshotMismatch`
        loudly instead of falling back — a stale-but-valid older snapshot
        of the *wrong run* must never win silently."""
        candidates = ([round_k] if round_k is not None
                      else list(reversed(self.mgr.steps())))
        last_err: Exception | None = None
        for step in candidates:
            try:
                meta = self.mgr.meta(step)
                self._check(meta)
                fields = dict(self.mgr._load_flat(step))
                for name in self.mgr.shard_names(step):
                    fields[name] = self.mgr.load_sharded(step, name)
            except SnapshotMismatch:
                raise
            except (IOError, json.JSONDecodeError, ValueError, KeyError) as e:
                last_err = e          # half-written step → try the previous
                continue
            return fields, int(meta["round"]), meta["mode"]
        raise FileNotFoundError(
            f"no restorable snapshot in {self.mgr.dir}"
            + (f" (last error: {last_err})" if last_err else ""))

    def _check(self, meta: dict) -> None:
        if meta.get("config_fingerprint") != self.cfg_fp:
            raise SnapshotMismatch(
                f"snapshot config fingerprint {meta.get('config_fingerprint')}"
                f" != current NEConfig {self.cfg_fp} — refusing to resume a "
                f"different run")
        if meta.get("graph_fingerprint") != self.graph_fp:
            raise SnapshotMismatch(
                f"snapshot graph fingerprint {meta.get('graph_fingerprint')} "
                f"!= current edge source {self.graph_fp} — refusing to resume "
                f"against a different graph")


__all__ = ["RunSnapshot", "ShardedCheckpointManager", "SnapshotMismatch",
           "config_fingerprint", "graph_fingerprint", "fsync_path"]
