"""Sharded finalize epilogue — per-host steps, host numpy, no torch.

A copy of the reference package's ``runtime/finalize.py``.  Each host
(a rank of a multi-controller run) finalizes **only the shard slices it
owns**, and the pieces combine through the store (sorted leftover-eid
spills) plus two small ``repro_torch.dist.compat`` collectives (a scalar
sum for the global leftover count, an O(N·P) OR for the replica-map
deltas).  No step here allocates an (M,) array (asserted by the
allocation-shape test in tests/test_torch_finalize.py).

Flow (driver-orchestrated; ``barrier`` comes from the caller):

1. :func:`stage_leftovers` — write this host's sorted leftover eids;
2. <barrier> — all spills durably staged;
3. :func:`apply_leftovers` — rank my leftovers globally by merging the
   other hosts' sorted spills one at a time (O(max per-host leftovers)
   memory), derive the shared
   :func:`~repro_torch.core.epilogue.leftover_plan` from the replicated
   counts + the agreed global total, and apply it slice-locally
   (``finalize_local``) to my shards and my replica-map copy;
4. the driver OR-combines the replica maps, adds ``take`` to the counts,
   and computes the quality metrics from the (P,)-sized partials
   (``repro_torch.core.metrics.stats_from_counts``) — replication factor,
   edge balance and vertex balance never touch the global assignment.

:func:`partition_contribs` then feeds the cooperative multi-writer
artifact save (``repro_torch.runtime.artifact``) straight from the
finalized slices.  :func:`leftover_assignments` reconstructs the full leftover
assignment from the spills — only the *lazy*
``PartitionResult.edge_part`` materialization uses it.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core.epilogue import finalize_local, leftover_plan, \
    leftover_targets
from repro_torch.obs.trace import traced
from repro_torch.runtime.cluster import _read_raw, _write_raw


def _left_path(fin_dir: str | os.PathLike, host: int) -> str:
    return os.path.join(os.fspath(fin_dir), f"left_h{host:03d}.bin")


def _read_left(fin_dir, host: int) -> np.ndarray:
    path = _left_path(fin_dir, host)
    return _read_raw(path, np.int64, (os.path.getsize(path) // 8,))


@traced("stage_leftovers", cat="finalize")
def stage_leftovers(fin_dir: str | os.PathLike, host: int,
                    ep_slices: dict, eids: dict) -> np.ndarray:
    """Write this host's sorted leftover eids to the shared finalize dir.

    ``ep_slices[d]`` / ``eids[d]`` are the owned shards' assignments and
    global edge ids (slot order); only the valid prefix (``eids[d].size``
    slots) is read.  Returns the sorted eid array.  Idempotent — a
    resumed epilogue rewrites the same bytes.
    """
    os.makedirs(os.fspath(fin_dir), exist_ok=True)
    mine = [eids[d][np.flatnonzero(
        np.asarray(ep_slices[d])[: eids[d].size] < 0)]
        for d in sorted(eids)]
    my = (np.sort(np.concatenate(mine)) if mine
          else np.zeros((0,), np.int64)).astype(np.int64)
    _write_raw(_left_path(fin_dir, host), my)
    return my


def leftover_ranks(fin_dir: str | os.PathLike, num_hosts: int, host: int,
                   my_sorted: np.ndarray) -> tuple[np.ndarray, int]:
    """Global eid-order ranks of this host's sorted leftover eids, plus
    the global leftover total, by merging the other hosts' sorted spills
    one at a time — peak memory O(max per-host leftovers), never
    O(total).  Eids are globally unique, so a rank is just the count of
    smaller eids across every spill."""
    ranks = np.arange(my_sorted.size, dtype=np.int64)
    total = int(my_sorted.size)
    for h in range(num_hosts):
        if h == host:
            continue
        other = _read_left(fin_dir, h)
        total += int(other.size)
        ranks += np.searchsorted(other, my_sorted)
    return ranks, total


@traced("apply_leftovers", cat="finalize")
def apply_leftovers(fin_dir: str | os.PathLike, host: int, num_hosts: int,
                    my_sorted: np.ndarray, ep_slices: dict, us: dict,
                    vs: dict, eids: dict, counts: np.ndarray, limit: int,
                    num_partitions: int, vparts: np.ndarray,
                    leftover_total: int | None = None,
                    ) -> tuple[np.ndarray, int]:
    """Slice-local leftover cleanup (after the staging barrier).

    Mutates the owned ``ep_slices`` (valid prefixes) and the local
    ``vparts`` copy in place; returns ``(take, leftover_total)`` — the
    shared water-fill plan and the global leftover count.  Pass
    ``leftover_total`` when the caller already agreed on it through a
    collective; by default it falls out of the spill merge.
    """
    ranks_sorted, total = leftover_ranks(fin_dir, num_hosts, host,
                                         my_sorted)
    if leftover_total is not None and leftover_total != total:
        raise RuntimeError(
            f"sharded finalize: collective leftover total "
            f"{leftover_total} != spill-merge total {total} — a host's "
            f"leftover spill is torn or stale")
    take = leftover_plan(counts, total, num_partitions, limit)
    off = 0
    for d in sorted(eids):
        k = int(eids[d].size)
        ep = np.asarray(ep_slices[d])
        rem = np.flatnonzero(ep[:k] < 0)
        e_d = eids[d][rem]
        # my_sorted is the sorted union of exactly these eids, so the
        # lookup is exact; ranks land back in slot (== eid) order
        ranks = ranks_sorted[np.searchsorted(my_sorted, e_d)]
        finalize_local(ep[:k], np.asarray(us[d])[:k], np.asarray(vs[d])[:k],
                       ranks, take, vparts)
        off += rem.size
    if off != my_sorted.size:
        raise RuntimeError(f"sharded finalize: applied {off} leftovers, "
                           f"staged {my_sorted.size}")
    return take, total


def leftover_assignments(fin_dir: str | os.PathLike, num_hosts: int,
                         take: np.ndarray,
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Every host's leftover assignment ``(eids, targets)`` from the
    staged spills — O(global leftovers), so only the explicit lazy
    ``PartitionResult.edge_part`` materialization calls it."""
    spills = [_read_left(fin_dir, h) for h in range(num_hosts)]
    eids = np.sort(np.concatenate(spills)) if spills \
        else np.zeros((0,), np.int64)
    tgt = leftover_targets(take, np.arange(eids.size, dtype=np.int64))
    return eids, tgt


def partition_contribs(ep_slices: dict, us: dict, vs: dict, eids: dict,
                       num_partitions: int) -> dict:
    """This host's per-partition ``(eids, u, v)`` artifact contributions,
    ascending-eid within each partition, from its finalized slices.

    One lexsort over the owned slots (O(owned shards), never O(M)) gives
    every partition's slice of this host's edges — the unit
    ``repro_torch.runtime.artifact.write_artifact_contrib`` spills.
    """
    devs = sorted(eids)
    e_all = np.concatenate([eids[d][: eids[d].size] for d in devs]) \
        if devs else np.zeros((0,), np.int64)
    p_all = np.concatenate([np.asarray(ep_slices[d])[: eids[d].size]
                            for d in devs]) if devs \
        else np.zeros((0,), np.int32)
    u_all = np.concatenate([np.asarray(us[d])[: eids[d].size]
                            for d in devs]) if devs \
        else np.zeros((0,), np.int32)
    v_all = np.concatenate([np.asarray(vs[d])[: eids[d].size]
                            for d in devs]) if devs \
        else np.zeros((0,), np.int32)
    if p_all.size and int(p_all.min()) < 0:
        raise ValueError("artifact contributions require a complete "
                         "assignment — run the finalize epilogue first")
    if e_all.size < 2 or bool((e_all[1:] > e_all[:-1]).all()):
        # eids already ascending (a host with one shard: slot order is
        # eid order): a stable sort of the partition ids alone gives the
        # lexsort's order, and numpy sorts 8- and 16-bit keys by radix
        keys = p_all.astype(np.min_scalar_type(max(num_partitions - 1, 0)))
        order = np.argsort(keys, kind="stable")
    else:
        order = np.lexsort((e_all, p_all))
    bounds = np.searchsorted(p_all[order],
                             np.arange(num_partitions + 1, dtype=np.int64))
    return {p: (e_all[order[bounds[p]:bounds[p + 1]]],
                u_all[order[bounds[p]:bounds[p + 1]]],
                v_all[order[bounds[p]:bounds[p + 1]]])
            for p in range(num_partitions)}


__all__ = ["apply_leftovers", "leftover_assignments", "leftover_ranks",
           "partition_contribs", "stage_leftovers"]
