"""Finalize epilogue — host-side numpy, no torch.

A copy of the reference package's epilogue: the α-capacity limit, the
water-fill of the ``max_rounds`` leftovers (whole-array, and the
per-shard half the sharded finalize of ``runtime.finalize`` applies) and
the stitch of shard-order assignments back to edge order.  The expressions
are kept exactly, since bit-identity with the reference depends on them.
"""
from __future__ import annotations

import numpy as np


def alpha_limit(alpha: float, m: int, num_partitions: int) -> int:
    """α-capacity limit ``⌊α·|E|/|P|⌋`` (paper Alg. 1)."""
    return int(alpha * m / num_partitions)


def _waterfill(counts: np.ndarray, cap: np.ndarray, k: int) -> np.ndarray:
    """Per-partition takes for ``k`` unit increments, each going to the
    currently least-loaded partition with remaining capacity — the greedy
    computed in closed form (binary search on the fill level) instead of
    k sequential argmins.  Ties at the final level break by partition id.
    """
    take = np.zeros_like(counts)
    if k <= 0:
        return take

    def filled(level: int) -> int:
        return int(np.minimum(np.maximum(level - counts, 0), cap).sum())

    lo, hi = int(counts.min()), int(counts.max()) + k + 1
    while lo < hi:                  # largest level with filled(level) <= k
        mid = (lo + hi + 1) // 2
        if filled(mid) <= k:
            lo = mid
        else:
            hi = mid - 1
    take = np.minimum(np.maximum(lo - counts, 0), cap)
    spill = k - int(take.sum())
    if spill > 0:
        room = np.nonzero((take < cap) & (counts + take == lo))[0]
        take[room[:spill]] += 1
    return take


def leftover_plan(counts: np.ndarray, num_leftover: int,
                  num_partitions: int, limit: int) -> np.ndarray:
    """Water-fill split of ``num_leftover`` unallocated edges: the
    least-loaded partitions under the α-capacity ``limit`` first, and only
    when every partition is at capacity does the overflow fill freely."""
    c64 = np.asarray(counts).astype(np.int64)
    free = np.maximum(limit - c64, 0)
    k_capped = min(int(num_leftover), int(free.sum()))
    take = _waterfill(c64, free, k_capped)
    overflow = int(num_leftover) - k_capped
    if overflow:
        no_cap = np.full(num_partitions, overflow, np.int64)
        take = take + _waterfill(c64 + take, no_cap, overflow)
    return take


def leftover_targets(take: np.ndarray, ranks: np.ndarray) -> np.ndarray:
    """Partition of each leftover rank under plan ``take``
    (``np.repeat(np.arange(P), take)[ranks]`` without the expansion)."""
    bounds = np.cumsum(np.asarray(take, np.int64))
    return np.searchsorted(bounds, np.asarray(ranks, np.int64),
                           side="right").astype(np.int32)


def finalize_local(ep_slice: np.ndarray, u_slice: np.ndarray,
                   v_slice: np.ndarray, ranks: np.ndarray,
                   take: np.ndarray, vparts: np.ndarray) -> int:
    """Per-shard half of the sharded finalize: fill this slice's leftover
    slots from the agreed water-fill ``take`` and mark the new replicas
    in the local ``vparts`` copy, in place.

    ``ep_slice`` / ``u_slice`` / ``v_slice`` are the shard's valid prefix
    (no padding); ``ranks`` are the global eid-order ranks of its
    leftover edges, in slot order (slot order within a shard is eid
    order).  Returns the number of edges assigned; every array touched
    is O(slice), never O(M).
    """
    rem = np.flatnonzero(ep_slice < 0)
    if rem.size == 0:
        return 0
    tgt = leftover_targets(take, ranks)
    ep_slice[rem] = tgt
    vparts[u_slice[rem], tgt] = True
    vparts[v_slice[rem], tgt] = True
    return int(rem.size)


def cleanup_leftovers(edge_part: np.ndarray, vparts: np.ndarray,
                      counts: np.ndarray, edges: np.ndarray,
                      num_partitions: int, limit: int) -> int:
    """Assign unallocated edges (the max_rounds safety hatch), in place.
    Returns the number of edges assigned."""
    rem = np.nonzero(edge_part < 0)[0]
    if rem.size == 0:
        return 0
    take = leftover_plan(counts, int(rem.size), num_partitions, limit)
    tgt = leftover_targets(take, np.arange(rem.size, dtype=np.int64))
    edge_part[rem] = tgt
    counts += take.astype(counts.dtype)
    vparts[edges[rem, 0], tgt] = True
    vparts[edges[rem, 1], tgt] = True
    return int(rem.size)


def stitch_slices(out: np.ndarray, ep_slices: dict, eids: dict,
                  ) -> np.ndarray:
    """Scatter shard slot-order assignments to their global edge ids.

    ``ep_slices[d]`` is shard ``d``'s (possibly padded) assignment and
    ``eids[d]`` its global edge ids in slot order; only the valid prefix
    (``eids[d].size`` slots) is read.  Writes into and returns ``out``.
    """
    for d, e in eids.items():
        out[e] = np.asarray(ep_slices[d])[: e.size]
    return out
