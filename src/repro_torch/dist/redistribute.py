"""All-to-all edge redistribution: partition p's edges land on rank p.

After ``partition_spmd`` finishes, edges still live where the 2D-hash
initial distribution put them.  The GAS engine (``apps.engine``) wants
rank ``d`` to own partition ``d``'s edges.  ``redistribute_edges`` is the
one-shot all-to-all shuffle between the two layouts: the paper's final
edge-migration step, and the hand-off that feeds
``apps.engine.build_sharded_graph``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.graph import exclusive_rank, resolve_device
from repro_torch.dist import compat


def _redistribute_numpy(shards, parts, valid, cap):
    """The whole (D, C) input on the host."""
    d = valid.shape[0]
    edges_out = np.zeros((d, d * cap, 2), np.int32)
    mask_out = np.zeros((d, d * cap), bool)
    for dst in range(d):
        for src in range(d):
            rows = shards[src][valid[src] & (parts[src] == dst)]
            lo = src * cap
            edges_out[dst, lo: lo + rows.shape[0]] = rows
            mask_out[dst, lo: lo + rows.shape[0]] = True
    return edges_out, mask_out


def redistribute_edges(shards, masks, parts, group=None, device=None):
    """Shuffle edge rows so partition ``p``'s edges land on rank ``p``.

    Without ``group``, on the host: ``shards`` (D, C, 2) int32 edge
    endpoints, one row per shard slot; ``masks`` (D, C) bool, the valid
    rows; ``parts`` (D, C) int32, each row's target partition (read
    where the mask is set).  Returns ``(edges_out, mask_out, dropped)``:
    ``edges_out`` is (D, D·cap, 2) int32, where block ``s`` of part
    ``p``'s axis holds the rows received from shard ``s`` in their
    original order; ``mask_out`` marks the valid rows; ``dropped`` counts
    masked rows whose target fell outside [0, D).  ``cap`` is the largest
    number of rows one shard sends to one part.

    With ``group`` (world D), on ``device`` (``None``: the card): this
    rank's row of each input ((C, 2), (C,), (C,)); each rank slots its
    rows by target with ``exclusive_rank``, ``cap`` is agreed by an
    all-reduce MAX, and one all-to-all moves the slots.  Returns row
    ``rank`` of the result above, as host arrays, and the same
    ``dropped``.
    """
    if group is None:
        shards = np.asarray(shards, np.int32)
        masks = np.asarray(masks, bool)
        parts = np.asarray(parts, np.int32)
        d = masks.shape[0]
        valid = masks & (parts >= 0) & (parts < d)
        dropped = int(masks.sum() - valid.sum())
        counts = np.zeros((d, d), np.int64)
        for dd in range(d):
            if valid[dd].any():
                counts[dd] = np.bincount(parts[dd][valid[dd]], minlength=d)
        cap = max(1, int(counts.max()))
        edges_out, mask_out = _redistribute_numpy(shards, parts, valid, cap)
        return edges_out, mask_out, dropped
    return _redistribute_ranks(shards, masks, parts, group, device)


def _redistribute_ranks(shard, mask, part, group, device):
    dev = resolve_device(device)
    d = dist.get_world_size(group)
    uv = torch.as_tensor(np.asarray(shard, np.int32), device=dev)
    mask = torch.as_tensor(np.asarray(mask, bool), device=dev)
    part = torch.as_tensor(np.asarray(part, np.int32), device=dev)
    valid = mask & (part >= 0) & (part < d)
    tgt = torch.where(valid, part, torch.full_like(part, -1))
    counts = torch.bincount(tgt[valid].long(), minlength=d)
    cap = counts.max().reshape(1)
    dist.all_reduce(cap, op=dist.ReduceOp.MAX, group=group)
    cap = max(1, int(cap))
    dropped = (mask.sum() - valid.sum()).reshape(1).to(torch.int64)
    dist.all_reduce(dropped, group=group)
    # stable slotting: rank within this rank's per-target stream
    myrank = exclusive_rank(tgt, d)
    slot = torch.where(tgt >= 0, tgt.clamp(min=0) * cap + myrank,
                       torch.full_like(tgt, d * cap)).long()
    payload = torch.zeros((d * cap + 1, 3), dtype=torch.int32, device=dev)
    payload[slot, :2] = uv                     # row d·cap takes the drops
    payload[slot, 2] = 1
    got = compat.all_to_all_rows(payload[:d * cap], group)    # (D·cap, 3)
    got = got.cpu().numpy()
    return got[:, :2].copy(), got[:, 2] > 0, int(dropped)
