"""Distributed graph applications over edge partitions (paper §7.6, Table 5).

PageRank, SSSP and WCC on the vertex-cut GAS engine (``apps.engine``).
Each rank of a ``torch.distributed`` group holds its slice of the
:class:`ShardedGraph` as tensors on its device and runs the supersteps;
a superstep's traffic is the mirror↔master all-to-all pair, so the
partition's replication factor sets the wire bytes, the effect the
paper measures on PowerLyra.  Every rank returns the whole (N,) result:
the ranks' masters are all-gathered and stitched on the host.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.apps.engine import (ShardedGraph, master_to_mirror,
                                     mirror_to_master, scatter_edges)
from repro_torch.core.graph import resolve_device
from repro_torch.dist import compat

INF = float("inf")
_FIELDS = ("edges_ml", "emask", "send_idx", "send_mask", "recv_owned",
           "owned_mask")


def unpack(sg: ShardedGraph, device=None, group=None) -> dict:
    """This rank's six engine arrays as tensors on ``device``, for the
    apps' ``arrays``: calls that pass them skip the copies from the host.
    The group's world must be the graph's number of parts."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if world != sg.num_devices:
        raise ValueError(f"a ShardedGraph of {sg.num_devices} parts needs a "
                         f"group of that many ranks, not {world}")
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(sg, k)[rank]))
            .to(dev) for k in _FIELDS}


def _stitch(sg: ShardedGraph, out_padded: np.ndarray, fill: float):
    """(D, O) padded master values → (N,) host array."""
    res = np.full((sg.num_vertices,), fill, np.float64)
    for d in range(sg.num_devices):
        mask = sg.owned_mask[d]
        res[sg.owned_glob[d][mask]] = out_padded[d][mask]
    return res


def _gather_stitch(sg: ShardedGraph, out: torch.Tensor, group,
                   fill: float) -> np.ndarray:
    rows = compat.all_gather_rows(out[:, 0].contiguous(), group)
    return _stitch(sg, rows.cpu().numpy(), fill)


def pagerank(sg: ShardedGraph, iters: int = 30, damping: float = 0.85,
             device=None, group=None, arrays=None) -> np.ndarray:
    """``iters`` supersteps of PageRank from 1/n: a vertex's rank is
    (1 − d)/n + d · Σ_neighbours rank/degree.  A vertex with no edge keeps
    (1 − d)/n.  ``device=None`` means the card; ``group=None`` the
    default group; ``arrays=None`` copies this rank's :func:`unpack`."""
    a = unpack(sg, device, group) if arrays is None else arrays
    n = sg.num_vertices
    caps = sg.caps
    lanes = (a["send_idx"], a["send_mask"], a["recv_owned"])
    src, dst = a["edges_ml"][:, 0].long(), a["edges_ml"][:, 1].long()
    ones = a["emask"].float()[:, None]
    owned = a["owned_mask"][:, None]
    zero = torch.zeros((), device=ones.device)
    deg_m = scatter_edges(ones, ones, a["edges_ml"], a["emask"], caps["R"])
    deg_o = mirror_to_master(deg_m, *lanes, caps["O"], group=group)
    pr = torch.where(owned, torch.full_like(zero, 1.0 / n), zero)
    for _ in range(iters):
        contrib = torch.where(deg_o > 0, pr / torch.clamp(deg_o, min=1.0),
                              zero)
        c_m = master_to_mirror(contrib, *lanes, caps["R"], group=group)
        ev_dst = c_m[src] * ones
        ev_src = c_m[dst] * ones
        acc = scatter_edges(ev_dst, ev_src, a["edges_ml"], a["emask"],
                            caps["R"])
        s = mirror_to_master(acc, *lanes, caps["O"], group=group)
        pr = torch.where(owned, (1.0 - damping) / n + damping * s, zero)
    return _gather_stitch(sg, pr, group, fill=(1.0 - damping) / n)


def _label_propagation(sg: ShardedGraph, init_vals: np.ndarray,
                       relax_add: float, max_iters: int, device, group,
                       arrays):
    """Shared min-propagation driver for SSSP (+1 relax) and WCC (+0).

    Runs supersteps while some rank's value fell in the last one and
    fewer than ``max_iters`` ran: one all-reduce and one host read of the
    ``changed`` flag a superstep.  Returns this rank's (O, 1) values and
    the supersteps run."""
    a = unpack(sg, device, group) if arrays is None else arrays
    rank = dist.get_rank(group)
    caps = sg.caps
    lanes = (a["send_idx"], a["send_mask"], a["recv_owned"])
    src, dst = a["edges_ml"][:, 0].long(), a["edges_ml"][:, 1].long()
    emask = a["emask"][:, None]
    init = torch.from_numpy(init_vals[rank]).to(a["emask"].device)
    inf = torch.full((), INF, device=init.device)
    val = torch.where(a["owned_mask"][:, None], init, inf)
    changed, it = True, 0
    while changed and it < max_iters:
        v_m = master_to_mirror(val, *lanes, caps["R"], group=group)
        ev_dst = torch.where(emask, v_m[src] + relax_add, inf)
        ev_src = torch.where(emask, v_m[dst] + relax_add, inf)
        acc = scatter_edges(ev_dst, ev_src, a["edges_ml"], a["emask"],
                            caps["R"], op="min", identity=INF)
        upd = mirror_to_master(acc, *lanes, caps["O"], op="min",
                               identity=INF, group=group)
        new = torch.minimum(val, upd)
        flag = (new < val).any().to(torch.int32)
        changed = int(compat.all_reduce_sum(flag, group)) > 0
        val, it = new, it + 1
    return val, it


def sssp(sg: ShardedGraph, source: int, max_iters: int = 200, device=None,
         group=None, arrays=None) -> tuple[np.ndarray, int]:
    """Unweighted single-source shortest paths: (distances, supersteps);
    inf where ``source`` cannot reach or the vertex has no edge."""
    vals = np.full((sg.num_devices, sg.caps["O"], 1), np.inf, np.float32)
    for d in range(sg.num_devices):
        hit = np.nonzero((sg.owned_glob[d] == source) & sg.owned_mask[d])[0]
        vals[d, hit] = 0.0
    out, iters = _label_propagation(sg, vals, 1.0, max_iters, device, group,
                                    arrays)
    return _gather_stitch(sg, out, group, fill=np.inf), iters


def wcc(sg: ShardedGraph, max_iters: int = 200, device=None,
        group=None, arrays=None) -> tuple[np.ndarray, int]:
    """Weakly connected components: (labels, supersteps), each vertex
    labelled by the smallest id in its component, -1 where it has no
    edge.  The labels propagate as float32, exact below 2^24 vertices."""
    vals = sg.owned_glob.astype(np.float32)[:, :, None]
    out, iters = _label_propagation(sg, vals, 0.0, max_iters, device, group,
                                    arrays)
    return _gather_stitch(sg, out, group, fill=-1.0), iters
