"""SPMD Distributed NE — the paper's §4 algorithm over torch.distributed.

The port of the reference package's ``dist/partitioner_sm.py``.  One
process per rank; the graph is 2D-hash edge-partitioned across ranks
(``core.graph.shard_edges``) and rank ``r`` holds shard ``r`` (an
equal-length padded slice of the edge list) on its own device and
allocates only its own edges.  One :func:`spmd_round_step` is one paper
round, on every rank:

  1. **selection** — every rank computes the same claim keys from the
     replicated state (``core.partitioner.vertex_claims``), reading the
     packed replica map unpacked once a round;
  2. **one-hop allocation** over the local shard (``one_hop`` with the
     shard's mask);
  3. **SyncVertexAllocations** — the replica-set delta is packed
     (``pack_bits``), OR-all-reduced (``compat.or_all_reduce``) and merged
     (``or_words``); the |E_p| and D_rest deltas are ``all_reduce(SUM)``;
  4. **two-hop "free edge" allocation** (Condition (5)) over the local
     shard in ``edge_chunk`` chunks, each testing the ANDed packed words
     of its edges' endpoints (``two_hop_best``); the α-capacity quota is
     split across ranks by an exclusive prefix over an ``all_gather`` of
     per-rank histograms.

Replica sets are always bit-packed: (N, ceil(P/32)) int32 words, the bit
patterns of the reference's uint32 words.  Every collective runs on every
rank in the same order, at world 1 too.  Results are bit-identical to the
reference's ``partition_spmd`` at the same device count, and at world 1
to the single-controller ``core.partitioner.partition``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random as trandom
from repro_torch.core.epilogue import alpha_limit, stitch_slices
from repro_torch.core.graph import (Graph, exclusive_rank, resolve_device,
                                    shard_edges, to_device)
from repro_torch.core.partitioner import (I32_INF, NEConfig, PartitionResult,
                                          _mark_replicas, finalize_result,
                                          priority_enc, vertex_claims)
from repro_torch.dist import compat
from repro_torch.io.edgefile import EdgeFile
from repro_torch.io.stream import require_canonical, shard_edges_stream
from repro_torch.kernels.ne_round import ops as ne_ops
from repro_torch.kernels.ne_round import ref as ne_ref

SUM = dist.ReduceOp.SUM


class SpmdState(NamedTuple):
    """One rank's round state; every field but ``edge_part`` is the same
    on every rank."""

    edge_part: torch.Tensor       # (C,)   int32 own shard, -1 = unallocated
    vparts: torch.Tensor          # (N, W) int32 packed replica sets
    degree_rest: torch.Tensor     # (N,)   int32
    edges_per_part: torch.Tensor  # (P,)   int32
    key: torch.Tensor             # (2,)   int64 threefry key words
    rounds: torch.Tensor          # ()     int32
    remaining: torch.Tensor       # ()     int32 unallocated edges, global


def replica_delta(new, part, u_loc, v_loc, n: int, p_num: int):
    """(N, P) bool: the replica flags that one allocation batch sets."""
    vnew = torch.zeros((n, p_num), dtype=torch.bool, device=u_loc.device)
    _mark_replicas(vnew, u_loc, v_loc, part, new)
    return vnew


def _apply_alloc(new, part, u_loc, v_loc, n, p_num, vparts, degree_rest,
                 edges_per_part, group, local_counts=None):
    """Fold one local allocation batch into the replicated state: the
    paper's SyncVertexAllocations.  Returns ``(vparts, degree_rest,
    edges_per_part, new_total)``."""
    newi = new.to(torch.int32)
    counts = local_counts
    if counts is None:
        add = torch.where(new, part, torch.zeros_like(part))
        counts = torch.zeros(p_num, dtype=torch.int32, device=new.device)
        counts.index_add_(0, add.long(), newi)
    dist.all_reduce(counts, SUM, group=group)
    delta = ne_ops.pack_bits(replica_delta(new, part, u_loc, v_loc, n, p_num))
    vparts = ne_ops.or_words(vparts, compat.or_all_reduce(delta, group))
    dec = torch.zeros(n, dtype=torch.int32, device=new.device)
    dec.index_add_(0, u_loc.long(), newi).index_add_(0, v_loc.long(), newi)
    dist.all_reduce(dec, SUM, group=group)
    return (vparts, degree_rest - dec, edges_per_part + counts,
            counts.sum(dtype=torch.int32))


def _two_hop_candidates(cfg: NEConfig, u_loc, v_loc, unal, vparts, enc_vec):
    """Condition (5) candidates of the local shard and their ranks among
    the shard's candidates of the same partition, in ``edge_chunk``
    chunks (the last one padded to the chunk length with u = v = 0 rows
    that are never unallocated, as the reference pads the shard).
    Returns ``(hist, cand, myrank)``: (P,) int32 candidate counts and
    (C,) int32 each."""
    p_num = cfg.num_partitions
    c_len = u_loc.shape[0]
    dev = u_loc.device
    ce = min(cfg.edge_chunk, c_len)
    hist = torch.zeros(p_num, dtype=torch.int32, device=dev)
    cand = torch.empty(c_len, dtype=torch.int32, device=dev)
    myrank = torch.empty(c_len, dtype=torch.int32, device=dev)
    for s in range(0, c_len, ce):
        uu, vv, un = u_loc[s:s + ce], v_loc[s:s + ce], unal[s:s + ce]
        pad = ce - uu.shape[0]
        if pad:
            uu, vv, un = (torch.nn.functional.pad(t, (0, pad))
                          for t in (uu, vv, un))
        # the AND of the packed words (32x fewer bytes than bools) and its
        # least enc over the set bits, in one kernel
        best = ne_ops.two_hop_best(vparts, uu, vv, un, enc_vec, p_num)
        cand_c = torch.where(best < I32_INF, best % p_num,
                             torch.full_like(best, -1))
        cand0 = cand_c.clamp(min=0).long()
        rank_c = exclusive_rank(cand_c, p_num) + hist[cand0]
        hist.index_add_(0, cand0, (cand_c >= 0).to(torch.int32))
        e = min(ce, c_len - s)
        cand[s:s + e] = cand_c[:e]
        myrank[s:s + e] = rank_c[:e]
    return hist, cand, myrank


# ---------------------------------------------------------------------------
# round-stepping surface
# ---------------------------------------------------------------------------

def spmd_round_step(cfg: NEConfig, limit: int, n: int, u_loc, v_loc,
                    mask_loc, state: SpmdState, group=None) -> SpmdState:
    """One paper round on this rank: ``u_loc``/``v_loc``/``mask_loc`` are
    its (C,) shard on its device, ``state`` its round state.  Every rank
    of ``group`` calls it together.  ``cfg`` must be clamped."""
    p_num = cfg.num_partitions
    key, sub = trandom.split(state.key)

    # --- 1. replicated selection + claims ----------------------------------
    vparts_rep = ne_ops.unpack_bits(state.vparts, p_num)
    vclaim = vertex_claims(cfg, limit, vparts_rep, state.degree_rest,
                           state.edges_per_part, sub)
    del vparts_rep

    # --- 2. one-hop allocation on the local shard --------------------------
    part1, counts1 = ne_ops.one_hop(vclaim, u_loc, v_loc, state.edge_part,
                                    p_num, mask=mask_loc)
    new1 = part1 >= 0
    edge_part = torch.where(new1, part1, state.edge_part)

    # --- 3. SyncVertexAllocations ------------------------------------------
    vparts, degree_rest, edges_per_part, new_total = _apply_alloc(
        new1, part1, u_loc, v_loc, n, p_num, state.vparts, state.degree_rest,
        state.edges_per_part, group, local_counts=counts1)

    # --- 4. two-hop free edges, Condition (5) ------------------------------
    if cfg.two_hop:
        pid = torch.arange(p_num, dtype=torch.int32, device=u_loc.device)
        enc_vec = priority_enc(edges_per_part, pid, p_num)
        enc_vec = torch.where(edges_per_part <= limit, enc_vec,
                              torch.full_like(enc_vec, I32_INF))
        quota = (limit + 1 - edges_per_part).clamp(min=0)
        unal = mask_loc & (edge_part < 0)
        hist, cand, myrank = _two_hop_candidates(cfg, u_loc, v_loc, unal,
                                                 vparts, enc_vec)
        cand0 = cand.clamp(min=0).long()
        # deterministic cross-rank quota split: rank r's candidates for
        # partition p rank after all candidates on ranks < r
        hists = compat.all_gather_rows(hist, group)               # (D, P)
        before = hists[:dist.get_rank(group)].sum(dim=0, dtype=torch.int32)
        keep = (cand >= 0) & (before[cand0] + myrank < quota[cand0])
        part2 = torch.where(keep, cand, torch.full_like(cand, -1))
        edge_part = torch.where(keep, part2, edge_part)
        vparts, degree_rest, edges_per_part, new2 = _apply_alloc(
            keep, part2, u_loc, v_loc, n, p_num, vparts, degree_rest,
            edges_per_part, group)
        new_total = new_total + new2

    return SpmdState(edge_part, vparts, degree_rest, edges_per_part, key,
                     state.rounds + 1, state.remaining - new_total)


def spmd_init_state(shards: np.ndarray, masks: np.ndarray, n: int,
                    cfg: NEConfig, device=None) -> SpmdState:
    """The initial round state of one rank, built from the host shards:
    global D_rest from the valid edges of every shard, an all-unallocated
    (C,) ``edge_part`` and empty packed replica sets."""
    flat = shards.reshape(-1, 2)[masks.reshape(-1)]
    degree = (np.bincount(flat[:, 0], minlength=n)
              + np.bincount(flat[:, 1], minlength=n))
    return spmd_state0(masks.shape[1], degree, flat.shape[0], cfg,
                       device=device)


def spmd_state0(cap: int, degree: np.ndarray, m: int, cfg: NEConfig,
                device=None) -> SpmdState:
    """The initial round state of one rank from its shard capacity
    ``cap``, the global (N,) degree and edge count ``m``: what a rank of
    a multi-controller run builds from the ingestion exchange, which
    never hands it the other ranks' shards."""
    dev = resolve_device(device)
    p_num = cfg.num_partitions
    return SpmdState(
        edge_part=torch.full((cap,), -1, dtype=torch.int32, device=dev),
        vparts=torch.zeros((degree.shape[0], ne_ref.replica_words(p_num)),
                           dtype=torch.int32, device=dev),
        degree_rest=torch.from_numpy(degree.astype(np.int32)).to(dev),
        edges_per_part=torch.zeros(p_num, dtype=torch.int32, device=dev),
        key=trandom.PRNGKey(cfg.seed, device=dev),
        rounds=torch.zeros((), dtype=torch.int32, device=dev),
        remaining=torch.tensor(m, dtype=torch.int32, device=dev),
    )


def spmd_done(state: SpmdState, cfg: NEConfig) -> bool:
    """Host-side mirror of the reference's round-loop condition."""
    return bool(int(state.remaining) <= 0
                or int(state.rounds) >= cfg.max_rounds)


def round_quality(cfg: NEConfig, state, n: int) -> dict:
    """Live quality gauges from a round state (SpmdState or NEState): RF,
    EB and VB of the current replica and edge counts, the boundary size
    (replicated vertices with unallocated degree) and ΣD_rest.  At the
    fixed point they equal the finalized result's metrics."""
    vparts = state.vparts
    if vparts.dtype == torch.int32:
        vparts = ne_ops.unpack_bits(vparts, cfg.num_partitions)
    vrep = vparts.sum(dim=0, dtype=torch.int32).cpu().numpy().astype(np.int64)
    boundary = int((vparts.any(dim=1) & (state.degree_rest > 0)).sum())
    degree_sum = int(state.degree_rest.sum(dtype=torch.int32))
    counts = state.edges_per_part.cpu().numpy().astype(np.int64)
    rf = float(vrep.sum()) / float(max(n, 1))
    eb = float(counts.max()) / max(float(counts.mean()), 1e-9)
    vb = float(vrep.max()) / max(float(vrep.mean()), 1e-9)
    return {"rf": rf, "eb": eb, "vb": vb, "boundary": boundary,
            "degree_sum": degree_sum}


def round_sync_payload_bytes(cfg: NEConfig, n: int, num_dev: int) -> int:
    """Per-rank bytes one round's SyncVertexAllocations moves: each
    ``_apply_alloc`` all-reduces the packed (N, ceil(P/32)) replica delta,
    the (P,) count and the (N,) D_rest deltas; two-hop adds a second sync
    and the (D, P) quota-histogram all-gather."""
    p = cfg.num_partitions
    per_sync = n * ne_ref.replica_words(p) * 4 + p * 4 + n * 4
    syncs = 2 if cfg.two_hop else 1
    gather = num_dev * p * 4 if cfg.two_hop else 0
    return syncs * per_sync + gather


def stitch_edge_part(ep_sh: np.ndarray, dev: np.ndarray, m: int,
                     ) -> np.ndarray:
    """Shard-order assignments (D, C) back to global edge order: shard d
    holds ``edges[dev == d]`` in their original relative order."""
    edge_part = np.full((m,), -1, np.int32)
    ep_sh = np.asarray(ep_sh)
    eids = {dd: np.flatnonzero(dev == dd) for dd in range(ep_sh.shape[0])}
    return stitch_slices(edge_part, {dd: ep_sh[dd] for dd in eids}, eids)


def rank_device(rank: int, device=None) -> torch.device:
    """``device``, or for ``None`` the card ``cuda:(rank % count)``;
    raises without a card."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the host")
    return torch.device("cuda", rank % torch.cuda.device_count())


def require_group() -> None:
    """Raise unless a torch.distributed group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the SPMD partitioner runs on every rank of an "
                           "initialised torch.distributed group (see "
                           "repro_torch.dist.compat.world1 and spawn)")


def shard_input(source, num_devices: int):
    """Edge shards + metadata from a Graph or a canonical EdgeFile:
    ``(n, m, edges, shards, masks, dev)`` with host ``edges`` (M, 2)
    int32 and ``dev`` the (M,) device of each edge.

    The EdgeFile path never builds a CSR: the SPMD partitioner needs only
    the raw edge shards, so a store handle goes disk → padded shards in
    two block passes (``io.stream.shard_edges_stream``).
    """
    if isinstance(source, Graph):
        edges = source.edges.cpu().numpy()
        shards, masks, _, dev = shard_edges(edges, num_devices)
        return (source.num_vertices, source.num_edges, edges, shards, masks,
                dev)
    if not isinstance(source, EdgeFile):
        raise TypeError(f"the SPMD partitioner takes a Graph or a canonical "
                        f"EdgeFile, got {type(source).__name__}")
    require_canonical(source)
    shards, masks, _, dev, edges = shard_edges_stream(source, num_devices,
                                                      with_edges=True)
    return (int(source.num_vertices), int(source.num_edges), edges, shards,
            masks, dev)


def rank_shard(shards: np.ndarray, masks: np.ndarray, rank: int, device):
    """Rank ``rank``'s (C,) shard columns ``u``, ``v`` and its mask as
    tensors on ``device``."""
    return tuple(to_device(a, device) for a in (shards[rank, :, 0],
                                                shards[rank, :, 1],
                                                masks[rank]))


def spmd_result(state: SpmdState, dev_of: np.ndarray, edges: np.ndarray,
                cfg: NEConfig, group=None) -> PartitionResult:
    """Every rank of ``group``: all-gather the shards' assignments, stitch
    them back to edge order, unpack the replica words and run the host
    epilogue; every rank returns the same :class:`PartitionResult`."""
    ep_sh = compat.all_gather_rows(state.edge_part, group).cpu().numpy()
    edge_part = stitch_edge_part(ep_sh, dev_of, edges.shape[0])
    vparts = ne_ref.unpack_bits_np(state.vparts.cpu().numpy(),
                                   cfg.num_partitions)
    return finalize_result(edge_part, vparts, state.edges_per_part, edges,
                           cfg, int(state.rounds))


def empty_result(n: int, p_num: int) -> PartitionResult:
    """The result of partitioning a graph with no edges."""
    return PartitionResult(np.zeros((0,), np.int32),
                           np.zeros((n, p_num), bool),
                           np.zeros((p_num,), np.int32), 0, 0)


def partition_spmd(g, cfg: NEConfig, group=None,
                   device=None) -> PartitionResult:
    """Run Distributed NE as an SPMD program over 2D-hash edge shards.

    Every rank of an initialised process group (``group``, default the
    world) calls it with the same graph and config; it raises without a
    group.  ``g`` is a port Graph or a canonical ``io.EdgeFile``
    (partitioned straight from the store, no CSR built).  Each rank
    shards the edge list on the host, keeps its own shard on ``device``
    (``None``: the card ``cuda:(rank % count)``) and runs rounds to the
    fixed point; then the shards' assignments are all-gathered and
    stitched, and every rank returns the same host-side
    :class:`PartitionResult` as ``core.partitioner.partition`` does.
    """
    require_group()
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    dev = rank_device(rank, device)
    n, m, edges, shards, masks, dev_of = shard_input(g, world)
    cfg = cfg.clamped(n)
    if m == 0:
        return empty_result(n, cfg.num_partitions)

    limit = alpha_limit(cfg.alpha, m, cfg.num_partitions)
    u_loc, v_loc, mask_loc = rank_shard(shards, masks, rank, dev)
    state = spmd_init_state(shards, masks, n, cfg, device=dev)
    del shards, masks
    while not spmd_done(state, cfg):
        state = spmd_round_step(cfg, limit, n, u_loc, v_loc, mask_loc, state,
                                group)
    return spmd_result(state, dev_of, edges, cfg, group)


def spmd_state_from_numpy(arrays: dict, device=None,
                          group=None) -> SpmdState:
    """This rank's SpmdState on ``device`` from the reference's state as
    numpy arrays (a dict with the SpmdState field names): ``edge_part``
    is row ``rank`` (this process's rank in ``group``, 0 without a group)
    of the reference's (D, C), or of a ``{rank: row}`` dict, the uint32
    ``vparts`` words become their int32 bit patterns, the uint32 ``key``
    words int64."""
    dev = resolve_device(device)
    rank = dist.get_rank(group) if dist.is_initialized() else 0

    def t(a, dtype):
        # np.array, not ascontiguousarray: that makes a 0-d round count 1-d
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(dev)

    words = np.ascontiguousarray(arrays["vparts"], dtype=np.uint32)
    return SpmdState(
        edge_part=t(arrays["edge_part"][rank], np.int32),
        vparts=torch.from_numpy(words.view(np.int32).copy()).to(dev),
        degree_rest=t(arrays["degree_rest"], np.int32),
        edges_per_part=t(arrays["edges_per_part"], np.int32),
        key=t(arrays["key"], np.int64),
        rounds=t(arrays["rounds"], np.int32),
        remaining=t(arrays["remaining"], np.int32),
    )


def spmd_state_to_numpy(state: SpmdState) -> dict:
    """The inverse of :func:`spmd_state_from_numpy` for one rank: numpy
    arrays with the reference's dtypes (``vparts`` and ``key`` as uint32;
    ``edge_part`` this rank's (C,) row)."""
    out = {f: getattr(state, f).cpu().numpy().copy()
           for f in SpmdState._fields}
    out["vparts"] = out["vparts"].view(np.uint32)
    out["key"] = out["key"].astype(np.uint32)
    return out
