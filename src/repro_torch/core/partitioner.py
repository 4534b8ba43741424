"""Distributed Neighbor Expansion (Distributed NE) on one device, in torch.

The port of the reference package's single-controller partitioner: the
paper's parallel expansion (§3), distributed edge allocation (§4) and
multi-expansion (§5).  One call of :func:`_round` is one paper round:

  1. every active partition selects its ``k = clamp(λ·|B_p|, 1, K)``
     minimum-``D_rest`` boundary vertices (``select``); empty boundaries
     re-seed from a random vertex with unallocated edges,
  2. vertex-grain claims (``claim_scatter``) and one-hop allocation
     (``one_hop``) with the deterministic ``(|E_p|, p)`` conflict rule,
  3. replica-set updates,
  4. two-hop "free edge" allocation under Condition (5) (``two_hop_best``).

The round's kernels run through ``repro_torch.kernels.ne_round.ops``: on
the card they are CUDA kernels, on the CPU their plain versions.  The
reference's ``while_loop`` becomes a Python loop over :func:`_round` with
the same condition; its ``lax.map`` over selection chunks becomes one
``select_chunk`` call over all P partitions (with the restart draw inside,
made on the card only for the partitions that restart), and its
``lax.scan`` over two-hop edge chunks a Python loop with the same chunk
size and order.  Every result is bit-identical to the reference's.

:func:`_round` updates the large arrays of the state it is given
(``edge_part``, ``vparts``, ``degree_rest``) in place, to save device
memory, and returns the new state, which holds the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.epilogue import alpha_limit, cleanup_leftovers
from repro_torch.core.graph import (Graph, as_graph, exclusive_rank,
                                    resolve_device)
from repro_torch.core.metrics import stats_from_counts
from repro_torch.kernels.ne_round import ops as ne_ops
from repro_torch.kernels.ne_round import ref as ne_ref

I32_INF = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class NEConfig:
    """Distributed NE hyper-parameters (paper defaults)."""

    num_partitions: int
    alpha: float = 1.1          # imbalance factor (paper §7.1)
    lam: float = 0.1            # expansion factor λ (paper §5, Fig. 6)
    k_sel: int = 256            # static cap on per-round selections per part
    max_rounds: int = 4096      # safety bound on the round loop
    edge_chunk: int = 1 << 18   # edges per two-hop intersection chunk
    two_hop: bool = True        # Condition (5) allocation on/off (ablation)
    seed: int = 0

    def __post_init__(self):
        assert self.num_partitions >= 1
        assert self.alpha > 1.0
        assert 0.0 < self.lam <= 1.0

    def clamped(self, num_vertices: int) -> "NEConfig":
        return dataclasses.replace(self, k_sel=min(self.k_sel, num_vertices))


class NEState(NamedTuple):
    edge_part: torch.Tensor       # (M,)   int32, -1 = unallocated
    vparts: torch.Tensor          # (N, P) bool replica sets  V(E_p)
    degree_rest: torch.Tensor     # (N,)   int32  D_rest
    edges_per_part: torch.Tensor  # (P,)   int32  |E_p|
    key: torch.Tensor             # (2,)   int64 threefry key words
    rounds: torch.Tensor          # ()     int32
    new_last_round: torch.Tensor  # ()     int32  edges allocated last round


class PartitionResult:
    """Final output of a partitioning run, as host numpy arrays.

    Fields: ``edge_part`` (M,) int32 final assignment, ``vparts`` (N, P)
    bool replica sets, ``edges_per_part`` (P,) int32, ``rounds``,
    ``leftover`` (edges assigned by the cleanup pass) and ``stats``
    (:class:`repro_torch.core.metrics.PartitionStats`).

    ``edge_part`` may be a zero-argument callable: the sharded
    multi-controller finalize hands back a *lazy* assignment, so that no
    rank holds the O(M) global array unless a consumer asks for it.  It
    is materialized once, on first read.
    """

    __slots__ = ("_edge_part", "vparts", "edges_per_part", "rounds",
                 "leftover", "stats")

    def __init__(self, edge_part, vparts, edges_per_part, rounds, leftover,
                 stats=None):
        self._edge_part = edge_part
        self.vparts = vparts
        self.edges_per_part = edges_per_part
        self.rounds = rounds
        self.leftover = leftover
        self.stats = stats

    @property
    def edge_part(self) -> np.ndarray:
        if callable(self._edge_part):
            self._edge_part = self._edge_part()
        return self._edge_part

    @property
    def edge_part_materialized(self) -> bool:
        """False while a lazy assignment has not been forced yet."""
        return not callable(self._edge_part)


# one copy of the claim rule, shared with the kernels' plain versions
priority_enc = ne_ref._enc


def vertex_claims(cfg: NEConfig, limit: int, vparts, degree_rest,
                  edges_per_part, sub):
    """Selection (multi-expansion §5) + vertex-grain claims (Alg. 3).

    Returns (N,) int32 claim keys: ``priority_enc(|E_p|, p)`` for claimed
    vertices, ``I32_INF`` where no partition claimed the vertex.  All P
    partitions are selected in one call: a partition's key is
    ``fold_in(sub, p)`` whatever the chunking, and rows are independent,
    so the reference's chunks of ``sel_chunk`` rows give the same result.
    """
    n = vparts.shape[0]
    p_num = cfg.num_partitions
    active = edges_per_part <= limit                # soft cap (paper Alg. 1)
    keys = trandom.fold_in(sub, torch.arange(p_num, device=vparts.device))
    # vparts.T is a strided (P, N) view of the (N, P) map; the select kernel
    # reads it in place
    sel_idx, sel_valid = ne_ops.select_chunk(
        vparts.T, active, degree_rest, cfg.lam, cfg.k_sel, keys,
        limit - edges_per_part)
    return ne_ops.claim_scatter(sel_idx, sel_valid, edges_per_part, n, p_num)


def _mark_replicas(vparts, u, v, part, new):
    """``vparts[u, part] = vparts[v, part] = True`` where ``new``."""
    sel = new.nonzero().squeeze(1)
    row = part[sel].long()
    vparts[u[sel].long(), row] = True
    vparts[v[sel].long(), row] = True


def _two_hop(u, v, edge_part, vparts, edges_per_part, cfg: NEConfig,
             limit: int):
    """Condition (5) allocation: (M,) int32 part, -1 where none."""
    m = u.shape[0]
    p_num = cfg.num_partitions
    dev = u.device
    ce = min(cfg.edge_chunk, m)
    unal = edge_part < 0
    pid = torch.arange(p_num, dtype=torch.int32, device=dev)
    # tie-break by |E_p| (Alg. 3 line 16); free edges only go to partitions
    # under the α-capacity, at most their remaining capacity this round
    enc_vec = priority_enc(edges_per_part, pid, p_num)
    enc_vec = torch.where(edges_per_part <= limit, enc_vec,
                          torch.full_like(enc_vec, I32_INF))
    quota = (limit + 1 - edges_per_part).clamp(min=0)
    part2 = torch.empty(m, dtype=torch.int32, device=dev)
    for s in range(0, m, ce):
        best = ne_ops.two_hop_best(vparts, u[s:s + ce], v[s:s + ce],
                                   unal[s:s + ce], enc_vec, p_num)
        cand = torch.where(best < I32_INF, best % p_num,
                           torch.full_like(best, -1))
        rank = exclusive_rank(cand, p_num)
        keep = (cand >= 0) & (rank < quota[cand.clamp(min=0).long()])
        out = torch.where(keep, cand, torch.full_like(cand, -1))
        quota -= torch.zeros_like(quota).index_add_(
            0, out.clamp(min=0).long(), keep.to(torch.int32))
        part2[s:s + ce] = out
    return part2


def _round(g: Graph, cfg: NEConfig, limit: int, state: NEState) -> NEState:
    """One paper round (updates ``state``'s large arrays in place)."""
    p_num = cfg.num_partitions
    u, v = g.edges[:, 0].contiguous(), g.edges[:, 1].contiguous()
    key, sub = trandom.split(state.key)

    vclaim_key = vertex_claims(cfg, limit, state.vparts, state.degree_rest,
                               state.edges_per_part, sub)

    # --- one-hop allocation ------------------------------------------------
    part1, counts1 = ne_ops.one_hop(vclaim_key, u, v, state.edge_part, p_num)
    new1 = part1 >= 0
    edge_part = torch.where(new1, part1, state.edge_part, out=state.edge_part)
    vparts = state.vparts
    _mark_replicas(vparts, u, v, part1, new1)
    degree_rest = state.degree_rest
    neg1 = -new1.to(torch.int32)
    degree_rest.index_add_(0, u.long(), neg1).index_add_(0, v.long(), neg1)
    edges_per_part = state.edges_per_part + counts1
    new_total = new1.sum(dtype=torch.int32)

    # --- two-hop "free edge" allocation, Condition (5) --------------------
    if cfg.two_hop:
        part2 = _two_hop(u, v, edge_part, vparts, edges_per_part, cfg, limit)
        new2 = part2 >= 0
        torch.where(new2, part2, edge_part, out=edge_part)
        edges_per_part = edges_per_part + torch.zeros_like(
            edges_per_part).index_add_(0, part2.clamp(min=0).long(),
                                       new2.to(torch.int32))
        neg2 = -new2.to(torch.int32)
        degree_rest.index_add_(0, u.long(), neg2).index_add_(0, v.long(),
                                                             neg2)
        new_total = new_total + new2.sum(dtype=torch.int32)

    return NEState(edge_part, vparts, degree_rest, edges_per_part, key,
                   state.rounds + 1, new_total)


def _init_state(g: Graph, cfg: NEConfig) -> NEState:
    n, m, p = g.num_vertices, g.num_edges, cfg.num_partitions
    dev = g.device
    return NEState(
        edge_part=torch.full((m,), -1, dtype=torch.int32, device=dev),
        vparts=torch.zeros((n, p), dtype=torch.bool, device=dev),
        degree_rest=g.degree.to(torch.int32).clone(),
        edges_per_part=torch.zeros(p, dtype=torch.int32, device=dev),
        key=trandom.PRNGKey(cfg.seed, device=dev),
        rounds=torch.zeros((), dtype=torch.int32, device=dev),
        new_last_round=torch.ones((), dtype=torch.int32, device=dev),
    )


# Round-stepping surface (one call == one paper round), as the
# reference package exposes it.
ne_init_state = _init_state
ne_round_step = _round


def ne_done(state: NEState, cfg: NEConfig) -> bool:
    """Host-side mirror of the round loop condition."""
    return bool(not (state.edge_part < 0).any().item()
                or int(state.rounds) >= cfg.max_rounds)


def finalize_result(edge_part, vparts, counts, edges: np.ndarray,
                    cfg: NEConfig, rounds: int) -> PartitionResult:
    """Host-side epilogue: copy the device state to numpy, water-fill the
    ``max_rounds`` leftovers, attach the quality stats, wrap."""
    edge_part = _host(edge_part)
    vparts = _host(vparts)
    counts = _host(counts)
    limit = alpha_limit(cfg.alpha, edges.shape[0], cfg.num_partitions)
    leftover = cleanup_leftovers(edge_part, vparts, counts, edges,
                                 cfg.num_partitions, limit)
    stats = stats_from_counts(vparts.sum(axis=0), counts, vparts.shape[0])
    return PartitionResult(edge_part, vparts, counts, int(rounds), leftover,
                           stats)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def run_rounds(g: Graph, cfg: NEConfig) -> NEState:
    """The whole round loop on ``g``'s device, from the initial state to
    the fixed point (or ``max_rounds``).  ``cfg`` must be clamped."""
    limit = alpha_limit(cfg.alpha, g.num_edges, cfg.num_partitions)
    state = _init_state(g, cfg)
    while not ne_done(state, cfg):
        state = _round(g, cfg, limit, state)
    return state


def partition(g, cfg: NEConfig, device=None) -> PartitionResult:
    """Run Distributed NE.  Returns the host-side result, cleanup applied.

    ``g`` is a port Graph (run on its device) or an edge ndarray, which is
    built into a Graph on ``device`` (``None`` means the card).
    """
    g = as_graph(g, device=device)
    cfg = cfg.clamped(g.num_vertices)
    state = run_rounds(g, cfg)
    return finalize_result(state.edge_part, state.vparts,
                           state.edges_per_part, _host(g.edges), cfg,
                           int(state.rounds))


def state_from_numpy(arrays: dict, device=None) -> NEState:
    """A port NEState on ``device`` from the reference's state as numpy
    arrays (a dict with the NEState field names; ``key`` as the uint32
    (2,) key data)."""
    dev = resolve_device(device)

    def t(name, dtype):
        a = np.asarray(arrays[name])
        # np.array, not ascontiguousarray: that makes a 0-d round count 1-d
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(dev)

    return NEState(
        edge_part=t("edge_part", np.int32),
        vparts=t("vparts", np.bool_),
        degree_rest=t("degree_rest", np.int32),
        edges_per_part=t("edges_per_part", np.int32),
        key=t("key", np.int64),
        rounds=t("rounds", np.int32),
        new_last_round=t("new_last_round", np.int32),
    )


def state_to_numpy(state: NEState) -> dict:
    """The inverse of :func:`state_from_numpy`: numpy arrays with the
    reference's dtypes (``key`` as uint32)."""
    out = {name: _host(getattr(state, name)) for name in NEState._fields}
    out["key"] = out["key"].astype(np.uint32)
    return out
