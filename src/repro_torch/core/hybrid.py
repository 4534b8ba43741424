"""HEP-style hybrid edge partitioning (Mayer & Jacobsen 2021, adapted).

The paper's Distributed NE wins on replication factor but pays for it in
memory: the expansion needs the CSR of everything it partitions.  HEP's
observation is that the high-degree tail of a skewed graph is the wrong
place to spend that memory — hub vertices end up replicated almost
everywhere under *any* method, so hashing their edges costs little
quality, while the low-degree body is exactly where neighbor expansion
earns its keep.  ``partition_hybrid`` implements that split under an
explicit memory budget:

1. **threshold** — :func:`degree_threshold` derives the degree cutoff θ
   from the budget τ ∈ (0, 1]: the largest θ such that the adjacency
   slots of all vertices with ``deg ≤ θ`` fit in ``τ · 2M`` slots.
2. **split** — :func:`hybrid_split` partitions the edge set on the host
   (numpy): an edge is *low* iff at least one endpoint has ``deg ≤ θ``;
   only hub–hub edges are assigned at once, by the same 2D grid hash as
   the ``grid_2d`` baseline (one streamed pass over a store: the full
   CSR is never built).
3. **expansion** — the NE rounds run over the low subgraph only, on the
   device, through the round function of the primary partitioner
   (``core.partitioner._round``, with its CUDA kernels on the card), from
   a round state pre-seeded with the tail's ``|E_p|`` counts and replica
   marks.
4. **stitch** — both halves meet in the shared finalize epilogue
   (``core.epilogue.cleanup_leftovers`` water-fills the ``max_rounds``
   leftovers under the *global* α-capacity).

A port of the reference package's ``core/hybrid.py``: every result is
bit-identical to the reference's on the same inputs.  Its ``_hybrid_jit``
``while_loop`` is :func:`hybrid_rounds`, a Python loop over ``_round``
with the same condition.  With ``budget_frac=1.0`` the tail is empty and
the run equals ``partition`` under the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.epilogue import alpha_limit, cleanup_leftovers
from repro_torch.core.graph import Graph, from_edges, resolve_device
from repro_torch.core.metrics import stats_from_counts
from repro_torch.core.partitioner import (NEConfig, NEState, PartitionResult,
                                          _host, _round, ne_done,
                                          ne_init_state)
from repro_torch.io.csr import grid_assign_host
from repro_torch.io.edgefile import EdgeFile
from repro_torch.io.stream import degree_indptr, require_canonical
from repro_torch.obs import trace as obs

# the NE hyper-parameters a HybridConfig forwards to the expansion phase
_NE_FIELDS = ("num_partitions", "alpha", "lam", "k_sel", "max_rounds",
              "edge_chunk", "two_hop", "seed")


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Hybrid partitioning hyper-parameters.

    ``budget_frac`` is the memory budget τ: the NE phase may hold at most
    ``τ · 2M`` adjacency slots (τ = 1 degenerates to pure Distributed NE;
    smaller τ hashes a larger tail).  Every other field mirrors
    :class:`~repro_torch.core.partitioner.NEConfig` and is forwarded to
    the expansion phase verbatim.

    The reference's config also has ``sel_chunk`` and ``use_pallas``,
    which the port's ``NEConfig`` dropped (it selects all P rows in one
    call and always runs its kernels).  ``runtime.snapshot.
    config_fingerprint`` hashes them at ``sel_chunk = 8``,
    ``use_pallas = True``, so a hybrid config's digest equals the
    reference's with those values.
    """

    num_partitions: int
    budget_frac: float = 0.5    # τ: NE-phase slot budget as a fraction of 2M
    alpha: float = 1.1
    lam: float = 0.1
    k_sel: int = 256
    max_rounds: int = 4096
    edge_chunk: int = 1 << 18
    two_hop: bool = True
    seed: int = 0
    grid_salt: int = 0          # tail-hash salt; 0 matches the grid_2d baseline

    def __post_init__(self):
        assert self.num_partitions >= 1
        assert self.alpha > 1.0
        assert 0.0 < self.budget_frac <= 1.0

    def ne_config(self) -> NEConfig:
        """The NEConfig of the expansion phase (shared round functions)."""
        return NEConfig(**{f: getattr(self, f) for f in _NE_FIELDS})

    def clamped(self, num_vertices: int) -> "HybridConfig":
        return dataclasses.replace(self, k_sel=min(self.k_sel, num_vertices))


def degree_threshold(degree: np.ndarray, budget_frac: float) -> int:
    """Degree cutoff θ for memory budget τ = ``budget_frac``.

    The largest θ such that ``Σ_{v: deg(v) ≤ θ} deg(v) ≤ τ · Σ_v deg(v)``
    — i.e. the adjacency slots of the θ-low vertex set fit the budget.
    Every low edge is incident to at least one low vertex, so
    ``M_low ≤ τ · 2M``.  Floored at 1 so the expansion phase always
    exists; τ = 1 returns the maximum degree (pure NE).
    """
    degree = np.asarray(degree, np.int64)
    total = int(degree.sum())
    if total == 0:
        return 1
    hist = np.bincount(degree)
    slots = np.cumsum(hist * np.arange(hist.size, dtype=np.int64))
    theta = int(np.searchsorted(slots, budget_frac * total, side="right")) - 1
    return max(theta, 1)


class HybridSplit(NamedTuple):
    """Output of :func:`hybrid_split` — everything the expansion phase and
    the stitch need, with no reference back to the source store."""

    low: Graph               # subgraph of low edges (full vertex space)
    low_eids: np.ndarray     # (M_low,) int64 global edge ids of low edges
    edge_part0: np.ndarray   # (M,) int32: tail grid assignments, low = -1
    tail_counts: np.ndarray  # (P,) int64 |E_p| placed by the tail hash
    tail_vparts: np.ndarray  # (N, P) bool replicas created by the tail hash
    threshold: int
    num_vertices: int
    num_edges: int


def _split_block(blk: np.ndarray, off: int, degree: np.ndarray, theta: int,
                 cfg: HybridConfig, edge_part0: np.ndarray,
                 tail_counts: np.ndarray, tail_vparts: np.ndarray):
    """Split one block of edges whose global ids start at ``off``: an edge
    is low iff an endpoint has ``deg <= theta``.  The tail's grid
    assignments go into ``edge_part0``, ``tail_counts`` and
    ``tail_vparts`` in place; returns the block's low edges (int32) and
    their global ids (int64)."""
    p = cfg.num_partitions
    lowm = (degree[blk[:, 0]] <= theta) | (degree[blk[:, 1]] <= theta)
    tail = blk[~lowm]
    if tail.shape[0]:
        part = grid_assign_host(tail, p, salt=cfg.grid_salt)
        edge_part0[off + np.flatnonzero(~lowm)] = part
        tail_counts += np.bincount(part, minlength=p)
        tail_vparts[tail[:, 0], part] = True
        tail_vparts[tail[:, 1], part] = True
    return (np.ascontiguousarray(blk[lowm], dtype=np.int32),
            np.flatnonzero(lowm).astype(np.int64) + off)


def hybrid_split(source, cfg: HybridConfig, device=None) -> HybridSplit:
    """Degree threshold + low/tail split + tail grid assignment, on the
    host; the low subgraph is built on ``device`` (``None``: a Graph's own
    device, the card for an EdgeFile).

    ``source`` is a port :class:`Graph` (one block: its resident edge
    array) or a canonical :class:`EdgeFile`, streamed block by block —
    degrees from one index pass (``degree_indptr``), the split and the
    tail hash from a second — so the only O(M) allocations are the
    outputs themselves (the low edge list and the (M,) assignment); the
    full-graph CSR is never built.  Both go through :func:`_split_block`,
    so their splits are bit-identical.
    """
    p = cfg.num_partitions
    if isinstance(source, Graph):
        dev = source.device if device is None else resolve_device(device)
        n, m = source.num_vertices, source.num_edges
        degree = _host(source.degree).astype(np.int64)
        blocks = [_host(source.edges)]
    elif isinstance(source, EdgeFile):
        require_canonical(source)
        dev = resolve_device(device)
        n, m = int(source.num_vertices), int(source.num_edges)
        degree = degree_indptr(source)[0].astype(np.int64)
        blocks = source.iter_blocks()
    else:
        raise TypeError("hybrid_split takes a Graph or a canonical "
                        f"EdgeFile, got {type(source).__name__}")
    theta = degree_threshold(degree, cfg.budget_frac)
    edge_part0 = np.full(m, -1, np.int32)
    tail_counts = np.zeros(p, np.int64)
    tail_vparts = np.zeros((n, p), bool)
    low_blocks = [np.zeros((0, 2), np.int32)]
    low_eid_blocks = [np.zeros((0,), np.int64)]
    off = 0
    for blk in blocks:
        low, eids = _split_block(blk, off, degree, theta, cfg, edge_part0,
                                 tail_counts, tail_vparts)
        low_blocks.append(low)
        low_eid_blocks.append(eids)
        off += blk.shape[0]
    # low edges are a subset of a canonical order, hence still canonical
    low = from_edges(np.concatenate(low_blocks), num_vertices=n, dedup=False,
                     device=dev)
    return HybridSplit(low, np.concatenate(low_eid_blocks), edge_part0,
                       tail_counts, tail_vparts, int(theta), int(n), int(m))


def hybrid_init_state(split: HybridSplit, necfg: NEConfig) -> NEState:
    """NE round state over the low subgraph on its device, pre-seeded with
    the tail phase's per-partition edge counts and replica marks (copies:
    the rounds update the state in place).  With an empty tail this is
    exactly ``ne_init_state``."""
    st = ne_init_state(split.low, necfg)
    dev = split.low.device
    return st._replace(
        vparts=torch.from_numpy(np.array(split.tail_vparts)).to(dev),
        edges_per_part=torch.from_numpy(
            split.tail_counts.astype(np.int32)).to(dev))


def hybrid_rounds(low: Graph, necfg: NEConfig, limit: int,
                  state: NEState) -> NEState:
    """The expansion's round loop from ``state`` to the fixed point (or
    ``max_rounds``): the same ``_round`` that ``PartitionDriver``
    (mode="hybrid") steps one call at a time, which is what makes pause
    and resume bit-identical.  ``limit`` is the whole graph's α-limit."""
    while not ne_done(state, necfg):
        state = _round(low, necfg, limit, state)
    return state


def hybrid_finalize(state: NEState, split: HybridSplit,
                    cfg: HybridConfig) -> PartitionResult:
    """Stitch the two phases through the shared epilogue.

    Low-slot assignments scatter to their global edge ids over the tail
    grid assignments; the ``max_rounds`` leftovers (always low edges —
    the tail is fully assigned by construction) water-fill under the
    *global* α-capacity via the exact ``cleanup_leftovers`` every other
    partitioning path uses.  Counts/replicas already carry both phases
    (the seeded state), so the stats combine is the standard one.
    """
    p = cfg.num_partitions
    limit = alpha_limit(cfg.alpha, split.num_edges, p)
    ep_low = _host(state.edge_part)
    vparts = _host(state.vparts)
    counts = _host(state.edges_per_part)
    leftover = cleanup_leftovers(ep_low, vparts, counts,
                                 _host(split.low.edges), p, limit)
    edge_part = split.edge_part0.copy()
    edge_part[split.low_eids] = ep_low
    stats = stats_from_counts(vparts.sum(axis=0), counts,
                              split.num_vertices)
    return PartitionResult(edge_part, vparts, counts, int(state.rounds),
                           leftover, stats)


def partition_hybrid(source, cfg: HybridConfig,
                     device=None) -> PartitionResult:
    """Run hybrid partitioning end to end.

    ``source`` is a port Graph (run on its device unless ``device`` says
    otherwise) or a canonical EdgeFile (split and hashed streamed on the
    host, the expansion on ``device``: ``None`` means the card).  Returns
    the same :class:`PartitionResult` surface as ``partition``.  Its
    three phases are ``obs.trace`` spans: ``hybrid_split`` (with θ and
    M_low), ``hybrid_rounds`` (with the rounds) and ``hybrid_finalize``.
    """
    with obs.span("hybrid_split", cat="hybrid") as sp:
        split = hybrid_split(source, cfg, device=device)
        sp.set(threshold=split.threshold, low_edges=split.low.num_edges)
    cfg = cfg.clamped(split.num_vertices)
    necfg = cfg.ne_config()
    limit = alpha_limit(cfg.alpha, split.num_edges, cfg.num_partitions)
    with obs.span("hybrid_rounds", cat="hybrid") as sp:
        state = hybrid_init_state(split, necfg)
        if split.low.num_edges:
            state = hybrid_rounds(split.low, necfg, limit, state)
        sp.set(rounds=int(state.rounds))
    with obs.span("hybrid_finalize", cat="hybrid"):
        return hybrid_finalize(state, split, cfg)


__all__ = ["HybridConfig", "HybridSplit", "degree_threshold",
           "hybrid_finalize", "hybrid_init_state", "hybrid_rounds",
           "hybrid_split", "partition_hybrid"]
