"""Partition-serving query surface: routing, fan-out, metrics.

A copy of the reference package's ``serve/service.py``: the traversals
take the same steps in the same order, so a ``ppr`` dict equals the
reference's float for float, and the Prometheus text has the same
``repro_serve_*`` names.

:class:`PartitionService` answers graph queries from a
:class:`~repro_torch.serve.store.ShardStore`, routing every vertex query
via the artifact's cut-vertex replica map: a query for ``v`` touches *only*
the partitions that actually hold a replica of ``v``.  That makes the
paper's quality metric operational — **replication factor is the
fan-out cost**: the number of partitions a boundary-vertex query fans
out to is bounded by (and in the full-gang view equal to) the vertex's
replica count, which the service measures per query and asserts as an
invariant (docs/DESIGN-serve.md).

The traversal queries (:func:`k_hop`, :func:`ppr`) are written against
a plain ``neighbors(v)`` callable, so the same code runs over a local
service and over a :class:`~repro_torch.serve.gang.GangClient` fanning out to
a multi-process gang — which is how the bit-consistency tests compare
the two deployments.

Metrics: per-query latency ring buffer → QPS / p50 / p99, cache
hit-rate from the store, per-query fan-out histogram.  ``stats()`` is
the one snapshot both exposition paths consume — the Prometheus text
endpoint (:func:`render_serve_prometheus`, served at ``/metrics`` by
``repro_torch.serve.server``) and the live-bus heartbeat
(:meth:`PartitionService.publish_heartbeat` → ``repro_torch.obs.live``, so
``python -m repro_torch.tools.monitor_run`` watches a serving gang
exactly like a partitioning run).
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

from repro_torch.obs import live
from repro_torch.obs import trace as obs
from repro_torch.serve.batch import RequestBatcher
from repro_torch.serve.store import ShardStore


class FanoutViolation(AssertionError):
    """A query fanned out beyond the vertex's replica set — the routing
    invariant (fan-out ≤ replica count) is structural; tripping this
    means the replica map and the store disagree."""


class PartitionService:
    """Query surface over one store (one serving process's partitions).

    ``batch``/``deadline_s`` configure the request batcher behind
    :meth:`neighbors_batched`; pass ``batch=0`` to disable batching
    (every query executes inline).
    """

    def __init__(self, store: ShardStore, batch: int | None = None,
                 deadline_s: float | None = None,
                 latency_window: int = 4096):
        self.store = store
        self._lat = deque(maxlen=latency_window)   # (t_done, seconds)
        self._fanout = deque(maxlen=latency_window)
        self.served = 0
        self.fanout_hist: dict[int, int] = {}
        self._t0 = time.monotonic()
        self._hb_seq = 0
        self.batcher = None
        if batch is None or batch > 0:
            self.batcher = RequestBatcher(
                self._execute_neighbor_batch, max_batch=batch,
                max_delay_s=deadline_s)

    # -- core queries -------------------------------------------------------

    def _route(self, v: int) -> tuple[list[int], int]:
        """(owned replica partitions, global replica count) for ``v`` —
        and the invariant: fan-out never exceeds the replica count."""
        replicas = self.store.partitions_of(v)
        owned = [int(p) for p in replicas if p in self.store._parts]
        if len(owned) > replicas.size:
            raise FanoutViolation(
                f"vertex {v}: fan-out {len(owned)} exceeds replica "
                f"count {replicas.size}")
        return owned, int(replicas.size)

    def _record(self, t_start: float, fanout: int) -> None:
        now = time.monotonic()
        self._lat.append((now, now - t_start))
        self._fanout.append(fanout)
        self.fanout_hist[fanout] = self.fanout_hist.get(fanout, 0) + 1
        self.served += 1

    def neighbors(self, v: int) -> np.ndarray:
        """Sorted neighbors of ``v`` across this store's partitions.

        For a store owning every partition this is ``v``'s complete
        adjacency (vertex-cut invariant); a partition-group store
        returns its share, which the gang client merges.
        """
        t0 = time.monotonic()
        owned, _reps = self._route(v)
        with obs.span("serve_neighbors", cat="serve", fanout=len(owned)):
            if not owned:
                out = np.zeros(0, np.int64)
            elif len(owned) == 1:
                out = self.store.neighbors(owned[0], v)
            else:
                out = np.unique(np.concatenate(
                    [self.store.neighbors(p, v) for p in owned]))
        self._record(t0, len(owned))
        return out

    def _execute_neighbor_batch(self, vs: list) -> list:
        """Batch executor: one pass grouped so each (partition, shard)
        decodes at most once per batch even with the cache off."""
        order = sorted(
            range(len(vs)),
            key=lambda i: (self.store.owned_partitions_of(vs[i]) or [-1]))
        out: list = [None] * len(vs)
        for i in order:
            out[i] = self.neighbors(vs[i])
        return out

    def neighbors_batched(self, v: int) -> np.ndarray:
        """Like :meth:`neighbors`, through the collect-until-deadline
        batcher (what the HTTP handler threads call)."""
        if self.batcher is None:
            return self.neighbors(v)
        return self.batcher(v)

    def feature(self, v: int) -> np.ndarray:
        """The vertex's feature vector — replica-independent, so any
        partition holding ``v`` (or none) serves identical bytes."""
        t0 = time.monotonic()
        out = self.store.features(v)[0]
        self._record(t0, 0)
        return out

    def degree(self, v: int) -> int:
        owned, _ = self._route(v)
        return sum(self.store.degree(p, v) for p in owned)

    # -- traversal queries (shared with the gang client) --------------------

    def k_hop(self, v: int, k: int) -> np.ndarray:
        return k_hop(self.neighbors, v, k)

    def ppr(self, v: int, alpha: float = 0.15, eps: float = 1e-4,
            max_pushes: int = 100_000) -> dict:
        return ppr(self.neighbors, v, alpha=alpha, eps=eps,
                   max_pushes=max_pushes)

    # -- metrics ------------------------------------------------------------

    def latencies_ms(self) -> np.ndarray:
        return np.asarray([lat * 1e3 for _, lat in self._lat])

    def stats(self) -> dict:
        lats = self.latencies_ms()
        window = list(self._lat)
        qps = 0.0
        if len(window) >= 2:
            span = window[-1][0] - window[0][0]
            if span > 0:
                qps = (len(window) - 1) / span
        fo = np.asarray(self._fanout, np.int64)
        fo = fo[fo > 0]
        return {
            "served": self.served,
            "uptime_s": time.monotonic() - self._t0,
            "qps": qps,
            "p50_ms": float(np.percentile(lats, 50)) if lats.size else None,
            "p99_ms": float(np.percentile(lats, 99)) if lats.size else None,
            "fanout_mean": float(fo.mean()) if fo.size else 0.0,
            "fanout_max": int(fo.max()) if fo.size else 0,
            "fanout_hist": dict(sorted(self.fanout_hist.items())),
            "cache": self.store.cache.stats(),
            "store": self.store.stats(),
            "batch": self.batcher.stats() if self.batcher else None,
        }

    def publish_heartbeat(self) -> None:
        """One live-bus snapshot (``repro_torch.obs.live``): heartbeat +
        serving gauges, monitorable with
        ``python -m repro_torch.tools.monitor_run``."""
        self._hb_seq += 1
        st = self.stats()
        live.publish(phase="serve", round=self._hb_seq,
                     qps=st["qps"], p99_ms=st["p99_ms"],
                     cache_hit=st["cache"]["hit_ratio"],
                     fanout=st["fanout_mean"])

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()
            self.batcher = None


# ---------------------------------------------------------------------------
# traversal algorithms over any neighbors(v) provider
# ---------------------------------------------------------------------------

def k_hop(neighbors_fn, v: int, k: int) -> np.ndarray:
    """Sorted vertices within ``k`` hops of ``v`` (including ``v``)."""
    seen = {int(v)}
    frontier = [int(v)]
    for _ in range(int(k)):
        nxt = []
        for u in frontier:
            for w in neighbors_fn(u):
                w = int(w)
                if w not in seen:
                    seen.add(w)
                    nxt.append(w)
        if not nxt:
            break
        frontier = nxt
    return np.asarray(sorted(seen), np.int64)


def ppr(neighbors_fn, v: int, alpha: float = 0.15, eps: float = 1e-4,
        max_pushes: int = 100_000) -> dict:
    """Personalized PageRank by incremental forward push (Andersen,
    Chung, Lang 2006) — the graph-serving PageRank: each query pushes
    only around its source instead of iterating the whole graph, and
    every ``neighbors`` call routes through the replica map like any
    other query.  Returns ``{vertex: mass}``; unpushed probability
    stays in the residual, so ``sum(mass) <= 1`` with L1 error at most
    ``eps * Σdeg``.  Deterministic: FIFO queue, sorted neighbor lists.
    """
    p: dict[int, float] = {}
    r: dict[int, float] = {int(v): 1.0}
    queue = deque([int(v)])
    queued = {int(v)}
    degs: dict[int, int] = {}
    adj: dict[int, np.ndarray] = {}
    pushes = 0
    while queue and pushes < max_pushes:
        u = queue.popleft()
        queued.discard(u)
        if u not in adj:
            adj[u] = np.asarray(neighbors_fn(u), np.int64)
            degs[u] = int(adj[u].size)
        du = degs[u]
        ru = r.get(u, 0.0)
        if du == 0:                       # dangling: keep all mass local
            p[u] = p.get(u, 0.0) + ru
            r[u] = 0.0
            continue
        if ru < eps * du:
            continue
        pushes += 1
        p[u] = p.get(u, 0.0) + alpha * ru
        share = (1.0 - alpha) * ru / du
        r[u] = 0.0
        for w in adj[u]:
            w = int(w)
            r[w] = r.get(w, 0.0) + share
            if w not in queued:
                dw = degs.get(w)
                if dw is None or r[w] >= eps * dw:
                    queue.append(w)
                    queued.add(w)
    return p


# ---------------------------------------------------------------------------
# Prometheus exposition (served at /metrics by repro_torch.serve.server)
# ---------------------------------------------------------------------------

def render_serve_prometheus(stats: dict, group: int = 0) -> str:
    """Prometheus text-format exposition of one serving host's stats —
    the same text contract as ``repro_torch.obs.monitor.render_prometheus``,
    with ``repro_serve_*`` names."""
    g = f'{{group="{group}"}}'
    out = []

    def emit(name, help_, value, kind="gauge"):
        if value is None:
            return
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {kind}")
        out.append(f"{name}{g} {value}")

    emit("repro_serve_requests_total", "Queries served", stats["served"],
         "counter")
    emit("repro_serve_qps", "Sustained queries/s (latency window)",
         stats["qps"])
    emit("repro_serve_latency_p50_ms", "Median query latency",
         stats["p50_ms"])
    emit("repro_serve_latency_p99_ms", "p99 query latency",
         stats["p99_ms"])
    emit("repro_serve_cache_hit_ratio",
         "Hot-shard LRU hit ratio (decoded adjacency slices)",
         stats["cache"]["hit_ratio"])
    emit("repro_serve_cache_evictions_total", "LRU evictions",
         stats["cache"]["evictions"], "counter")
    emit("repro_serve_fanout_mean",
         "Mean partitions touched per vertex query (≤ replica count)",
         stats["fanout_mean"])
    emit("repro_serve_fanout_max", "Max partitions touched by one query",
         stats["fanout_max"])
    emit("repro_serve_owned_partitions", "Partitions this host serves",
         len(stats["store"]["partitions"]))
    return "\n".join(out) + "\n"


__all__ = ["FanoutViolation", "PartitionService", "k_hop", "ppr",
           "render_serve_prometheus"]
