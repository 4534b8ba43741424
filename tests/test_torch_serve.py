"""The port's serving layer (``repro_torch.serve``) against the reference.

First ``tests/test_serve.py``'s tests, each on the port over an artifact
the port saved: store roundtrip, batching, caching, replica-map routing,
gang bit-consistency and monitor integration.  Then the port held to
``repro.serve`` in the same process: one artifact served by both
packages' stores (the same shard bytes, ``verts``, ``indptr`` and
stats, equal answers, ``ppr`` dicts equal float for float), a real NE
partition made and saved by the port served by both, and each package's
``GangClient`` over a gang of the other package's servers (one wire
protocol).  The serving layer does no device work, so nothing here
needs a card.
"""
import json
import os
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

from repro_torch.runtime.artifact import load_artifact, save_artifact
from repro_torch.serve.batch import RequestBatcher
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.service import (FanoutViolation, PartitionService,
                                       k_hop, ppr, render_serve_prometheus)
from repro_torch.serve.store import ShardStore, vertex_features

N, P = 120, 4
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _random_partition(n, m, p_num, seed=0):
    """Random-assignment partition over a random edge list (the
    reference test's): save_artifact takes anything exposing
    PartitionResult's fields."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(m, 2), dtype=np.int64)
    edges = edges[edges[:, 0] != edges[:, 1]]
    edge_part = rng.integers(0, p_num, size=edges.shape[0]).astype(np.int32)
    vparts = np.zeros((n, p_num), bool)
    for p in range(p_num):
        e = edges[edge_part == p]
        vparts[e[:, 0], p] = True
        vparts[e[:, 1], p] = True
    res = types.SimpleNamespace(
        edge_part=edge_part, vparts=vparts,
        edges_per_part=np.bincount(edge_part, minlength=p_num),
        rounds=1, leftover=0)
    return edges, res


def _adjacency(edges):
    adj = {}
    for u, v in edges:
        adj.setdefault(int(u), set()).add(int(v))
        adj.setdefault(int(v), set()).add(int(u))
    return adj


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    td = tmp_path_factory.mktemp("serve_art")
    edges, res = _random_partition(N, 500, P)
    save_artifact(td / "art", res, edges, N)
    a = load_artifact(td / "art")
    a._edges_ref = edges          # keep the ground truth alongside
    a._dir = str(td / "art")
    return a


@pytest.fixture(scope="module")
def adj(art):
    return _adjacency(art._edges_ref)


# ---------------------------------------------------------------------------
# artifact helpers
# ---------------------------------------------------------------------------

def test_artifact_replica_views(art):
    counts = art.replica_counts()
    assert counts.shape == (N,)
    for v in (0, 5, N - 1):
        parts = art.partitions_of(v)
        assert counts[v] == parts.size
        assert np.array_equal(parts, np.flatnonzero(art.vparts[v]))
    boundary = art.boundary_vertices()
    assert np.array_equal(boundary, np.flatnonzero(counts > 1))


# ---------------------------------------------------------------------------
# store: roundtrip, shards, degree
# ---------------------------------------------------------------------------

def test_store_neighbors_exact(art, adj):
    store = ShardStore(art, rows_per_shard=8, cache_entries=16)
    for v in range(N):
        got = np.unique(np.concatenate(
            [store.neighbors(p, v) for p in range(P)]
            or [np.zeros(0, np.int64)]))
        want = np.asarray(sorted(adj.get(v, ())), np.int64)
        np.testing.assert_array_equal(got, want)


def test_store_from_path_and_group(art, adj):
    # loading by path, owning a partition subset: answers its share only
    store = ShardStore(art._dir, partitions=[0, 2], rows_per_shard=8)
    v = int(art.boundary_vertices()[0])
    for p in (0, 2):
        nbrs = store.neighbors(p, v)
        assert set(map(int, nbrs)) <= adj[v]
    with pytest.raises(KeyError):
        store.neighbors(1, v)     # not owned by this group


def test_store_degree_no_decode(art, adj):
    store = ShardStore(art, rows_per_shard=8, cache_entries=16)
    base = store.decodes
    for v in range(0, N, 7):
        deg = sum(store.degree(p, v) for p in range(P))
        assert deg >= len(adj.get(v, ()))   # replicas double-count cuts
    assert store.decodes == base            # degree reads indptr only


def test_store_rejects_torn_artifact(art, tmp_path):
    edges, res = _random_partition(N, 300, P, seed=3)
    save_artifact(tmp_path / "art", res, edges, N)
    # corrupt the manifest's edge count for partition 0
    mpath = tmp_path / "art" / "manifest.json"
    m = json.loads(mpath.read_text())
    m["edges_per_part"][0] += 1
    mpath.write_text(json.dumps(m))
    with pytest.raises((IOError, ValueError)):
        ShardStore(load_artifact(tmp_path / "art"))


def test_features_deterministic():
    vs = np.asarray([0, 3, 99])
    f1 = vertex_features(vs, dim=8, seed=0)
    f2 = vertex_features(vs, dim=8, seed=0)
    assert f1.dtype == np.float32 and f1.shape == (3, 8)
    np.testing.assert_array_equal(f1, f2)
    assert not np.array_equal(f1, vertex_features(vs, dim=8, seed=1))
    assert (f1 >= 0).all() and (f1 < 1).all()


# ---------------------------------------------------------------------------
# LRU cache
# ---------------------------------------------------------------------------

def test_lru_eviction_order():
    c = LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1          # refresh a → b is now LRU
    c.put("c", 3)                   # evicts b
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    assert c.evictions == 1 and len(c) == 2


def test_lru_disabled_and_stats():
    c = LRUCache(0)
    c.put("a", 1)
    assert c.get("a") is None and len(c) == 0
    st = c.stats()
    assert st["hits"] == 0 and st["misses"] == 1
    assert st["hit_ratio"] == 0.0


def test_cached_slice_matches_fresh_decode(art):
    hot = ShardStore(art, rows_per_shard=8, cache_entries=64)
    cold = ShardStore(art, rows_per_shard=8, cache_entries=0)
    v = int(art.boundary_vertices()[0])
    for _ in range(3):                      # repeats hit the LRU...
        for p in range(P):
            np.testing.assert_array_equal(hot.neighbors(p, v),
                                          cold.neighbors(p, v))
    assert hot.cache.hits > 0
    assert cold.decodes > hot.decodes       # ...cold re-decodes each time


# ---------------------------------------------------------------------------
# request batcher
# ---------------------------------------------------------------------------

def test_batcher_flushes_at_size():
    seen = []

    def execute(items):
        seen.append(list(items))
        return [i * 2 for i in items]

    b = RequestBatcher(execute, max_batch=4, max_delay_s=30.0)
    futs = [b.submit(i) for i in range(4)]
    # size trigger: resolves long before the 30s deadline
    assert [f.result(timeout=5) for f in futs] == [0, 2, 4, 6]
    assert seen and len(seen[0]) >= 1
    b.close()
    assert b.items == 4


def test_batcher_deadline_anchored_to_oldest():
    b = RequestBatcher(lambda xs: xs, max_batch=1000, max_delay_s=0.05)
    t0 = time.monotonic()
    fut = b.submit("lone")
    assert fut.result(timeout=5) == "lone"
    waited = time.monotonic() - t0
    # a lone request flushes on the deadline, not the batch size
    assert 0.03 <= waited < 2.0
    b.close()


def test_batcher_failure_isolates_batches():
    def execute(items):
        if "bad" in items:
            raise ValueError("poison")
        return items

    b = RequestBatcher(execute, max_batch=1, max_delay_s=0.01)
    with pytest.raises(ValueError, match="poison"):
        b("bad")
    assert b("good") == "good"      # later batches unaffected
    b.close()
    with pytest.raises(RuntimeError):
        b.submit("late")


def test_batcher_concurrent_callers_share_batches():
    b = RequestBatcher(lambda xs: [x + 1 for x in xs], max_batch=8,
                       max_delay_s=0.02)
    results = {}

    def worker(i):
        results[i] = b(i)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == {i: i + 1 for i in range(32)}
    b.close()
    assert b.batches >= 1 and b.items == 32


# ---------------------------------------------------------------------------
# service: routing, fan-out invariant, traversal
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def svc(art):
    store = ShardStore(art, rows_per_shard=8, cache_entries=32)
    s = PartitionService(store, batch=4, deadline_s=0.005)
    yield s
    s.close()


def test_service_neighbors_exact(svc, adj):
    for v in range(N):
        want = np.asarray(sorted(adj.get(v, ())), np.int64)
        np.testing.assert_array_equal(svc.neighbors(v), want)
        np.testing.assert_array_equal(svc.neighbors_batched(v), want)


def test_fanout_equals_replica_set(svc, art):
    """A boundary vertex fans out to exactly its replica set."""
    reps = art.replica_counts()
    for v in map(int, art.boundary_vertices()[:20]):
        before = len(svc._fanout)
        svc.neighbors(v)
        fanout = svc._fanout[-1]
        assert len(svc._fanout) == before + 1
        assert fanout == reps[v] == art.partitions_of(v).size
    # interior vertex: exactly one partition touched
    interior = np.flatnonzero(reps == 1)
    if interior.size:
        svc.neighbors(int(interior[0]))
        assert svc._fanout[-1] == 1


def test_fanout_violation_guard():
    """The client-side invariant check trips when a (hypothetically
    torn) replica map claims fewer replicas than were contacted."""
    from repro_torch.serve.gang import GangClient

    cli = GangClient(artifact=None, ports=[0, 0])
    cli._record(time.monotonic(), fanout=1, replicas=1)   # at the bound
    with pytest.raises(FanoutViolation):
        cli._record(time.monotonic(), fanout=2, replicas=1)


def test_khop_and_ppr_match_reference(svc, adj):
    # k_hop against a BFS over the ground-truth adjacency
    v = next(u for u in sorted(adj) if adj[u])
    want = {v}
    frontier = {v}
    for _ in range(2):
        frontier = {w for u in frontier for w in adj.get(u, ())} - want
        want |= frontier
    np.testing.assert_array_equal(svc.k_hop(v, 2),
                                  np.asarray(sorted(want), np.int64))
    # ppr: probability mass conserved and localized at the seed
    mass = svc.ppr(v, alpha=0.15, eps=1e-6)
    total = sum(mass.values())
    assert 0.9 < total <= 1.0 + 1e-9
    assert max(mass, key=mass.get) == v


def test_ppr_provider_agnostic(svc, adj):
    """The same push over the service and over the raw adjacency gives
    identical masses — the provider abstraction the gang client rides."""
    def raw_neighbors(u):
        return np.asarray(sorted(adj.get(int(u), ())), np.int64)

    v = int(next(iter(adj)))
    assert ppr(svc.neighbors, v, eps=1e-5) == ppr(raw_neighbors, v,
                                                  eps=1e-5)
    np.testing.assert_array_equal(k_hop(svc.neighbors, v, 2),
                                  k_hop(raw_neighbors, v, 2))


def test_service_stats_and_prometheus(svc):
    svc.feature(3)
    st = svc.stats()
    assert st["served"] > 0 and st["p99_ms"] is not None
    assert 0.0 <= st["cache"]["hit_ratio"] <= 1.0
    assert st["fanout_hist"]
    text = render_serve_prometheus(st, group=1)
    assert 'repro_serve_qps{group="1"}' in text
    assert "repro_serve_cache_hit_ratio" in text
    assert "repro_serve_fanout_mean" in text


# ---------------------------------------------------------------------------
# gang: multi-process bit-consistency + monitor integration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gang_env():
    return {"PYTHONPATH": SRC + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def test_gang_matches_single_process(art, adj, gang_env, tmp_path):
    from repro_torch.obs.monitor import BusMonitor, render_prometheus
    from repro_torch.serve.gang import GangClient, launch_serving_gang

    bus_dir = tmp_path / "live"
    env = dict(gang_env, REPRO_LIVE_METRICS=str(bus_dir))
    gang = launch_serving_gang(art._dir, 2, cache=32, batch=0,
                               extra_env=env, timeout_s=60)
    try:
        cli = GangClient(art, gang.ports)
        local = PartitionService(
            ShardStore(art, rows_per_shard=8, cache_entries=32), batch=0)
        # bit-consistency: merged gang answers == single-process answers
        for v in range(0, N, 5):
            np.testing.assert_array_equal(cli.neighbors(v),
                                          local.neighbors(v))
        np.testing.assert_array_equal(cli.feature(7), local.feature(7))
        v = int(art.boundary_vertices()[0])
        assert cli.ppr(v, eps=1e-5) == local.ppr(v, eps=1e-5)
        np.testing.assert_array_equal(cli.k_hop(v, 2), local.k_hop(v, 2))
        # routing: every member holds its round-robin group, and the
        # client contacted only members with a replica
        for g, h in enumerate(cli.health()):
            assert h["partitions"] == [p for p in range(P) if p % 2 == g]
        assert max(cli.fanout_hist) <= 2
        # /metrics endpoint speaks Prometheus text
        txt = urllib.request.urlopen(
            f"http://127.0.0.1:{gang.ports[0]}/metrics").read().decode()
        assert "repro_serve_requests_total" in txt
        local.close()
        # live-bus heartbeats reach the monitor with serve gauges
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            mon = BusMonitor(bus_dir)
            mon.poll()
            rows = mon.assess()["hosts"]
            if len(rows) == 2 and all(r["qps"] is not None
                                      for r in rows.values()):
                break
            time.sleep(0.25)
        else:
            pytest.fail("serve heartbeats never reached the bus")
        assert all(r["phase"] == "serve" for r in rows.values())
        prom = render_prometheus(mon.assess())
        assert "repro_serve_qps" in prom
        assert "repro_serve_cache_hit_ratio" in prom
    finally:
        gang.close()
    assert all(p.poll() is not None for p in gang.procs)


def test_gang_member_death_detected(art, gang_env):
    from repro_torch.serve.gang import launch_serving_gang

    gang = launch_serving_gang(art._dir, 2, extra_env=gang_env,
                               timeout_s=60)
    try:
        gang.procs[1].terminate()
        gang.procs[1].wait(timeout=10)
        assert gang.poll_dead() == [1]   # first death = gang failure
    finally:
        gang.close()


def test_group_partitions_cover_exactly():
    from repro_torch.serve.server import group_partitions

    for p_num, w in ((8, 2), (7, 3), (4, 4), (3, 5)):
        groups = [group_partitions(p_num, g, w) for g in range(w)]
        flat = sorted(p for grp in groups for p in grp)
        assert flat == list(range(p_num))   # exactly once each
    with pytest.raises(ValueError):
        group_partitions(8, 2, 2)


# ---------------------------------------------------------------------------
# the port against the reference, in one process
# ---------------------------------------------------------------------------

def _same_stores(mine, ref):
    """The port's store and the reference's hold the same shards."""
    assert mine.partitions == ref.partitions
    for p in ref.partitions:
        a, b = mine._parts[p], ref._parts[p]
        assert a.shards == b.shards, f"partition {p}: shard bytes differ"
        np.testing.assert_array_equal(a.verts, b.verts)
        np.testing.assert_array_equal(a.indptr, b.indptr)
        assert a.nbytes == b.nbytes and a.num_shards == b.num_shards
    assert mine.stats() == ref.stats()


def _same_answers(mine, ref, n, hops=(), pushes=()):
    """Every vertex's answers equal through both packages' services."""
    from repro.serve.service import PartitionService as RService
    from repro.serve.service import render_serve_prometheus as r_render

    a, b = PartitionService(mine, batch=0), RService(ref, batch=0)
    for v in range(n):
        for p in ref.partitions:
            np.testing.assert_array_equal(mine.neighbors(p, v),
                                          ref.neighbors(p, v))
            assert mine.degree(p, v) == ref.degree(p, v)
        np.testing.assert_array_equal(a.neighbors(v), b.neighbors(v))
        assert a.degree(v) == b.degree(v)
        assert mine.owned_partitions_of(v) == ref.owned_partitions_of(v)
    np.testing.assert_array_equal(mine.features(np.arange(n)),
                                  ref.features(np.arange(n)))
    for v in hops:
        np.testing.assert_array_equal(a.k_hop(v, 2), b.k_hop(v, 2))
    for v in pushes:
        assert a.ppr(v, eps=1e-5) == b.ppr(v, eps=1e-5)
    assert mine.decodes == ref.decodes
    assert mine.cache.stats() == ref.cache.stats()
    st = b.stats()
    assert (render_serve_prometheus(st, group=3)
            == r_render(st, group=3))
    assert a.fanout_hist == b.fanout_hist


@pytest.mark.parametrize("rows,cache", [(1, 0), (8, 16), (256, 64)])
def test_one_artifact_two_stores(tmp_path, rows, cache):
    """An artifact the reference wrote, loaded by both packages: the
    port's row shards are the reference's bytes, at any shard size, and
    every answer is equal (``ppr`` float for float)."""
    from repro.runtime.artifact import load_artifact as r_load
    from repro.runtime.artifact import save_artifact as r_save
    from repro.serve.store import ShardStore as RStore

    edges, res = _random_partition(N, 500, P, seed=1)
    r_save(tmp_path / "art", res, edges, N)
    mine = ShardStore(str(tmp_path / "art"), rows_per_shard=rows,
                      cache_entries=cache)
    ref = RStore(r_load(tmp_path / "art"), rows_per_shard=rows,
                 cache_entries=cache)
    _same_stores(mine, ref)
    boundary = ref.artifact.boundary_vertices()
    _same_answers(mine, ref, N, hops=boundary[:3].tolist(),
                  pushes=boundary[:3].tolist())


def test_store_group_and_empty_partition(tmp_path):
    """A partition group, and a partition that holds no edge: the same
    shards, counts and stats as the reference's."""
    from repro.runtime.artifact import load_artifact as r_load
    from repro.serve.store import ShardStore as RStore

    edges, res = _random_partition(N, 400, P, seed=2)
    res.edge_part[res.edge_part == 1] = 0          # partition 1 empty
    res.vparts[:, 0] |= res.vparts[:, 1]
    res.vparts[:, 1] = False
    res.edges_per_part = np.bincount(res.edge_part, minlength=P)
    save_artifact(tmp_path / "art", res, edges, N)
    for group in ([1], [0, 1, 3], None):
        mine = ShardStore(load_artifact(tmp_path / "art"),
                          partitions=group, rows_per_shard=5)
        ref = RStore(r_load(tmp_path / "art"), partitions=group,
                     rows_per_shard=5)
        _same_stores(mine, ref)
        _same_answers(mine, ref, N)
    assert mine._parts[1].num_shards == 0 == mine._parts[1].nbytes


def test_real_partition_served_by_both(tmp_path):
    """An NE partition the port made on the CPU (RMAT (10, 8, seed 3),
    P 8) and saved: both packages serve it with equal answers."""
    from repro.runtime.artifact import load_artifact as r_load
    from repro.serve.store import ShardStore as RStore
    from repro_torch.core import partitioner as tp
    from repro_torch.graphs.rmat import rmat

    g = rmat(10, 8, seed=3, device="cpu")
    res = tp.partition(g, tp.NEConfig(num_partitions=8))
    save_artifact(tmp_path / "art", res, g.edges.numpy(), g.num_vertices)
    art = load_artifact(tmp_path / "art")
    assert art.replica_counts().mean() == art.replication_factor
    mine = ShardStore(art, rows_per_shard=64, cache_entries=256)
    ref = RStore(r_load(tmp_path / "art"), rows_per_shard=64,
                 cache_entries=256)
    _same_stores(mine, ref)
    boundary = art.boundary_vertices()
    _same_answers(mine, ref, g.num_vertices,
                  hops=boundary[:2].tolist(), pushes=boundary[:4].tolist())
    # the full store: a query fans out to exactly the replica set, and
    # the union over replicas is the canonical graph's adjacency
    svc = PartitionService(mine, batch=0)
    e = g.edges.numpy()
    reps = art.replica_counts()
    for v in boundary[:64].tolist():
        want = np.unique(np.concatenate([e[e[:, 0] == v, 1],
                                         e[e[:, 1] == v, 0]]))
        np.testing.assert_array_equal(svc.neighbors(v), want)
        assert svc._fanout[-1] == reps[v] and svc.degree(v) == want.size


@pytest.mark.parametrize("server,client", [("repro_torch", "repro"),
                                           ("repro", "repro_torch")])
def test_gang_across_packages(art, gang_env, server, client):
    """One wire protocol: each package's ``GangClient`` over a 2-member
    gang of the other package's servers answers as the port's
    single-process ``PartitionService``."""
    import importlib

    launch = importlib.import_module(f"{server}.serve.gang")
    cli_mod = importlib.import_module(f"{client}.serve.gang")
    gang = launch.launch_serving_gang(art._dir, 2, cache=16, batch=0,
                                      extra_env=gang_env, timeout_s=60)
    try:
        cli = cli_mod.GangClient(art, gang.ports)
        local = PartitionService(ShardStore(art, cache_entries=16),
                                 batch=0)
        for v in range(N):
            np.testing.assert_array_equal(cli.neighbors(v),
                                          local.neighbors(v))
            assert cli.degree(v) == local.degree(v)
        np.testing.assert_array_equal(cli.feature(11), local.feature(11))
        v = int(art.boundary_vertices()[1])
        assert cli.ppr(v, eps=1e-5) == local.ppr(v, eps=1e-5)
        np.testing.assert_array_equal(cli.k_hop(v, 2), local.k_hop(v, 2))
        assert [h["partitions"] for h in cli.health()] == [[0, 2], [1, 3]]
        assert max(cli.fanout_hist) <= 2
    finally:
        gang.close()
    assert all(p.poll() is not None for p in gang.procs)
