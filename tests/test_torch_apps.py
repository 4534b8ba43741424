"""The port's GAS applications, edge redistribution and communication model
against the reference.

``comm_volume_model`` must equal the reference's and 2·comm_slots·F·bytes
of the ShardedGraph built from the same partition; ``barabasi_albert``
must give the reference's (networkx's) edges bit for bit.  PageRank, SSSP
and WCC run over the vertex-cut engine: at one rank (in this process, a
gloo group) against the reference's run on a 1-device mesh, and at 1, 2
and 4 ranks (spawned gloo processes, rank bodies in ``torch_spmd_ranks``)
against networkx, as ``tests/spmd/run_spmd_checks.py`` holds the
reference.  ``redistribute_edges``: the host path against the reference
bit for bit (``dropped`` included), and each rank's row of the rank form
at 2 and 4 ranks against the host path.

Tolerances: SSSP and WCC take minima of integer-valued float32s, so they
are exact, and so is the count of supersteps.  PageRank sums float32
terms in another order than the reference (and across ranks), so it is
held to 1e-5 of its largest value against the reference; against
networkx's converged float64 PageRank, 40 supersteps are within 1e-6
(the reference's own check).
"""
import networkx as nx
import numpy as np
import pytest
import torch

import torch_spmd_ranks
from repro.apps import algorithms as jalg
from repro.apps import engine as jeng
from repro.core.metrics import comm_volume_model as j_comm_volume_model
from repro.core.metrics import evaluate as j_evaluate
from repro.dist.redistribute import redistribute_edges as j_redistribute
from repro.graphs import generators as jgen
from repro_torch.apps import algorithms as alg
from repro_torch.apps import engine as eng
from repro_torch.core import partitioner as tp
from repro_torch.core.graph import from_edges, shard_edges
from repro_torch.core.metrics import comm_volume_model, evaluate
from repro_torch.dist import compat
from repro_torch.dist.redistribute import redistribute_edges
from repro_torch.graphs import generators

N, ATTACH, SEED = 300, 3, 5
ISOLATED = 7          # vertices with no edge, after the BA graph's
SOURCE = 0
PR_ITERS = 40         # run_spmd_checks.py's PageRank against networkx
WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def graph():
    """BA(300, 3, seed 5) and 7 isolated vertices."""
    edges = np.asarray(jgen.barabasi_albert(N, ATTACH, seed=SEED).edges)
    return edges, N + ISOLATED


def _edge_part(edges, n, d):
    return tp.partition(from_edges(edges, n, device="cpu"),
                        tp.NEConfig(num_partitions=d, seed=0)).edge_part


def _networkx(edges, n):
    """networkx's PageRank, hop distances from SOURCE and component
    labels (the smallest id), with the engine's fills where a vertex has
    no edge: (1 - d)/n, inf and -1."""
    gx = nx.Graph()
    gx.add_nodes_from(range(n))
    gx.add_edges_from(edges.tolist())
    has_edge = np.zeros(n, bool)
    has_edge[edges.ravel()] = True
    pr_nx = nx.pagerank(gx.subgraph(np.nonzero(has_edge)[0].tolist()),
                        alpha=0.85, max_iter=200, tol=1e-10)
    # the engine's 1/n start and (1 - d)/n teleport are over all n
    # vertices, isolated ones too: scale networkx's to that n
    m = int(has_edge.sum())
    pr = np.full(n, 0.15 / n)
    for k, v in pr_nx.items():
        pr[k] = v * m / n
    dist = np.full(n, np.inf)
    for k, v in nx.single_source_shortest_path_length(gx, SOURCE).items():
        dist[k] = v
    labels = np.full(n, -1.0)
    for comp in nx.connected_components(gx):
        if len(comp) > 1:
            labels[list(comp)] = min(comp)
    return pr, dist, labels


def _assert_pagerank(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------------------
# the communication model and the generator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d,feat,nbytes", [(1, 1, 4), (4, 16, 4),
                                           (8, 128, 2)])
def test_comm_volume_model(graph, d, feat, nbytes):
    edges, n = graph
    ep = _edge_part(edges, n, d)
    st = evaluate(edges, ep, n, d)
    want = j_comm_volume_model(j_evaluate(edges, ep, n, d), n, feat, nbytes)
    got = comm_volume_model(st, n, feat, nbytes)
    assert got == want
    sg = eng.build_sharded_graph(edges, ep, n, d)
    assert got == 2 * sg.comm_slots * feat * nbytes


@pytest.mark.parametrize("n,m,seed", [(300, 3, 5), (200, 3, 3),
                                      (3000, 5, 11)])
def test_barabasi_albert_matches_reference(n, m, seed):
    want = jgen.barabasi_albert(n, m, seed)
    got = generators.barabasi_albert(n, m, seed, device="cpu")
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    assert got.num_vertices == want.num_vertices == n


def test_table5_cell_matches_reference():
    """Paper Table 5's cell (``benchmarks/bench_apps.py:32-44``):
    BA(8000, 5, seed 11) at P = 8, NE's, ``random_1d``'s and
    ``grid_2d``'s partitions equal to the reference's, and each one's
    PageRank wire bytes over 30 supersteps equal to the reference's model
    and to 2 · comm_slots · 4 · 30 of the 8-part ShardedGraph."""
    from repro.core import NEConfig as JNEConfig
    from repro.core import partition as j_partition
    from repro.core import baselines as jbase
    from repro_torch.core import baselines

    jg = jgen.barabasi_albert(8000, 5, seed=11)
    g = generators.barabasi_albert(8000, 5, 11, device="cpu")
    e, n, p = g.edges.numpy(), g.num_vertices, 8
    want = {"dne": np.asarray(j_partition(jg, JNEConfig(
                num_partitions=p, seed=0, edge_chunk=1 << 14)).edge_part),
            "random": np.asarray(jbase.random_1d(jg, p)),
            "grid": np.asarray(jbase.grid_2d(jg, p))}
    # one thread: under pytest-xdist several workers share the host's
    # cores, and the round's small parallel ops slow down ~100x when
    # every worker's OpenMP threads contend for them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ne = tp.partition(g, tp.NEConfig(num_partitions=p, seed=0,
                                         edge_chunk=1 << 14)).edge_part
    finally:
        torch.set_num_threads(threads)
    got = {"dne": ne, "random": baselines.random_1d(g, p),
           "grid": baselines.grid_2d(g, p)}
    for name, ep in got.items():
        np.testing.assert_array_equal(ep, want[name], err_msg=name)
        com = comm_volume_model(evaluate(e, ep, n, p), n, 1) * 30
        assert com == j_comm_volume_model(j_evaluate(e, want[name], n, p),
                                          n, 1) * 30
        sg = eng.build_sharded_graph(e, ep, n, p)
        assert com == 2 * sg.comm_slots * 4 * 30


@pytest.mark.parametrize("m", [0, 5])
def test_barabasi_albert_refuses_bad_m(m):
    with pytest.raises(ValueError):
        generators.barabasi_albert(5, m, device="cpu")


# --------------------------------------------------------------------------
# the apps at one rank against the reference's 1-device run
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world1_runs(graph):
    edges, n = graph
    ep = np.zeros(len(edges), np.int32)
    jsg = jeng.build_sharded_graph(edges, ep, n, 1)
    want = {"pagerank": jalg.pagerank(jsg, iters=30),
            "sssp": jalg.sssp(jsg, SOURCE), "wcc": jalg.wcc(jsg)}
    sg = eng.build_sharded_graph(edges, ep, n, 1)
    with compat.world1("gloo"):
        got = {"pagerank": alg.pagerank(sg, 30, device="cpu"),
               "sssp": alg.sssp(sg, SOURCE, device="cpu"),
               "wcc": alg.wcc(sg, device="cpu")}
    return got, want


def test_pagerank_world1_matches_reference(world1_runs):
    got, want = world1_runs
    assert got["pagerank"].dtype == want["pagerank"].dtype == np.float64
    _assert_pagerank(got["pagerank"], want["pagerank"])
    assert (got["pagerank"][N:] == (1.0 - 0.85) / (N + ISOLATED)).all()


@pytest.mark.parametrize("app", ["sssp", "wcc"])
def test_label_propagation_world1_matches_reference(world1_runs, app):
    got, want = world1_runs
    (vals, iters), (want_vals, want_iters) = got[app], want[app]
    np.testing.assert_array_equal(vals, want_vals)
    assert iters == want_iters > 1


def test_apps_need_a_group_of_the_graphs_world(graph):
    edges, n = graph
    sg = eng.build_sharded_graph(edges, np.zeros(len(edges), np.int32), n, 2)
    with compat.world1("gloo"), pytest.raises(ValueError):
        alg.pagerank(sg, 1, device="cpu")


def test_label_propagation_stops_at_max_iters(graph):
    edges, n = graph
    ep = np.zeros(len(edges), np.int32)
    jsg = jeng.build_sharded_graph(edges, ep, n, 1)
    sg = eng.build_sharded_graph(edges, ep, n, 1)
    with compat.world1("gloo"):
        got = alg.sssp(sg, SOURCE, max_iters=2, device="cpu")
    want = jalg.sssp(jsg, SOURCE, max_iters=2)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 2


def test_apps_reuse_unpacked_arrays(graph, world1_runs):
    """Arrays from ``unpack`` passed to the apps, twice each, give the same
    bits as the calls that copy them; zero supersteps give the start."""
    edges, n = graph
    sg = eng.build_sharded_graph(edges, np.zeros(len(edges), np.int32), n, 1)
    got, _ = world1_runs
    with compat.world1("gloo"):
        a = alg.unpack(sg, "cpu")
        for _ in range(2):
            np.testing.assert_array_equal(
                alg.pagerank(sg, 30, device="cpu", arrays=a), got["pagerank"])
            for app, run in (("sssp", lambda k: alg.sssp(
                    sg, SOURCE, k, device="cpu", arrays=a)),
                             ("wcc", lambda k: alg.wcc(
                                 sg, k, device="cpu", arrays=a))):
                vals, iters = run(200)
                np.testing.assert_array_equal(vals, got[app][0])
                assert iters == got[app][1]
                assert run(0)[1] == 0
        start = alg.pagerank(sg, 0, device="cpu", arrays=a)
    assert (start[:N] == np.float32(1.0 / (N + ISOLATED))).all()


# --------------------------------------------------------------------------
# 1, 2 and 4 ranks against networkx; redistribute's rank form
# --------------------------------------------------------------------------

def _redistribute_inputs(edges, n, d):
    """The reference's hand-off (run_spmd_checks.py): the 2D-hash shards
    of the edges, each row's target its edge's NE partition at P = d."""
    ep = _edge_part(edges, n, d)
    shards, masks, _, dev_of = shard_edges(edges, d, salt=0)
    parts = np.zeros(masks.shape, np.int32)
    for dd in range(d):
        sel = np.nonzero(dev_of == dd)[0]
        parts[dd, : sel.size] = ep[sel]
    return ep, shards, masks, parts


@pytest.fixture(scope="module", params=WORLDS)
def rank_runs(request, graph):
    d = request.param
    edges, n = graph
    ep, shards, masks, parts = _redistribute_inputs(edges, n, d)
    args = (edges, n, ep, SOURCE, PR_ITERS, shards, masks, parts)
    if d == 1:
        with compat.world1("gloo"):
            outs = [torch_spmd_ranks.apps_checks(*args)]
    else:
        outs = compat.spawn(torch_spmd_ranks.apps_checks, d, "gloo", *args)
    return d, ep, (shards, masks, parts), outs


def test_apps_across_ranks_match_networkx(graph, rank_runs):
    edges, n = graph
    d, _, _, outs = rank_runs
    assert len(outs) == d
    pr, dist, labels = _networkx(edges, n)
    for out in outs:                # every rank holds the whole result
        assert np.abs(out["pagerank"] - pr).max() < 1e-6
        np.testing.assert_array_equal(out["sssp"][0], dist)
        np.testing.assert_array_equal(out["wcc"][0], labels)
        for app in ("sssp", "wcc"):
            assert out[app][1] == outs[0][app][1]


def test_redistribute_across_ranks_matches_host_path(graph, rank_runs):
    edges, _ = graph
    d, ep, inputs, outs = rank_runs
    want_e, want_m, want_dropped = redistribute_edges(*inputs)
    assert want_dropped == 0
    for rank, out in enumerate(outs):
        got_e, got_m, dropped = out["redistribute"]
        assert got_e.dtype == np.int32 and got_m.dtype == bool
        np.testing.assert_array_equal(got_e, want_e[rank])
        np.testing.assert_array_equal(got_m, want_m[rank])
        assert dropped == 0
        # partition `rank`'s edges arrived, each once
        key = np.sort(got_e[got_m].astype(np.int64) @ [1 << 32, 1])
        want = np.sort(edges[ep == rank].astype(np.int64) @ [1 << 32, 1])
        np.testing.assert_array_equal(key, want)


@pytest.mark.parametrize("d,c,seed", [(1, 40, 0), (3, 50, 1), (4, 64, 2),
                                      (8, 9, 3)])
def test_redistribute_host_path_matches_reference(d, c, seed):
    """Random rows with masked rows and targets outside [0, D): the
    reference's result bit for bit, ``dropped`` included."""
    rng = np.random.default_rng(seed)
    shards = rng.integers(0, 1000, (d, c, 2)).astype(np.int32)
    masks = rng.random((d, c)) < 0.8
    parts = rng.integers(-1, d + 1, (d, c)).astype(np.int32)
    want = j_redistribute(shards, masks, parts)
    got = redistribute_edges(shards, masks, parts)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2] > 0


def test_redistribute_rank_form_drops_as_the_host_path():
    """One rank, rows masked and targets outside [0, 1): the rank form's
    row 0 and ``dropped`` equal the host path's."""
    rng = np.random.default_rng(7)
    shards = rng.integers(0, 1000, (1, 33, 2)).astype(np.int32)
    masks = rng.random((1, 33)) < 0.7
    parts = rng.integers(-1, 2, (1, 33)).astype(np.int32)
    want = redistribute_edges(shards, masks, parts)
    with compat.world1("gloo"):
        got = redistribute_edges(shards[0], masks[0], parts[0],
                                 torch.distributed.group.WORLD,
                                 device="cpu")
    np.testing.assert_array_equal(got[0], want[0][0])
    np.testing.assert_array_equal(got[1], want[1][0])
    assert got[2] == want[2] > 0

