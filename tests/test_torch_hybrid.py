"""The port's hybrid (HEP-style) partitioner (``repro_torch.core.hybrid``)
and the driver's hybrid mode against the reference package's
``repro.core.hybrid``.

Mirrors tests/test_hybrid.py: the degree split, the τ = 1.0 degeneracy to
pure NE, Graph ↔ EdgeFile bit-identity, driver run / kill / resume and the
quality sandwich; every case computes the reference in this process and
asserts the port's result equal to it (``edge_part``, ``vparts``,
``edges_per_part``, ``rounds``, ``leftover``).  Where snapshot or
artifact bytes are compared, the reference's config has
``use_pallas=True`` (the fingerprint rule of ``runtime.snapshot``).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import NEConfig as JNEConfig
from repro.core import partition as j_partition
from repro.core.baselines import grid_2d as j_grid_2d
from repro.core.hybrid import HybridConfig as JHybridConfig
from repro.core.hybrid import degree_threshold as j_degree_threshold
from repro.core.hybrid import hybrid_split as j_hybrid_split
from repro.core.hybrid import partition_hybrid as j_partition_hybrid
from repro.graphs.rmat import rmat as j_rmat
from repro.io.edgefile import EdgeFile as JEdgeFile
from repro.runtime import PartitionDriver as JDriver
from repro_torch.core.baselines import grid_2d
from repro_torch.core.graph import from_edges
from repro_torch.core.hybrid import (HybridConfig, degree_threshold,
                                     hybrid_init_state, hybrid_split,
                                     partition_hybrid)
from repro_torch.core.metrics import evaluate
from repro_torch.core.partitioner import NEConfig, ne_init_state, partition
from repro_torch.graphs.rmat import rmat
from repro_torch.io.stream import canonicalize_stream
from repro_torch.runtime import (PartitionDriver, SnapshotMismatch,
                                 load_artifact)

P = 8
CFG = HybridConfig(num_partitions=P, budget_frac=0.25, seed=0)
JCFG = JHybridConfig(num_partitions=P, budget_frac=0.25, seed=0,
                     use_pallas=True)
TAUS = (1.0, 0.5, 0.25)
KEEP_ALL = 1 << 20


def _same(got, want):
    for f in ("edge_part", "vparts", "edges_per_part"):
        np.testing.assert_array_equal(got[f] if isinstance(got, dict)
                                      else getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.rounds, got.leftover) == (want.rounds, want.leftover)
    if getattr(got, "stats", None) is not None:
        assert dataclasses.astuple(got.stats) == \
            dataclasses.astuple(want.stats)


def _same_files(a, b):
    """Two directory trees with the same files, byte for byte."""
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.fixture(scope="module")
def jg():
    return j_rmat(11, 8, seed=2)


@pytest.fixture(scope="module")
def g():
    return rmat(11, 8, seed=2, device="cpu")


@pytest.fixture(scope="module")
def ef(g, tmp_path_factory):
    td = tmp_path_factory.mktemp("hybrid_ef")
    return canonicalize_stream(g.edges.numpy(), os.path.join(td, "g.edges"),
                               num_vertices=g.num_vertices, tmpdir=str(td))


@pytest.fixture(scope="module")
def j_runs(jg):
    """The reference's partition_hybrid at each τ."""
    return {tau: j_partition_hybrid(jg, JHybridConfig(
        num_partitions=P, budget_frac=tau, seed=0)) for tau in TAUS}


# -- degree threshold -------------------------------------------------------

def test_threshold_equals_reference(g):
    deg = g.degree.numpy()
    taus = (1e-9, 0.1, 0.25, 0.5, 1.0)
    ths = [degree_threshold(deg, t) for t in taus]
    assert ths == [j_degree_threshold(deg, t) for t in taus]
    assert ths == sorted(ths) and ths[0] >= 1
    assert ths[-1] == int(deg.max())
    for tau, theta in zip(taus[1:4], ths[1:4]):   # Σ_{deg≤θ} deg ≤ τ·2M
        assert deg[deg <= theta].sum() <= tau * 2 * g.num_edges + 1e-9
    assert degree_threshold(np.zeros(4, np.int32), 0.5) == 1


# -- the split --------------------------------------------------------------

@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("store", [False, True], ids=["graph", "edgefile"])
def test_split_equals_reference(g, jg, ef, store, tau):
    cfg = HybridConfig(num_partitions=P, budget_frac=tau, seed=0)
    got = hybrid_split(ef if store else g, cfg, device="cpu")
    want = j_hybrid_split(jg, JHybridConfig(num_partitions=P,
                                            budget_frac=tau, seed=0))
    assert (got.threshold, got.num_vertices, got.num_edges) == \
        (want.threshold, want.num_vertices, want.num_edges)
    for f in ("low_eids", "edge_part0", "tail_counts", "tail_vparts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in ("edges", "indptr", "adj_dst", "adj_eid", "slot_src",
              "degree"):
        np.testing.assert_array_equal(getattr(got.low, f).numpy(),
                                      np.asarray(getattr(want.low, f)),
                                      err_msg=f)


def test_split_tail_is_grid_2d(g):
    split = hybrid_split(g, CFG)
    tail = split.edge_part0 >= 0
    assert 0 < tail.sum() < g.num_edges
    np.testing.assert_array_equal(split.edge_part0[tail],
                                  grid_2d(g, P, seed=CFG.grid_salt)[tail])
    np.testing.assert_array_equal(
        split.tail_counts, np.bincount(split.edge_part0[tail], minlength=P))


def test_init_state_seeds_the_tail(g):
    """The seeded state is ``ne_init_state`` of the low subgraph with the
    tail's replicas and counts, copied (the rounds update in place)."""
    split = hybrid_split(g, CFG)
    necfg = CFG.clamped(g.num_vertices).ne_config()
    st = hybrid_init_state(split, necfg)
    base = ne_init_state(split.low, necfg)
    np.testing.assert_array_equal(st.vparts.numpy(), split.tail_vparts)
    np.testing.assert_array_equal(st.edges_per_part.numpy(),
                                  split.tail_counts)
    np.testing.assert_array_equal(st.degree_rest.numpy(),
                                  base.degree_rest.numpy())
    st.vparts.fill_(True)
    assert not split.tail_vparts.all()


# -- end-to-end -------------------------------------------------------------

@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("store", [False, True], ids=["graph", "edgefile"])
def test_partition_hybrid_equals_reference(g, ef, j_runs, store, tau):
    cfg = HybridConfig(num_partitions=P, budget_frac=tau, seed=0)
    _same(partition_hybrid(ef if store else g, cfg, device="cpu"),
          j_runs[tau])


def test_full_budget_is_pure_ne(g, jg):
    """τ = 1.0: the whole graph is the low subgraph and the hybrid equals
    the port's ``partition`` (and the reference's)."""
    ne = partition(g, NEConfig(num_partitions=P, seed=0))
    hy = partition_hybrid(g, HybridConfig(num_partitions=P,
                                          budget_frac=1.0, seed=0))
    _same(hy, ne)
    _same(ne, j_partition(jg, JNEConfig(num_partitions=P, seed=0)))


def test_empty_low_subgraph_equals_reference():
    """Every endpoint above θ = 1 (a complete graph): the tail takes every
    edge, the expansion runs no round."""
    e = np.array([(i, j) for i in range(6) for j in range(i + 1, 6)])
    from repro.core import from_edges as j_from_edges

    cfg = HybridConfig(num_partitions=4, budget_frac=1e-6)
    got = partition_hybrid(from_edges(e, device="cpu"), cfg)
    want = j_partition_hybrid(j_from_edges(e),
                              JHybridConfig(num_partitions=4,
                                            budget_frac=1e-6))
    assert got.rounds == 0 and (got.edge_part >= 0).all()
    _same(got, want)


def test_rf_between_ne_and_grid(g, j_runs):
    e = g.edges.numpy()

    def rf(ep):
        return evaluate(e, ep, g.num_vertices, P).replication_factor

    rf_hy = rf(j_runs[0.25].edge_part)
    assert rf(partition(g, NEConfig(num_partitions=P)).edge_part) <= rf_hy
    assert rf_hy <= rf(grid_2d(g, P, seed=CFG.grid_salt))


def test_result_invariants_and_stats(g, j_runs):
    res = j_runs[0.25]
    ep = np.asarray(res.edge_part)
    assert ((ep >= 0) & (ep < P)).all()
    np.testing.assert_array_equal(np.asarray(res.edges_per_part),
                                  np.bincount(ep, minlength=P))
    st = evaluate(g.edges.numpy(), ep, g.num_vertices, P)
    assert st.replication_factor == res.stats.replication_factor
    assert st.edge_balance == res.stats.edge_balance


def test_entry_points_default_to_the_card(ef, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition_hybrid(ef, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PartitionDriver(ef, CFG, mode="hybrid")
    with pytest.raises(TypeError, match="Graph or a canonical EdgeFile"):
        hybrid_split(np.zeros((3, 2), np.int32), CFG)


# -- driver: run / kill / resume -------------------------------------------

@pytest.fixture(scope="module")
def j_driver(jg, tmp_path_factory):
    """The reference's hybrid driver, a snapshot every round, and its
    artifact."""
    td = tmp_path_factory.mktemp("j_driver")
    drv = JDriver(jg, JCFG, mode="hybrid", snapshot_dir=td / "snap",
                  snapshot_every=1, keep=KEEP_ALL)
    res = drv.run()
    drv.save_artifact(td / "art")
    return res, td


@pytest.mark.parametrize("store", [False, True], ids=["graph", "edgefile"])
def test_driver_writes_the_reference_bytes(g, ef, j_driver, tmp_path,
                                           store):
    """Stepped to the end with a snapshot every round: the reference's
    result, snapshot files and artifact files, byte for byte."""
    jres, jdir = j_driver
    drv = PartitionDriver(ef if store else g, CFG, mode="hybrid",
                          snapshot_dir=tmp_path / "snap", snapshot_every=1,
                          keep=KEEP_ALL, device="cpu")
    assert (drv.n, drv.m) == (g.num_vertices, g.num_edges)
    got = drv.run()
    _same(got, jres)
    _same(got, partition_hybrid(g, CFG))
    drv.save_artifact(tmp_path / "art")
    if store:
        # the fingerprint of a store hashes its block index, not the
        # edges: the reference's files for the same EdgeFile
        jdir = tmp_path / "ref"
        jdrv = JDriver(JEdgeFile(ef.path), JCFG, mode="hybrid",
                       snapshot_dir=jdir / "snap", snapshot_every=1,
                       keep=KEEP_ALL)
        jdrv.run()
        jdrv.save_artifact(jdir / "art")
    _same_files(tmp_path / "snap", jdir / "snap")
    _same_files(tmp_path / "art", jdir / "art")


@pytest.mark.parametrize("own", [True, False], ids=["own", "reference"])
def test_resume_bit_identity(g, j_driver, tmp_path, own):
    """Killed after round k: a fresh driver resumed from round k's
    snapshot — its own or the reference's — runs to the same result."""
    jres, jdir = j_driver
    snap = jdir / "snap"
    if own:
        snap = tmp_path / "snap"
        PartitionDriver(g, CFG, mode="hybrid", snapshot_dir=snap,
                        snapshot_every=1, keep=KEEP_ALL, device="cpu").run()
    kill_at = min(3, jres.rounds - 1)
    drv = PartitionDriver.resume(g, CFG, snap, round_k=kill_at,
                                 mode="hybrid", device="cpu")
    assert drv.rounds == kill_at
    _same(drv.run(), jres)


def test_resume_wrong_budget_fails(g, tmp_path):
    PartitionDriver(g, CFG, mode="hybrid", snapshot_dir=tmp_path,
                    snapshot_every=8, device="cpu").run()
    other = HybridConfig(num_partitions=P, budget_frac=0.5, seed=0)
    with pytest.raises(SnapshotMismatch):
        PartitionDriver.resume(g, other, tmp_path, mode="hybrid",
                               device="cpu")
    with pytest.raises(SnapshotMismatch, match="fingerprint"):
        PartitionDriver.resume(g, CFG.ne_config(), tmp_path, mode="single",
                               device="cpu")


def test_artifact_roundtrip(g, tmp_path):
    drv = PartitionDriver(g, CFG, mode="hybrid", device="cpu")
    res = drv.run()
    drv.save_artifact(tmp_path / "art")
    back = load_artifact(tmp_path / "art")
    np.testing.assert_array_equal(back.edge_part, res.edge_part)
    np.testing.assert_array_equal(back.edges, g.edges.numpy())
    _same(back.result(), res)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_hybrid_on_the_card_equals_the_reference(cuda, ef, j_runs):
    """From the EdgeFile, split on the host and expanded on the card."""
    for tau in TAUS:
        _same(partition_hybrid(ef, HybridConfig(num_partitions=P,
                                                budget_frac=tau, seed=0)),
              j_runs[tau])


@pytest.mark.gpu
def test_hybrid_driver_on_the_card(cuda, g, j_driver, tmp_path):
    jres, jdir = j_driver
    drv = PartitionDriver(rmat(11, 8, seed=2, device=cuda), CFG,
                          mode="hybrid", snapshot_dir=tmp_path / "s",
                          snapshot_every=1, keep=KEEP_ALL)
    _same(drv.run(), jres)
    _same_files(tmp_path / "s", jdir / "snap")
