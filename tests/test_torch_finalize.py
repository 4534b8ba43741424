"""The sharded finalize of a multi-controller run
(``repro_torch.runtime.finalize``, ``core.epilogue.finalize_local``), the
multi-writer artifact, the lazy ``PartitionResult``, the host-side
collectives of ``dist.compat`` and the driver's multi-controller path in
one process, against the reference package.

Mirrors tests/test_runtime.py's tests of the reference's
``runtime/finalize.py`` (the leftover plan, the sharded finalize, the
multi-writer artifact and its torn save, the lazy result).  Tolerance 0:
bits for arrays, bytes for files.
"""
import contextlib
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import torch_spmd_ranks
from repro.core import epilogue as jepi
from repro.core import partitioner as jp
from repro.core.partitioner import PartitionResult as JResult
from repro.dist import partitioner_sm as jsm
from repro.io.edgefile import EdgeFile as JEdgeFile
from repro.runtime import artifact as jart
from repro.runtime import finalize as jfz
from repro_torch import io as tio
from repro_torch.core import epilogue as epi
from repro_torch.core import partitioner as tp
from repro_torch.core.metrics import stats_from_counts
from repro_torch.dist import compat
from repro_torch.dist import partitioner_sm as sm
from repro_torch.graphs.rmat import rmat
from repro_torch.io.csr import grid_assign_host
from repro_torch.obs import trace as obs
from repro_torch.runtime import PartitionDriver, load_artifact
from repro_torch.runtime import artifact as art
from repro_torch.runtime import finalize as fz

ROOT = Path(__file__).resolve().parent.parent
GRAPH = (10, 8, 3)
KW = dict(num_partitions=8, seed=0, k_sel=64, edge_chunk=1 << 10)
CFG = tp.NEConfig(**KW)
JCFG = jp.NEConfig(use_pallas=True, **KW)
FIELDS = ("edge_part", "vparts", "edges_per_part", "rounds", "leftover")
KEEP_ALL = 1 << 20


def _fabricated_layout(seed=0, n=400, m=3000, p_num=8, num_devices=4,
                       leftover_frac=0.1):
    """A deterministic partial assignment over a 2D-hash shard layout:
    the raw material of a finalize, without running a partitioner."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(m, 2)).astype(np.int32)
    dev = grid_assign_host(edges, num_devices)
    eids = {d: np.flatnonzero(dev == d).astype(np.int64)
            for d in range(num_devices)}
    ep = ((edges[:, 0].astype(np.int64) * 31 + edges[:, 1])
          % p_num).astype(np.int32)
    ep[rng.random(m) < leftover_frac] = -1
    vparts = np.zeros((n, p_num), bool)
    ok = ep >= 0
    vparts[edges[ok, 0], ep[ok]] = True
    vparts[edges[ok, 1], ep[ok]] = True
    counts = np.bincount(ep[ok], minlength=p_num).astype(np.int32)
    return edges, dev, eids, ep, vparts, counts


def _same_dir(a, b) -> int:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return len(names)


# ---------------------------------------------------------------------------
# the epilogue's pieces == the reference's
# ---------------------------------------------------------------------------

def test_leftover_plan_matches_cleanup():
    """leftover_plan + leftover_targets reproduce the cleanup_leftovers
    water-fill exactly (the overflow case too), and equal the
    reference's."""
    rng = np.random.default_rng(7)
    for _ in range(20):
        p_num = int(rng.integers(2, 9))
        counts = rng.integers(0, 50, size=p_num).astype(np.int32)
        k = int(rng.integers(0, 200))
        limit = epi.alpha_limit(1.1, int(counts.sum()) + k, p_num)
        take = epi.leftover_plan(counts, k, p_num, limit)
        np.testing.assert_array_equal(
            take, jepi.leftover_plan(counts, k, p_num, limit))
        assert int(take.sum()) == k
        ref = np.repeat(np.arange(p_num, dtype=np.int32), take)
        got = epi.leftover_targets(take, np.arange(k))
        np.testing.assert_array_equal(ref, got)
        if k <= int(np.maximum(limit - counts.astype(np.int64), 0).sum()):
            assert ((counts + take) <= max(limit, int(counts.max()))).all()
        ep = np.concatenate([np.repeat(np.arange(p_num, dtype=np.int32),
                                       counts),
                             np.full(k, -1, np.int32)])
        edges = np.zeros((ep.size, 2), np.int64)
        vp = np.zeros((1, p_num), bool)
        c2 = counts.copy()
        assert epi.cleanup_leftovers(ep, vp, c2, edges, p_num, limit) == k
        np.testing.assert_array_equal(c2, counts + take)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_finalize_local_matches_reference(seed):
    """The port's finalize_local on one shard slice: the same slots,
    replica flags and count as the reference's."""
    edges, _, eids, ep, vparts, counts = _fabricated_layout(seed=seed)
    rem_all = np.flatnonzero(ep < 0)
    take = epi.leftover_plan(counts, rem_all.size, 8,
                             epi.alpha_limit(1.1, ep.size, 8))
    e = eids[seed % 4]
    ranks = np.searchsorted(rem_all, e[ep[e] < 0])
    outs = []
    for f in (epi.finalize_local, jepi.finalize_local):
        sl, vp = ep[e].copy(), vparts.copy()
        k = f(sl, edges[e, 0], edges[e, 1], ranks, take, vp)
        outs.append((sl, vp, k))
    (a, va, ka), (b, vb, kb) = outs
    assert ka == kb > 0
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(va, vb)
    assert (a >= 0).all()


def test_sharded_finalize_bit_identical_and_bounded(tmp_path):
    """The per-host epilogue (stage → rank → slice-local apply → OR/sum
    combine) reproduces the whole-array finalize bit for bit, its spills
    and take equal the reference's, and no per-host structure it touches
    is O(m)."""
    n, m, p_num, num_devices, hosts = 400, 3000, 8, 4, 2
    edges, dev, eids, ep_full, vparts, counts = _fabricated_layout(
        n=n, m=m, p_num=p_num, num_devices=num_devices)
    limit = epi.alpha_limit(1.1, m, p_num)
    ref_ep, ref_vp, ref_counts = ep_full.copy(), vparts.copy(), counts.copy()
    leftover = epi.cleanup_leftovers(ref_ep, ref_vp, ref_counts, edges,
                                     p_num, limit)
    assert leftover > 0                      # the fixture must exercise it

    owned = {0: [0, 1], 1: [2, 3]}
    runs = {}
    for name, mod in (("port", fz), ("reference", jfz)):
        fin = tmp_path / name
        slices = {d: ep_full[eids[d]].copy() for d in range(num_devices)}
        us = {d: edges[eids[d], 0] for d in range(num_devices)}
        vs = {d: edges[eids[d], 1] for d in range(num_devices)}

        def own(x, h):
            return {d: x[d] for d in owned[h]}

        staged = {h: mod.stage_leftovers(fin, h, own(slices, h),
                                         own(eids, h))
                  for h in range(hosts)}
        assert all(s.size < m for s in staged.values())
        vp_host, takes = {}, {}
        for h in range(hosts):
            vp_host[h] = vparts.copy()
            takes[h], total = mod.apply_leftovers(
                fin, h, hosts, staged[h], own(slices, h), own(us, h),
                own(vs, h), own(eids, h), counts, limit, p_num, vp_host[h])
        np.testing.assert_array_equal(takes[0], takes[1])
        assert total == leftover
        vp_comb = vp_host[0] | vp_host[1]
        counts_after = (counts.astype(np.int64) + takes[0]).astype(np.int32)
        stats = stats_from_counts(vp_comb.sum(axis=0), counts_after, n)
        out = np.full(m, -1, np.int32)
        epi.stitch_slices(out, slices, eids)
        np.testing.assert_array_equal(out, ref_ep)
        np.testing.assert_array_equal(vp_comb, ref_vp)
        np.testing.assert_array_equal(counts_after, ref_counts)
        assert stats.replicas_total == int(ref_vp.sum())
        for h in range(hosts):
            contribs = mod.partition_contribs(own(slices, h), own(us, h),
                                              own(vs, h), own(eids, h),
                                              p_num)
            assert sum(c[0].size for c in contribs.values()) \
                == sum(eids[d].size for d in owned[h])
        le, lt = mod.leftover_assignments(fin, hosts, takes[0])
        chk = ep_full.copy()
        chk[le] = lt
        np.testing.assert_array_equal(chk, ref_ep)
        runs[name] = (takes[0], le, lt)
    for a, b in zip(runs["port"], runs["reference"]):
        np.testing.assert_array_equal(a, b)
    assert _same_dir(tmp_path / "port", tmp_path / "reference") == hosts


def test_multiwriter_artifact_bit_identical(tmp_path):
    """A multi-writer artifact (per-host contributions, owner encode,
    writer-0 publish) has the bytes of the single-writer save_artifact,
    the port's and the reference's."""
    n, m, p_num, num_devices, hosts = 400, 3000, 8, 4, 2
    edges, _, eids, ep, vparts, counts = _fabricated_layout(
        n=n, m=m, p_num=p_num, num_devices=num_devices, leftover_frac=0.0)
    res = types.SimpleNamespace(edge_part=ep, vparts=vparts,
                                edges_per_part=counts, rounds=9, leftover=0)
    meta = dict(config_fingerprint="cfg", graph_fingerprint="g")
    art.save_artifact(tmp_path / "ref", res, edges, n, **meta)
    jart.save_artifact(tmp_path / "jax", res, edges, n, **meta)

    owned = {0: [0, 1], 1: [2, 3]}
    art.begin_shared_artifact(tmp_path / "mw")
    for h in range(hosts):
        contribs = fz.partition_contribs(
            {d: ep[eids[d]] for d in owned[h]},
            {d: edges[eids[d], 0] for d in owned[h]},
            {d: edges[eids[d], 1] for d in owned[h]},
            {d: eids[d] for d in owned[h]}, p_num)
        art.write_artifact_contrib(tmp_path / "mw", h, contribs)
    for h in range(hosts):
        art.encode_shared_parts(tmp_path / "mw", h,
                                list(range(h, p_num, hosts)), hosts)
    art.publish_shared_artifact(
        tmp_path / "mw", num_vertices=n, num_edges=m,
        num_partitions=p_num, num_hosts=hosts, vparts=vparts,
        edges_per_part=counts, rounds=9, leftover=0, **meta)
    assert _same_dir(tmp_path / "ref", tmp_path / "mw") == p_num + 2
    assert _same_dir(tmp_path / "jax", tmp_path / "mw") == p_num + 2
    np.testing.assert_array_equal(load_artifact(tmp_path / "mw").edge_part,
                                  ep)


def test_multiwriter_artifact_torn_save_invisible(tmp_path):
    """A writer killed before publish leaves only the dot-prefixed
    staging dir; an artifact already at the target stays intact; publish
    refuses partitions nobody encoded; the next save reclaims the
    staging."""
    n, m, p_num, num_devices = 300, 2000, 4, 2
    edges, _, eids, ep, vparts, counts = _fabricated_layout(
        n=n, m=m, p_num=p_num, num_devices=num_devices, leftover_frac=0.0)
    res = types.SimpleNamespace(edge_part=ep, vparts=vparts,
                                edges_per_part=counts, rounds=3, leftover=0)
    target = tmp_path / "art"
    art.save_artifact(target, res, edges, n)
    before = {p.name: p.read_bytes() for p in target.iterdir()}

    def contribs(own):
        return fz.partition_contribs(
            {d: ep[eids[d]] for d in own}, {d: edges[eids[d], 0] for d in own},
            {d: edges[eids[d], 1] for d in own}, {d: eids[d] for d in own},
            p_num)

    art.begin_shared_artifact(target)
    art.write_artifact_contrib(target, 0, contribs([0]))
    assert before == {p.name: p.read_bytes() for p in target.iterdir()}
    assert art._shared_tmp(target).exists()
    with pytest.raises(IOError, match="never staged"):
        art.encode_shared_parts(target, 0, [0], num_hosts=2)
    with pytest.raises(IOError, match="no host encoded"):
        art.publish_shared_artifact(
            target, num_vertices=n, num_edges=m, num_partitions=p_num,
            num_hosts=2, vparts=vparts, edges_per_part=counts, rounds=3,
            leftover=0)
    art.begin_shared_artifact(target)
    for h, own in ((0, [0]), (1, [1])):
        art.write_artifact_contrib(target, h, contribs(own))
    for h in (0, 1):
        art.encode_shared_parts(target, h, list(range(h, p_num, 2)), 2)
    art.publish_shared_artifact(
        target, num_vertices=n, num_edges=m, num_partitions=p_num,
        num_hosts=2, vparts=vparts, edges_per_part=counts, rounds=3,
        leftover=0)
    assert not art._shared_tmp(target).exists()
    np.testing.assert_array_equal(load_artifact(target).edge_part, ep)


def test_artifact_threads_write_the_same_bytes(tmp_path):
    """Partitions encode and decode in threads: with many more
    partitions than threads and a short switch interval, the save has
    the reference's bytes and the load gives back every edge."""
    import sys

    n, m, p_num = 500, 20_000, 200
    rng = np.random.default_rng(5)
    edges = rng.integers(0, n, size=(m, 2)).astype(np.int32)
    ep = rng.integers(0, p_num, size=m).astype(np.int32)
    vparts = np.zeros((n, p_num), bool)
    vparts[edges[:, 0], ep] = vparts[edges[:, 1], ep] = True
    res = types.SimpleNamespace(
        edge_part=ep, vparts=vparts, rounds=4, leftover=0,
        edges_per_part=np.bincount(ep, minlength=p_num).astype(np.int32))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        art.save_artifact(tmp_path / "port", res, edges, n)
        loaded = load_artifact(tmp_path / "port")
        np.testing.assert_array_equal(loaded.edge_part, ep)
        np.testing.assert_array_equal(loaded.edges, edges)
    finally:
        sys.setswitchinterval(old)
    jart.save_artifact(tmp_path / "jax", res, edges, n)
    assert _same_dir(tmp_path / "port", tmp_path / "jax") == p_num + 2


@pytest.mark.parametrize("cls", [tp.PartitionResult, JResult],
                         ids=["port", "reference"])
def test_lazy_partition_result_materializes_once(cls):
    calls = []

    def make():
        calls.append(1)
        return np.arange(5, dtype=np.int32)

    res = cls(make, None, None, 1, 0)
    assert not res.edge_part_materialized
    np.testing.assert_array_equal(res.edge_part, np.arange(5))
    assert res.edge_part_materialized
    np.testing.assert_array_equal(res.edge_part, np.arange(5))
    assert len(calls) == 1
    eager = cls(np.arange(3), None, None, 1, 0)
    assert eager.edge_part_materialized
    assert not hasattr(eager, "__dict__")          # __slots__ hold


# ---------------------------------------------------------------------------
# the host-side collectives
# ---------------------------------------------------------------------------

def test_host_collectives_at_world_1():
    """Without a group, and in a world-1 group: identities."""
    mask = np.random.default_rng(0).random((37, 13)) < 0.3
    for ctx in (contextlib.nullcontext(), compat.world1("gloo")):
        with ctx:
            compat.barrier("x")
            assert compat.all_processes_min(5) == 5
            assert compat.all_processes_sum(5) == 5
            assert compat.all_processes_any(mask) is not None
            np.testing.assert_array_equal(compat.all_processes_any(mask),
                                          mask)


@pytest.mark.parametrize("world,p,chunk", [(2, 37, 64), (4, 8, 1 << 26),
                                           (3, 64, 100)])
def test_host_collectives_across_ranks(world, p, chunk):
    """min, sum and the chunked OR of packed words at 2-4 gloo ranks
    (chunks of ``chunk`` bytes of words: many chunks, one, ragged)."""
    rng = np.random.default_rng(world)
    masks = rng.random((world, 203, p)) < 0.1
    values = rng.integers(-50, 50, size=world)
    outs = compat.spawn(torch_spmd_ranks.host_collectives, world, "gloo",
                        masks, values, chunk)
    for mn, sm_, any_ in outs:
        assert mn == values.min() and sm_ == values.sum()
        np.testing.assert_array_equal(any_, masks.any(axis=0))


# ---------------------------------------------------------------------------
# the driver's multi-controller path at world 1, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = tmp_path_factory.mktemp("store") / "c.edges"
    return tio.write_edgefile(path, rmat(*GRAPH, device="cpu").edges.numpy(),
                              num_vertices=1 << GRAPH[0], block_size=1 << 10,
                              flags=tio.FLAG_CANONICAL)


@pytest.fixture(scope="module")
def world1_runs(store, tmp_path_factory):
    """At world 1: a multi-controller run (exchange, multi-writer
    snapshots every 4 rounds and artifact) and a single-writer one."""
    td = tmp_path_factory.mktemp("mh1")
    tr = obs.configure(path=None)
    try:
        with compat.world1("gloo"):
            mh = PartitionDriver(store, CFG, exchange_dir=td / "ex",
                                 snapshot_dir=td / "snap_mh",
                                 snapshot_every=4, keep=KEEP_ALL,
                                 device="cpu")
            res = mh.run()
            lazy = not res.edge_part_materialized
            mh.save_artifact(td / "art_mh")
            res.edge_part             # the all-gather, inside the group
            one = PartitionDriver(store, CFG, snapshot_dir=td / "snap_1",
                                  snapshot_every=4, keep=KEEP_ALL,
                                  device="cpu")
            res1 = one.run()
            one.save_artifact(td / "art_1")
            spmd = sm.partition_spmd(store, CFG, device="cpu")
    finally:
        obs.disable()
    return dict(td=td, res=res, lazy=lazy, res1=res1, spmd=spmd,
                events=tr.events, driver=mh)


def test_multihost_driver_at_world_1_matches(world1_runs):
    """== the single-writer driver, partition_spmd at world 1 and the
    reference's partition_spmd on one device; the lazy edge_part is
    forced only by the read."""
    r = world1_runs
    assert r["lazy"]
    want = jsm.partition_spmd(JEdgeFile(r["driver"].source.path), JCFG)
    for other in (r["res1"], r["spmd"], want):
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(r["res"], f)),
                                          np.asarray(getattr(other, f)),
                                          err_msg=f)
    assert r["res"].stats == r["res1"].stats


def test_multihost_driver_writes_single_writer_bytes(world1_runs):
    """Its multi-writer snapshots and artifact have the single-writer
    driver's bytes; its spans include the exchange ingest."""
    td = world1_runs["td"]
    for step in sorted(p.name for p in (td / "snap_1").glob("step_*")):
        assert _same_dir(td / "snap_1" / step, td / "snap_mh" / step) == 3
    assert _same_dir(td / "art_1", td / "art_mh") == CFG.num_partitions + 2
    names = {e["name"] for e in world1_runs["events"] if e["ev"] == "span"}
    assert {"ingest", "exchange_write", "exchange_assemble", "finalize",
            "stage_leftovers", "apply_leftovers", "snapshot"} <= names


def test_multihost_driver_forbids_materializing(store, tmp_path,
                                                monkeypatch):
    """With REPRO_FORBID_EDGE_PART_MATERIALIZE set the run finalizes and
    saves its artifact; only reading edge_part raises."""
    monkeypatch.setenv("REPRO_FORBID_EDGE_PART_MATERIALIZE", "1")
    with compat.world1("gloo"):
        drv = PartitionDriver(store, CFG, exchange_dir=tmp_path / "ex",
                              device="cpu")
        res = drv.run()
        drv.save_artifact(tmp_path / "art")
        with pytest.raises(RuntimeError, match="FORBID"):
            res.edge_part
    assert load_artifact(tmp_path / "art").manifest["rounds"] == res.rounds


def test_multihost_driver_resumes_at_world_1(store, world1_runs):
    """A fresh multi-controller driver resumed from the run's round-8
    multi-writer snapshot ends on the same bits."""
    td = world1_runs["td"]
    with compat.world1("gloo"):
        drv = PartitionDriver.resume(store, CFG, td / "snap_mh", round_k=8,
                                     exchange_dir=td / "ex2", device="cpu")
        assert drv.rounds == 8
        got = drv.run()
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f)),
                np.asarray(getattr(world1_runs["res"], f)), err_msg=f)


def test_single_writer_driver_resumes_multi_writer_snapshot(
        store, world1_runs, tmp_path):
    """The single-writer spmd driver resumed from the run's round-8
    multi-writer snapshot, then writing its own snapshots into a store of
    its own: each step dir has the bytes of the multi-writer one, and the
    result the same bits (the card script's phase 9 (c))."""
    from repro_torch.runtime.snapshot import RunSnapshot

    td = world1_runs["td"]
    with compat.world1("gloo"):
        drv = PartitionDriver(store, CFG, snapshot_dir=td / "snap_mh",
                              device="cpu")
        assert drv.restore_snapshot(8) == 8
        drv.snapshot = RunSnapshot(tmp_path, drv.cfg, drv.snapshot.graph_fp,
                                   keep=KEEP_ALL)
        drv.snapshot_every = 4
        got = drv.run()
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == [f"step_{k:010d}"
                     for k in range(12, got.rounds + 1, 4)] and steps
    for step in steps:
        assert _same_dir(tmp_path / step, td / "snap_mh" / step) == 3
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)),
            np.asarray(getattr(world1_runs["res"], f)), err_msg=f)


# ---------------------------------------------------------------------------
# the launcher's other paths
# ---------------------------------------------------------------------------

def _launcher(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.launch_multihost",
         "--device", "cpu", *args], capture_output=True, text=True,
        timeout=timeout, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_launcher_runs_the_hybrid_single_controller(store, tmp_path):
    """``--partitioner hybrid`` at one process: the reference's hybrid,
    and its artifact's bytes."""
    from repro.core import hybrid as jhybrid

    proc = _launcher("--edgefile", store.path, "--partitions", "8",
                     "--k-sel", "64", "--edge-chunk", str(1 << 10),
                     "--partitioner", "hybrid", "--budget-frac", "0.5",
                     "--num-processes", "1", "--out", str(tmp_path / "out"),
                     "--artifact-out", str(tmp_path / "art"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(tmp_path / "out" / "result.npz")
    jcfg = jhybrid.HybridConfig(budget_frac=0.5, use_pallas=True, **KW)
    want = jhybrid.partition_hybrid(JEdgeFile(store.path), jcfg)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert load_artifact(tmp_path / "art").rounds == int(want.rounds)


@pytest.mark.parametrize("args,msg", [
    (["--partitioner", "hybrid", "--num-processes", "2"],
     "single-controller"),
    (["--num-processes", "2"], "needs --exchange-dir"),
])
def test_launcher_refuses_what_it_cannot_run(store, args, msg):
    proc = _launcher("--edgefile", store.path, "--partitions", "8", *args,
                     timeout=120)
    assert proc.returncode == 2 and msg in proc.stderr
