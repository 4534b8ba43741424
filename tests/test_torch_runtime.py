"""The port's checkpointable runtime (``repro_torch.runtime``) against the
reference package's ``repro.runtime``.

Mirrors tests/test_runtime.py, but for its tests of the reference's
``runtime/finalize.py`` (tests/test_torch_finalize.py mirrors those; the
multi-controller launches are tests/test_torch_multihost_{2,4}.py).  The driver in
single and spmd mode equals ``partition`` / ``partition_spmd`` and the
reference's driver bit for bit; a run killed after round k and resumed
from its snapshot equals the uninterrupted run; snapshot directories and
artifacts are byte-identical to the reference driver's (run with
``use_pallas=True``, the fingerprint decision in
``repro_torch.runtime.snapshot``), and each package resumes from and
loads the other's.  Spmd mode runs at world 1 in this process (gloo) and
at 2 and 4 spawned gloo ranks (rank bodies in ``torch_spmd_ranks``),
against the reference at 2 and 4 devices, which runs in a subprocess
(this file run as a script, started with the module's first test):

    python tests/test_torch_runtime.py EDGEFILE OUT_DIR
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_spmd_ranks
from repro.apps import engine as jengine
from repro.core import partitioner as jp
from repro.dist import partitioner_sm as jsm
from repro.graphs.rmat import rmat as j_rmat
from repro.io.edgefile import EdgeFile as JEdgeFile
from repro.runtime import PartitionDriver as JDriver
from repro.runtime import snapshot as jsnap
from repro.train import checkpoint as jckpt
from repro_torch import io as tio
from repro_torch.apps.engine import build_sharded_graph
from repro_torch.core import partitioner as tp
from repro_torch.core.hybrid import HybridConfig
from repro_torch.core.metrics import evaluate
from repro_torch.dist import compat
from repro_torch.dist import partitioner_sm as sm
from repro_torch.graphs.rmat import rmat
from repro_torch.io.stream import shard_edges_stream
from repro_torch.obs import live
from repro_torch.obs import trace as obs
from repro_torch.runtime import (PartitionDriver, SnapshotMismatch,
                                 config_fingerprint, graph_fingerprint,
                                 host_block_ranges, ingest_edgefile,
                                 load_artifact, save_artifact)
from repro_torch.runtime.snapshot import RunSnapshot, ShardedCheckpointManager
from repro_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parent.parent
GRAPH = (10, 8, 3)                       # RMAT scale, edge factor, seed
KW = dict(num_partitions=8, seed=0, k_sel=64, edge_chunk=1 << 10)
CFG = tp.NEConfig(**KW)
JCFG = jp.NEConfig(use_pallas=True, **KW)
WORLDS = (2, 4)
KEEP_ALL = 1 << 20


def _result(res) -> dict:
    return {"edge_part": np.asarray(res.edge_part),
            "vparts": np.asarray(res.vparts),
            "edges_per_part": np.asarray(res.edges_per_part),
            "rounds": res.rounds, "leftover": res.leftover}


def _same(got, want):
    """Two results (or ``_result`` dicts) equal field for field."""
    got = _result(got)
    want = want if isinstance(want, dict) else _result(want)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _same_tree(a, b) -> int:
    """Two directories hold the same files with the same bytes."""
    a, b = Path(a), Path(b)
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for f in fa:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    return len(fa)


def _canonical_edges():
    return rmat(*GRAPH, device="cpu").edges.numpy()


def _write_reference_runs(ef_path: str, out: str) -> None:
    """The reference driver at 2 and 4 devices from the port's EdgeFile:
    snapshots every round, the result and the artifact."""
    import jax

    assert len(jax.devices()) >= max(WORLDS), jax.devices()
    res = {}
    for d in WORLDS:
        drv = JDriver(JEdgeFile(ef_path), JCFG, num_devices=d,
                      snapshot_dir=os.path.join(out, f"snap{d}"),
                      snapshot_every=1, keep=KEEP_ALL)
        res[d] = _result(drv.run())
        drv.save_artifact(os.path.join(out, f"art{d}"))
    with open(os.path.join(out, "results.pkl"), "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The test graph as the port's canonical EdgeFile (blocks of 1,024)."""
    path = tmp_path_factory.mktemp("store") / "c.edges"
    return tio.write_edgefile(path, _canonical_edges(),
                              num_vertices=1 << GRAPH[0], block_size=1 << 10,
                              flags=tio.FLAG_CANONICAL)


@pytest.fixture(scope="module", autouse=True)
def _reference_process(tmp_path_factory, store):
    """Starts the reference's multi-device runs with the module's first
    test; yields (process, output dir), and ends the process if no test
    waited for it."""
    out = tmp_path_factory.mktemp("jax_runtime")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.Popen([sys.executable, __file__, store.path, str(out)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(ROOT))
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference_runs(_reference_process):
    proc, out = _reference_process
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(out / "results.pkl", "rb") as f:
        return out, pickle.load(f)


@pytest.fixture(scope="module")
def graph():
    return rmat(*GRAPH, device="cpu")


@pytest.fixture(scope="module")
def snapped_run(graph, tmp_path_factory):
    """One uninterrupted spmd run at world 1, a snapshot every round."""
    snap_dir = tmp_path_factory.mktemp("runtime") / "snap"
    with compat.world1("gloo"):
        drv = PartitionDriver(graph, CFG, snapshot_dir=snap_dir,
                              snapshot_every=1, keep=KEEP_ALL, device="cpu")
        res = drv.run()
    return drv, res, snap_dir


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference driver's spmd run at 1 device on the same graph."""
    out = tmp_path_factory.mktemp("jax_world1")
    drv = JDriver(j_rmat(*GRAPH), JCFG, snapshot_dir=out / "snap",
                  snapshot_every=1, keep=KEEP_ALL)
    res = drv.run()
    drv.save_artifact(out / "art")
    return res, out


# ---------------------------------------------------------------------------
# driver == partition / partition_spmd == the reference's driver
# ---------------------------------------------------------------------------

def test_driver_spmd_matches_partition_spmd_and_reference(graph, snapped_run,
                                                          reference_run):
    """Round stepping calls the round function partition_spmd loops over,
    so the state machine is bit-identical to it and to the reference."""
    _, res, _ = snapped_run
    with compat.world1("gloo"):
        _same(res, sm.partition_spmd(graph, CFG, device="cpu"))
    _same(res, reference_run[0])
    _same(res, jsm.partition_spmd(j_rmat(*GRAPH), JCFG))


def test_driver_single_mode_matches_partition_and_reference(graph,
                                                            tmp_path):
    drv = PartitionDriver(graph, CFG, mode="single", device="cpu",
                          snapshot_dir=tmp_path / "t", snapshot_every=2,
                          keep=KEEP_ALL)
    res = drv.run()
    _same(res, tp.partition(graph, CFG))
    jdrv = JDriver(j_rmat(*GRAPH), JCFG, mode="single",
                   snapshot_dir=tmp_path / "j", snapshot_every=2,
                   keep=KEEP_ALL)
    _same(res, jdrv.run())
    # the single-mode snapshots (bool replica map in data.bin) too
    assert _same_tree(tmp_path / "t", tmp_path / "j") > 3


def test_snapshots_byte_identical_to_reference(snapped_run, reference_run):
    """Every round's step dir — data.bin, the edge_part shard files and
    the manifest with both fingerprints — has the reference's bytes."""
    _, res, snap_dir = snapped_run
    assert _same_tree(snap_dir, reference_run[1] / "snap") \
        == 3 * res.rounds


def test_artifact_byte_identical_to_reference(snapped_run, reference_run,
                                              tmp_path):
    drv, _, _ = snapped_run
    with compat.world1("gloo"):
        drv.save_artifact(tmp_path / "art")
    assert _same_tree(tmp_path / "art", reference_run[1] / "art") \
        == CFG.num_partitions + 2


# ---------------------------------------------------------------------------
# kill-at-round-k + resume bit-identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_resume_bit_identity(graph, snapped_run, where):
    """Resume from the round-k snapshot == uninterrupted run, bit for bit:
    identical vparts, edge assignment, and replication factor."""
    _, res, snap_dir = snapped_run
    k = {"first": 1, "middle": res.rounds // 2,
         "last": res.rounds - 1}[where]
    with compat.world1("gloo"):
        drv = PartitionDriver.resume(graph, CFG, snap_dir, round_k=k,
                                     device="cpu")
        assert drv.rounds == k
        got = drv.run()
    _same(got, res)
    edges = graph.edges.numpy()
    assert evaluate(edges, got.edge_part, graph.num_vertices, 8) \
        == evaluate(edges, res.edge_part, graph.num_vertices, 8)


def test_resume_latest_snapshot(graph, snapped_run):
    """Default resume picks the newest snapshot — the post-kill path."""
    _, res, snap_dir = snapped_run
    with compat.world1("gloo"):
        drv = PartitionDriver.resume(graph, CFG, snap_dir, device="cpu")
        assert drv.rounds == res.rounds
        _same(drv.run(), res)       # already at the fixed point


def test_resume_single_mode(tmp_path):
    g = rmat(9, 8, seed=5, device="cpu")
    cfg = tp.NEConfig(num_partitions=4, seed=1, k_sel=32, edge_chunk=1 << 10)
    full = PartitionDriver(g, cfg, mode="single", snapshot_dir=tmp_path,
                           snapshot_every=2, keep=KEEP_ALL,
                           device="cpu").run()
    drv = PartitionDriver.resume(g, cfg, tmp_path, mode="single",
                                 device="cpu")
    assert drv.rounds > 0
    _same(drv.run(), full)


@pytest.mark.parametrize("mode", ["spmd", "single"])
def test_resumed_driver_writes_the_unbroken_runs_snapshots(graph, tmp_path,
                                                           mode):
    """A driver resumed at round k writes every later step dir with the
    bytes of the uninterrupted run's: restoring keeps the 0-d round
    counters 0-d."""
    with compat.world1("gloo"):
        full = PartitionDriver(graph, CFG, mode=mode,
                               snapshot_dir=tmp_path / "full",
                               snapshot_every=2, keep=KEEP_ALL, device="cpu")
        res = full.run()
        k = 2 * (res.rounds // 4)
        assert k > 0
        drv = PartitionDriver.resume(graph, CFG, tmp_path / "full",
                                     round_k=k, mode=mode, device="cpu")
        drv.snapshot = RunSnapshot(tmp_path / "resumed", drv.cfg,
                                   drv.snapshot.graph_fp, keep=KEEP_ALL)
        drv.snapshot_every = 2
        _same(drv.run(), res)
    steps = sorted(p.name for p in (tmp_path / "resumed").glob("step_*"))
    assert steps == [f"step_{r:010d}"
                     for r in range(k + 2, res.rounds + 1, 2)] and steps
    for step in steps:
        assert _same_tree(tmp_path / "resumed" / step,
                          tmp_path / "full" / step) == (
            3 if mode == "spmd" else 2)       # + the edge_part shard


@pytest.mark.parametrize("direction", ["port_from_reference",
                                       "reference_from_port"])
def test_resume_across_packages(graph, snapped_run, reference_run,
                                direction):
    """Each package resumes from the other's snapshot at round k and
    finishes with the same result."""
    _, res, snap_dir = snapped_run
    k = res.rounds // 3
    if direction == "port_from_reference":
        with compat.world1("gloo"):
            drv = PartitionDriver.resume(graph, CFG,
                                         reference_run[1] / "snap",
                                         round_k=k, device="cpu")
            assert drv.rounds == k
            got = drv.run()
    else:
        jdrv = JDriver.resume(j_rmat(*GRAPH), JCFG, snap_dir, round_k=k)
        assert jdrv.rounds == k
        got = jdrv.run()
    _same(got, res)


def test_resume_wrong_config_fails(graph, snapped_run):
    _, _, snap_dir = snapped_run
    other = dataclasses.replace(CFG, seed=1)
    with compat.world1("gloo"), pytest.raises(SnapshotMismatch):
        PartitionDriver.resume(graph, other, snap_dir, device="cpu")


def test_resume_wrong_graph_fails(snapped_run):
    _, _, snap_dir = snapped_run
    other = rmat(GRAPH[0], GRAPH[1], seed=4, device="cpu")
    with compat.world1("gloo"), pytest.raises(SnapshotMismatch):
        PartitionDriver.resume(other, CFG, snap_dir, device="cpu")


def test_resume_wrong_mode_fails(graph, snapped_run):
    _, _, snap_dir = snapped_run
    with pytest.raises(SnapshotMismatch):
        PartitionDriver.resume(graph, CFG, snap_dir, mode="single",
                               device="cpu")


def test_fingerprints_discriminate_and_equal_reference(graph, store):
    for cfg in (CFG, dataclasses.replace(CFG, seed=7),
                dataclasses.replace(CFG, alpha=1.2),
                dataclasses.replace(CFG, two_hop=False).clamped(100)):
        jcfg = jp.NEConfig(use_pallas=True, sel_chunk=8,
                           **dataclasses.asdict(cfg))
        assert config_fingerprint(cfg) == jsnap.config_fingerprint(jcfg)
        assert config_fingerprint(cfg) != jsnap.config_fingerprint(
            dataclasses.replace(jcfg, use_pallas=False))
    assert config_fingerprint(CFG) != config_fingerprint(
        dataclasses.replace(CFG, seed=7))
    assert graph_fingerprint(graph) == jsnap.graph_fingerprint(
        j_rmat(*GRAPH))
    assert graph_fingerprint(graph) != graph_fingerprint(
        rmat(GRAPH[0], GRAPH[1], seed=4, device="cpu"))
    assert graph_fingerprint(store) == jsnap.graph_fingerprint(
        JEdgeFile(store.path))
    assert graph_fingerprint(store) != graph_fingerprint(graph)


# ---------------------------------------------------------------------------
# artifact store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact(snapped_run, tmp_path_factory):
    drv, _, _ = snapped_run
    path = tmp_path_factory.mktemp("artifact") / "art"
    with compat.world1("gloo"):
        drv.save_artifact(path)
    return path


def test_artifact_roundtrip(graph, snapped_run, artifact):
    """partition → save_artifact → load_artifact → identical edge_part /
    replica map, and the reference loads the same result from it."""
    _, res, _ = snapped_run
    edges = graph.edges.numpy()
    loaded = load_artifact(artifact)
    np.testing.assert_array_equal(loaded.edge_part, res.edge_part)
    np.testing.assert_array_equal(loaded.vparts, res.vparts)
    np.testing.assert_array_equal(loaded.edges_per_part, res.edges_per_part)
    np.testing.assert_array_equal(loaded.edges, edges)
    back = loaded.result()
    assert isinstance(back, tp.PartitionResult)
    _same(back, res)
    from repro.runtime import load_artifact as j_load_artifact

    _same(j_load_artifact(artifact).result(), res)
    for p in (0, CFG.num_partitions - 1):
        e_p = loaded.partition_edges(p)
        np.testing.assert_array_equal(e_p, edges[res.edge_part == p])
        assert e_p.shape[0] == int(res.edges_per_part[p])
    part_bytes = sum((loaded.dir / f"part_{p:05d}.bin").stat().st_size
                     for p in range(CFG.num_partitions))
    assert part_bytes < 8 * graph.num_edges


def test_artifact_feeds_gas_engine(graph, snapped_run, artifact):
    """The loaded artifact builds the identical vertex-cut engine structure
    the in-memory result builds (and the reference's engine builds) — no
    re-partitioning."""
    _, res, _ = snapped_run
    sg_art = load_artifact(artifact).sharded_graph(CFG.num_partitions)
    edges = graph.edges.numpy()
    for sg_ref in (build_sharded_graph(edges, res.edge_part,
                                       graph.num_vertices,
                                       CFG.num_partitions),
                   jengine.build_sharded_graph(edges, res.edge_part,
                                               graph.num_vertices,
                                               CFG.num_partitions)):
        for field in ("edges_ml", "emask", "mirror_glob", "mirror_mask",
                      "send_idx", "send_mask", "recv_owned", "owned_glob",
                      "owned_mask"):
            np.testing.assert_array_equal(getattr(sg_art, field),
                                          np.asarray(getattr(sg_ref, field)))
        assert sg_art.comm_slots == sg_ref.comm_slots


def test_artifact_rejects_incomplete_assignment(tmp_path):
    res = tp.PartitionResult(np.array([0, -1], np.int32),
                             np.zeros((3, 2), bool),
                             np.array([1, 0], np.int32), 1, 0)
    with pytest.raises(ValueError, match="complete assignment"):
        save_artifact(tmp_path / "a", res,
                      np.array([[0, 1], [1, 2]], np.int32), 3)


def test_artifact_checksum_detects_corruption(artifact, tmp_path):
    import shutil

    shutil.copytree(artifact, tmp_path / "art")
    path = tmp_path / "art" / "part_00000.bin"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        load_artifact(tmp_path / "art").partition_edges(0)


# ---------------------------------------------------------------------------
# host block-range ingestion
# ---------------------------------------------------------------------------

def test_host_block_ranges_tile_and_balance(store):
    from repro.runtime import host_block_ranges as j_ranges

    for hosts in (1, 2, 3, 7):
        ranges = host_block_ranges(store, hosts)
        assert ranges == j_ranges(JEdgeFile(store.path), hosts)
        assert len(ranges) == hosts
        assert ranges[0][0] == 0 and ranges[-1][1] == store.num_blocks
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c and a <= b
        covered = sum(store.edges_in_blocks(a, b) for a, b in ranges)
        assert covered == store.num_edges


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_ingest_matches_shard_edges_stream(store, hosts):
    """Multi-host assembly is bit-identical to the sequential pass."""
    ref = shard_edges_stream(store, 4, with_edges=True)
    got = ingest_edgefile(store, 4, num_hosts=hosts, with_edges=True)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


def test_ingest_process_pool(store):
    ref = shard_edges_stream(store, 4)
    got = ingest_edgefile(store, 4, num_hosts=2, processes=True)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


def test_runtime_store_modules_import_without_torch():
    """The ingestion workers, the artifact and snapshot stores, the
    checkpoint manager and obs stay torch-free: unpickling
    ``cluster._ingest_worker`` in a spawn worker goes through the package
    __init__ and must not drag the driver's torch import in."""
    code = ("import sys; import repro_torch.runtime.cluster, "
            "repro_torch.runtime.artifact, repro_torch.runtime.snapshot, "
            "repro_torch.train.checkpoint, repro_torch.obs.trace, "
            "repro_torch.obs.live, repro_torch.obs.rss, repro_torch.io; "
            "import repro_torch.runtime as rt; rt.host_block_ranges; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro')]; assert not bad, bad; "
            "assert 'repro_torch.runtime.driver' not in sys.modules")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_driver_from_store(store, tmp_path):
    """The EdgeFile front door: stream the store to shards, partition, and
    match the store path of partition_spmd, the Graph run and the
    reference's driver ingesting by two host ranges."""
    with compat.world1("gloo"):
        res = PartitionDriver(store, CFG, device="cpu").run()
        _same(res, sm.partition_spmd(store, CFG, device="cpu"))
        _same(res, sm.partition_spmd(rmat(*GRAPH, device="cpu"), CFG,
                                     device="cpu"))
    _same(res, JDriver(JEdgeFile(store.path), JCFG, num_hosts=2).run())
    # and from a PackedCSR, in single mode
    packed = tio.pack_csr(store, tmp_path / "g.rcsr")
    _same(PartitionDriver(packed, CFG, mode="single", device="cpu").run(),
          res)


def test_edgefile_block_range_reads(store):
    full = store.read_all()
    a = store.read_blocks(0, 2)
    b = store.read_blocks(2)
    np.testing.assert_array_equal(np.concatenate([a, b]), full)
    assert store.edges_in_blocks(0, 2) == a.shape[0]
    assert store.edges_in_blocks() == store.num_edges
    assert store.read_blocks(5, 5).shape == (0, 2)
    assert list(store.iter_blocks(1, 1)) == []


# ---------------------------------------------------------------------------
# checkpoint managers
# ---------------------------------------------------------------------------

def test_checkpoint_manager_layout_and_restore(tmp_path):
    """The port's manager writes the reference's bytes from tensors,
    restores onto a device with each template leaf's dtype, and falls
    back past a torn newest step."""
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.tensor([1, 2], dtype=torch.int64),
                  np.array(7, np.int32)]}
    host = {"w": tree["w"].numpy(), "b": [tree["b"][0].numpy(),
                                          tree["b"][1]]}
    mgr = CheckpointManager(tmp_path / "t", keep=2)
    for step in (1, 2, 3):
        mgr.save(step, tree, extra_meta={"step": step})
        jckpt.CheckpointManager(tmp_path / "j", keep=2).save(
            step, host, extra_meta={"step": step})
    assert mgr.steps() == [2, 3]
    assert _same_tree(tmp_path / "t", tmp_path / "j") == 4
    got, step = mgr.restore(tree, device="cpu")
    assert step == 3 and isinstance(got["b"][1], torch.Tensor)
    assert got["w"].dtype == torch.float32 and got["b"][0].dtype == \
        torch.int64
    np.testing.assert_array_equal(got["w"].numpy(), host["w"])
    np.testing.assert_array_equal(got["b"][1].numpy(), 7)
    plain, _ = mgr.restore(host)
    assert isinstance(plain["w"], np.ndarray)
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(dict(host, extra=np.zeros(1)))
    (mgr._step_dir(3) / "data.bin").write_bytes(b"torn")
    _, step = mgr.restore(tree)
    assert step == 2


def test_sharded_checkpoint_roundtrip(tmp_path):
    mgr = ShardedCheckpointManager(tmp_path / "t", keep=2)
    rep = {"counts": np.arange(8, dtype=np.int32)}
    sharded = {"edge_part": np.arange(24, dtype=np.int32).reshape(4, 6)}
    mgr.save(3, rep, sharded={"edge_part": torch.from_numpy(
        sharded["edge_part"])}, extra_meta={"mode": "spmd"})
    jsnap.ShardedCheckpointManager(tmp_path / "j", keep=2).save(
        3, rep, sharded=sharded, extra_meta={"mode": "spmd"})
    assert _same_tree(tmp_path / "t", tmp_path / "j") == 6
    files = sorted(p.name for p in mgr._step_dir(3).iterdir())
    assert [f for f in files if f.startswith("edge_part.shard")] == [
        f"edge_part.shard{i:05d}.bin" for i in range(4)]
    np.testing.assert_array_equal(mgr.load_shard(3, "edge_part", 2),
                                  sharded["edge_part"][2])
    np.testing.assert_array_equal(mgr.load_sharded(3, "edge_part"),
                                  sharded["edge_part"])
    assert mgr.meta(3) == {"mode": "spmd"}
    assert mgr.shard_names(3) == ["edge_part"]


def test_sharded_checkpoint_shard_corruption(tmp_path):
    mgr = ShardedCheckpointManager(tmp_path)
    mgr.save(1, {}, sharded={"x": np.ones((2, 3), np.float32)})
    (mgr._step_dir(1) / "x.shard00001.bin").write_bytes(b"\0" * 12)
    np.testing.assert_array_equal(mgr.load_shard(1, "x", 0), np.ones(3))
    with pytest.raises(IOError, match="checksum"):
        mgr.load_shard(1, "x", 1)


def test_run_snapshot_skips_half_written(tmp_path, graph):
    """A torn newest snapshot falls back to the previous round; a valid
    snapshot of the wrong run raises instead of falling back."""
    snap = RunSnapshot(tmp_path, CFG, graph_fingerprint(graph))
    fields = {"edge_part": np.zeros((2, 4), np.int32),
              "vparts": np.zeros((5, 8), bool),
              "rounds": np.int32(1)}
    snap.save_state(1, fields, "spmd")
    fields["rounds"] = np.int32(2)
    snap.save_state(2, fields, "spmd")
    (snap.mgr._step_dir(2) / "edge_part.shard00001.bin").write_bytes(b"xy")
    got, rnd, mode = snap.restore_state()
    assert rnd == 1 and mode == "spmd"
    np.testing.assert_array_equal(got["edge_part"], fields["edge_part"])
    other = RunSnapshot(tmp_path, dataclasses.replace(CFG, seed=9),
                        graph_fingerprint(graph))
    with pytest.raises(SnapshotMismatch):
        other.restore_state()


# ---------------------------------------------------------------------------
# multi-writer snapshot protocol (numpy, replayed in one process)
# ---------------------------------------------------------------------------

def _multiwriter_save(snap, round_k, fields, ep, hosts=2):
    """Replay the cooperative protocol single-process, in protocol order:
    host 0 drives save_state_multihost, and the other hosts' shard writes
    happen at the all-shards barrier."""
    d = ep.shape[0]
    per_host = d // hosts

    def slices(h):
        return {i: ep[i] for i in range(h * per_host, (h + 1) * per_host)}

    def barrier(name):
        if name == f"snap-shards-{round_k}":
            for h in range(1, hosts):
                snap.mgr.write_host_shards(round_k, h,
                                           {"edge_part": slices(h)})

    snap.save_state_multihost(round_k, fields, "spmd", 0,
                              {"edge_part": slices(0)}, {"edge_part": d},
                              barrier)


def test_multiwriter_layout_matches_single_writer(tmp_path, graph):
    """A cooperatively-written step restores identically to a
    single-writer step, and its bytes are the reference's cooperative
    step's."""
    fp = graph_fingerprint(graph)
    ep = np.arange(32, dtype=np.int32).reshape(8, 4)
    fields = {"vparts": np.ones((6, 8), bool), "rounds": np.int32(5)}
    single = RunSnapshot(tmp_path / "s1", CFG, fp)
    single.save_state(5, dict(fields, edge_part=ep), "spmd")
    multi = RunSnapshot(tmp_path / "s2", CFG, fp)
    _multiwriter_save(multi, 5, fields, ep)
    f1, r1, m1 = single.restore_state()
    f2, r2, m2 = multi.restore_state()
    assert (r1, m1) == (r2, m2) == (5, "spmd")
    for k in f1:
        np.testing.assert_array_equal(f1[k], f2[k])
    ref = jsnap.RunSnapshot(tmp_path / "j", JCFG, fp)
    _multiwriter_save(ref, 5, fields, ep)
    assert _same_tree(tmp_path / "s2", tmp_path / "j") == 10


def test_multiwriter_unpublished_staging_is_invisible(tmp_path, graph):
    snap = RunSnapshot(tmp_path, CFG, graph_fingerprint(graph))
    ep = np.zeros((4, 3), np.int32)
    _multiwriter_save(snap, 1, {"rounds": np.int32(1)}, ep)
    meta = {"mode": "spmd", "round": 2, "config_fingerprint": snap.cfg_fp,
            "graph_fingerprint": snap.graph_fp}
    snap.mgr.begin_shared(2, {"rounds": np.int32(2)}, extra_meta=meta)
    snap.mgr.write_host_shards(2, 0, {"edge_part": {0: ep[0], 1: ep[1]}})
    assert snap.rounds() == [1]
    _, rnd, _, _ = snap.restore_state_multihost([0, 1])
    assert rnd == 1
    _multiwriter_save(snap, 2, {"rounds": np.int32(2)}, ep)
    assert snap.rounds() == [1, 2]
    assert not snap.mgr.shared_tmp(2).exists()


def test_multiwriter_refuses_missing_host_slices(tmp_path, graph):
    snap = RunSnapshot(tmp_path, CFG, graph_fingerprint(graph))
    meta = {"mode": "spmd", "round": 1, "config_fingerprint": snap.cfg_fp,
            "graph_fingerprint": snap.graph_fp}
    snap.mgr.begin_shared(1, {"rounds": np.int32(1)}, extra_meta=meta)
    snap.mgr.write_host_shards(1, 0, {"edge_part": {0: np.zeros(3)}})
    with pytest.raises(IOError, match="no host staged"):
        snap.mgr.publish_shared(1, {"edge_part": 4})
    assert snap.rounds() == []


def test_restore_multihost_loads_owned_slices_only(tmp_path, graph):
    snap = RunSnapshot(tmp_path, CFG, graph_fingerprint(graph))
    ep = np.arange(20, dtype=np.int32).reshape(4, 5)
    _multiwriter_save(snap, 3, {"rounds": np.int32(3)}, ep)
    fields, rnd, mode, counts = snap.restore_state_multihost([1, 3])
    assert (rnd, mode, counts) == (3, "spmd", {"edge_part": 4})
    assert sorted(fields["edge_part"]) == [1, 3]
    np.testing.assert_array_equal(fields["edge_part"][3], ep[3])
    fields, _, _, _ = snap.restore_state_multihost([0], num_devices=2,
                                                   host=1, num_hosts=2)
    assert sorted(fields["edge_part"]) == [1, 3]       # elastic: i % 2 == 1


# ---------------------------------------------------------------------------
# exchange-dir ingestion and the store-backed elastic reshard (numpy)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_exchange_ingestion_bit_identical(store, tmp_path, hosts):
    from repro_torch.runtime.cluster import (exchange_assemble,
                                             exchange_read_global,
                                             exchange_write_range)

    ref_sh, ref_mk, ref_cap, ref_dev, ref_edges = shard_edges_stream(
        store, 4, with_edges=True)
    ex = tmp_path / "exchange"
    for h in range(hosts):
        exchange_write_range(ex, store.path, h, hosts, 4)
    shards, masks, cap, degree = exchange_assemble(ex, hosts, 4, [0, 2, 3])
    assert cap == ref_cap
    for d in (0, 2, 3):
        np.testing.assert_array_equal(shards[d], ref_sh[d])
        np.testing.assert_array_equal(masks[d], ref_mk[d])
    edges, dev = exchange_read_global(ex, hosts)
    np.testing.assert_array_equal(edges, ref_edges)
    np.testing.assert_array_equal(dev, ref_dev)
    deg = np.zeros(int(store.num_vertices), np.int64)
    np.add.at(deg, ref_edges[:, 0], 1)
    np.add.at(deg, ref_edges[:, 1], 1)
    np.testing.assert_array_equal(degree, deg)


@pytest.mark.parametrize("hosts", [1, 2])
def test_exchange_ingestion_one_device_bit_identical(store, tmp_path, hosts):
    """At one device every edge hashes to device 0 (no hash is taken, a
    block is copied whole, the flat edges are not scattered): the same
    bytes as the streaming shards and repro's exchange."""
    from repro.runtime import cluster as jcluster
    from repro_torch.runtime.cluster import (exchange_assemble,
                                             exchange_read_global,
                                             exchange_write_range)

    ref_sh, ref_mk, ref_cap, ref_dev, ref_edges = shard_edges_stream(
        store, 1, with_edges=True)
    ex, jex = tmp_path / "exchange", tmp_path / "jexchange"
    for h in range(hosts):
        counts = exchange_write_range(ex, store.path, h, hosts, 1)
        want = jcluster.exchange_write_range(jex, store.path, h, hosts, 1)
        np.testing.assert_array_equal(counts, want)
    for f in sorted(os.listdir(jex)):
        assert (ex / f).read_bytes() == (jex / f).read_bytes(), f
    shards, masks, cap, _ = exchange_assemble(ex, hosts, 1, [0])
    assert cap == ref_cap
    np.testing.assert_array_equal(shards[0], ref_sh[0])
    np.testing.assert_array_equal(masks[0], ref_mk[0])
    edges, dev = exchange_read_global(ex, hosts)
    np.testing.assert_array_equal(edges, ref_edges)
    np.testing.assert_array_equal(dev, ref_dev)


def test_reshard_stream_matches_memory(store, tmp_path):
    from repro_torch.io.csr import grid_assign_host
    from repro_torch.runtime.cluster import (exchange_write_range,
                                             reshard_assemble, reshard_write,
                                             shard_eids)

    hosts, d_old, d_new = 2, 4, 2
    ref_sh, _, _, dev_old, edges = shard_edges_stream(store, d_old,
                                                      with_edges=True)
    m = int(store.num_edges)
    old_full = (np.arange(m) % 7 - 1).astype(np.int32)
    old_slices = {d: np.full(ref_sh.shape[1], -1, np.int32)
                  for d in range(d_old)}
    for d in range(d_old):
        sel = np.flatnonzero(dev_old == d)
        old_slices[d][:sel.size] = old_full[sel]
    ex = tmp_path / "exchange"
    for h in range(hosts):
        exchange_write_range(ex, store.path, h, hosts, d_new)
    dev_new = grid_assign_host(edges, d_new)
    spill = tmp_path / "reshard"
    for h in range(hosts):
        mine = {i: old_slices[i] for i in range(d_old) if i % hosts == h}
        reshard_write(spill, ex, hosts, mine, d_old, d_new, h)
    got = {}
    for h in range(hosts):
        owned = [d for d in range(d_new) if d % hosts == h]
        cap_new = int(np.bincount(dev_new, minlength=d_new).max())
        got.update(reshard_assemble(spill, hosts, owned, cap_new))
    full = sm.stitch_edge_part(np.stack([old_slices[d]
                                         for d in range(d_old)]), dev_old, m)
    np.testing.assert_array_equal(full, old_full)
    eids = shard_eids(ex, hosts, list(range(d_new)))
    for d in range(d_new):
        sel = np.flatnonzero(dev_new == d)
        np.testing.assert_array_equal(eids[d], sel)
        np.testing.assert_array_equal(got[d][:sel.size], full[sel])
        assert (got[d][sel.size:] == -1).all()


# ---------------------------------------------------------------------------
# the driver's surface: stats, obs, modes left for later, the card default
# ---------------------------------------------------------------------------

def test_finalize_attaches_stats(graph, snapped_run):
    _, res, _ = snapped_run
    assert res.stats == evaluate(graph.edges.numpy(), res.edge_part,
                                 graph.num_vertices, CFG.num_partitions)


def test_driver_traces_spans_and_publishes_live(graph, tmp_path):
    """The obs spans and counters, and the live bus: a round line a round
    and a done line whose quality equals the result's."""
    tr = obs.configure(path=None)
    live.configure(tmp_path / "live", manifest={"run": "test"})
    try:
        with compat.world1("gloo"):
            drv = PartitionDriver(graph, CFG, snapshot_dir=tmp_path / "s",
                                  snapshot_every=4, device="cpu")
            res = drv.run()
            drv.restore_snapshot()
    finally:
        obs.disable()
        live.disable()
    spans = [e["name"] for e in tr.events if e["ev"] == "span"]
    assert spans.count("round") == res.rounds
    assert spans.count("snapshot") == res.rounds // 4
    for name in ("ingest", "finalize", "restore"):
        assert spans.count(name) == 1, name
    counters = {e["name"] for e in tr.events if e["ev"] == "counter"}
    assert {"edges_remaining", "sync_payload_bytes"} <= counters
    snaps = live.load_snapshots(live.host_metrics(tmp_path / "live")[0])
    rounds = [s for s in snaps if s.get("phase") == "round"]
    assert [s["round"] for s in rounds] == list(range(1, res.rounds + 1))
    assert rounds[-1]["edges_remaining"] == 0
    done = snaps[-1]
    assert done["done"] and done["rf"] == res.stats.replication_factor
    assert rounds[-1]["rf"] == pytest.approx(done["rf"], abs=1e-12)


def test_driver_modes_not_in_this_slice_raise(graph, tmp_path):
    with pytest.raises(ValueError, match="unknown mode"):
        PartitionDriver(graph, CFG, mode="nope", device="cpu")
    with pytest.raises(RuntimeError, match="torch.distributed group"):
        PartitionDriver(graph, CFG, device="cpu")
    with compat.world1("gloo"):
        with pytest.raises(ValueError, match="num_devices=2"):
            PartitionDriver(graph, CFG, num_devices=2, device="cpu")


def test_driver_exchange_dir_takes_an_edgefile(graph, tmp_path):
    """A multi-controller run ingests a canonical EdgeFile a block range
    a rank; any other source raises the reference's TypeError."""
    with compat.world1("gloo"):
        with pytest.raises(TypeError, match="canonical EdgeFile"):
            PartitionDriver(graph, CFG, exchange_dir=tmp_path, device="cpu")
    with pytest.raises(TypeError, match="canonical EdgeFile"):
        JDriver(j_rmat(*GRAPH), JCFG, exchange_dir=tmp_path)._init_multihost(
            j_rmat(*GRAPH), JCFG, None, None, tmp_path)


@pytest.mark.parametrize("mode", ["single", "hybrid"])
def test_driver_exchange_dir_needs_spmd_mode(store, tmp_path, mode):
    cfg = HybridConfig(**KW) if mode == "hybrid" else CFG
    with pytest.raises(ValueError, match="multi-controller"):
        PartitionDriver(store, cfg, mode=mode, exchange_dir=tmp_path,
                        device="cpu")


def test_driver_hybrid_mode_takes_a_hybrid_config(graph):
    with pytest.raises(TypeError, match="HybridConfig"):
        PartitionDriver(graph, CFG, mode="hybrid", device="cpu")


def test_driver_hybrid_mode_is_single_controller():
    """In a group of 2 gloo ranks every rank's hybrid driver raises."""
    outs = compat.spawn(torch_spmd_ranks.hybrid_driver_error, 2, "gloo",
                        rmat(*GRAPH, device="cpu").edges.numpy(),
                        HybridConfig(num_partitions=8))
    assert len(outs) == 2
    for name, msg in outs:
        assert name == "ValueError" and "single-controller" in msg


def test_driver_defaults_to_the_card(graph, monkeypatch):
    """``device=None`` means the card in both modes; without one the
    driver raises, with no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = graph.edges.numpy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PartitionDriver(e, CFG, mode="single")
    with compat.world1("gloo"), pytest.raises(RuntimeError,
                                              match="no CUDA device"):
        PartitionDriver(graph, CFG)


# ---------------------------------------------------------------------------
# 2 and 4 ranks: spawned gloo processes against the reference's devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, store, tmp_path_factory):
    d = request.param
    out = tmp_path_factory.mktemp(f"ranks{d}")
    outs = compat.spawn(torch_spmd_ranks.driver_checks, d, "gloo",
                        store.path, CFG, str(out / "snap"), str(out / "art"),
                        7)
    return d, outs, out


def test_driver_across_ranks_matches_reference(ranks, reference_runs):
    d, outs, _ = ranks
    _, ref = reference_runs
    assert len(outs) == d
    for out in outs:           # every rank returns the reference's result
        _same(out["result"], ref[d])


def test_kill_and_resume_across_ranks(ranks):
    """Every rank of a driver resumed from round 7 finishes with the
    uninterrupted run's result."""
    _, outs, _ = ranks
    for out in outs:
        assert out["resumed_from"] == 7
        _same(out["resumed"], outs[0]["result"])


def test_snapshots_and_artifact_across_ranks_byte_identical(ranks,
                                                            reference_runs):
    d, outs, out = ranks
    ref_dir, _ = reference_runs
    rounds = outs[0]["result"].rounds
    assert _same_tree(out / "snap", ref_dir / f"snap{d}") \
        == (2 + d) * rounds
    assert _same_tree(out / "art", ref_dir / f"art{d}") \
        == CFG.num_partitions + 2


def test_elastic_resume_reshards_in_memory(ranks, store):
    """A world-1 driver restores the snapshots the ranks took: at the
    fixed point the values reshard exactly (the same result); mid-run
    a valid complete partition comes out."""
    _, outs, out = ranks
    res = outs[0]["result"]
    with compat.world1("gloo"):
        drv = PartitionDriver.resume(store, CFG, out / "snap", device="cpu")
        assert drv.rounds == res.rounds
        _same(drv.run(), res)
        drv = PartitionDriver.resume(store, CFG, out / "snap", round_k=3,
                                     device="cpu")
        got = drv.run()
    assert (got.edge_part >= 0).all()
    np.testing.assert_array_equal(
        np.bincount(got.edge_part, minlength=CFG.num_partitions),
        got.edges_per_part)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_driver_resume_on_the_card(graph, snapped_run, tmp_path):
    """On the card (world-1 NCCL group): a run snapshotted, killed after
    round k and resumed equals the CPU run bit for bit, in both modes,
    and resumes from the CPU run's snapshot too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, res, snap_dir = snapped_run
    k = res.rounds // 2
    with compat.world1("nccl"):
        PartitionDriver(graph, CFG, snapshot_dir=tmp_path / "s",
                        snapshot_every=k).run()
        for src in (tmp_path / "s", snap_dir):
            drv = PartitionDriver.resume(graph, CFG, src, round_k=k)
            assert drv.state.edge_part.is_cuda
            _same(drv.run(), res)
    card_graph = rmat(*GRAPH)
    single = PartitionDriver(card_graph, CFG, mode="single",
                             snapshot_dir=tmp_path / "t", snapshot_every=k)
    _same(single.run(), res)
    drv = PartitionDriver.resume(card_graph, CFG, tmp_path / "t", round_k=k,
                                 mode="single")
    assert drv.state.edge_part.is_cuda
    _same(drv.run(), res)


if __name__ == "__main__":
    _write_reference_runs(sys.argv[1], sys.argv[2])
