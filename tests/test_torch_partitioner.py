"""The port's single-controller partitioner against the reference package.

Graphs, one round from a carried-over state, and whole runs must equal
the reference's to the last bit: ``edge_part``, ``vparts``,
``edges_per_part``, ``rounds``, ``leftover`` and the stats.  Plus the
port's import hygiene: it imports neither jax nor anything of ``repro``.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import partitioner as jp
from repro.core.epilogue import alpha_limit as j_alpha_limit
from repro.core.metrics import evaluate as j_evaluate
from repro.graphs.rmat import rmat as j_rmat
from repro.graphs.rmat import rmat_edges as j_rmat_edges
from repro_torch.core import graph as tgraph
from repro_torch.core import partitioner as tp
from repro_torch.core.epilogue import alpha_limit
from repro_torch.core.metrics import evaluate, theorem1_upper_bound
from repro_torch.graphs.rmat import rmat, rmat_edges

ROOT = Path(__file__).resolve().parent.parent


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.edge_part, np.asarray(want.edge_part))
    np.testing.assert_array_equal(got.vparts, np.asarray(want.vparts))
    np.testing.assert_array_equal(got.edges_per_part,
                                  np.asarray(want.edges_per_part))
    assert got.rounds == want.rounds
    assert got.leftover == want.leftover
    assert dataclasses.astuple(got.stats) == dataclasses.astuple(want.stats)


# --------------------------------------------------------------------------
# graphs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale,ef,seed", [(6, 4, 0), (10, 8, 3), (12, 16, 1)])
def test_rmat_edges_equal(scale, ef, seed):
    np.testing.assert_array_equal(rmat_edges(scale, ef, seed),
                                  j_rmat_edges(scale, ef, seed))


@pytest.mark.parametrize("n,m,seed", [(30, 100, 0), (500, 4000, 1),
                                      (64, 0, 2)])
def test_from_edges_equal(n, m, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2))     # loops and duplicates included
    want = jgraph.from_edges(e, n)
    got = tgraph.from_edges(e, n, device="cpu")
    for f in ("edges", "indptr", "adj_dst", "adj_eid", "slot_src",
              "degree"):
        w = np.asarray(getattr(want, f))
        t = getattr(got, f)
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), w, err_msg=f)
    assert got.num_vertices == want.num_vertices
    assert got.num_edges == want.num_edges
    assert tgraph.as_graph(got) is got


_GRAPH_FIELDS = ("edges", "indptr", "adj_dst", "adj_eid", "slot_src",
                 "degree")


def _edge_case(kind):
    """(edges, num_vertices) of one input shape for the graph builders."""
    rng = np.random.default_rng(7)
    if kind == "rmat":
        return rmat_edges(10, 8, 3), 1 << 10
    if kind == "random":         # loops and duplicates included
        return rng.integers(0, 300, size=(5000, 2)), 300
    if kind == "random_int32_n_inferred":
        return rng.integers(0, 50, size=(400, 2)).astype(np.int32), None
    if kind == "isolated_tail":  # vertices past the last id
        return rng.integers(0, 40, size=(200, 2)), 64
    if kind == "loops_only":
        return np.array([[3, 3], [5, 5]]), None
    return np.zeros((0, 2), np.int64), 16          # empty


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("kind", ["rmat", "random",
                                  "random_int32_n_inferred", "isolated_tail",
                                  "loops_only", "empty"])
def test_tensor_graph_build_equal(kind, dedup):
    """``graph_from_edges_tensor`` (what ``from_edges`` runs for the card)
    gives the host build's Graph and the reference's, bit for bit."""
    e, n = _edge_case(kind)
    got = tgraph.graph_from_edges_tensor(torch.from_numpy(e), n, dedup)
    host = tgraph.from_edges(e, n, device="cpu", dedup=dedup)
    want = jgraph.from_edges(e, n, dedup=dedup)
    for f in _GRAPH_FIELDS:
        t = getattr(got, f)
        assert t.dtype == torch.int32 and t.device.type == "cpu", f
        np.testing.assert_array_equal(t.numpy(), getattr(host, f).numpy(),
                                      err_msg=f)
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.num_vertices, got.num_edges) == (want.num_vertices,
                                                 want.num_edges)


def test_exclusive_rank_equal():
    rng = np.random.default_rng(0)
    cand = rng.integers(-1, 7, 3000).astype(np.int32)
    want = jgraph.exclusive_rank(jax.numpy.asarray(cand), 7)
    got = tgraph.exclusive_rank(torch.from_numpy(cand), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_card_is_the_default_device():
    """``device=None`` means the card; without one it raises."""
    if torch.cuda.is_available():
        assert tgraph.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tgraph.from_edges(np.array([[0, 1]]), 2)


# --------------------------------------------------------------------------
# one round from a carried-over state
# --------------------------------------------------------------------------

def _jax_state_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in jp.NEState._fields}


@pytest.mark.parametrize("k", [0, 3])
def test_round_from_carried_state(k):
    jg = j_rmat(10, 8, seed=5)
    cfg_kw = dict(num_partitions=8, seed=2, k_sel=64, edge_chunk=1 << 11)
    jcfg = jp.NEConfig(use_pallas=True, **cfg_kw).clamped(jg.num_vertices)
    limit = j_alpha_limit(jcfg.alpha, jg.num_edges, jcfg.num_partitions)
    st = jp.ne_init_state(jg, jcfg)
    for _ in range(k):
        st = jp.ne_round_step(jg, jcfg, limit, st)
    arrays = _jax_state_numpy(st)
    want = _jax_state_numpy(jp.ne_round_step(jg, jcfg, limit, st))

    tg = rmat(10, 8, seed=5, device="cpu")
    tcfg = tp.NEConfig(**cfg_kw).clamped(tg.num_vertices)
    assert alpha_limit(tcfg.alpha, tg.num_edges, 8) == limit
    tstate = tp.state_from_numpy(arrays, device="cpu")
    for f, a in tp.state_to_numpy(tstate).items():      # the carry is exact
        np.testing.assert_array_equal(a, arrays[f], err_msg=f)
        assert (a.dtype, a.shape) == (arrays[f].dtype, arrays[f].shape), f
    got = tp.state_to_numpy(tp.ne_round_step(tg, tcfg, limit, tstate))
    for f in jp.NEState._fields:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert (want["edge_part"] >= 0).sum() > (arrays["edge_part"] >= 0).sum()


# --------------------------------------------------------------------------
# the whole slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("two_hop", [True, False])
@pytest.mark.parametrize("p", [4, 8])
def test_partition_bit_identical_scale10_pallas(p, two_hop):
    kw = dict(num_partitions=p, two_hop=two_hop, seed=1)
    want = jp.partition(j_rmat(10, 8, seed=13),
                        jp.NEConfig(use_pallas=True, **kw))
    got = tp.partition(rmat(10, 8, seed=13, device="cpu"), tp.NEConfig(**kw))
    _assert_same_result(got, want)
    assert got.leftover == 0 and (got.edge_part >= 0).all()


@pytest.mark.parametrize("two_hop", [True, False])
def test_partition_bit_identical_scale12_chunked(two_hop):
    """Small edge_chunk and k_sel: several two-hop chunks carry the quota
    and selection is capped, against the reference's XLA path."""
    kw = dict(num_partitions=16, two_hop=two_hop, k_sel=32,
              edge_chunk=1 << 12, seed=0)
    want = jp.partition(j_rmat(12, 8, seed=2),
                        jp.NEConfig(use_pallas=False, **kw))
    got = tp.partition(rmat(12, 8, seed=2, device="cpu"), tp.NEConfig(**kw))
    _assert_same_result(got, want)


def test_partition_leftover_epilogue_identical():
    """A max_rounds cut leaves edges for the water-fill epilogue."""
    kw = dict(num_partitions=8, max_rounds=3, seed=4)
    want = jp.partition(j_rmat(10, 8, seed=1),
                        jp.NEConfig(use_pallas=False, **kw))
    got = tp.partition(rmat(10, 8, seed=1, device="cpu"), tp.NEConfig(**kw))
    _assert_same_result(got, want)
    assert got.leftover > 0 and got.rounds == 3


def test_partition_quality_invariants():
    edges = rmat_edges(11, 8, seed=7)
    g = tgraph.from_edges(edges, 1 << 11, device="cpu")
    cfg = tp.NEConfig(num_partitions=8)
    res = tp.partition(g, cfg)
    e = g.edges.numpy()
    assert (res.edge_part >= 0).all()
    np.testing.assert_array_equal(res.edges_per_part,
                                  np.bincount(res.edge_part, minlength=8))
    assert res.edges_per_part.max() <= alpha_limit(1.1, len(e), 8) + 1
    st = evaluate(e, res.edge_part, g.num_vertices, 8)
    assert st == res.stats
    assert dataclasses.astuple(st) == dataclasses.astuple(
        j_evaluate(e, res.edge_part, g.num_vertices, 8))
    assert st.replication_factor <= theorem1_upper_bound(
        g.num_vertices, len(e), 8)
    # an edge ndarray goes through as_graph on the asked device
    again = tp.partition(edges, cfg, device="cpu")
    np.testing.assert_array_equal(again.edge_part, res.edge_part)


# --------------------------------------------------------------------------
# import hygiene
# --------------------------------------------------------------------------

def test_port_imports_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch.core.partitioner, repro_torch.graphs.rmat\n"
        "import repro_torch.kernels.build\n"
        "import repro_torch.dist.compat, repro_torch.dist.partitioner_sm\n"
        "import repro_torch.launch.gnn_engine, repro_torch.apps.engine\n"
        "import repro_torch.kernels.block_spmm.ops\n"
        "import repro_torch.tools.block_csr_tiles\n"
        "import repro_torch.models.gnn.gin, repro_torch.train.optimizer\n"
        "import repro_torch.configs.gin_tu, repro_torch.configs.shapes\n"
        "import repro_torch.graphs.generators\n"
        "import repro_torch.kernels.embedding_bag.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.models.recsys.embedding\n"
        "import repro_torch.models.recsys.deepfm\n"
        "import repro_torch.models.lm.transformer\n"
        "import repro_torch.models.lm.serve\n"
        "import repro_torch.configs.deepfm, repro_torch.configs.smollm_135m\n"
        "import repro_torch.launch.steps\n"
        "import repro_torch.io, repro_torch.io.atomicdir\n"
        "import repro_torch.io.compress, repro_torch.io.edgefile\n"
        "import repro_torch.io.stream, repro_torch.io.ingest\n"
        "import repro_torch.io.spill\n"
        "import repro_torch.obs, repro_torch.obs.rss, repro_torch.obs.trace\n"
        "import repro_torch.obs.live, repro_torch.train.checkpoint\n"
        "import repro_torch.runtime, repro_torch.runtime.cluster\n"
        "import repro_torch.runtime.artifact, repro_torch.runtime.snapshot\n"
        "import repro_torch.runtime.driver\n"
        "import repro_torch.core.baselines, repro_torch.core.hybrid\n"
        "import repro_torch.core.theory, repro_torch.core.sequential_ne\n"
        "import repro_torch.kernels.stream.ops\n"
        "import repro_torch.kernels.stream.ref\n"
        "import repro_torch.tools.quality\n"
        "import repro_torch.apps.algorithms, repro_torch.dist.redistribute\n"
        "import repro_torch.models.gnn.pna, repro_torch.models.gnn.egnn\n"
        "import repro_torch.models.gnn.wigner\n"
        "import repro_torch.models.gnn.equiformer_v2\n"
        "import repro_torch.configs.pna, repro_torch.configs.egnn\n"
        "import repro_torch.configs.equiformer_v2\n"
        "import repro_torch.tools.step_time\n"
        "import repro_torch.tools.bag_backward_profile\n"
        "import repro_torch.configs.registry, repro_torch.configs.qwen3_0_6b\n"
        "import repro_torch.configs.deepseek_67b, repro_torch.launch.train\n"
        "import repro_torch.train.trainer, repro_torch.train.compression\n"
        "import repro_torch.graphs.sampler, repro_torch.tree\n"
        "import repro_torch.models.lm.moe, repro_torch.configs.olmoe_1b_7b\n"
        "import repro_torch.configs.kimi_k2_1t_a32b\n"
        "import repro_torch.runtime.finalize, repro_torch.runtime.multihost\n"
        "import repro_torch.obs.export, repro_torch.obs.report\n"
        "import repro_torch.obs.monitor, repro_torch.tools.launch_multihost\n"
        "import repro_torch.tools.monitor_run, repro_torch.tools.report_run\n"
        "import repro_torch.serve, repro_torch.serve.cache\n"
        "import repro_torch.serve.batch, repro_torch.serve.store\n"
        "import repro_torch.serve.service, repro_torch.serve.server\n"
        "import repro_torch.serve.gang\n"
        "import repro_torch.dist.context, repro_torch.dist.sharding\n"
        "import repro_torch.launch.mesh\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "CLEAN" in proc.stdout


def test_serving_host_imports_no_torch_no_jax_no_repro():
    """A gang member starts without torch: ``repro_torch.serve.server``
    and ``repro_torch.serve.gang`` load numpy and the standard library,
    never torch, jax or anything of ``repro``."""
    code = (
        "import sys\n"
        "import repro_torch.serve.server, repro_torch.serve.gang\n"
        "import repro_torch.serve\n"
        "repro_torch.serve.GangClient, repro_torch.serve.ShardStore\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'repro')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "CLEAN" in proc.stdout


def test_port_sources_name_no_jax_and_no_repro():
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    for mod in ("dist/context.py", "dist/sharding.py", "launch/mesh.py",
                "dist/partitioner_sm.py", "launch/gnn_engine.py",
                "kernels/block_spmm/ops.py", "apps/engine.py",
                "models/gnn/gin.py", "train/optimizer.py",
                "kernels/embedding_bag/ops.py",
                "kernels/flash_attention/ops.py",
                "models/recsys/embedding.py", "models/recsys/deepfm.py",
                "models/lm/transformer.py", "models/lm/serve.py",
                "configs/deepfm.py", "configs/smollm_135m.py",
                "launch/steps.py", "io/__init__.py", "io/atomicdir.py",
                "io/compress.py", "io/edgefile.py", "io/stream.py",
                "io/ingest.py", "io/spill.py", "obs/__init__.py",
                "obs/rss.py", "obs/trace.py", "obs/live.py",
                "train/checkpoint.py", "runtime/__init__.py",
                "runtime/cluster.py", "runtime/artifact.py",
                "runtime/snapshot.py", "runtime/driver.py",
                "core/baselines.py", "core/hybrid.py", "core/theory.py",
                "core/sequential_ne.py", "kernels/stream/__init__.py",
                "kernels/stream/ops.py", "kernels/stream/ref.py",
                "tools/quality.py", "apps/algorithms.py",
                "dist/redistribute.py", "core/metrics.py",
                "graphs/generators.py", "models/gnn/pna.py",
                "models/gnn/egnn.py", "models/gnn/wigner.py",
                "models/gnn/equiformer_v2.py", "configs/pna.py",
                "configs/egnn.py", "configs/equiformer_v2.py",
                "tools/step_time.py", "tools/bag_backward_profile.py",
                "models/lm/moe.py", "configs/olmoe_1b_7b.py",
                "configs/kimi_k2_1t_a32b.py", "runtime/finalize.py",
                "runtime/multihost.py", "obs/export.py", "obs/report.py",
                "obs/monitor.py", "tools/launch_multihost.py",
                "tools/monitor_run.py", "tools/report_run.py",
                "serve/__init__.py", "serve/cache.py", "serve/batch.py",
                "serve/store.py", "serve/service.py", "serve/server.py",
                "serve/gang.py"):
        assert ROOT / "src" / "repro_torch" / mod in files
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_spmd_ranks.py"]
    assert len(files) > 25
    for f in files:
        hits = bad.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"
