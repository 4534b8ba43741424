"""The port's out-of-core graph store (``repro_torch.io``) against the
reference package's ``repro.io``.

Mirrors tests/test_io.py and tests/test_ingest.py: every file the port
writes (EdgeFile, canonicalized stream, PackedCSR, spilled RMAT, ingested
text) is byte-identical to the one ``repro`` writes from the same input,
each package reads the other's files, graphs built from the store equal
``from_edges`` (and the reference's graph) field for field, and the
partitioner entry points take an EdgeFile with the same result as the
Graph run and as ``repro``'s.  Plus ``repro_torch.io`` importing without
torch.  Graphs at RMAT scale <= 12, P <= 8.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.io as jio
from repro.core import graph as jgraph
from repro.core import partitioner as jp
from repro.dist import partitioner_sm as jsm
from repro.graphs import rmat as jrmat
from repro.io import compress as jcompress
from repro_torch import io as tio
from repro_torch.core import graph as tgraph
from repro_torch.core import partitioner as tp
from repro_torch.dist import compat
from repro_torch.dist import partitioner_sm as sm
from repro_torch.graphs.rmat import rmat_edge_chunks, rmat_edges
from repro_torch.io import compress as tcompress

ROOT = Path(__file__).resolve().parent.parent
SEED = 0
GRAPH_FIELDS = ("edges", "indptr", "adj_dst", "adj_eid", "slot_src",
                "degree")


def random_edges(rng, n, m, dup_heavy=False, loops=True):
    hi = max(n, 1)
    if dup_heavy:                       # tiny id range → mostly duplicates
        hi = max(int(np.sqrt(n)), 2)
    e = rng.integers(0, hi, size=(m, 2))
    if loops and m:
        k = max(m // 10, 1)
        idx = rng.integers(0, m, size=k)
        e[idx, 1] = e[idx, 0]
    return e


def case_edges(case, seed, n, m):
    rng = np.random.default_rng(seed)
    if case == "random":
        return random_edges(rng, n, m)
    if case == "dup_heavy":
        return random_edges(rng, n, m, dup_heavy=True)
    if case == "single":
        return np.array([[5, 3]])
    return np.zeros((0, 2), np.int64)


def graphs_equal(got, want):
    """A port Graph against a port or reference Graph, field and dtype."""
    for f in GRAPH_FIELDS:
        a = getattr(got, f).numpy()
        b = getattr(want, f)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)


def same_bytes(a, b):
    assert Path(a).read_bytes() == Path(b).read_bytes(), (a, b)


def both_read(path, want):
    """Each package reads ``path`` as the edge list ``want``."""
    for pkg in (tio, jio):
        with pkg.EdgeFile(path) as ef:
            np.testing.assert_array_equal(ef.read_all(), want)


# ---------------------------------------------------------------------------
# edgefile
# ---------------------------------------------------------------------------

def test_edgefile_roundtrip_and_seek(tmp_path):
    rng = np.random.default_rng(SEED)
    e = random_edges(rng, 500, 3210)
    ef = tio.write_edgefile(tmp_path / "t.edges", e, num_vertices=500,
                            block_size=1000)
    jio.write_edgefile(tmp_path / "j.edges", e, num_vertices=500,
                       block_size=1000)
    same_bytes(tmp_path / "t.edges", tmp_path / "j.edges")
    assert ef.num_edges == 3210 and ef.num_vertices == 500
    assert ef.num_blocks == 4
    both_read(tmp_path / "j.edges", e)
    both_read(tmp_path / "t.edges", e)
    np.testing.assert_array_equal(ef.block(3), e[3000:])
    np.testing.assert_array_equal(ef.block(1), e[1000:2000])
    for i in range(4):
        blk = e[i * 1000:(i + 1) * 1000]
        assert ef.block_vmin[i] == blk.min()
        assert ef.block_vmax[i] == blk.max()
        assert ef.block_counts[i] == blk.shape[0]


def test_edgefile_chunked_append_matches_single(tmp_path):
    rng = np.random.default_rng(SEED + 1)
    e = random_edges(rng, 100, 777)
    with tio.EdgeFileWriter(tmp_path / "a.edges", block_size=64) as w:
        off = 0
        for k in (0, 1, 63, 64, 65, 200, 777 - 393):   # odd chunk cuts
            w.append(e[off:off + k])
            off += k
        assert off == 777
    jio.write_edgefile(tmp_path / "j.edges", e, block_size=64)
    same_bytes(tmp_path / "a.edges", tmp_path / "j.edges")
    both_read(tmp_path / "a.edges", e)


def test_edgefile_empty(tmp_path):
    ef = tio.write_edgefile(tmp_path / "z.edges", np.zeros((0, 2), np.int64))
    jio.write_edgefile(tmp_path / "j.edges", np.zeros((0, 2), np.int64))
    same_bytes(tmp_path / "z.edges", tmp_path / "j.edges")
    assert ef.num_edges == 0 and ef.num_blocks == 0
    assert ef.read_all().shape == (0, 2)


def test_edgefile_infers_num_vertices(tmp_path):
    e = np.array([[0, 7], [3, 2]])
    ef = tio.write_edgefile(tmp_path / "n.edges", e)
    assert ef.num_vertices == 8
    assert jio.EdgeFile(tmp_path / "n.edges").num_vertices == 8


def test_edgefile_rejects_ids_wider_than_dtype(tmp_path):
    with pytest.raises(ValueError, match="int32"):
        tio.write_edgefile(tmp_path / "w.edges",
                           np.array([[0, 2 ** 31]], np.int64))
    ok = tio.write_edgefile(tmp_path / "ok.edges",
                            np.array([[0, 2 ** 31 - 1]], np.int64))
    assert ok.read_all()[0, 1] == 2 ** 31 - 1
    with pytest.raises(ValueError, match="do not fit"):
        tio.write_edgefile(tmp_path / "u.edges",
                           np.array([[1, 3_000_000_000]], np.uint32))


def test_edgefile_rejects_lying_num_vertices(tmp_path):
    with pytest.raises(ValueError, match="num_vertices"):
        tio.write_edgefile(tmp_path / "lie.edges", np.array([[0, 99]]),
                           num_vertices=3)


def test_graph_from_edgefile_rejects_conflicting_n(tmp_path):
    can, _ = tio.canonicalize_host(np.array([[0, 1], [1, 2]]), 3)
    ef = tio.write_edgefile(tmp_path / "c.edges", can, num_vertices=3,
                            flags=tio.FLAG_CANONICAL)
    with pytest.raises(ValueError, match="conflicts"):
        tio.graph_from_edgefile(ef, num_vertices=10, device="cpu")
    packed = tio.pack_csr(ef, tmp_path / "c.rcsr")
    with pytest.raises(ValueError, match="conflicts"):
        tgraph.as_graph(packed, num_vertices=10, device="cpu")


def test_edgefile_inference_excludes_loop_only_vertices(tmp_path):
    e = np.array([[0, 1], [5, 5]])
    ef = tio.write_edgefile(tmp_path / "l.edges", e)
    assert ef.num_vertices == 2
    graphs_equal(tio.graph_from_edgefile(ef, tmpdir=str(tmp_path),
                                         device="cpu"),
                 tgraph.from_edges(e, device="cpu"))


# ---------------------------------------------------------------------------
# varint / zigzag / delta codec
# ---------------------------------------------------------------------------

def test_varint_fuzz():
    rng = np.random.default_rng(SEED)
    for _ in range(20):
        kind = rng.integers(0, 3)
        size = int(rng.integers(0, 3000))
        if kind == 0:
            x = rng.integers(0, 128, size)                  # 1-byte dense
        elif kind == 1:
            x = rng.integers(-2 ** 62, 2 ** 62, size)       # wide
        else:
            x = rng.integers(-5, 5, size)                   # small signed
        buf = tio.varint_encode(tio.zigzag_encode(x))
        np.testing.assert_array_equal(
            buf, jio.varint_encode(jio.zigzag_encode(x)))
        y = tio.zigzag_decode(tio.varint_decode(buf, x.size))
        np.testing.assert_array_equal(x, y)


def test_varint_extremes():
    x = np.array([0, 1, -1, 127, 128, -128,
                  np.iinfo(np.int64).max, np.iinfo(np.int64).min])
    buf = tio.varint_encode(tio.zigzag_encode(x))
    np.testing.assert_array_equal(
        buf, jio.varint_encode(jio.zigzag_encode(x)))
    np.testing.assert_array_equal(
        tio.zigzag_decode(tio.varint_decode(buf, x.size)), x)


def test_varint_rejects_corrupt():
    with pytest.raises(ValueError):
        tio.varint_decode(np.array([0x80, 0x80], np.uint8), 1)   # no end
    with pytest.raises(ValueError):
        tio.varint_decode(np.array([1, 2], np.uint8), 1)         # extra


def test_delta_rows_roundtrip():
    rng = np.random.default_rng(SEED)
    vals = rng.integers(0, 1000, 257)
    bounds = np.unique(rng.integers(0, 257, 40))
    bounds = np.concatenate([[0], bounds, [257]]).astype(np.int64)
    d = tcompress.delta_encode_rows(vals, bounds)
    np.testing.assert_array_equal(d, jcompress.delta_encode_rows(vals,
                                                                  bounds))
    np.testing.assert_array_equal(tcompress.delta_decode_rows(d, bounds),
                                  vals)


# ---------------------------------------------------------------------------
# out-of-core canonicalization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "dup_heavy", "single", "empty"])
def test_canonicalize_stream_matches_host(tmp_path, case):
    n = 300
    e = case_edges(case, SEED + 2, n, 5000)
    raw = tio.write_edgefile(tmp_path / "raw.edges", e, num_vertices=n,
                             block_size=128)
    # chunk size far smaller than the input → true external-sort dedup
    can = tio.canonicalize_stream(raw, tmp_path / "can.edges",
                                  num_vertices=n, chunk_size=64)
    jio.canonicalize_stream(jio.EdgeFile(tmp_path / "raw.edges"),
                            tmp_path / "j.edges", num_vertices=n,
                            chunk_size=64)
    same_bytes(tmp_path / "can.edges", tmp_path / "j.edges")
    ref, _ = tio.canonicalize_host(e, n)
    np.testing.assert_array_equal(can.read_all(), ref)
    assert can.canonical and can.num_edges == ref.shape[0]


def test_canonicalize_stream_dedups_across_chunks(tmp_path):
    e = np.tile(np.array([[1, 2], [4, 3], [2, 1]]), (50, 1))
    raw = tio.write_edgefile(tmp_path / "raw.edges", e, num_vertices=5,
                             block_size=4)
    can = tio.canonicalize_stream(raw, tmp_path / "can.edges",
                                  num_vertices=5, chunk_size=4)
    np.testing.assert_array_equal(can.read_all(), [[1, 2], [3, 4]])


# ---------------------------------------------------------------------------
# streaming Graph build — bit-identical to from_edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "dup_heavy", "empty", "single"])
def test_stream_graph_bit_identical_random(tmp_path, case):
    n = 200
    e = case_edges(case, SEED + 3, n, 4000)
    raw = tio.write_edgefile(tmp_path / "raw.edges", e, num_vertices=n,
                             block_size=256)
    g = tio.graph_from_edgefile(raw, chunk_size=128, tmpdir=str(tmp_path),
                                device="cpu")
    graphs_equal(g, tgraph.from_edges(e, num_vertices=n, device="cpu"))
    graphs_equal(g, jgraph.from_edges(e, num_vertices=n))


def test_stream_graph_bit_identical_rmat12(tmp_path):
    """Stream-built Graph == from_edges == the reference's, RMAT scale 12,
    built from the file the reference wrote."""
    e = rmat_edges(12, 16, seed=SEED)
    jio.write_edgefile(tmp_path / "raw.edges", e, num_vertices=1 << 12)
    g = tio.graph_from_edgefile(tio.EdgeFile(tmp_path / "raw.edges"),
                                tmpdir=str(tmp_path), device="cpu")
    graphs_equal(g, tgraph.from_edges(e, num_vertices=1 << 12,
                                      device="cpu"))
    graphs_equal(g, jgraph.from_edges(e, num_vertices=1 << 12))


def test_stream_graph_from_chunk_iterator(tmp_path):
    g = tio.graph_from_edgefile(
        rmat_edge_chunks(8, 4, seed=2, chunk_size=100),
        num_vertices=1 << 8, tmpdir=str(tmp_path), device="cpu")
    e = np.concatenate(list(rmat_edge_chunks(8, 4, seed=2, chunk_size=100)))
    graphs_equal(g, tgraph.from_edges(e, num_vertices=1 << 8, device="cpu"))
    with pytest.raises(ValueError, match="num_vertices"):
        tio.graph_from_edgefile(rmat_edge_chunks(8, 4, seed=2),
                                device="cpu")


def test_as_graph_dispatch(tmp_path):
    e = rmat_edges(8, 8, seed=1)
    g_ref = tgraph.from_edges(e, num_vertices=1 << 8, device="cpu")
    raw = tio.write_edgefile(tmp_path / "raw.edges", e, num_vertices=1 << 8)
    graphs_equal(tgraph.as_graph(raw, device="cpu"), g_ref)
    assert tgraph.as_graph(g_ref) is g_ref
    graphs_equal(tgraph.as_graph(e, num_vertices=1 << 8, device="cpu"),
                 g_ref)
    packed = tio.pack_csr(g_ref, tmp_path / "g.rcsr")
    graphs_equal(tgraph.as_graph(packed, device="cpu"), g_ref)
    with pytest.raises(TypeError):
        tgraph.as_graph("not a graph", device="cpu")


def test_store_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """``device=None`` means the card: without one every entry point that
    stages the store on a device raises, with no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    can, n = tio.canonicalize_host(rmat_edges(6, 4, seed=0), 1 << 6)
    ef = tio.write_edgefile(tmp_path / "c.edges", can, num_vertices=n,
                            flags=tio.FLAG_CANONICAL)
    packed = tio.pack_csr(ef, tmp_path / "c.rcsr", rows_per_shard=16)
    for call in (lambda: tio.graph_from_edgefile(ef),
                 lambda: tgraph.as_graph(ef), packed.to_graph,
                 lambda: packed.shard_device(0),
                 lambda: tp.partition(ef, tp.NEConfig(num_partitions=2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# packed CSR container
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows_per_shard", [7, 64, 10_000])
def test_packed_csr_roundtrip(tmp_path, rows_per_shard):
    e = rmat_edges(9, 8, seed=2)
    g = tgraph.from_edges(e, num_vertices=1 << 9, device="cpu")
    packed = tio.pack_csr(g, tmp_path / "g.rcsr",
                          rows_per_shard=rows_per_shard)
    jio.pack_csr(jgraph.from_edges(e, num_vertices=1 << 9),
                 tmp_path / "j.rcsr", rows_per_shard=rows_per_shard)
    same_bytes(tmp_path / "g.rcsr", tmp_path / "j.rcsr")
    graphs_equal(packed.to_graph(device="cpu"), g)
    graphs_equal(tio.PackedCSR(tmp_path / "j.rcsr").to_graph(device="cpu"),
                 jio.PackedCSR(tmp_path / "g.rcsr").to_graph())


def test_packed_csr_from_edgefile_stream(tmp_path):
    e = rmat_edges(10, 8, seed=3)
    raw = tio.write_edgefile(tmp_path / "raw.edges", e, num_vertices=1 << 10)
    can = tio.canonicalize_stream(raw, tmp_path / "can.edges",
                                  chunk_size=1000)
    packed = tio.pack_csr(can, tmp_path / "g.rcsr", rows_per_shard=100,
                          chunk_size=500)
    jio.pack_csr(jio.EdgeFile(tmp_path / "can.edges"), tmp_path / "j.rcsr",
                 rows_per_shard=100, chunk_size=500)
    same_bytes(tmp_path / "g.rcsr", tmp_path / "j.rcsr")
    graphs_equal(packed.to_graph(device="cpu"),
                 tgraph.from_edges(e, num_vertices=1 << 10, device="cpu"))


def test_packed_csr_lazy_row_and_shard_device(tmp_path):
    g = tgraph.from_edges(rmat_edges(9, 8, seed=4), num_vertices=1 << 9,
                          device="cpu")
    packed = tio.pack_csr(g, tmp_path / "g.rcsr", rows_per_shard=32)
    indptr = g.indptr.numpy()
    dst_ref = g.adj_dst.numpy()
    for v in (0, 31, 32, 100, (1 << 9) - 1):
        dst, _ = packed.row(v)
        np.testing.assert_array_equal(dst, dst_ref[indptr[v]:indptr[v + 1]])
    for s in (0, 5, packed.num_shards - 1):
        got = packed.shard_device(s, device="cpu")
        for t, a in zip(got, packed.shard(s)):
            assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), a)


def test_packed_csr_compresses(tmp_path):
    g = tgraph.from_edges(rmat_edges(12, 16, seed=5), num_vertices=1 << 12,
                          device="cpu")
    tio.pack_csr(g, tmp_path / "g.rcsr")
    raw_bytes = 2 * g.adj_dst.shape[0] * 4          # adj_dst + adj_eid int32
    disk = os.path.getsize(tmp_path / "g.rcsr")
    assert disk < 0.75 * raw_bytes, (disk, raw_bytes)


def test_packed_csr_empty(tmp_path):
    g = tgraph.from_edges(np.zeros((0, 2), np.int64), num_vertices=10,
                          device="cpu")
    packed = tio.pack_csr(g, tmp_path / "g.rcsr", rows_per_shard=4)
    graphs_equal(packed.to_graph(device="cpu"), g)


def test_packed_csr_writer_context_manager_finalizes(tmp_path):
    g = tgraph.from_edges(rmat_edges(8, 8, seed=6), num_vertices=1 << 8,
                          device="cpu")
    with tio.PackedCSRWriter(tmp_path / "g.rcsr", g.indptr.numpy(),
                             g.num_edges) as w:
        w.append_slots(g.adj_dst.numpy(), g.adj_eid.numpy())
    graphs_equal(tio.PackedCSR(tmp_path / "g.rcsr").to_graph(device="cpu"),
                 g)


def test_packed_csr_rejects_non_canonical_graph(tmp_path):
    g = tgraph.from_edges(np.array([[3, 1], [2, 2], [0, 4]]), num_vertices=5,
                          device="cpu", dedup=False)
    with pytest.raises(ValueError, match="canonical"):
        tio.pack_csr(g, tmp_path / "g.rcsr")


# ---------------------------------------------------------------------------
# spillable RMAT
# ---------------------------------------------------------------------------

def test_spill_rmat_matches_chunked_generator(tmp_path):
    ef = tio.spill_rmat(tmp_path / "r.edges", 10, 8, seed=7,
                        chunk_size=1000)
    jio.spill_rmat(tmp_path / "j.edges", 10, 8, seed=7, chunk_size=1000)
    same_bytes(tmp_path / "r.edges", tmp_path / "j.edges")
    ref = np.concatenate(list(rmat_edge_chunks(10, 8, seed=7,
                                               chunk_size=1000)))
    np.testing.assert_array_equal(ref, np.concatenate(list(
        jrmat.rmat_edge_chunks(10, 8, seed=7, chunk_size=1000))))
    assert ef.num_edges == (1 << 10) * 8
    np.testing.assert_array_equal(ef.read_all(), ref)


def test_spill_rmat_deterministic(tmp_path):
    a = tio.spill_rmat(tmp_path / "a.edges", 9, 8, seed=11, chunk_size=500)
    b = tio.spill_rmat(tmp_path / "b.edges", 9, 8, seed=11, chunk_size=500)
    np.testing.assert_array_equal(a.read_all(), b.read_all())


def test_rmat_edges_int32_when_small():
    assert rmat_edges(8, 4, seed=0).dtype == np.int32
    assert next(rmat_edge_chunks(8, 4, seed=0)).dtype == np.int32


def test_spill_canonical_rmat_partitions(tmp_path):
    can = tio.spill_canonical_rmat(tmp_path / "t", 9, 8, seed=1,
                                   chunk_size=700)
    jio.spill_canonical_rmat(tmp_path / "j", 9, 8, seed=1, chunk_size=700)
    same_bytes(tmp_path / "t" / "canonical.edges",
               tmp_path / "j" / "canonical.edges")
    assert can.canonical
    kw = dict(num_partitions=4, seed=0)
    res = tp.partition(can, tp.NEConfig(**kw), device="cpu")
    assert (res.edge_part >= 0).all()
    assert res.edge_part.shape == (can.num_edges,)
    want = jp.partition(jio.EdgeFile(tmp_path / "j" / "canonical.edges"),
                        jp.NEConfig(use_pallas=False, **kw))
    np.testing.assert_array_equal(res.edge_part, want.edge_part)
    np.testing.assert_array_equal(res.vparts, want.vparts)


# ---------------------------------------------------------------------------
# host hash + streaming shards + the partitioners' store front doors
# ---------------------------------------------------------------------------

def test_grid_assign_host_matches_device():
    e = rmat_edges(10, 8, seed=3)
    for d in (1, 2, 3, 4, 8, 12):        # 1, 2, 3: a grid side of 1
        host = tio.grid_assign_host(e, d, salt=1)
        dev = tgraph.grid_assign(torch.from_numpy(e), d, salt=1).numpy()
        np.testing.assert_array_equal(host, dev)
        np.testing.assert_array_equal(host, jio.grid_assign_host(e, d,
                                                                 salt=1))


@pytest.mark.parametrize("d", [1, 3, 8])
def test_shard_edges_stream_matches_inmemory(tmp_path, d):
    can, n = tio.canonicalize_host(rmat_edges(10, 8, seed=3), 1 << 10)
    ef = tio.write_edgefile(tmp_path / "c.edges", can, num_vertices=n,
                            block_size=512, flags=tio.FLAG_CANONICAL)
    s_ref, m_ref, cap_ref, dev_ref = tgraph.shard_edges(can, d)
    got = tio.shard_edges_stream(ef, d, with_edges=True)
    want = jio.shard_edges_stream(jio.EdgeFile(tmp_path / "c.edges"), d,
                                  with_edges=True)
    assert got[2] == cap_ref == want[2]
    for a, b, c in zip((s_ref, m_ref, dev_ref, can), got[:2] + got[3:],
                       want[:2] + want[3:]):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)
        assert b.dtype == c.dtype


def _canonical_file(tmp_path, scale, seed, block_size):
    can, n = tio.canonicalize_host(rmat_edges(scale, 8, seed=seed),
                                   1 << scale)
    return tio.write_edgefile(tmp_path / "c.edges", can, num_vertices=n,
                              block_size=block_size,
                              flags=tio.FLAG_CANONICAL), can, n


def _same_result(got, want):
    for f in ("edge_part", "vparts", "edges_per_part"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.rounds, got.leftover) == (want.rounds, want.leftover)


def test_partition_from_edgefile(tmp_path):
    ef, can, n = _canonical_file(tmp_path, 9, 5, 300)
    kw = dict(num_partitions=4, seed=0)
    res_file = tp.partition(ef, tp.NEConfig(**kw), device="cpu")
    res_mem = tp.partition(tgraph.from_edges(can, n, device="cpu"),
                           tp.NEConfig(**kw))
    _same_result(res_file, res_mem)
    _same_result(res_file, jp.partition(jio.EdgeFile(ef.path),
                                        jp.NEConfig(use_pallas=False, **kw)))


def test_partition_spmd_from_edgefile(tmp_path):
    ef, can, n = _canonical_file(tmp_path, 9, 5, 300)
    kw = dict(num_partitions=4, seed=0)
    with compat.world1("gloo"):
        res_file = sm.partition_spmd(ef, tp.NEConfig(**kw), device="cpu")
        res_mem = sm.partition_spmd(tgraph.from_edges(can, n, device="cpu"),
                                    tp.NEConfig(**kw), device="cpu")
    _same_result(res_file, res_mem)
    _same_result(res_file, jsm.partition_spmd(
        jio.EdgeFile(ef.path), jp.NEConfig(use_pallas=True, **kw)))


def test_partition_spmd_rejects_raw_edgefile(tmp_path):
    raw = tio.write_edgefile(tmp_path / "raw.edges", rmat_edges(8, 4),
                             num_vertices=1 << 8)
    with compat.world1("gloo"), pytest.raises(ValueError,
                                              match="not canonical"):
        sm.partition_spmd(raw, tp.NEConfig(num_partitions=4), device="cpu")


def test_io_importable_without_torch(tmp_path):
    """The store imports and runs with neither torch nor jax loaded."""
    code = (
        "import sys\n"
        "import repro_torch.io as rio\n"
        "from repro_torch.graphs.rmat import rmat_edges\n"
        f"ef = rio.spill_rmat({str(tmp_path / 'r.edges')!r}, 8, 4, seed=0)\n"
        f"can = rio.canonicalize_stream(ef, "
        f"{str(tmp_path / 'c.edges')!r})\n"
        f"rio.pack_csr(can, {str(tmp_path / 'g.rcsr')!r})\n"
        "rio.shard_edges_stream(can, 4)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'repro')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLEAN" in out.stdout


# ---------------------------------------------------------------------------
# text ingest (mirrors tests/test_ingest.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".txt", ".txt.gz"])
def test_ingest_roundtrip_matches_canonicalize(tmp_path, suffix):
    e = tgraph.from_edges(rmat_edges(10, 8, seed=7), 1 << 10,
                          device="cpu").edges.numpy()
    src = tmp_path / f"g{suffix}"
    tio.dump_text(e, src, header="roundtrip — edge list")
    jsrc = tmp_path / f"j{suffix}"
    jio.dump_text(e, jsrc, header="roundtrip — edge list")
    if suffix == ".txt":            # gzip stamps the file name and time
        same_bytes(src, jsrc)
    ef = tio.ingest_text(src, tmp_path / "a.edges", tmpdir=str(tmp_path))
    jio.ingest_text(jsrc, tmp_path / "j.edges", tmpdir=str(tmp_path))
    same_bytes(tmp_path / "a.edges", tmp_path / "j.edges")
    ref = tio.canonicalize_stream(e, tmp_path / "b.edges",
                                  num_vertices=1 << 10,
                                  tmpdir=str(tmp_path))
    assert ef.num_vertices == ref.num_vertices
    assert ef.num_edges == ref.num_edges
    np.testing.assert_array_equal(ef.read_all(), ref.read_all())


def test_ingest_dedup_loops_comments_extra_columns(tmp_path):
    src = tmp_path / "messy.txt"
    src.write_text(
        "# SNAP header\n"
        "% KONECT header\n"
        "\n"
        "1 2\n"
        "2\t1\n"          # directed duplicate — dedups with the above
        "3 3\n"           # self loop — dropped
        "0 2 17 1970\n"   # extra columns (weight, timestamp) ignored
        "1 2\n")          # exact duplicate
    ef = tio.ingest_text(src, tmp_path / "messy.edges", tmpdir=str(tmp_path))
    assert ef.num_vertices == 3
    np.testing.assert_array_equal(ef.read_all(), [[0, 2], [1, 2]])
    jio.ingest_text(src, tmp_path / "j.edges", tmpdir=str(tmp_path))
    same_bytes(tmp_path / "messy.edges", tmp_path / "j.edges")


def test_ingest_iter_chunks_and_gz(tmp_path):
    import gzip

    src = tmp_path / "e.txt.gz"
    lines = "".join(f"{i} {i + 1}\n" for i in range(10))
    with gzip.open(src, "wt") as f:
        f.write(lines)
    chunks = list(tio.iter_text_edges(src, chunk_size=4))
    assert [len(c) for c in chunks] == [4, 4, 2]
    np.testing.assert_array_equal(
        np.concatenate(chunks),
        np.stack([np.arange(10), np.arange(1, 11)], axis=1))


@pytest.mark.parametrize("bad, msg", [
    ("1 2\n7\n", "expected 'src dst'"),
    ("1 2\na b\n", "non-integer"),
])
def test_ingest_malformed_raises_with_lineno(tmp_path, bad, msg):
    src = tmp_path / "bad.txt"
    src.write_text(bad)
    with pytest.raises(ValueError, match=msg) as exc:
        list(tio.iter_text_edges(src))
    assert ":2:" in str(exc.value)


def test_ingest_explicit_num_vertices_skips_inference(tmp_path):
    src = tmp_path / "e.txt"
    src.write_text("0 1\n1 2\n")
    ef = tio.ingest_text(src, tmp_path / "e.edges", num_vertices=100,
                         tmpdir=str(tmp_path))
    assert ef.num_vertices == 100
    assert ef.num_edges == 2
