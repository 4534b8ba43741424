"""The port's SPMD partitioner against the reference package.

The 2D-hash sharding, whole runs, rounds from a carried-over state, the
quality gauges and the OR all-reduce must equal the reference's to the
last bit.  World 1 runs in this process (a gloo group); the reference at
2, 3 and 4 devices runs in a subprocess with forced host devices (this
file run as a script, started with the module's first test so that it
runs while the world-1 tests do), and the port's 2, 3 and 4 ranks in
gloo processes (``repro_torch.dist.compat.spawn``, rank bodies in
``torch_spmd_ranks``).

    python tests/test_torch_spmd.py OUT.pkl  # write the multi-device reference
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_ranks
from repro.core import graph as jgraph
from repro.core import partitioner as jp
from repro.core.epilogue import alpha_limit as j_alpha_limit
from repro.dist import compat as jcompat
from repro.dist import partitioner_sm as jsm
from repro.graphs.rmat import rmat as j_rmat
from repro.io import csr as jcsr
from repro.kernels.ne_round import ref as jref
from repro_torch.core import graph as tgraph
from repro_torch.core import partitioner as tp
from repro_torch.dist import compat
from repro_torch.dist import partitioner_sm as sm
from repro_torch.graphs.rmat import rmat
from repro_torch.io import csr as tcsr
from repro_torch.kernels.ne_round import ref

ROOT = Path(__file__).resolve().parent.parent
GRAPH = (10, 8, 13)                            # RMAT scale, edge factor, seed
KW = dict(num_partitions=37, edge_chunk=1 << 9, seed=1)
CARRY_ROUNDS, STEPS = 3, 2
WORLDS = (2, 3, 4)


def _result(res) -> dict:
    return {"edge_part": np.asarray(res.edge_part),
            "vparts": np.asarray(res.vparts),
            "edges_per_part": np.asarray(res.edges_per_part),
            "rounds": res.rounds, "leftover": res.leftover,
            "stats": dataclasses.astuple(res.stats)}


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for f, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(w),
                                      err_msg=f)


def _jax_state(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in jsm.SpmdState._fields}


def _jax_states(d: int, jcfg, rounds_at):
    """The reference's SpmdState (numpy) after each round count in
    ``rounds_at``, stepping ``spmd_round_step`` on a ``d``-device mesh."""
    jg = j_rmat(*GRAPH)
    n = jg.num_vertices
    shards, masks, _, _ = jgraph.shard_edges(np.asarray(jg.edges), d)
    mesh = jcompat.make_mesh((d,), (jsm.AXIS,), devices=jax.devices()[:d])
    limit = j_alpha_limit(jcfg.alpha, jg.num_edges, jcfg.num_partitions)
    args = (jnp.asarray(shards[:, :, 0]), jnp.asarray(shards[:, :, 1]),
            jnp.asarray(masks))
    st = jsm.spmd_init_state(shards, masks, n, jcfg)
    out = {}
    for r in range(max(rounds_at) + 1):
        if r in rounds_at:
            out[r] = _jax_state(st)
        st = jsm.spmd_round_step(jcfg, limit, n, mesh, *args, st)
    return out


def _write_multi_device_reference(path: str) -> None:
    """The reference at 2, 3 and 4 devices: a whole ``partition_spmd``
    run on its bool path (it pins its packed path equal to it) and the
    packed round states the carried-state test starts and ends at."""
    assert len(jax.devices()) >= max(WORLDS), jax.devices()
    jg = j_rmat(*GRAPH)
    out = {}
    for d in WORLDS:
        res = jsm.partition_spmd(jg, jp.NEConfig(use_pallas=False, **KW),
                                 num_devices=d)
        jcfg = jp.NEConfig(use_pallas=True, **KW)
        states = _jax_states(d, jcfg.clamped(jg.num_vertices),
                             (CARRY_ROUNDS, CARRY_ROUNDS + STEPS))
        out[d] = {"result": _result(res), "carried": states[CARRY_ROUNDS],
                  "after": states[CARRY_ROUNDS + STEPS]}
    with open(path, "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# 2D-hash sharding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("salt", [0, 1, 7, 12345])
def test_hash_u32_matches_reference(salt):
    rng = np.random.default_rng(salt)
    x = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    x[:4] = [0, -1, 2**31 - 1, -2**31]
    want = np.asarray(jgraph.hash_u32(jnp.asarray(x), salt)).astype(np.int64)
    got = tgraph.hash_u32(torch.from_numpy(x), salt)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tcsr.hash_u32_host(x, salt),
                                  jcsr.hash_u32_host(x, salt))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_shard_edges_match_reference(d):
    edges = np.array(j_rmat(9, 8, seed=d).edges)  # writable, for torch
    want = np.asarray(jgraph.grid_assign(jnp.asarray(edges), d))
    got = tgraph.grid_assign(torch.from_numpy(edges), d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tcsr.grid_assign_host(edges, d), want)
    got_sh = tgraph.shard_edges(edges, d)
    want_sh = jgraph.shard_edges(edges, d)
    assert got_sh[2] == want_sh[2]
    for a, b in zip(got_sh[:2] + got_sh[3:], want_sh[:2] + want_sh[3:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# world 1, in this process
# --------------------------------------------------------------------------

def test_partition_spmd_world1_matches_reference_and_single_controller():
    """Against the reference's bool path here (it pins its packed path
    equal to it); the multi-device cases below take the packed path."""
    want = _result(jsm.partition_spmd(
        j_rmat(*GRAPH), jp.NEConfig(use_pallas=False, **KW), num_devices=1))
    g = rmat(*GRAPH, device="cpu")
    with compat.world1("gloo"):
        assert compat.process_env() == (0, 1)
        got = sm.partition_spmd(g, tp.NEConfig(**KW), device="cpu")
    _assert_same(_result(got), want)
    _assert_same(_result(tp.partition(g, tp.NEConfig(**KW))), want)
    assert got.leftover == 0 and (got.edge_part >= 0).all()


def test_partition_spmd_needs_a_group_and_a_graph():
    g = rmat(6, 4, seed=0, device="cpu")
    assert compat.process_env() == (0, 1)
    with pytest.raises(RuntimeError):
        sm.partition_spmd(g, tp.NEConfig(num_partitions=4), device="cpu")
    with compat.world1("gloo"), pytest.raises(TypeError):
        sm.partition_spmd(g.edges.numpy(), tp.NEConfig(num_partitions=4),
                          device="cpu")


@pytest.fixture(scope="module")
def world1_states():
    jcfg = jp.NEConfig(use_pallas=True, **KW).clamped(1 << GRAPH[0])
    rounds = (0, STEPS, CARRY_ROUNDS, CARRY_ROUNDS + STEPS)
    return _jax_states(1, jcfg, rounds)


def _world1_shard():
    edges = rmat(*GRAPH, device="cpu").edges.numpy()
    shards, masks, _, _ = tgraph.shard_edges(edges, 1)
    u, v = (torch.from_numpy(np.ascontiguousarray(shards[0, :, i]))
            for i in (0, 1))
    return shards, masks, u, v, torch.from_numpy(masks[0])


@pytest.mark.parametrize("k", [0, CARRY_ROUNDS])
def test_spmd_round_steps_from_carried_state_world1(world1_states, k):
    n = 1 << GRAPH[0]
    cfg = tp.NEConfig(**KW).clamped(n)
    shards, masks, u, v, mask = _world1_shard()
    limit = j_alpha_limit(cfg.alpha, int(masks.sum()), cfg.num_partitions)
    carried, want = world1_states[k], world1_states[k + STEPS]
    if k == 0:       # the port's initial state is the reference's
        init = sm.spmd_state_to_numpy(sm.spmd_init_state(shards, masks, n, cfg,
                                                         device="cpu"))
        init["edge_part"] = init["edge_part"][None]
        for f, a in carried.items():
            assert init[f].dtype == a.dtype, f
            np.testing.assert_array_equal(init[f], a, err_msg=f)
    with compat.world1("gloo"):
        state = sm.spmd_state_from_numpy(carried, device="cpu")
        back = sm.spmd_state_to_numpy(state)             # the carry is exact
        back["edge_part"] = back["edge_part"][None]
        for f, a in carried.items():
            np.testing.assert_array_equal(back[f], a, err_msg=f)
        for _ in range(STEPS):
            state = sm.spmd_round_step(cfg, limit, n, u, v, mask, state)
    got = sm.spmd_state_to_numpy(state)
    got["edge_part"] = got["edge_part"][None]
    for f, a in want.items():
        assert got[f].dtype == a.dtype, f
        np.testing.assert_array_equal(got[f], a, err_msg=f)
    assert (got["edge_part"] >= 0).sum() > (carried["edge_part"] >= 0).sum()


def test_round_quality_matches_reference(world1_states):
    n = 1 << GRAPH[0]
    cfg = tp.NEConfig(**KW)
    jcfg = jp.NEConfig(use_pallas=True, **KW)
    arrays = world1_states[CARRY_ROUNDS]
    want = jsm.round_quality(
        jcfg, jsm.SpmdState(*(jnp.asarray(arrays[f])
                              for f in jsm.SpmdState._fields)), n)
    with compat.world1("gloo"):
        state = sm.spmd_state_from_numpy(arrays, device="cpu")
    assert sm.round_quality(cfg, state, n) == want
    # the single controller's NEState, with (N, P) bool replica sets
    jg = j_rmat(*GRAPH)
    jcfg = jcfg.clamped(n)
    limit = j_alpha_limit(jcfg.alpha, jg.num_edges, jcfg.num_partitions)
    st = jp.ne_init_state(jg, jcfg)
    for _ in range(2):
        st = jp.ne_round_step(jg, jcfg, limit, st)
    tstate = tp.state_from_numpy(
        {f: np.asarray(getattr(st, f)) for f in jp.NEState._fields},
        device="cpu")
    assert sm.round_quality(cfg, tstate, n) == jsm.round_quality(jcfg, st, n)


@pytest.mark.parametrize("two_hop", [True, False])
def test_round_sync_payload_bytes_matches_reference(two_hop):
    for p in (1, 32, 37, 64, 100):
        for d in (1, 2, 3, 8):
            kw = dict(num_partitions=p, two_hop=two_hop)
            assert sm.round_sync_payload_bytes(tp.NEConfig(**kw), 1000, d) \
                == jsm.round_sync_payload_bytes(
                    jp.NEConfig(use_pallas=True, **kw), 1000, d)


def test_or_all_reduce_world1_returns_its_input():
    x = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    with compat.world1("gloo"):
        assert compat.or_all_reduce(x) is x
        np.testing.assert_array_equal(compat.all_gather_rows(x).numpy(),
                                      x.numpy()[None])


def test_spawn_raises_when_a_rank_fails():
    """A failing rank's traceback surfaces, and the ranks blocked in a
    collective are ended rather than waited for."""
    with pytest.raises(RuntimeError, match="fails on purpose"):
        compat.spawn(torch_spmd_ranks.fail_on_last_rank, 2, "gloo")


def test_stitch_edge_part_matches_reference():
    edges = np.asarray(j_rmat(8, 8, seed=2).edges)
    shards, masks, _, dev = jgraph.shard_edges(edges, 3)
    rng = np.random.default_rng(0)
    ep_sh = np.where(masks, rng.integers(0, 9, masks.shape), -1)
    np.testing.assert_array_equal(
        sm.stitch_edge_part(ep_sh.astype(np.int32), dev, edges.shape[0]),
        jsm.stitch_edge_part(ep_sh.astype(np.int32), dev, edges.shape[0]))


# --------------------------------------------------------------------------
# 2, 3 and 4 ranks: gloo processes against the reference's devices
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _reference_process(tmp_path_factory):
    """Starts the multi-device reference with the module's first test;
    yields (process, output path), and ends the process if no test
    waited for it."""
    out = tmp_path_factory.mktemp("jax_spmd") / "ref.pkl"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.Popen([sys.executable, __file__, str(out)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(ROOT))
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def multi_device_reference(_reference_process):
    proc, out = _reference_process
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, multi_device_reference):
    d = request.param
    ref_d = multi_device_reference[d]
    n = 1 << GRAPH[0]
    words = ref.replica_words(KW["num_partitions"])
    rng = np.random.default_rng(d)
    or_rows = rng.integers(0, 2**32, (d, n, words)).astype(np.uint32)
    or_rows[:, ::5] |= np.uint32(1 << 31)
    or_rows = or_rows.view(np.int32)
    edges = rmat(*GRAPH, device="cpu").edges.numpy()
    outs = compat.spawn(torch_spmd_ranks.spmd_checks, d, "gloo", edges, n,
                        tp.NEConfig(**KW), ref_d["carried"], STEPS, or_rows)
    return d, ref_d, outs, or_rows


def test_partition_spmd_matches_reference_across_ranks(ranks):
    d, ref_d, outs, _ = ranks
    assert len(outs) == d
    for out in outs:           # every rank returns the reference's result
        _assert_same(_result(out["result"]), ref_d["result"])


def test_spmd_round_steps_from_carried_state_across_ranks(ranks):
    d, ref_d, outs, _ = ranks
    want = ref_d["after"]
    got_ep = np.stack([out["state"]["edge_part"] for out in outs])
    np.testing.assert_array_equal(got_ep, want["edge_part"])
    for out in outs:
        for f in jsm.SpmdState._fields:
            if f != "edge_part":
                assert out["state"][f].dtype == want[f].dtype, f
                np.testing.assert_array_equal(out["state"][f], want[f],
                                              err_msg=f)


def test_or_all_reduce_is_any_over_ranks(ranks):
    d, _, outs, or_rows = ranks
    want = np.bitwise_or.reduce(or_rows, axis=0)
    p = KW["num_partitions"]
    want_any = np.any([jref.unpack_bits_np(r.view(np.uint32), p)
                       for r in or_rows], axis=0)
    for out in outs:
        np.testing.assert_array_equal(out["or"], want)
        np.testing.assert_array_equal(ref.unpack_bits_np(out["or"], p),
                                      want_any)


if __name__ == "__main__":
    _write_multi_device_reference(sys.argv[1])
