"""The port's NE-round kernels against the reference package.

On the CPU the port's front door runs the plain versions; each is held,
exactly, against the reference's Pallas kernel in interpret mode and
against its XLA reference, on the same numpy-made inputs.  The ``gpu``
cases hold the CUDA kernels against the plain versions on the card and
skip without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partitioner as jp
from repro.kernels.ne_round import ne_round as ne_pl
from repro.kernels.ne_round import ref as jref
from repro_torch import random as trandom
from repro_torch.core import partitioner as tp
from repro_torch.kernels.ne_round import ops, ref

I32_INF = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand_edges(n, m, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2)).astype(np.int32)
    return e[e[:, 0] != e[:, 1]]


def _one_hop_inputs(n, m, seed):
    rng = np.random.default_rng(seed)
    e = _rand_edges(n, m, seed)
    vclaim = np.full(n, I32_INF, np.int32)
    claimed = rng.integers(0, n, n // 3)
    vclaim[claimed] = rng.integers(0, 1000, claimed.size)
    ep = np.where(rng.random(e.shape[0]) < 0.3, 0, -1).astype(np.int32)
    mask = rng.random(e.shape[0]) < 0.9
    return vclaim, e[:, 0].copy(), e[:, 1].copy(), ep, mask


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("n,m,p,seed", [(50, 200, 4, 0), (300, 1000, 8, 1),
                                        (128, 500, 16, 2)])
def test_one_hop_matches_reference(n, m, p, seed, use_mask):
    vclaim, u, v, ep, mask = _one_hop_inputs(n, m, seed)
    mk = mask if use_mask else None
    got = ops.one_hop(_t(vclaim), _t(u), _t(v), _t(ep), p,
                      mask=None if mk is None else _t(mk))
    want_pl = ne_pl.one_hop(jnp.asarray(vclaim), jnp.asarray(u),
                            jnp.asarray(v), jnp.asarray(ep), p,
                            mask=None if mk is None else jnp.asarray(mk),
                            block_edges=128, interpret=True)
    want_ref = jref.one_hop_ref(jnp.asarray(vclaim), jnp.asarray(u),
                                jnp.asarray(v), jnp.asarray(ep), p,
                                mask=None if mk is None else jnp.asarray(mk))
    for want in (want_pl, want_ref):
        np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32


def _select_inputs(n, c, seed, ties=False, restart=False):
    rng = np.random.default_rng(seed)
    vparts_c = rng.random((c, n)) < 0.15
    active_c = rng.random(c) < 0.8
    degree_rest = rng.integers(0, 20, n).astype(np.int32)
    if ties:
        degree_rest = np.where(degree_rest > 0, 3, 0).astype(np.int32)
    if restart:
        vparts_c[0] = False          # an empty boundary: row 0 restarts
        active_c[0] = True
    remaining_c = rng.integers(0, 200, c).astype(np.int32)
    return vparts_c, active_c, degree_rest, remaining_c


def _where_valid(idx, valid):
    return np.where(_np(valid), _np(idx), -1)


@pytest.mark.parametrize("case", ["plain", "ties", "restart"])
@pytest.mark.parametrize("n,c,k_sel,seed", [(100, 4, 16, 0), (600, 8, 64, 1),
                                            (257, 3, 32, 2)])
def test_select_matches_reference(n, c, k_sel, seed, case):
    vp, act, dr, rem = _select_inputs(n, c, seed, ties=case == "ties",
                                      restart=case == "restart")
    keys_j = jax.vmap(jax.random.PRNGKey)(jnp.arange(c) + seed)
    keys_t = torch.stack([trandom.PRNGKey(s + seed, device="cpu")
                          for s in range(c)])
    # the restart draw: the port's equals the reference's
    rnd_j, any_j = jp.boundary_reseed(jnp.asarray(dr), keys_j)
    rnd_t, any_t = ref.boundary_reseed(_t(dr), keys_t)
    np.testing.assert_array_equal(_np(rnd_t), _np(rnd_j))
    assert bool(any_t) == bool(any_j)

    # the plain select with the draw made outside, as the Pallas kernel
    got_idx, got_val = ref.select_ref(_t(vp), _t(act), _t(dr), 0.5, k_sel,
                                      _t(rem), rnd_t, any_t)
    assert got_idx.dtype == torch.int32 and got_val.dtype == torch.bool
    pl_idx, pl_val = ne_pl.select(jnp.asarray(vp), jnp.asarray(act),
                                  jnp.asarray(dr), 0.5, k_sel,
                                  jnp.asarray(rem), rnd_j, any_j,
                                  block_n=64, interpret=True)
    ch_idx, ch_val = jp.select_chunk(jnp.asarray(vp), jnp.asarray(act),
                                     jnp.asarray(dr), 0.5, k_sel, keys_j,
                                     jnp.asarray(rem))
    # the port's select_chunk (draw + select) equals the reference's
    sc_idx, sc_val = ops.select_chunk(_t(vp), _t(act), _t(dr), 0.5, k_sel,
                                      keys_t, _t(rem))
    for w_idx, w_val in ((pl_idx, pl_val), (ch_idx, ch_val)):
        np.testing.assert_array_equal(_np(got_val), _np(w_val))
        np.testing.assert_array_equal(_where_valid(got_idx, got_val),
                                      _where_valid(w_idx, w_val))
    np.testing.assert_array_equal(_np(sc_val), _np(ch_val))
    np.testing.assert_array_equal(_where_valid(sc_idx, sc_val),
                                  _where_valid(ch_idx, ch_val))
    if case == "restart":
        assert bool(got_val[0, 0]) and int(got_idx[0, 0]) == int(rnd_j[0])


def _restart_case(n, c, seed, case):
    """Selection inputs whose rows restart: ``some`` (every third row has
    an empty boundary), ``all`` (every boundary empty), ``no_rest`` (no
    vertex has D_rest > 0: nothing restarts, ``any_ok`` false) and
    ``inactive`` (an empty boundary on an inactive row, which does not
    restart)."""
    rng = np.random.default_rng(seed)
    vp = rng.random((c, n)) < 0.2
    act = np.ones(c, bool)
    dr = rng.integers(0, 4, n).astype(np.int32)       # many equal scores
    if case == "some":
        vp[::3] = False
    elif case == "all":
        vp[:] = False
    elif case == "no_rest":
        vp[::2] = False
        dr[:] = 0
    elif case == "inactive":
        vp[1] = vp[2] = False
        act[1] = False
    rem = rng.integers(0, 60, c).astype(np.int32)
    return vp, act, dr, rem


@pytest.mark.parametrize("case", ["some", "all", "no_rest", "inactive"])
@pytest.mark.parametrize("n,c,k_sel,seed", [(300, 11, 16, 0),
                                            (1000, 4, 64, 1)])
def test_select_chunk_ref_matches_reference(n, c, k_sel, seed, case):
    """The plain select_chunk (draw + select, REF_ROWS rows at a time)
    equals the reference's select_chunk bit for bit, restart rows
    included; 11 rows span two row groups."""
    vp, act, dr, rem = _restart_case(n, c, seed, case)
    keys_j = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(5),
                                                   s))(jnp.arange(c))
    keys_t = trandom.fold_in(trandom.PRNGKey(5, device="cpu"),
                             torch.arange(c))
    want_idx, want_val = jp.select_chunk(jnp.asarray(vp), jnp.asarray(act),
                                         jnp.asarray(dr), 0.1, k_sel, keys_j,
                                         jnp.asarray(rem))
    got_idx, got_val = ref.select_chunk_ref(_t(vp), _t(act), _t(dr), 0.1,
                                            k_sel, keys_t, _t(rem))
    np.testing.assert_array_equal(_np(got_val), _np(want_val))
    np.testing.assert_array_equal(_where_valid(got_idx, got_val),
                                  _where_valid(want_idx, want_val))
    restart = ~(vp & (dr > 0)[None, :] & act[:, None]).any(1) & act \
        & (dr > 0).any()
    assert (_np(got_val)[:, 0] >= restart).all()
    if restart.any():                     # the draws land on D_rest > 0
        assert (dr[_np(got_idx)[restart, 0]] > 0).all()


def test_select_all_equal_scores_lowest_index_first():
    """Every score equal: the K lowest boundary ids, in order."""
    n, c, k_sel = 300, 2, 8
    vp = np.ones((c, n), bool)
    vp[1, ::3] = False
    dr = np.ones(n, np.int32)
    act = np.ones(c, bool)
    rem = np.full(c, 1000, np.int32)
    keys = trandom.fold_in(trandom.PRNGKey(0, device="cpu"), torch.arange(c))
    idx, val = ops.select_chunk(_t(vp), _t(act), _t(dr), 1.0, k_sel,
                                keys, _t(rem))
    assert bool(val.all())
    np.testing.assert_array_equal(_np(idx[0]), np.arange(k_sel))
    np.testing.assert_array_equal(_np(idx[1]),
                                  np.flatnonzero(vp[1])[:k_sel])


def _two_hop_inputs(n, p, ce, seed):
    rng = np.random.default_rng(seed)
    bools = rng.random((n, p)) < 0.3
    bools[::5, p - 1] = True                    # the last partition
    if p > 31:
        bools[::2, 31] = True                   # bit 31 of word 0
    uu = rng.integers(0, n, ce).astype(np.int32)
    vv = rng.integers(0, n, ce).astype(np.int32)
    un = rng.random(ce) < 0.7
    enc = rng.integers(0, 10_000, p).astype(np.int32)
    enc[rng.random(p) < 0.2] = I32_INF         # partitions over the limit
    return bools, uu, vv, un, enc


@pytest.mark.parametrize("fmt", ["words", "bools"])
@pytest.mark.parametrize("n,p,ce,seed", [(200, 64, 500, 0), (150, 37, 333, 1),
                                         (90, 100, 256, 2), (60, 5, 100, 3)])
def test_two_hop_best_ref_matches_reference(fmt, n, p, ce, seed):
    """The plain two_hop_best (and the CPU front door) equals the
    reference's candidate sequence: the AND of the two rows (packed words
    through its Pallas unpack_bits in interpret mode), then where/min."""
    bools, uu, vv, un, enc = _two_hop_inputs(n, p, ce, seed)
    if fmt == "words":
        words = jref.pack_bits_np(bools)
        inter = ne_pl.unpack_bits(jnp.asarray(words)[uu]
                                  & jnp.asarray(words)[vv], p,
                                  block_rows=128, interpret=True)
        vparts = _t(words.view(np.int32))
    else:
        inter = jnp.asarray(bools)[uu] & jnp.asarray(bools)[vv]
        vparts = _t(bools)
    want = jnp.where(inter & jnp.asarray(un)[:, None],
                     jnp.asarray(enc)[None, :], I32_INF).min(axis=1)
    args = (vparts, _t(uu), _t(vv), _t(un), _t(enc), p)
    got = ref.two_hop_best_ref(*args)
    assert got.dtype == torch.int32 and got.shape == (ce,)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(ops.two_hop_best(*args)),
                                  np.asarray(want))


@pytest.mark.parametrize("n,p,k_sel,seed", [(100, 4, 16, 0), (600, 8, 64, 1),
                                            (257, 3, 32, 2), (1001, 5, 8, 3),
                                            (300, 6, 7, 4)])
def test_claim_scatter_matches_reference(n, p, k_sel, seed):
    """Half the slots on 10 vertices; seeds 3 and 4 add vertices at or
    past N, which both drop (seed 4 with every slot invalid)."""
    rng = np.random.default_rng(seed)
    sel_idx = rng.integers(0, n, (p, k_sel)).astype(np.int32)
    sel_idx[:, ::2] = rng.integers(0, 10, (p, (k_sel + 1) // 2))
    if seed >= 3:
        sel_idx[:, 1::3] = rng.integers(n, 3 * n, sel_idx[:, 1::3].shape)
    sel_valid = rng.random((p, k_sel)) < (0.6 if seed < 4 else 0.0)
    epp = rng.integers(0, 100, p).astype(np.int32)
    got = ops.claim_scatter(_t(sel_idx), _t(sel_valid), _t(epp), n, p)
    for want in (ne_pl.claim_scatter(jnp.asarray(sel_idx),
                                     jnp.asarray(sel_valid),
                                     jnp.asarray(epp), n, p,
                                     interpret=True),
                 jref.claim_scatter_ref(jnp.asarray(sel_idx),
                                        jnp.asarray(sel_valid),
                                        jnp.asarray(epp), n, p)):
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("p,sel_chunk", [(8, 8), (8, 3), (5, 2)])
def test_vertex_claims_match_reference(p, sel_chunk):
    """Selection + claims from the same round state and the same key:
    the port selects all P partitions in one call, the reference in
    chunks of ``sel_chunk`` (a ragged last chunk pads its replica map)."""
    rng = np.random.default_rng(7)
    n = 400
    vparts = rng.random((n, p)) < 0.1
    dr = rng.integers(0, 15, n).astype(np.int32)
    epp = rng.integers(0, 300, p).astype(np.int32)
    kw = dict(num_partitions=p, seed=0, k_sel=32)
    want = jp.vertex_claims(jp.NEConfig(use_pallas=True, sel_chunk=sel_chunk,
                                        **kw), 250,
                            jnp.asarray(vparts), jnp.asarray(dr),
                            jnp.asarray(epp), jax.random.PRNGKey(9))
    got = tp.vertex_claims(tp.NEConfig(**kw), 250, _t(vparts), _t(dr),
                           _t(epp), trandom.PRNGKey(9, device="cpu"))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_priority_enc_matches_reference():
    cnt = np.array([0, 5, 2**30, I32_INF], np.int32)
    pid = np.array([0, 3, 7, 2], np.int32)
    for p_num in (1, 8, 64):
        want = jp.priority_enc(jnp.asarray(cnt), jnp.asarray(pid % p_num),
                               p_num)
        np.testing.assert_array_equal(
            _np(tp.priority_enc(_t(cnt), _t(pid % p_num), p_num)),
            _np(want))
        np.testing.assert_array_equal(
            _np(ref._enc(_t(cnt), _t(pid % p_num), p_num)), _np(want))


def test_front_door_rejects_other_devices():
    x = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.one_hop(x, x, x, x, 2)
    ops.reset_launches()
    ops.one_hop(*(torch.zeros(4, dtype=torch.int32) for _ in range(4)), 2)
    assert ops.launches == {"one_hop": 0, "select": 0, "restart_draw": 0,
                            "claim_scatter": 0, "two_hop_best": 0,
                            "pack_bits": 0, "unpack_bits": 0, "or_words": 0}


# --------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,p", [(1 << 16, 1 << 20, 64), (1000, 5000, 7)])
def test_one_hop_kernel_matches_plain(cuda, n, m, p):
    vclaim, u, v, ep, mask = _one_hop_inputs(n, m, 3)
    args = [_t(a).to(cuda) for a in (vclaim, u, v, ep)]
    before = ops.launches["one_hop"]
    for mk in (None, _t(mask).to(cuda)):
        got = ops.one_hop(*args, p, mask=mk)
        want = ref.one_hop_ref(*args, p, mask=mk)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert ops.launches["one_hop"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["plain", "ties", "restart", "all_restart",
                                  "chunk_view", "ragged_rows", "hubs"])
def test_select_kernel_matches_plain(cuda, case):
    """select_chunk's kernels against its plain version, exactly: the
    whole (N, 64) map transposed (the main path's view), scores all 1
    (every selection a tie at the threshold, resolved by id), restart
    rows (every fourth row, or all), an 8-row strided chunk view (byte
    loads), 37 rows of a copied map, and scores that all lie above the
    256 exact buckets (the overflow levels)."""
    n, p, k_sel = 1 << 16, 64, 256
    rng = np.random.default_rng(5)
    vparts = _t(rng.random((n, p)) < 0.1).to(cuda)
    dr = rng.integers(0, 50, n).astype(np.int32)
    if case in ("restart", "all_restart"):
        vparts[:, ::4 if case == "restart" else 1] = False
    if case == "ties":
        dr = np.where(dr > 0, 1, 0).astype(np.int32)
    if case == "hubs":
        dr = np.where(dr > 0, 300 + rng.integers(0, 1 << 20, n), 0
                      ).astype(np.int32)
    rows = {"chunk_view": 8, "ragged_rows": 37}.get(case, p)
    start = 8 if case == "chunk_view" else 0
    view = vparts[:, start:start + rows].T
    if case == "ragged_rows":
        view = vparts[:, :rows].contiguous().T
    keys = trandom.fold_in(trandom.PRNGKey(3, device=cuda),
                           torch.arange(rows, device=cuda))
    active = _t(rng.random(rows) < 0.8).to(cuda)
    active[0] = True
    args = (view, active, _t(dr).to(cuda), 0.1, k_sel, keys,
            _t(rng.integers(0, 3000, rows).astype(np.int32)).to(cuda))
    before = (ops.launches["select"], ops.launches["restart_draw"],
              ops.rows_drawn(cuda))
    gi, gv = ops.select_chunk(*args)
    drawn = ops.rows_drawn(cuda) - before[2]
    assert (ops.launches["select"] - before[0],
            ops.launches["restart_draw"] - before[1]) == (1, 1)
    wi, wv = ref.select_chunk_ref(*args)
    torch.testing.assert_close(gv, wv, rtol=0, atol=0)
    torch.testing.assert_close(torch.where(gv, gi, -1),
                               torch.where(wv, wi, -1), rtol=0, atol=0)
    bnd = view & (args[2] > 0)[None, :] & active[:, None]
    want = int((~bnd.any(1) & active).sum()) if (args[2] > 0).any() else 0
    assert drawn == want


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,p", [("words", 64), ("words", 37),
                                   ("words", 100), ("bools", 64),
                                   ("bools", 37)])
def test_two_hop_best_kernel_matches_plain(cuda, fmt, p):
    """two_hop_best against its plain version, exactly, at the main path's
    chunk length: packed words (W = 2, a ragged 37, W = 4) and bool rows
    (16-byte loads at P = 64, byte loads at 37)."""
    n, ce = 1 << 16, 1 << 18
    bools, uu, vv, un, enc = _two_hop_inputs(n, p, ce, 8)
    vparts = (_t(ref.pack_bits_np(bools)) if fmt == "words"
              else _t(bools)).to(cuda)
    args = (vparts, *(_t(a).to(cuda) for a in (uu, vv, un, enc)), p)
    before = ops.launches["two_hop_best"]
    got = ops.two_hop_best(*args)
    assert ops.launches["two_hop_best"] == before + 1
    torch.testing.assert_close(got, ref.two_hop_best_ref(*args), rtol=0,
                               atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case,n", [
    ("crowded", 1 << 16), ("main_path", 1 << 22), ("ragged", 50_003),
    ("ragged", 1001), ("empty", 0), ("all_invalid", 1 << 16),
    ("collisions", 1 << 22), ("out_of_range", 40_000)])
def test_claim_scatter_kernel_matches_plain(cuda, case, n):
    """The one-launch kernel against the plain version, exactly: at the
    main path's N = 2^22, N not a multiple of 4 (and not of the 32,768
    vertices a block owns), N = 0, every slot invalid, half the slots on
    10 vertices, and vertices outside [0, N) (dropped)."""
    p, k_sel = 64, 256
    rng = np.random.default_rng(6)
    idx = rng.integers(0, max(n, 1), (p, k_sel))
    valid = rng.random((p, k_sel)) < 0.5
    if case == "crowded":
        idx = rng.integers(0, 100, (p, k_sel))
    elif case == "all_invalid":
        valid[:] = False
    elif case == "collisions":
        idx[:, ::2] = rng.integers(0, 10, (p, k_sel // 2))
        valid[:] = True
    elif case == "out_of_range":
        idx[:, ::3] = rng.integers(-n, 2 * n, (p, -(-k_sel // 3)))
    sel_idx = _t(idx.astype(np.int32)).to(cuda)
    sel_valid = _t(valid).to(cuda)
    epp = _t(rng.integers(0, 1000, p).astype(np.int32)).to(cuda)
    before = ops.launches["claim_scatter"]
    got = ops.claim_scatter(sel_idx, sel_valid, epp, n, p)
    assert got.shape == (n,)
    assert ops.launches["claim_scatter"] == before + (n > 0)
    torch.testing.assert_close(
        got, ref.claim_scatter_ref(sel_idx, sel_valid, epp, n, p),
        rtol=0, atol=0)
