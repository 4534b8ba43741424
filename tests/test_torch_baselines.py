"""The port's baselines (``repro_torch.core.baselines``) and their
streaming scans (``repro_torch.kernels.stream``) against the reference
package's ``repro.core.baselines``.

Mirrors tests/test_baselines.py: every case computes the reference in
this process and asserts the port's assignment equal to it, bit for bit,
not just valid.  On the CPU the scans take their plain versions
(``kernels/stream/ref.py``); the ``gpu`` cases hold the CUDA kernels to
them on the card.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro.core import evaluate as j_evaluate
from repro.core import from_edges as j_from_edges
from repro.core.baselines import PARTITIONERS as J_PARTITIONERS
from repro.core.baselines import _hdrf_scan, _oblivious_scan
from repro.graphs.rmat import rmat as j_rmat
from repro_torch.core.baselines import (PARTITIONERS, dbh, hdrf, oblivious)
from repro_torch.core.graph import from_edges
from repro_torch.core.metrics import evaluate
from repro_torch.graphs.rmat import rmat
from repro_torch.kernels.stream import ops, ref

P = 8


@pytest.fixture(scope="module")
def jg():
    return j_rmat(10, 8, seed=3)   # 1024 vertices, 6,008 canonical edges


@pytest.fixture(scope="module")
def g():
    return rmat(10, 8, seed=3, device="cpu")


def test_graph_equals_reference(g, jg):
    np.testing.assert_array_equal(g.edges.numpy(), np.asarray(jg.edges))


@pytest.mark.parametrize("p,seed", [(P, 0), (P, 1), (5, 0)])
@pytest.mark.parametrize("name", sorted(PARTITIONERS))
def test_partitioner_equals_reference(g, jg, name, p, seed):
    got = PARTITIONERS[name](g, p, seed=seed)
    assert got.shape == (g.num_edges,) and got.dtype == np.int32
    np.testing.assert_array_equal(got, J_PARTITIONERS[name](jg, p,
                                                            seed=seed))


def test_assignments_valid_and_deterministic(g):
    for name, fn in PARTITIONERS.items():
        a, b = fn(g, P), fn(g, P)
        assert ((a >= 0) & (a < P)).all(), name
        np.testing.assert_array_equal(a, b, err_msg=name)
        # every method is seeded (hash salt or stream order)
        assert (fn(g, P, seed=0) != fn(g, P, seed=1)).any(), name


def test_dbh_hashes_lower_degree_endpoint(g):
    """An edge lands on the partition chosen by its lower-degree endpoint
    (ties broken by vertex id)."""
    e = g.edges.numpy()
    deg = g.degree.numpy()
    du, dv = deg[e[:, 0]], deg[e[:, 1]]
    pick = np.where((du < dv) | ((du == dv) & (e[:, 0] < e[:, 1])),
                    e[:, 0], e[:, 1])
    ep = dbh(g, P)
    for vid in np.unique(pick)[:200]:
        assert len(set(ep[pick == vid])) == 1


@pytest.mark.parametrize("lam", [0.1, 1.0, 2.0])
@pytest.mark.parametrize("p", [1, 4, 37])
def test_hdrf_scan_equals_reference(g, jg, p, lam):
    """The scan itself on the canonical edge order, at P = 1, a power of
    two and a ragged P, over balance weights on both sides of 1."""
    got = ops.hdrf_scan(g.edges, p, g.num_vertices, lam)
    want = _hdrf_scan(jg.edges, p, jg.num_vertices, lam)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("limit", [1, 40, 800, 1 << 20])
@pytest.mark.parametrize("p", [1, 8, 37])
def test_oblivious_scan_equals_reference(g, jg, p, limit):
    """limit = 1 saturates at once (the every-partition-full rule decides
    nearly every edge); a limit of ~the fair share, and no limit."""
    got = ops.oblivious_scan(g.edges, p, g.num_vertices, limit)
    want = _oblivious_scan(jg.edges, p, jg.num_vertices, limit)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_oblivious_respects_capacity(g):
    m = g.num_edges
    limit = -(-m // P)
    parts = ops.oblivious_scan(g.edges, P, g.num_vertices, limit).numpy()
    assert np.bincount(parts, minlength=P).max() <= limit


def test_oblivious_overflow_spreads(g):
    parts = ops.oblivious_scan(g.edges, P, g.num_vertices, 1).numpy()
    counts = np.bincount(parts, minlength=P)
    assert counts.max() - counts.min() <= 1


def test_oblivious_default_assigns_all(g, jg):
    ep = oblivious(g, P)
    st = evaluate(g.edges.numpy(), ep, g.num_vertices, P)
    assert st.edge_balance <= 1.1 + P / g.num_edges + 1e-6
    want = j_evaluate(np.asarray(jg.edges), ep, jg.num_vertices, P)
    assert st.edge_balance == want.edge_balance


def test_hdrf_first_edge_degenerate():
    """max == min (the first edge of every stream): the balance term is
    1 everywhere, and the port picks the reference's partition."""
    e = np.array([[0, 1]])
    got = hdrf(from_edges(e, num_vertices=2, device="cpu"), 4)
    want = J_PARTITIONERS["hdrf"](j_from_edges(e, num_vertices=2), 4)
    assert got.shape == (1,) and 0 <= int(got[0]) < 4
    np.testing.assert_array_equal(got, want)


def test_hdrf_lambda_controls_balance(g, jg):
    got = hdrf(g, P, lam_balance=100.0)
    counts = np.bincount(got, minlength=P)
    assert counts.max() <= -(-g.num_edges // P) + 1
    np.testing.assert_array_equal(
        got, J_PARTITIONERS["hdrf"](jg, P, lam_balance=100.0))


def test_scans_take_a_loop_edge_as_the_reference():
    """u == v adds 2 to the partial degree, as ``.at[u].add(1).at[v]
    .add(1)`` does (a canonical graph has no loops, the scans still take
    one)."""
    e = np.array([[0, 0], [0, 1], [1, 1], [2, 0], [0, 2]], np.int32)
    for p in (1, 3):
        np.testing.assert_array_equal(
            ops.hdrf_scan(torch.from_numpy(e), p, 3, 0.5).numpy(),
            np.asarray(_hdrf_scan(e, p, 3, 0.5)))
        np.testing.assert_array_equal(
            ops.oblivious_scan(torch.from_numpy(e), p, 3, 2).numpy(),
            np.asarray(_oblivious_scan(e, p, 3, 2)))


# --------------------------------------------------------------------------
# the float32 steps
# --------------------------------------------------------------------------

def test_hdrf_rounds_the_product_as_xla_does():
    """XLA contracts ``lam * x + y`` into an FMA in a plain elementwise
    fusion on the CPU but not inside the HDRF scan: the score is
    ``(g_u + g_v) + f32(lam * c_bal)``.  On ``rmat(9, 8, seed=1)`` at
    P = 5, lam = 0.9 the stream's step 1,972 is a near tie that an FMA
    breaks the other way; the port must follow the reference there."""
    f = np.float32
    lam = f(0.9)
    g2, cb2 = f(1.65), f(1) / f(3)          # partition 2
    g4, cb4 = f(1.35), f(2) / f(3)          # partition 4
    assert g2 + lam * cb2 == g4 + lam * cb4    # a tie: the first, 2, wins
    fma2 = f(float(Fraction(float(lam)) * Fraction(float(cb2))
                   + Fraction(float(g2))))
    assert fma2 < g4 + lam * cb4            # an FMA would pick 4
    got = hdrf(rmat(9, 8, seed=1, device="cpu"), 5, lam_balance=0.9)
    want = J_PARTITIONERS["hdrf"](j_rmat(9, 8, seed=1), 5, lam_balance=0.9)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

def test_wrappers_check_inputs_and_count_only_kernels(g):
    before = dict(ops.launches)
    ops.hdrf_scan(g.edges[:50], P, g.num_vertices)       # plain versions
    ops.oblivious_scan(g.edges[:50], P, g.num_vertices, 10)
    assert ops.launches == before
    assert ops.hdrf_scan(g.edges[:0], P, 4).shape == (0,)
    with pytest.raises(TypeError, match="int32"):
        ops.hdrf_scan(g.edges.long(), P, g.num_vertices)
    with pytest.raises(ValueError, match="no stream kernel"):
        ops.oblivious_scan(g.edges.to("meta"), P, g.num_vertices, 10)
    with pytest.raises(ValueError, match="outside"):
        ops.hdrf_scan(g.edges, P, g.num_vertices - 1)
    assert [ops.threads(p) for p in (1, 32, 33, 64, 1000, 5000)] == \
        [32, 32, 64, 64, 1024, 1024]


def test_hdrf_route_and_its_state(g):
    """Both scans take the one-warp kernel up to P = 256 (the quality
    matrix's P 4 and 16, the NE cells' 64) and below 2^31 edges, and the
    block kernel otherwise;
    the warp route's replica flags are (N, ceil(P/32)) int32 bit words,
    the block route's (N, P) bytes, for HDRF and Oblivious alike.
    Only ``prepare``'s allocation is reached here: it runs on the CPU too,
    and nothing is launched."""
    assert [ops.hdrf_route(p) for p in (1, 4, 16, 32, 33, 64, 256, 257,
                                        1500)] == ["warp"] * 7 + ["block"] * 2
    assert ops.hdrf_route(16, 2**31 - 1) == "warp"
    assert ops.hdrf_route(16, 2**31) == "block"      # the warp's int steps
    with pytest.raises(ValueError, match="p >= 1"):
        ops.hdrf_route(0)
    e, n = g.edges[:10], g.num_vertices
    for p, route, shape, dtype in ((16, "warp", (n, 1), torch.int32),
                                   (33, "warp", (n, 2), torch.int32),
                                   (256, "warp", (n, 8), torch.int32),
                                   (257, "block", (n, 257), torch.uint8)):
        scan = ops.prepare("hdrf_scan", e, p, n, 1.0)
        assert (scan.route, tuple(scan.vparts.shape), scan.vparts.dtype) \
            == (route, shape, dtype)
        assert not scan.vparts.any() and not scan.degree.any()
    assert [ops.oblivious_route(p) for p in (1, 4, 16, 33, 256, 257,
                                             1500)] == \
        ["warp"] * 5 + ["block"] * 2
    assert ops.oblivious_route(1, 2**31 - 1) == "warp"
    assert ops.oblivious_route(256, 2**31) == "block"
    with pytest.raises(ValueError, match="p >= 1"):
        ops.oblivious_route(0)
    for p, route, shape, dtype in ((1, "warp", (n, 1), torch.int32),
                                   (16, "warp", (n, 1), torch.int32),
                                   (256, "warp", (n, 8), torch.int32),
                                   (257, "block", (n, 257), torch.uint8)):
        scan = ops.prepare("oblivious_scan", e, p, n, 5)
        assert (scan.route, tuple(scan.vparts.shape), scan.vparts.dtype,
                scan.degree) == (route, shape, dtype, None)
        assert not scan.vparts.any()


# --------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4, 16, 32, 33, 37, 64, 256, 257, 1500])
def test_stream_kernels_match_plain(cuda, g, p):
    """Both scans on the card equal their plain versions bit for bit over
    1,500 edges, on the warp route up to P = 256 (1 to 8 words a vertex,
    a ragged last word at 33, 37) and on the block route above."""
    e = g.edges[:1500].to(cuda)
    n = g.num_vertices
    before = dict(ops.launches)
    for lam in (0.1, 1.0):
        got = ops.hdrf_scan(e, p, n, lam)
        torch.testing.assert_close(got, ref.hdrf_scan_ref(e, p, n, lam),
                                   rtol=0, atol=0)
    for limit in (1, -(-e.shape[0] // p) + 3):
        got = ops.oblivious_scan(e, p, n, limit)
        torch.testing.assert_close(
            got, ref.oblivious_scan_ref(e, p, n, limit), rtol=0, atol=0)
    assert ops.launches["hdrf_scan"] == before["hdrf_scan"] + 2
    assert ops.launches["oblivious_scan"] == before["oblivious_scan"] + 2


def _shared_endpoint_streams():
    """Streams whose consecutive edges share endpoints, so that a step
    reads what the steps before wrote: a star (every edge at the hub), a
    path (each edge at the last one's end), repeated edges, self-loops,
    both orders of one edge, and streams of 1, 2 and 3 edges (as short as
    the warp kernel's look-ahead); (M, 2) int32 and N."""
    rng = np.random.default_rng(21)
    star = np.stack([np.zeros(400, np.int64), rng.integers(1, 60, 400)], 1)
    path = np.stack([np.arange(300), np.arange(1, 301)], 1)
    rep = np.repeat(rng.integers(0, 60, (40, 2)), 6, axis=0)
    loops = np.repeat(np.arange(30)[:, None], 2, axis=1)
    back = np.concatenate([rep[:60], rep[:60, ::-1]], 1).reshape(-1, 2)
    mixed = np.concatenate([star[:50], loops, rep[:50], path[:50],
                            loops[::-1], back])
    tiny = [np.array(x) for x in ([[0, 1]], [[0, 1], [1, 1]],
                                  [[0, 0], [0, 0], [0, 1]])]
    return [(torch.from_numpy(x.astype(np.int32)), int(x.max()) + 1)
            for x in [star, path, rep, loops, mixed] + tiny]


@pytest.mark.parametrize("p", [1, 4, 33])
def test_hdrf_plain_on_shared_endpoints(p):
    """The plain HDRF equals the reference's scan on the streams the card
    test below runs (consecutive edges sharing endpoints, self-loops)."""
    for e, n in _shared_endpoint_streams():
        np.testing.assert_array_equal(ref.hdrf_scan_ref(e, p, n, 1.0),
                                      np.asarray(_hdrf_scan(e.numpy(), p, n,
                                                            1.0)))


def _filling_limit(e, p):
    """A limit every partition fills: at most half a fair share."""
    return max(1, e.shape[0] // (2 * p))


@pytest.mark.parametrize("fill", [True, False])
@pytest.mark.parametrize("p", [1, 4, 33])
def test_oblivious_plain_on_shared_endpoints(p, fill):
    """The plain Oblivious equals the reference's scan on the streams the
    card test below runs, at a limit every partition fills (the overflow
    rule) and at one none reaches."""
    for e, n in _shared_endpoint_streams():
        limit = _filling_limit(e, p) if fill else e.shape[0] + 1
        np.testing.assert_array_equal(
            ref.oblivious_scan_ref(e, p, n, limit),
            np.asarray(_oblivious_scan(e.numpy(), p, n, limit)))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4, 33, 256, 300])
def test_hdrf_forwarding_on_shared_endpoints(cuda, p):
    """The warp kernel loads edge i + 1's degrees and flags before edge i
    writes them and forwards edge i's writes from registers: on streams
    whose consecutive edges share endpoints (star, path, repeated edges,
    self-loops, both orders, 1 to 3 edges) it gives the plain version's
    bits, as the block kernel (P = 300) does."""
    for e, n in _shared_endpoint_streams():
        for lam in (0.1, 1.0, 3.0):
            got = ops.hdrf_scan(e.to(cuda), p, n, lam)
            torch.testing.assert_close(got.cpu(),
                                       ref.hdrf_scan_ref(e, p, n, lam),
                                       rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4, 33, 256, 300])
def test_oblivious_forwarding_on_shared_endpoints(cuda, p):
    """The Oblivious warp kernel forwards the bit edge i sets to edge
    i + 1's loaded flag words: on streams whose consecutive edges share
    endpoints it gives the plain version's bits at a limit every
    partition fills and at one none reaches, as the block kernel (P =
    300) does, and the same bits from call to call."""
    for e, n in _shared_endpoint_streams():
        for limit in (_filling_limit(e, p), e.shape[0] + 1):
            got = ops.oblivious_scan(e.to(cuda), p, n, limit)
            again = ops.oblivious_scan(e.to(cuda), p, n, limit)
            assert torch.equal(got, again)
            torch.testing.assert_close(
                got.cpu(), ref.oblivious_scan_ref(e, p, n, limit),
                rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PARTITIONERS))
def test_partitioners_on_the_card_equal_the_reference(cuda, jg, name):
    gc = rmat(10, 8, seed=3, device=cuda)
    np.testing.assert_array_equal(PARTITIONERS[name](gc, P),
                                  J_PARTITIONERS[name](jg, P))
