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


# --------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4, 37, 64, 1500])
def test_stream_kernels_match_plain(cuda, g, p):
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


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PARTITIONERS))
def test_partitioners_on_the_card_equal_the_reference(cuda, jg, name):
    gc = rmat(10, 8, seed=3, device=cuda)
    np.testing.assert_array_equal(PARTITIONERS[name](gc, P),
                                  J_PARTITIONERS[name](jg, P))
