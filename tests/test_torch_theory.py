"""The port's numpy copies of the reference package's theory module, its
Sequential NE oracle and the synthetic generators, against the reference.

Mirrors tests/test_theory.py (each value equal to the reference's, and
the paper's Table 1), and the uses of ``ring_plus_complete`` and
``sequential_ne`` in tests/test_partitioner.py (Theorem 2 tightness, the
oracle beating 1D hashing).
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import theory as jtheory
from repro.core.metrics import evaluate as j_evaluate
from repro.core.sequential_ne import sequential_ne as j_sequential_ne
from repro.graphs import generators as jgen
from repro.graphs.rmat import rmat as j_rmat
from repro_torch.core import theory
from repro_torch.core.baselines import random_1d
from repro_torch.core.metrics import evaluate, theorem1_upper_bound
from repro_torch.core.partitioner import NEConfig, partition
from repro_torch.core.sequential_ne import sequential_ne
from repro_torch.graphs import generators as gen
from repro_torch.graphs.rmat import rmat

ALPHAS = (2.2, 2.4, 2.6, 2.8)


def test_zeta_known_values():
    assert abs(theory.riemann_zeta(2.0) - math.pi ** 2 / 6) < 1e-9
    assert abs(theory.riemann_zeta(4.0) - math.pi ** 4 / 90) < 1e-9
    for s in (1.5, 2.0, 3.3):
        assert theory.riemann_zeta(s) == jtheory.riemann_zeta(s)


@pytest.mark.parametrize("alpha,expected", [
    (2.2, 2.88), (2.4, 2.12), (2.6, 1.88), (2.8, 1.75)])
def test_table1_distributed_ne_row(alpha, expected):
    """Paper Table 1, Distributed NE row (|P| = 256), and its ordering
    against every baseline row."""
    ub = theory.expected_ub_distributed_ne(alpha)
    assert ub == jtheory.expected_ub_distributed_ne(alpha)
    assert abs(ub - expected) < 0.02
    assert theory.PAPER_TABLE1 == jtheory.PAPER_TABLE1
    for name, row in theory.PAPER_TABLE1.items():
        if name != "Distributed NE":
            assert ub < row[alpha]


@pytest.mark.parametrize("alpha", [2.4, 2.8])
def test_estimators_equal_reference(alpha):
    p = 256
    r = theory.expected_rf_random(alpha, p)
    g = theory.expected_rf_grid(alpha, p)
    d = theory.expected_rf_dbh(alpha, p, n_mc=5_000)
    assert (r, g, d) == (jtheory.expected_rf_random(alpha, p),
                         jtheory.expected_rf_grid(alpha, p),
                         jtheory.expected_rf_dbh(alpha, p, n_mc=5_000))
    assert 1.0 <= g <= r and 1.0 <= d <= r + 1.0


def test_theorem2_construction_equals_reference():
    for n in (3, 5, 8):
        edges, nv, p = theory.theorem2_construction(n)
        j_edges, j_nv, j_p = jtheory.theorem2_construction(n)
        np.testing.assert_array_equal(edges, j_edges)
        assert (nv, p) == (j_nv, j_p) == (n + n * (n - 1) // 2,
                                          n * (n - 1) // 2)
        assert edges.shape[0] == n * (n - 1)


@pytest.mark.parametrize("make", [
    lambda m, **kw: m.ring_plus_complete(6, **kw)[0],
    lambda m, **kw: m.grid2d(13, 17, **kw),
    lambda m, **kw: m.powerlaw_configuration(3000, 2.1, seed=4, **kw),
    lambda m, **kw: m.erdos_renyi(500, 4.0, seed=1, **kw),
], ids=["ring_plus_complete", "grid2d", "powerlaw_configuration",
        "erdos_renyi"])
def test_generators_equal_reference(make):
    got, want = make(gen, device="cpu"), make(jgen)
    for f in ("edges", "indptr", "adj_dst", "adj_eid", "degree"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_theorem2_tightness():
    """Ring + complete construction: RF ≤ Theorem 1's bound, and the port's
    run equals the reference's stats."""
    g, p = gen.ring_plus_complete(6, device="cpu")
    assert p == jgen.ring_plus_complete(6)[1]
    res = partition(g, NEConfig(num_partitions=p, alpha=1.01, seed=0))
    e = g.edges.numpy()
    st = evaluate(e, res.edge_part, g.num_vertices, p)
    assert st.replication_factor <= theorem1_upper_bound(
        g.num_vertices, g.num_edges, p) + 1e-9
    assert dataclasses.astuple(st) == dataclasses.astuple(
        j_evaluate(e, res.edge_part, g.num_vertices, p))


@pytest.mark.parametrize("p,seed", [(8, 0), (5, 3)])
def test_sequential_ne_equals_reference(p, seed):
    """Paper Table 4's oracle: the reference's assignment, and a lower RF
    than 1D hashing."""
    g = rmat(10, 8, seed=3, device="cpu")
    e = g.edges.numpy()
    ep = sequential_ne(e, g.num_vertices, p, seed=seed)
    jg = j_rmat(10, 8, seed=3)
    np.testing.assert_array_equal(
        ep, j_sequential_ne(np.asarray(jg.edges), jg.num_vertices, p,
                            seed=seed))
    assert (ep >= 0).all()
    rf_seq = evaluate(e, ep, g.num_vertices, p).replication_factor
    rf_rand = evaluate(e, random_1d(g, p), g.num_vertices,
                       p).replication_factor
    assert rf_seq < rf_rand
