"""Theoretical bounds (paper §6): Theorem 1/2 and Table 1 closed forms.

A numpy copy of the reference package's ``core/theory.py`` (the port
imports nothing of it); ``graphs.generators.ring_plus_complete`` builds
on :func:`theorem2_construction`.
"""
from __future__ import annotations

import math

import numpy as np


def riemann_zeta(s: float, terms: int = 400) -> float:
    """ζ(s) for s>1 via Euler–Maclaurin (no scipy in this environment)."""
    assert s > 1.0
    n = terms
    total = sum(k ** (-s) for k in range(1, n))
    total += n ** (1 - s) / (s - 1) + 0.5 * n ** (-s)
    # first Bernoulli correction terms
    total += s * n ** (-s - 1) / 12.0
    total -= s * (s + 1) * (s + 2) * n ** (-s - 3) / 720.0
    return total


def expected_ub_distributed_ne(alpha: float) -> float:
    """E[UB] ≈ ζ(α−1)/(2ζ(α)) + 1 for power-law graphs, d_min = 1 (paper §6).

    Matches paper Table 1 (e.g. α=2.2 → 2.88).
    """
    return riemann_zeta(alpha - 1.0) / (2.0 * riemann_zeta(alpha)) + 1.0


def _expected_degree_moments(alpha: float, d_max: int = 10_000_000):
    """Degree pmf Pr[d] = d^-α / ζ(α), d ≥ 1, truncated (negligible tail)."""
    # truncated pmf, renormalized (tail mass is negligible for α > 2)
    ds = np.arange(1, 200_000, dtype=np.float64)
    pmf = ds ** (-alpha)
    pmf /= pmf.sum()
    return ds, pmf


def expected_rf_random(alpha: float, p: int) -> float:
    """1D-hash expected RF on power-law graphs [Xie et al. NIPS'14]:
    E[RF] = E_d[ P · (1 − (1 − 1/P)^d) ]."""
    ds, pmf = _expected_degree_moments(alpha)
    return float(np.sum(pmf * p * (1.0 - (1.0 - 1.0 / p) ** ds)))


def expected_rf_grid(alpha: float, p: int) -> float:
    """2D-hash (Grid): a vertex's edges land in a row/col of the √P×√P grid,
    so at most 2√P−1 distinct partitions [Xie et al. NIPS'14]."""
    q = 2 * math.isqrt(p) - 1
    ds, pmf = _expected_degree_moments(alpha)
    return float(np.sum(pmf * q * (1.0 - (1.0 - 1.0 / q) ** ds)))


def expected_rf_dbh(alpha: float, p: int, n_mc: int = 200_000,
                    seed: int = 0) -> float:
    """DBH expected RF, Monte-Carlo over the degree distribution.

    Each edge is hashed by its lower-degree endpoint; for a vertex of degree
    d, each incident edge is self-hashed (goes to h(v), one partition) if v
    is the lower-degree side, otherwise goes to a ~uniform partition.  We
    sample neighbor degrees i.i.d. from the pmf (the paper's analytic bound
    makes the same independence assumption).
    """
    rng = np.random.default_rng(seed)
    ds, pmf = _expected_degree_moments(alpha)
    # size-biased neighbor degree distribution: Pr*[d] ∝ d·Pr[d]
    nb_pmf = pmf * ds
    nb_pmf /= nb_pmf.sum()
    deg = rng.choice(ds, size=n_mc, p=pmf).astype(np.int64)
    deg = np.minimum(deg, 512)  # cap per-vertex work; tail ≈ P partitions
    total = 0.0
    for d in np.unique(deg):
        cnt = int((deg == d).sum())
        nb = rng.choice(ds, size=(cnt, int(d)), p=nb_pmf)
        self_hash = nb >= d  # v is the lower-or-tied-degree side → h(v)
        k_rand = (~self_hash).sum(axis=1)
        # self-hashed edges share one partition; other-hashed edges are
        # ~uniform i.i.d. → expected distinct = P(1 − (1 − 1/P)^k)
        exp_rand = p * (1.0 - (1.0 - 1.0 / p) ** k_rand)
        total += float(np.sum(self_hash.any(axis=1) + exp_rand))
    return total / n_mc


# Paper Table 1 (|P| = 256) — baseline rows are computed from the formulas
# of Xie et al. [NIPS'14], which we cannot re-derive offline; we cite the
# paper's reported values and additionally report our own first-principles
# *expectation* estimators above (a different, looser quantity — see
# benchmarks/bench_theory.py).  The Distributed NE row is our closed form
# ``expected_ub_distributed_ne`` and matches the paper to <0.02.
PAPER_TABLE1 = {
    "Random (1D-hash)": {2.2: 5.88, 2.4: 3.46, 2.6: 2.64, 2.8: 2.23},
    "Grid (2D-hash)": {2.2: 4.82, 2.4: 3.13, 2.6: 2.47, 2.8: 2.13},
    "DBH": {2.2: 5.54, 2.4: 3.19, 2.6: 2.42, 2.8: 2.05},
    "Distributed NE": {2.2: 2.88, 2.4: 2.12, 2.6: 1.88, 2.8: 1.75},
}


def theorem2_construction(n: int):
    """Ring + complete graph of Theorem 2; returns (edges, |V|, |P|).

    Complete graph on n vertices (n(n−1)/2 edges) ∪ ring on n(n−1)/2
    vertices; |P| = n(n−1)/2 makes RF/UB → 1 as n → ∞.
    """
    kn = [(i, j) for i in range(n) for j in range(i + 1, n)]
    r = n * (n - 1) // 2
    ring = [(n + i, n + (i + 1) % r) for i in range(r)]
    edges = np.asarray(kn + ring, dtype=np.int32)
    return edges, n + r, r
