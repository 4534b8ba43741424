"""Synthetic graph generators (numpy only), as in the reference package.

Each builds its edge list on the host with numpy, edge for edge the
reference's, then ``from_edges`` on ``device`` (``None`` means the card).
``barabasi_albert`` copies networkx's generator with the standard
library's ``random``, so it needs no networkx.
"""
from __future__ import annotations

import random

import numpy as np

from repro_torch.core.graph import Graph, from_edges
from repro_torch.core.theory import theorem2_construction


def ring_plus_complete(n: int, device=None) -> tuple[Graph, int]:
    """Theorem 2 tightness construction; returns (graph, |P|)."""
    edges, nv, p = theorem2_construction(n)
    return from_edges(edges, num_vertices=nv, device=device), p


def grid2d(rows: int, cols: int, device=None) -> Graph:
    """Road-network proxy (paper §7.7 non-skewed graphs)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    h = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)
    v = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)
    return from_edges(np.concatenate([h, v]), num_vertices=rows * cols,
                      device=device)


def barabasi_albert(n: int, m_attach: int, seed: int = 0,
                    device=None) -> Graph:
    """Barabási–Albert preferential attachment, edge for edge
    ``networkx.barabasi_albert_graph(n, m_attach, seed=seed)`` (networkx
    3.x): a star on m + 1 nodes, then each new node joins m distinct
    targets drawn by ``random.Random(seed).choice`` from the list of
    nodes repeated once per edge end.  The targets are collected in a
    ``set`` whose iteration order, as networkx's, decides the list's
    order and so every later draw."""
    if m_attach < 1 or m_attach >= n:
        raise ValueError(f"Barabási–Albert needs 1 <= m < n, m = {m_attach}, "
                         f"n = {n}")
    rng = random.Random(seed)
    adj = [[] for _ in range(n)]          # neighbours in insertion order
    for v in range(1, m_attach + 1):
        adj[0].append(v)
        adj[v].append(0)
    repeated = [0] * m_attach + list(range(1, m_attach + 1))
    for source in range(m_attach + 1, n):
        targets = set()
        while len(targets) < m_attach:
            targets.add(rng.choice(repeated))
        for t in targets:
            adj[source].append(t)
            adj[t].append(source)
        repeated.extend(targets)
        repeated.extend([source] * m_attach)
    # networkx's Graph.edges order: nodes in order, each edge once
    edges = np.array([(u, v) for u in range(n) for v in adj[u] if v > u],
                     dtype=np.int64)
    return from_edges(edges, num_vertices=n, device=device)


def erdos_renyi(n: int, avg_deg: float, seed: int = 0,
                device=None) -> Graph:
    """int(n·avg_deg/2)·1.2 uniform vertex pairs, then ``from_edges``
    (loops and duplicates dropped): the reference's graph, edge for edge."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    e = rng.integers(0, n, size=(int(m * 1.2), 2))
    return from_edges(e, num_vertices=n, device=device)


def powerlaw_configuration(n: int, alpha: float, seed: int = 0,
                           device=None) -> Graph:
    """Configuration-model power-law graph, Pr[d] ∝ d^-α, d_min=1 (§6)."""
    rng = np.random.default_rng(seed)
    ds = np.arange(1, n // 4 + 1, dtype=np.float64)
    pmf = ds ** (-alpha)
    pmf /= pmf.sum()
    deg = rng.choice(ds.astype(np.int64), size=n, p=pmf)
    if deg.sum() % 2:
        deg[0] += 1
    stubs = np.repeat(np.arange(n), deg)
    rng.shuffle(stubs)
    e = stubs.reshape(-1, 2)
    return from_edges(e, num_vertices=n, device=device)
