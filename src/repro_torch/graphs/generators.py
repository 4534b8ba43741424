"""Synthetic graph generators (numpy only), as in the reference package."""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, from_edges


def erdos_renyi(n: int, avg_deg: float, seed: int = 0,
                device=None) -> Graph:
    """int(n·avg_deg/2)·1.2 uniform vertex pairs, then ``from_edges``
    (loops and duplicates dropped): the reference's graph, edge for edge."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    e = rng.integers(0, n, size=(int(m * 1.2), 2))
    return from_edges(e, num_vertices=n, device=device)
