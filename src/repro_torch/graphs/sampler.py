"""Fanout neighbor sampler for the minibatch_lg cell (GraphSAGE-style),
the reference's ``graphs/sampler.py`` on the port's ``Graph``.

Given a CSR graph, per-seed multi-hop uniform neighbor sampling with the
assigned fanout (15, 10), producing padded subgraph batches consumable by
any GNN model.  numpy, host-side (data pipeline), deterministic per seed:
the same draws as the reference's, so the same batches bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.io.csr import to_numpy


class NeighborSampler:
    def __init__(self, g: Graph, fanout: tuple[int, ...] = (15, 10),
                 seed: int = 0):
        self.indptr = to_numpy(g.indptr)
        self.adj = to_numpy(g.adj_dst)
        self.fanout = fanout
        self.n = g.num_vertices
        self.rng = np.random.default_rng(seed)
        f_total = 1
        self.nodes_cap = 1
        for f in fanout:
            f_total *= f
            self.nodes_cap += f_total
        self.edges_cap = self.nodes_cap - 1          # tree upper bound

    def sample(self, seeds: np.ndarray):
        """Returns dict of padded arrays for a batch of seeds.

        nodes: (B, nodes_cap) global ids (pad = 0), n_count (B,),
        edge_index: (B, 2, 2·edges_cap) subgraph-local (both directions),
        edge_mask (B, 2·edges_cap); seeds are local node 0.
        """
        b = seeds.shape[0]
        nodes = np.zeros((b, self.nodes_cap), np.int64)
        n_count = np.ones(b, np.int64)
        e_src = np.zeros((b, self.edges_cap), np.int64)
        e_dst = np.zeros((b, self.edges_cap), np.int64)
        e_count = np.zeros(b, np.int64)
        for i, s in enumerate(seeds):
            nodes[i, 0] = s
            frontier = [(0, s)]
            for f in self.fanout:
                nxt = []
                for loc, v in frontier:
                    lo, hi = self.indptr[v], self.indptr[v + 1]
                    if hi == lo:
                        continue
                    k = min(f, hi - lo)
                    picks = self.rng.choice(self.adj[lo:hi], size=k,
                                            replace=False)
                    for u in picks:
                        uloc = n_count[i]
                        nodes[i, uloc] = u
                        e_src[i, e_count[i]] = uloc
                        e_dst[i, e_count[i]] = loc
                        e_count[i] += 1
                        nxt.append((uloc, u))
                        n_count[i] += 1
                frontier = nxt
        emask = np.arange(self.edges_cap)[None, :] < e_count[:, None]
        # both directions, padding edges point at node 0 masked out
        ei = np.stack([np.concatenate([e_src, e_dst], 1),
                       np.concatenate([e_dst, e_src], 1)], axis=1)
        return dict(nodes=nodes.astype(np.int32),
                    n_count=n_count.astype(np.int32),
                    edge_index=ei.astype(np.int32),
                    edge_mask=np.concatenate([emask, emask], 1))

    def batches(self, batch_size: int):
        while True:
            seeds = self.rng.integers(0, self.n, size=batch_size)
            yield self.sample(seeds)
