"""GNN substrate: message passing by segment sums over an edge index.

The part of the reference's ``models/gnn/common.py`` that the plain GIN
needs.  A graph is one padded edge list:

  node_feats: (N, F)        edge_index: (2, E) int32 (src, dst)
  edge_mask:  (E,) bool     padding edges point at node N-1 with mask=False
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GraphData:
    node_feats: torch.Tensor         # (N, F)
    edge_index: torch.Tensor         # (2, E) directed (src → dst); both
    edge_mask: torch.Tensor          # (E,) bool  directions when undirected
    graph_ids: torch.Tensor | None = None   # (N,) for graph-level readout
    n_graphs: int = 1


def segment_agg(msgs, dst, num_nodes: int, mask=None):
    """out[v] = Σ msgs[e] over edges e with dst[e] == v (and mask[e]): the
    sum, the one aggregation GIN takes."""
    if mask is not None:
        msgs = torch.where(mask[:, None], msgs, torch.zeros_like(msgs))
        dst = torch.where(mask, dst, torch.full_like(dst, num_nodes))
    out = torch.zeros((num_nodes + 1,) + tuple(msgs.shape[1:]),
                      dtype=msgs.dtype, device=msgs.device)
    return out.index_add(0, dst.long(), msgs)[:num_nodes]


def graph_readout(node_vals, graph_ids, n_graphs: int):
    """Per-graph sums of node values."""
    out = torch.zeros((n_graphs,) + tuple(node_vals.shape[1:]),
                      dtype=node_vals.dtype, device=node_vals.device)
    return out.index_add(0, graph_ids.long(), node_vals)


def to_directed_padded(edges: np.ndarray, num_nodes: int,
                       pad_to: int | None = None):
    """Undirected edge list → both-direction (2, E') + mask (host-side)."""
    e = np.asarray(edges)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    ei = np.stack([src, dst]).astype(np.int32)
    m = np.ones(ei.shape[1], bool)
    if pad_to is not None and pad_to > ei.shape[1]:
        padn = pad_to - ei.shape[1]
        ei = np.concatenate(
            [ei, np.full((2, padn), num_nodes - 1, np.int32)], axis=1)
        m = np.concatenate([m, np.zeros(padn, bool)])
    return ei, m
