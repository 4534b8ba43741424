"""GNN substrate: message passing by segment reductions over an edge index.

A graph is one padded edge list:

  node_feats: (N, F)        edge_index: (2, E) int32 (src, dst)
  edge_mask:  (E,) bool     padding edges point at node N-1 with mask=False

The segment max and min are ``scatter_reduce`` from an identity-filled
tensor: their gradient goes to the messages equal to the result, split
evenly among them, the rule of ``jax.grad`` through the reference's
``segment_max`` and ``segment_min``.
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
    positions: torch.Tensor | None = None   # (N, 3) for E(n)/SO(3) models


def _segment(msgs, dst, num_segments: int, op: str):
    """out[s] (op)= msgs[e] over e with dst[e] == s, from the op's
    identity (0, -inf, +inf)."""
    shape = (num_segments,) + tuple(msgs.shape[1:])
    idx = dst.long()
    if op == "sum":
        out = torch.zeros(shape, dtype=msgs.dtype, device=msgs.device)
        return out.index_add(0, idx, msgs)
    ident = float("-inf") if op == "max" else float("inf")
    out = torch.full(shape, ident, dtype=msgs.dtype, device=msgs.device)
    idx = idx.reshape((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
    return out.scatter_reduce(0, idx, msgs, reduce="a" + op)


def segment_agg(msgs, dst, num_nodes: int, op: str = "sum", mask=None):
    """out[v] = the ``op`` (sum, mean, max or min) of msgs[e] over edges
    e with dst[e] == v (and mask[e]); 0 where v has no such edge."""
    if mask is not None:
        fill = {"sum": 0.0, "mean": 0.0, "max": float("-inf"),
                "min": float("inf")}[op]
        msgs = torch.where(mask[:, None], msgs,
                           torch.full_like(msgs[:1], fill))
        dst = torch.where(mask, dst, torch.full_like(dst, num_nodes))
    if op == "sum":
        out = _segment(msgs, dst, num_nodes + 1, "sum")
    elif op == "mean":
        s = _segment(msgs, dst, num_nodes + 1, "sum")
        c = _segment(torch.ones(msgs.shape[:1], dtype=msgs.dtype,
                                device=msgs.device), dst, num_nodes + 1,
                     "sum")
        out = s / torch.clamp(c[:, None], min=1.0)
    elif op in ("max", "min"):
        out = _segment(msgs, dst, num_nodes + 1, op)
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    else:
        raise ValueError(op)
    return out[:num_nodes]


def segment_softmax(scores, dst, num_nodes: int, mask=None):
    """Edge softmax normalized per destination.  scores: (E, H)."""
    if mask is not None:
        scores = torch.where(mask[:, None], scores,
                             torch.full_like(scores[:1], float("-inf")))
        dst = torch.where(mask, dst, torch.full_like(dst, num_nodes))
    mx = _segment(scores, dst, num_nodes + 1, "max")
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    idx = dst.long()
    ex = torch.exp(scores - mx[idx])
    ex = torch.where(torch.isfinite(ex), ex, torch.zeros_like(ex))
    den = _segment(ex, dst, num_nodes + 1, "sum")
    return ex / torch.clamp(den[idx], min=1e-16)


def degrees(edge_index, num_nodes: int, mask=None):
    """(N,) float32 in-degree of each node over the (masked) edges."""
    dst = edge_index[1]
    ones = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
    if mask is not None:
        ones = ones * mask
        dst = torch.where(mask, dst, torch.full_like(dst, num_nodes))
    return _segment(ones, dst, num_nodes + 1, "sum")[:num_nodes]


def graph_readout(node_vals, graph_ids, n_graphs: int, op: str = "sum"):
    """Per-graph sums (or means) of node values."""
    s = _segment(node_vals, graph_ids, n_graphs, "sum")
    if op == "sum":
        return s
    if op == "mean":
        c = _segment(torch.ones(node_vals.shape[:1], dtype=node_vals.dtype,
                                device=node_vals.device), graph_ids,
                     n_graphs, "sum")
        return s / torch.clamp(c[:, None], min=1.0)
    raise ValueError(op)


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
