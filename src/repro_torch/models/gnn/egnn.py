"""EGNN [Satorras et al., ICML'21] — E(n)-equivariant message passing.

  m_ij  = φ_e(h_i, h_j, ‖x_i − x_j‖²)
  x_i' = x_i + (1/deg) Σ_j (x_i − x_j) · φ_x(m_ij)
  h_i' = φ_h(h_i, Σ_j m_ij)

``EGNN.forward`` is the plain single-device model, the oracle twin of the
vertex-cut engine's ``egnn_forward`` in ``repro_torch.launch.gnn_engine``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.common import MLP
from repro_torch.models.gnn.common import (GraphData, degrees,
                                           graph_readout, segment_agg)


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 32
    n_classes: int = 2
    graph_level: bool = False


class EGNNLayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, gen: torch.Generator,
                 device=None):
        super().__init__()
        self.phi_e = MLP([2 * d_in + 1, d_hidden, d_hidden], gen, device)
        self.phi_x = MLP([d_hidden, d_hidden, 1], gen, device)
        self.phi_h = MLP([d_in + d_hidden, d_hidden, d_hidden], gen, device)


class EGNN(nn.Module):
    MODEL = "egnn"

    def __init__(self, cfg: EGNNConfig, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        dims = [cfg.d_feat] + [cfg.d_hidden] * cfg.n_layers
        self.layers = nn.ModuleList(
            EGNNLayer(d_in, cfg.d_hidden, gen, device) for d_in in dims[:-1])
        self.head = MLP([cfg.d_hidden, cfg.n_classes], gen, device)

    def param_tree(self) -> dict:
        return {"layers": [{"phi_e": lp.phi_e.param_tree(),
                            "phi_x": lp.phi_x.param_tree(),
                            "phi_h": lp.phi_h.param_tree()}
                           for lp in self.layers],
                "head": self.head.param_tree()}

    def forward(self, g: GraphData):
        h, x = g.node_feats, g.positions
        n = h.shape[0]
        src, dst = g.edge_index[0].long(), g.edge_index[1]
        m = g.edge_mask
        deg = torch.clamp(degrees(g.edge_index, n, m), min=1.0)
        for lp in self.layers:
            rel = x[dst.long()] - x[src]            # messages flow src→dst
            d2 = (rel * rel).sum(-1, keepdim=True)
            msg = lp.phi_e(torch.cat([h[dst.long()], h[src], d2], -1),
                           act=F.silu, final_act=F.silu)
            coef = lp.phi_x(msg, act=F.silu)
            x = x + segment_agg(rel * coef, dst, n, "sum", m) / deg[:, None]
            agg = segment_agg(msg, dst, n, "sum", m)
            h = lp.phi_h(torch.cat([h, agg], -1), act=F.silu)
        if self.cfg.graph_level:
            return self.head(graph_readout(h, g.graph_ids, g.n_graphs,
                                           "mean"))
        return self.head(h)
