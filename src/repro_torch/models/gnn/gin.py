"""GIN [Xu et al., ICLR'19] — sum aggregation + learnable ε (gin-tu config).

``GIN.forward`` is the plain single-device model (segment sums over an
edge index), the oracle twin of the vertex-cut engine's forward in
``repro_torch.launch.gnn_engine``.  ``param_tree`` lays the parameters out
as the reference's pytree; ``params_to_numpy``/``params_from_numpy`` carry
that pytree across as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.common import (MLP, params_from_numpy,  # noqa: F401
                                      params_to_numpy)
from repro_torch.models.gnn.common import (GraphData, graph_readout,
                                           segment_agg)


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 32
    n_classes: int = 2
    graph_level: bool = False          # TU graph classification vs node task


class GINLayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, gen: torch.Generator,
                 device=None):
        super().__init__()
        self.mlp = MLP([d_in, d_hidden, d_hidden], gen, device)
        self.eps = nn.Parameter(torch.zeros((), device=device))  # GIN-ε, 0


class GIN(nn.Module):
    MODEL = "gin"

    def __init__(self, cfg: GINConfig, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        dims = [cfg.d_feat] + [cfg.d_hidden] * cfg.n_layers
        self.layers = nn.ModuleList(
            GINLayer(d_in, cfg.d_hidden, gen, device) for d_in in dims[:-1])
        self.head = MLP([cfg.d_hidden, cfg.n_classes], gen, device)

    def param_tree(self) -> dict:
        return {"layers": [{"mlp": lp.mlp.param_tree(), "eps": lp.eps}
                           for lp in self.layers],
                "head": self.head.param_tree()}

    def forward(self, g: GraphData):
        h = g.node_feats
        n = h.shape[0]
        src, dst = g.edge_index[0].long(), g.edge_index[1]
        for lp in self.layers:
            agg = segment_agg(h[src], dst, n, "sum", g.edge_mask)
            h = torch.relu(lp.mlp((1.0 + lp.eps) * h + agg, act=torch.relu))
        if self.cfg.graph_level:
            pooled = graph_readout(h, g.graph_ids, g.n_graphs)
            return self.head(pooled)
        return self.head(h)
