"""PNA [Corso et al., NeurIPS'20] — multi-aggregator (mean/max/min/std) ×
degree scalers (identity/amplification/attenuation).

``PNA.forward`` is the plain single-device model, the oracle twin of the
vertex-cut engine's ``pna_forward`` in ``repro_torch.launch.gnn_engine``.
``param_tree`` lays the parameters out as the reference's pytree.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.common import MLP
from repro_torch.models.gnn.common import (GraphData, degrees,
                                           graph_readout, segment_agg)

AGGS = ("mean", "max", "min", "std")
N_SCALERS = 3


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_feat: int = 32
    n_classes: int = 2
    avg_log_deg: float = 2.0           # δ: dataset-level normalizer
    graph_level: bool = False


class PNALayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, gen: torch.Generator,
                 device=None):
        super().__init__()
        self.pre = MLP([2 * d_in, d_hidden], gen, device)
        self.post = MLP([len(AGGS) * N_SCALERS * d_hidden + d_in, d_hidden],
                        gen, device)


def scalers(deg, avg_log_deg: float):
    """The three degree scalers of (N,) degrees, each (N, 1)."""
    logd = torch.log1p(deg)[:, None]
    return (torch.ones_like(logd), logd / avg_log_deg,
            avg_log_deg / torch.clamp(logd, min=1e-3))


class PNA(nn.Module):
    MODEL = "pna"

    def __init__(self, cfg: PNAConfig, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        dims = [cfg.d_feat] + [cfg.d_hidden] * cfg.n_layers
        self.layers = nn.ModuleList(
            PNALayer(d_in, cfg.d_hidden, gen, device) for d_in in dims[:-1])
        self.head = MLP([cfg.d_hidden, cfg.n_classes], gen, device)

    def param_tree(self) -> dict:
        return {"layers": [{"pre": lp.pre.param_tree(),
                            "post": lp.post.param_tree()}
                           for lp in self.layers],
                "head": self.head.param_tree()}

    def forward(self, g: GraphData):
        h = g.node_feats
        n = h.shape[0]
        src, dst = g.edge_index[0].long(), g.edge_index[1]
        m = g.edge_mask
        sc = scalers(degrees(g.edge_index, n, m), self.cfg.avg_log_deg)
        for lp in self.layers:
            msg = lp.pre(torch.cat([h[src], h[dst.long()]], -1))
            mean = segment_agg(msg, dst, n, "mean", m)
            sq = segment_agg(msg * msg, dst, n, "mean", m)
            aggs = [mean, segment_agg(msg, dst, n, "max", m),
                    segment_agg(msg, dst, n, "min", m),
                    torch.sqrt(torch.clamp(sq - mean * mean, min=0.0)
                               + 1e-6)]
            stacked = [a * s for a in aggs for s in sc]
            h = torch.relu(lp.post(torch.cat(stacked + [h], -1)))
        if self.cfg.graph_level:
            return self.head(graph_readout(h, g.graph_ids, g.n_graphs,
                                           "mean"))
        return self.head(h)
