"""Input shapes of the GNN cells (the GNN part of the reference's
``configs/shapes.py``)."""
from __future__ import annotations

GNN_SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=2_708, n_edges=10_556,
                          d_feat=1_433, n_classes=7),
    "minibatch_lg": dict(kind="minibatch", n_nodes=232_965,
                         n_edges=114_615_892, batch_nodes=1_024,
                         fanout=(15, 10), d_feat=602, n_classes=41),
    "ogb_products": dict(kind="full", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100, n_classes=47),
    "molecule": dict(kind="batched", n_nodes=30, n_edges=64, batch=128,
                     d_feat=32, n_classes=2),
}
