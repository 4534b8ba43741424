"""Input shapes of the cells, per model family (the reference's
``configs/shapes.py``), and the reduced shapes of the CPU smoke tests."""
from __future__ import annotations

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4_096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32_768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524_288, global_batch=1),
}

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

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}

# Reduced shapes for the CPU smoke tests.
SMOKE_SHAPES = {
    "lm": {
        "train": dict(kind="train", seq_len=32, global_batch=2),
        "prefill": dict(kind="prefill", seq_len=16, global_batch=2),
        "decode": dict(kind="decode", seq_len=24, global_batch=2),
    },
    "gnn": {
        "full": dict(kind="full", n_nodes=60, n_edges=200, d_feat=12,
                     n_classes=4),
        "minibatch": dict(kind="minibatch", n_nodes=300, n_edges=900,
                          batch_nodes=8, fanout=(3, 2), d_feat=12,
                          n_classes=4),
        "batched": dict(kind="batched", n_nodes=12, n_edges=20, batch=4,
                        d_feat=12, n_classes=4),
    },
    "recsys": {
        "train": dict(kind="train", batch=16),
        "serve": dict(kind="serve", batch=8),
        "retrieval": dict(kind="retrieval", batch=1, n_candidates=64),
    },
}
