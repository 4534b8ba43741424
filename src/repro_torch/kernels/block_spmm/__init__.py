"""Block-sparse SpMM for the GNN aggregation: ``out = A @ x``."""
