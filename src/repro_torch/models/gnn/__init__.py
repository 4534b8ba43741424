"""GNN models: message passing by segment sums over an edge index."""
